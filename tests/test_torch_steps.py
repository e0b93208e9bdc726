"""The STEPS slice of the PyTorch port as a whole, against the JAX package
on the CPU, at 128^2 with the headline configuration (8 levels, AR(2),
nonparametric noise, BPS, incremental mask, CDF matching, spectral
domain).

(a) ``_steps_init`` with an explicit displacement bound, then the port's
    ``_steps_scan`` started from the JAX init (``params_from_numpy``) with
    the JAX per-(member, lead) phase draws handed over: value by value
    within 1e-3 x span, identical NaN sets.  The explicit bound drives the
    kernel-semantics path (K1 on the coarse carry, K2, K4) through the
    plain versions.  Once with the sort matcher against the JAX package's
    CPU path; against its TPU path (the Pallas kernels in interpret mode)
    once with the PWL matcher (K3), once with the fused match-rim-warp
    chain (``use_chain=True`` on both sides) and once at 160^2, where the
    field's 200 rows of 128 do not tile into 32 and both packages apply
    the hierarchical PWL map.
(b) The deterministic configuration through the public ``forecast``:
    within 1e-3 x span, identical NaN sets.
(c) The stochastic configuration through ``forecast``: CRPS against the
    synthetic truth and the spread/error ratio within 10% of the JAX
    package's (the two draw different random numbers).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu import cascade as jcascade  # noqa: E402
from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu.noise import fftgenerators as jfft  # noqa: E402
from pysteps_tpu.nowcasts import steps as jsteps  # noqa: E402
from pysteps_tpu.ops import pallas_chain, pallas_dilate, pallas_histmatch, pallas_warp  # noqa: E402
from pysteps_tpu.ops import warp as jwarp  # noqa: E402
from pysteps_tpu.utils import tapering as jtaper  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators as tfft  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as tsteps  # noqa: E402
from pysteps_tpu_torch.ops import pallas_chain as tchain  # noqa: E402
from pysteps_tpu_torch.ops import pallas_histmatch as thist  # noqa: E402

SIDE = 128
KW = dict(
    n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0, timestep=5,
    noise_method="nonparametric", vel_pert_method="bps",
    mask_method="incremental", probmatching_method="cdf", domain="spectral",
)


def _to_db(x):
    return np.where(x >= 0.1, 10.0 * np.log10(np.maximum(x, 0.1)), -15.0).astype(np.float32)


def _inputs(n_frames=3, evolution=0.0, side=SIDE):
    """A side^2 sequence with dry areas (made at 2 side and subsampled) and
    a non-integer motion of (1.7, 0.6) px per step: with an integer one,
    sampling positions land within rounding of the domain edge and the
    NaN set would hang on FFT rounding."""
    frames = make_synthetic_sequence(
        n_frames=n_frames, shape=(2 * side, 2 * side), velocity=(3.4, 1.2),
        seed=42, evolution=evolution,
    )[:, ::2, ::2]
    velocity = np.zeros((2, side, side), np.float32)
    velocity[0], velocity[1] = 1.7, 0.6
    return frames, velocity


def _close(ref, out, rel=1e-3, of_max=False):
    """Within ``rel`` x span of ``ref`` (x max|ref| with ``of_max``, for
    scalars and constant planes)."""
    ref, out = np.asarray(ref, np.float32), np.asarray(out, np.float32)
    assert ref.shape == out.shape
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    scale = float(np.nanmax(ref) - np.nanmin(ref))
    if of_max:
        scale = max(scale, float(np.nanmax(np.abs(ref))))
    err = float(np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(out))))
    assert err <= rel * max(scale, 1e-6), (err, scale)


@pytest.fixture(params=["sort", "pwl", "chain", "hier160"])
def pallas_path(request, monkeypatch):
    """Any path but "sort": the JAX package takes its TPU path on the CPU
    (Pallas kernels in interpret mode, PWL matcher); its jit caches are
    cleared around the test, since they do not key on the switch."""
    pallas = request.param != "sort"
    if pallas:
        monkeypatch.setattr(jwarp, "_use_pallas_cache", True)
        for mod in (pallas_warp, pallas_dilate, pallas_histmatch, pallas_chain):
            monkeypatch.setattr(mod, "INTERPRET", True)
        jax.clear_caches()
    yield request.param
    if pallas:
        jax.clear_caches()


def test_init_and_scan_value_by_value(monkeypatch, pallas_path):
    side = 160 if pallas_path == "hier160" else SIDE
    use_chain = pallas_path == "chain"
    frames, velocity = _inputs(side=side)
    precip = _to_db(frames)
    E, T, max_disp = 4, 4, 48
    m = n = side
    w = np.array(jcascade.get_method("gaussian")((m, n), 8)["weights_2d"], np.float32)
    taper = jtaper.compute_window_function(m, n, "tukey").astype(np.float32)
    key_members, key_vel = jax.random.split(jax.random.PRNGKey(42), 3)[1:]
    statics = dict(
        E=E, ar_order=2, conditional=False, mask_method="incremental",
        struct_radius=2, mask_rim=10, vel_pert=True, n_iter=1,
        interp_order=1, noise_in_graph=True, max_disp=max_disp,
    )
    j_al, j_par, j_st = jsteps._steps_init(
        jnp.asarray(precip), jnp.asarray(velocity), jnp.asarray(w),
        key_members, key_vel, jnp.float32(-10.0), taper, **statics,
    )
    gen = torch.Generator().manual_seed(0)
    t_al, t_par, t_st = tsteps._steps_init(
        torch.from_numpy(precip), torch.from_numpy(velocity), torch.from_numpy(w),
        gen, -10.0, torch.from_numpy(taper), **statics,
    )
    _close(j_al, t_al, rel=1e-5)
    for f in dataclasses.fields(jsteps.StepsNowcasterParams):
        _close(getattr(j_par, f.name), getattr(t_par, f.name), rel=1e-4, of_max=True)
    _close(j_st.window, t_st.window, rel=1e-4)
    _close(j_st.precip_mask, t_st.precip_mask, rel=1e-6)

    # the JAX per-member phase draws: key chain fold_in(key_members, i),
    # then one split per lead (nowcasts/steps.py member())
    keys = list(j_st.member_keys)
    draws = []
    for _ in range(T):
        step = []
        for i in range(E):
            keys[i], k_noise = jax.random.split(keys[i])
            step.append(np.asarray(jfft._spectral_phase_white(k_noise, (m, n))))
        draws.append(torch.from_numpy(np.stack(step)))
    it = iter(draws)
    monkeypatch.setattr(tfft, "_spectral_phase_white", lambda g, s, b: next(it))
    calls = {"match_warp_rim": 0, "pwl_apply_hier": 0}
    for mod, name in ((tchain, "match_warp_rim"), (thist, "pwl_apply_hier")):
        def counted(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    vsf = 60.0 / 5.0
    p_par = tuple(float(v) for v in jsteps.get_default_params_bps_par())
    p_perp = tuple(float(v) for v in jsteps.get_default_params_bps_perp())
    domain_mask = np.zeros((m, n), bool)
    cfg = dict(
        noise=True, mask_method="incremental", probmatching="cdf",
        domain="spectral", vel_pert=True, timestep_min=5.0, mask_rim=10,
        struct_radius=2, n_iter=1, interp_order=1, need_det=False, E=E,
        max_disp=max_disp,
    )
    ones = np.ones(8, np.float32)
    _, ref = jsteps._steps_scan(
        j_st.window, j_st.precip_mask, j_st.member_keys, jnp.asarray(velocity),
        j_par.phi, j_par.noise_filter, None, (m, n), False, jnp.asarray(w),
        jnp.asarray(ones), j_par.means, j_par.stds, j_par.precip_last,
        j_par.precip_min, jnp.float32(-10.0), j_par.war, j_par.mu_0,
        jnp.asarray(domain_mask), j_st.eps_par, j_st.eps_perp,
        j_par.velocity_unit, j_par.velocity_perp, jnp.float32(vsf),
        p_par, p_perp, T, use_chain=use_chain, **cfg,
    )
    par, st = tsteps.params_from_numpy(
        {f.name: np.asarray(getattr(j_par, f.name))
         for f in dataclasses.fields(jsteps.StepsNowcasterParams)},
        {k: np.asarray(getattr(j_st, k))
         for k in ("window", "precip_mask", "eps_par", "eps_perp")},
        "cpu", seed=0,
    )
    out = tsteps._steps_scan(
        st.window, st.precip_mask, st.generator, torch.from_numpy(velocity),
        par.phi, par.noise_filter, (m, n), torch.from_numpy(w),
        torch.from_numpy(ones), par.means, par.stds, par.precip_last,
        par.precip_min, -10.0, par.war, par.mu_0, torch.from_numpy(domain_mask),
        st.eps_par, st.eps_perp, par.velocity_unit, par.velocity_perp, vsf,
        p_par, p_perp, T, pwl_match=pallas_path != "sort", use_chain=use_chain,
        **cfg,
    )
    assert calls["match_warp_rim"] == (T if use_chain else 0)
    assert (calls["pwl_apply_hier"] > 0) == (pallas_path == "hier160")
    assert np.isnan(np.asarray(ref)).any()
    _close(ref, out)


def test_deterministic_forecast():
    frames, velocity = _inputs()
    precip = _to_db(frames)
    kw = dict(KW, n_ens_members=2, noise_method=None, vel_pert_method=None, seed=42)
    ref = jnowcasts.get_method("steps")(precip, velocity, 4, **kw)
    out = tnowcasts.get_method("steps")(precip, velocity, 4, device="cpu", **kw)
    assert out.device.type == "cpu" and out.shape == (2, 4, SIDE, SIDE)
    _close(ref, out)


def _crps(ens, obs):
    ens = ens.reshape(ens.shape[0], -1)
    obs = obs.reshape(-1)
    ok = np.all(np.isfinite(ens), axis=0) & np.isfinite(obs)
    ens, obs = ens[:, ok], obs[ok]
    n = ens.shape[0]
    term1 = np.abs(ens - obs).mean(axis=0)
    srt = np.sort(ens, axis=0)
    pair = ((2 * np.arange(n) + 1 - n)[:, None] * srt).sum(axis=0) / n**2
    return float((term1 - pair).mean())


def _scores(fc, truth):
    """CRPS over all leads and the spread/error ratio, in rain rate."""
    fc = np.asarray(fc, np.float64)
    rr = 10.0 ** (fc / 10.0) * (fc > -10)
    crps = np.mean([_crps(rr[:, t], truth[t]) for t in range(rr.shape[1])])
    spread = np.nanmean(np.nanstd(rr, axis=0, ddof=1))
    err = np.sqrt(np.nanmean((np.nanmean(rr, axis=0) - truth) ** 2))
    return crps, spread / err


def test_stochastic_forecast_crps_parity():
    frames, velocity = _inputs(n_frames=9, evolution=0.2)
    precip = _to_db(frames[:3])
    truth = frames[3:]
    j, t = [], []
    for seed in (11, 22):
        kw = dict(KW, n_ens_members=16, seed=seed)
        j.append(_scores(jnowcasts.get_method("steps")(precip, velocity, 6, **kw), truth))
        out = tnowcasts.get_method("steps")(precip, velocity, 6, device="cpu", **kw)
        assert out.shape == (16, 6, SIDE, SIDE)
        t.append(_scores(out.numpy(), truth))
    (c_j, r_j), (c_t, r_t) = np.mean(j, axis=0), np.mean(t, axis=0)
    assert abs(c_t - c_j) / c_j <= 0.1, (c_t, c_j)
    assert abs(r_t - r_j) / r_j <= 0.1, (r_t, r_j)


def test_unported_options_raise():
    frames, velocity = _inputs()
    precip = _to_db(frames)
    f = tnowcasts.get_method("steps")
    # mesh= is ported (tests/test_torch_parallel.py): it takes a DeviceMesh
    for extra in (dict(mesh=object()),):
        with pytest.raises(TypeError, match="DeviceMesh"):
            f(precip, velocity, 2, device="cpu", **dict(KW, n_ens_members=2, **extra))
    for extra in (
        dict(noise_stddev_adj="sometimes"), dict(noise_stddev_adj="auto", precip_thr=None,
                                                 mask_method=None),
        dict(noise_method="pink"),
    ):
        with pytest.raises(ValueError):
            f(precip, velocity, 2, device="cpu", **dict(KW, n_ens_members=2, **extra))
