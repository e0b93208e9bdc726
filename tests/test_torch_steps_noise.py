"""STEPS' other noise generators in the PyTorch port against the JAX
package on the CPU, at 128^2 with 8 levels, AR(2), BPS, the incremental
mask and CDF matching: the parametric filter (spectral and spatial
domain), SSFT (``win_size=64``) and nested (``max_level=2``).

For each: the JAX init (``_steps_init``, then the noise filter, the SSFT
masks and the noise std coefficients as JAX's ``_steps_forecast`` builds
them) carried over with ``params_from_numpy`` / ``noise_from_numpy``, and
the JAX per-(member, lead) draws handed to the port:

- ``_member_update`` (noise -> cascade -> AR(2) -> recompose) over three
  leads: each lead's field within 1e-4 x span;
- ``_steps_scan``: the output value by value within 1e-3 x span, identical
  NaN sets.  The scan ends in the sort-based CDF match, whose rank ties
  move a few pixels to a neighbouring target quantile: the nonparametric
  scan of ``test_torch_steps.py`` differs from JAX's by up to 1.6e-4 x
  span at 0.004% of its pixels, so 1e-3 x span is that test's tolerance.

The port's own noise init (``steps._noise_init``) on JAX's aligned inputs
gives JAX's filter (rtol 1e-4 with 1e-4 x max absolute; 1e-3 for the
parametric fit) and masks and, for "fixed", exactly JAX's coefficients.
``test_torch_steps_noise_crps.py`` holds the stochastic forecasts of each
method to JAX's by CRPS and spread/error.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_steps import _close, _inputs, _to_db  # noqa: E402

from pysteps_tpu import cascade as jcascade  # noqa: E402
from pysteps_tpu import noise as jnoise  # noqa: E402
from pysteps_tpu.noise import fftgenerators as jfft  # noqa: E402
from pysteps_tpu.nowcasts import steps as jsteps  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators as tfft  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as tsteps  # noqa: E402

SIDE = 128
METHODS = {
    "parametric-spectral": ("parametric", "spectral", {}, "auto"),
    "parametric-spatial": ("parametric", "spatial", {}, "fixed"),
    "ssft": ("ssft", "spectral", {"win_size": SIDE // 2}, "fixed"),
    "nested": ("nested", "spectral", {"max_level": 2}, None),
}


def _jax_noise_init(method, domain, noise_kwargs, adj, precip, precip_aligned, precip_min,
                    bp, key):
    """JAX's noise init, as ``pysteps_tpu/nowcasts/steps.py:664-719`` runs it."""
    m, n = precip.shape[1:]
    init = jnoise.get_method(method)[0]
    src = precip_aligned if method == "parametric" else np.asarray(precip_aligned)
    pert_gen = init(src, **noise_kwargs)
    filt = jnp.asarray(pert_gen["field"], jnp.float32)
    full = bool(pert_gen.get("use_full_fft", False))
    if domain == "spectral" and full and filt.ndim == 2:
        filt, full = filt[:, : n // 2 + 1], False
    masks = None
    if filt.ndim == 4:
        masks = jnp.asarray(jfft._ssft_gen_masks(filt.shape, (m, n), 0.2, "tukey"), jnp.float32)
    if adj == "auto":
        coeffs = jnoise.utils.compute_noise_stddev_adjs(
            precip[-1], -10.0, precip_min, bp, None, pert_gen, None, 20, conditional=True,
            key=key).astype(jnp.float32)
    elif adj == "fixed":
        coeffs = jnp.asarray([1.0 / (0.75 + 0.09 * k) for k in range(1, 9)], jnp.float32)
    else:
        coeffs = jnp.ones(8, jnp.float32)
    return filt, masks, full, coeffs


@functools.lru_cache(maxsize=None)
def _setup(case):
    """JAX's init and noise init for ``case``, the port's noise init on
    JAX's aligned inputs checked against it, and the JAX draws per lead
    (built once a case; the tests only read them)."""
    method, domain, noise_kwargs, adj = METHODS[case]
    frames, velocity = _inputs()
    precip = _to_db(frames)
    E, T, m, n = 3, 3, SIDE, SIDE
    bp = jcascade.get_method("gaussian")((m, n), 8)
    w = np.array(bp["weights_2d"], np.float32)
    key_noise, key_members, key_vel = jax.random.split(jax.random.PRNGKey(42), 3)
    statics = dict(
        E=E, ar_order=2, conditional=False, mask_method="incremental", struct_radius=2,
        mask_rim=10, vel_pert=True, n_iter=1, interp_order=1, noise_in_graph=False,
        max_disp=None,
    )
    j_al, j_par, j_st = jsteps._steps_init(
        jnp.asarray(precip), jnp.asarray(velocity), jnp.asarray(w), key_members, key_vel,
        jnp.float32(-10.0), np.ones((m, n), np.float32), **statics,
    )
    filt, masks, full, coeffs = _jax_noise_init(
        method, domain, noise_kwargs, adj, jnp.asarray(precip), j_al,
        float(j_par.precip_min), bp, key_noise)

    # the port's noise init on JAX's aligned inputs builds the same filter
    cfg = tsteps.StepsNowcasterConfig(
        n_cascade_levels=8, precip_threshold=-10.0, noise_method=method, domain=domain,
        noise_kwargs=noise_kwargs, noise_stddev_adj="fixed" if adj == "fixed" else None)
    par0, _ = tsteps.params_from_numpy(
        {f.name: np.asarray(getattr(j_par, f.name))
         for f in dataclasses.fields(jsteps.StepsNowcasterParams)},
        {k: np.asarray(getattr(j_st, k)) for k in ("window", "precip_mask", "eps_par",
                                                      "eps_perp")}, "cpu", seed=0)
    t_filt, t_full, t_masks, t_coeffs = tsteps._noise_init(
        cfg, torch.from_numpy(precip), torch.from_numpy(np.array(j_al)), par0,
        {"weights_2d": w}, torch.Generator().manual_seed(0), (m, n))
    ref_f = np.asarray(filt)
    np.testing.assert_allclose(t_filt.numpy(), ref_f, rtol=1e-4 if masks is not None else 1e-3,
                               atol=1e-4 * np.abs(ref_f).max())
    assert t_full == full and (t_masks is None) == (masks is None)
    if masks is not None:
        np.testing.assert_array_equal(t_masks.numpy(), np.asarray(masks))
    if adj == "fixed":
        np.testing.assert_array_equal(t_coeffs.numpy(), np.asarray(coeffs))

    # the JAX draws, per lead for all members: key chain fold_in(key_members,
    # i), one split per lead (nowcasts/steps.py member())
    keys = list(j_st.member_keys)
    draws = []
    for _ in range(T):
        step = []
        for i in range(E):
            keys[i], k_noise = jax.random.split(keys[i])
            if masks is not None or full:
                step.append(np.asarray(jax.random.normal(k_noise, (m, n), jnp.float32)))
            else:
                step.append(np.asarray(jfft._spectral_phase_white(k_noise, (m, n))))
        draws.append(torch.from_numpy(np.stack(step)))
    return precip, velocity, w, j_par, j_st, filt, masks, full, coeffs, domain, draws


def _hand_over(monkeypatch, draws, masks, full):
    it = iter(draws)
    if masks is not None or full:
        monkeypatch.setattr(tfft, "_white_normal", lambda g, s, b: next(it))
    else:
        monkeypatch.setattr(tfft, "_spectral_phase_white", lambda g, s, b: next(it))
    return it


@pytest.mark.parametrize("case", list(METHODS))
def test_member_update_value_by_value_with_jax_draws(monkeypatch, case):
    _, _, w, j_par, j_st, filt, masks, full, coeffs, domain, draws = _setup(case)
    E, T, m, n = 3, 3, SIDE, SIDE
    it = _hand_over(monkeypatch, draws, masks, full)
    spectral = domain == "spectral"
    window = jnp.fft.rfft2(j_st.window) if spectral else j_st.window
    flags = {"noise": True, "spectral": spectral, "shape": (m, n), "ssft_masks": masks,
             "packed": False}
    keys = list(j_st.member_keys)
    lags_j = [tuple(window[:, i] for i in range(2)) for _ in range(E)]
    lags_t = tuple(torch.from_numpy(np.array(window[:, i]))[None].expand(E, -1, -1, -1)
                   for i in range(2))
    phi_t = torch.from_numpy(np.array(j_par.phi))
    for _ in range(T):
        ref = []
        for i in range(E):
            keys[i], k_noise = jax.random.split(keys[i])
            lags_j[i], field = jsteps._member_update(
                k_noise, lags_j[i], j_par.phi, filt, (m, n), full, jnp.asarray(w), coeffs,
                j_par.means, j_par.stds, flags)
            ref.append(np.asarray(field))
        lags_t, out = tsteps._member_update(
            None, lags_t, phi_t, torch.from_numpy(np.array(filt)), (m, n),
            torch.from_numpy(w), torch.from_numpy(np.array(coeffs)),
            torch.from_numpy(np.array(j_par.means)), torch.from_numpy(np.array(j_par.stds)),
            spectral, E, use_full_fft=full,
            ssft_masks=None if masks is None else torch.from_numpy(np.array(masks)))
        _close(np.stack(ref), out, rel=1e-4)
    assert next(it, None) is None


@pytest.mark.parametrize("case", list(METHODS))
def test_scan_value_by_value_with_jax_draws(monkeypatch, case):
    precip, velocity, w, j_par, j_st, filt, masks, full, coeffs, domain, draws = _setup(case)
    E, T, m, n = 3, 3, SIDE, SIDE
    it = _hand_over(monkeypatch, draws, masks, full)
    vsf = 60.0 / 5.0
    p_par = tuple(float(v) for v in jsteps.get_default_params_bps_par())
    p_perp = tuple(float(v) for v in jsteps.get_default_params_bps_perp())
    domain_mask = np.zeros((m, n), bool)
    scan_cfg = dict(
        noise=True, mask_method="incremental", probmatching="cdf", domain=domain,
        vel_pert=True, timestep_min=5.0, mask_rim=10, struct_radius=2, n_iter=1,
        interp_order=1, need_det=False, E=E, max_disp=None,
    )
    _, ref = jsteps._steps_scan(
        j_st.window, j_st.precip_mask, j_st.member_keys, jnp.asarray(velocity), j_par.phi,
        filt, masks, (m, n), full, jnp.asarray(w), coeffs, j_par.means, j_par.stds,
        j_par.precip_last, j_par.precip_min, jnp.float32(-10.0), j_par.war, j_par.mu_0,
        jnp.asarray(domain_mask), j_st.eps_par, j_st.eps_perp, j_par.velocity_unit,
        j_par.velocity_perp, jnp.float32(vsf), p_par, p_perp, T, **scan_cfg,
    )
    par, st = tsteps.params_from_numpy(
        {f.name: np.asarray(getattr(j_par, f.name))
         for f in dataclasses.fields(jsteps.StepsNowcasterParams)},
        {k: np.asarray(getattr(j_st, k)) for k in ("window", "precip_mask", "eps_par",
                                                      "eps_perp")}, "cpu", seed=0)
    nz = tsteps.noise_from_numpy(np.asarray(filt), None if masks is None else np.asarray(masks),
                                 np.asarray(coeffs), "cpu")
    out = tsteps._steps_scan(
        st.window, st.precip_mask, st.generator, torch.from_numpy(velocity), par.phi,
        nz["noise_filt"], (m, n), torch.from_numpy(w), nz["noise_std_coeffs"], par.means,
        par.stds, par.precip_last, par.precip_min, -10.0, par.war, par.mu_0,
        torch.from_numpy(domain_mask), st.eps_par, st.eps_perp, par.velocity_unit,
        par.velocity_perp, vsf, p_par, p_perp, T, use_full_fft=full,
        ssft_masks=nz["ssft_masks"], **scan_cfg,
    )
    assert next(it, None) is None  # every lead drew once
    assert np.isnan(np.asarray(ref)).any()
    _close(ref, out, rel=1e-3)


@pytest.mark.parametrize("adj", [None, "auto", "fixed"])
@pytest.mark.parametrize("method", [None, "nonparametric", "parametric", "ssft", "nested"])
def test_every_noise_method_and_adjustment_runs(method, adj):
    """``forecast`` on the CPU with each noise method and adjustment at
    64^2: a forecast of the asked shape, mostly finite, whose members
    spread where there is noise and coincide where there is none."""
    frames, velocity = _inputs(side=64)
    precip = _to_db(frames)
    kw = {"ssft": {"win_size": 32}, "nested": {"max_level": 2}}.get(method, {})
    out = tsteps.forecast(
        precip, velocity, 2, n_ens_members=3, n_cascade_levels=6, precip_thr=-10.0,
        kmperpixel=1.0, timestep=5, domain="spectral", seed=3, noise_method=method,
        noise_stddev_adj=adj, noise_kwargs=kw, vel_pert_method=None, device="cpu")
    assert tuple(out.shape) == (3, 2, 64, 64)
    assert float(torch.isfinite(out).float().mean()) > 0.8
    spread = float(torch.nan_to_num(out.std(dim=0)).max())
    assert (spread > 0) == (method is not None)
