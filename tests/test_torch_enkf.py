"""The PCA EnKF combination in the PyTorch port against the JAX package on
the CPU (``pysteps_tpu_torch/blending/{ens_kalman_filter_methods,
pca_ens_kalman_filter}.py``), on the same numpy inputs made from a seed.

- ``masked_enkf_correct_core`` given JAX's Bernoulli draws, over its
  options, and the filter classes: analyses within 1e-4 x span (the
  analysis is the product of an eigendecomposition and a solve of
  float32 matrices formed in another summation order), the filter's
  scalars within 1e-5.  Eigenvectors are fixed up to their sign, which
  the two libraries choose differently; the update's products cancel it,
  so the comparisons are on reconstructions, never on components.
- ``_forecast_core`` given JAX's noise pool and picks, on the exact gather
  and on the shift path (the plain versions of K1), and the small
  helpers.
- ``forecast`` end to end on JAX's draws handed over (the noise pool, the
  members' picks from it, the Bernoulli draws of the resampled targets),
  and without them by the ``MODEL_PARITY.json`` CRPS recipe over two
  seeds, within 10%.

The CDF match of the forecast step may swap the ranks of pixels within
rounding of each other (see ``tests/test_torch_blending_steps.py``), and
the warp after it then interpolates the swapped values: a forecast on
JAX's draws is held with identical NaN sets, at 99.9% of its pixels
within 1e-4 x span (99.96-99.99% measured), on average within 1e-6 x
span (up to 1.4e-7 measured) and everywhere within 1e-2 x span (up to
5.4e-4 measured); one cycle of ``_forecast_core`` as a matched field of
``tests/test_torch_blending_steps.py``."""

import datetime
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_blending_steps import _held  # noqa: E402

from helpers import make_synthetic_sequence  # noqa: E402
from pysteps_tpu.blending import ens_kalman_filter_methods as jenkf  # noqa: E402
from pysteps_tpu.blending import pca_ens_kalman_filter as jpca  # noqa: E402
from pysteps_tpu.verification import probscores  # noqa: E402
from pysteps_tpu_torch import blending as tblending  # noqa: E402
from pysteps_tpu_torch.blending import ens_kalman_filter_methods as tenkf  # noqa: E402
from pysteps_tpu_torch.blending import pca_ens_kalman_filter as tpca  # noqa: E402

SIDE = 64


@pytest.fixture(autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    frames = make_synthetic_sequence(n_frames=9, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                     seed=1)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    nwp = (db[2:9] + 0.5 * np.random.RandomState(7).randn(7, SIDE, SIDE)).astype(np.float32)
    return db.astype(np.float32), velocity, nwp


def _t(x):
    return torch.from_numpy(np.array(x))


def _ensembles(seed=7, E=6, m=32, n=32):
    rng = np.random.RandomState(seed)
    bg = np.abs(rng.gamma(2.0, 2.0, (E, m, n))).astype(np.float32)
    obs = np.abs(rng.gamma(2.0, 2.5, (E, m, n))).astype(np.float32)
    bg[: E // 2, :, n // 2:] = 0.0
    return bg, obs


def _held_cycles(out, ref):
    """A combined forecast against JAX's (module docstring)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    diff = np.nan_to_num(np.abs(out - ref)) / (np.nanmax(ref) - np.nanmin(ref))
    assert np.mean(diff <= 1e-4) >= 0.999, np.mean(diff <= 1e-4)
    assert diff.mean() <= 1e-6 and diff.max() <= 1e-2, (diff.mean(), diff.max())


def _close(out, ref, rel=1e-4):
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out, np.float64)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    scale = max(np.nanmax(np.abs(ref)), 1e-30)
    assert np.nanmax(np.abs(out - ref)) <= rel * scale, np.nanmax(np.abs(out - ref)) / scale


def test_resample_core_on_jax_draws():
    rng = np.random.default_rng(0)
    a = rng.gamma(1.0, 2.0, (3, 500)).astype(np.float32)
    b = rng.gamma(1.0, 2.0, (3, 500)).astype(np.float32)
    a[0, 5] = np.nan
    keys = [jax.random.PRNGKey(i) for i in range(3)]
    ref = np.stack([np.asarray(jenkf._resample_core(jnp.asarray(a[j]), jnp.asarray(b[j]), 0.3,
                                                    keys[j])) for j in range(3)])
    pick = np.stack([np.asarray(jax.random.bernoulli(k, 0.3, (500,))) for k in keys])
    out = tenkf._resample_core(_t(a), _t(b), 0.3, pick=_t(pick))
    np.testing.assert_array_equal(out.numpy(), ref)
    drawn = tenkf._resample_core(_t(a), _t(b), 0.3, torch.Generator().manual_seed(1))
    assert tuple(drawn.shape) == (3, 500)


CORE = dict(precip_thr=0.5, norain_thr=0.0, n_ens_prec=1, n_lien=3, non_precip_mask=True,
            lien_criterion=True, inflation_factor_bg=1.0, inflation_factor_obs=1.0,
            offset_bg=0.0, offset_obs=0.0, iterative_prob_matching=True,
            sampling_prob_source="ensemble", use_accum=False, ensure_full_nwp_weight=True)
CORE_CASES = {
    "default": ({}, 0.0, 0),
    "explained_var": (dict(sampling_prob_source="explained_var", use_accum=True), 0.3, 0),
    "no_masks_inflated": (dict(non_precip_mask=False, lien_criterion=False,
                               inflation_factor_bg=1.2, inflation_factor_obs=0.8,
                               offset_bg=0.01, offset_obs=0.02), 0.0, 0),
    "near_full_nwp": ({}, 0.996, 0),
    "no_iterative": (dict(iterative_prob_matching=False, ensure_full_nwp_weight=False), 0.0, 0),
    "too_few_rainy": (dict(precip_thr=30.0), 0.0, 0),
}


@pytest.mark.parametrize("case", list(CORE_CASES))
def test_masked_enkf_correct_core_on_jax_draws(case):
    over, accum, n_tap = CORE_CASES[case]
    cfg = dict(CORE, **over)
    bg, obs = _ensembles()
    E = bg.shape[0]

    class P:
        combination_kwargs = {"n_tapering": n_tap}

    class C:
        n_ens_members = E

    taper = jenkf.EnsembleKalmanFilter(C(), P()).get_tapering(2 * E).astype(np.float32)
    res0 = bg.copy()
    key = jax.random.PRNGKey(3)
    scal = (0.1, accum, 1.0, 0.2)
    ref = jenkf.masked_enkf_correct_core(
        jnp.asarray(bg), jnp.asarray(obs), jnp.asarray(res0), key,
        *[jnp.float32(s) for s in scal], taper=jnp.asarray(taper), **cfg)
    # JAX's draws of the resampled target: one fold of the key a member
    p_first = 1.0 - ref[2]
    pick = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(key, j), p_first,
                                                     (bg[0].size,))) for j in range(E)])
    out = tenkf.masked_enkf_correct_core(
        _t(bg), _t(obs), _t(res0), None, *[torch.tensor(s, dtype=torch.float32) for s in scal],
        taper=_t(taper), pick=_t(pick), **cfg)
    _close(out[0].numpy(), ref[0])
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for a, b in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5)


@pytest.mark.parametrize("n_tapering", [0, 2])
def test_enkf_update_and_covariance(n_tapering):
    class Cfg:
        n_ens_members = 8
        precip_threshold = 0.5

    class Params:
        combination_kwargs = {"n_tapering": n_tapering}

    rng = np.random.RandomState(0)
    bg = (rng.randn(8, 10) + 5.0).astype(np.float32)
    obs = (rng.randn(8, 10) * 0.1).astype(np.float32)
    t, j = tenkf.EnsembleKalmanFilter(Cfg(), Params()), jenkf.EnsembleKalmanFilter(Cfg(), Params())
    np.testing.assert_array_equal(t.get_tapering(10), j.get_tapering(10))
    _close(t.get_covariance_matrix(_t(bg), 1.1, 0.01).numpy(),
           j.get_covariance_matrix(bg, 1.1, 0.01), 1e-5)
    _close(t.update(bg, obs, 1.0, 1.2, device="cpu").numpy(), j.update(bg, obs, 1.0, 1.2))
    _close(t.K.numpy(), j.K)
    ens = np.abs(rng.gamma(1.0, 1.0, (8, 6, 6))).astype(np.float32)
    np.testing.assert_array_equal(t.get_precipitation_mask(_t(ens)), j.get_precipitation_mask(ens))
    np.testing.assert_array_equal(t.get_lien_criterion(_t(ens), _t(ens[::-1].copy())),
                                  j.get_lien_criterion(ens, ens[::-1].copy()))
    a, b, c = rng.randn(3, 8, 20).astype(np.float32)
    assert t.get_weighting_for_probability_matching(a, b, c) == \
        j.get_weighting_for_probability_matching(a, b, c)


@pytest.mark.parametrize("source", ["ensemble", "explained_var"])
def test_masked_enkf_correct_step(source):
    class Cfg:
        n_ens_members = 6
        precip_threshold = 0.5
        norain_threshold = 0.0

    class Params:
        combination_kwargs = {"n_lien": 3, "sampling_prob_source": source,
                              "iterative_prob_matching": False}

    bg, obs = _ensembles(11)
    t, j = tenkf.MaskedEnKF(Cfg(), Params()), jenkf.MaskedEnKF(Cfg(), Params())
    for _ in range(2):  # the filter's state carries over
        out, _ = t.correct_step(_t(bg), _t(obs))
        ref, _ = j.correct_step(bg.copy(), obs.copy(), rng_key=jax.random.PRNGKey(0))
        _close(out.numpy(), ref)
        assert abs(t.sampling_probability - j.sampling_probability) <= 1e-5
        assert abs(t.get_inflation_factor_obs() - j.get_inflation_factor_obs()) <= 1e-5
    # iterative matching draws a target of the analysis' shape
    t2 = tenkf.MaskedEnKF(Cfg(), type("P", (), {"combination_kwargs": {"n_lien": 3}})())
    _, res = t2.correct_step(_t(bg), _t(obs), resampled_forecast=_t(bg),
                             generator=torch.Generator().manual_seed(0))
    assert tuple(res.shape) == bg.shape
    dry, _ = t.correct_step(torch.zeros_like(_t(bg)), torch.zeros_like(_t(obs)))
    assert float(dry.abs().max()) == 0.0


def test_helpers_against_jax(data):
    db, _, nwp = data
    mask = db[2] > 0.0
    for size in (1, 3, 4):
        np.testing.assert_array_equal(tpca._square_dilate(_t(mask)[None], size)[0].numpy(),
                                      np.asarray(jpca._square_dilate(jnp.asarray(mask), size)))
    np.testing.assert_allclose(tpca._gauss1(_t(db[2])).numpy(),
                               np.asarray(jpca._gauss1(jnp.asarray(db[2]))), atol=1e-5)
    x = np.stack([nwp[:3], nwp[:3] + 1.0])
    x[0, 0, 1, 2] = np.nan
    mm = np.array([0, 1, 0, 1, 1])
    np.testing.assert_array_equal(
        tpca._prep_nwp(_t(x), _t(mm), -10.0, -12.0).numpy(),
        np.asarray(jpca._prep_nwp(jnp.asarray(x), jnp.asarray(mm), -10.0, -12.0)))
    casc = np.stack([db[k:k + 3] * (0.5 + 0.1 * k) for k in range(4)]).astype(np.float32)
    for p, norain in ((1, False), (2, False), (1, True)):
        _close(tpca._fit_ar(_t(casc[:, -p - 1:]), p, norain).numpy(),
               jpca._fit_ar(jnp.asarray(casc[:, -p - 1:]), p, norain), 1e-5)


def _jax_pool_and_picks(keys, n_pool):
    idx = []
    new = []
    for k in keys:
        k2, sub = jax.random.split(k)
        new.append(k2)
        idx.append(int(jax.random.randint(sub, (), 0, n_pool)))
    return np.array(idx), new


@pytest.mark.parametrize("is_corr,max_disp", [(False, None), (True, None), (True, 12)])
def test_forecast_core_on_jax_noise(data, is_corr, max_disp):
    db, velocity, nwp = data
    E, k, p = 3, 6, 1
    w2 = jpca.cascade.get_method("gaussian")((SIDE, SIDE), k)["weights_2d"].astype(np.float32)
    key = jax.random.PRNGKey(5)
    pool = np.asarray(jpca._init_noise_pool(key, jnp.ones((SIDE, SIDE // 2 + 1)), (SIDE, SIDE),
                                            False, jnp.asarray(w2), 4, k))
    nwc = np.stack([db[2], db[2] + 0.3, db[2] - 0.2]).astype(np.float32)
    lev, mu, sig = jax.vmap(lambda f: jpca.decompose_core(f, jnp.asarray(w2)))(jnp.asarray(nwc))
    cascades = np.asarray(lev)[:, :, None]
    phi = np.tile(np.array([[0.9, 0.4]], np.float32), (k, 1))
    nsc = np.linspace(1.0, 1.5, k).astype(np.float32)
    res_mask = np.arange(k) < 3
    dom = np.zeros((SIDE, SIDE), bool)
    dom[:, :4] = True
    targ = np.stack([nwp[1], nwp[2], nwp[1] + 0.5]).astype(np.float32)
    nwp_m = np.stack([nwp[0]] * E)
    keys = [jax.random.PRNGKey(10 + j) for j in range(E)]
    ref = jpca._forecast_core(
        jnp.asarray(nwc), jnp.asarray(cascades), mu, sig, jnp.stack(keys), jnp.asarray(nwp_m),
        jnp.asarray(targ), jnp.asarray(w2), jnp.asarray(phi), jnp.asarray(nsc),
        jnp.asarray(res_mask), jnp.asarray(pool), jnp.asarray(velocity), jnp.asarray(dom),
        -10.0, -12.0, is_corr, 3, max_disp)
    idx, _ = _jax_pool_and_picks(keys, 4)
    out = tpca._forecast_core(
        _t(nwc), _t(cascades), _t(mu), _t(sig), None, _t(nwp_m), _t(targ), _t(w2), _t(phi),
        _t(nsc), _t(res_mask), _t(pool), _t(velocity), _t(dom), -10.0, -12.0, is_corr, 3,
        max_disp, idx=_t(idx))
    _held(out[0].numpy()[:, None], np.asarray(ref[0])[:, None])
    for a, b in zip(out[1:], ref[1:4]):
        _close(a.numpy(), b)


def _hand_over_jax_draws(monkeypatch, seed, E, n_nwp):
    """Hand the JAX forecast's draws to the port: its noise pool (recorded
    from JAX's run, which must come first), each forecast cycle's picks
    from it (one split of each member's key a cycle) and each
    correction's Bernoulli draws of the resampled target (one split of
    the resampling key a correction, one fold of it a member)."""
    rec = {}
    real = jpca._init_noise_pool

    def recording(*args):
        rec["pool"] = np.asarray(real(*args))
        return rec["pool"]

    monkeypatch.setattr(jpca, "_init_noise_pool", recording)
    monkeypatch.setattr(tpca, "_init_noise_pool",
                        lambda *args: torch.from_numpy(rec["pool"].copy()))
    base = jax.random.PRNGKey(seed)
    _, key_members = jax.random.split(base)
    keys = [jax.random.fold_in(key_members, i) for i in range(E)]
    state = {"keys": keys, "rng": jax.random.fold_in(base, 777)}

    def picks(generator, n_pool, E_):
        idx, state["keys"] = _jax_pool_and_picks(state["keys"], n_pool)
        return torch.from_numpy(idx)

    def bernoulli(generator, p, shape):
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(sub, j), float(p), shape[1:])) for j in range(shape[0])]))

    monkeypatch.setattr(tpca, "_pool_picks", picks)
    monkeypatch.setattr(tenkf.probmatching, "_bernoulli", bernoulli)


ENKF_CASES = {
    "default": {},
    "timestamps": dict(timestamps=True),
    "fixed_adj_dilated": dict(noise_stddev_adj="fixed", precip_mask_dilation=3),
    "no_combination": dict(enable_combination=False),
    "enkf_method": dict(enkf_method="enkf"),
    "smooth_mask": dict(smooth_radar_mask_range=10, domain_nan=True),
    "accumulated": dict(combination_kwargs={"use_accum_sampling_prob": True,
                                            "sampling_prob_source": "explained_var",
                                            "iterative_prob_matching": False}),
}


@pytest.mark.parametrize("case", list(ENKF_CASES))
def test_forecast_deterministic(data, case, monkeypatch):
    db, velocity, nwp = data
    kw = dict(ENKF_CASES[case])
    obs = db[1:3].copy()
    if kw.pop("domain_nan", False):
        obs[:, :, :5] = np.nan
    nwp_ens = np.stack([nwp[:4], nwp[:4] + 0.2])
    ts = dict(obs_timestamps=None, nwp_timestamps=None)
    horizon = 3
    if kw.pop("timestamps", False):
        t0 = datetime.datetime(2021, 6, 29, 12, 0)
        ts = dict(obs_timestamps=np.array([t0 - datetime.timedelta(minutes=5), t0]),
                  nwp_timestamps=np.array([t0 + datetime.timedelta(minutes=5 * i)
                                           for i in range(4)]), issuetime=t0)
        horizon = 15
    ckw = kw.pop("combination_kwargs", {})
    _hand_over_jax_draws(monkeypatch, 42, 4, 2)
    args = (obs, ts.pop("obs_timestamps"), nwp_ens, ts.pop("nwp_timestamps"), velocity,
            horizon)
    common = dict(n_ens_members=4, precip_thr=-10.0, seed=42, combination_kwargs=ckw, **ts, **kw)
    ref = np.asarray(jpca.forecast(*args, **common))
    out = tblending.get_method("pca_enkf")(*args, device="cpu", **common)
    assert out.device.type == "cpu"
    _held_cycles(out.numpy(), ref)


def test_forecast_callback_verbose_and_return_output(data, capsys):
    db, velocity, nwp = data
    nwp_ens = np.stack([nwp[:4], nwp[:4] + 0.2])
    kw = dict(n_ens_members=4, precip_thr=-10.0, seed=42, device="cpu")
    frames = []
    res = tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 3, callback=frames.append,
                        return_output=False, verbose_output=True, **kw)
    full = tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 3, **kw)
    assert res is None and len(frames) == 3
    np.testing.assert_array_equal(np.stack(frames, axis=1), full[:, 1:].numpy())
    out, init_s, loop_s = tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 3,
                                        measure_time=True, **kw)
    np.testing.assert_array_equal(out.numpy(), full.numpy())
    assert init_s >= 0 and loop_s >= 0
    with pytest.raises(TypeError):
        tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 3, mesh=object(), **kw)


def test_noise_stddev_adj_auto_runs_where_jax_raises(data):
    """JAX's ``EnKFCombinationNowcaster`` hands the bare filter to
    ``compute_noise_stddev_adjs``, which reads ``noise_filter["field"]``
    and raises; the port hands it the filter's dict."""
    db, velocity, nwp = data
    nwp_ens = np.stack([nwp[:4], nwp[:4] + 0.2])
    kw = dict(n_ens_members=2, precip_thr=-10.0, seed=1, noise_stddev_adj="auto")
    with pytest.raises(TypeError):
        jpca.forecast(db[1:3], None, nwp_ens, None, velocity, 2, **kw)
    out = tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 2, device="cpu", **kw)
    assert tuple(out.shape) == (2, 3, SIDE, SIDE) and bool(torch.isfinite(out).all())


def test_forecast_crps_parity(data):
    db, velocity, nwp = data
    nwp_ens = np.stack([nwp[:3], nwp[:3] + 0.2])
    j, t = [], []
    for seed in (11, 22):
        kw = dict(n_ens_members=8, precip_thr=-10.0, seed=seed)
        j.append(probscores.CRPS(np.asarray(jpca.forecast(
            db[1:3], None, nwp_ens, None, velocity, 3, **kw))[:, -1], db[5]))
        out = tpca.forecast(db[1:3], None, nwp_ens, None, velocity, 3, device="cpu", **kw)
        assert float(out[:, 1:].std(dim=0).mean()) > 0
        t.append(probscores.CRPS(out[:, -1].numpy(), db[5]))
    assert abs(np.mean(t) - np.mean(j)) / np.mean(j) <= 0.1, (t, j)


def test_pca_enkf_256_schedule_against_jax(capsys):
    """The bench's ``pca_enkf_256`` (``bench.py:312-343``; ``chip_smoke.py``'s
    path W): 24 members at 256^2, 6 levels, a 60-minute horizon.  Both
    packages take the NWP ensemble as it is at 55 and 60 minutes, where
    the observations' inflation has decayed below 0.02, and make a nowcast
    step in the 10 other cycles; the chip check counts its K1 launches
    from this schedule."""
    side, E, T = 256, 24, 12
    frames = make_synthetic_sequence(n_frames=4, shape=(side, side), velocity=(2.0, 1.0),
                                     seed=42)
    db = np.where(frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0)
    db = (db + 0.1 * np.random.RandomState(7).randn(*db.shape)).astype(np.float32)
    velocity = np.zeros((2, side, side), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    t0 = datetime.datetime(2021, 6, 29, 12, 0)
    obs_ts = np.array([t0 - datetime.timedelta(minutes=5), t0])
    nwp_ts = np.array([t0 + datetime.timedelta(minutes=5 * i) for i in range(T + 1)])
    rng = np.random.RandomState(1)
    nwp = np.stack([np.repeat(db[2][None], T + 1, axis=0) + 0.5 * rng.randn(T + 1, side, side)
                    for _ in range(E)]).astype(np.float32)
    capsys.readouterr()
    jpca.forecast(db[:2], obs_ts, nwp, nwp_ts, velocity, 5 * T, issuetime=t0, n_ens_members=E,
                  n_cascade_levels=6, precip_thr=-10.0, norain_thr=0.01, seed=43,
                  verbose_output=True)
    jax_leads = [int(line.split("+")[1].split()[0]) for line in capsys.readouterr().out.splitlines()
                 if line.startswith("Full NWP weight is reached")]
    cfg = tpca.EnKFCombinationConfig(n_ens_members=E, n_cascade_levels=6, precip_threshold=-10.0,
                                     norain_threshold=0.01, seed=43)
    run = tpca.EnKFCombinationNowcaster(db[:2], nwp, velocity, 5 * T,
                                        enkf_combination_config=cfg, obs_timestamps=obs_ts,
                                        nwp_timestamps=nwp_ts, issuetime=t0, device="cpu")
    run.compute_forecast()
    assert jax_leads == run.full_nwp_leads == [55, 60]


def test_cycle_scan_equals_cycles_and_the_class_api(data):
    """``_cycle_scan`` is successive ``_cycle`` calls; ``ForecastModel``'s
    correction is ``MaskedEnKF.correct_step``; ``ForecastInitialization``
    gives the uncombined background without the t0 analysis."""
    db, velocity, nwp = data
    E, k = 4, 6
    w2 = torch.tensor(tpca.cascade.get_method("gaussian")((SIDE, SIDE), k)["weights_2d"],
                      dtype=torch.float32)
    nwc = _t(np.stack([nwp[0], nwp[1], nwp[0] + 0.3, nwp[1] - 0.3]))
    levels, mu, sig = tpca.decompose_core(nwc, w2)
    pool = tpca._init_noise_pool(torch.Generator().manual_seed(0), torch.ones(SIDE, SIDE // 2 + 1),
                                 (SIDE, SIDE), False, w2, 5, k)
    nwp_m = _t(np.stack([nwp[:4]] * E))
    consts = (w2, torch.tensor([[0.9, 0.3]] * k), torch.ones(k), torch.ones(k, dtype=torch.bool),
              pool, _t(velocity), torch.zeros(SIDE, SIDE, dtype=torch.bool), torch.eye(2 * E),
              torch.zeros(1, 1), -10.0, -12.0)
    cfg = dict(CORE, precip_thr=-10.0, n_lien=2, iterative_prob_matching=False)
    statics = dict(is_corr=True, dil=1, max_disp=None, obs_norain=False, corr_cfg=cfg,
                   has_smooth=False)

    def carry():
        return (nwc, levels[:, :, None], mu, sig, torch.Generator().manual_seed(1), nwc,
                *[torch.tensor(v) for v in (0.0, 0.0, 1.0, 0.2)])

    c_scan, outs = tpca._cycle_scan(carry(), nwp_m, [1, 2], [2, 3], *consts, **statics)
    c, out1, _ = tpca._cycle(carry(), nwp_m, 1, 2, *consts, **statics)
    c, out2, _ = tpca._cycle(c, nwp_m, 2, 3, *consts, **statics)
    np.testing.assert_array_equal(outs.numpy(), torch.stack([out1, out2]).numpy())

    class Cfg:
        n_ens_members, precip_threshold, norain_threshold = E, -10.0, 0.0

    class Par:
        combination_kwargs = {"n_lien": 2, "iterative_prob_matching": False}

    model = tpca.ForecastModel(Cfg(), Par(), tenkf.MaskedEnKF(Cfg(), Par()))
    state = tpca.ForecastState(analysis=nwc, generator=torch.Generator().manual_seed(0))
    new = model.correction_step(state, nwc, nwp_m[:, 2], 3)
    ref, _ = tenkf.MaskedEnKF(Cfg(), Par()).correct_step(nwc, nwp_m[:, 2])
    np.testing.assert_array_equal(new.analysis.numpy(), ref.numpy())
    assert new.timestep == 1 and model.forecast_step(new, nwc).timestep == 2
    cfg_init = tpca.EnKFCombinationConfig(n_ens_members=2, precip_threshold=-10.0, seed=3)
    bg = tpca.ForecastInitialization(db[1:3], velocity, cfg_init, 2,
                                     device="cpu").compute_background()
    assert tuple(bg.shape) == (2, 2, SIDE, SIDE) and not bool(torch.isnan(bg).any())
