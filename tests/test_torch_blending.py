"""The port's blending components against the JAX package on the CPU, on
the same numpy inputs made from a seed: ``utils/pca.py``, ``clim``,
``skill_scores``, the weights of ``blending/steps.py``, ``blending/utils``,
linear and salient blending and the registry.

Tolerances: the host numpy code (clim, the weights, the skill regression)
is the same code and is held to 1e-12 relative; float32 device code to
1e-5 (correlations, weighted sums) or 1e-4 x the largest value where an
FFT or a convolution sums in another order.  Principal components are
fixed up to their sign, which the libraries choose differently, so PCA is
held on its explained variance, its scores up to each component's sign
and its reconstructions."""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import make_synthetic_sequence
from pysteps_tpu import blending as jblending
from pysteps_tpu.blending import clim as jclim
from pysteps_tpu.blending import skill_scores as jskill
from pysteps_tpu.blending import steps as jsteps
from pysteps_tpu.blending import utils as jutils
from pysteps_tpu.utils import pca as jpca
from pysteps_tpu_torch import blending as tblending
from pysteps_tpu_torch.blending import clim as tclim
from pysteps_tpu_torch.blending import skill_scores as tskill
from pysteps_tpu_torch.blending import steps as tsteps
from pysteps_tpu_torch.blending import utils as tutils
from pysteps_tpu_torch.utils import pca as tpca

SIDE = 64


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def data():
    frames = make_synthetic_sequence(n_frames=6, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                     seed=1)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 2.0, 1.0
    nwp = (db[2:6] + 0.5 * np.random.RandomState(7).randn(4, SIDE, SIDE)).astype(np.float32)
    return db.astype(np.float32), velocity, nwp


# --- utils/pca.py ---------------------------------------------------------


def _ens(seed=0, n=6, p=200):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(3, p))
    return (rng.normal(size=(n, 3)) @ base + 0.1 * rng.normal(size=(n, p))).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_pca_transform_and_backtransform(masked):
    X = _ens()
    mask = np.random.default_rng(1).random(X.shape[1]) > 0.3 if masked else None
    ref, jpar = jpca.pca_transform(X, get_params=True)
    out, tpar = tpca.pca_transform(X, get_params=True, device="cpu")
    np.testing.assert_allclose(tpar["mean"].numpy(), np.asarray(jpar["mean"]), atol=1e-6)
    np.testing.assert_allclose(tpar["explained_variance"].numpy(),
                               np.asarray(jpar["explained_variance"]), atol=1e-5)
    # the leading components (above rounding) up to their sign
    k = 3
    sign = np.sign(np.sum(tpar["principal_components"].numpy()[:k]
                          * np.asarray(jpar["principal_components"])[:k], axis=1))
    np.testing.assert_allclose(out.numpy()[:, :k] * sign, np.asarray(ref)[:, :k],
                               atol=1e-4 * np.abs(ref).max())
    if masked:
        ref_m = np.asarray(jpca.pca_transform(X, mask=jnp.asarray(mask), pca_params=jpar))
        out_m = tpca.pca_transform(X, mask=torch.from_numpy(mask), pca_params=tpar,
                                   device="cpu").numpy()
        np.testing.assert_allclose(out_m[:, :k] * sign, ref_m[:, :k],
                                   atol=1e-4 * np.abs(ref_m).max())
    back = tpca.pca_backtransform(out, tpar).numpy()
    jback = np.asarray(jpca.pca_backtransform(ref, jpar))
    np.testing.assert_allclose(back, jback, atol=1e-4 * np.abs(X).max())
    np.testing.assert_allclose(back, X, atol=1e-4 * np.abs(X).max())


def test_pca_n_components_errors_and_mesh():
    X = _ens(2)
    out, par = tpca.pca_transform(X, get_params=True, n_components=2, device="cpu")
    assert tuple(out.shape) == (6, 2) and tuple(par["principal_components"].shape) == (2, 200)
    for bad, err in (({"mean": par["mean"]}, KeyError),
                     ({"principal_components": par["principal_components"]}, KeyError),
                     ({"principal_components": par["principal_components"],
                       "mean": par["mean"][:10]}, ValueError)):
        with pytest.raises(err):
            tpca.pca_transform(X, pca_params=bad, device="cpu")
        with pytest.raises(err):
            jpca.pca_transform(X, pca_params={k: np.asarray(v) for k, v in bad.items()})
    with pytest.raises(ValueError):
        tpca.pca_transform(X[0], device="cpu")
    with pytest.raises(TypeError):
        tpca.pca_transform(X, mesh=object(), device="cpu")


# --- clim and skill_scores ---------------------------------------------------


@pytest.mark.parametrize("levels,models", [(6, 1), (10, 2), (3, 1)])
def test_default_skill(levels, models):
    np.testing.assert_array_equal(tclim.get_default_skill(levels, models),
                                  jclim.get_default_skill(levels, models))


@pytest.mark.parametrize("days", [1, 31])
def test_save_skill_and_clim(days, tmp_path):
    t0 = datetime.datetime(2026, 8, 1, 12)
    for port, path in ((tclim, tmp_path / "t"), (jclim, tmp_path / "j")):
        r = np.random.default_rng(days)
        for d in range(days):
            for h in range(2):
                port.save_skill(r.uniform(0.01, 0.9, (1, 6)),
                                t0 + datetime.timedelta(days=d, hours=h), str(path))
    out = tclim.calc_clim_skill(str(tmp_path / "t"), 6, 1)
    ref = jclim.calc_clim_skill(str(tmp_path / "j"), 6, 1)
    np.testing.assert_allclose(out, ref, rtol=1e-12)


def test_skill_regression_and_extrapolation(tmp_path):
    rho0 = np.array([0.9, 0.8, 0.7, 0.5, 0.3, 0.1])
    for lt in (5, 60, 240):
        np.testing.assert_allclose(tskill.lt_dependent_cor_nwp(lt, rho0, str(tmp_path)),
                                   jskill.lt_dependent_cor_nwp(lt, rho0, str(tmp_path)),
                                   rtol=1e-12)
    for k in (4, 10):
        for a, b in zip(tskill.clim_regr_values(k, str(tmp_path)),
                        jskill.clim_regr_values(k, str(tmp_path))):
            np.testing.assert_array_equal(a, b)
    phi = np.array([[0.9, -0.1, 0.3], [0.5, 0.2, 0.6]])
    for order in (1, 2):
        t = tskill.lt_dependent_cor_extrapolation(phi, ar_order=order)
        j = jskill.lt_dependent_cor_extrapolation(phi, ar_order=order)
        t2 = tskill.lt_dependent_cor_extrapolation(phi, t[0], t[1], order)
        j2 = jskill.lt_dependent_cor_extrapolation(phi, j[0], j[1], order)
        for a, b in zip(t + t2, j + j2):
            np.testing.assert_allclose(a, b, rtol=1e-12)
    with pytest.raises(ValueError):
        tskill.lt_dependent_cor_extrapolation(phi, ar_order=3)


@pytest.mark.parametrize("with_nan", [False, True])
def test_spatial_correlation(with_nan):
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(4, 32, 32)).astype(np.float32)
    mod = (0.7 * obs + 0.5 * rng.normal(size=obs.shape)).astype(np.float32)
    dom = np.zeros((32, 32), bool)
    dom[:, :5] = True
    if with_nan:
        mod[1, 3, 7] = np.nan
    out = tskill.spatial_correlation(obs, mod, dom, device="cpu")
    ref = jskill.spatial_correlation(obs, mod, dom)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, ref, atol=1e-5)


# --- the weights -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 6), (1, 6), (3, 4)])
def test_weights_bps(shape):
    corr = np.random.default_rng(shape[0]).uniform(-0.05, 0.95, shape)
    np.testing.assert_array_equal(tsteps.calculate_ratios(corr), jsteps.calculate_ratios(corr))
    np.testing.assert_array_equal(tsteps.calculate_weights_bps(corr),
                                  jsteps.calculate_weights_bps(corr))


@pytest.mark.parametrize("cov", [[[1.0, 0.5], [0.5, 1.0]], [[1.0, 1.0], [1.0, 1.0]], None])
def test_weights_spn(cov):
    corr = np.array([0.8, 0.6])
    cov = None if cov is None else np.array(cov)
    np.testing.assert_array_equal(tsteps.calculate_weights_spn(corr, cov),
                                  jsteps.calculate_weights_spn(corr, cov))


@pytest.mark.parametrize("model_only", [False, True])
def test_end_weights(model_only):
    w = jsteps.calculate_weights_bps(np.array([[0.8, 0.5, 0.2], [0.6, 0.3, 0.1]]))
    for t in (3, 5, 8):
        np.testing.assert_array_equal(
            tsteps.calculate_end_weights(w, t, 8, 2, model_only),
            jsteps.calculate_end_weights(w, t, 8, 2, model_only))


def test_blend_means_sigmas():
    rng = np.random.default_rng(4)
    means, sigmas = rng.normal(size=(2, 6)), rng.uniform(0.5, 2, (2, 6))
    weights = rng.uniform(0, 1, (3, 6))
    for m, s, w in ((means, sigmas, weights), (means[:, 0], sigmas[:, 0], weights[:, :1]),
                    (means, sigmas, np.zeros((3, 6)))):
        out = tsteps.blend_means_sigmas(m, s, w, device="cpu")
        ref = jsteps.blend_means_sigmas(m, s, w)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_presort_targets(data):
    db, _, nwp = data
    fields = nwp[None, :3].transpose(1, 0, 2, 3).copy()
    fields[0, 0, 3, 4] = np.nan
    out = tsteps._presort_targets(_t(db[2]), _t(fields), torch.tensor(-15.0))
    ref = jsteps._presort_targets(jnp.asarray(db[2]), jnp.asarray(fields), jnp.float32(-15.0))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- blending/utils.py ------------------------------------------------------


def test_cascade_stacking_blending_recompose(data):
    rng = np.random.default_rng(5)
    decomps = [{"cascade_levels": rng.normal(size=(4, 16, 16)).astype(np.float32),
                "means": rng.normal(size=4).astype(np.float32),
                "stds": rng.uniform(0.5, 2, 4).astype(np.float32)} for _ in range(3)]
    for donorm in (True, False):
        out = tutils.stack_cascades(decomps, donorm, device="cpu")
        ref = jutils.stack_cascades(decomps, donorm)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    casc = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    w = rng.uniform(size=(2, 4)).astype(np.float32)
    for c in (casc, casc[..., 0, 0]):
        np.testing.assert_allclose(tutils.blend_cascades(c, w, device="cpu").numpy(),
                                   np.asarray(jutils.blend_cascades(c, jnp.asarray(w))),
                                   rtol=1e-6, atol=1e-6)
    mu, sig = rng.normal(size=4).astype(np.float32), rng.uniform(1, 2, 4).astype(np.float32)
    np.testing.assert_allclose(tutils.recompose_cascade(casc[0], mu, sig, device="cpu").numpy(),
                               np.asarray(jutils.recompose_cascade(casc[0], mu, sig)),
                               rtol=1e-5, atol=1e-5)
    flows = [rng.normal(size=(2, 8, 8)).astype(np.float32) for _ in range(3)]
    np.testing.assert_allclose(
        tutils.blend_optical_flows(flows, [1.0, 2.0, 3.0], device="cpu").numpy(),
        np.asarray(jutils.blend_optical_flows(flows, jnp.asarray([1.0, 2.0, 3.0]))),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tutils.blend_optical_flows(flows, [1.0, 2.0], device="cpu")


@pytest.mark.parametrize("kw", [dict(max_padding_size_in_px=0), dict(max_padding_size_in_px=12),
                                dict(max_padding_size_in_px=20, inverted=True),
                                dict(max_padding_size_in_px=16,
                                     non_linear_growth_kernel_sizes=True)])
def test_smooth_dilated_mask(kw):
    mask = np.zeros((SIDE, SIDE), bool)
    mask[10:40, 15:50] = True
    mask[45:50, 5:9] = True
    out = tutils.compute_smooth_dilated_mask(mask, device="cpu", **kw).numpy()
    ref = np.asarray(jutils.compute_smooth_dilated_mask(mask, **kw))
    np.testing.assert_allclose(out, ref, atol=1e-6)
    with pytest.raises(ValueError):
        tutils.compute_smooth_dilated_mask(mask, max_padding_size_in_px=-1, device="cpu")


def test_nwp_store_roundtrip(data, tmp_path):
    db, velocity, nwp = data
    out = tutils.decompose_NWP(nwp, "m1", num_cascade_levels=4, device="cpu")
    ref = jutils.decompose_NWP(nwp, "m1", num_cascade_levels=4)
    for key in ("cascade_levels", "means", "stds"):
        np.testing.assert_allclose(out[key], ref[key], atol=1e-4 * np.abs(ref[key]).max())
    path = tutils.decompose_NWP(nwp, "m1", analysis_time="t0", num_cascade_levels=4,
                                output_path=str(tmp_path), device="cpu")

    def oflow(pair):
        return np.broadcast_to(velocity, (2, SIDE, SIDE)) * float(np.mean(pair) > -100)

    vpath = tutils.compute_store_nwp_motion(nwp, oflow, "t0", "m1", str(tmp_path))
    np.testing.assert_array_equal(np.load(vpath), jutils.compute_store_nwp_motion(nwp, oflow))
    dec, vel = tutils.load_NWP(path, vpath, n_timesteps=2)
    jdec, jvel = jutils.load_NWP(path, vpath, n_timesteps=2)
    assert dec.keys() == jdec.keys() and dec["cascade_levels"].shape[0] == 3
    for key in ("cascade_levels", "means", "stds", "valid_times"):
        np.testing.assert_array_equal(dec[key], jdec[key])
    np.testing.assert_array_equal(vel, jvel)


def test_check_norain_alias_warns():
    x = np.full((2, 8, 8), -15.0, np.float32)
    with pytest.warns(DeprecationWarning):
        assert tutils.check_norain(x, -10.0, 0.0) is True


# --- linear and salient blending and the registry --------------------------


@pytest.mark.parametrize("method,kw", [
    ("linear_blending", dict(start_blending=5, end_blending=15)),
    ("salient_blending", dict(start_blending=5, end_blending=20)),
    ("linear_blending", dict(start_blending=5, end_blending=15, fill_nwp=False, ens=True)),
    ("salient_blending", dict(start_blending=0, end_blending=30, ens=True)),
    ("linear_blending", dict(no_nwp=True)),
])
def test_linear_and_salient_blending(data, method, kw):
    db, velocity, nwp = data
    kw = dict(kw)
    meta = {"transform": "dB", "unit": "mm/h", "threshold": -10.0, "zerovalue": -15.0}
    rr_nwp = (10.0 ** (nwp[:3] / 10.0)).astype(np.float32)
    if kw.pop("ens", False):
        rr_nwp = np.stack([rr_nwp, rr_nwp * 1.1])
    if kw.pop("no_nwp", False):
        rr_nwp = None
    ref = np.asarray(jblending.get_method(method)(
        db[1], meta, velocity, 3, 5, "extrapolation", precip_nwp=rr_nwp, **kw))
    out = tblending.get_method(method)(
        db[1], meta, velocity, 3, 5, "extrapolation", precip_nwp=rr_nwp, device="cpu", **kw)
    assert out.device.type == "cpu" and tuple(out.shape) == ref.shape
    np.testing.assert_array_equal(np.isnan(out.numpy()), np.isnan(ref))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4 * np.nanmax(ref))


def test_salience_rank_and_weight():
    rng = np.random.default_rng(8)
    now = rng.gamma(0.7, 2.0, (32, 32)).astype(np.float32)
    nwp = np.round(rng.gamma(0.7, 2.0, (32, 32)), 1).astype(np.float32)
    ranked = tblending.linear_blending._ranked_salience(_t(now), _t(nwp))
    jranked = jblending.linear_blending._ranked_salience(jnp.asarray(now), jnp.asarray(nwp))
    np.testing.assert_allclose(ranked.numpy(), np.asarray(jranked), atol=1e-7)
    for w in (0.2, 0.7):
        np.testing.assert_allclose(
            tblending.linear_blending._salience_weight(w, ranked).numpy(),
            np.asarray(jblending.linear_blending._salience_weight(w, jranked)), atol=1e-6)


def test_registry():
    for name in ("linear_blending", "salient_blending", "steps", "pca_enkf", "STEPS"):
        assert callable(tblending.get_method(name))
        assert callable(jblending.get_method(name))
    for bad in ("nope", "pca"):
        with pytest.raises(ValueError) as out:
            tblending.get_method(bad)
        with pytest.raises(ValueError) as ref:
            jblending.get_method(bad)
        assert str(out.value) == str(ref.value)
    with pytest.raises(ValueError):
        tblending.get_method(None)
