"""``pysteps_tpu_torch.postprocessing`` against ``pysteps_tpu.postprocessing``
on the CPU: the rest of probmatching (empirical CDF, the exact matcher
with and without ignored pixels, the PMM interpolator, two-moment
matching, the resampling of two distributions on JAX's own Bernoulli
draw), the ensemble statistics and both registries.

Inputs: numpy-seeded (16, 48, 40) ensembles of gamma-distributed rain
with dry pixels and, where said, NaNs.  Tolerances: exceedance
probabilities, band-depth ranks and the matcher's permutations equal;
float sums within 1e-6 relative; ``interp`` equal to ``jnp.interp`` (and
to ``np.interp`` at the ends and on tied knots) within 1e-6; two-moment
matching's shift and scale within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysteps_tpu.postprocessing as jpp
import pysteps_tpu_torch.postprocessing as tpp
from pysteps_tpu.postprocessing import diagnostics as jdiag
from pysteps_tpu.postprocessing import ensemblestats as jes
from pysteps_tpu.postprocessing import interface as jif
from pysteps_tpu.postprocessing import probmatching as jpm
from pysteps_tpu_torch.postprocessing import diagnostics as tdiag
from pysteps_tpu_torch.postprocessing import ensemblestats as tes
from pysteps_tpu_torch.postprocessing import interface as tif
from pysteps_tpu_torch.postprocessing import probmatching as tpm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the tier-1 run
    shares the machine's cores among its workers, and a pool of one thread
    a core in each worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ensemble(seed=0, nan=False, shape=(16, 48, 40)):
    rng = np.random.default_rng(seed)
    X = np.maximum(rng.gamma(0.7, 4.0, shape) - 1.5, 0.0).astype(np.float32)
    if nan:
        X[:, :3, :] = np.nan
        X[2, 10:14, 5:9] = np.nan
    return X


def _close(out, ref, rtol=1e-6):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    scale = max(float(np.nanmax(np.abs(ref))), 1e-30)
    assert np.nanmax(np.abs(out - ref)) <= rtol * scale


def test_interp_ends_and_ties_like_jnp_and_np():
    xp = np.array([0.0, 1.0, 1.0, 1.0, 2.0, 3.0, 3.0], np.float32)
    fp = np.array([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6], np.float32)
    x = np.array([-2.0, 0.0, 0.5, 1.0, 1.5, 2.0, 2.999, 3.0, 7.0], np.float32)
    out = tpm.interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    _close(out, np.asarray(jnp.interp(x, xp, fp)))
    ends = [0, 1, 4, 5, 6, 8]  # below, on the first knot, on ties, at the top, above
    assert np.allclose(out[ends], np.interp(x, xp, fp)[ends], atol=1e-6)


def test_compute_empirical_cdf():
    edges = np.linspace(0.0, 5.0, 11)
    hist = np.random.default_rng(1).integers(0, 30, 10)
    _close(tpm.compute_empirical_cdf(edges, hist, device="cpu"),
           jpm.compute_empirical_cdf(edges, hist))


@pytest.mark.parametrize("ignore", [None, "mask", "indices"])
def test_nonparam_match_empirical_cdf(ignore):
    X = _ensemble(2)
    initial, target = X[0], X[1] * 1.7
    kw_j, kw_t = {}, {}
    if ignore == "mask":
        mask = np.zeros(initial.shape, bool)
        mask[5:20, 3:30] = True
        kw_j = kw_t = {"ignore_indices": mask}
    elif ignore == "indices":
        idx = np.random.default_rng(3).choice(initial.size, 300, replace=False)
        kw_j = kw_t = {"ignore_indices": idx}
    out = tpm.nonparam_match_empirical_cdf(initial, target, device="cpu", **kw_t)
    ref = jpm.nonparam_match_empirical_cdf(initial, target, **kw_j)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_nonparam_match_empirical_cdf_size_mismatch():
    with pytest.raises(ValueError):
        tpm.nonparam_match_empirical_cdf(np.zeros(5), np.zeros(6), device="cpu")


def test_pmm_init_and_compute():
    rng = np.random.default_rng(4)
    e1, e2 = np.linspace(0, 10, 21), np.linspace(-1, 12, 21)
    c1 = tpm.compute_empirical_cdf(e1, rng.integers(1, 9, 20), device="cpu").numpy()
    c2 = tpm.compute_empirical_cdf(e2, rng.integers(1, 9, 20), device="cpu").numpy()
    x = rng.uniform(-2, 12, (30, 20)).astype(np.float32)
    out = tpm.pmm_compute(tpm.pmm_init(e1, c1, e2, c2, device="cpu"), x)
    ref = jpm.pmm_compute(jpm.pmm_init(e1, c1, e2, c2), x)
    _close(out, ref)
    assert np.isnan(out.numpy()).any()  # above the last edge: p = 1


@pytest.mark.parametrize("f", ["dB", "mm/h"])
def test_shift_scale(f):
    R = _ensemble(5)[0] * (3.0 if f == "dB" else 1.0)
    shift, scale, out = tpm.shift_scale(R, f, 0.4, 30.0 if f == "dB" else 8.0, device="cpu")
    jshift, jscale, jout = jpm.shift_scale(R, f, 0.4, 30.0 if f == "dB" else 8.0)
    assert abs(shift - jshift) <= 1e-5 * max(abs(jshift), 1.0)
    assert abs(scale - jscale) <= 1e-5 * jscale
    _close(out, jout, 1e-5)


def test_resample_distributions_on_jax_draw(monkeypatch):
    """The port's draw replaced by JAX's Bernoulli draw of the same key."""
    X = _ensemble(6, nan=True)
    a, b = X[0], X[1] + 0.5
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(tpm, "_bernoulli", lambda g, p, shape: torch.tensor(
        np.asarray(jax.random.bernoulli(key, p, shape))))
    out = tpm.resample_distributions(a, b, 0.3, device="cpu")
    ref = jpm.resample_distributions(a, b, 0.3, key=key)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        tpm.resample_distributions(a, b[:-1], 0.3, device="cpu")


def test_resample_distributions_draws_from_the_generator():
    X = _ensemble(7)
    g = torch.Generator().manual_seed(1)
    out = tpm.resample_distributions(X[0], X[1], 0.5, key=g, device="cpu").numpy()
    a, b = np.sort(X[0].ravel())[::-1], np.sort(X[1].ravel())[::-1]
    assert np.all((out == a) | (out == b))
    assert 0.4 < np.mean(out == a) < 0.6 or np.mean(a == b) > 0.3


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("kw", [{}, {"ignore_nan": True}, {"X_thr": 1.0},
                                {"X_thr": 1.0, "ignore_nan": True}])
def test_mean(nan, kw):
    X = _ensemble(8, nan=nan)
    _close(tes.mean(X, device="cpu", **kw), jes.mean(X, **kw))
    np.testing.assert_array_equal(tes.mean(X[0], device="cpu").numpy(), X[0])


@pytest.mark.parametrize("thr", [1.0, [0.5, 1.0, 4.0]])
@pytest.mark.parametrize("ignore_nan", [False, True])
def test_excprob(thr, ignore_nan):
    X = _ensemble(9, nan=True)
    out = tes.excprob(X, thr, ignore_nan=ignore_nan, device="cpu")
    _close(out, jes.excprob(X, thr, ignore_nan=ignore_nan), 0.0)


@pytest.mark.parametrize("thr,norm", [(None, False), (None, True), (2.0, False), (2.0, True)])
def test_banddepth(thr, norm):
    X = _ensemble(10, nan=True)
    _close(tes.banddepth(X, thr=thr, norm=norm, device="cpu"),
           jes.banddepth(X, thr=thr, norm=norm))


def test_registry_names_and_errors():
    assert set(tif._postprocessing_methods) == set(jif._postprocessing_methods)
    for name in jif._postprocessing_methods:
        assert tif.get_method(name.upper()).__name__ == jif.get_method(name).__name__
    with pytest.raises(ValueError):
        tif.get_method("nonexistent")
    with pytest.raises(ValueError):
        tif.add_postprocessor("ensemblestats.mean", tes.mean)
    table = {}
    tif.add_postprocessor("plugin.x", tes.mean, _methods=table)
    assert table == {"plugin.x": tes.mean}


def test_postprocessors_info(capsys):
    assert tif.postprocessors_info() == jif.postprocessors_info()
    assert "pysteps_tpu_torch.postprocessing" in capsys.readouterr().out


def test_diagnostics_registry_has_its_own_entry_point_group():
    assert tdiag.ENTRY_POINT_GROUP == "pysteps_tpu_torch.plugins.diagnostics"
    assert tdiag._diagnostics is not jdiag._diagnostics
    tdiag.add_diagnostic("_test_diag", len)
    try:
        assert tdiag.get_diagnostic("_test_diag") is len
        with pytest.raises(ValueError):
            tdiag.add_diagnostic("_test_diag", len)
    finally:
        del tdiag._diagnostics["_test_diag"]
    with pytest.raises(ValueError):
        tdiag.get_diagnostic("_test_diag")


def test_package_exports_what_the_jax_package_exports():
    public = {n for n in dir(jpp) if not n.startswith("_")}
    assert public <= {n for n in dir(tpp) if not n.startswith("_")}
