"""``verification/`` of the PyTorch port (all but ``parallel.py``) against
the JAX package's on the same seeded inputs (48 x 64 fields with NaNs, a
12-member ensemble): every public score, one-shot and through its
init / accum / merge / compute chain, the registry and the plots (Agg).

Tolerances: counts, ranks and contingency tables equal; float32
reductions (continuous scores, CRPS, FSS, binary MSE) within 1e-5
relative (2e-4 for the scatter, a difference of two quantiles); host
code (lifetime, SAL) equal to 1e-12.  The rank histogram's random tie
breaks use another generator: with ties, only the counts of tie-free
ranks and the total are compared.
"""

import sys

import numpy as np
import pytest
import torch

from pysteps_tpu import verification as jver
from pysteps_tpu.verification import detcatscores as jcat
from pysteps_tpu.verification import detcontscores as jcont
from pysteps_tpu.verification import ensscores as jens
from pysteps_tpu.verification import lifetime as jlife
from pysteps_tpu.verification import plots as jplots
from pysteps_tpu.verification import probscores as jprob
from pysteps_tpu.verification import salscores as jsal
from pysteps_tpu.verification import spatialscores as jspat
from pysteps_tpu_torch import verification as tver
from pysteps_tpu_torch.verification import detcatscores as tcat
from pysteps_tpu_torch.verification import detcontscores as tcont
from pysteps_tpu_torch.verification import ensscores as tens
from pysteps_tpu_torch.verification import interface as tinterface
from pysteps_tpu_torch.verification import lifetime as tlife
from pysteps_tpu_torch.verification import plots as tplots
from pysteps_tpu_torch.verification import probscores as tprob
from pysteps_tpu_torch.verification import salscores as tsal
from pysteps_tpu_torch.verification import spatialscores as tspat

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its many small operators run
    no faster on more, and threads that wait spinning slow the other test
    workers sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(rng, shape=(48, 64), nan=True):
    x = np.maximum(rng.gamma(0.7, 3.0, shape) - 0.8, 0.0).astype(np.float32)
    if nan:
        x[rng.random(shape) < 0.03] = np.nan
    return x


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    obs = _field(rng)
    pred = (obs * rng.uniform(0.5, 1.5, obs.shape) + rng.gamma(0.5, 1.0, obs.shape)).astype(
        np.float32)
    pred[rng.random(obs.shape) < 0.02] = np.nan
    ens = np.stack([_field(rng, nan=False) + 0.5 * np.nan_to_num(obs) for _ in range(12)])
    ens = ens.astype(np.float32)
    ens[:, :2, :3] = np.nan
    stack = np.stack([_field(rng) for _ in range(3)])
    return dict(obs=obs, pred=pred, ens=ens, stack=stack, pred2=_field(rng), obs2=_field(rng))


def _same(a, b, rtol=1e-5):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k], rtol)
        return
    if isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y, rtol)
        return
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                               atol=rtol * 1e-3, equal_nan=True)


# --- categorical -------------------------------------------------------------


CAT_SCORES = ["", "POD", "far", "FA", "acc", "csi", "bias", "hss", "hk", "gss", "ets", "f1",
              "mcc", "sedi", "csi, pod, far"]


@pytest.mark.parametrize("scores", CAT_SCORES)
def test_det_cat_fct(data, scores):
    ref = jcat.det_cat_fct(data["pred"], data["obs"], 0.5, scores=scores)
    out = tcat.det_cat_fct(data["pred"], data["obs"], 0.5, scores=scores, **CPU)
    _same(out, ref)


def test_det_cat_chain_and_axis(data):
    for axis in (None, 0, (1, 2)):
        cj = jcat.det_cat_fct_init(1.0, axis=axis)
        jcat.det_cat_fct_accum(cj, data["stack"], data["stack"][::-1])
        ct = tcat.det_cat_fct_init(1.0, axis=axis)
        tcat.det_cat_fct_accum(ct, data["stack"], data["stack"][::-1], **CPU)
        for k in ("hits", "false_alarms", "misses", "correct_negatives"):
            np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
        _same(tcat.det_cat_fct_compute(ct, "csi"), jcat.det_cat_fct_compute(cj, "csi"))
    a_j, b_j = jcat.det_cat_fct_init(0.5), jcat.det_cat_fct_init(0.5)
    jcat.det_cat_fct_accum(a_j, data["pred"], data["obs"])
    jcat.det_cat_fct_accum(b_j, data["pred2"], data["obs2"])
    jcat.det_cat_fct_accum(b_j, data["obs2"], data["pred2"])
    a_t, b_t = tcat.det_cat_fct_init(0.5), tcat.det_cat_fct_init(0.5)
    tcat.det_cat_fct_accum(a_t, data["pred"], data["obs"], **CPU)
    tcat.det_cat_fct_accum(b_t, data["pred2"], data["obs2"], **CPU)
    tcat.det_cat_fct_accum(b_t, data["obs2"], data["pred2"], **CPU)
    _same(tcat.det_cat_fct_compute(tcat.det_cat_fct_merge(a_t, b_t)),
          jcat.det_cat_fct_compute(jcat.det_cat_fct_merge(a_j, b_j)))


# --- continuous --------------------------------------------------------------


@pytest.mark.parametrize("conditioning", [None, "single", "double"])
def test_det_cont_fct(data, conditioning):
    ref = jcont.det_cont_fct(data["pred"], data["obs"], conditioning=conditioning, thr=0.3)
    out = tcont.det_cont_fct(data["pred"], data["obs"], conditioning=conditioning, thr=0.3,
                             **CPU)
    assert set(out) == set(ref)
    for k in ref:
        _same(out[k], ref[k], 2e-4 if k == "scatter" else 1e-5)
    _same(tcont.det_cont_fct(data["pred"], data["obs"], scores="RMSE", **CPU),
          jcont.det_cont_fct(data["pred"], data["obs"], scores="RMSE"))
    _same(tcont.det_cont_fct(data["pred"], data["obs"], scores=["me", "corr_s"], **CPU),
          jcont.det_cont_fct(data["pred"], data["obs"], scores=["me", "corr_s"]))


def test_det_cont_chain(data):
    for conditioning in (None, "double"):
        states = []
        for mod, kw in ((jcont, {}), (tcont, CPU)):
            a = mod.det_cont_fct_init(conditioning=conditioning, thr=0.3)
            b = mod.det_cont_fct_init(conditioning=conditioning, thr=0.3)
            mod.det_cont_fct_accum(a, data["pred"], data["obs"], **kw)
            mod.det_cont_fct_accum(a, data["pred2"], data["obs2"], **kw)
            mod.det_cont_fct_accum(b, data["obs2"], data["pred"], **kw)
            empty = mod.det_cont_fct_init()
            states.append((mod.det_cont_fct_compute(mod.det_cont_fct_merge(a, b)),
                           mod.det_cont_fct_compute(a, "mae, beta1"),
                           mod.det_cont_fct_compute(mod.det_cont_fct_merge(empty, a), "RV"),
                           mod.det_cont_fct_compute(mod.det_cont_fct_merge(a, empty), "ME")))
        _same(states[1], states[0])


# --- probabilistic -----------------------------------------------------------


def test_crps_and_chain(data):
    _same(tprob.CRPS(data["ens"], data["obs"], **CPU), jprob.CRPS(data["ens"], data["obs"]))
    _same(tver.CRPS(data["ens"], data["obs"], **CPU), jver.CRPS(data["ens"], data["obs"]))
    states = []
    for mod, kw in ((jprob, {}), (tprob, CPU)):
        a, b = mod.CRPS_init(), mod.CRPS_init()
        mod.CRPS_accum(a, data["ens"], data["obs"], **kw)
        mod.CRPS_accum(b, data["ens"][:, ::-1], data["obs2"], **kw)
        m = mod.CRPS_merge(a, b)
        states.append((m["CRPS_sum"], m["n"], mod.CRPS_compute(m)))
    _same(states[1], states[0])


def _prob(data):
    return np.mean(np.nan_to_num(data["ens"]) >= 1.0, axis=0).astype(np.float32)


@pytest.mark.parametrize("n_bins, min_count", [(10, 10), (5, 1)])
def test_reldiag(data, n_bins, min_count):
    P = _prob(data)
    _same(tprob.reldiag(P, data["obs"], 1.0, n_bins=n_bins, min_count=min_count, **CPU),
          jprob.reldiag(P, data["obs"], 1.0, n_bins=n_bins, min_count=min_count))
    j, t = jprob.reldiag_init(1.0, n_bins), tprob.reldiag_init(1.0, n_bins)
    for mod, st, kw in ((jprob, j, {}), (tprob, t, CPU)):
        mod.reldiag_accum(st, P, data["obs"], **kw)
        mod.reldiag_accum(st, P[::-1], data["obs2"], **kw)
    for k in ("X_sum", "Y_sum", "num_idx", "sample_size"):
        _same(t[k], j[k])
    np.testing.assert_array_equal(t["sample_size"], j["sample_size"])


@pytest.mark.parametrize("compute_area", [False, True])
def test_roc_curve(data, compute_area):
    P = _prob(data)
    _same(tprob.ROC_curve(P, data["obs"], 1.0, n_prob_thrs=7, compute_area=compute_area, **CPU),
          jprob.ROC_curve(P, data["obs"], 1.0, n_prob_thrs=7, compute_area=compute_area))
    j, t = jprob.ROC_curve_init(0.5), tprob.ROC_curve_init(0.5)
    jprob.ROC_curve_accum(j, P, data["obs"])
    tprob.ROC_curve_accum(t, P, data["obs"], **CPU)
    for k in ("hits", "misses", "false_alarms", "corr_neg"):
        np.testing.assert_array_equal(t[k], j[k])


# --- ensemble ----------------------------------------------------------------


@pytest.mark.parametrize("X_min", [None, 1.0])
def test_rankhist_without_ties(data, X_min):
    rng = np.random.default_rng(2)
    ens = rng.normal(size=(8, 40, 30)).astype(np.float32)
    obs = rng.normal(size=(40, 30)).astype(np.float32)
    _same(tens.rankhist(ens, obs, X_min=X_min, **CPU), jens.rankhist(ens, obs, X_min=X_min))
    _same(tens.rankhist(ens, obs, normalize=False, **CPU), jens.rankhist(ens, obs, normalize=False))
    j, t = jens.rankhist_init(8, X_min), tens.rankhist_init(8, X_min)
    jens.rankhist_accum(j, ens, obs)
    tens.rankhist_accum(t, ens, obs, **CPU)
    _same(tens.rankhist_compute(tens.rankhist_merge(t, t)),
          jens.rankhist_compute(jens.rankhist_merge(j, j)))


def test_rankhist_with_ties(data):
    """Dry pixels tie with dry members: the tie-free ranks' counts and the
    total equal JAX's; the tied ones land in their tie's ranks."""
    ens, obs = data["ens"], data["obs"]
    ref = jens.rankhist(ens, obs, normalize=False)
    out = tens.rankhist(ens, obs, normalize=False, generator=torch.Generator().manual_seed(0),
                        **CPU)
    assert out.sum() == ref.sum()
    flat_f = ens.reshape(12, -1).T
    flat_o = obs.reshape(-1)
    ok = np.all(np.isfinite(flat_f), axis=1) & np.isfinite(flat_o)
    ties = np.sum(flat_f[ok] == flat_o[ok][:, None], axis=1)
    ranks = np.sum(flat_f[ok] < flat_o[ok][:, None], axis=1)
    free = np.bincount(ranks[ties == 0], minlength=13)
    tied_hi = np.bincount((ranks + ties)[ties > 0], minlength=13)
    lo = np.bincount(ranks[ties > 0], minlength=13)
    assert np.all(out >= free) and np.all(out <= free + np.cumsum(lo)[-1])
    assert tied_hi.sum() + free.sum() == out.sum()


@pytest.mark.parametrize("metric, kw", [("RMSE", {}), ("csi", {"thr": 1.0}), ("corr_p", {})])
def test_ensemble_skill_and_spread(data, metric, kw):
    ens = np.nan_to_num(data["ens"][:5])
    _same(tens.ensemble_skill(ens, data["obs"], metric, **CPU, **kw),
          jens.ensemble_skill(ens, data["obs"], metric, **kw))
    _same(tens.ensemble_spread(ens, metric, **CPU, **kw), jens.ensemble_spread(ens, metric, **kw))


# --- spatial -----------------------------------------------------------------


@pytest.mark.parametrize("scale", [1, 3, 4, 9])
def test_fss(data, scale):
    _same(tspat.fss(data["pred"], data["obs"], 1.0, scale, **CPU),
          jspat.fss(data["pred"], data["obs"], 1.0, scale))
    states = []
    for mod, kw in ((jspat, {}), (tspat, CPU)):
        a, b = mod.fss_init(0.5, scale), mod.fss_init(0.5, scale)
        mod.fss_accum(a, data["pred"], data["obs"], **kw)
        mod.fss_accum(b, data["pred2"], data["obs2"], **kw)
        m = mod.fss_merge(a, b)
        states.append((m["sum_obs_sq"], m["sum_fct_obs"], m["sum_fct_sq"], mod.fss_compute(m)))
    _same(states[1], states[0])


def test_binary_mse_and_intensity_scale(data):
    # the Haar transform halves each side log2(min side) times: 32 x 64
    p, o = data["pred"][:32], data["obs"][:32]
    _same(tspat.binary_mse(p, o, 1.0, **CPU), jspat.binary_mse(p, o, 1.0))
    _same(tspat.intensity_scale(p, o, "fss", [0.5, 2.0], scales=[1, 4, 8], **CPU),
          jspat.intensity_scale(p, o, "fss", [0.5, 2.0], scales=[1, 4, 8]))
    _same(tspat.intensity_scale(p, o, "bmse", [0.5, 2.0], **CPU),
          jspat.intensity_scale(p, o, "bmse", [0.5, 2.0]))
    for name, scales in (("fss", [2, 5]), ("bmse", None)):
        out = []
        for mod, kw in ((jspat, {}), (tspat, CPU)):
            a = mod.intensity_scale_init(name, [0.5, 1.5], scales)
            b = mod.intensity_scale_init(name, [0.5, 1.5], scales)
            mod.intensity_scale_accum(a, p, o, **kw)
            mod.intensity_scale_accum(b, data["pred2"][:32], data["obs2"][:32], **kw)
            merged = mod.intensity_scale_merge(a, b)
            out.append((mod.intensity_scale_compute(merged), merged["scales"]))
        _same(out[1], out[0])
    for mod in (jspat, tspat):
        with pytest.raises(ValueError):
            mod.intensity_scale_init("fss", [1.0])
        with pytest.raises(ValueError):
            mod.intensity_scale_init("sal", [1.0])
        with pytest.raises(ValueError):
            mod.intensity_scale_merge(mod.intensity_scale_init("bmse", [1.0]),
                                      mod.intensity_scale_init("fss", [1.0], [2]))


# --- lifetime and SAL --------------------------------------------------------


@pytest.mark.parametrize("rule", ["1/e", "trapz", "simpson"])
def test_lifetime(rule):
    t = np.arange(0, 65, 5.0)
    for curve in (np.exp(-t / 23.0), np.exp(-t / 2.0), np.full(t.shape, 0.9)):
        _same(tlife.lifetime(curve, t, rule), jlife.lifetime(curve, t, rule), 1e-12)
    j, s = jlife.lifetime_init(rule), tlife.lifetime_init(rule)
    for mod, st in ((jlife, j), (tlife, s)):
        mod.lifetime_accum(st, np.exp(-t / 23.0), t)
        mod.lifetime_accum(st, np.exp(-t / 9.0), t)
    _same(tlife.lifetime_compute(s), jlife.lifetime_compute(j), 1e-12)
    with pytest.raises(ValueError):
        tlife.lifetime_init("midpoint")


def _sal_fields():
    from test_feature_tracking import _storm_field

    obs = _storm_field([(30, 30), (80, 90)], shape=(112, 128), peak=12.0, scale=6.0)
    pred = _storm_field([(34, 38), (76, 84), (20, 100)], shape=(112, 128), peak=9.0, scale=8.0)
    return pred.astype(np.float32), obs.astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"thr_factor": 0.1, "thr_quantile": 0.9},
                                {"thr_factor": None, "tstorm_kwargs": {"minref": 2.0,
                                                                       "maxref": 6.0,
                                                                       "mindiff": 1.0,
                                                                       "minsize": 4,
                                                                       "minmax": 3.0}}])
def test_sal(kw):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent))
    pred, obs = _sal_fields()
    ref = jsal.sal(pred, obs, **kw)
    out = tsal.sal(torch.as_tensor(pred), obs, **kw)
    assert np.all(np.isfinite(ref))
    _same(out, ref, 1e-12)
    _same(tsal.sal_amplitude(pred, obs), jsal.sal_amplitude(pred, obs), 1e-12)
    with pytest.raises(ValueError):
        tsal.sal_structure(pred, obs, thr_factor=0.1, thr_quantile=None)


def test_sal_without_pandas(monkeypatch):
    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parent))
    pred, obs = _sal_fields()
    ref = jsal.sal(pred, obs)
    monkeypatch.setitem(sys.modules, "pandas", None)
    _same(tsal.sal(pred, obs), ref, 1e-12)


# --- the registry and the plots ------------------------------------------------


def _all_names():
    det = sorted(tinterface.CATEGORICAL | tinterface.CONTINUOUS) + [
        "fss", "binary_mse", "bmse", "sal", "BETA", "CSI"]
    return ([(n, "deterministic") for n in det]
            + [(n, "ensemble") for n in ("ens_skill", "ens_spread", "rankhist")]
            + [(n, t) for n in ("crps", "reldiag", "roc") for t in ("probabilistic", "prob")])


@pytest.mark.parametrize("name, kind", _all_names())
def test_registry_equals_jax(data, name, kind):
    j, t = jver.get_method(name, type=kind), tver.get_method(name, type=kind)
    if j.__name__ == "f":  # a wrapped categorical or continuous score
        kw = {"thr": 0.5} if name.lower() in tinterface.CATEGORICAL else {}
        _same(t(data["pred"], data["obs"], device="cpu", **kw),
              j(data["pred"], data["obs"], **kw), 2e-4)
    else:
        assert t.__module__.replace("pysteps_tpu_torch", "pysteps_tpu") == j.__module__
        assert t.__name__ == j.__name__


@pytest.mark.parametrize("name, kind", [("nope", "deterministic"), ("crps", "ensemble"),
                                        ("rankhist", "prob"), ("csi", "spatial"),
                                        (None, "deterministic"), ("csi", None)])
def test_registry_errors_equal_jax(name, kind):
    with pytest.raises(ValueError) as ej:
        jver.get_method(name, type=kind)
    with pytest.raises(ValueError) as et:
        tver.get_method(name, type=kind)
    assert str(et.value) == str(ej.value)


def test_plots_with_agg(data, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    P = _prob(data)
    rd_j, rd_t = jprob.reldiag_init(1.0, 5, 1), tprob.reldiag_init(1.0, 5, 1)
    jprob.reldiag_accum(rd_j, P, data["obs"])
    tprob.reldiag_accum(rd_t, P, data["obs"], **CPU)
    roc_j, roc_t = jprob.ROC_curve_init(1.0), tprob.ROC_curve_init(1.0)
    jprob.ROC_curve_accum(roc_j, P, data["obs"])
    tprob.ROC_curve_accum(roc_t, P, data["obs"], **CPU)
    rh_j, rh_t = jens.rankhist_init(12), tens.rankhist_init(12)
    rng = np.random.default_rng(4)
    ens, obs = rng.normal(size=(12, 20, 20)), rng.normal(size=(20, 20))
    jens.rankhist_accum(rh_j, ens, obs)
    tens.rankhist_accum(rh_t, ens, obs, **CPU)
    is_j = jspat.intensity_scale_init("fss", [0.5, 1.0], [1, 4])
    is_t = tspat.intensity_scale_init("fss", [0.5, 1.0], [1, 4])
    jspat.intensity_scale_accum(is_j, data["pred"], data["obs"])
    tspat.intensity_scale_accum(is_t, data["pred"], data["obs"], **CPU)
    cases = [
        ("plot_reldiag", rd_j, rd_t, {}), ("plot_reldiag", jprob.reldiag_compute(rd_j),
                                           tprob.reldiag_compute(rd_t), {}),
        ("plot_ROC", roc_j, roc_t, {}), ("plot_rankhist", rh_j, rh_t, {}),
        ("plot_intensityscale", is_j, is_t, {"kmperpixel": 2.0, "unit": "mm/h"}),
    ]
    for fname, arg_j, arg_t, kw in cases:
        if fname == "plot_intensityscale":
            ax_j = getattr(jplots, fname)(arg_j, fig=plt.figure(), **kw)
            ax_t = getattr(tplots, fname)(arg_t, fig=plt.figure(), **kw)
            np.testing.assert_allclose(ax_t.images[0].get_array(), ax_j.images[0].get_array(),
                                       rtol=1e-5)
            assert [x.get_text() for x in ax_t.get_yticklabels()] == [
                x.get_text() for x in ax_j.get_yticklabels()]
        else:
            ax_j = getattr(jplots, fname)(arg_j)
            ax_t = getattr(tplots, fname)(arg_t)
            assert len(ax_t.lines) == len(ax_j.lines) and len(ax_t.patches) == len(ax_j.patches)
            for a, b in zip(ax_t.lines, ax_j.lines):
                np.testing.assert_allclose(a.get_xydata(), b.get_xydata(), rtol=1e-6)
            for a, b in zip(ax_t.patches, ax_j.patches):
                assert a.get_height() == pytest.approx(b.get_height(), rel=1e-12)
        assert ax_t.get_xlabel() == ax_j.get_xlabel()
        ax_t.figure.savefig(tmp_path / f"{fname}.png")
        plt.close("all")
