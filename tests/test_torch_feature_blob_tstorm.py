"""The blob and tstorm feature detectors and the feature registry of the
PyTorch port against the JAX package's on the same seeded inputs.

- blob: the (x, y, sigma) rows equal, in JAX's order (strongest first,
  ties by their flat (sigma, y, x) index);
- tstorm: the label grids equal; the centroids equal for
  ``output_feat=True`` and as the table's ``cen_x``/``cen_y``; the
  ``DataFrame``'s columns, their types and every cell equal; without
  pandas the centroids and labels still work and the table raises an
  ``ImportError`` that names pandas;
- the registry: the same names and the same error.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_feature_tracking import _storm_field  # noqa: E402

from pysteps_tpu import feature as jfeature  # noqa: E402
from pysteps_tpu.feature import blob as jblob  # noqa: E402
from pysteps_tpu.feature import tstorm as jtstorm  # noqa: E402
from pysteps_tpu_torch import feature as tfeature  # noqa: E402
from pysteps_tpu_torch.feature import blob as tblob  # noqa: E402
from pysteps_tpu_torch.feature import tstorm as ttstorm  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: its many small operators run
    no faster on more, and threads that wait spinning slow the other test
    workers sharing the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields():
    """name -> (field, detection keywords)."""
    rng = np.random.default_rng(7)
    noisy = _storm_field([(20, 30), (70, 90), (100, 40)], shape=(128, 112), peak=30.0,
                         scale=5.0) + rng.gamma(1.0, 2.0, (128, 112))
    with_nan = _storm_field([(40, 40), (90, 80)], peak=30.0)
    with_nan[60:70, 10:30] = np.nan
    # three equal blobs away from the edges: equal responses, which the
    # cut at 2 must take in the order of their flat index
    tied = _storm_field([(60, 40), (20, 60), (20, 20)], shape=(96, 96), peak=30.0, scale=3.0)
    return {
        "two_gaussians": (_storm_field([(40, 40), (90, 80)], peak=30.0),
                          dict(max_num_features=10, threshold=1.0)),
        "noisy": (noisy, dict(max_num_features=25)),
        "noisy_few": (noisy, dict(max_num_features=3, threshold=0.1, num_sigma=6)),
        "with_nan": (with_nan, dict(max_num_features=None, min_sigma=2, max_sigma=8)),
        "tied": (tied, dict(max_num_features=2, threshold=1.0, min_sigma=2, max_sigma=6,
                            num_sigma=5)),
    }


@pytest.mark.parametrize("name", list(_fields()))
def test_blob_rows_and_order(name):
    field, kw = _fields()[name]
    ref = jblob.detection(field, **kw)
    out = tblob.detection(field, device="cpu", **kw)
    assert out.shape == ref.shape and out.shape[1] == 3 and len(out) > 0
    # as sets, and in JAX's order
    assert {tuple(r) for r in out} == {tuple(r) for r in ref}
    np.testing.assert_array_equal(out, ref)


def _tstorm_cases():
    rng = np.random.default_rng(3)
    many = _storm_field([(20, 20), (30, 60), (80, 30), (90, 95), (50, 110)], shape=(128, 128),
                        peak=52.0, scale=5.0) + rng.uniform(0, 3, (128, 128))
    return {
        "two": (_storm_field([(40, 40), (90, 80)], peak=50.0),
                dict(minref=35, minmax=41, minsize=10)),
        "many": (many, dict(minref=35, minmax=41, minsize=10, mindis=8)),
        "many_top3": (many, dict(minref=35, minmax=41, minsize=10, max_num_features=3)),
        "splits_merges": (many, dict(minref=35, minsize=10, output_splits_merges=True,
                                     time="202610171200")),
        "none": (np.zeros((64, 64)), dict(minref=35)),
    }


@pytest.mark.parametrize("name", list(_tstorm_cases()))
def test_tstorm_table_labels_and_centroids(name):
    field, kw = _tstorm_cases()[name]
    cells_j, labels_j = jtstorm.detection(field, **kw)
    cells_t, labels_t = ttstorm.detection(field, **kw)
    np.testing.assert_array_equal(labels_t, labels_j)
    assert list(cells_t.columns) == list(cells_j.columns)
    assert cells_t.dtypes.to_dict() == cells_j.dtypes.to_dict()
    assert list(cells_t.index) == list(cells_j.index)
    for col in cells_j.columns:
        for a, b in zip(cells_t[col], cells_j[col]):
            if col == "cont":
                assert len(a) == len(b)
                for ca, cb in zip(a, b):
                    np.testing.assert_array_equal(ca, cb)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b or (a is None and b is None), (col, a, b)
    feat_j = jtstorm.detection(field, output_feat=True, **kw)
    feat_t = ttstorm.detection(field, output_feat=True, **kw)
    np.testing.assert_array_equal(feat_t, feat_j)
    if len(cells_j) and "max_num_features" not in kw:
        np.testing.assert_array_equal(
            feat_t, np.column_stack([cells_t.cen_x.to_numpy(), cells_t.cen_y.to_numpy()]))


def test_tstorm_helpers_match():
    field = _tstorm_cases()["many"][0]
    loc = np.where(field > 45)
    for mindis in (3, 10):
        ref = jtstorm.longdistance(loc, mindis)
        out = ttstorm.longdistance(loc, mindis)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    maxima = np.zeros(field.shape)
    maxima[tuple(np.asarray(jtstorm.longdistance(loc, 10)))] = 1
    np.testing.assert_array_equal(ttstorm.breakup(field, 0.0, maxima)[0],
                                  jtstorm.breakup(field, 0.0, maxima)[0])
    binary = (field > 35).astype(float)
    fj, lj = jtstorm.get_profile(*jtstorm.breakup(field, 0.0, maxima)[:1], binary, field,
                                 tuple(np.asarray(jtstorm.longdistance(loc, 10))), "t", 35)
    ft, lt = ttstorm.get_profile(*ttstorm.breakup(field, 0.0, maxima)[:1], binary, field,
                                 tuple(np.asarray(ttstorm.longdistance(loc, 10))), "t", 35)
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(ft.area.to_numpy(), fj.area.to_numpy())


def test_tstorm_without_pandas(monkeypatch):
    field, kw = _tstorm_cases()["many"]
    with_pandas = ttstorm.detection(field, **kw)[1]
    ref = jtstorm.detection(field, output_feat=True, **kw)
    monkeypatch.setitem(sys.modules, "pandas", None)
    np.testing.assert_array_equal(ttstorm.detection(field, output_feat=True, **kw), ref)
    table, labels = ttstorm._detect(field, **kw)
    np.testing.assert_array_equal(labels, with_pandas)
    assert set(table) == set(ttstorm.COLUMNS)
    with pytest.raises(ImportError, match="pandas"):
        ttstorm.detection(field, **kw)


def test_tstorm_takes_tensors():
    field, kw = _tstorm_cases()["two"]
    np.testing.assert_array_equal(
        ttstorm.detection(torch.as_tensor(field), output_feat=True, **kw),
        jtstorm.detection(field, output_feat=True, **kw))


def test_feature_registry_equals_jax():
    for name in ("shitomasi", "SHITOMASI", "blob", "Blob", "tstorm"):
        j, t = jfeature.get_method(name), tfeature.get_method(name)
        assert t.__module__.replace("pysteps_tpu_torch", "pysteps_tpu") == j.__module__
        assert t.__name__ == j.__name__
    for name in ("harris", None, "log"):
        with pytest.raises(ValueError) as ej:
            jfeature.get_method(name)
        with pytest.raises(ValueError) as et:
            tfeature.get_method(name)
        assert str(et.value) == str(ej.value)
