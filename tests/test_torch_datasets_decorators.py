"""The port's ``datasets`` and ``decorators`` against the JAX package's: the
package's own synthetic generator bit-equal to the tests' helper, the
archive it writes and the cases it loads equal to JAX's, and each decorator
behaving as JAX's on numpy and on tensors."""

import warnings

import numpy as np
import pytest
import torch

from helpers import make_synthetic_sequence
from pysteps_tpu import datasets as jdatasets
from pysteps_tpu import decorators as jdecorators
from pysteps_tpu_torch import datasets, decorators


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_frames=3, shape=(48, 64), velocity=(1.5, -0.5), seed=3),
    dict(n_frames=4, shape=(64, 64), velocity=(3.4, 1.2), seed=42, evolution=0.2),
], ids=["default", "rect", "evolution"])
def test_generator_is_the_helper_bit_for_bit(kw):
    np.testing.assert_array_equal(datasets.make_synthetic_sequence(**kw),
                                  make_synthetic_sequence(**kw))


def test_create_synthetic_dataset_matches_jax(tmp_path):
    kw = dict(n_frames=4, shape=(48, 64), velocity=(2.0, 1.0), seed=5)
    paths, meta = datasets.create_synthetic_dataset(str(tmp_path / "port"), **kw)
    jpaths, jmeta = jdatasets.create_synthetic_dataset(str(tmp_path / "jax"), **kw)
    assert meta == jmeta
    assert [p.split("/")[-1] for p in paths] == [p.split("/")[-1] for p in jpaths]
    for p, q in zip(paths, jpaths):
        with np.load(p, allow_pickle=True) as a, np.load(q, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            np.testing.assert_array_equal(a["precip"], b["precip"])
            assert a["precip"].dtype == np.float32
            assert a["metadata"].item() == b["metadata"].item()


def test_load_dataset_matches_jax():
    precip, meta = datasets.load_dataset("fmi", frames=2)
    ref, ref_meta = jdatasets.load_dataset("fmi", frames=2)
    assert precip.shape == (2, 512, 512)
    np.testing.assert_array_equal(precip, ref)
    assert meta == ref_meta


def test_default_rc_matches_jax(tmp_path):
    path = datasets.create_default_pystepsrc(str(tmp_path / "data"), config_dir=str(tmp_path))
    with open(path) as f:
        text = f.read()
    jpath = jdatasets.create_default_pystepsrc(str(tmp_path / "data"), config_dir=str(tmp_path),
                                               file_name="jax_rc")
    with open(jpath) as f:
        assert text == f.read()


def test_package_does_not_touch_sys_path(tmp_path, monkeypatch):
    import sys

    before = list(sys.path)
    datasets.create_synthetic_dataset(str(tmp_path), n_frames=2, shape=(16, 16))
    datasets.load_dataset("fmi", frames=1)
    assert sys.path == before


def _frames(n=3):
    return np.random.RandomState(0).rand(n, 8, 8).astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("n,ndim", [(3, 3), (1, 3), (5, 3), (3, 2)])
def test_check_input_frames_matches_jax(as_tensor, n, ndim):
    def outcome(deco, port=False):
        seen = []

        @deco(minimum_input_frames=2, maximum_input_frames=4)
        def method(images):
            seen.append(images)
            return images.shape

        x = _frames(n) if ndim == 3 else _frames(n)[0]
        if as_tensor:
            x = torch.from_numpy(x)
        try:
            shape = method(x)
        except ValueError as err:
            return "ValueError", str(err)
        # the port hands a tensor on as it is, never copied to numpy
        assert seen[0] is x if (as_tensor and port) else isinstance(seen[0], np.ndarray)
        return tuple(shape)

    assert (outcome(decorators.check_input_frames, port=True)
            == outcome(jdecorators.check_input_frames))


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("case", ["constant_1d", "constant_2d", "varying"])
def test_prepare_interpolator_matches_jax(as_tensor, case):
    values = {"constant_1d": np.full(5, 2.5), "constant_2d": np.full((5, 2), -1.0),
              "varying": np.arange(5.0)}[case]
    xy = np.random.RandomState(1).rand(5, 2)
    xgrid, ygrid = np.arange(4.0), np.arange(3.0)

    def run(deco):
        @deco()
        def interp(xy_coord, vals, xg, yg, **kw):
            return "called", tuple(vals.shape)

        return interp(xy, torch.from_numpy(values) if as_tensor else values, xgrid, ygrid)

    out, ref = run(decorators.prepare_interpolator), run(jdecorators.prepare_interpolator)
    if case == "varying":
        assert out == ref == ("called", (5,))
    else:
        assert isinstance(out, np.ndarray) and out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("make", [np.asarray, torch.as_tensor], ids=["numpy", "tensor"])
def test_memoize_matches_jax(make):
    """The port keys a tensor by its values as JAX keys an array (JAX's
    keys a tensor by identity): its hits on tensors are JAX's on arrays."""

    def counted(deco, make):
        calls = []

        @deco(maxsize=2)
        def f(x, scale=1.0):
            calls.append(1)
            return float(x.sum()) * scale

        a, b, c = (make(np.arange(4.0) + k) for k in range(3))
        outs = [f(a), f(a), f(b), f(a, scale=2.0), f(c), f(a), f(make(np.arange(4.0)))]
        return outs, len(calls)

    assert counted(decorators.memoize, make) == counted(jdecorators.memoize, np.asarray)
    # a tensor and an array of the same values are different keys
    calls = []

    @decorators.memoize()
    def g(x):
        calls.append(1)
        return 0

    g(np.zeros(3, np.float32))
    g(torch.zeros(3))
    g(torch.zeros(3))
    assert len(calls) == 2


def test_deprecate_args_and_postprocess_import_match_jax():
    def run(mod):
        @mod.deprecate_args({"old": "new"}, "1.0")
        def f(new=0):
            return new

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            val = f(old=3)
        return val, [str(x.message) for x in w]

    assert run(decorators) == run(jdecorators)

    def imported(mod):
        @mod.postprocess_import(fillna=-1.0, dtype="float64")
        def importer(fname):
            """doc"""
            return np.array([[np.nan, 1.0]], np.float32), None, {"unit": "mm/h"}

        out = importer("x")
        return out[0], out[0].dtype, out[2], importer.__name__, importer.__doc__

    out, ref = imported(decorators), imported(jdecorators)
    np.testing.assert_array_equal(out[0], ref[0])
    assert out[1:] == ref[1:]
