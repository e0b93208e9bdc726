"""The utilities that dense Lucas-Kanade needs, ported to
``pysteps_tpu_torch.utils`` (``images``, ``cleansing``, ``interpolate``)
and the port's stencils (``ops/conv.py``), against the JAX package on the
CPU.

Inputs: numpy-seeded 64 x 80 fields with NaNs and dry areas, and
O(100) scattered samples at non-integer coordinates (so that no grid
point has tied k-th neighbours).  Tolerances: the openings and the
host-side cleansing equal; the stencils and interpolations within 1e-5
of the output's largest magnitude (float32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysteps_tpu.utils import cleansing as jcl
from pysteps_tpu.utils import images as jim
from pysteps_tpu.utils import interpolate as jip
from pysteps_tpu_torch.ops import conv as tconv
from pysteps_tpu_torch.utils import cleansing as tcl
from pysteps_tpu_torch.utils import images as tim
from pysteps_tpu_torch.utils import interpolate as tip


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the tier-1 run
    shares the machine's cores among its workers, and a pool of one thread
    a core in each worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(seed, m=64, n=80, nan=True):
    rng = np.random.default_rng(seed)
    f = np.maximum(rng.gamma(0.6, 5.0, (m, n)) - 1.0, 0.0).astype(np.float32)
    if nan:
        f[:4, :] = np.nan
    return f


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    scale = max(float(np.nanmax(np.abs(ref))), 1e-30)
    assert np.nanmax(np.abs(out - ref)) <= rtol * scale


@pytest.mark.parametrize("k", [(3, 3), (4, 4), (1, 15), (6, 1)])
def test_corr_same_pads_like_jax(k):
    rng = np.random.default_rng(sum(k))
    f = rng.normal(size=(2, 30, 26)).astype(np.float32)
    w = rng.normal(size=k).astype(np.float32)
    ref = jax.vmap(lambda x: jax.lax.conv_general_dilated(
        x[None, None], w[None, None], (1, 1), "SAME")[0, 0])(f)
    _close(tconv.corr_same(torch.tensor(f), torch.tensor(w)), ref)


@pytest.mark.parametrize("size", [3, 4, 5])
@pytest.mark.parametrize("op", ["max", "min"])
def test_pool_same_like_reduce_window(size, op):
    f = np.random.default_rng(size).normal(size=(30, 26)).astype(np.float32)
    init, fn = (-jnp.inf, jax.lax.max) if op == "max" else (jnp.inf, jax.lax.min)
    ref = jax.lax.reduce_window(f, init, fn, (size, size), (1, 1), "SAME")
    np.testing.assert_array_equal(tconv.pool_same(torch.tensor(f), size, op).numpy(),
                                  np.asarray(ref))


def test_ieee_fp32_restores_the_flag():
    before = torch.backends.cudnn.allow_tf32
    with tconv.ieee_fp32():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


@pytest.mark.parametrize("n", [3, 4, 7])
def test_morph_opening(n):
    f = _field(n)
    thr = 1.0
    out = tim.morph_opening(f, thr, n, device="cpu")
    np.testing.assert_array_equal(out.numpy(), np.asarray(jim.morph_opening(f, thr, n)))


def test_morph_opening_batch():
    fields = np.stack([_field(s, nan=False) for s in (1, 2, 3)])
    thrs = [0.5, 1.0, 2.0]
    out = tim.morph_opening_batch(fields, thrs, 3, device="cpu")
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jim.morph_opening_batch(fields, thrs, 3)))


def _points(seed, n=120, m=64, w=80):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, w - 1, n), rng.uniform(0, m - 1, n)], axis=1)
    uv = np.stack([2.0 + 0.3 * rng.normal(size=n), 1.0 + 0.3 * rng.normal(size=n)], axis=1)
    uv[:4] += 9.0  # outliers
    return xy.astype(np.float32), uv.astype(np.float32)


@pytest.mark.parametrize("min_samples", [1, 2])
def test_decluster(min_samples):
    xy, uv = _points(1)
    out = tcl.decluster(torch.tensor(xy), uv, 10, min_samples)
    ref = jcl.decluster(xy, uv, 10, min_samples)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [None, 12])
@pytest.mark.parametrize("one_variable", [False, True])
def test_detect_outliers(k, one_variable):
    xy, uv = _points(2)
    data = uv[:, 0] if one_variable else uv
    out = tcl.detect_outliers(torch.tensor(data), 3.0, coord=xy, k=k)
    np.testing.assert_array_equal(out, jcl.detect_outliers(data, 3.0, coord=xy, k=k))
    if k is None:
        assert out[:4].all()


def test_cleansing_rejects_non_finite():
    xy, uv = _points(3)
    uv[0, 0] = np.nan
    with pytest.raises(ValueError):
        tcl.decluster(xy, uv, 10)
    with pytest.raises(ValueError):
        tcl.detect_outliers(uv, 3.0)


@pytest.mark.parametrize("k", [None, 7, 20])
@pytest.mark.parametrize("one_value", [False, True])
def test_idwinterp2d(k, one_value):
    xy, uv = _points(4)
    values = uv[:, 0] if one_value else uv
    xg, yg = np.arange(80, dtype=np.float32), np.arange(64, dtype=np.float32)
    out = tip.idwinterp2d(xy, values, xg, yg, k=k, power=1.0, device="cpu")
    _close(out, jip.idwinterp2d(xy, values, xg, yg, k=k, power=1.0))


@pytest.mark.parametrize("epsilon", [None, 6.0])
def test_rbfinterp2d(epsilon):
    xy, uv = _points(5, n=60)
    xg, yg = np.arange(80, dtype=np.float32), np.arange(64, dtype=np.float32)
    kw = {} if epsilon is None else {"epsilon": epsilon}
    out = tip.rbfinterp2d(xy, uv[:, 1], xg, yg, device="cpu", **kw)
    _close(out, jip.rbfinterp2d(xy, uv[:, 1], xg, yg, **kw), 1e-3)
