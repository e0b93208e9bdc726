"""The plain model of the ``cdf_counts`` kernel's algorithm
(``pallas_histmatch._cdf_counts_search_plain``: the rank sort of the edges
with their indices, NaN last, the tree search of each pixel, the 129-bin
histogram, its suffix sums and their scatter) held against the port's plain
version, ``_cdf_counts_plain``, and against the JAX package's Pallas kernel
in interpret mode, on the same inputs made from numpy seeds (the cases of
the kernel's card tests, ``test_torch_kernels_cuda.cdf_case``).

Tolerance: exact (0).  All three count integers (the JAX kernel in f32,
exact below 2^24 pixels).  The JAX side takes only fields its tiling takes
(a multiple of 128 pixels).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu_torch.ops import pallas_histmatch as tph
from test_torch_kernels_cuda import CDF_CASES as CASES, NEG_NAN, cdf_case as _case


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)


def _model(x, edges):
    return tph._cdf_counts_search_plain(
        torch.from_numpy(np.atleast_2d(x)), torch.from_numpy(np.atleast_2d(edges))).numpy()


def _plain(x, edges):
    return tph._cdf_counts_plain(
        torch.from_numpy(np.atleast_2d(x)), torch.from_numpy(np.atleast_2d(edges))).numpy()


def _jax(x, edges):
    return np.asarray(jph.cdf_counts(jnp.asarray(x), jnp.asarray(edges)))


@pytest.mark.parametrize("case", CASES)
def test_model_equals_plain_and_jax(case):
    x, edges = _case(case)
    model = _model(x, edges)[0]
    np.testing.assert_array_equal(model, _plain(x, edges)[0])
    np.testing.assert_array_equal(model, _jax(x, edges))
    exact = (x[None, :] >= edges[:, None]).sum(axis=1).astype(np.float32)
    np.testing.assert_array_equal(model, exact)


@pytest.mark.parametrize("case", CASES)
def test_rank_sort(case):
    """The sorted edges are nondecreasing with every NaN last and -0
    before +0, the permutation is one, and ties (equal bits, or two NaNs)
    keep their index order."""
    _, edges = _case(case)
    srt, perm = tph._cdf_sort(torch.from_numpy(edges[None]))
    srt, perm = srt[0].numpy(), perm[0].numpy()
    assert sorted(perm.tolist()) == list(range(128))
    np.testing.assert_array_equal(srt.view(np.uint32), edges[perm].view(np.uint32))
    n_num = int((~np.isnan(edges)).sum())
    assert np.isnan(srt[n_num:]).all() and not np.isnan(srt[:n_num]).any()
    assert (srt[1:n_num] >= srt[: max(n_num - 1, 0)]).all()
    bits = srt.view(np.uint32)
    tied = (bits[1:] == bits[:-1]) | (np.isnan(srt[1:]) & np.isnan(srt[:-1]))
    assert (perm[1:][tied] > perm[:-1][tied]).all()
    zero = np.flatnonzero(srt[:n_num] == 0.0)
    assert (np.diff(np.signbit(srt[zero]).astype(int)) <= 0).all()


def test_sign_bit_nan_sorts_last():
    """A NaN with its sign bit set sorts after +inf by ``isnan``; under the
    usual bit-flip integer key it would land below -inf and break the
    search's prefix."""
    edges = np.linspace(-1.0, 1.0, 128).astype(np.float32)
    edges[[0, 64, 127]] = [NEG_NAN, -np.inf, np.inf]
    srt = tph._cdf_sort(torch.from_numpy(edges[None]))[0][0].numpy()
    assert srt[0] == -np.inf and srt[126] == np.inf and np.isnan(srt[127])
    bits = edges.view(np.uint32)
    key = np.where(bits >> 31, ~bits, bits | np.uint32(0x80000000))
    assert key[0] < key[64]  # the integer key's order: NaN below -inf


@pytest.mark.parametrize("case", CASES)
def test_tree_search_counts_the_prefix(case):
    """k = #{s : x >= sorted[s]} from the tree equals the direct count,
    NaN pixels 0."""
    x, edges = _case(case)
    srt = tph._cdf_sort(torch.from_numpy(edges[None]))[0]
    xt = torch.from_numpy(x[None])
    k = tph._tree_count(xt, srt, 7)
    np.testing.assert_array_equal(k.numpy(), (xt[:, :, None] >= srt[:, None, :]).sum(2).numpy())
    assert (k.numpy()[np.isnan(x[None])] == 0).all()


@pytest.mark.parametrize("n", [1, 3, 1001, 4 * 128 + 5])
def test_any_pixel_count(n):
    """N = 1 and N not a multiple of 4 or of 128 (port only: the TPU kernel
    needs a multiple of 128)."""
    x, edges = _case("hot_value" if n > 16 else "unsorted", n=n, seed=n)
    np.testing.assert_array_equal(_model(x, edges), _plain(x, edges))


@pytest.mark.parametrize("shape", [(13, 128), (64, 128)])
def test_other_tilings_match_jax(shape):
    """Fields of 13 rows of 128 (one whole-field tile) and 64 rows."""
    n = int(np.prod(shape))
    x, edges = _case("nan_pixels", n=n, seed=n)
    model = _model(x, edges)[0]
    np.testing.assert_array_equal(model, _jax(x.reshape(shape), edges))
    np.testing.assert_array_equal(model, _plain(x, edges)[0])


def test_batched_members_each_their_own_case():
    """(B, N) with (B, 128): each member sorts and counts its own edges, as
    ``vmap(cdf_counts)``."""
    cases = [_case(name, seed=b) for b, name in enumerate(CASES)]
    x = np.stack([c[0] for c in cases])
    edges = np.stack([c[1] for c in cases])
    model = _model(x, edges)
    np.testing.assert_array_equal(model, _plain(x, edges))
    for b in range(len(CASES)):
        np.testing.assert_array_equal(model[b], _jax(x[b], edges[b]))
