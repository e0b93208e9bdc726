"""``cdf_counts`` of the PyTorch port (its plain version, on the CPU) held
against the JAX package's Pallas kernel in interpret mode, on the same
inputs made from numpy seeds.

Tolerance: exact (0).  Both count integers: the JAX kernel sums 0/1 floats
in f32, exact below 2^24 pixels, and the port counts in integers and
converts once, so the two are bit-equal at these sizes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu_torch.ops import pallas_histmatch as tph


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)


def _field_and_edges(shape, seed):
    """A field on a quarter-unit grid (so many pixels tie with an edge) and
    128 unsorted edges, most of them pixel values."""
    rng = np.random.default_rng(seed)
    field = (np.round(rng.normal(0.0, 3.0, shape) * 4.0) / 4.0).astype(np.float32)
    flat = field.reshape(-1)
    edges = np.concatenate([
        flat[rng.integers(0, flat.size, 96)],
        rng.normal(0.0, 4.0, 32).astype(np.float32),
    ])
    return field, rng.permutation(edges).astype(np.float32)


def _jax(field, edges):
    return np.asarray(jph.cdf_counts(jnp.asarray(field), jnp.asarray(edges)))


def _port(field, edges):
    return tph.cdf_counts(torch.from_numpy(field), torch.from_numpy(edges)).numpy()


@pytest.mark.parametrize(
    "shape,tile",
    [((512, 512), 2048), ((128, 128), 64), ((160, 160), 8), ((13, 128), 13)],
)
def test_matches_jax_on_every_tiling(shape, tile):
    """One case per branch of the TPU kernel's ``_tile_rows``: tiles of
    2048, 64 and 8 rows, and one whole-field tile of 13 rows."""
    assert jph._tile_rows(int(np.prod(shape)) // 128) == tile
    field, edges = _field_and_edges(shape, sum(shape))
    out = _port(field, edges)
    assert out.dtype == np.float32 and out.shape == (128,)
    np.testing.assert_array_equal(out, _jax(field, edges))
    exact = (field.reshape(-1)[None, :] >= edges[:, None]).sum(axis=1)
    np.testing.assert_array_equal(out, exact.astype(np.float32))


def test_special_edges_and_pixels_match_jax():
    """NaN, +inf and -inf edges; duplicate, unsorted edges and edges equal
    to pixel values; NaN pixels, -0.0 against a 0.0 edge and infinite
    pixels."""
    field, edges = _field_and_edges((128, 128), 3)
    flat = field.reshape(-1)
    flat[:50] = np.nan
    flat[50:80] = -0.0
    flat[80:90] = 0.0
    flat[90:95] = np.inf
    flat[95:99] = -np.inf
    edges[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, np.nan, flat[200], flat[200]]
    out = _port(field, edges)
    np.testing.assert_array_equal(out, _jax(field, edges))
    n_nan = int(np.isnan(flat).sum())
    assert out[0] == 0 and out[5] == 0  # x >= NaN is false
    assert out[1] == 5  # the +inf pixels
    assert out[2] == flat.size - n_nan  # every pixel but the NaN ones
    assert out[3] == out[4] == int((flat >= 0.0).sum())  # -0.0 >= 0.0
    assert out[6] == out[7]


def test_batched_form_matches_jax_member_by_member():
    """``edges`` (B, 128) with ``field`` (B, ...) counts per member, as
    ``vmap(cdf_counts)``."""
    B = 3
    cases = [_field_and_edges((64, 128), 20 + b) for b in range(B)]
    fields = np.stack([f for f, _ in cases])
    edges = np.stack([e for _, e in cases])
    out = _port(fields, edges)
    assert out.shape == (B, 128)
    for b in range(B):
        np.testing.assert_array_equal(out[b], _jax(fields[b], edges[b]))


def test_tail_counts_of_both_lut_builds():
    """On the fields the PWL LUT build sees, at the edges it places: the
    last 16 counts equal the build's exact tail counts ``size - r_tail``
    (``#(x >= e_j)`` for its top 16 edges, ``pallas_histmatch.py:415-417``),
    in both packages."""
    rng = np.random.default_rng(11)
    B, shape = 2, (128, 128)
    size = int(np.prod(shape))
    fields = np.maximum(rng.normal(0.0, 2.0, (B,) + shape), 0.0).astype(np.float32)
    target = np.sort(np.maximum(rng.normal(0.5, 3.0, size), 0.0)).astype(np.float32)
    ts_t = tph.prepare_target(torch.from_numpy(target), torch.tensor(target[0]))
    ts_j = jph.prepare_target(jnp.asarray(target), jnp.float32(target[0]))

    x = torch.from_numpy(fields.reshape(B, -1))
    edges = tph.build_pwl_coeffs(x, ts_t)[0]
    counts = tph.cdf_counts(x, edges)
    tail_ge = (x[:, None, :] >= edges[:, -16:, None]).sum(dim=2)
    torch.testing.assert_close(counts[:, -16:], tail_ge.to(torch.float32), rtol=0, atol=0)

    for b in range(B):
        init = jnp.asarray(fields[b].reshape(-1))
        e_j = jph.build_pwl_coeffs(init, ts_j)[0]
        r_tail = size - jnp.sum((init[:, None] >= e_j[None, -16:]).astype(jnp.float32), axis=0)
        ref = _jax(fields[b], np.array(e_j))
        np.testing.assert_array_equal(ref[-16:], size - np.asarray(r_tail))
        np.testing.assert_array_equal(_port(fields[b], np.array(e_j)), ref)


@pytest.mark.parametrize("n_edges", [64, 129])
def test_other_edge_counts_raise(n_edges):
    """JAX's ``edges.reshape(K, 1)`` fails for any K but 128; so does the
    port, in both forms."""
    field = torch.zeros((2, 128 * 4))
    with pytest.raises(ValueError):
        tph.cdf_counts(field, torch.zeros(n_edges))
    with pytest.raises(ValueError):
        tph.cdf_counts(field, torch.zeros((2, n_edges)))
    with pytest.raises(TypeError):
        jph.cdf_counts(jnp.zeros(128 * 4), jnp.zeros(n_edges))


@pytest.mark.parametrize("N", [1, 1000])
def test_any_pixel_count_on_the_port(N):
    """The TPU kernel needs a multiple of 128 pixels; the port takes any
    count, held here against an exact numpy count."""
    rng = np.random.default_rng(N)
    fields = rng.normal(0.0, 1.0, (2, N)).astype(np.float32)
    edges = rng.normal(0.0, 1.0, (2, 128)).astype(np.float32)
    out = _port(fields, edges)
    exact = (fields[:, None, :] >= edges[:, :, None]).sum(axis=2)
    np.testing.assert_array_equal(out, exact.astype(np.float32))


def test_plain_chunks_do_not_change_the_count(monkeypatch):
    """The plain version's pixel chunks (1 << 24 compare elements) split a
    large field; a small chunk gives the same counts."""
    field, edges = _field_and_edges((40, 128), 5)
    whole = _port(field, edges)
    monkeypatch.setattr(tph, "_PLAIN_CHUNK", 128 * 7)
    np.testing.assert_array_equal(_port(field, edges), whole)
