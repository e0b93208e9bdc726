"""Kernel K4's decomposition (``csrc/rim.cu``), as a plain numpy model held
against K4's plain version and the JAX package's two rim kernels (Pallas
in interpret mode) on the CPU.

The model does what a block of the tile kernel does: per tile of W
columns by H rows, the window of rows and columns R beyond it, clipped to
the field, becomes wet words of 32 bits; each column's horizontal
distance comes from the words; a backward then a forward min-plus down
the column gives the bounded L1 distance (for R <= 31 the kernel's
distances stop at 32, not R + 1: the same rim); the rim is looked up
from a table of ``pst_rim_of``; the tiles are stitched.  Cases: numpy-
seeded fields with NaN pixels, shapes that are not multiples of the
tile, R <= 31, R > 31 (the kernel's word walk) and R wider than the field,
``thr`` = +-inf, float masks with values in (0, 1) and bool masks.

Tolerances: none against ``_rim_plain`` (``torch.equal``: both compute the
same small integers and the same f32 division), 1e-6 against JAX (its
distances are floats around 1e9 and the clip in another order).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_dilate as jpd
from pysteps_tpu_torch.ops import pallas_dilate as tpd


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpd, "INTERPRET", True)


def _wet_words(wet):
    """(rows, cols) bool -> (rows, ceil(cols / 32)) uint32 words, bit k of
    word q the column 32 q + k (a warp's ballot)."""
    rows, cols = wet.shape
    nw = -(-cols // 32)
    bits = np.zeros((rows, nw * 32), np.uint64)
    bits[:, :cols] = wet
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(rows, nw, 32) * weights).sum(axis=2).astype(np.uint32)


def _hdist(words, p, reach):
    """Distance from window positions ``p`` to the nearest wet bit of each
    row within ``reach`` positions, reach + 1 if none, read from the
    words."""
    rows, nw = words.shape
    d = np.full((rows, len(p)), reach + 1, np.int64)
    for k in range(reach, -1, -1):
        for pos in (p - k, p + k):
            ok = (pos >= 0) & (pos < 32 * nw)
            q, bit = np.where(ok, pos, 0) >> 5, np.where(ok, pos, 0) & 31
            hit = ok & (((words[:, q] >> bit.astype(np.uint32)) & 1) == 1)
            d = np.where(hit, k, d)
    return d


def _tile_model(x, thr, strict, kr, r, W, H):
    """K4's tile decomposition on a (B, m, n) numpy array."""
    B, m, n = x.shape
    R = kr + r
    # for R <= 31 the kernel's distances reach 31 and stop at 32, not R + 1
    reach = R if R > 31 else 31
    table = np.clip(
        (np.float32(R + 1) - np.arange(max(R + 2, 33), dtype=np.float32)) / np.float32(r + 1),
        np.float32(0), np.float32(1)).astype(np.float32)
    with np.errstate(invalid="ignore"):
        wet_all = x > thr if strict else x >= thr
    out = np.empty((B, m, n), np.float32)
    for b in range(B):
        for i0 in range(0, m, H):
            iend = min(m, i0 + H)
            rs, re = max(0, i0 - R), min(m, iend + R)
            for j0 in range(0, n, W):
                cw = min(W, n - j0)
                cs, ce = max(0, j0 - R), min(n, j0 + W + R)
                words = _wet_words(wet_all[b, rs:re, cs:ce])
                dh = _hdist(words, np.arange(cw) + j0 - cs, reach)  # (re - rs, cw)
                g = np.full(cw, reach + 1)
                back = {}
                for i in range(re - 1, i0 - 1, -1):
                    g = np.minimum(dh[i - rs], g + 1)
                    back[i] = g
                f = np.full(cw, reach + 1)
                for i in range(rs, iend):
                    f = np.minimum(back[i] if i >= i0 else dh[i - rs], f + 1)
                    if i >= i0:
                        out[b, i, j0:j0 + cw] = table[f]
    return out


def _field(shape, seed, nan_frac=0.05):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, shape).astype(np.float32)
    x[rng.random(shape) < nan_frac] = np.nan
    return x


def _jax_from_field(x, thr, kr, r):
    """JAX's whole-field kernel; where its jump doubling would roll by more
    than the field's side (a power of two <= R above min(m, n)), which it
    refuses, its banded kernel on the thresholded field."""
    R, side = kr + r, min(x.shape[1:])
    if R > 0 and 1 << (R.bit_length() - 1) > side:
        with np.errstate(invalid="ignore"):
            return _jax_from_mask(x >= thr, kr, r)
    return np.stack([np.asarray(jpd.dilated_rim_from_field_pallas(
        jnp.asarray(f), thr, kr, r)) for f in x])


def _jax_from_mask(mask, kr, r):
    return np.stack([np.asarray(jpd.dilated_rim_pallas(jnp.asarray(f), kr, r))
                     for f in mask])


@pytest.mark.parametrize("W,H", [(128, 8), (16, 8), (32, 64)])
@pytest.mark.parametrize("kr,r", [(0, 0), (2, 10), (3, 30), (1, 60)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 9, 10), (1, 70, 45)])
def test_tile_model_equals_plain_and_jax(shape, kr, r, W, H):
    """R = 0, 12, 33 (word walk) and 61 (wider than every field here)."""
    x = _field(shape, seed=kr + 7 * r + shape[1])
    thr = 1.0
    model = _tile_model(x, thr, False, kr, r, W, H)
    plain = tpd.dilated_rim_from_field(torch.from_numpy(x), thr, kr, r)
    assert torch.equal(torch.from_numpy(model), plain)
    np.testing.assert_allclose(model, _jax_from_field(x, thr, kr, r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kr,r", [(2, 10), (3, 30)])
@pytest.mark.parametrize("dtype", ["bool", "float"])
def test_tile_model_masks(kr, r, dtype):
    """The mask entry point: wet where > 0, a float mask with values in
    (0, 1) (and NaN, never wet) or a bool mask, through the model read as
    given (strict, thr 0) and through JAX's banded kernel."""
    rng = np.random.default_rng(kr + r)
    shape = (2, 41, 67)
    mask = np.where(rng.random(shape) > 0.97, rng.uniform(0.01, 0.99, shape), 0.0)
    mask = mask.astype(np.float32)
    if dtype == "bool":
        mask = mask > 0
    else:
        mask[rng.random(shape) < 0.02] = np.nan
    model = _tile_model(mask.astype(np.float32), 0.0, True, kr, r, 32, 8)
    plain = tpd.dilated_rim(torch.from_numpy(mask), kr, r)
    assert torch.equal(torch.from_numpy(model), plain)
    ref_mask = np.nan_to_num(mask.astype(np.float32), nan=0.0)
    np.testing.assert_allclose(model, _jax_from_mask(ref_mask, kr, r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("thr", [float("inf"), float("-inf")])
def test_tile_model_infinite_thresholds(thr):
    """thr = +inf: only +inf pixels are wet; thr = -inf: every pixel but
    NaN is wet."""
    x = _field((2, 33, 40), seed=5, nan_frac=0.1)
    x[0, 3, 7] = np.inf
    model = _tile_model(x, thr, False, 2, 10, 16, 8)
    plain = tpd.dilated_rim_from_field(torch.from_numpy(x), thr, 2, 10)
    assert torch.equal(torch.from_numpy(model), plain)
    np.testing.assert_allclose(model, _jax_from_field(x, thr, 2, 10), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kr,r", [(4, 30), (10, 40)])
def test_plain_rim_matches_jax_above_31(kr, r):
    """K4's plain version against both JAX kernels at R = 34 and 50, on a
    field wider than 32 columns and narrower than 2R + 1."""
    x = _field((1, 48, 96), seed=kr * r)
    out = tpd.dilated_rim_from_field(torch.from_numpy(x), 0.8, kr, r).numpy()
    np.testing.assert_allclose(out, _jax_from_field(x, 0.8, kr, r), rtol=0, atol=1e-6)
    mask = np.nan_to_num(x) >= 0.8
    out_m = tpd.dilated_rim(torch.from_numpy(mask), kr, r).numpy()
    np.testing.assert_allclose(out_m, _jax_from_mask(mask, kr, r), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out, out_m)
