"""Kernel K2's decomposition (``csrc/warp.cu``), as a plain torch model held
against K2's plain version and the JAX package's ``warp_fused_pallas``
(Pallas in interpret mode) on the CPU, and the tile geometry that the
wrapper computes for the card.

The model does what a block of the tile kernel does: per tile of ``th``
rows by ``tw`` columns, the vertical lerp of its rows over every column a
horizontal tap can reach, [j0 - D, j0 + tw + D], clipped to the field;
then, ``WARP_CH`` columns at a time, the two transposed displacement
planes read along i and transposed, and each output one lerp from the
tile's rows, with the fill; the tiles are stitched.  It asserts that every
tap lies in its tile's columns and that those fit the ``cols`` of the
geometry (``warp_tile``), the shared rows the kernel is launched with.  Where ``warp_geometry`` gives the
two-pass route, the model is the two passes.  Cases: numpy-seeded fields
with NaN and +-inf in the field and the displacement, shapes that are
not multiples of the tile, strips and column tiles, D from 8 to beyond
the field, both ``masked`` values.

Tolerances: none against ``_warp_fused_plain`` (``torch.equal`` with the
same NaN set: the same operations in the same order), 1e-5 x span against
JAX (as ``tests/test_torch_warp.py``; its lerp gathers rows through
one-hot chunks).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_warp as jpw
from pysteps_tpu_torch.ops import _kernels
from pysteps_tpu_torch.ops import pallas_warp as tpw


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpw, "INTERPRET", True)


def _taps(pos, disp, D, size):
    """pst_tap: the clipped taps and the weight of pos + disp."""
    c = pos.float() + disp
    f = torch.floor(c)
    k = torch.clamp(f.int(), pos - D, pos + D)
    return torch.clamp(k, 0, size - 1).long(), torch.clamp(k + 1, 0, size - 1).long(), c - f, c


def _lerp(a, c, w):
    return a * (1.0 - w) + c * w


def _tile_model(field, dy, disp_t, D, cval, masked, th, tw, cols):
    """K2's tile decomposition on (B, m, n) CPU tensors, D rounded, with
    ``cols`` columns of the vertical stage a tile holds."""
    B, m, n = field.shape
    out = torch.full_like(field, -12345.0)
    Dn = min(D, n)
    for i0 in range(0, m, th):
        rows = min(th, m - i0)
        i = torch.arange(i0, i0 + rows, dtype=torch.int32)[:, None]
        for j0 in range(0, n, tw):
            jend = min(n, j0 + tw)
            cs, ce = max(0, j0 - Dn), min(n, jend + Dn + 1)
            assert ce - cs <= cols
            k0, k1, w, _ = _taps(i, dy[:, i0:i0 + rows, cs:ce], D, m)
            band = field[:, :, cs:ce]
            C = _lerp(torch.gather(band, 1, k0), torch.gather(band, 1, k1), w)
            for jc0 in range(j0, jend, tpw.WARP_CH):
                jc1 = min(jend, jc0 + tpw.WARP_CH)
                j = torch.arange(jc0, jc1, dtype=torch.int32)[None, :]
                # the planes' rows jc0..jc1, read along i, then transposed
                dxs = disp_t[:, 0, jc0:jc1, i0:i0 + rows].transpose(1, 2)
                x0, x1, wx, cx = _taps(j, dxs, D, n)
                assert int(x0.min()) >= cs and int(x1.max()) < ce  # in the tile
                v = _lerp(torch.gather(C, 2, x0 - cs), torch.gather(C, 2, x1 - cs), wx)
                if masked:
                    cy = i.float() + disp_t[:, 1, jc0:jc1, i0:i0 + rows].transpose(1, 2)
                    inside = (cy >= 0) & (cy <= m - 1) & (cx >= 0) & (cx <= n - 1)
                    v = torch.where(inside, v, float(cval))
                out[:, i0:i0 + rows, jc0:jc1] = v
    return out


def _model(field, dy, disp_t, D, cval, masked, geometry):
    D = tpw._round8(D)
    if geometry["route"] == "two_pass":
        C = tpw._warp_v_plain(field, dy, D)
        return tpw._warp_h_plain(C, disp_t, D, cval, masked)
    return _tile_model(field, dy, disp_t, D, cval, masked, geometry["th"], geometry["tw"],
                       geometry["cols"])


def _inputs(shape, seed, amp, specials=True):
    """A field, its displacement (dy, disp_t) of about +-amp px, as CPU
    tensors; with ``specials`` NaN and +-inf pixels in both."""
    rng = np.random.default_rng(seed)
    B, m, n = shape
    field = (rng.normal(0.0, 5.0, shape) + 10.0).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0, 3, m), np.linspace(0, 2, n), indexing="ij")
    a = rng.uniform(0.5, 1.0, (B, 2, 1, 1))
    disp = amp * np.stack([a[:, 0] * np.sin(xx + yy) + 0.1,
                           -a[:, 1] * np.cos(0.7 * xx - yy) + 0.15], axis=1)
    disp = disp.astype(np.float32)
    if specials:
        for arr in (field, disp):
            flat = arr.reshape(-1)
            idx = rng.choice(flat.size, 3 * max(1, flat.size // 400), replace=False)
            flat[idx] = np.tile(np.array([np.nan, np.inf, -np.inf], np.float32), len(idx) // 3)
    dy = np.ascontiguousarray(disp[:, 1])
    disp_t = np.ascontiguousarray(disp.transpose(0, 1, 3, 2))
    return torch.from_numpy(field), torch.from_numpy(dy), torch.from_numpy(disp_t)


def _equal(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


GEOMETRIES = [  # (th, tw): tw = None is the strip (tw = n)
    (16, None), (8, 16), (4, 64), (1, 7),
]


@pytest.mark.parametrize("th,tw", GEOMETRIES)
@pytest.mark.parametrize("D,amp", [(8, 6.0), (13, 20.0), (48, 30.0), (200, 150.0)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 9, 10), (1, 70, 130)])
def test_tile_model_equals_plain(shape, D, amp, th, tw):
    """D = 13 rounds to 16; |disp| beyond D pins the clip; D = 200 is wider
    than every field here (the halo is the whole row)."""
    field, dy, disp_t = _inputs(shape, seed=D + shape[2] + th, amp=amp)
    geometry = tpw.warp_tile(*shape, D, th, tw or shape[2])
    for masked in (True, False):
        plain = tpw.warp_fused(field, dy, disp_t, D, float("nan"), masked)
        model = _model(field, dy, disp_t, D, float("nan"), masked, geometry)
        assert _equal(model, plain)
    assert bool(torch.isnan(plain).any())


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape,D", [((3, 64, 96), 13), ((1, 40, 200), 48), ((2, 24, 16), 300)])
def test_geometry_model_equals_plain_and_jax(shape, D, masked):
    """At the geometry the wrapper computes for the card, on finite inputs
    of multiples of 8 (the JAX kernel's domain), against the plain version
    and ``warp_fused_pallas``; cval 0."""
    field, dy, disp_t = _inputs(shape, seed=shape[1] + D, amp=20.0, specials=False)
    geometry = tpw.warp_geometry(*shape, D)
    assert geometry["route"] == "tile"
    model = _model(field, dy, disp_t, D, 0.0, masked, geometry)
    assert _equal(model, tpw.warp_fused(field, dy, disp_t, D, 0.0, masked))
    span = float(field.max() - field.min())
    for b in range(shape[0]):
        ref = np.asarray(jpw.warp_fused_pallas(
            jnp.asarray(field[b].numpy()), jnp.asarray(dy[b].numpy()),
            jnp.asarray(disp_t[b].numpy()), D, jnp.float32(0.0), masked=masked))
        err = np.abs(ref - model[b].numpy()).max()
        assert err <= 1e-5 * span, (err, span)


def test_two_pass_route_model():
    """A field too wide for any tile at this D takes the two passes; the
    model then is the plain version itself, on a thin field."""
    shape, D = (1, 2, 60000), 30000
    assert tpw.warp_route(shape[1], shape[2], D) == "two_pass"
    field, dy, disp_t = _inputs(shape, seed=1, amp=40.0)
    geometry = tpw.warp_geometry(*shape, D)
    model = _model(field, dy, disp_t, D, float("nan"), True, geometry)
    assert _equal(model, tpw.warp_fused(field, dy, disp_t, D, float("nan"), True))


def test_geometry_of_the_paths():
    """Path C: full-width strips of 16 rows; path B, whose strip would take
    more than WARP_STRIP_BYTES: column tiles of 16 x 256 with a halo of 48
    columns on either side; enough blocks for 2 an SM of 132, and the
    shared memory the layout says."""
    b = tpw.warp_geometry(32, 1024, 1024, 48)
    assert b == {"route": "tile", "th": 16, "tw": 256, "cols": 256 + 97,
                 "smem_bytes": 16 * 353 * 4 + 4 * 64 * 17 * 4, "blocks": 32 * 64 * 4}
    c = tpw.warp_geometry(96, 320, 320, 48)
    assert (c["th"], c["tw"], c["cols"], c["blocks"]) == (16, 320, 320, 96 * 20)
    assert c["smem_bytes"] == 16 * 320 * 4 + 4 * 64 * 17 * 4
    # fewer members: the rows fall until 2 blocks an SM exist
    assert tpw.warp_geometry(2, 1024, 1024, 48)["th"] == 16  # 512 tiles of 256 columns
    assert tpw.warp_geometry(2, 512, 512, 48)["th"] == 2  # 512 strips
    assert tpw.warp_geometry(1, 512, 512, 48)["th"] == 1  # 512 strips
    assert tpw.warp_geometry(1, 9, 10, 48)["th"] == 1
    # D is rounded up to 8 before the halo is sized
    assert tpw.warp_geometry(32, 256, 4096, 13)["cols"] == 256 + 2 * 16 + 1


def test_geometry_strip_and_shared_memory_limits():
    """Strips while th rows of n columns fit WARP_STRIP_BYTES (at th 16:
    n <= 752), then column tiles of WARP_TW (256) with a halo of
    2 min(D, n) + 1;
    the tile route while one row of a tile fits the H100's 227 KB (cols <= 57600),
    two passes beyond."""
    assert tpw._warp_smem(16, 752) <= tpw.WARP_STRIP_BYTES < tpw._warp_smem(16, 753)
    strip = tpw.warp_geometry(128, 64, 752, 48)
    tile = tpw.warp_geometry(128, 64, 753, 48)
    assert (strip["th"], strip["tw"], strip["cols"]) == (16, 752, 752)
    assert (tile["th"], tile["tw"], tile["cols"]) == (16, 256, 256 + 97)
    assert tpw._warp_smem(1, 57600) == _kernels.SMEM_LIMIT
    assert tpw.warp_route(2, 57600, 30000) == "tile"
    assert tpw.warp_geometry(1, 2, 57600, 30000)["smem_bytes"] == _kernels.SMEM_LIMIT
    assert tpw.warp_route(2, 57601, 30000) == "two_pass"
    # on a wider field the halo decides: 256 + 2 D + 1 <= 57600
    assert tpw.warp_route(2, 100000, 28664) == "tile"
    assert tpw.warp_route(2, 100000, 28665) == "two_pass"  # rounds to 28672
    assert tpw.warp_route(1024, 1024, 48) == tpw.warp_route(320, 320, 48) == "tile"
    for geometry in (strip, tile):
        assert geometry["smem_bytes"] == tpw._warp_smem(geometry["th"], geometry["cols"])
