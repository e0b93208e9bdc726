"""The hierarchical and flat PWL maps of the PyTorch port through their
plain versions, and the port's ``match_cdf_pwl`` dispatch, held against
the JAX package on the CPU (Pallas in interpret mode).

Tolerance: 1e-5 x scale, as the JAX package's own test of its three apply
kernels (``tests/test_pallas_kernels.py:81-82``); the three evaluate the
same map and differ only in f32 summation order.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_chain as jpc
from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu_torch.ops import pallas_chain as tpc
from pysteps_tpu_torch.ops import pallas_histmatch as tph


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)
    monkeypatch.setattr(jpc, "INTERPRET", True)


def _case(shape, seed, n_members=3):
    """``tests/test_pallas_kernels.py``'s fields (rectified normals against
    a rectified normal target), one independent draw per member so that
    each has its own LUT, and both target states."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    fields = np.maximum(rng.normal(0.0, 2.0, (n_members,) + tuple(shape)), 0.0)
    fields = fields.astype(np.float32)
    target = np.sort(np.maximum(rng.normal(0.5, 3.0, size), 0.0)).astype(np.float32)
    ts_j = jph.prepare_target(jnp.asarray(target), jnp.float32(target[0]))
    ts_t = tph.prepare_target(torch.from_numpy(target), torch.tensor(target[0]))
    return fields, ts_j, ts_t


def test_hier_plain_matches_pallas():
    fields, ts_j, _ = _case((128, 128), 7)
    coeffs = [jph.build_pwl_coeffs(jnp.asarray(f.reshape(-1)), ts_j) for f in fields]
    packed = [jpc.pack_hier_lut(*c[:3]) for c in coeffs]
    out = tph.pwl_apply_hier(
        torch.from_numpy(fields.reshape(3, -1)),
        torch.from_numpy(np.stack([np.asarray(e)[:, 0] for e, _ in packed])),
        torch.from_numpy(np.stack([np.asarray(M) for _, M in packed])),
        *(torch.tensor([float(c[i]) for c in coeffs]) for i in (3, 4, 5)),
    ).numpy()
    for b, (c, (e16, M3)) in enumerate(zip(coeffs, packed)):
        ref = np.asarray(jph.pwl_apply_hier(jnp.asarray(fields[b].reshape(-1)), e16, M3, *c[3:]))
        assert np.abs(out[b] - ref).max() < 1e-5 * np.abs(ref).max()


def test_hier_below_first_block_gives_q0():
    """Below e16[0] no block is selected: the map gives q0, where the
    gather map K3 extends the first segment instead (here its slope is
    not 0).  The JAX kernel agrees on the whole row."""
    rng = np.random.default_rng(8)
    B = 2
    edges = np.sort(rng.normal(0.0, 3.0, (B, 128)), axis=1).astype(np.float32)
    d0 = rng.normal(0.0, 0.5, (B, 128)).astype(np.float32)
    d1 = rng.normal(0.0, 0.1, (B, 128)).astype(np.float32)
    d1[:, 0] = 0.7
    q0 = np.array([1.5, -2.0], np.float32)
    zval, ztrg = np.full(B, -100.0, np.float32), np.zeros(B, np.float32)
    below = edges[:, :1] - np.array([[1.0, 2.0, 5.0]], np.float32)
    inside = rng.uniform(edges[:, :1], edges[:, -1:], (B, 125)).astype(np.float32)
    x = np.concatenate([below, inside], axis=1)
    e16, M3 = tpc.pack_hier_lut(*(torch.from_numpy(a) for a in (edges, d0, d1)))
    args = (torch.from_numpy(q0), torch.from_numpy(zval), torch.from_numpy(ztrg))
    out = tph.pwl_apply_hier(torch.from_numpy(x), e16, M3, *args)
    torch.testing.assert_close(out[:, :3], torch.from_numpy(q0)[:, None].expand(B, 3),
                               rtol=0, atol=0)
    e8, T = tph.pack_gather_lut(*(torch.from_numpy(a) for a in (edges, d0, d1)))
    gather = tph.pwl_apply_gather(torch.from_numpy(x), e8, T, *args)
    assert not torch.equal(gather[:, :3], out[:, :3])
    for b in range(B):
        e16_j, M3_j = jpc.pack_hier_lut(*(jnp.asarray(a[b]) for a in (edges, d0, d1)))
        ref = np.asarray(jph.pwl_apply_hier(
            jnp.asarray(x[b]), e16_j, M3_j, q0[b], zval[b], ztrg[b]))
        np.testing.assert_array_equal(ref[:3], q0[b])
        assert np.abs(out[b].numpy() - ref).max() < 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(128, 128), (40, 128)])
def test_flat_matches_pallas(shape):
    """``match_cdf_pwl_flat``: the bf16x3 split by masking bits, the flat
    map, the dry override; (40, 128) has a row count the TPU kernels tile
    in 8-row steps.  The seed is the JAX test's own (7): the two sum the
    128 terms in other orders, so the difference grows with the LUT's
    cancellation (|d0| reaches thousands for some draws); here it stays
    below 200."""
    fields, ts_j, ts_t = _case(shape, 7)
    out = tph.match_cdf_pwl_flat(torch.from_numpy(fields), ts_t).numpy()
    for b in range(3):
        ref = np.asarray(jph.match_cdf_pwl_flat(jnp.asarray(fields[b]), ts_j))
        assert np.abs(out[b] - ref).max() < 1e-5 * np.abs(ref).max()
    # the plain map equals the f64 flat sum of the deltas
    x = torch.from_numpy(fields.reshape(3, -1))
    edges, d0, d1, q0, zval, ztrg = (c.double().numpy() for c in tph.build_pwl_coeffs(x, ts_t))
    for b in range(3):
        xs = fields[b].reshape(-1).astype(np.float64)
        cum = (xs[:, None] >= edges[b][None, :]).astype(np.float64)
        ref = np.where(xs == zval[b], ztrg, q0[b] + cum @ d0[b] + xs * (cum @ d1[b]))
        assert np.abs(out[b].reshape(-1) - ref).max() < 1e-4 * max(np.ptp(ref), 1.0)


def test_tile_rows_and_dispatch_follow_jax(monkeypatch):
    """The port's ``match_cdf_pwl`` takes the gather kernel exactly where
    the JAX package's does and the hierarchical map elsewhere."""
    for rows in list(range(1, 300)) + [800, 2048, 4096, 6144, 8192]:
        assert tph._tile_rows(rows) == jph._tile_rows(rows), rows
    calls = []
    for name in ("pwl_apply_gather", "pwl_apply_hier"):
        fn = getattr(tph, name)
        monkeypatch.setattr(
            tph, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a)
        )
    for shape in ((32, 128), (40, 128), (64, 128), (96, 128), (128, 128),
                  (160, 160), (320, 320), (256, 384)):
        calls.clear()
        fields, _, ts_t = _case(shape, 10, n_members=1)
        tph.match_cdf_pwl(torch.from_numpy(fields), ts_t)
        gather = jph._tile_rows(int(np.prod(shape)) // 128) % 32 == 0
        assert calls == ["pwl_apply_gather" if gather else "pwl_apply_hier"], shape


def test_match_cdf_pwl_at_a_hierarchical_shape():
    """160^2 (200 rows of 128, tiled in 8s): both packages apply the
    hierarchical map, with LUTs built by each package's own coefficients."""
    assert jph._tile_rows(200) % 32 != 0
    fields, ts_j, ts_t = _case((160, 160), 13, n_members=2)
    out = tph.match_cdf_pwl(torch.from_numpy(fields), ts_t).numpy()
    for b in range(2):
        ref = np.asarray(jph.match_cdf_pwl(jnp.asarray(fields[b]), ts_j))
        assert np.abs(out[b] - ref).max() < 1e-5 * np.abs(ref).max()
