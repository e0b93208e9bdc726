"""The prefix-table PWL evaluation of chain stage 1 (``csrc/chain.cu``),
through its plain model ``pallas_histmatch._pwl_apply_prefix_plain``, held
against K3's 15-term sum (``_pwl_apply_gather_plain``) and the JAX
package's ``pwl_apply_gather`` (Pallas in interpret mode) on the CPU, on
LUTs that the JAX package's ``build_pwl_coeffs`` builds from numpy-seeded
fields with a dry floor (duplicated edges, ``zval`` pixels) and NaN pixels.

Tolerance: none; the values are equal under == (NaN where NaN).  XLA's CPU
build contracts the JAX kernel's last ``(q0 + acc0) + x * acc1`` into one
fused multiply-add, which the card and the plain versions do not, so the
JAX side is held on its two sums: the model's sums combined as that FMA
(in f64, one rounding to f32) give the JAX values bit for bit.
"""

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu.postprocessing import probmatching as jpm
from pysteps_tpu_torch.ops import pallas_histmatch as tph


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)


def _case(shape, seed):
    """A dB field with a dry floor, its JAX LUT and scalars, as numpy; a
    few pixels set to NaN after the LUT build."""
    rng = np.random.default_rng(seed)
    target = np.where(
        rng.random(shape) > 0.55, rng.gamma(2.0, 6.0, shape) + 5.0, -15.0
    ).astype(np.float32)
    field = np.maximum(target + rng.normal(0.0, 2.0, shape), -15.0).astype(np.float32)
    field[rng.random(shape) < 0.3] = -15.0  # the dry floor: zval pixels
    ranked, zv = jpm._prepare_cdf_target(jnp.asarray(target))
    coeffs = jph.build_pwl_coeffs(jnp.asarray(field.reshape(-1)), jph.prepare_target(ranked, zv))
    e8, T = jph.pack_gather_lut(*coeffs[:3])
    field.reshape(-1)[rng.choice(field.size, 7, replace=False)] = np.nan
    scal = np.array([float(coeffs[i]) for i in (3, 4, 5)], np.float32)
    return field, np.array(coeffs[0]), np.array(e8)[:, 0], np.array(T), scal


def _equal(a, b):
    """Equal under == with the same NaN set."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.parametrize("shape,seed", [((64, 128), 1), ((128, 128), 2), ((64, 256), 3)])
def test_prefix_model_is_the_15_term_sum_and_jax(shape, seed):
    field, edges, e8, T, scal = _case(shape, seed)
    assert (edges[1:] == edges[:-1]).any()  # the dry floor duplicates edges
    assert (field == scal[1]).mean() > 0.2 and np.isnan(field).sum() == 7
    x = torch.from_numpy(field.reshape(1, -1))
    e8_t, T_t = torch.from_numpy(e8)[None], torch.from_numpy(T)[None]
    q0, zval, ztrg = (torch.tensor([float(v)]) for v in scal)
    assert bool(tph._pwl_prefix_ok(T_t).all())
    out = tph._pwl_apply_prefix_plain(x, e8_t, T_t, q0, zval, ztrg)
    assert _equal(out, tph._pwl_apply_gather_plain(x, e8_t, T_t, q0, zval, ztrg))

    ref = torch.from_numpy(np.array(jph.pwl_apply_gather(
        jnp.asarray(field.reshape(-1)), jnp.asarray(e8)[:, None], jnp.asarray(T),
        *(jnp.float32(v) for v in scal))))[None]
    acc0, acc1 = tph._pwl_prefix_acc(x, e8_t, T_t)
    fused = (x.double() * acc1.double() + (q0[:, None] + acc0).double()).float()
    fused = torch.where(x == zval[:, None], ztrg[:, None], fused)
    assert _equal(fused, ref)


def test_prefix_check_and_fallback():
    """The check fails for a shuffled row, a NaN edge and an infinite d0
    term, and a failing member takes the 15-term sum while the others keep
    the prefix tables."""
    field, _, e8, T, scal = _case((64, 128), 4)
    rng = np.random.default_rng(5)
    bad = [T.copy() for _ in range(3)]
    bad[0][7, :15] = rng.permutation(bad[0][7, :15])  # the tail: distinct edges
    bad[1][5, 9] = np.nan
    bad[2][1, 15 + 4] = np.inf
    T_all = torch.from_numpy(np.stack([T] + bad))
    assert tph._pwl_prefix_ok(T_all).tolist() == [True, False, False, False]
    assert not bool(tph._pwl_prefix_ok(torch.from_numpy(T)[None].neg()).any())  # descending
    x = torch.from_numpy(np.nan_to_num(field, nan=0.0).reshape(1, -1)).expand(4, -1)
    e8_t = torch.from_numpy(e8)[None].expand(4, -1)
    q0, zval, ztrg = (torch.full((4,), float(v)) for v in scal)
    out = tph._pwl_apply_prefix_plain(x, e8_t, T_all, q0, zval, ztrg)
    assert _equal(out, tph._pwl_apply_gather_plain(x, e8_t, T_all, q0, zval, ztrg))
    # the shuffled row's pixels would differ without the fallback
    acc0, acc1 = tph._pwl_prefix_acc(x[1:2], e8_t[1:2], T_all[1:2])
    naive = q0[1] + acc0 + x[1:2] * acc1
    naive = torch.where(x[1:2] == zval[1], ztrg[1], naive)
    assert not _equal(naive, out[1:2])


def _gather_acc(x, e8, T, select=False):
    """The two 15-term sums of K3 (``_pwl_apply_gather_plain``'s loop);
    with ``select`` each term is ``where(x >= e, d, 0)`` in place of
    ``d * float(x >= e)``."""
    idx = torch.zeros(x.shape, dtype=torch.long)
    for g in range(1, 8):
        idx += (x >= e8[:, g:g + 1]).long()

    def col(c):
        return torch.gather(T[:, :, c], 1, idx)

    acc0, acc1 = col(45), col(46)
    for j in range(15):
        on = x >= col(j)
        if select:
            acc0 = acc0 + torch.where(on, col(15 + j), 0.0)
            acc1 = acc1 + torch.where(on, col(30 + j), 0.0)
        else:
            acc0 = acc0 + col(15 + j) * on.to(torch.float32)
            acc1 = acc1 + col(30 + j) * on.to(torch.float32)
    return acc0, acc1


@pytest.mark.parametrize("N", [1, 3, 5, 4097, 8192])
def test_k3_shapes_and_failing_luts(N):
    """K3's map on one member with a sorted LUT and three whose LUT fails
    the check (a shuffled row, a NaN edge, an infinite d1 term), N odd and
    below 4, 4097 and 8192, with NaN and ``x == zval`` pixels: the prefix
    model (which takes the 15-term sum for the failing members, as the
    kernel does) and the wrapper equal K3's plain version, and JAX's kernel
    on its sums at N = 8192, 64 rows of 128 (at 32 or 96 rows JAX's tiles
    of 16 rows step 32 rows at a time and write nothing, ROADMAP §C)."""
    field, _, e8, T, scal = _case((64, 128), 6)
    rng = np.random.default_rng(7)
    bad = [T.copy() for _ in range(3)]
    bad[0][6, :15] = rng.permutation(bad[0][6, :15])
    bad[1][2, 11] = np.nan
    bad[2][3, 30 + 2] = -np.inf
    T_all = torch.from_numpy(np.stack([T] + bad))
    x = field.reshape(-1)[:N].copy()
    x[0] = scal[1]  # a dry pixel
    if N > 2:
        x[2] = np.nan
    x_all = torch.from_numpy(np.stack([x, x[::-1].copy(), x, x]))
    e8_t = torch.from_numpy(e8)[None].expand(4, -1).contiguous()
    q0, zval, ztrg = (torch.full((4,), float(v)) for v in scal)
    assert tph._pwl_prefix_ok(T_all).tolist() == [True, False, False, False]
    plain = tph._pwl_apply_gather_plain(x_all, e8_t, T_all, q0, zval, ztrg)
    assert _equal(tph._pwl_apply_prefix_plain(x_all, e8_t, T_all, q0, zval, ztrg), plain)
    assert _equal(tph.pwl_apply_gather(x_all, e8_t, T_all, q0, zval, ztrg), plain)
    assert float(plain[0, 0]) == float(scal[2])
    if N % 8192:
        return
    refs = []
    for b in range(4):
        args = (jnp.asarray(x_all[b].numpy()), jnp.asarray(e8)[:, None],
                jnp.asarray(T_all[b].numpy()), *(jnp.float32(v) for v in scal))
        refs.append(torch.from_numpy(np.array(jph.pwl_apply_gather(*args))))

    def fused(select):
        acc0, acc1 = _gather_acc(x_all, e8_t, T_all, select)
        out = (x_all.double() * acc1.double() + (q0[:, None] + acc0).double()).float()
        return torch.where(x_all == zval[:, None], ztrg[:, None], out)

    ieee = fused(False)
    assert all(_equal(ieee[b], refs[b]) for b in range(3))
    # The member with an infinite d1 term: in IEEE arithmetic (the card,
    # the plain versions) the term gives -inf * 0 = NaN where it is not
    # selected.  JAX's kernel gives what a select gives: XLA's CPU build
    # rewrites d * float(x >= e) into select(x >= e, d, 0), as its compiled
    # HLO shows (selects that carry the multiply's op name).  What the TPU
    # kernel gives is not known (ROADMAP §C).
    nan = torch.isnan(ieee[3]) & ~torch.isnan(x_all[3])
    assert bool(nan.any()) and not bool(torch.isnan(refs[3][nan]).any())
    assert _equal(ieee[3][~nan], refs[3][~nan])
    assert _equal(fused(True)[3], refs[3])
    hlo = jph.pwl_apply_gather.lower(*args).compile().as_text()
    assert any(" select(" in line and re.search(r'op_name="[^"]*/mul"', line)
               for line in hlo.splitlines())


def _k3_cover(N, x_off, o_off, pix=16384):
    """How ``pst_pwl_gather_kernel`` (``csrc/pwl.cu``) splits one member's
    N pixels over its blocks of ``pix``, the input and output rows starting
    ``x_off`` and ``o_off`` floats past a 16-byte boundary: per pixel, the
    times a block maps it; and the first pixel of every 16-byte vector."""
    count = np.zeros(N, np.int64)
    starts = []
    nbx = -(-N // pix)
    for bx in range(nbx):
        p0, p1 = bx * pix, min(bx * pix + pix, N)
        if (x_off - o_off) % 4:  # the member goes scalar
            count[p0:p1] += 1
            continue
        head = min((4 - x_off) % 4, N)
        nv = (N - head) // 4
        tail = head + 4 * nv
        if bx == 0:
            count[:head] += 1
        if bx == nbx - 1:
            count[tail:] += 1
        for v in range(p0 // 4, min(p1 // 4, nv)):
            count[head + 4 * v:head + 4 * v + 4] += 1
            starts.append(head + 4 * v)
    return count, np.array(starts, np.int64)


@pytest.mark.parametrize("N", [1, 3, 5, 16384, 16387, 2 * 16384 + 2, 3 * 16384 + 13])
def test_k3_blocks_cover_each_pixel_once(N):
    """Every pixel is mapped by exactly one block, once, for each offset of
    the input and output rows; vectors start on 16-byte boundaries of both
    (``data_ptr() % 16 != 0`` views go scalar where the two differ)."""
    for x_off in range(4):
        for o_off in range(4):
            count, starts = _k3_cover(N, x_off, o_off)
            assert (count == 1).all()
            if (x_off - o_off) % 4 == 0:
                assert ((starts + x_off) % 4 == 0).all()
                assert len(starts) == (N - min((4 - x_off) % 4, N)) // 4
            else:
                assert len(starts) == 0
