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
