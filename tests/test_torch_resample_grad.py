"""K1 under autograd (``pysteps_tpu_torch/ops/pallas_warp.py::AxisResample``)
on the CPU: its forward is the plain K1, its backward the gathers and
``scatter_add_`` of ``_axis_resample_grads``.

Inputs: numpy-seeded fields (B, m, n) and smooth displacements whose
largest part passes the bound D (clipped taps) and whose sources leave
the field (edge clamps: both taps on one index), with B // Bi of 1 and
3 fields sharing an index plane.  Tolerances: the gradients equal
autograd of the plain ``_axis_resample`` within 1e-6 relative (of the
largest component), and ``jax.grad`` of the JAX package's
``_axis_resample`` (``pysteps_tpu/ops/warp.py``) within 1e-5 relative;
the VET cost's gradient through the shift warp (the card's branch of
``motion/vet.py``) equals the plain autograd's within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysteps_tpu.ops import warp as jwarp
from pysteps_tpu_torch.motion import vet as tvet
from pysteps_tpu_torch.ops import pallas_warp as tpw
from pysteps_tpu_torch.ops import warp as twarp

CASES = [(axis, rep, D) for axis in (0, 1) for rep in (1, 3) for D in (3, 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch calls: the tier-1 run
    shares the machine's cores among its workers, and a pool of one thread
    a core in each worker oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(axis, rep, D, m=24, n=20, Bi=2, seed=0):
    rng = np.random.default_rng(seed + 10 * axis + rep + 100 * D)
    field = rng.normal(0.0, 3.0, (Bi * rep, m, n)).astype(np.float32)
    size = m if axis == 0 else n
    pos = np.arange(size, dtype=np.float32)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    yy, xx = np.meshgrid(np.linspace(0, 2, m), np.linspace(0, 3, n), indexing="ij")
    # up to +-7 px, past D = 3, with the sources beyond both edges
    disp = np.stack([7.0 * np.sin(xx + yy + b) for b in range(Bi)]).astype(np.float32)
    c = pos + disp
    idx0 = np.floor(c).astype(np.int32)
    frac = (c - np.floor(c)).astype(np.float32)
    cot = rng.normal(size=field.shape).astype(np.float32)
    return field, idx0, frac, cot


def _torch_grads(fn, field, idx0, frac, cot, D, axis):
    f = torch.tensor(field, requires_grad=True)
    w = torch.tensor(frac, requires_grad=True)
    out = fn(f, torch.tensor(idx0), w, D, axis)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), f.grad.numpy(), w.grad.numpy()


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("axis,rep,D", CASES)
def test_axis_resample_grads_equal_plain_autograd(axis, rep, D):
    field, idx0, frac, cot = _inputs(axis, rep, D)
    out, gf, gw = _torch_grads(tpw.axis_resample, field, idx0, frac, cot, D, axis)
    pout, pgf, pgw = _torch_grads(tpw._axis_resample, field, idx0, frac, cot, D, axis)
    np.testing.assert_array_equal(out, pout)
    assert _rel(gf, pgf) <= 1e-6
    assert _rel(gw, pgw) <= 1e-6


@pytest.mark.parametrize("axis,rep,D", CASES)
def test_axis_resample_grads_equal_jax_grad(axis, rep, D):
    """JAX's ``_axis_resample`` takes one (m, n) field: the fields that
    share a plane map over it, and jax.grad sums their frac gradients."""
    field, idx0, frac, cot = _inputs(axis, rep, D)
    _, gf, gw = _torch_grads(tpw.axis_resample, field, idx0, frac, cot, D, axis)
    Bi = idx0.shape[0]

    def loss(f, w):
        total = 0.0
        for b in range(f.shape[0]):
            p = b // rep
            total = total + jnp.sum(
                jwarp._axis_resample(f[b], jnp.asarray(idx0[p]), w[p], D, axis) * cot[b])
        return total

    jgf, jgw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(field), jnp.asarray(frac))
    assert np.asarray(jgw).shape == (Bi,) + field.shape[1:]
    assert _rel(gf, np.asarray(jgf)) <= 1e-5
    assert _rel(gw, np.asarray(jgw)) <= 1e-5


def test_edge_taps_collapse_onto_one_index():
    """A source beyond the last row: both taps clamp to it and the field's
    gradient there is the whole cotangent."""
    field = np.arange(12, dtype=np.float32).reshape(1, 4, 3)
    idx0 = np.full((1, 4, 3), 7, np.int32)
    frac = np.full((1, 4, 3), 0.25, np.float32)
    cot = np.ones((1, 4, 3), np.float32)
    _, gf, gw = _torch_grads(tpw.axis_resample, field, idx0, frac, cot, 9, 0)
    np.testing.assert_array_equal(gf[0, -1], [4.0, 4.0, 4.0])
    assert np.all(gf[0, :-1] == 0) and np.all(gw == 0)


def test_axis_resample_takes_autograd_only_when_asked():
    field, idx0, frac, _ = _inputs(0, 1, 3)
    plain = tpw.axis_resample(torch.tensor(field), torch.tensor(idx0), torch.tensor(frac), 3, 0)
    assert plain.grad_fn is None
    w = torch.tensor(frac, requires_grad=True)
    out = tpw.axis_resample(torch.tensor(field), torch.tensor(idx0), w, 3, 0)
    assert type(out.grad_fn).__name__ == "AxisResampleBackward"
    with torch.no_grad():
        assert tpw.axis_resample(torch.tensor(field), torch.tensor(idx0), w, 3, 0).grad_fn is None


def test_vet_shift_cost_gradient_through_k1_equals_plain(monkeypatch):
    """The VET cost of the card's branch (the recentred shift warp of two
    pairs that share one flow) and its gradient, through AxisResample and
    through autograd of the plain version."""
    rng = np.random.default_rng(5)
    m = n = 48
    templates = torch.tensor(rng.normal(10.0, 4.0, (2, m, n)).astype(np.float32))
    targets = torch.tensor(rng.normal(10.0, 4.0, (2, m, n)).astype(np.float32))
    args = (templates, targets, torch.zeros((m, n), dtype=torch.bool), 1e3, (4, 4),
            tvet._interp_matrices(m, n, 4, 4, "cpu"))
    x = torch.tensor(rng.normal(1.0, 2.0, 32).astype(np.float32))
    val, grad = tvet._make_cost(*args, max_disp=8, center_shift=(1, 2))(x)
    monkeypatch.setattr(twarp, "axis_resample", tpw._axis_resample)
    pval, pgrad = tvet._make_cost(*args, max_disp=8, center_shift=(1, 2))(x)
    assert abs(float(val - pval)) <= 1e-6 * abs(float(pval))
    assert _rel(grad.numpy(), pgrad.numpy()) <= 1e-5
