"""The motion solvers, K1 under autograd and the port's convolutions on
the card, against the same functions on the CPU.

- ``AxisResample`` (K1 forward, gathers and ``scatter_add_`` backward) on
  CUDA tensors: its output equals the plain version's within 1e-5 of the
  field's span, and its gradients the plain autograd's on the card within
  1e-5 relative (of the largest component);
- the port's stencils (``ops/conv.py``, ``timeseries/correlation.py::
  _sep_conv2d``) within 1e-5 of float64 on the CPU, relative to the
  largest output (IEEE float32, not TF32);
- each motion method at 256^2 (the synthetic sequence of
  ``tests/helpers.py``, velocity (2, 1), seed 42) on the card against a
  CPU run of the port through the card's branch (the shift warp with the
  card's bounds, plain K1): within 0.05 px at every pixel and 1e-3 px
  RMS (a few low-texture pixels of Farneback's floored 2 x 2 solve
  amplify the stencils' rounding), VET's flow within 0.1 x |v| RMS (its
  Adam loop amplifies rounding), with the K1
  launches the card's branch makes and the truth bound of
  ``tests/test_motion.py``.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_motion_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu_torch import motion  # noqa: E402
from pysteps_tpu_torch.motion import farneback, proesmans  # noqa: E402
from pysteps_tpu_torch.ops import _kernels, conv, pallas_warp  # noqa: E402
from pysteps_tpu_torch.timeseries.correlation import _gaussian_kernel1d, _sep_conv2d  # noqa: E402

pytestmark = pytest.mark.cuda

SIDE = 256
SPEED = float(np.hypot(2.0, 1.0))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _frames(n_frames):
    f = make_synthetic_sequence(n_frames=n_frames, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                seed=42)
    return (10.0 * np.log10(np.maximum(f, 0.1))).astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rep", [1, 2])
def test_axis_resample_autograd_on_card(dev, axis, rep):
    gen = torch.Generator(device=dev).manual_seed(axis + 2 * rep)
    B, m, n, D = 4 * rep, 96, 128, 6
    field = torch.randn((B, m, n), generator=gen, device=dev)
    pos = torch.arange(m if axis == 0 else n, device=dev, dtype=torch.float32)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    c = pos + 9.0 * torch.randn((4, m, n), generator=gen, device=dev)
    idx0 = torch.floor(c).to(torch.int32).contiguous()
    cot = torch.randn((B, m, n), generator=gen, device=dev)
    grads = []
    for fn in (pallas_warp.axis_resample, pallas_warp._axis_resample):
        f = field.clone().requires_grad_(True)
        w = (c - torch.floor(c)).contiguous().requires_grad_(True)
        _kernels.reset_launches()
        out = fn(f, idx0, w, D, axis)
        (out * cot).sum().backward()
        grads.append((out.detach(), f.grad, w.grad, _kernels.LAUNCHES[f"resample_axis{axis}"]))
    (out, gf, gw, launches), (pout, pgf, pgw, plain_launches) = grads
    assert launches == 1 and plain_launches == 0
    span = float(field.max() - field.min())
    assert float((out - pout).abs().max()) <= 1e-5 * span
    assert float((gf - pgf).abs().max()) <= 1e-5 * float(pgf.abs().max())
    assert float((gw - pgw).abs().max()) <= 1e-5 * float(pgw.abs().max())


def test_convolutions_are_ieee_float32(dev):
    field = torch.as_tensor(_frames(1)[0], device=dev)
    k30 = _gaussian_kernel1d(30.0, dev)
    gw = farneback._gauss_kernel(16, 8.0, dev)
    lap = torch.tensor(proesmans._LAP, dtype=torch.float32, device=dev)
    for fn, k in ((_sep_conv2d, k30), (lambda f, k: conv.sep_corr(f, k, k), gw),
                  (conv.corr_same, lap)):
        ref = fn(field.cpu().double(), k.cpu().double())
        out = fn(field, k).cpu().double()
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _cpu_branch(method, frames):
    x = torch.as_tensor(frames)
    if method == "proesmans":
        return proesmans._proesmans_full(x[-2], x[-1], 50.0, 6, 100, 0.0, True, False)
    if method == "farneback":
        return farneback._farneback_full(x[-2], x[-1], 4, 5, 7, 1.5, 32, True)
    kw = {"max_disp": "shift", "verbose": False} if method == "vet" else {}
    return motion.get_method(method)(x, device="cpu", **kw)


# (method, frames, truth bound, K1 launches an axis at 256^2)
CASES = [
    ("lk", 3, 0.1, 0),
    ("vet", 3, 0.1, 500),
    ("proesmans", 2, 0.1, 2 * 100 * 6),  # 256 down to 8: 6 levels
    ("darts", 9, 0.6, 0),
    ("farneback", 3, 0.1, 5 * 4),  # 256 down to 32: 4 levels
]


@pytest.mark.parametrize("method,n_frames,bound,k1", CASES, ids=[c[0] for c in CASES])
def test_motion_on_card_against_cpu(dev, method, n_frames, bound, k1):
    frames = _frames(n_frames)
    kw = {"verbose": False} if method in ("vet", "darts") else {}
    _kernels.reset_launches()
    flow = motion.get_method(method)(torch.as_tensor(frames, device=dev), **kw)
    torch.cuda.synchronize()
    assert flow.is_cuda and tuple(flow.shape) == (2, SIDE, SIDE)
    assert _kernels.LAUNCHES["resample_axis0"] == _kernels.LAUNCHES["resample_axis1"] == k1
    card = flow.cpu().double()
    u, v = card[0, 20:-20, 20:-20], card[1, 20:-20, 20:-20]
    assert float(torch.sqrt(torch.mean((u - 2) ** 2 + (v - 1) ** 2))) / SPEED < bound
    cpu = _cpu_branch(method, frames).double()
    if method == "vet":
        assert float(torch.sqrt(torch.mean((card - cpu) ** 2))) <= 0.1 * SPEED
    else:
        assert float((card - cpu).abs().max()) <= 0.05
        assert float(torch.sqrt(torch.mean((card - cpu) ** 2))) <= 1e-3


def test_numpy_frames_go_to_the_card(dev):
    frames = _frames(2)
    assert motion.get_method("farneback")(frames).is_cuda
    assert motion.get_method(None)(frames).is_cuda
