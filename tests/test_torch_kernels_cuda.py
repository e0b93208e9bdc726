"""Kernels K1-K4 of the PyTorch port on the card, against their plain
PyTorch versions on the same CUDA inputs, at small odd shapes that the
main path never gives them (grids that are not multiples of 8 or 32, one
pixel, a rim radius wider than the grid).  ``chip_smoke.py`` holds them at
the main path's shapes.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: 1e-5 x span for K1-K3 (one or two f32 lerps, or the same
sum in the same order), 1e-6 for K4 (small integers held in floats).
"""

import numpy as np
import pytest
import torch

from pysteps_tpu_torch.ops import _kernels, pallas_dilate, pallas_histmatch, pallas_warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(out, ref, tol):
    torch.cuda.synchronize()
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.shape == ref.shape
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    err = float(np.nanmax(np.abs(np.nan_to_num(out) - np.nan_to_num(ref)), initial=0.0))
    assert err <= tol, (err, tol)


def _disp(gen, dev, B, m, n, amp):
    """Smooth (B, 2, m, n) displacements of about +-amp pixels."""
    yy = torch.linspace(0, 3, m, device=dev)[:, None]
    xx = torch.linspace(0, 2, n, device=dev)[None, :]
    a = torch.rand((B, 2, 1, 1), generator=gen, device=dev) + 0.5
    return amp * torch.stack(
        [a[:, 0] * torch.sin(xx + yy) + 0.1, -a[:, 1] * torch.cos(0.7 * xx - yy)], dim=1
    )


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("D", [5, 13])
def test_k1_resample(dev, axis, rep, D):
    """|disp| reaches 20 > D: pins the clip to [p - D, p + D], then the
    edges; ``rep`` fields share one index plane."""
    gen = torch.Generator(device=dev).manual_seed(axis + 10 * rep + D)
    B, m, n = 3, 37, 53
    field = torch.randn((B * rep, m, n), generator=gen, device=dev)
    pos = torch.arange((m, n)[axis], device=dev, dtype=torch.float32)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    c = pos + _disp(gen, dev, B, m, n, 20.0)[:, 1 - axis]
    idx0 = torch.floor(c).to(torch.int32).contiguous()
    frac = (c - torch.floor(c)).contiguous()
    before = _kernels.LAUNCHES[f"resample_axis{axis}"]
    out = pallas_warp.axis_resample(field, idx0, frac, D, axis)
    assert _kernels.LAUNCHES[f"resample_axis{axis}"] == before + 1
    ref = pallas_warp._axis_resample(field, idx0, frac, D, axis)
    _close(out, ref, 1e-5 * float(field.max() - field.min()))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("D", [13, 48])
def test_k2_warp(dev, masked, D):
    """D = 13 is rounded up to 16 by the wrapper; the grid is no multiple
    of 8."""
    gen = torch.Generator(device=dev).manual_seed(D + masked)
    B, m, n = 2, 37, 53
    field = torch.randn((B, m, n), generator=gen, device=dev) * 5.0 + 10.0
    disp = _disp(gen, dev, B, m, n, 20.0)
    dy = disp[:, 1].contiguous()
    disp_t = disp.transpose(-1, -2).contiguous()
    before = _kernels.LAUNCHES["warp"]
    out = pallas_warp.warp_fused(field, dy, disp_t, D, float("nan"), masked)
    assert _kernels.LAUNCHES["warp"] == before + 1
    ref = pallas_warp._warp_fused_plain(field, dy, disp_t, -(-D // 8) * 8, float("nan"), masked)
    assert masked == bool(torch.isnan(ref).any())
    _close(out, ref, 1e-5 * float(field.max() - field.min()))


@pytest.mark.parametrize("N", [1, 1000, 40 * 128])
def test_k3_pwl_gather(dev, N):
    """Any pixel count works: no row tiling, no rows % 32 trap."""
    gen = torch.Generator(device=dev).manual_seed(N)
    B = 3
    target = torch.randn(max(N, 256), generator=gen, device=dev) * 4.0
    target = torch.where(target > -1.0, target, -1.0)
    ranked = torch.sort(target).values
    tstate = pallas_histmatch.prepare_target(ranked, ranked[0])
    x = torch.randn((B, max(N, 256)), generator=gen, device=dev) * 3.0
    x = torch.where(x > -2.0, x, -2.0)
    edges, d0, d1, q0, zval, ztrg = pallas_histmatch.build_pwl_coeffs(x, tstate)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    x = x[:, :N].contiguous()
    ztrg = ztrg.expand(B)
    before = _kernels.LAUNCHES["pwl_gather"]
    out = pallas_histmatch.pwl_apply_gather(x, e8, T, q0, zval, ztrg)
    assert _kernels.LAUNCHES["pwl_gather"] == before + 1
    ref = pallas_histmatch._pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    _close(out, ref, 1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("kr,r", [(1, 1), (2, 10), (3, 6)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 9, 10)])
def test_k4_rim(dev, kr, r, shape):
    """Both entry points; (9, 10) is narrower than the rim radius."""
    gen = torch.Generator(device=dev).manual_seed(kr * 10 + r)
    field = torch.rand(shape, generator=gen, device=dev)
    before = dict(_kernels.LAUNCHES)
    out = pallas_dilate.dilated_rim_from_field(field, 0.9, kr, r)
    _close(out, pallas_dilate._rim_plain(field, 0.9, kr, r), 1e-6)
    mask = (field >= 0.9).to(torch.float32)
    out_m = pallas_dilate.dilated_rim(mask, kr, r)
    _close(out_m, pallas_dilate._rim_plain(mask, 0.5, kr, r), 1e-6)
    _close(out_m, out, 1e-6)
    assert _kernels.LAUNCHES["rim_from_field"] == before["rim_from_field"] + 1
    assert _kernels.LAUNCHES["rim_from_mask"] == before["rim_from_mask"] + 1


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    f = torch.zeros((2, 16, 16), device=dev)
    idx = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pallas_warp.axis_resample(f, idx.float(), f, 4, 0)
    with pytest.raises(ValueError):
        pallas_warp.axis_resample(f.transpose(1, 2), idx, f, 4, 0)
    with pytest.raises(ValueError):
        pallas_warp.warp_fused(f, f, f, 8, 0.0)
    with pytest.raises(ValueError):
        pallas_dilate.dilated_rim_from_field(f.double(), 0.5, 1, 1)
