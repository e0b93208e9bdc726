"""
Kernels K1 (axis resample) and K2 (separable bilinear warp) with their
plain PyTorch versions — the counterparts of the Pallas kernels in
``pysteps_tpu/ops/pallas_warp.py``.

Each wrapper launches its CUDA kernel (``csrc/resample.cu``,
``csrc/warp.cu``) for a CUDA tensor and runs the plain version for a CPU
tensor; there is no other fallback.  Fields carry a leading batch axis
(members, or members x channels) so one launch serves the ensemble.
"""

import torch

from pysteps_tpu_torch.ops import _kernels


def _gather_lerp(field, k, frac, dim):
    """lerp(field[k], field[k + 1]) along ``dim`` of a (B, m, n) field with
    edge clamping (``k`` already clipped to the displacement bound)."""
    size = field.shape[dim]
    k0 = torch.clamp(k, 0, size - 1).long()
    k1 = torch.clamp(k + 1, 0, size - 1).long()
    a = torch.gather(field, dim, k0)
    c = torch.gather(field, dim, k1)
    return a * (1.0 - frac) + c * frac


def _axis_resample(field, idx0, frac, D, axis):
    """Plain version of K1.  ``field`` (B, m, n); ``idx0`` (int32) and
    ``frac`` (Bi, m, n) with B a multiple of Bi, field b using plane
    b // (B // Bi).  Along ``axis``, idx0 is clipped to [p - D, p + D] and
    then to the edges: out = lerp(field[idx0], field[idx0 + 1], frac)."""
    rep = field.shape[0] // idx0.shape[0]
    if rep > 1:
        idx0 = idx0.repeat_interleave(rep, dim=0)
        frac = frac.repeat_interleave(rep, dim=0)
    size = field.shape[1 + axis]
    pos = torch.arange(size, device=field.device, dtype=idx0.dtype)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    k = torch.clamp(idx0, pos - D, pos + D)
    return _gather_lerp(field, k, frac, 1 + axis)


def axis_resample(field, idx0, frac, D, axis):
    """K1 (replaces ``axis_resample_pallas`` / ``pallas_resample0``): see
    :func:`_axis_resample` for the function it computes."""
    if not field.is_cuda:
        return _axis_resample(field, idx0, frac, D, axis)
    B, m, n = field.shape
    if idx0.shape[1:] != (m, n) or frac.shape != idx0.shape:
        raise ValueError("axis_resample: idx0/frac must be (Bi, m, n)")
    if B % idx0.shape[0] != 0:
        raise ValueError("axis_resample: field batch must be a multiple of idx0's")
    _kernels.check_inputs(
        "axis_resample", (field, idx0, frac),
        (torch.float32, torch.int32, torch.float32),
    )
    out = torch.empty_like(field)
    _kernels.launch(
        "pst_resample", field.device, field.data_ptr(), idx0.data_ptr(),
        frac.data_ptr(), out.data_ptr(), B, B // idx0.shape[0], m, n,
        int(D), int(axis),
    )
    _kernels.LAUNCHES[f"resample_axis{int(axis)}"] += 1
    return out


def _round8(D):
    return int(-(-int(D) // 8) * 8)


def _warp_v_plain(field, dy, D):
    """Vertical stage of K2: lerp along rows at ``i + dy`` (D already
    rounded up to a multiple of 8)."""
    rows = torch.arange(field.shape[1], device=field.device, dtype=torch.int32)[:, None]
    cy = rows.float() + dy
    y0 = torch.floor(cy)
    k = torch.clamp(y0.int(), rows - D, rows + D)
    return _gather_lerp(field, k, cy - y0, 1)


def _warp_h_plain(C, disp_t, D, cval, masked=True):
    """Horizontal stage of K2 on the vertically resampled ``C``, with the
    out-of-domain fill read from the transposed planes ``disp_t``."""
    B, m, n = C.shape
    dev = C.device
    rows = torch.arange(m, device=dev, dtype=torch.int32)[:, None]
    cols = torch.arange(n, device=dev, dtype=torch.int32)[None, :]
    dxt = disp_t[:, 0].transpose(1, 2)  # (B, m, n) view of the (n, m) plane
    cx = cols.float() + dxt
    x0 = torch.floor(cx)
    k = torch.clamp(x0.int(), cols - D, cols + D)
    out = _gather_lerp(C, k, cx - x0, 2)
    if masked:
        cyt = rows.float() + disp_t[:, 1].transpose(1, 2)
        inside = (cyt >= 0) & (cyt <= m - 1) & (cx >= 0) & (cx <= n - 1)
        out = torch.where(inside, out, float(cval))
    return out


def _warp_fused_plain(field, dy, disp_t, D, cval, masked=True):
    """Plain version of K2 (D already rounded up to a multiple of 8)."""
    return _warp_h_plain(_warp_v_plain(field, dy, D), disp_t, D, cval, masked)


def warp_fused(field, dy, disp_t, D, cval, masked=True):
    """K2 (replaces ``warp_fused_pallas``): separable bilinear backward
    warp of ``field`` (B, m, n) by the vertical displacement ``dy``
    (B, m, n) and the transposed (dx, dy) planes ``disp_t`` (B, 2, n, m).
    The displacement is clipped to D rounded up to a multiple of 8; with
    ``masked``, pixels whose source lies outside the domain get ``cval``."""
    D = _round8(D)
    if not field.is_cuda:
        return _warp_fused_plain(field, dy, disp_t, D, cval, masked)
    B, m, n = field.shape
    if dy.shape != field.shape or disp_t.shape != (B, 2, n, m):
        raise ValueError("warp_fused: dy must be (B, m, n), disp_t (B, 2, n, m)")
    _kernels.check_inputs(
        "warp_fused", (field, dy, disp_t), (torch.float32,) * 3
    )
    scratch = torch.empty_like(field)
    out = torch.empty_like(field)
    _kernels.launch(
        "pst_warp", field.device, field.data_ptr(), dy.data_ptr(),
        disp_t.data_ptr(), scratch.data_ptr(), out.data_ptr(), B, m, n, D,
        float(cval), int(bool(masked)),
    )
    _kernels.LAUNCHES["warp"] += 1
    return out
