"""
Kernels K1 (axis resample) and K2 (separable bilinear warp) with their
plain PyTorch versions — the counterparts of the Pallas kernels in
``pysteps_tpu/ops/pallas_warp.py``.

Each wrapper launches its CUDA kernel (``csrc/resample.cu``,
``csrc/warp.cu``) for a CUDA tensor and runs the plain version for a CPU
tensor; there is no other fallback.  Fields carry a leading batch axis
(members, or members x channels) so one launch serves the ensemble.

K2 is one launch of a tile kernel that keeps the vertical stage in shared
memory (:func:`warp_geometry` sizes its tiles); a shape whose tile cannot
hold in a block's shared memory takes the two-pass kernels through a
scratch plane (:func:`warp_route`).
"""

import ctypes

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


def _axis_resample_launch(field, idx0, frac, D, axis):
    """K1 on checked CUDA inputs."""
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


def _axis_resample_grads(grad, field, idx0, frac, D, axis, need_field, need_frac):
    """The gradients of K1's function (:func:`_axis_resample`) for the
    output's gradient ``grad``: with k the index clipped to [p - D, p + D]
    and its two taps k0 = k and k1 = k + 1 clamped to the edges (both the
    same index beyond an edge),
    d field[k0] += grad (1 - frac), d field[k1] += grad frac, and d frac =
    grad (field[k1] - field[k0]), summed over the fields that share a
    plane.  Gathers and ``scatter_add_``: the JAX package's kernel has no
    backward of its own (its gradient is XLA's autodiff)."""
    Bi = idx0.shape[0]
    rep = field.shape[0] // Bi
    dim = 1 + axis
    size = field.shape[dim]
    pos = torch.arange(size, device=field.device, dtype=idx0.dtype)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    k = torch.clamp(idx0, pos - D, pos + D).long()
    k0, k1 = torch.clamp(k, 0, size - 1), torch.clamp(k + 1, 0, size - 1)
    if rep > 1:
        k0, k1 = k0.repeat_interleave(rep, dim=0), k1.repeat_interleave(rep, dim=0)
        frac = frac.repeat_interleave(rep, dim=0)
    grad_field = grad_frac = None
    if need_frac:
        diff = torch.gather(field, dim, k1) - torch.gather(field, dim, k0)
        grad_frac = (grad * diff).reshape((Bi, rep) + tuple(grad.shape[1:])).sum(dim=1)
    if need_field:
        grad_field = torch.zeros_like(field)
        grad_field.scatter_add_(dim, k0, grad * (1.0 - frac))
        grad_field.scatter_add_(dim, k1, grad * frac)
    return grad_field, grad_frac


class AxisResample(torch.autograd.Function):
    """K1 under autograd: the forward is kernel K1 for CUDA tensors and
    its plain version for CPU tensors, the backward
    :func:`_axis_resample_grads` (PyTorch operators on either device)."""

    @staticmethod
    def forward(ctx, field, idx0, frac, D, axis):
        ctx.save_for_backward(field, idx0, frac)
        ctx.D, ctx.axis = int(D), int(axis)
        if field.is_cuda:
            return _axis_resample_launch(field, idx0, frac, D, axis)
        return _axis_resample(field, idx0, frac, D, axis)

    @staticmethod
    def backward(ctx, grad):
        field, idx0, frac = ctx.saved_tensors
        grad_field, grad_frac = _axis_resample_grads(
            grad.contiguous(), field, idx0, frac, ctx.D, ctx.axis,
            ctx.needs_input_grad[0], ctx.needs_input_grad[2])
        return grad_field, None, grad_frac, None, None


def axis_resample(field, idx0, frac, D, axis):
    """K1 (replaces ``axis_resample_pallas`` / ``pallas_resample0``): see
    :func:`_axis_resample` for the function it computes.  Where ``field``
    or ``frac`` requires grad, it runs through :class:`AxisResample`."""
    if torch.is_grad_enabled() and (field.requires_grad or frac.requires_grad):
        return AxisResample.apply(field, idx0, frac, D, axis)
    if not field.is_cuda:
        return _axis_resample(field, idx0, frac, D, axis)
    return _axis_resample_launch(field, idx0, frac, D, axis)


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


WARP_TH = (16, 8, 4, 2, 1)  # tile rows, largest first
WARP_CH = 64  # WP_CH of csrc/warp.cu: output columns of a horizontal step
WARP_TW = 256  # output columns of a column tile
WARP_STRIP_BYTES = 64 * 1024  # a strip's shared memory, at most: 3 blocks an SM


def _warp_smem(th, cols):
    """The tile kernel's shared memory: ``th`` rows of ``cols`` floats of
    the vertical stage, then two buffers of the two transposed planes,
    WARP_CH rows of th + 1 floats each (``pst_warp`` refuses less)."""
    return th * cols * 4 + 2 * 2 * WARP_CH * (th + 1) * 4


def warp_tile(B, m, n, D, th, tw):
    """The tile kernel's geometry at ``th`` rows by ``tw`` output columns
    for a (B, m, n) call with bound ``D`` (rounded up to a multiple of 8
    here): ``cols`` of the vertical stage a block holds (the tile and the
    D columns a tap reaches on each side, clipped to the field),
    ``smem_bytes`` and ``blocks``.  ``pst_warp`` launches what this gives
    and refuses a geometry that does not hold the tile."""
    D = _round8(D)
    tw = min(n, tw)
    cols = n if tw >= n else min(n, tw + 2 * min(D, n) + 1)
    return {"route": "tile", "th": th, "tw": tw, "cols": cols,
            "smem_bytes": _warp_smem(th, cols), "blocks": B * -(-m // th) * -(-n // tw)}


def warp_geometry(B, m, n, D, sms=_kernels.H100_SMS):
    """K2's tile geometry for a (B, m, n) call with displacement bound
    ``D``, computed, not measured: ``th`` tile rows, the largest of
    :data:`WARP_TH` that still gives 2 blocks an SM of a card with ``sms``
    SMs (else the smallest that fits); ``tw`` output columns, the whole row
    when th rows of n columns fit :data:`WARP_STRIP_BYTES`, else
    :data:`WARP_TW`; the rest as :func:`warp_tile` gives it.  A tile must
    fit ``_kernels.SMEM_LIMIT``; where none does, the route is
    ``"two_pass"`` and the other keys are None."""
    best = None
    for th in WARP_TH:
        tw = n if _warp_smem(th, n) <= WARP_STRIP_BYTES else WARP_TW
        geometry = warp_tile(B, m, n, D, th, tw)
        if geometry["smem_bytes"] > _kernels.SMEM_LIMIT:
            continue
        best = geometry
        if geometry["blocks"] >= 2 * sms:
            break
    return best or {"route": "two_pass", "th": None, "tw": None, "cols": None,
                    "smem_bytes": None, "blocks": None}


def warp_route(m, n, D):
    """Which kernels K2 launches for an (m, n) field and bound ``D``:
    ``"tile"`` (one launch, no scratch) or ``"two_pass"`` (two launches
    through a scratch plane), for any batch."""
    return warp_geometry(1, m, n, D)["route"]


def warp_info(geometry, device=None):
    """The blocks of the tile kernel that fit on one SM of the card at
    ``geometry``'s shared memory (the occupancy API; computed, not
    measured)."""
    bps = ctypes.c_int()
    with torch.cuda.device(device or torch.device("cuda")):
        err = _kernels.library().pst_warp_info(
            int(geometry["smem_bytes"]), ctypes.byref(bps))
    if err != 0:
        raise RuntimeError(f"pst_warp_info: CUDA error {err}")
    return {"blocks_per_sm": bps.value}


def _warp_launch(field, dy, disp_t, D, cval, masked, geometry):
    """Launch K2 on checked CUDA inputs (D rounded) at ``geometry`` (from
    :func:`warp_geometry` or :func:`warp_tile`): the tile kernel, or the
    two-pass kernels and their scratch plane."""
    B, m, n = field.shape
    out = torch.empty_like(field)
    tile = geometry["route"] == "tile"
    scratch = None if tile else torch.empty_like(field)
    _kernels.launch(
        "pst_warp", field.device, field.data_ptr(), dy.data_ptr(),
        disp_t.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), B, m, n, D, float(cval), int(bool(masked)),
        *((geometry["th"], geometry["tw"], geometry["cols"], geometry["smem_bytes"])
          if tile else (0, 0, 0, 0)),
    )
    _kernels.LAUNCHES["warp"] += 1
    return out


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
    geometry = warp_geometry(B, m, n, D, _kernels.sm_count(field.device))
    return _warp_launch(field, dy, disp_t, D, cval, masked, geometry)
