"""
Kernel K4, the bounded L1 distance rim of the incremental mask, with its
plain PyTorch version (counterpart of ``pysteps_tpu/ops/pallas_dilate.py``).

``compute_dilated_mask`` (reference: nowcasts/utils.py:69) is
``sum_i 1[d1(x) <= kr + i] / (r + 1)``: kr binary dilations followed by r
accumulating ones.  Written with the L1 distance d1 to the nearest wet
pixel it is ``rim = clip((kr + r + 1 - d1) / (r + 1), 0, 1)``; d1 is
separable (vertical, then horizontal min-plus over |k| <= kr + r).

Both entry points launch one kernel (``csrc/rim.cu``) that reads its input
as given: a float32 field (wet where ``>= thr``), or a mask (wet where
``> 0``) of float32, bool or uint8; a mask of another dtype is first
made bool.  For ``kr + r <= MAX_RIM`` that is one launch of the tile
kernel, which keeps each tile's window as wet bits in shared memory and
allocates nothing but the output; above it, the two-pass kernels with a
scratch plane.  Either way one call adds one to its launch counter.
"""

import ctypes

import torch

from pysteps_tpu_torch.ops import _kernels


def _shifted_min(x, R, dim, fill):
    """min over |k| <= R of x shifted by k along ``dim`` plus |k|, with
    ``fill`` outside the domain."""
    size = x.shape[dim]
    out = x.clone()
    for k in range(1, min(R, size - 1) + 1):
        pad = torch.full_like(x.narrow(dim, 0, k), fill)
        fwd = torch.cat([x.narrow(dim, k, size - k), pad], dim=dim)
        bwd = torch.cat([pad, x.narrow(dim, 0, size - k)], dim=dim)
        out = torch.minimum(out, torch.minimum(fwd, bwd) + float(k))
    return out


def _rim_plain(field, thr, kr, r):
    """Plain version of K4 on (B, m, n): separable bounded L1 distance."""
    R = int(kr) + int(r)
    big = float(R + 1)
    d = torch.where(field >= thr, 0.0, big)
    d = _shifted_min(d, R, 1, big)
    d = _shifted_min(d, R, 2, big)
    return torch.clamp((R + 1.0 - d) / (r + 1.0), 0.0, 1.0)


# the largest kr + r that the tile kernel takes (its distances are bytes)
MAX_RIM = 254


def rim_route(kr, r):
    """Which kernels a call with these radii launches: ``"tile"`` (one
    launch) or ``"two_pass"`` (two launches and a scratch plane)."""
    return "tile" if int(kr) + int(r) <= MAX_RIM else "two_pass"


def rim_info(B, m, n, kr, r, device=None):
    """The tile kernel's geometry for a (B, m, n) call on the card, worked
    out from its layout and the occupancy API, not measured: tile rows
    ``H`` and columns ``W``, ``smem_bytes`` of dynamic shared memory,
    ``blocks`` of the launch and ``blocks_per_sm``.  Needs the card and
    ``kr + r <= MAX_RIM``."""
    H, W, bps = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem, blocks = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(device or torch.device("cuda")):
        err = _kernels.library().pst_rim_info(
            int(B), int(m), int(n), int(kr), int(r), *(ctypes.byref(v) for v in (
                H, W, smem, blocks, bps)))
    if err != 0:
        raise RuntimeError(f"pst_rim_info: CUDA error {err}")
    return {"H": H.value, "W": W.value, "smem_bytes": smem.value,
            "blocks": blocks.value, "blocks_per_sm": bps.value}


def _rim(x, thr, strict, kr, r, counter):
    """Launch K4 on a contiguous (B, m, n) CUDA tensor ``x``: float32, or
    bool / uint8; wet where ``x > thr`` when ``strict``, else ``x >= thr``."""
    B, m, n = x.shape
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    scratch = torch.empty_like(out) if rim_route(kr, r) == "two_pass" else None
    _kernels.launch(
        "pst_rim", x.device, x.data_ptr(), int(x.dtype != torch.float32),
        float(thr), int(strict), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), B, m, n, int(kr), int(r),
    )
    _kernels.LAUNCHES[counter] += 1
    return out


def dilated_rim_from_field(field, thr, kr, r):
    """K4 (replaces ``dilated_rim_from_field_pallas``): the rim of
    ``field >= thr`` for a float32 (B, m, n) field; ``thr`` a Python float."""
    field = field.contiguous()
    if not field.is_cuda:
        return _rim_plain(field, float(thr), kr, r)
    _kernels.check_inputs("rim", (field,), (torch.float32,))
    return _rim(field, float(thr), False, kr, r, "rim_from_field")


def dilated_rim(mask, kr, r):
    """K4 (replaces ``dilated_rim_pallas``): the rim of a (B, m, n) mask,
    every positive value counting as wet."""
    if not mask.is_cuda:
        return _rim_plain((mask > 0).to(torch.float32), 0.5, kr, r)
    if mask.dtype not in (torch.float32, torch.bool, torch.uint8):
        mask = mask > 0
    return _rim(mask.contiguous(), 0.0, True, kr, r, "rim_from_mask")
