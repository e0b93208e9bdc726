"""
Kernel K4, the bounded L1 distance rim of the incremental mask, with its
plain PyTorch version (counterpart of ``pysteps_tpu/ops/pallas_dilate.py``).

``compute_dilated_mask`` (reference: nowcasts/utils.py:69) is
``sum_i 1[d1(x) <= kr + i] / (r + 1)``: kr binary dilations followed by r
accumulating ones.  Written with the L1 distance d1 to the nearest wet
pixel it is ``rim = clip((kr + r + 1 - d1) / (r + 1), 0, 1)``; d1 is
separable (vertical, then horizontal min-plus over |k| <= kr + r).
Both entry points launch the same kernel (``csrc/rim.cu``); the mask entry
point feeds a 0/1 field with threshold 0.5.
"""

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


def _rim(field, thr, kr, r, counter):
    if not field.is_cuda:
        return _rim_plain(field, thr, kr, r)
    B, m, n = field.shape
    _kernels.check_inputs("rim", (field,), (torch.float32,))
    scratch = torch.empty_like(field)
    out = torch.empty_like(field)
    _kernels.launch(
        "pst_rim", field.device, field.data_ptr(), float(thr),
        scratch.data_ptr(), out.data_ptr(), B, m, n, int(kr), int(r),
    )
    _kernels.LAUNCHES[counter] += 1
    return out


def dilated_rim_from_field(field, thr, kr, r):
    """K4 (replaces ``dilated_rim_from_field_pallas``): the rim of
    ``field >= thr`` for a (B, m, n) field; ``thr`` a Python float."""
    return _rim(field.contiguous(), float(thr), kr, r, "rim_from_field")


def dilated_rim(mask, kr, r):
    """K4 (replaces ``dilated_rim_pallas``): the rim of a (B, m, n) mask,
    every positive value counting as wet (fed to K4 as 0/1 with
    threshold 0.5)."""
    return _rim((mask > 0).to(torch.float32), 0.5, kr, r, "rim_from_mask")
