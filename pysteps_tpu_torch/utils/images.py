"""Morphological opening (counterpart of ``pysteps_tpu/utils/images.py``):
erosion then dilation of the thresholded image as min- and max-pooling."""

import torch

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.ops.conv import pool_same
from pysteps_tpu_torch.utils.arrays import _nanmin


def _morph_opening_core(field, thr, n):
    """Opening of one (m, n) field binarized at ``thr`` with an n x n
    window; pixels the opening removes take the field's minimum."""
    binary = (field > thr).to(torch.float32)
    opened = pool_same(pool_same(binary, n, "min"), n, "max")
    return torch.where((binary - opened) > 0, _nanmin(field), field)


def morph_opening(input_image, thr, n, device=None):
    """Remove features smaller than an n-pixel structuring element: the
    image is binarized at ``thr`` and pixels removed by the opening are
    set to the image minimum."""
    field = as_device_tensor(input_image, device, torch.float32)
    return _morph_opening_core(field, float(thr), int(n))


def morph_opening_batch(fields, thrs, n, device=None):
    """Opening of a (T, m, n) stack with one threshold a frame."""
    fields = as_device_tensor(fields, device, torch.float32)
    thrs = torch.as_tensor(thrs, dtype=torch.float32, device=fields.device).reshape(-1)
    return torch.stack([_morph_opening_core(f, t, int(n)) for f, t in zip(fields, thrs)])
