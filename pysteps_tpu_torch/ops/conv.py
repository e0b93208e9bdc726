"""Stencils of the port: "same" correlations and pooling windows with the
JAX package's padding rule, in IEEE float32 on the card.

``jax.lax.conv_general_dilated`` and ``reduce_window`` with ``"SAME"``
pad a window of k taps by (k - 1) // 2 before and k // 2 after.
PyTorch's cuDNN convolutions round float32 inputs to TF32 (10 mantissa
bits) unless ``torch.backends.cudnn.allow_tf32`` is False, and its
default is True; every convolution of the port runs inside
:func:`ieee_fp32`, which turns TF32 off for the call only (and cuBLAS'
float32 matmuls with it, whose flag a caller may have turned on).
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN convolutions and cuBLAS matmuls in IEEE float32 (no TF32)
    inside the block; the caller's settings are restored after it."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def conv2d(x, w, padding=0):
    """``F.conv2d(x, w, padding=padding)`` in IEEE float32."""
    with ieee_fp32():
        return F.conv2d(x, w, padding=padding)


def _same_pads(kh, kw):
    return ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2)


def corr_same(field, kernel):
    """Zero-padded "same" correlation of (..., m, n) fields with the 2-D
    ``kernel`` (kh, kw): ``conv_general_dilated(..., "SAME")``."""
    shape = field.shape
    kh, kw = kernel.shape
    f = F.pad(field.reshape(-1, 1, shape[-2], shape[-1]), _same_pads(kh, kw))
    out = conv2d(f, kernel.to(field.dtype).reshape(1, 1, kh, kw))
    return out.reshape(shape)


def sep_corr(field, kx, ky):
    """Separable "same" correlation: ``ky`` along the rows (axis -2), then
    ``kx`` along the columns (axis -1)."""
    return corr_same(corr_same(field, ky[:, None]), kx[None, :])


def pool_same(field, size, op):
    """``reduce_window`` of ``op`` ("max" or "min") over size x size windows
    with stride 1 and "SAME" padding by the op's identity."""
    shape = field.shape
    sign = 1.0 if op == "max" else -1.0
    f = F.pad(sign * field.reshape(-1, 1, shape[-2], shape[-1]), _same_pads(size, size),
              value=float("-inf"))
    return (sign * F.max_pool2d(f, size, stride=1)).reshape(shape)
