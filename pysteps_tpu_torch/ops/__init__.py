"""Kernels K1-K4 (CUDA C++ under ``csrc/``) with their wrappers and plain
PyTorch versions, and the warp primitives built on them."""

from pysteps_tpu_torch.ops import (  # noqa: F401
    pallas_dilate,
    pallas_histmatch,
    pallas_warp,
    warp,
)
