"""The hand-written CUDA kernels (C++ under ``csrc/``) with their wrappers
and plain PyTorch versions: K1-K4, the fused chain, the hierarchical
and flat PWL maps and the CDF counts; and the warp primitives built on
them."""

from pysteps_tpu_torch.ops import (  # noqa: F401
    pallas_chain,
    pallas_dilate,
    pallas_histmatch,
    pallas_warp,
    warp,
)
