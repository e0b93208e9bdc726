"""
pysteps_tpu_torch — the STEPS ensemble nowcast on PyTorch and CUDA.

A port of the ``pysteps_tpu`` JAX package to PyTorch for NVIDIA Hopper
GPUs.  Subpackages and modules sit at the same relative paths as their
counterparts in the JAX package.  Plain tensor code is PyTorch; every
Pallas kernel on the ported path is a hand-written CUDA C++ kernel under
``csrc/`` (built with ``nvcc`` for ``sm_90a`` at first use, see
``ops/_kernels.py``).

Device rule: entry points run on ``"cuda"`` unless the caller passes
``device="cpu"`` (or CPU tensors).  A kernel wrapper given a CUDA tensor
launches its kernel or raises; its plain PyTorch version runs only for CPU
tensors.

The host boundary (``io``, ``datasets``, ``visualization``, ``scripts``)
reads and writes numpy: importers return numpy arrays and metadata dicts,
and the exporters and plots take numpy or tensors on any device, which they
read back to the host once.  ``visualization`` is not imported here, so
matplotlib stays optional.
"""

from pysteps_tpu_torch import (  # noqa: F401
    blending,
    cascade,
    config,
    datasets,
    downscaling,
    extrapolation,
    feature,
    io,
    motion,
    noise,
    nowcasts,
    ops,
    postprocessing,
    timeseries,
    tracking,
    utils,
    verification,
)

__version__ = "0.1.0"
