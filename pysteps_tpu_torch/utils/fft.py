"""FFT namespace (counterpart of ``pysteps_tpu/utils/fft.py``; reference:
pysteps/utils/fft.py:20,39,61).

The reference's uniform namespace (fft2/ifft2/rfft2/irfft2/fftshift/
ifftshift/fftfreq) over ``torch.fft``: the numpy/scipy/pyfftw distinction
collapses to one backend, as it does over ``jnp.fft`` in the JAX package.
``fftfreq`` is numpy's, as there.
"""

from types import SimpleNamespace

import numpy as np
import torch


def get_fft(shape, fftn_shape=None, **kwargs):
    """Return an FFT namespace bound to a field shape."""
    f = {
        "fft2": torch.fft.fft2,
        "ifft2": torch.fft.ifft2,
        "rfft2": torch.fft.rfft2,
        "irfft2": lambda X: torch.fft.irfft2(X, s=tuple(shape)),
        "fftshift": torch.fft.fftshift,
        "ifftshift": torch.fft.ifftshift,
        "fftfreq": np.fft.fftfreq,
    }
    if fftn_shape is not None:
        f["fftn"] = torch.fft.fftn
    fft = SimpleNamespace(**f)
    fft.shape = shape
    return fft


# API-parity aliases: every requested backend is torch.fft underneath
def get_numpy(shape, **kwargs):
    return get_fft(shape, **kwargs)


def get_scipy(shape, **kwargs):
    return get_fft(shape, **kwargs)


def get_pyfftw(shape, **kwargs):
    return get_fft(shape, **kwargs)
