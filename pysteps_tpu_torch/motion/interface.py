"""Motion-method registry (counterpart of
``pysteps_tpu/motion/interface.py``): the same names, the same errors."""

import numpy as np
import torch

from pysteps_tpu_torch._device import device_of
from pysteps_tpu_torch.motion.constant import constant
from pysteps_tpu_torch.motion.darts import DARTS
from pysteps_tpu_torch.motion.farneback import farneback
from pysteps_tpu_torch.motion.lucaskanade import dense_lucaskanade
from pysteps_tpu_torch.motion.proesmans import proesmans
from pysteps_tpu_torch.motion.vet import vet


def _do_nothing(input_images, device=None, **kwargs):
    """A zero flow (2, m, n) on the input's device."""
    shape = tuple(np.shape(input_images)[1:])
    return torch.zeros((2,) + shape, dtype=torch.float32,
                       device=device_of(input_images, device))


_motion_methods = {
    "constant": constant,
    "darts": DARTS,
    "farneback": farneback,
    "lk": dense_lucaskanade,
    "lucaskanade": dense_lucaskanade,
    "proesmans": proesmans,
    "vet": vet,
    None: _do_nothing,
    "none": _do_nothing,
}


def get_method(name):
    """The motion method registered under ``name`` (``None`` and "none":
    no motion); "brox" and "clg" raise ``NotImplementedError``, unknown
    names ``ValueError``."""
    if isinstance(name, str):
        name = name.lower()
    if name in ("brox", "clg"):
        raise NotImplementedError(f"method {name} not implemented")
    try:
        return _motion_methods[name]
    except KeyError:
        raise ValueError(
            f"unknown optical flow method {name}; available: {list(_motion_methods)}"
        ) from None
