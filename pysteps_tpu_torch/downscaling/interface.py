"""Downscaling registry (counterpart of
``pysteps_tpu/downscaling/interface.py``; reference:
pysteps/downscaling/interface.py:17)."""

from pysteps_tpu_torch.downscaling import rainfarm

_downscale_methods = {"rainfarm": rainfarm.downscale}


def get_method(name):
    if name is None:
        raise ValueError("name is None")
    try:
        return _downscale_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown downscaling method {name}; available: {list(_downscale_methods)}"
        ) from None
