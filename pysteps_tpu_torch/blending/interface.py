"""Blending registry (counterpart of ``pysteps_tpu/blending/interface.py``):
``linear_blending``, ``salient_blending``, ``steps`` and ``pca_enkf``."""

import functools

from pysteps_tpu_torch.blending import linear_blending, pca_ens_kalman_filter, steps

_blending_methods = {
    "linear_blending": linear_blending.forecast,
    "salient_blending": functools.partial(linear_blending.forecast, saliency=True),
    "steps": steps.forecast,
    "pca_enkf": pca_ens_kalman_filter.forecast,
}


def get_method(name):
    """The blending function registered under ``name``."""
    if name is None:
        raise ValueError("name is None")
    try:
        return _blending_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown blending method {name}; available: {list(_blending_methods)}"
        ) from None
