"""Cascade method registry (counterpart of ``pysteps_tpu/cascade/interface.py``)."""

from pysteps_tpu_torch.cascade import bandpass_filters, decomposition

_cascade_methods = {
    "fft": (decomposition.decomposition_fft, decomposition.recompose_fft),
    "gaussian": bandpass_filters.filter_gaussian,
    "uniform": bandpass_filters.filter_uniform,
}


def get_method(name):
    if name is None:
        raise ValueError("name is None")
    try:
        return _cascade_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown cascade method {name}; available: {list(_cascade_methods)}"
        ) from None
