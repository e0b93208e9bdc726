"""Nowcast-method registry (counterpart of
``pysteps_tpu/nowcasts/interface.py``); STEPS is the ported method."""

from pysteps_tpu_torch.nowcasts import steps

_nowcast_methods = {
    "steps": steps.forecast,
}


def get_method(name):
    """The forecast function registered under ``name``."""
    if name is None:
        raise ValueError("name is None")
    try:
        return _nowcast_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown nowcast method {name}; available: {list(_nowcast_methods)}"
        ) from None
