"""Tracking registry (counterpart of ``pysteps_tpu/tracking/interface.py``):
the same names, the same error."""

from pysteps_tpu_torch.tracking import lucaskanade


def _get_tdating():
    from pysteps_tpu_torch.tracking import tdating

    return tdating.dating


def get_method(name):
    """The tracking function registered under ``name`` ("lucaskanade",
    "tdating"); ``ValueError`` for any other."""
    name = name.lower() if isinstance(name, str) else name
    if name == "lucaskanade":
        return lucaskanade.track_features
    if name == "tdating":
        return _get_tdating()
    raise ValueError(f"unknown tracking method {name}")
