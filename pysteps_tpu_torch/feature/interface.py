"""Feature-detection registry (counterpart of
``pysteps_tpu/feature/interface.py``): the same names, the same error."""

from pysteps_tpu_torch.feature import shitomasi


def _get_blob():
    from pysteps_tpu_torch.feature import blob

    return blob.detection


def _get_tstorm():
    from pysteps_tpu_torch.feature import tstorm

    return tstorm.detection


def get_method(name):
    """The detection function registered under ``name`` ("shitomasi",
    "blob", "tstorm"); ``ValueError`` for any other."""
    name = name.lower() if isinstance(name, str) else name
    if name == "shitomasi":
        return shitomasi.detection
    if name == "blob":
        return _get_blob()
    if name == "tstorm":
        return _get_tstorm()
    raise ValueError(f"unknown feature detection method {name}")
