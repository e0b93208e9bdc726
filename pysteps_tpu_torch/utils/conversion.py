"""Unit conversions mm/h <-> mm <-> dBZ through the Z-R relation
Z = a R^b (counterpart of ``pysteps_tpu/utils/conversion.py``).  The
arithmetic runs on the tensor's device (other input goes to the card
unless ``device`` says otherwise), the metadata on the host."""

from pysteps_tpu_torch._device import as_device_tensor
from pysteps_tpu_torch.utils import transformation


def _undo_transform(R, metadata):
    t = metadata.get("transform")
    if t is None:
        return R, metadata
    if t == "dB":
        return transformation.dB_transform(R, metadata, inverse=True)
    if t in ("BoxCox", "log"):
        return transformation.boxcox_transform(R, metadata, inverse=True)
    if t == "NQT":
        return transformation.NQ_transform(R, metadata, inverse=True)
    if t == "sqrt":
        return transformation.sqrt_transform(R, metadata, inverse=True)
    raise ValueError(f"Unknown transformation {t}")


def _zr_coeffs(metadata, zr_a, zr_b):
    if zr_a is None:
        zr_a = metadata.get("zr_a", 200.0)
    if zr_b is None:
        zr_b = metadata.get("zr_b", 1.6)
    return zr_a, zr_b


def to_rainrate(R, metadata, zr_a=None, zr_b=None, device=None):
    """Convert to rain rate [mm/h]."""
    R = as_device_tensor(R, device)
    metadata = dict(metadata)
    R, metadata = _undo_transform(R, metadata)
    unit = metadata["unit"]
    if unit == "mm/h":
        pass
    elif unit == "mm":
        fac = 60.0 / float(metadata["accutime"])
        R = R * fac
        metadata["threshold"] = metadata["threshold"] * fac
        metadata["zerovalue"] = metadata["zerovalue"] * fac
    elif unit == "dBZ":
        zr_a, zr_b = _zr_coeffs(metadata, zr_a, zr_b)
        R = (R / zr_a) ** (1.0 / zr_b)
        metadata["threshold"] = (metadata["threshold"] / zr_a) ** (1.0 / zr_b)
        metadata["zerovalue"] = (metadata["zerovalue"] / zr_a) ** (1.0 / zr_b)
        metadata["zr_a"], metadata["zr_b"] = zr_a, zr_b
    else:
        raise ValueError(f"Cannot convert unit {unit} to mm/h")
    metadata["unit"] = "mm/h"
    return R, metadata


def to_raindepth(R, metadata, zr_a=None, zr_b=None, device=None):
    """Convert to rain depth [mm]."""
    R = as_device_tensor(R, device)
    metadata = dict(metadata)
    R, metadata = _undo_transform(R, metadata)
    unit = metadata["unit"]
    if unit == "mm":
        pass
    elif unit == "mm/h":
        fac = float(metadata["accutime"]) / 60.0
        R = R * fac
        metadata["threshold"] = metadata["threshold"] * fac
        metadata["zerovalue"] = metadata["zerovalue"] * fac
    elif unit == "dBZ":
        zr_a, zr_b = _zr_coeffs(metadata, zr_a, zr_b)
        fac = float(metadata["accutime"]) / 60.0
        R = (R / zr_a) ** (1.0 / zr_b) * fac
        metadata["threshold"] = (metadata["threshold"] / zr_a) ** (1.0 / zr_b) * fac
        metadata["zerovalue"] = (metadata["zerovalue"] / zr_a) ** (1.0 / zr_b) * fac
        metadata["zr_a"], metadata["zr_b"] = zr_a, zr_b
    else:
        raise ValueError(f"Cannot convert unit {unit} to mm")
    metadata["unit"] = "mm"
    return R, metadata


def to_reflectivity(R, metadata, zr_a=None, zr_b=None, device=None):
    """Convert to reflectivity [dBZ]."""
    R = as_device_tensor(R, device)
    metadata = dict(metadata)
    R, metadata = _undo_transform(R, metadata)
    unit = metadata["unit"]
    if unit in ("mm/h", "mm"):
        if unit == "mm":
            R, metadata = to_rainrate(R, metadata)
        zr_a, zr_b = _zr_coeffs(metadata, zr_a, zr_b)
        R = zr_a * R**zr_b
        metadata["threshold"] = zr_a * metadata["threshold"] ** zr_b
        metadata["zerovalue"] = zr_a * metadata["zerovalue"] ** zr_b
        metadata["zr_a"], metadata["zr_b"] = zr_a, zr_b
        R, metadata = transformation.dB_transform(R, metadata)
    elif unit == "dBZ":
        R, metadata = transformation.dB_transform(R, metadata)
    else:
        raise ValueError(f"Cannot convert unit {unit} to dBZ")
    metadata["unit"] = "dBZ"
    return R, metadata
