"""The port's device rule: CUDA unless the caller asks for the CPU."""

import numpy as np
import torch


def resolve_device(device=None, *inputs):
    """The device a forecast runs on.

    ``device=None`` means the device of the first torch tensor among
    ``inputs``, else ``"cuda"``.  Raises ``RuntimeError`` when the result
    is a CUDA device and CUDA is unavailable: the port never falls back to
    the CPU on its own.
    """
    if device is None:
        tensors = [x for x in inputs if isinstance(x, torch.Tensor)]
        device = tensors[0].device if tensors else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pysteps_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


def device_of(x, device=None):
    """The device an entry point runs on for its input ``x``: ``device``
    if given, else the device of ``x`` if it is a tensor, else the port's
    default (the card; see ``resolve_device``)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def as_device_tensor(x, device=None, dtype=None):
    """``x`` as a tensor on ``device_of(x, device)``: a tensor keeps its
    own device unless ``device`` is given, anything else goes to the card
    unless the caller asks for the CPU.  A numpy view with negative
    strides (``x[::-1]``) is copied first, as torch cannot wrap it."""
    if isinstance(x, np.ndarray) and any(s < 0 for s in x.strides):
        x = np.ascontiguousarray(x)
    return torch.as_tensor(x, dtype=dtype, device=device_of(x, device))


def to_numpy(x):
    """``x`` as a host numpy array: a tensor on any device is copied to the
    host once (also from the CPU, so the array never shares a buffer the
    caller reuses), bfloat16 through float32, which numpy lacks; anything
    else goes through ``np.asarray``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)
