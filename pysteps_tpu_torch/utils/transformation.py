"""Invertible intensity transforms with metadata bookkeeping (counterpart
of ``pysteps_tpu/utils/transformation.py``).

Each transform takes a tensor (or anything ``torch.as_tensor`` takes) and
returns ``(tensor, metadata)``; the arithmetic runs on the tensor's device
(other input goes to the card unless ``device`` says otherwise) and the
metadata stays on the host.  NQT keeps its sorted-quantile tables
in the metadata as two tensors, so the inverse runs on the device too.
"""

import numpy as np
import torch

from pysteps_tpu_torch._device import as_device_tensor


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` for sorted 1-D ``xp``: linear between the
    knots, ``fp[0]`` below ``xp[0]`` and ``fp[-1]`` above ``xp[-1]``; in a
    run of tied knots a value takes the run's last ``fp``."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def dB_transform(R, metadata=None, threshold=None, zerovalue=None, inverse=False,
                 device=None):
    """dB transform of rain rates.  Forward: R >= threshold -> 10 log10 R,
    else ``zerovalue`` (default threshold_dB - 5).  Inverse: 10^(R/10),
    values below the threshold set to ``zerovalue``."""
    R = as_device_tensor(R, device)
    metadata = dict(metadata) if metadata is not None else (
        {"transform": "dB"} if inverse else {"transform": None}
    )

    if not inverse:
        if metadata.get("transform") == "dB":
            return R, metadata
        if threshold is None:
            threshold = metadata.get("threshold", 0.1)
        zeros = R < threshold
        threshold_db = 10.0 * np.log10(threshold)
        if zerovalue is None:
            zerovalue = threshold_db - 5
        R = torch.where(
            zeros, zerovalue, 10.0 * torch.log10(torch.where(zeros, 1.0, R))
        ).to(R.dtype)
        metadata.update(transform="dB", zerovalue=zerovalue, threshold=threshold_db)
        return R, metadata

    if metadata.get("transform") != "dB":
        return R, metadata
    if threshold is None:
        threshold = metadata.get("threshold", -10.0)
    if zerovalue is None:
        zerovalue = 0.0
    R = torch.pow(10.0, R / 10.0)
    threshold_lin = 10.0 ** (threshold / 10.0)
    R = torch.where(R < threshold_lin, zerovalue, R).to(R.dtype)
    metadata.update(transform=None, threshold=threshold_lin, zerovalue=zerovalue)
    return R, metadata


def boxcox_transform(
    R, metadata=None, Lambda=None, threshold=None, zerovalue=None, inverse=False,
    device=None,
):
    """One-parameter Box-Cox transform; ``Lambda=0`` is the log transform."""
    R = as_device_tensor(R, device)
    metadata = dict(metadata) if metadata is not None else (
        {"transform": "BoxCox"} if inverse else {"transform": None}
    )

    if not inverse:
        if metadata.get("transform") == "BoxCox":
            return R, metadata
        if Lambda is None:
            Lambda = metadata.get("BoxCox_lambda", 0.0)
        if threshold is None:
            threshold = metadata.get("threshold", 0.1)
        zeros = R < threshold
        Rsafe = torch.where(zeros, 1.0, R).to(R.dtype)
        if Lambda == 0.0:
            Rt = torch.log(Rsafe)
            threshold_t = np.log(threshold)
        else:
            Rt = (Rsafe**Lambda - 1) / Lambda
            threshold_t = (threshold**Lambda - 1) / Lambda
        if zerovalue is None:
            zerovalue = threshold_t - 1
        R = torch.where(zeros, zerovalue, Rt).to(R.dtype)
        metadata.update(
            transform="BoxCox", BoxCox_lambda=Lambda, zerovalue=zerovalue,
            threshold=threshold_t,
        )
        return R, metadata

    if metadata.get("transform") not in ["BoxCox", "log"]:
        return R, metadata
    if Lambda is None:
        Lambda = metadata.pop("BoxCox_lambda", 0.0)
    if threshold is None:
        threshold = metadata.get("threshold", -10.0)
    if zerovalue is None:
        zerovalue = 0.0
    if Lambda == 0.0:
        R = torch.exp(R)
        threshold_lin = np.exp(threshold)
    else:
        R = torch.exp(torch.log(Lambda * R + 1) / Lambda)
        threshold_lin = np.exp(np.log(Lambda * threshold + 1) / Lambda)
    R = torch.where(R < threshold_lin, zerovalue, R).to(R.dtype)
    metadata.update(transform=None, zerovalue=zerovalue, threshold=threshold_lin)
    return R, metadata


def sqrt_transform(R, metadata=None, inverse=False, device=None, **kwargs):
    """Square-root transform and its inverse."""
    R = as_device_tensor(R, device)
    if metadata is None:
        metadata = {"transform": "sqrt" if inverse else None}
        metadata["zerovalue"] = np.nan
        metadata["threshold"] = np.nan
    else:
        metadata = dict(metadata)
    if not inverse:
        R = torch.sqrt(R)
        metadata.update(
            transform="sqrt",
            zerovalue=np.sqrt(metadata["zerovalue"]),
            threshold=np.sqrt(metadata["threshold"]),
        )
    else:
        R = R**2
        metadata.update(
            transform=None,
            zerovalue=metadata["zerovalue"] ** 2,
            threshold=metadata["threshold"] ** 2,
        )
    return R, metadata


def _nanmin(x):
    return float(torch.where(torch.isnan(x), float("inf"), x).amin())


def NQ_transform(R, metadata=None, inverse=False, device=None, **kwargs):
    """Normal-quantile transform.  The forward map keeps the sorted values
    and their normal quantiles in the metadata ("nqt_values",
    "nqt_quantiles"); the inverse interpolates back through them."""
    a = kwargs.get("a", 0.0)
    R = as_device_tensor(R, device).to(torch.float32)
    shape0 = R.shape
    Rflat = R.reshape(-1)
    finite = torch.isfinite(Rflat)
    nan = torch.tensor(float("nan"), device=R.device)

    if metadata is None:
        metadata = {"transform": "NQT" if inverse else None}
        metadata["zerovalue"] = _nanmin(Rflat)
    else:
        metadata = dict(metadata)

    if not inverse:
        n = Rflat.numel()
        pp = (torch.arange(n, dtype=torch.float32, device=R.device) + 1 - a) / (
            n + 1 - 2 * a
        )
        Rqn = torch.special.ndtri(pp)
        # NaNs sort to the end as +inf; the interpolation runs against the
        # sorted finite values
        Rsorted = torch.sort(torch.where(finite, Rflat, float("inf"))).values
        Rt = _interp(Rflat, Rsorted, Rqn)
        Rt = torch.where(Rflat == metadata["zerovalue"], 0.0, Rt)
        Rt = torch.where(finite, Rt, nan)
        metadata["nqt_quantiles"] = Rqn
        metadata["nqt_values"] = Rsorted
        metadata["transform"] = "NQT"
        metadata["zerovalue"] = 0
        metadata["threshold"] = float(torch.where(Rt > 0, Rt, float("inf")).amin())
        return Rt.reshape(shape0), metadata

    qs = metadata.pop("nqt_quantiles")
    vals = metadata.pop("nqt_values")
    Rb = _interp(Rflat, qs, vals)
    Rb = torch.where(finite, Rb, nan)
    metadata["transform"] = None
    metadata["zerovalue"] = _nanmin(Rb)
    wet = Rb > metadata["zerovalue"]
    metadata["threshold"] = float(torch.where(wet, Rb, float("inf")).amin())
    return Rb.reshape(shape0), metadata
