"""Temporal autocorrelation (counterpart of
``pysteps_tpu/timeseries/correlation.py``, spatial domain, global window)."""

import torch


def _masked_corrcoef(a, b, mask):
    w = mask.to(a.dtype)
    cnt = torch.clamp(w.sum(), min=1.0)
    ma = (a * w).sum() / cnt
    mb = (b * w).sum() / cnt
    va = ((a - ma) ** 2 * w).sum()
    vb = ((b - mb) ** 2 * w).sum()
    cov = ((a - ma) * (b - mb) * w).sum()
    return cov / torch.sqrt(torch.clamp(va * vb, min=1e-30))


def temporal_autocorrelation(x, mask=None):
    """Lag-l autocorrelations gamma_l = corr(x[-1], x[-1-l]) for
    l = 1..len(x)-1 of a (t, m, n) series, over the boolean ``mask``
    if given.  Returns a list of 0-d tensors."""
    m = mask if mask is not None else torch.ones(x.shape[1:], dtype=torch.bool, device=x.device)
    return [_masked_corrcoef(x[-1], x[-(k + 2)], m) for k in range(x.shape[0] - 1)]
