"""Window arithmetic: the rate and the tail percentile."""


def percentile(values, q):
    """The ``q``-th percentile (0-100) of ``values``, linear between the
    order statistics (``statistics.quantiles``' inclusive method), the
    value itself for one sample."""
    vals = sorted(values)
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return float(vals[lo] + (vals[hi] - vals[lo]) * (pos - lo))


def rate(work, window_s):
    """Work done over the window's elapsed seconds."""
    return float(work) / float(window_s)

