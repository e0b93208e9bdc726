"""The traced run's reduction: kernel intervals from the profiler's
events, their union against the traced window, device time by kernel
group (all of the window's, and the part that ran inside the forecast
calls' spans), the longest idle gaps with what the host was doing, and a
record of the hand-written kernels' launches with their arguments.

The groups are ``scripts/profile_torch_steps.py``'s (kernel-name
substrings, the first match wins); its idle share summed the kernels'
self times, which counts overlapping kernels twice: here the busy time is
the union of the kernels' intervals.
"""

import numpy as np

GROUPS = (
    ("pst_resample", "K1 resample"), ("pst_warp", "K2 warp"),
    ("pst_chain_v", "chain match+vert+rim"), ("pst_chain_h", "chain horiz"),
    ("pst_pwl_hier", "pwl hier"), ("pst_pwl_flat", "pwl flat"),
    ("pst_pwl", "K3 pwl"), ("pst_rim", "K4 rim"), ("pst_cdf", "cdf counts"),
    ("fft", "fft"), ("sort", "sort"), ("radix", "sort"),
    ("scatter", "scatter/gather"), ("gather", "scatter/gather"), ("cudnn", "conv"),
    ("implicit_gemm", "conv"), ("fprop", "conv"), ("convolution", "conv"),
    ("conv2d", "conv"), ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"),
    ("reduce", "reduction"), ("elementwise", "elementwise"),
    ("vectorized", "elementwise"), ("memcpy", "copy"), ("memset", "copy"),
)
WINDOW_SPAN = "bench.window"
FORECAST_SPAN = "bench.forecast"


def group_of(name):
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


class LaunchRecorder:
    """While entered, every launch through ``kernels.launch`` (the port's
    ``ops/_kernels`` module) is recorded as (entry, args) in ``launches``
    and then made as before."""

    def __init__(self, kernels):
        self.kernels, self.launches = kernels, []

    def __enter__(self):
        self._launch = self.kernels.launch

        def launch(name, device, *args):
            self.launches.append((name, args))
            return self._launch(name, device, *args)

        self.kernels.launch = launch
        return self

    def __exit__(self, *exc):
        self.kernels.launch = self._launch


def split_events(events):
    """(device intervals [(name, start ns, end ns)], host events [(name,
    start ns, end ns)]) of the profiler's raw events; annotations mirrored
    onto the device span kernels and are left out."""
    dev, host = [], []
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation() and end > start:
                dev.append((ev.name(), start, end))
        else:
            host.append((ev.name(), start, end))
    return dev, host


def merged(intervals, lo, hi):
    """The union of ``intervals`` [(start, end)] clipped to [lo, hi], as
    sorted disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(busy, lo, hi):
    """The idle intervals of [lo, hi] between the ``busy`` union."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_at(host, t):
    """The innermost host event running at ``t`` (the shortest that spans
    it), or "host: untraced" where none does."""
    if not host:
        return "host: untraced"
    starts = np.fromiter((h[1] for h in host), np.int64, len(host))
    ends = np.fromiter((h[2] for h in host), np.int64, len(host))
    hit = np.nonzero((starts <= t) & (ends >= t))[0]
    if hit.size == 0:
        return "host: untraced"
    return host[int(hit[np.argmin(ends[hit] - starts[hit])])][0]


def within(spans, t):
    """Whether ``t`` lies inside one of the sorted disjoint ``spans``."""
    starts = np.fromiter((sp[0] for sp in spans), np.int64, len(spans))
    k = int(np.searchsorted(starts, t, side="right")) - 1
    return k >= 0 and t <= spans[k][1]


def summarize(events, top=10):
    """The traced window's reduction of the profiler's raw ``events``:
    window and busy seconds (the union of device intervals inside the
    window), device seconds by group and by name inside the window, device
    seconds by group of the kernels whose middle lies inside a
    ``bench.forecast`` span (each forecast call ends in a synchronize, so
    its kernels run inside its span), the ``top`` longest idle gaps each
    with the host event at its middle, and the device seconds of the
    hand-written kernels (``pst_`` in the name)."""
    dev, host = split_events(events)
    spans = [h for h in host if h[0] == WINDOW_SPAN]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    lo, hi = spans[0][1], spans[0][2]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = merged([(s, e) for _, s, e in inside], lo, hi)
    calls = merged([(h[1], h[2]) for h in host if h[0] == FORECAST_SPAN], lo, hi)
    by_group, by_name, in_calls = {}, {}, {}
    for name, s, e in inside:
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + (e - s) / 1e9
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if calls and within(calls, (s + e) // 2):
            in_calls[g] = in_calls.get(g, 0.0) + (e - s) / 1e9
    gaps = sorted(idle_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    inner = [h for h in host if h[2] > lo and h[1] < hi and h[0] != WINDOW_SPAN]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s_by_group": by_group,
        "forecast_s_by_group": in_calls,
        "device_ops": sorted(([n[:200], s] for n, s in by_name.items()),
                             key=lambda r: -r[1])[:top],
        "idle_gaps": [[host_at(inner, (s + e) // 2)[:200], (e - s) / 1e9] for s, e in gaps],
        "pst_device_s": sum(e - s for n, s, e in inside if "pst_" in n) / 1e9,
        "pst_kernels": sum(1 for n, _, _ in inside if "pst_" in n),
    }
