"""One reader a metric, found by the metric's name in ``BENCHMARK.json``.

Each module's ``read(ctx)`` returns the metric's value, or None where the
run holds nothing to read it from (the harness then leaves it out).
``ctx`` holds: ``E`` and ``T`` of the configuration; ``requests``, a
dict a request of the window (``latency_s`` on the host clock, ``init_s``
and ``loop_s`` from the port's ``measure_time`` in a traced run);
``window_s``;
``setup_s``; ``peak_bytes``; ``trace``, the traced window's reduction
(``harness/trace.py::summarize``) or None, over its first
``traced_requests`` requests; ``launches``, the hand-written kernels'
launches of the traced requests as (entry, args); ``device_name``.
"""

import statistics


def mean_of(ctx, key):
    """The mean of ``key`` over the window's requests that ran outside the
    profiler (all of them where none did), None where no request has it."""
    reqs = ctx["requests"][ctx["traced_requests"]:] or ctx["requests"]
    vals = [r[key] for r in reqs if r.get(key) is not None]
    return statistics.fmean(vals) if vals else None


def device_ms_per_lead(ctx, groups):
    """Device ms a request and a lead of the kernel ``groups`` that ran
    inside the forecast's span, from the trace."""
    tr = ctx["trace"]
    if tr is None or not ctx["traced_requests"]:
        return None
    total = sum(tr["forecast_s_by_group"].get(g, 0.0) for g in groups)
    return 1e3 * total / (ctx["traced_requests"] * ctx["T"])
