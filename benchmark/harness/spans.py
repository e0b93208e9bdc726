"""The traced requests by the port's own spans: each ``pst.`` span of the
forecast (``pysteps_tpu_torch/utils/profiling.py::annotate``) with the
device time it launched, the device's idle time while the host was in it,
and the kernel launches and host-blocking calls made in it.

A kernel or copy is given to the span that launched it, not to the span
the host was in while it ran: the loop does not wait for the card, so a
kernel launched in ``pst.match`` often runs while the host is already in
``pst.warp``.  The profiler records each launching runtime call (or driver
call) with the same correlation id as its kernel; the kernel's launch time
is that call's start, and the innermost ``pst.`` span around it takes the
kernel.  A kernel whose call the trace does not hold, or whose call lies
outside every ``pst.`` span, is unattributed.  Idle time is the part of a
``bench.forecast`` span that no kernel or copy covers (busy as in
``trace.summarize``), given to the innermost ``pst.`` span the host was in.

Spans are keyed by their path, the names from the outermost ``pst.`` span
in, joined by "/" (``pst.loop/pst.lead/pst.match``).

The runner hands its readers the trace's summary (``ctx["trace"]``), not
the profiler's events.  :func:`of` finds them in the runner's frame that
holds the readers' ``ctx`` (its ``tracer``), reduces them once, keeps the
reduction in ``ctx["spans"]`` for the other readers, and prints the
coverage shares and the reduction to stderr as
``benchmark: spans {...} {...}``.
"""

import json
import re
import sys

import numpy as np

from benchmark.harness.trace import FORECAST_SPAN, WINDOW_SPAN, idle_gaps, merged

PREFIX = "pst."
# CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, cudaStreamSynchronize, ...)
_API = re.compile(r"cu(da)?[A-Z]")
_LAUNCH = re.compile(r"Launch\w*Kernel")


def is_launch(name):
    """Whether the runtime or driver call ``name`` launches a kernel."""
    return bool(_LAUNCH.search(name))


def is_sync(name):
    """Whether the runtime or driver call ``name`` blocks the host until the
    card catches up: a synchronize, or a memcpy that is not asynchronous."""
    return name.endswith("Synchronize") or ("Memcpy" in name and "Async" not in name)


def timeline(spans):
    """The sorted disjoint segments (start, end, path) over which the
    innermost of the properly nested ``spans`` [(start, end, name)] stays
    the same."""
    segs, stack, cur = [], [], None

    def emit(a, b, path):
        if b > a:
            segs.append((a, b, path))

    for s, e, name in sorted(spans, key=lambda sp: (sp[0], -sp[1])):
        while stack and stack[-1][0] <= s:
            end, path = stack.pop()
            emit(cur, end, path)
            cur = end
        if stack:
            emit(cur, s, stack[-1][1])
        stack.append((e, (stack[-1][1] + "/" if stack else "") + name))
        cur = s
    while stack:
        end, path = stack.pop()
        emit(cur, end, path)
        cur = end
    return segs


class _Lookup:
    """The path of the innermost span at a time, from a timeline."""

    def __init__(self, segs):
        self.segs = segs
        self.starts = np.fromiter((sg[0] for sg in segs), np.int64, len(segs))

    def at(self, t):
        k = int(np.searchsorted(self.starts, t, side="right")) - 1
        if k >= 0 and t < self.segs[k][1]:
            return self.segs[k][2]
        return None

    def split(self, a, b):
        """[(path or None, ns)] of the interval [a, b] by innermost span."""
        out, t = [], a
        k = max(int(np.searchsorted(self.starts, a, side="right")) - 1, 0)
        while k < len(self.segs) and self.segs[k][0] < b:
            s, e, path = self.segs[k]
            s, e = max(s, a), min(e, b)
            if e > s:
                if s > t:
                    out.append((None, s - t))
                out.append((path, e - s))
                t = e
            k += 1
        if b > t:
            out.append((None, b - t))
        return out


def _add(d, key, v):
    d[key] = d.get(key, 0) + v


def reduce(events):
    """The ``pst.`` spans of the traced window's raw profiler ``events``:

    - ``requests``: the ``bench.forecast`` spans in the window;
    - ``span_s``, ``span_n``: wall seconds and count of each span name;
    - ``device_s``: device seconds of the kernels and copies a span path
      launched; ``launches``, ``syncs``: the kernel launches and the
      host-blocking calls made in it (each call once, by correlation id);
    - ``idle_s``: device idle seconds inside the forecast calls while the
      host was in a span path;
    - ``forecast_device_s``: the device seconds of every kernel and copy
      launched inside a forecast call (or, unpaired, whose middle lies in
      one); ``unattributed_s``: the part launched outside every ``pst.``
      span or unpaired; ``unspanned_idle_s``: idle seconds of the forecast
      calls outside every ``pst.`` span;
    - ``paired_by``: the event id that paired kernels with their calls
      (``correlation_id`` or ``linked_correlation_id``), and ``unpaired``,
      the number of device events left without a call.

    None where the trace holds no ``bench.window`` span."""
    window, calls, spans, api, dev = None, [], [], [], []
    for ev in events:
        name, s, e = ev.name(), ev.start_ns(), ev.end_ns()
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation() and e > s:
                dev.append((s, e, ev.correlation_id(), ev.linked_correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((s, e, name))
        elif name == FORECAST_SPAN:
            calls.append((s, e))
        elif name == WINDOW_SPAN:
            window = (s, e)
        elif _API.match(name):
            api.append((s, name, ev.correlation_id()))
    if window is None:
        return None
    lo, hi = window
    calls = merged(calls, lo, hi)
    spans = [sp for sp in spans if sp[1] > lo and sp[0] < hi]
    look = _Lookup(timeline(spans))
    in_call = _Lookup([(a, b, FORECAST_SPAN) for a, b in calls])

    span_s, span_n = {}, {}
    for s, e, name in spans:
        _add(span_s, name, (e - s) / 1e9)
        _add(span_n, name, 1)

    # a runtime call and the driver call it makes share a correlation id:
    # each is counted once, and a kernel's launch is the earlier start
    launches, syncs, call_at, seen = {}, {}, {}, set()
    for s, name, corr in sorted(api):
        if corr:
            call_at.setdefault(corr, s)
        kind = "launch" if is_launch(name) else "sync" if is_sync(name) else None
        path = look.at(s)
        if kind is None or path is None or (corr and (corr, kind) in seen):
            continue
        seen.add((corr, kind))
        _add(launches if kind == "launch" else syncs, path, 1)

    # the id that pairs a device event with its call
    n_corr = sum(1 for d in dev if d[2] in call_at)
    n_link = sum(1 for d in dev if d[3] in call_at)
    key, paired_by = (3, "linked_correlation_id") if n_link > n_corr else (2, "correlation_id")
    device_s = {}
    forecast_s = unattributed = 0.0
    unpaired = 0
    for d in dev:
        s, e = max(d[0], lo), min(d[1], hi)
        if e <= s:
            continue
        sec = (e - s) / 1e9
        t = call_at.get(d[key])
        if t is None:
            unpaired += 1
            if in_call.at((s + e) // 2):
                forecast_s += sec
                unattributed += sec
            continue
        if not in_call.at(t):
            continue
        forecast_s += sec
        path = look.at(t)
        if path is None:
            unattributed += sec
        else:
            _add(device_s, path, sec)

    busy = merged([(s, e) for s, e, _, _ in dev], lo, hi)
    starts = np.fromiter((b[0] for b in busy), np.int64, len(busy))
    ends = np.fromiter((b[1] for b in busy), np.int64, len(busy))
    idle_s, unspanned = {}, 0.0
    for a, b in calls:
        near = busy[int(np.searchsorted(ends, a)):int(np.searchsorted(starts, b))]
        for g0, g1 in idle_gaps(merged(near, a, b), a, b):
            for path, ns in look.split(g0, g1):
                if path is None:
                    unspanned += ns / 1e9
                else:
                    _add(idle_s, path, ns / 1e9)

    return {
        "requests": len(calls), "span_s": span_s, "span_n": span_n,
        "device_s": device_s, "idle_s": idle_s, "launches": launches, "syncs": syncs,
        "forecast_device_s": forecast_s, "unattributed_s": unattributed,
        "unspanned_idle_s": unspanned, "paired_by": paired_by if dev else None,
        "unpaired": unpaired,
    }


def inside(by_path, span):
    """The sum of ``by_path``'s values over the paths that pass through the
    span name ``span``."""
    return sum(v for path, v in by_path.items() if span in path.split("/"))


def _tracer_of(ctx):
    """The ``tracer`` of the caller's frame whose ``ctx`` is ``ctx``, or
    None."""
    f = sys._getframe(1)
    while f is not None:
        local = f.f_locals
        if local.get("ctx") is ctx and callable(getattr(local.get("tracer"), "events", None)):
            return local["tracer"]
        f = f.f_back
    return None


def of(ctx):
    """The span reduction of the run whose metrics are read from ``ctx``:
    ``ctx["spans"]`` where it is set, else the reduction of the traced
    window's events (None for a run with no trace summary, that is an
    untraced or off-card run, or where the events cannot be found)."""
    if "spans" not in ctx:
        sp = None
        tracer = _tracer_of(ctx) if ctx.get("trace") is not None else None
        if tracer is not None:
            sp = reduce(tracer.events())
            if sp:
                print(f"benchmark: spans {json.dumps(coverage(sp, ctx['trace']))} "
                      f"{json.dumps(sp)}", file=sys.stderr)
        ctx["spans"] = sp
    return ctx["spans"]


def per_request(ctx, key, span, leads=False):
    """``ctx``'s span reduction's ``key`` (``device_s``, ``idle_s``,
    ``launches``, ``syncs``) summed over the paths through ``span``, a
    request (and a lead with ``leads``); None where the run recorded no
    such span."""
    sp = of(ctx)
    if not sp or not sp["requests"] or span not in sp["span_n"]:
        return None
    return inside(sp[key], span) / (sp["requests"] * (ctx["T"] if leads else 1))


def coverage(sp, summary=None):
    """The shares the span reduction accounts for: device time launched in
    a ``pst.`` span over the forecast calls' device time, that sum over the
    trace reduction's (``summary``'s ``forecast_s_by_group``), and idle
    time in a ``pst.`` span over the forecast calls' idle time."""
    attributed = sum(sp["device_s"].values())
    idle = sum(sp["idle_s"].values())
    out = {
        "device_attributed": attributed / sp["forecast_device_s"]
        if sp["forecast_device_s"] else None,
        "idle_in_spans": idle / (idle + sp["unspanned_idle_s"])
        if idle + sp["unspanned_idle_s"] else None,
    }
    if summary is not None:
        total = sum(summary["forecast_s_by_group"].values())
        out["device_vs_trace"] = attributed / total if total else None
    return out
