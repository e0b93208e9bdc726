"""Profiling and tracing helpers (counterpart of
``pysteps_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (with the card's kernels
when one is present) and writes it as a Chrome trace into ``logdir``,
``annotate`` names a region inside it, ``device_memory_stats`` reads the
caching allocator's statistics under the JAX package's key names, and
``Timer`` accumulates named wall-clock sections that end in a
synchronization of the card.

``annotate`` is the port's span entry point.  The STEPS nowcast and STEPS
blending forecasts name their stages with it (``pst.gate``, ``pst.init``
and its ``pst.init.*`` stages, ``pst.loop``, one ``pst.lead`` a lead and
member chunk with its ``pst.update``, ``pst.mask``, ``pst.match``,
``pst.warp`` and ``pst.write``; ``pst.stream`` where a callback takes the
frames).  Under any ``torch.profiler`` session, ``trace`` included, the
spans land in the same trace as the kernels and copies, on the same clock,
so a forecast wrapped in ``trace`` shows them in Perfetto.  With no
session recording a span costs one check of the profiler's state.
"""

import contextlib
import os
import tempfile
import time

import torch


def _cuda_ready():
    return torch.cuda.is_available() and torch.cuda.is_initialized()


@contextlib.contextmanager
def trace(logdir=None, host=False):
    """Record a profiler trace of the enclosed block into ``logdir``
    (default: ``pysteps_tpu_torch_trace`` in the temporary directory) as
    ``trace_<pid>_<ns>.json``; view it in Perfetto or ``chrome://tracing``.
    The card's activity is recorded when a card is present and ``host`` is
    False."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "pysteps_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and not host:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


# the context ``annotate`` hands out while no profiler records
_OFF = contextlib.nullcontext()


def annotate(name):
    """Named region that shows up inside profiler traces: a
    ``torch.profiler.record_function`` while a profiler session records,
    else a shared no-op context (no dispatcher call, nothing allocated).

    Usage::

        with annotate("cascade-decompose"):
            levels, mu, sigma = decompose_core(field, weights)
    """
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


# the JAX package's names (a TPU device's ``memory_stats()``) and the
# caching allocator's counters they read
_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
}


def device_memory_stats(device=None):
    """The card's memory use (bytes) under the JAX package's key names,
    with ``bytes_limit`` the card's total memory; ``{}`` on the CPU."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {k: int(stats.get(v, 0)) for k, v in _MEMORY_KEYS.items()}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    return out


class Timer:
    """Cumulative named wall-clock timers for host-side phase accounting.
    Each section ends in ``torch.cuda.synchronize()`` once CUDA is in use,
    so that it counts the card's work it enqueued::

        t = Timer()
        with t("init"): ...
        with t("scan"): ...
        print(t.report())
    """

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _cuda_ready():
                torch.cuda.synchronize()
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self):
        width = max((len(k) for k in self.totals), default=0)
        return "\n".join(
            f"{k:{width}s}  {v*1e3:10.2f} ms" for k, v in self.totals.items()
        )
