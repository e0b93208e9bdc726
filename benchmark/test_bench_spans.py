"""CPU tests of the reduction by the port's ``pst.`` spans
(``harness/spans.py``) and of the metrics that read it, on synthetic
profiler events with correlation ids.  Run with ``python -m pytest
benchmark -q``."""

from importlib import import_module

import pytest

from benchmark.harness import spans

READERS = ("gate_ms", "init_idle_ms", "update_device_ms_per_lead", "match_device_ms_per_lead",
           "warp_device_ms_per_lead", "launches_per_lead", "syncs_per_request")


class _Ev:
    """A profiler event: host unless ``device``; ``corr`` the correlation id,
    ``link`` the linked one."""

    def __init__(self, name, start, end, device=False, corr=0, link=0, user=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._l, self._u = device, corr, link, user

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._u

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


def _span(name, start, end):
    return _Ev(name, start, end, user=True)


def _kernel(start, end, corr, name="elementwise_kernel"):
    return _Ev(name, start, end, device=True, corr=corr)


def _request(offset=0):
    """One forecast call of 1000 ns: gate, init, and a loop of one lead."""
    o = offset
    return [
        _span("bench.forecast", o, o + 1000),
        _span("pst.gate", o, o + 100),
        _span("pst.init", o + 100, o + 500),
        _span("pst.init.decompose", o + 150, o + 300),
        _span("pst.loop", o + 500, o + 1000),
        _span("pst.lead", o + 500, o + 1000),
        _span("pst.update", o + 500, o + 600),
        _span("pst.match", o + 600, o + 700),
        _span("pst.warp", o + 700, o + 800),
    ]


def _read(name, ctx):
    return import_module(f"benchmark.metrics.{name}").read(ctx)


def test_timeline_gives_the_innermost_span():
    segs = spans.timeline([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (12, 15, "d")])
    assert segs == [(0, 2, "a"), (2, 3, "a/b"), (3, 4, "a/b/c"), (4, 5, "a/b"),
                    (5, 10, "a"), (12, 15, "d")]


def test_kernel_counts_for_the_span_that_launched_it():
    """A kernel launched in ``pst.match`` that runs while the host is in
    ``pst.warp`` counts for the match."""
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaLaunchKernel", 650, 660, corr=7),
        _kernel(720, 900, 7),
        _Ev("cudaLaunchKernel", 750, 760, corr=8),
        _kernel(900, 950, 8, "void pst_resample_kernel"),
    ]
    sp = spans.reduce(events)
    assert sp["device_s"] == {"pst.loop/pst.lead/pst.match": pytest.approx(180e-9),
                              "pst.loop/pst.lead/pst.warp": pytest.approx(50e-9)}
    assert sp["paired_by"] == "correlation_id" and sp["unpaired"] == 0
    ctx = {"spans": sp, "T": 1}
    assert _read("match_device_ms_per_lead", ctx) == pytest.approx(180e-6)
    assert _read("warp_device_ms_per_lead", ctx) == pytest.approx(50e-6)
    assert _read("update_device_ms_per_lead", ctx) == pytest.approx(0.0)
    assert spans.coverage(sp)["device_attributed"] == pytest.approx(1.0)


def test_linked_ids_pair_where_correlation_ids_do_not():
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaLaunchKernel", 550, 560, corr=7),
        _Ev("kernel", 600, 650, device=True, corr=99, link=7),
    ]
    sp = spans.reduce(events)
    assert sp["paired_by"] == "linked_correlation_id"
    assert sp["device_s"] == {"pst.loop/pst.lead/pst.update": pytest.approx(50e-9)}


def test_init_idle_is_the_span_less_the_union_of_busy_intervals():
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaLaunchKernel", 110, 111, corr=1), _kernel(120, 250, 1),
        _Ev("cudaLaunchKernel", 112, 113, corr=2), _kernel(200, 300, 2),  # overlaps
        _Ev("cudaMemcpyAsync", 400, 401, corr=3),
        _Ev("Memcpy HtoD (Pageable -> Device)", 450, 550, device=True, corr=3),
    ]
    sp = spans.reduce(events)
    # pst.init is 100-500 and busy 120-300 and 450-500: idle 100-120 and
    # 300-450, both outside its stage (150-300)
    assert sp["idle_s"]["pst.init"] == pytest.approx((20 + 150) * 1e-9)
    assert "pst.init/pst.init.decompose" not in sp["idle_s"]
    assert _read("init_idle_ms", {"spans": sp, "T": 1}) == pytest.approx(170e-6)
    # the gate (0-100) is idle, and so is the loop after 550
    assert sp["idle_s"]["pst.gate"] == pytest.approx(100e-9)
    assert sp["unspanned_idle_s"] == 0.0
    assert spans.coverage(sp)["idle_in_spans"] == pytest.approx(1.0)


def test_launches_and_syncs_are_counted_per_span():
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaStreamSynchronize", 50, 60, corr=1),             # gate
        _Ev("cudaMemcpy", 160, 170, corr=2),                      # init, blocking
        _Ev("cudaMemcpyAsync", 180, 190, corr=3),                 # init, not blocking
        _Ev("cudaLaunchKernel", 510, 515, corr=4),                # update
        _Ev("cuLaunchKernel", 511, 514, corr=4),                  # the same launch
        _Ev("cuLaunchKernel", 610, 615, corr=5),                  # match
        _Ev("cudaLaunchKernel", 710, 715, corr=6),                # warp
        _Ev("cudaDeviceSynchronize", 990, 999, corr=7),           # the loop's lead
    ]
    sp = spans.reduce(events)
    assert sp["launches"] == {"pst.loop/pst.lead/pst.update": 1,
                              "pst.loop/pst.lead/pst.match": 1,
                              "pst.loop/pst.lead/pst.warp": 1}
    assert sp["syncs"] == {"pst.gate": 1, "pst.init/pst.init.decompose": 1,
                           "pst.loop/pst.lead": 1}
    ctx = {"spans": sp, "T": 1}
    assert _read("launches_per_lead", ctx) == 3
    assert _read("syncs_per_request", ctx) == 3
    assert _read("gate_ms", ctx) == pytest.approx(100e-6)


def test_per_request_and_lead_divides_by_both():
    events = [_span("bench.window", 0, 3000)] + _request(0) + _request(2000) + [
        _Ev("cudaLaunchKernel", 650, 651, corr=1), _kernel(700, 800, 1),
        _Ev("cudaLaunchKernel", 2650, 2651, corr=2), _kernel(2700, 2900, 2),
    ]
    sp = spans.reduce(events)
    assert sp["requests"] == 2
    ctx = {"spans": sp, "T": 3}
    assert _read("match_device_ms_per_lead", ctx) == pytest.approx(1e3 * 300e-9 / 6)
    assert _read("launches_per_lead", ctx) == pytest.approx(2 / 6)


def test_an_unpaired_kernel_is_unattributed():
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaLaunchKernel", 650, 651, corr=1), _kernel(700, 800, 1),
        _kernel(800, 900, 42),                       # no call holds id 42
        _kernel(1100, 1200, 43),                     # outside the window
    ]
    sp = spans.reduce(events)
    assert sp["unpaired"] == 1
    assert sp["forecast_device_s"] == pytest.approx(200e-9)
    assert sp["unattributed_s"] == pytest.approx(100e-9)
    assert spans.coverage(sp)["device_attributed"] == pytest.approx(0.5)
    summary = {"forecast_s_by_group": {"elementwise": 200e-9}}
    assert spans.coverage(sp, summary)["device_vs_trace"] == pytest.approx(0.5)


def test_a_kernel_launched_outside_the_spans_is_unattributed():
    events = [_span("bench.window", 0, 2000), _span("bench.forecast", 0, 1000),
              _span("pst.loop", 200, 1000),
              _Ev("cudaLaunchKernel", 100, 101, corr=1), _kernel(150, 300, 1),
              _Ev("cudaLaunchKernel", 1500, 1501, corr=2), _kernel(1500, 1600, 2)]
    sp = spans.reduce(events)
    assert sp["device_s"] == {}
    assert sp["forecast_device_s"] == pytest.approx(150e-9)   # the second is outside
    assert sp["unattributed_s"] == pytest.approx(150e-9)
    assert sp["unspanned_idle_s"] == pytest.approx(150e-9)   # 0-150 before pst.loop


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_without_the_spans(name):
    assert _read(name, {"spans": None, "T": 12}) is None
    # a traced run of a program without pst. spans
    events = [_span("bench.window", 0, 1000), _span("bench.forecast", 0, 1000),
              _Ev("cudaLaunchKernel", 10, 11, corr=1), _kernel(20, 30, 1)]
    assert _read(name, {"spans": spans.reduce(events), "T": 12}) is None
    assert spans.reduce(events[1:]) is None


class _Tracer:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _read_in_runner(names, events, summary):
    """Read ``names`` as ``runner.main`` does: from a frame that holds the
    run's ``tracer`` beside the readers' ``ctx``."""
    tracer = _Tracer(events)  # noqa: F841 (found by spans.of in this frame)
    ctx = {"T": 1, "trace": summary}
    return [_read(name, ctx) for name in names], ctx


def test_readers_reduce_the_runners_profiler_once(capsys):
    events = [_span("bench.window", 0, 1000)] + _request() + [
        _Ev("cudaLaunchKernel", 650, 660, corr=7), _kernel(720, 900, 7)]
    summary = {"forecast_s_by_group": {"elementwise": 180e-9}}
    values, ctx = _read_in_runner(("match_device_ms_per_lead", "gate_ms"), events, summary)
    assert values == [pytest.approx(180e-6), pytest.approx(100e-6)]
    assert ctx["spans"] == spans.reduce(events)
    err = capsys.readouterr().err
    assert err.count("benchmark: spans ") == 1 and '"device_vs_trace": 1.0' in err


@pytest.mark.parametrize("name", READERS)
def test_readers_return_none_in_an_untraced_run(name):
    events = [_span("bench.window", 0, 1000)] + _request()
    assert _read_in_runner((name,), events, None)[0] == [None]
    # and where no frame holds the run's profiler
    assert _read(name, {"T": 1, "trace": {"forecast_s_by_group": {}}}) is None
