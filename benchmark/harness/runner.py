"""One run of one cell: set-up, the measured window, the metrics, the
comparison with the plain reference and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's name is looked up in ``BENCHMARK.json``; its configuration file
(``configs``' ``file``), its traffic file (``benchmark/traffic/<name>.json``),
its entry (``benchmark/entries/<entry>.py`` and the plain reference
``benchmark/reference/<entry>.py``, the entry named by the configuration)
and each metric's reader (``benchmark/metrics/<name>.py``, or for
``<name>.<suffix>`` the reader of ``<name>``) are found by name, so that
a new cell, mix or metric is a new file and a new entry.

The traffic is a closed loop with one client: requests run back to back,
each from its host inputs to its output ready on the card.  Set-up (from
the process's start) makes the request pool from the seed, loads the
kernels (built into ``build/`` inside the checkout on a first run) and
runs two warm-up requests at the cell's shapes.  With ``--trace 1`` the
window runs with the port's ``measure_time`` on, its first requests under
``torch.profiler``, and the per-layer metrics are reported; otherwise the
end-to-end ones.
After the window, the outputs of two requests drawn from the seed
(copied to host memory as they finished) are held against the plain
reference run on the same inputs and seeds.
"""

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

from benchmark.harness import compare, imports, trace, traffic as traffic_mod

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")
CACHE_DIR = os.path.join(ROOT, "build", "benchmark_cache")
WARM_UPS = 2
# the requests at the start of a --trace 1 window that run under the profiler
TRACED_REQUESTS = 16
# the requests whose outputs are compared: one drawn from each range
SAMPLE_RANGES = ((0, 4), (4, 8))
_T_IMPORT = time.time()


def process_age_s():
    """Seconds since this process started (``/proc``), or since this module
    was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - _T_IMPORT


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, bench=None):
    """(cell, configuration, traffic, benchmark) of the cell ``name``."""
    bench = bench or load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic", cell["traffic"] + ".json"))
    return cell, config, traffic, bench


def cell_metrics(bench, cell, traced):
    """The metric entries this cell reports in a run (per-layer ones when
    traced)."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]


def metric_reader(name):
    """The reader module of metric ``name``: ``benchmark/metrics/<name>.py``,
    or for a name with a cell-group suffix (``host_ms.cycle``), where that
    file is absent, the reader of the name before the first dot."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        path = os.path.join(BENCH_DIR, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def power_limit():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def parse_args(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Cell:
    """A cell's program and reference on ``device``, driven request by
    request from its pool."""

    def __init__(self, config, traffic, seed, device, torch):
        self.config, self.traffic, self.torch = config, traffic, torch
        self.device = torch.device(device)
        self.entry = importlib.import_module(f"benchmark.entries.{config['entry']}")
        self.pool = traffic_mod.make_pool(traffic, config, seed)
        rng = np.random.default_rng([int(seed), 0xBE7C])
        self.seed_base = int(rng.integers(2**20, 2**31 - 2**20))
        self.samples = sorted({int(rng.integers(lo, hi)) for lo, hi in SAMPLE_RANGES})
        self.span = contextlib.nullcontext

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def request(self, i, measure_time=False, control=False):
        """Request ``i`` of the loop (negative: a warm-up): (output, its
        times).  ``control`` runs the control of ``correct`` instead: the
        program with its outputs in bfloat16 (the forecast's
        ``output_dtype``)."""
        req = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        with self.span("bench.forecast"):
            out, init_s, loop_s = self.entry.program(
                req, self.config, self.seed_base + i, self.device,
                measure_time=measure_time, output_dtype="bfloat16" if control else "float32")
            self.sync()
        t1 = time.perf_counter()
        times = {"latency_s": t1 - t0, "init_s": init_s, "loop_s": loop_s}
        return out, times

    def numbers(self, i, out):
        """The compared numbers of request ``i``'s output, held on the host,
        against the plain reference's on the same inputs and seed."""
        req = self.pool[i % len(self.pool)]
        ref = importlib.import_module(f"benchmark.reference.{self.config['entry']}")
        ref_out = ref.forecast(req, self.config, self.seed_base + i, self.device)
        return compare.field_numbers(out.to(self.device), ref_out)

    def limits(self):
        return dict(self.config["limits"])


class Tracer:
    """The traced part of a ``--trace 1`` window: the profiler (host and
    device activity) and the record of the hand-written kernels' launches
    over the window's first :data:`TRACED_REQUESTS` requests, inside one
    ``bench.window`` span.  The rest of the window runs untraced, so that
    the trace stays small enough to read within the run's time."""

    def __init__(self, torch, kernels, on_card):
        from torch.profiler import ProfilerActivity, profile, record_function

        self.record_function = record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self.prof = profile(activities=acts)
        self.recorder = trace.LaunchRecorder(kernels)
        self.requests = 0
        self._span = None

    def start(self):
        self.prof.start()
        self.recorder.__enter__()
        self._span = self.record_function(trace.WINDOW_SPAN)
        self._span.__enter__()

    def stop(self, requests):
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        self._span = None
        self.recorder.__exit__(None, None, None)
        self.prof.stop()
        self.requests = requests

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _phase(name, t0):
    """Print a set-up phase's end to stderr; returns the time."""
    t = time.time()
    print(f"benchmark: {name} done at process age {process_age_s():.2f} s "
          f"({t - t0:.2f} s)", file=sys.stderr, flush=True)
    return t


def main(argv=None, device=None, overrides=None):
    """Run a cell once and print its result line; returns the exit code.
    ``device`` None looks for the card (and fails without one); tests pass
    "cpu", and ``overrides`` (a dict with "config" and "traffic" updates)
    to run the rest of a run at a small size."""
    args = parse_args(argv)
    cell, config, traffic, bench = load_cell(args.workload)
    if overrides:
        config = {**config, **overrides.get("config", {})}
        traffic = {**traffic, **overrides.get("traffic", {})}
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
    on_card = torch.device(device).type == "cuda"
    E, T = int(config["members"]), int(config["leads"])

    # the port prints progress on stdout, which carries the result line
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        t = _phase("imports", time.time())
        run = Cell(config, traffic, args.seed, device, torch)
        from pysteps_tpu_torch.ops import _kernels

        t = _phase("request pool", t)
        for k in range(WARM_UPS):
            out = run.request(-1 - k, measure_time=bool(args.trace))[0]
            if k == 0:
                # host buffers for the compared requests' outputs, pinned so
                # that the copy in the window is one fast transfer
                buffers = {i: torch.empty(out.shape, dtype=out.dtype, pin_memory=on_card)
                           for i in run.samples}
            del out
            t = _phase(f"warm-up {k + 1}", t)
        records, failed, done_ids = [], 0, []  # done_ids: the compared requests that finished
        tracer = Tracer(torch, _kernels, on_card) if args.trace else None
        if tracer:
            run.span = tracer.record_function
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = process_age_s()
        t_w0 = time.perf_counter()
        t_end = t_w0
        i = 0
        while True:
            if tracer and i == 0:
                tracer.start()
            try:
                out, times = run.request(i, measure_time=bool(args.trace))
                t_end = time.perf_counter()
                records.append(times)
                if i in buffers:
                    buffers[i].copy_(out)
                    done_ids.append(i)
                del out
            except Exception:  # a failed request counts, and the loop goes on
                failed += 1
                t_end = time.perf_counter()
                print(f"benchmark: request {i} failed:\n{traceback.format_exc()}",
                      file=sys.stderr)
            i += 1
            done = time.perf_counter() - t_w0 >= args.seconds
            if tracer and (i == TRACED_REQUESTS or done):
                tracer.stop(i)
            if done:
                break
        window_s = t_end - t_w0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        summary = None
        if tracer and on_card:
            t = time.time()
            summary = trace.summarize(tracer.events())
            _phase("trace reduction", t)
        ctx = {"E": E, "T": T, "requests": records, "window_s": window_s,
               "setup_s": setup_s, "peak_bytes": peak, "trace": summary,
               "traced_requests": tracer.requests if tracer else 0,
               "launches": tracer.recorder.launches if tracer else [],
               "device_name": torch.cuda.get_device_name(0) if on_card else "cpu"}
        metrics = {}
        for m in cell_metrics(bench, cell, bool(args.trace)):
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del tracer, ctx

        # the comparison, once the window's state is freed
        if on_card:
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        found, limits = {}, run.limits()
        t = _phase("window", time.time())
        for i in done_ids:
            nums = run.numbers(i, buffers[i])
            print(f"benchmark: request {i}: {nums}", file=sys.stderr)
            for key, value in nums.items():
                if key in limits:
                    found[key] = max(found.get(key, value), value)
        del buffers
        t = _phase("comparison", t)
    # a number that was not read (no request compared) or is not finite
    # is null, and fails
    checks = {key: {"value": found[key] if np.isfinite(found.get(key, np.nan)) else None,
                    "limit": lim} for key, lim in limits.items()}
    print(f"benchmark: {len(done_ids)} request(s) compared, {failed} failed", file=sys.stderr)
    correct = (failed == 0 and len(done_ids) >= 1
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))

    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"benchmark: forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
                "power_limit": power_limit() if on_card else "not measured"}
    result = {"correct": bool(correct), "attempted": len(records) + failed, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    for key, c in checks.items():
        print(f"check {key}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
