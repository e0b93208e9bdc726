"""CPU tests of the benchmark's machinery: discovery by name, the window
arithmetic, the trace reduction, the kernels' byte counts and the import
check.  Run with ``python -m pytest benchmark -q``."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import imports, kernel_costs, runner, stats, trace

ROOT = Path(__file__).resolve().parent.parent
H100 = "NVIDIA H100 80GB HBM3"


# --- discovery by name -------------------------------------------------------

DUMMY_METRIC = '''"""A metric added as a file of its own: requests in the window."""


def read(ctx):
    return float(len(ctx["requests"]))
'''

DRIVE = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark.harness import runner
runner.SAMPLE_RANGES = ((0, 1),)  # a short CPU window: compare its first request
cfg = runner.load_cell("dummy_cell")[1]
ov = {{"config": {{"members": 2, "shape": [64, 72], "leads": 2,
                   "kwargs": dict(cfg["kwargs"], n_ens_members=2)}}}}
sys.exit(runner.main(["--workload", "dummy_cell", "--seed", "5", "--seconds", "0.5",
                      "--trace", "0"], device="cpu", overrides=ov))
"""


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_mix_and_metric_are_files_of_their_own(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files plus new entries in BENCHMARK.json are found by name and run,
    with no file of the benchmark edited."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "benchmark")

    cfg = json.loads((ROOT / "benchmark/configs/steps_mch_ccs4.json").read_text())
    cfg["name"] = "dummy_config"
    (tmp_path / "benchmark/configs/dummy_config.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/given_motion.json").read_text())
    mix["wet_fraction"] = [0.3, 0.4]
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/metrics/dummy_requests.py").write_text(DUMMY_METRIC)
    bench["configs"].append({"name": "dummy_config", "source": "https://example.org/dummy",
                             "file": "benchmark/configs/dummy_config.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_config",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_requests", "unit": "requests",
                                "better": "higher", "bound": 0.25, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", DRIVE.format(root=str(tmp_path))],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["dummy_requests"]["value"] == line["attempted"]
    assert "setup_s" in line["metrics"]
    after = {p: d for p, d in _digests(tmp_path / "benchmark").items() if p in before}
    assert after == before


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        runner.load_cell("no_such_cell")


def test_every_metric_and_mix_named_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(runner.metric_reader(m["name"]).read), m["name"]
    for w in bench["workloads"]:
        assert (ROOT / "benchmark/traffic" / f"{w['traffic']}.json").is_file()
        cfg = runner.load_cell(w["name"])[1]
        assert (ROOT / "benchmark/entries" / f"{cfg['entry']}.py").is_file()
        assert (ROOT / "benchmark/reference" / f"{cfg['entry']}.py").is_file()


# --- window arithmetic -------------------------------------------------------

def _window(latencies, gap=0.001):
    """(requests, window seconds) of a closed loop of these latencies."""
    return [{"latency_s": x} for x in latencies], sum(latencies) + gap * len(latencies)


def _read(name, ctx):
    from importlib import import_module

    return import_module(f"benchmark.metrics.{name}").read(ctx)


def test_rate_and_p90_of_a_window():
    reqs, window = _window([0.25] * 8)
    ctx = {"requests": reqs, "window_s": window, "E": 96, "T": 12}
    assert _read("member_frames_per_s", ctx) == pytest.approx(8 * 96 * 12 / window)
    assert _read("forecast_p90_s", ctx) == pytest.approx(0.25)
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90) == pytest.approx(9.1)
    assert stats.percentile([3.0], 90) == 3.0


def test_one_stall_moves_both_rate_and_p90():
    base_reqs, base_win = _window([0.25] * 8)
    stall_reqs, stall_win = _window([0.25] * 7 + [2.5])
    base = {"requests": base_reqs, "window_s": base_win, "E": 96, "T": 12}
    stall = {"requests": stall_reqs, "window_s": stall_win, "E": 96, "T": 12}
    assert _read("member_frames_per_s", stall) < 0.6 * _read("member_frames_per_s", base)
    assert _read("forecast_p90_s", stall) > 1.5 * _read("forecast_p90_s", base)


# --- trace reduction ---------------------------------------------------------

class _Ev:
    def __init__(self, name, start, end, device, user=False):
        self._n, self._s, self._e, self._d, self._u = name, start, end, device, user

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


def test_idle_share_is_the_union_of_overlapping_kernels():
    events = [
        _Ev("bench.window", 0, 1000, False, True),
        _Ev("aten::mul", 100, 150, False),
        _Ev("elementwise_kernel", 100, 400, True),
        _Ev("reduce_kernel", 300, 500, True),          # overlaps the first
        _Ev("void pst_chain_v_kernel<0>", 700, 800, True),
        _Ev("fft_kernel", 950, 1200, True),            # runs past the window
        _Ev("bench.window", 100, 900, True, True),     # the annotation on the device
    ]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((400 + 100 + 50) * 1e-9)  # 100-500, 700-800, 950-1000
    assert s["pst_device_s"] == pytest.approx(100e-9)
    assert s["device_s_by_group"]["elementwise"] == pytest.approx(300e-9)
    gaps = dict((round(d * 1e9), n) for n, d in s["idle_gaps"])
    assert sorted(gaps) == [100, 150, 200]  # 0-100, 800-950, 500-700
    ctx = {"trace": s}
    assert _read("device_idle_pct", ctx) == pytest.approx(100 * (1 - 550 / 1000))


def test_layer_groups_count_only_kernels_inside_the_forecast_calls():
    """Device time by group for the forecast's layers takes the kernels
    whose middle lies inside a ``bench.forecast`` span, and not those of
    other work in the window."""
    events = [
        _Ev("bench.window", 0, 1000, False, True),
        _Ev("bench.forecast", 100, 400, False, True),
        _Ev("bench.forecast", 600, 900, False, True),
        _Ev("bench.motion", 400, 600, False, True),
        _Ev("DeviceRadixSortOnesweepKernel", 150, 250, True),
        _Ev("DeviceRadixSortOnesweepKernel", 450, 550, True),  # the motion's sort
        _Ev("regular_fft_factor", 650, 700, True),
        _Ev("elementwise_kernel", 380, 440, True),  # its middle, 410, is outside
    ]
    s = trace.summarize(events)
    assert s["device_s_by_group"]["sort"] == pytest.approx(200e-9)
    assert s["forecast_s_by_group"]["sort"] == pytest.approx(100e-9)
    assert s["forecast_s_by_group"]["fft"] == pytest.approx(50e-9)
    assert "elementwise" not in s["forecast_s_by_group"]
    ctx = {"trace": s, "traced_requests": 2, "T": 5}
    assert _read("sort_device_ms_per_lead", ctx) == pytest.approx(1e3 * 100e-9 / 10)
    assert _read("fft_device_ms_per_lead", ctx) == pytest.approx(1e3 * 50e-9 / 10)
    assert _read("aten_device_ms_per_lead", ctx) == pytest.approx(0.0)


def test_gap_is_named_by_the_innermost_host_event():
    events = [_Ev("bench.window", 0, 1000, False, True),
              _Ev("bench.forecast", 0, 1000, False, True),
              _Ev("aten::sort", 200, 800, False),
              _Ev("k", 0, 100, True), _Ev("k", 900, 1000, True)]
    s = trace.summarize(events)
    assert s["idle_gaps"][0][0] == "aten::sort"


# --- kernel byte counts ------------------------------------------------------

# PERF.md's kernel table: (entry, launch arguments at its "Timed at" shapes,
# the bound column in ms)
TABLE = [
    ("pst_resample", (0, 0, 0, 0, 192, 2, 128, 128, 12, 0), 0.01127),
    ("pst_warp", (0, 0, 0, 0, 0, 32, 1024, 1024, 48, 0.0, 1, 0, 0, 0, 0), 0.20032),
    ("pst_warp", (0, 0, 0, 0, 0, 96, 320, 320, 48, 0.0, 1, 0, 0, 0, 0), 0.05869),
    ("pst_pwl_gather", (0, 0, 0, 0, 0, 32, 1048576), 0.08015),
    ("pst_rim", (0, 0, 0.0, 0, 0, 0, 32, 1024, 1024, 2, 10), 0.08013),
    ("pst_rim", (0, 0, 0.0, 0, 0, 0, 96, 320, 320, 2, 10), 0.02348),
    ("pst_rim", (0, 1, 0.0, 1, 0, 0, 1, 512, 512, 2, 10), 0.00039),
    ("pst_chain_v", (0,) * 7 + (96, 512, 512, 48, 2, 10, -10.0, 1), 0.12024),
    ("pst_chain_h", (0, 0, 0, 96, 512, 512, 48, 0.0), 0.12019),
    ("pst_pwl_hier", (0, 0, 0, 0, 0, 96, 102400), 0.02361),
    ("pst_pwl_flat", (0, 0, 0, 0, 0, 96, 262144), 0.06023),
    ("pst_cdf_counts", (0, 0, 0, 0, 96, 262144), 0.03008),
]


@pytest.mark.parametrize("entry,args,bound_ms", TABLE,
                         ids=[f"{e}-{i}" for i, (e, _, _) in enumerate(TABLE)])
def test_kernel_bytes_give_the_table_bound(entry, args, bound_ms):
    seconds, by = kernel_costs.least_seconds(entry, args, H100)
    assert by == "bytes"
    assert round(seconds * 1e3, 5) == pytest.approx(bound_ms, abs=1.01e-5)


def test_roofline_reads_least_over_device_time():
    args = (0, 0, 0, 96, 512, 512, 48, 0.0)
    least = kernel_costs.least_seconds("pst_chain_h", args, H100)[0]
    ctx = {"trace": {"pst_device_s": 2 * least}, "launches": [("pst_chain_h", args)],
           "device_name": H100}
    assert _read("pst_kernels_roofline", ctx) == pytest.approx(50.0)
    assert _read("pst_kernels_roofline", {"trace": None, "launches": [],
                                           "device_name": H100}) is None


# --- imports -----------------------------------------------------------------

def test_import_check_compares_whole_top_level_names():
    assert imports.forbidden_loaded(["pysteps_tpu_torch", "pysteps_tpu_torch.ops",
                                     "numpy", "jaxtyping_free"]) == []
    assert imports.forbidden_loaded(["pysteps_tpu.nowcasts", "jax.numpy", "flax",
                                     "jaxlib"]) == ["flax", "jax", "jaxlib", "pysteps_tpu"]


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_file_imports_jax_and_the_reference_none_of_the_port():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = _imported_tops(path)
        assert not tops & set(imports.FORBIDDEN), path
        if "reference" in path.relative_to(ROOT).parts:
            assert "pysteps_tpu_torch" not in tops, path


# --- the form of BENCHMARK.json ---------------------------------------------

NAME = r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}"


def test_benchmark_json_keeps_its_form():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for name in names:
        assert re.fullmatch(NAME, name), name
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["why"]) <= 200
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in metrics:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {m["moves"] for m in bench["per_layer"]}
    assert layers <= {m["name"] for m in bench["end_to_end"]}


# --- the compared numbers ----------------------------------------------------

def test_field_gap_catches_one_moved_member_and_p75_a_moved_lead():
    import torch

    from benchmark.harness import compare

    ref = torch.linspace(-15.0, 25.0, 8 * 3 * 40 * 50).reshape(8, 3, 40, 50)
    span, cap = 40.0, compare.CAP
    out = ref.clone()
    out[0, 1] += 0.4  # one member at one lead: the worst field, under the 75th percentile
    nums = compare.field_numbers(out, ref)
    assert nums["member_p75_gap"] == 0.0
    assert nums["field_gap"] == pytest.approx(min(0.4 / span, cap), rel=1e-4)
    assert nums["uncapped_field_gap"] == pytest.approx(0.4 / span, rel=1e-4)
    assert nums["worst"] == "member 0 lead 2" and nums["fields_over_1e-5"] == 1
    out = ref.clone()
    out[3, 0, 7, :10] -= 4.5  # ten pixels across a dry/wet jump: each weighs the cap
    nums = compare.field_numbers(out, ref)
    assert nums["field_gap"] == pytest.approx(10 * cap / 2000, rel=1e-4)
    assert nums["uncapped_field_gap"] == pytest.approx(10 * 4.5 / span / 2000, rel=1e-4)
    assert nums["pixels_over_cap"] == 10
    out = ref.clone()
    out[:, 2] += 0.05  # every member at the last lead, under the cap
    nums = compare.field_numbers(out, ref)
    assert nums["member_p75_gap"] == pytest.approx(0.05 / span, rel=1e-3)
    assert nums["fields_over_1e-5"] == 8
    out = ref.clone()
    out[4:] = out[:4].mean(dim=0, keepdim=True)  # half the members left out
    assert compare.field_numbers(out, ref)["member_p75_gap"] > 1e-3
    out = ref.clone()
    ref[:, 1, :, :20] = float("nan")  # outside the domain on both sides: not counted
    out[:, 1, :, :20] = float("nan")
    out[:, 1, :, 20:25] = float("nan")  # finite on one side only: the cap
    nums = compare.field_numbers(out, ref)
    assert nums["member_p75_gap"] == pytest.approx(200 * cap / 1200)
    assert nums["field_gap"] == pytest.approx(200 * cap / 1200)
    assert nums["one_side_pixels"] == 8 * 200
    assert compare.field_numbers(out[:, :2], ref)["field_gap"] == float("inf")
