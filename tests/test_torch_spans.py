"""The port's spans (``utils/profiling.py::annotate``) in the STEPS nowcast
and STEPS blending forecasts, on the CPU: every span the forecasts name,
nested as stated, one ``pst.lead`` a lead and member chunk; no
``record_function`` while no profiler records; the same output with and
without a profiler; ``pst.init`` and ``pst.loop`` over the intervals that
``measure_time`` reports."""

import glob
import json

import numpy as np
import pytest
import torch

from helpers import make_synthetic_sequence
from pysteps_tpu_torch import blending, nowcasts
from pysteps_tpu_torch.utils import profiling

E, SHAPE, T, CHUNK = 2, (64, 72), 3, 1

INIT = {
    "steps": {"filter", "align", "decompose", "mask", "bps", "noise"},
    "blending": {"norain", "filter", "align", "decompose", "copy", "nwp_decompose", "rho0",
                 "skill", "velocity", "noise", "mask", "bps", "presort"},
}
LEAD = {"pst.update", "pst.mask", "pst.match", "pst.warp", "pst.write"}


@pytest.fixture(scope="module")
def inputs():
    f = make_synthetic_sequence(n_frames=3, shape=SHAPE, velocity=(1.7, 0.6), seed=3)
    db = np.where(f >= 0.1, 10 * np.log10(np.maximum(f, 0.1)), -15.0).astype(np.float32)
    v = np.zeros((2,) + SHAPE, np.float32)
    v[0], v[1] = 1.7, 0.6
    rng = np.random.default_rng(4)
    nwp = (db[-1] + 0.3 * rng.standard_normal((T + 1,) + SHAPE)).astype(np.float32)
    return db, v, nwp[None]


def run(kind, inputs, skill_dir, **kw):
    db, v, nwp = inputs
    common = dict(n_ens_members=E, n_cascade_levels=4, precip_thr=-10.0, kmperpixel=1.0,
                  seed=7, member_chunk=CHUNK, device="cpu")
    common.update(kw)
    if kind == "steps":
        return nowcasts.get_method("steps")(db, v, T, timestep=5, **common)
    return blending.get_method("steps")(db, nwp, v, v[None], T, 5, noise_method="nonparametric",
                                        vel_pert_method="bps", outdir_path_skill=skill_dir,
                                        **common)


def traced(kind, inputs, skill_dir, logdir, **kw):
    """(the forecast's result, its ``pst.`` spans [(name, start us, end us)])
    from a run under ``profiling.trace``."""
    with profiling.trace(str(logdir), host=True):
        res = run(kind, inputs, skill_dir, **kw)
    (path,) = glob.glob(str(logdir / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and str(e.get("name", "")).startswith("pst.")]
    return res, spans


def inside(child, parents):
    return any(p[1] <= child[1] + 1 and child[2] <= p[2] + 1 for p in parents)


@pytest.fixture(scope="module")
def skill_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("skill"))


@pytest.fixture(scope="module", params=["steps", "blending"])
def timed(request, inputs, skill_dir, tmp_path_factory):
    """(kind, (out, init s, loop s), spans) of a traced run with
    ``measure_time``."""
    res, spans = traced(request.param, inputs, skill_dir,
                        tmp_path_factory.mktemp("trace"), measure_time=True)
    return request.param, res, spans


def test_every_span_is_emitted_and_nested(timed):
    kind, _, spans = timed
    by = {}
    for sp in spans:
        by.setdefault(sp[0], []).append(sp)
    stages = {name.split(".", 2)[2] for name in by if name.startswith("pst.init.")}
    assert stages == INIT[kind]
    assert {"pst.gate", "pst.init", "pst.loop", "pst.lead"} | LEAD <= set(by)
    assert len(by["pst.init"]) == len(by["pst.loop"]) == 1
    assert len(by["pst.lead"]) == T * (E // CHUNK)
    assert by["pst.gate"][-1][2] <= by["pst.init"][0][1] + 1
    assert by["pst.init"][0][2] <= by["pst.loop"][0][1] + 1
    for name, items in by.items():
        parents = (by["pst.init"] if name.startswith("pst.init.")
                   else by["pst.loop"] if name == "pst.lead"
                   else by["pst.lead"] if name in LEAD else None)
        if parents is not None:
            assert all(inside(sp, parents) for sp in items), name
    for lead in by["pst.lead"]:
        assert {n for n, s, e in spans if inside((n, s, e), [lead])} >= LEAD


def test_spans_cover_measure_times_intervals(timed):
    _, (_, init_s, loop_s), spans = timed
    for name, secs in (("pst.init", init_s), ("pst.loop", loop_s)):
        (sp,) = [s for s in spans if s[0] == name]
        assert abs((sp[2] - sp[1]) * 1e-6 - secs) <= max(0.05 * secs, 2e-3), name


@pytest.mark.parametrize("kind", ["steps", "blending"])
def test_output_is_the_same_with_and_without_a_profiler(kind, inputs, skill_dir, tmp_path):
    plain = run(kind, inputs, skill_dir)
    under, _ = traced(kind, inputs, skill_dir, tmp_path)
    assert torch.equal(torch.nan_to_num(plain, nan=-1e9), torch.nan_to_num(under, nan=-1e9))


@pytest.mark.parametrize("kind", ["steps", "blending"])
def test_no_record_function_while_no_profiler_records(kind, inputs, skill_dir, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    out = run(kind, inputs, skill_dir)
    assert out.shape == (E, T) + SHAPE


def test_annotate_hands_out_one_shared_noop_while_off(tmp_path):
    assert profiling.annotate("pst.a") is profiling.annotate("pst.b")
    with profiling.trace(str(tmp_path), host=True):
        on = profiling.annotate("pst.a")
        assert isinstance(on, torch.profiler.record_function)
        with on:
            pass


@pytest.mark.parametrize("kind", ["steps", "blending"])
def test_streamed_frames_have_their_span(kind, inputs, skill_dir, tmp_path):
    frames = []
    out, spans = traced(kind, inputs, skill_dir, tmp_path, callback=frames.append,
                        return_output=False, member_chunk=None)
    assert out is None and len(frames) == T
    streams = [s for s in spans if s[0] == "pst.stream"]
    assert streams and all(inside(s, [l for l in spans if l[0] == "pst.loop"])
                           for s in streams)
