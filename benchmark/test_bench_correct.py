"""CPU tests of what decides ``correct``: the plain reference against the
port at a small size, the bfloat16 control that has to fail, and runs of
the harness with the timed path broken underneath, each of which has to
come out not correct.  The card test runs the cell briefly on the card.

On the CPU the port samples by the joint bilinear gather, which the
reference then takes too; the separable sampling that both take on the
card is held here stage by stage against the port's plain versions of
its kernels."""

import json

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.harness import runner
from benchmark.reference import steps_blending as ref_blend
from benchmark.reference import steps_nowcast as ref

CELL = "steps24_ccs4"
CELLS = ("steps24_ccs4", "blend24_ccs4")


def small(cell=CELL):
    """Overrides that run ``cell`` at 2 members x 64 x 72 x 3 leads."""
    cfg = runner.load_cell(cell)[1]
    return {"config": {"members": 2, "shape": [64, 72], "leads": 3,
                       "kwargs": dict(cfg["kwargs"], n_ens_members=2)}}


@pytest.fixture
def one_sample(monkeypatch):
    """Compare the window's first request only (a CPU window is short)."""
    monkeypatch.setattr(runner, "SAMPLE_RANGES", ((0, 1),))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_holds_the_port_and_the_control_fails(cell, one_sample):
    rows = calibrate.readings(cell, [11, 13], [12], device="cpu", overrides=small(cell))
    limits = runner.load_cell(cell)[1]["limits"]
    sound = [r for r in rows if r["kind"] == "sound"]
    control = [r for r in rows if r["kind"] == "control"]
    assert len(sound) == 2 and control
    for key, limit in limits.items():
        assert all(r[key] <= limit for r in sound), (key, sound)
    assert all(any(r[key] > limit for key, limit in limits.items()) for r in control), control


def _field(seed, shape=(3, 150, 170)):
    g = torch.Generator().manual_seed(seed)
    return 30.0 * torch.rand(shape, generator=g) - 15.0


def _flow(seed, lead=(3,), shape=(150, 170), scale=30.0):
    g = torch.Generator().manual_seed(seed)
    return scale * (torch.rand(lead + (2,) + shape, generator=g) - 0.5)


def test_separable_sampling_is_the_ports_shift_warp():
    """The reference's card sampling (column resample, then row resample,
    each source held within 48 pixels) against the port's plain K1 path,
    with displacements past the bound."""
    from pysteps_tpu_torch.ops.warp import warp_shifted, warp_shifted_multi

    f, d = _field(1), _flow(2, scale=120.0)
    mine = ref.sample(f.double(), d.double(), 48, fill=float("nan"))
    port = warp_shifted(f, d, 48, cval=float("nan"))
    assert torch.equal(torch.isnan(mine), torch.isnan(port))
    ok = ~torch.isnan(port)
    assert torch.allclose(mine[ok], port[ok].double(), atol=1e-3)  # f32 positions
    v = _flow(3, lead=(), scale=8.0)
    mine = torch.stack([ref.sample(v[c].double(), d.double(), 48) for c in range(2)], dim=1)
    port = warp_shifted_multi(v, d, 48, mode="nearest")
    assert torch.allclose(mine, port.double(), atol=5e-4)


def test_buffered_rain_is_the_ports_rim():
    from pysteps_tpu_torch.ops.pallas_dilate import dilated_rim_from_field

    f = _field(4)
    assert torch.equal(ref.buffered_rain(f >= 10.0, 2, 10).float(),
                       dilated_rim_from_field(f, 10.0, 2, 10))


def test_cdf_match_is_the_ports_packed_sort():
    from pysteps_tpu_torch.postprocessing.probmatching import (
        _match_cdf_presorted,
        _prepare_cdf_target,
    )

    f, target = _field(5), _field(6)[0]
    f[:, :40] = f.amin(dim=(-2, -1), keepdim=True)  # a dry plateau at each minimum
    target[100:] = -15.0
    ranked, zvalue = _prepare_cdf_target(target)
    port = _match_cdf_presorted(f, ranked, zvalue)
    diff = (ref.cdf_match(f.double(), target.double()) - port.double()).abs()
    # a pixel whose quantized value rounds the other way moves by a rank or two
    assert (diff > 1e-4).double().mean() < 1e-2 and diff.max() < 0.05


def test_blend_pieces_are_the_ports():
    """The blending reference's white spectra, skill weights and exact
    match against the port's."""
    from pysteps_tpu_torch.blending.steps import _match_cdf_targets, calculate_weights_bps
    from pysteps_tpu_torch.noise.fftgenerators import _spectral_white

    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    for n in (170, 171):
        W = ref_blend.white_spectra(g1, 2, 150, n)
        assert torch.allclose(W, _spectral_white(g2, (150, n), 2).to(W.dtype), rtol=1e-6,
                              atol=1e-3)
    corr = np.array([[0.99, 0.9, 0.5, 0.1, 1e-6, -0.2], [0.8, 0.7, 0.3, 0.2, 0.05, 0.01]])
    assert np.allclose(ref_blend.skill_weights(*corr), calculate_weights_bps(corr))
    f, target = _field(8), _field(9)
    f[:, :30] = f.amin(dim=(-2, -1), keepdim=True)
    target[:, 120:] = -15.0
    port = _match_cdf_targets(f, target.reshape(3, -1))
    mine = ref_blend.exact_match(f.double(), target.reshape(3, -1).double())
    assert torch.equal(mine.float(), port)
    with pytest.raises(NotImplementedError):
        ref_blend.card_bound("cuda", 2.0, 12, 5.0, 12.0, 512, 512)
    assert ref_blend.card_bound("cuda", 2.0, 12, 5.0, 12.0, 640, 710) == 48
    assert ref_blend.card_bound("cpu", 2.0, 12, 5.0, 12.0, 640, 710) is None


def run_cell(capsys, seconds="1", cell=CELL):
    """The result line of a CPU run of ``cell`` at the small size."""
    rc = runner.main(["--workload", cell, "--seed", "2200000007", "--seconds", seconds,
                      "--trace", "0"], device="cpu", overrides=small(cell))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, capsys, one_sample):
    line = run_cell(capsys, cell=cell)
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def _broken_scan(scan, how):
    """``scan`` (the port's loop) with its output broken where it is
    produced: ``half`` leaves out the second half of the members and puts
    the mean of the rest in their place, ``answer`` alters the last lead
    (every member's field), ``member`` one member's field at one lead by
    0.4 dB."""

    def wrapped(*args, **kwargs):
        out = scan(*args, **kwargs)
        E = out.shape[0]
        if how == "half":
            out[E // 2:] = out[: E // 2].mean(dim=0, keepdim=True)
        elif how == "answer":
            out[:, -1] += 1.0
        else:
            out[E - 1, 1] += 0.4
        return out

    return wrapped


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered",
                                   "one_member_altered"])
def test_broken_timed_path_is_not_correct(cell, fault, capsys, one_sample, monkeypatch):
    """A step that returns its state unchanged, half of the members left
    out (the mean of the rest in their place), the last lead's answer
    altered, one member's field altered at one lead: each makes
    ``correct`` false.  (One card: no exchange between chips to leave
    out.)"""
    if cell == CELL:
        from pysteps_tpu_torch.nowcasts import steps as mod

        scan = "_steps_scan"
    else:
        from pysteps_tpu_torch.blending import steps as mod

        scan = "_blending_scan"
    if fault == "state_unchanged":
        monkeypatch.setattr(mod, "_ar_step_lags", lambda lags, phi, eps=None: lags)
    else:
        how = {"half_batch": "half", "answer_altered": "answer"}.get(fault, "member")
        monkeypatch.setattr(mod, scan, _broken_scan(getattr(mod, scan), how))
    line = run_cell(capsys, cell=cell)
    assert line["correct"] is False, line["checks"]


def test_reference_refuses_the_paths_it_does_not_follow():
    with pytest.raises(NotImplementedError):
        ref.card_path("cuda", 512, 512)  # the 4x coarse displacement
    with pytest.raises(NotImplementedError):
        ref.card_path("cuda", 150, 512)  # the piecewise-linear match
    with pytest.raises(NotImplementedError):
        ref.card_path("cuda", 64, 72)  # the bound from the flow's speed
    assert ref.card_path("cuda", 640, 710) == 48 and ref.card_path("cpu", 640, 710) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_on_the_card_is_correct(cell, card, capsys):
    rc = runner.main(["--workload", cell, "--seed", "2200000009", "--seconds", "20",
                      "--trace", "1"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err[-3000:]
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["correct"] is True, captured.err[-3000:]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    metrics = {k.split(".")[0]: v["value"] for k, v in line["metrics"].items()}
    assert metrics["pst_kernels_roofline"] <= 100.0
    assert metrics["sort_device_ms_per_lead"] > 0
