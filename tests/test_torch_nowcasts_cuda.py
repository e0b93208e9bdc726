"""The nowcasts beside STEPS (extrapolation, lagrangian_probability,
S-PROG, ANVIL, SSEPS) and STEPS' streaming callback on the card, against
the same functions on the CPU, at 256^2 with 3 leads, with the kernel
launch counts of their paths (I-M and S of ``chip_smoke.py``).

Tolerances, with identical NaN sets: extrapolation and the ANVIL loop
from one init (kernel K1 against the CPU's exact gather) 1e-4 x span;
probabilities 1e-4 at 99.9% of the pixels and 1e-4 on average (cuFFT
rounds the window sums otherwise than the CPU's FFT, by about 1e-7 of
the largest sum, which is more where few valid pixels share a window);
S-PROG and SSEPS, with the card's path run on the
CPU through the plain versions (and SSEPS on the same white draws), 99.9%
of the pixels within 1e-3 x span and 1e-4 x span on average (the STEPS
card-vs-CPU rule: a rank tie of the window matches' sort may move a pixel
to a neighbouring quantile); the streamed STEPS frames 1e-5 of the full
run's.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_nowcasts_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu_torch import cascade, nowcasts  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators  # noqa: E402
from pysteps_tpu_torch.nowcasts import anvil, sprog, sseps  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402

pytestmark = pytest.mark.cuda

SIDE, T = 256, 3
META = {"accutime": 5, "threshold": -10.0, "xpixelsize": 1000.0}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs():
    rain = make_synthetic_sequence(n_frames=4, shape=(SIDE, SIDE), velocity=(2.0, 1.0),
                                   seed=42).astype(np.float32)
    db = np.where(rain >= 0.1, 10.0 * np.log10(np.maximum(rain, 0.1)), -15.0)
    vel = np.zeros((2, SIDE, SIDE), np.float32)
    vel[0], vel[1] = 2.0, 1.0
    return rain, db.astype(np.float32)[-3:], vel


def _held(card, cpu, rel, of_span=True, frac=None):
    torch.cuda.synchronize()
    c = card.detach().cpu().double().numpy()
    r = cpu.detach().cpu().double().numpy()
    assert c.shape == r.shape
    assert np.array_equal(np.isnan(c), np.isnan(r))
    scale = float(np.nanmax(r) - np.nanmin(r)) if of_span else 1.0
    diff = np.abs(np.nan_to_num(c) - np.nan_to_num(r))
    if frac is None:
        assert diff.max() <= rel * scale, diff.max() / scale
    else:
        assert (diff <= rel * scale).mean() >= frac
        assert diff.mean() <= 1e-4 * scale


def _launches(run, expected):
    _kernels.reset_launches()
    out = run()
    torch.cuda.synchronize()
    got = dict(_kernels.LAUNCHES)
    assert got == dict(dict.fromkeys(got, 0), **expected)
    return out


@pytest.mark.parametrize("order", [0, 1, 3])
def test_extrapolation_card_vs_cpu(dev, order):
    _, db, vel = _inputs()
    f = nowcasts.get_method("extrapolation")
    kw = dict(extrap_kwargs={"interp_order": order})
    k1 = 3 * T if order == 1 else 0  # orders 0 and 3 gather exactly on the card too
    out = _launches(lambda: f(torch.tensor(db[-1], device=dev), torch.tensor(vel, device=dev),
                              T, **kw), {"resample_axis0": k1, "resample_axis1": k1})
    assert out.device.type == "cuda"
    _held(out, f(db[-1], vel, T, device="cpu", **kw), 1e-4)


def test_lagrangian_probability_card_vs_cpu(dev):
    rain, _, vel = _inputs()
    f = nowcasts.get_method("lagrangian_probability")
    out = _launches(lambda: f(rain[2], vel, T, 1.0, slope=2, device=dev),
                    {"resample_axis0": 3 * T, "resample_axis1": 3 * T})
    _held(out, f(rain[2], vel, T, 1.0, slope=2, device="cpu"), 1e-4, of_span=False,
          frac=0.999)


def test_sprog_card_vs_cpu_on_the_card_path(dev, monkeypatch):
    _, db, vel = _inputs()
    f = nowcasts.get_method("sprog")
    kw = dict(n_cascade_levels=8, precip_thr=-10.0)
    k1 = 2 * 2 + 1 + 3 * T  # the init's 2 unit steps and warp, then 3 a lead
    out = _launches(lambda: f(db, vel, T, device=dev, **kw),
                    {"resample_axis0": k1, "resample_axis1": k1, "pwl_gather": T})
    path = sprog._scan_path(dev, (SIDE, SIDE), torch.tensor(vel), T)
    assert path == (48, 48, True)
    monkeypatch.setattr(sprog, "_scan_path", lambda *a: path)
    _held(out, f(db, vel, T, device="cpu", **kw), 1e-3, frac=0.999)


def test_anvil_card_vs_cpu(dev):
    rain, _, vel = _inputs()
    f = nowcasts.get_method("anvil")
    max_disp = int(np.ceil(T * 2.5)) + 2
    _launches(lambda: f(rain, vel, T, n_cascade_levels=8, device=dev),
              {"resample_axis0": 3 * T, "resample_axis1": 3 * T})
    w = torch.tensor(cascade.get_method("gaussian")((SIDE, SIDE), 8)["weights_2d"],
                     dtype=torch.float32)
    init = anvil._anvil_init(torch.tensor(rain), torch.tensor(vel), w,
                             torch.ones((SIDE, SIDE), dtype=torch.bool), 2, 50, 1, 1)
    zeros = torch.zeros((SIDE, SIDE))
    dom = zeros.bool()
    args = (init[0], torch.tensor(vel), init[1], init[2], init[3], zeros, zeros, dom)
    card = anvil._anvil_scan(*[x.to(dev) for x in args], T, False, True, 1, 1,
                             max_disp=max_disp)
    _held(card, anvil._anvil_scan(*args, T, False, True, 1, 1), 1e-4)


def _sseps_on(device, db, vel, path, draws, **kw):
    it = iter(draws)
    real_white, real_path = fftgenerators._white_normal, sseps._scan_path
    fftgenerators._white_normal = lambda g, shape, batch: next(it).to(g.device)
    sseps._scan_path = lambda *a: path
    try:
        return nowcasts.get_method("sseps")(db, dict(META), vel, T, n_ens_members=4,
                                            n_cascade_levels=6, win_size=SIDE // 2,
                                            device=device, **kw)
    finally:
        fftgenerators._white_normal, sseps._scan_path = real_white, real_path


def test_sseps_card_vs_cpu_on_the_card_path(dev):
    _, db, vel = _inputs()
    gen = torch.Generator().manual_seed(3)
    draws = [torch.randn((4, SIDE, SIDE), generator=gen) for _ in range(T)]
    path = sseps._scan_path(dev, (SIDE, SIDE), 2.0, T)
    assert path == (int(np.ceil(T * 2.5)) + 2, True)
    card = _launches(lambda: _sseps_on(dev, db, vel, path, draws), {
        "resample_axis0": 2 * T, "resample_axis1": 2 * T, "warp": T, "pwl_gather": T,
        "rim_from_field": T, "rim_from_mask": 1})
    _held(card, _sseps_on("cpu", db, vel, path, draws), 1e-3, frac=0.999)
    frames = []
    assert _sseps_on(dev, db, vel, path, draws, callback=frames.append,
                     return_output=False) is None
    np.testing.assert_array_equal(np.stack(frames, axis=1), card.cpu().numpy())


def test_steps_streaming_on_the_card(dev):
    _, db, vel = _inputs()
    kw = dict(n_ens_members=8, n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0,
              timestep=5, domain="spectral", seed=3)
    f = nowcasts.get_method("steps")
    _kernels.reset_launches()
    full = f(db, vel, 8, device=dev, **kw)
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    frames = []
    assert _launches(lambda: f(db, vel, 8, device=dev, callback=frames.append,
                               return_output=False, **kw), counts) is None
    streamed = np.stack(frames, axis=1)
    ref = full.cpu().numpy()
    assert np.array_equal(np.isnan(streamed), np.isnan(ref))
    assert np.nanmax(np.abs(streamed - ref)) <= 1e-5
