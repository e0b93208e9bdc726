"""LINDA's parts on the card against the same functions on the CPU.

- blob detection at 128^2: the same (x, y, sigma) rows in the same order;
- the Adam update: bit-equal (IEEE float32 arithmetic, the square root
  correctly rounded through float64 on both);
- the kernel fit at 96^2 with blob features: the objective the card's
  spectra reach within 1% of the CPU's.  The fit follows rounding from
  its first step in phi (``nowcasts/linda.py::_fit_kernels``): on the
  CPU, sources changed by 1e-6 of their value move one feature's kernel
  to another optimum in 3 runs of 8 (spectra 0.34 apart, objectives
  0.2%), the others within 2e-3;
- the scan from one init (the CPU's, moved to the card) on the same white
  spectra and BPS draws: within 1e-4 x span (cuFFT against the CPU's
  FFT), identical NaN sets;
- LINDA launches none of the port's hand kernels.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_linda_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu_torch.feature import blob  # noqa: E402
from pysteps_tpu_torch.noise.fftgenerators import _spectral_white  # noqa: E402
from pysteps_tpu_torch.nowcasts import linda  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402

pytestmark = pytest.mark.cuda

SIDE = 96


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(side=SIDE, n_frames=3):
    frames = make_synthetic_sequence(
        n_frames=n_frames, shape=(2 * side, 2 * side), velocity=(3.4, 1.2), seed=42,
        evolution=0.2,
    )[:, ::2, ::2].astype(np.float32)
    vel = np.zeros((2, side, side), np.float32)
    vel[0], vel[1] = 1.7, 0.6
    return frames, vel


def _span_close(card, cpu, rel):
    c = card.detach().cpu().double().numpy()
    r = cpu.detach().cpu().double().numpy()
    assert np.array_equal(np.isnan(c), np.isnan(r))
    scale = float(np.nanmax(r) - np.nanmin(r))
    diff = float(np.nanmax(np.abs(np.nan_to_num(c) - np.nan_to_num(r))))
    assert diff <= rel * scale, (diff, scale)


def _init(device, frames, vel, coords):
    w = linda._compute_window_weights(coords, SIDE, SIDE, 0.2 * SIDE)
    iw = torch.as_tensor((w / w.sum(axis=0, keepdims=True)).astype(np.float32), device=device)
    w = torch.as_tensor(w.astype(np.float32), device=device)
    out = linda._linda_init_core(torch.as_tensor(frames, device=device),
                                 torch.as_tensor(vel, device=device), w, iw, ari_order=1)
    return w, iw, out


def test_blob_on_the_card(dev):
    f = make_synthetic_sequence(n_frames=1, shape=(128, 128), velocity=(2.0, 1.0), seed=3)[0]
    ref = blob.detection(f, max_num_features=25, device="cpu")
    out = blob.detection(f, max_num_features=25, device=dev)
    assert len(out) > 0
    np.testing.assert_array_equal(out, ref)


def test_adam_update_on_the_card(dev):
    rng = np.random.default_rng(0)
    mu_c = nu_c = torch.zeros(8, 3, device=dev)
    mu = nu = torch.zeros(8, 3)
    for count in range(1, 151):
        g = rng.normal(size=(8, 3)) * 10.0 ** rng.integers(-3, 6, size=(8, 3))
        g = g.astype(np.float32)
        u_c, mu_c, nu_c = linda._adam_update(torch.as_tensor(g, device=dev), mu_c, nu_c, count,
                                             0.1)
        u, mu, nu = linda._adam_update(torch.as_tensor(g), mu, nu, count, 0.1)
        np.testing.assert_array_equal(u_c.cpu().numpy(), u.numpy())


def test_kernel_fit_on_the_card(dev):
    frames, vel = _inputs()
    coords = np.fliplr(blob.detection(frames[-1], max_num_features=4, device="cpu")[:, :2])
    w, _, init = _init("cpu", frames, vel, coords)
    mask = init[6]
    diffs = torch.diff(torch.as_tensor(frames), dim=0) * mask
    ref = linda._fit_kernels(diffs[0], diffs[1], w, mask)
    out = linda._fit_kernels(diffs[0].to(dev), diffs[1].to(dev), w.to(dev), mask.to(dev)).cpu()
    wsel = w * (w > 1e-3) * mask

    def objective(k):
        pred = linda._conv_kernels(diffs[0], k) / linda._conv_mask_norm(k, mask)
        return torch.sum(wsel * (pred - diffs[1]) ** 2, dim=(1, 2))

    assert torch.all((objective(out) - objective(ref)).abs() <= 0.01 * objective(ref))


@pytest.mark.parametrize("perturbed", [False, True])
def test_scan_on_the_card(dev, perturbed, monkeypatch):
    frames, vel = _inputs()
    coords = np.fliplr(blob.detection(frames[-1], max_num_features=4, device="cpu")[:, :2])
    _, iw, init = _init("cpu", frames, vel, coords)
    E, T = (3, 3) if perturbed else (1, 3)
    gen = torch.Generator().manual_seed(5)
    whites = [_spectral_white(gen, (SIDE, SIDE), E) for _ in range(T)]
    if perturbed:
        noise = np.random.default_rng(1).lognormal(0.0, 0.3, frames[-1].shape)
        err = np.where(frames[-1] > 0.5, noise, np.nan)
        pert = linda._estimate_error_model(err, coords, (SIDE, SIDE), 0.15 * SIDE, 0.25 * SIDE,
                                           0.2 * SIDE, device="cpu")
    else:
        pert = linda._degenerate_perturbations((SIDE, SIDE), "cpu")
    v = torch.as_tensor(vel)
    Nv = torch.linalg.vector_norm(v, dim=0)
    V_n = v / Nv[None]
    V_perp = torch.stack([-V_n[1], V_n[0]])
    eps = torch.tensor([0.7, -1.2, 0.3][:E])
    kw = dict(vel_pert=perturbed, vp_coeffs=((10.88, 0.23, -7.68), (5.76, 0.31, -2.72)),
              eps_par=eps, eps_perp=-eps, V_n=V_n, V_perp=V_perp, vsf=12.0, timestep_min=5.0)

    def run(device):
        it = iter(whites)
        monkeypatch.setattr(linda, "_member_white", lambda gens, shape: next(it).to(device))
        to = {k: (x.to(device) if isinstance(x, torch.Tensor) else x) for k, x in kw.items()}
        return linda._linda_scan(
            init[5].to(device), init[7].to(device), v.to(device),
            *[x.to(device) for x in init[:4]], iw.to(device), init[4].to(device),
            init[6].to(device), [None] * E, {k: x.to(device) for k, x in pert.items()}, T,
            perturbed, E, (SIDE, SIDE), **to)

    _kernels.reset_launches()
    card = run(dev)
    assert not any(_kernels.LAUNCHES.values()), _kernels.LAUNCHES
    _span_close(card, run(torch.device("cpu")), 1e-4)
