"""The noise filters, generators and std adjustment of the PyTorch port on
the card against the same functions on the CPU, on the same inputs and
draws, at 256^2 (192 x 224 where a shape is not square).  Tolerances: the
filters rtol 1e-4 with 1e-4 x max|ref| absolute (cuFFT against the CPU's
FFT in float32), the parametric fit's parameters rtol 1e-3 and its filter
rtol 1e-3; generated noise 1e-4 x max|ref|; the std adjustments rtol 1e-4.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_noise_cuda.py -q
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import make_synthetic_sequence  # noqa: E402

from pysteps_tpu_torch import cascade, noise, nowcasts  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fields(shape=(256, 256)):
    f = make_synthetic_sequence(n_frames=3, shape=shape, velocity=(2.0, 1.0), seed=42)
    f[:, :, 3 * shape[1] // 8 :] = 0.0
    return np.where(f >= 0.1, 10 * np.log10(np.maximum(f, 0.1)), -15.0).astype(np.float32)


def _close(ref, out, rtol=1e-4, of_max=True):
    torch.cuda.synchronize()
    ref = ref.cpu().numpy().astype(np.float64)
    out = out.cpu().numpy()
    assert ref.shape == out.shape
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()) if of_max else 0.0)


@pytest.mark.parametrize("method, kw", [
    ("nonparametric", {}), ("nonparametric", {"donorm": True, "use_full_fft": True}),
    ("ssft", {}), ("ssft", {"win_size": 64}), ("nested", {"max_level": 2}),
    ("nested", {"max_level": 3}),
])
@pytest.mark.parametrize("shape", [(256, 256), (192, 224)])
def test_filter_stacks_card_vs_cpu(dev, method, kw, shape):
    x = _fields(shape)
    init = noise.get_method(method)[0]
    on_card = init(torch.from_numpy(x).to(dev), **kw)
    on_cpu = init(torch.from_numpy(x), **kw)
    assert on_card["field"].device.type == "cuda"
    _close(on_cpu["field"], on_card["field"])


@pytest.mark.parametrize("kw", [{}, {"win_fun": "tukey", "weighted": True}])
def test_parametric_filter_card_vs_cpu(dev, kw):
    x = _fields()
    on_card = noise.get_method("parametric")[0](torch.from_numpy(x).to(dev), **kw)
    on_cpu = noise.get_method("parametric")[0](torch.from_numpy(x), **kw)
    np.testing.assert_allclose(on_card["pars"], on_cpu["pars"], rtol=1e-3, atol=1e-6)
    _close(on_cpu["field"], on_card["field"], rtol=1e-3, of_max=False)


@pytest.mark.parametrize("method, kw", [("ssft", {}), ("nested", {"max_level": 2})])
@pytest.mark.parametrize("chunk_bytes", [None, 1 << 24])
def test_ssft_noise_card_vs_cpu(dev, monkeypatch, method, kw, chunk_bytes):
    x = _fields()
    F = noise.get_method(method)[0](torch.from_numpy(x), **kw)
    masks = fftgenerators._ssft_gen_masks(F["field"].shape, (256, 256), 0.2, "tukey")
    white = torch.randn((5, 256, 256), generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(fftgenerators, "_white_normal",
                        lambda g, s, b: white.to(g.device if g is not None else "cpu"))
    ref = fftgenerators._generate_ssft_noise(None, F["field"], masks, (256, 256), 5)
    if chunk_bytes is not None:
        monkeypatch.setattr(fftgenerators, "_SSFT_CHUNK_BYTES", chunk_bytes)
    gen = torch.Generator(device=dev)
    out = fftgenerators._generate_ssft_noise(gen, F["field"].to(dev), masks.to(dev),
                                             (256, 256), 5)
    torch.cuda.synchronize()
    assert float((out.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize("method, kw", [
    ("nonparametric", {}), ("parametric", {}), ("ssft", {}), ("nested", {"max_level": 2}),
])
def test_noise_stddev_adjs_card_vs_cpu(dev, monkeypatch, method, kw):
    x = _fields()
    bp = cascade.get_method("gaussian")((256, 256), 8)
    F_cpu = noise.get_method(method)[0](torch.from_numpy(x), **kw)
    F_card = dict(F_cpu, field=F_cpu["field"].to(dev))
    gen = torch.Generator().manual_seed(2)
    normal = torch.randn((20, 256, 256), generator=gen)
    half = fftgenerators._spectral_white(gen, (256, 256), 20)
    monkeypatch.setattr(fftgenerators, "_white_normal", lambda g, s, b: normal.to(g.device))
    monkeypatch.setattr(fftgenerators, "_spectral_white", lambda g, s, b: half.to(g.device))
    ref = noise.utils.compute_noise_stddev_adjs(
        torch.from_numpy(x[-1]), -10.0, -15.0, bp, None, F_cpu, None, 20)
    out = noise.utils.compute_noise_stddev_adjs(
        torch.from_numpy(x[-1]).to(dev), -10.0, -15.0, bp, None, F_card, None, 20)
    assert out.device.type == "cuda"
    _close(ref, out, of_max=False)


@pytest.mark.parametrize("method, adj, kw", [
    ("parametric", "auto", {}), ("ssft", "fixed", {}), ("nested", None, {"max_level": 2}),
])
def test_steps_runs_each_noise_method_on_the_card(dev, method, adj, kw):
    x = _fields()
    v = np.zeros((2, 256, 256), np.float32)
    v[0], v[1] = 1.7, 0.6
    out = nowcasts.get_method("steps")(
        torch.from_numpy(x).to(dev), torch.from_numpy(v).to(dev), 3, n_ens_members=4,
        n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0, timestep=5,
        domain="spectral", seed=1, noise_method=method, noise_stddev_adj=adj,
        noise_kwargs=kw)
    assert out.device.type == "cuda" and tuple(out.shape) == (4, 3, 256, 256)
    fin = torch.isfinite(out)
    assert float(fin.float().mean()) > 0.7
    spread = torch.nan_to_num(out.std(dim=0)).mean(dim=(-2, -1))
    assert bool((spread > 0).all())
