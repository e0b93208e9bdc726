"""``parallel/`` and RainFARM on the card.

- an NCCL process group of this process alone (rank 0 of 1) carries a
  1 x 1 x 1 mesh: its axes, one all-reduce and one all-gather;
- ``sharded_warp`` launches K1 once an axis and equals ``warp_shifted``
  on the card (within an ulp of the extended block's height times the
  field's span) and the plain version on the CPU (1e-5, as
  tests/test_parallel.py);
- ``rfft2_local`` / ``irfft2_local`` against ``torch.fft`` on the card
  (1e-5 of the largest magnitude);
- ``sharded_steps.forecast`` at 4 x 64^2 x 3 launches K1 once an axis a
  lead and K4 from a mask once, and gives finite values of the forecast's
  shape (its values are held against the CPU in ``chip_smoke.py``'s path
  Y, and against JAX in ``tests/test_torch_parallel.py``);
- STEPS' ``mesh=`` with its members over 2 "ens" ranks, each rank's block
  run in turn on the 1-rank mesh (``workers.as_ens_rank``), at 128^2 x 3
  leads, 8 members in one chunk and 6 in chunks of 2 (a chunk split
  between the ranks): each block launches the fused chain and K1 as the
  code says (``workers.block_launches``), and the blocks put together
  have the unsharded card forecast's NaN set and its values within 3e-2
  dB (tests/test_parallel.py:46-48).  Not bit for bit: cuFFT's plans
  depend on the batch, so a block's transforms round unlike the whole
  ensemble's and the CDF match hands that on (1.1e-4 dB at most in one
  chunk, 1.0e-5 in chunks of 2; NVIDIA H100 80GB HBM3, 700.00 W).  On the
  CPU the blocks are bit-equal (tests/test_torch_parallel.py);
- RainFARM's balanced average in IEEE float32 with cuDNN's TF32 allowed
  around the call (PyTorch's default), within 1e-5 of float64 on the CPU;
- both psum matchers of ``sharded_steps`` (the binned one also with one
  target a member, as sharded blending's resampled targets) on the
  1-rank mesh equal to the CPU's one block (``mesh=None``) bit for bit;
- sharded blending (``sharded_blending.blending_scan_sharded``) at 4 x
  64^2 x 2 leads launches K1 once an axis a lead (its halo warp) and K4
  from a mask never (its inputs are prepared on the CPU); the last lead's
  halo warp through K1 equals the same warp through K1's plain version on
  the card bit for bit.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_parallel_cuda.py -q
"""

import dataclasses
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402

from pysteps_tpu_torch import nowcasts  # noqa: E402
from pysteps_tpu_torch.blending import steps as blend_steps  # noqa: E402
from pysteps_tpu_torch.downscaling import rainfarm  # noqa: E402
from pysteps_tpu_torch.ops import _kernels, pallas_warp  # noqa: E402
from pysteps_tpu_torch.ops import warp as warp_mod  # noqa: E402
from pysteps_tpu_torch.ops.warp import warp_shifted  # noqa: E402
from pysteps_tpu_torch.parallel import dist_fft, halo, make_mesh, sharded_steps  # noqa: E402
from pysteps_tpu_torch.parallel import sharded_blending  # noqa: E402
from pysteps_tpu_torch.parallel.mesh import all_gather_cat, all_reduce  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    yield make_mesh(ens=1, y=1, x=1, device_type="cuda")
    dist.destroy_process_group()


def test_nccl_one_rank_mesh(mesh):
    assert dist.get_backend() == "nccl"
    assert tuple(mesh.shape) == (1, 1, 1) and mesh.mesh_dim_names == ("ens", "y", "x")
    x = torch.arange(6.0, device="cuda").reshape(2, 3)
    assert torch.equal(all_reduce(x, mesh, "y"), x)
    assert torch.equal(all_gather_cat(x, mesh, "ens"), x)


def test_sharded_warp_launches_k1(mesh):
    field, disp, max_disp = workers.warp_inputs()
    f, d = torch.as_tensor(field, device="cuda"), torch.as_tensor(disp, device="cuda")
    _kernels.reset_launches()
    out = halo.sharded_warp(f, d, mesh, max_disp, cval=0.0)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["resample_axis0"] == 1 and _kernels.LAUNCHES["resample_axis1"] == 1
    # positions in the 80-row extended block round at its row numbers: the
    # fractions differ by up to an ulp of 80 (7.6e-6) times the field's
    # span (1)
    ref = warp_shifted(f, d, max_disp, cval=0.0)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=2.0**-17)
    cpu = warp_shifted(torch.as_tensor(field), torch.as_tensor(disp), max_disp, cval=0.0)
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), atol=1e-5)


@pytest.mark.parametrize("n", [96, 90])
def test_rfft2_local_on_the_card(mesh, n):
    f = torch.as_tensor(workers.fft_field(n), device="cuda")
    spec = dist_fft.rfft2_local(f, mesh)
    ref = torch.fft.rfft2(f)
    scale = float(ref.abs().max())
    assert float((spec[:, : n // 2 + 1] - ref).abs().max()) <= 1e-5 * scale
    back = dist_fft.irfft2_local(spec, (64, n), mesh)
    assert float((back - f).abs().max()) <= 1e-5 * float(f.abs().max())


def test_sharded_steps_launches(mesh):
    db, vel = workers.ss_inputs()
    db, vel = db[:, ::2, ::2].copy(), vel[:, ::2, ::2].copy()
    _kernels.reset_launches()
    out = sharded_steps.forecast(db, vel, 3, mesh, **workers.SS_KW)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    assert launches.pop("resample_axis0") == 3 and launches.pop("resample_axis1") == 3
    assert launches.pop("rim_from_mask") == 1 and not any(launches.values())
    assert tuple(out.shape) == (4, 3, 64, 64) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("E,chunk", [(8, None), (6, 2)])
def test_steps_member_blocks_on_the_card(mesh, E, chunk):
    frames = workers.make_synthetic_sequence(n_frames=3, shape=(128, 128),
                                             velocity=(2.0, 1.0), seed=0)
    db = np.where(frames >= 0.1, 10 * np.log10(np.maximum(frames, 0.1)), -15.0)
    vel = np.zeros((2, 128, 128), np.float32)
    vel[0], vel[1] = 2.0, 1.0
    kw = dict(n_ens_members=E, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
              timestep=5, vel_pert_method="bps", seed=3, member_chunk=chunk)
    f = nowcasts.get_method("steps")
    whole = f(db.astype(np.float32), vel, 3, **kw)
    blocks = []
    for block in ((0, E // 2), (E // 2, E)):
        with workers.as_ens_rank(block):
            _kernels.reset_launches()
            blocks.append(f(db.astype(np.float32), vel, 3, mesh=mesh, **kw))
            torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        expected = workers.block_launches(block, E, 3, chunk)
        assert launches == dict(dict.fromkeys(launches, 0), **expected), (block, launches)
    joined = torch.cat(blocks)
    assert joined.is_cuda and tuple(joined.shape) == (E, 3, 128, 128)
    assert torch.equal(torch.isnan(joined), torch.isnan(whole))
    assert float(torch.nan_to_num(joined - whole).abs().max()) <= 3e-2


def test_rainfarm_balanced_average_ieee(dev):
    x = np.random.RandomState(1).gamma(1.0, 2.0, (256, 256)).astype(np.float32)
    x[40:60, 100:130] = np.nan
    kernel = rainfarm._make_gaussian_kernel(8)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = rainfarm._balanced_spatial_average(torch.as_tensor(x, device=dev), kernel)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ref = rainfarm._balanced_spatial_average(torch.as_tensor(x, dtype=torch.float64), kernel)
    card, ref = card.cpu().double().numpy(), ref.numpy()
    assert np.array_equal(np.isnan(card), np.isnan(ref))
    assert np.nanmax(np.abs(card - ref)) <= 1e-5 * np.nanmax(np.abs(ref))


@pytest.mark.parametrize("which", ["psum", "binned", "binned_per_member"])
def test_psum_matchers_card_vs_cpu(mesh, which):
    fields, target = workers.match_inputs()
    tstate = sharded_steps._prepare_pwl_target(torch.as_tensor(target))
    ranked, zvalue, c_t, tlo, tscale, n_wet = tstate
    size = float(fields[0].size)

    def match(x, dev, m):
        if which == "psum":
            return sharded_steps._match_cdf_psum(x, tuple(t.to(dev) for t in tstate), size, m)
        stats = (zvalue, c_t, tlo, tscale, n_wet, ranked[-1] - 1.0)
        if which == "binned_per_member":
            B = x.shape[0]
            stats = tuple(t.expand((B,) + t.shape).contiguous() for t in stats)
        return sharded_steps._match_cdf_psum_binned(x, *(t.to(dev) for t in stats), size,
                                                    m)

    card = match(torch.as_tensor(fields, device="cuda"), "cuda", mesh)
    cpu = match(torch.as_tensor(fields), "cpu", None)
    assert torch.equal(card.cpu(), cpu)


def test_sharded_blending_halo_warp_launches_k1(mesh, tmp_path):
    db, nwp, vel, vel_m = workers.blend_inputs(2)
    inp = blend_steps.scan_inputs(db, nwp, vel, vel_m, 2, 5, device="cpu",
                                  outdir_path_skill=str(tmp_path),
                                  **dict(workers.BLEND_KW, n_ens_members=4, seed=3))

    def cuda(obj, **over):
        return dataclasses.replace(obj, **{k: v.cuda() for k, v in vars(obj).items()
                                           if isinstance(v, torch.Tensor)}, **over)

    params = cuda(inp.params)
    state = cuda(inp.state, generator=torch.Generator(device="cuda").manual_seed(3))
    seen = {}
    orig = sharded_blending._warp_from_ext

    def keep(*args):
        seen["args"] = args
        return orig(*args)

    sharded_blending._warp_from_ext = keep
    try:
        _kernels.reset_launches()
        out = sharded_blending.blending_scan_sharded(params, state, 2, mesh,
                                                     vmax_bound=inp.vmax_bound, **inp.statics)
        torch.cuda.synchronize()
    finally:
        sharded_blending._warp_from_ext = orig
    launches = dict(_kernels.LAUNCHES)
    assert launches.pop("resample_axis0") == 2 and launches.pop("resample_axis1") == 2
    assert not any(launches.values())
    assert tuple(out.shape) == (4, 2, 64, 64) and bool(torch.isfinite(out).all())
    ext, disp, h, cval, _ = seen["args"]
    kernel = orig(ext, disp, h, cval, mesh)
    real = warp_mod.axis_resample
    warp_mod.axis_resample = pallas_warp._axis_resample
    try:
        plain = orig(ext, disp, h, cval, mesh)
    finally:
        warp_mod.axis_resample = real
    assert torch.equal(kernel, plain)
