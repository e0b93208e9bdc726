"""On-card smoke run of the PyTorch port (``pysteps_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``).
Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: the hand-written kernels of ``pysteps_tpu_torch/csrc`` compiled
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. kernels: each kernel of the STEPS path (K1 resample on both axes, K2
   warp, K3 PWL apply, K4 rim from a field and from a mask) at the shapes
   the main path gives it, held against its plain PyTorch version on the
   same CUDA inputs, with its time, the plain version's, a library
   yardstick where one PyTorch call comes close, and its bound;
4. parity: the deterministic STEPS loop at 256^2 through the kernels on
   the card against the plain versions on the CPU, same statics;
5. main path: ``nowcasts.get_method("steps")`` at 96 members x 512^2 x 12
   leads with the headline configuration, kernel launch counts read
   around the timed run;

then the ``kernels`` summary line and, last, the ``ok`` line.  Any failed
check raises, and the script exits non-zero without the ``ok`` line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pysteps_tpu_torch import nowcasts  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as steps_mod  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402
from pysteps_tpu_torch.ops import pallas_dilate, pallas_histmatch, pallas_warp  # noqa: E402
from pysteps_tpu_torch.postprocessing.probmatching import _prepare_cdf_target  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
from helpers import make_synthetic_sequence  # noqa: E402

N_MEMBERS, SIDE, N_LEADS = 96, 512, 12
# memory rate (bytes/s) and non-tensor-core f32 rate (FLOP/s) by card,
# from NVIDIA's data sheets; the SXM part's figures are the default
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_peaks(name):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return CARD_PEAKS["H100"]


def bench_inputs(side, velocity=(2.0, 1.0)):
    """The STEPS benchmark's inputs: three synthetic frames in dB with a
    small perturbation, and a constant motion field."""
    frames = make_synthetic_sequence(
        n_frames=3, shape=(side, side), velocity=velocity, seed=42
    )
    precip_db = np.where(
        frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0
    ).astype(np.float32)
    precip_db += 0.1 * np.random.RandomState(7).randn(*precip_db.shape).astype(np.float32)
    vel = np.zeros((2, side, side), np.float32)
    vel[0], vel[1] = velocity
    return precip_db, vel


BENCH_KWARGS = dict(
    n_ens_members=N_MEMBERS, n_cascade_levels=8, precip_thr=-10.0,
    kmperpixel=1.0, timestep=5, noise_method="nonparametric",
    vel_pert_method="bps", mask_method="incremental",
    probmatching_method="cdf", domain="spectral", seed=42,
)


def cuda_ms(fn, reps=20):
    """Mean device time of ``fn`` in ms (CUDA events, after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return name, smi


def phase_build():
    t0 = time.time()
    path = _kernels.build()
    _kernels.library()
    secs = time.time() - t0
    emit({"phase": "build", "seconds": round(secs, 3), "library": os.path.relpath(path, ROOT),
          "ptxas_report": os.path.relpath(path.with_suffix(".log"), ROOT)})


def _record(name, source, replaces, counter, out, ref, tol, kernel_ms, plain_ms,
            library_ms, library_call, bytes_moved, flops, peaks):
    """One kernel's check and numbers; raises when it disagrees."""
    torch.cuda.synchronize()
    both_nan = torch.isnan(out) & torch.isnan(ref)
    if not torch.equal(torch.isnan(out), torch.isnan(ref)):
        raise AssertionError(f"{name}: NaN sets differ from the plain version")
    err = float(torch.where(both_nan, 0.0, (out - ref).abs()).max())
    if not err <= tol:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} > {tol}")
    bw, fl = peaks
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fl * 1e3
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "counter": counter, "launches": None, "max_abs_err": err, "tol": tol,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library_call": library_call,
        "bytes": bytes_moved, "flops": flops,
    }
    emit(dict(rec, phase="kernel"))
    return rec


def _grid_sample_ms(field, disp):
    """F.grid_sample (bilinear, zeros padding) of (B, 1, m, n) fields at
    displaced positions: a yardstick close to K1/K2, not the same function
    (no displacement clip, joint 2-D sampling, other edge rule)."""
    B, m, n = field.shape
    yy = torch.linspace(-1, 1, m, device=field.device)[:, None].expand(m, n)
    xx = torch.linspace(-1, 1, n, device=field.device)[None, :].expand(m, n)
    grid = torch.stack(
        [xx + disp[:, 0] * (2.0 / (n - 1)), yy + disp[:, 1] * (2.0 / (m - 1))], dim=-1
    )
    f4 = field[:, None]
    return cuda_ms(lambda: F.grid_sample(f4, grid, mode="bilinear", align_corners=True))


def phase_kernels(peaks):
    """Each kernel against its plain version at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = []
    E, m = N_MEMBERS, SIDE
    mc = m // 4

    def smooth_disp(batch, size, amp):
        """Smooth random (batch, 2, size, size) displacements of about amp px."""
        yy = torch.linspace(0, 3, size, device=dev)[:, None]
        xx = torch.linspace(0, 2, size, device=dev)[None, :]
        a = torch.rand((batch, 2, 1, 1), generator=gen, device=dev) + 0.5
        return amp * torch.stack([
            a[:, 0] * torch.sin(xx + yy) + 0.1, -a[:, 1] * torch.cos(0.7 * xx - yy)
        ], dim=1)

    # K1: per-lead velocity sampling on the coarse grid, 96 members x 2
    # channels sharing one index plane per member, Dc = 12
    vel = torch.randn((E, 2, mc, mc), generator=gen, device=dev)
    disp = smooth_disp(E, mc, 14.0)
    for axis in (0, 1):
        pos = torch.arange(mc, device=dev, dtype=torch.float32)
        pos = pos[:, None] if axis == 0 else pos[None, :]
        c = pos + disp[:, 1 - axis]
        idx0 = torch.floor(c).to(torch.int32).contiguous()
        frac = (c - torch.floor(c)).contiguous()
        fields = vel.reshape(2 * E, mc, mc).contiguous()
        out = pallas_warp.axis_resample(fields, idx0, frac, 12, axis)
        ref = pallas_warp._axis_resample(fields, idx0, frac, 12, axis)
        span = float(fields.max() - fields.min())
        nb = 4 * (2 * fields.numel() + 2 * idx0.numel())
        recs.append(_record(
            f"K1_resample_axis{axis}", "pysteps_tpu_torch/csrc/resample.cu",
            "pysteps_tpu/ops/pallas_warp.py:82", f"resample_axis{axis}", out, ref,
            1e-5 * span,
            cuda_ms(lambda: pallas_warp.axis_resample(fields, idx0, frac, 12, axis)),
            cuda_ms(lambda: pallas_warp._axis_resample(fields, idx0, frac, 12, axis), 5),
            _grid_sample_ms(fields, disp.repeat_interleave(2, dim=0)),
            "F.grid_sample bilinear (close, not the same function)",
            nb, 4 * fields.numel(), peaks,
        ))

    # K2: the per-lead output warp, 96 x 512^2, D = 48
    field = torch.randn((E, m, m), generator=gen, device=dev) * 5.0 + 10.0
    disp = smooth_disp(E, m, 20.0)
    dy = disp[:, 1].contiguous()
    disp_t = disp.transpose(-1, -2).contiguous()
    nan = float("nan")
    out = pallas_warp.warp_fused(field, dy, disp_t, 48, nan)
    ref = pallas_warp._warp_fused_plain(field, dy, disp_t, 48, nan)
    recs.append(_record(
        "K2_warp", "pysteps_tpu_torch/csrc/warp.cu",
        "pysteps_tpu/ops/pallas_warp.py:216", "warp", out, ref,
        1e-5 * float(field.max() - field.min()),
        cuda_ms(lambda: pallas_warp.warp_fused(field, dy, disp_t, 48, nan)),
        cuda_ms(lambda: pallas_warp._warp_fused_plain(field, dy, disp_t, 48, nan), 5),
        _grid_sample_ms(field, disp),
        "F.grid_sample bilinear (close, not the same function)",
        4 * 5 * field.numel(), 12 * field.numel(), peaks,
    ))

    # K3: the PWL apply of 96 member fields against the benchmark target
    precip_db, _ = bench_inputs(m)
    target = torch.as_tensor(precip_db[-1], device=dev)
    tstate = pallas_histmatch.prepare_target(*_prepare_cdf_target(target))
    x = (target[None] + 2.0 * torch.randn((E, m, m), generator=gen, device=dev)).reshape(E, -1)
    edges, d0, d1, q0, zval, ztrg = pallas_histmatch.build_pwl_coeffs(x, tstate)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    ztrg_b = ztrg.expand(E)
    out = pallas_histmatch.pwl_apply_gather(x, e8, T, q0, zval, ztrg_b)
    ref = pallas_histmatch._pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg_b)
    recs.append(_record(
        "K3_pwl_gather", "pysteps_tpu_torch/csrc/pwl.cu",
        "pysteps_tpu/ops/pallas_histmatch.py:199", "pwl_gather", out, ref,
        1e-5 * float(ref.abs().max()),
        cuda_ms(lambda: pallas_histmatch.pwl_apply_gather(x, e8, T, q0, zval, ztrg_b)),
        cuda_ms(lambda: pallas_histmatch._pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg_b), 3),
        None, "none: no PyTorch call computes a per-member piecewise-linear map",
        4 * (2 * x.numel() + e8.numel() + T.numel() + 3 * E),
        # 7 coarse compares, 15 x (compare + 2 multiply-adds), the affine end
        (7 + 15 * 5 + 4) * x.numel(), peaks,
    ))

    # K4: the incremental-mask rim, per lead from 96 fields (kr=2, r=10)
    # and at init from one 0/1 mask
    fields = x.reshape(E, m, m).contiguous()
    R = 12
    out = pallas_dilate.dilated_rim_from_field(fields, -10.0, 2, 10)
    ref = pallas_dilate._rim_plain(fields, -10.0, 2, 10)
    recs.append(_record(
        "K4_rim_from_field", "pysteps_tpu_torch/csrc/rim.cu",
        "pysteps_tpu/ops/pallas_dilate.py:86", "rim_from_field", out, ref, 1e-6,
        cuda_ms(lambda: pallas_dilate.dilated_rim_from_field(fields, -10.0, 2, 10)),
        cuda_ms(lambda: pallas_dilate._rim_plain(fields, -10.0, 2, 10), 3),
        None, "none: no PyTorch call computes a bounded L1 distance transform",
        4 * 2 * fields.numel(), 4 * (2 * R + 1) * fields.numel(), peaks,
    ))
    mask = (fields[:1] >= -10.0).to(torch.float32)
    out = pallas_dilate.dilated_rim(mask, 2, 10)
    ref = pallas_dilate._rim_plain(mask, 0.5, 2, 10)
    recs.append(_record(
        "K4_rim_from_mask", "pysteps_tpu_torch/csrc/rim.cu",
        "pysteps_tpu/ops/pallas_dilate.py:115", "rim_from_mask", out, ref, 1e-6,
        cuda_ms(lambda: pallas_dilate.dilated_rim(mask, 2, 10)),
        cuda_ms(lambda: pallas_dilate._rim_plain(mask, 0.5, 2, 10), 3),
        None, "none: no PyTorch call computes a bounded L1 distance transform",
        4 * 2 * mask.numel(), 4 * (2 * R + 1) * mask.numel(), peaks,
    ))
    return recs


def _deterministic_run(precip, velocity, device, side, E, T):
    """Deterministic STEPS init + loop with the kernel path's statics
    (max_disp 48, coarse 4, PWL matcher) on ``device``."""
    cfg = dict(BENCH_KWARGS, n_ens_members=E)
    dev = torch.device(device)
    w = torch.tensor(
        steps_mod.cascade.get_method("gaussian")((side, side), 8)["weights_2d"],
        dtype=torch.float32, device=dev,
    )
    p = torch.as_tensor(precip, device=dev)
    v = torch.as_tensor(velocity, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    _, par, st = steps_mod._steps_init(
        p, v, w, gen, -10.0, torch.ones((side, side), device=dev), E=E,
        ar_order=2, conditional=False, mask_method="incremental",
        struct_radius=2, mask_rim=10, vel_pert=False, n_iter=1,
        interp_order=1, noise_in_graph=False, max_disp=48,
    )
    out = steps_mod._steps_scan(
        st.window, st.precip_mask, st.generator, v, par.phi, par.noise_filter,
        (side, side), w, torch.ones(8, device=dev), par.means, par.stds,
        par.precip_last, par.precip_min, -10.0, par.war, par.mu_0,
        torch.zeros((side, side), dtype=torch.bool, device=dev),
        st.eps_par, st.eps_perp, par.velocity_unit, par.velocity_perp, 1.0,
        None, None, T, noise=False, mask_method="incremental",
        probmatching="cdf", domain="spectral", vel_pert=False,
        timestep_min=float(cfg["timestep"]), mask_rim=10, struct_radius=2,
        n_iter=1, interp_order=1, need_det=True, E=E, max_disp=48,
        pwl_match=True,
    )
    return out.cpu().numpy()


def phase_parity():
    """Card against CPU on the same statics; a non-integer motion keeps
    sampling positions off the domain edge, where the NaN set would hang
    on FFT rounding."""
    side, E, T = 256, 8, 6
    precip, velocity = bench_inputs(side, velocity=(1.7, 0.6))
    t0 = time.time()
    gpu = _deterministic_run(precip, velocity, "cuda", side, E, T)
    t1 = time.time()
    cpu = _deterministic_run(precip, velocity, "cpu", side, E, T)
    t2 = time.time()
    nan_g, nan_c = np.isnan(gpu), np.isnan(cpu)
    if not np.array_equal(nan_g, nan_c):
        raise AssertionError(f"parity: NaN sets differ ({int((nan_g != nan_c).sum())} pixels)")
    fin = ~nan_c
    span = float(cpu[fin].max() - cpu[fin].min())
    diff = np.abs(gpu[fin] - cpu[fin])
    frac_ok = float((diff <= 1e-3 * span).mean())
    mean_rel = float(diff.mean() / span)
    rec = {"phase": "parity", "shape": [E, T, side, side], "span": span,
           "frac_within_1e-3_span": frac_ok, "mean_abs_diff_over_span": mean_rel,
           "max_abs_diff_over_span": float(diff.max() / span),
           "nan_fraction": float(nan_c.mean()),
           "gpu_s": round(t1 - t0, 3), "cpu_s": round(t2 - t1, 3)}
    emit(rec)
    if frac_ok < 0.999 or mean_rel > 1e-4:
        raise AssertionError(f"parity: card and CPU disagree: {rec}")


def phase_main(name, smi, recs):
    precip_db, velocity = bench_inputs(SIDE)
    dev = torch.device("cuda")
    p = torch.as_tensor(precip_db, device=dev)
    v = torch.as_tensor(velocity, device=dev)
    f = nowcasts.get_method("steps")
    out = f(p, v, N_LEADS, **BENCH_KWARGS)
    float(torch.nanmean(out))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.time()
    out, init_s, loop_s = f(p, v, N_LEADS, **dict(BENCH_KWARGS, seed=43, measure_time=True))
    checksum = float(torch.nanmean(out))
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    if tuple(out.shape) != (N_MEMBERS, N_LEADS, SIDE, SIDE):
        raise AssertionError(f"main: output shape {tuple(out.shape)}")
    if torch.isinf(out).any():
        raise AssertionError("main: infinite values in the output")
    finite = torch.isfinite(out).float().mean(dim=(0, 2, 3)).cpu().numpy()
    # only the inflow band (sources outside the domain) may be NaN
    if finite[0] < 0.95 or finite[-1] < 0.75:
        raise AssertionError(f"main: finite fraction per lead {finite.tolist()}")
    fin = out[torch.isfinite(out)]
    lo, hi = float(p[-1].min()), float(p[-1].max())
    if float(fin.min()) < lo - 1e-3 or float(fin.max()) > hi + 1e-3:
        raise AssertionError("main: matched values outside the target's range")

    # launches per forecast, from the code's structure: the init integrates
    # ar_order unit steps of 2 velocity samples each and warps the inputs
    # once (each sample or warp one K1 launch per axis); every lead takes 2
    # samples, one warp, one match and one rim
    ar_order = 2
    k1 = ar_order * 2 + 1 + 2 * N_LEADS
    expected = {"resample_axis0": k1, "resample_axis1": k1, "warp": N_LEADS,
                "pwl_gather": N_LEADS, "rim_from_field": N_LEADS, "rim_from_mask": 1}
    if launches != expected:
        raise AssertionError(f"main: launches {launches} != expected {expected}")
    for rec in recs:
        rec["launches"] = launches[rec["counter"]]
        if rec["launches"] < 1:
            raise AssertionError(f"main: {rec['name']} was never launched")
    emit({"phase": "main", "shape": list(out.shape), "member_frames_per_s":
          N_MEMBERS * N_LEADS / wall, "wall_s": wall, "init_s": init_s,
          "loop_s": loop_s, "max_memory_allocated": peak,
          "finite_fraction_first_last_lead": [float(finite[0]), float(finite[-1])],
          "checksum": checksum, "launches": launches,
          "device": name, "nvidia_smi": smi})


def main():
    name, smi = phase_device()
    peaks = card_peaks(name)
    phase_build()
    recs = phase_kernels(peaks)
    phase_parity()
    phase_main(name, smi, recs)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: r[k] for k in keys} | {"library_call": r["library_call"]}
                      for r in recs],
          "card": smi, "peaks": {"bytes_per_s": peaks[0], "f32_flop_per_s": peaks[1]}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
