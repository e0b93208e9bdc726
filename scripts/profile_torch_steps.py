"""Where the time of the PyTorch port's STEPS main path goes, on one card.

    python3 scripts/profile_torch_steps.py [--runs 10] [--out FILE] [--no-chain] [--shapes]
                                           [--path A|F|G|H|I|J|K|L|M|N|O|P|Q|R|T|U|V|W|Y]

Runs ``pysteps_tpu_torch.nowcasts.get_method("steps")`` at the headline
configuration of ``chip_smoke.py`` (path A: 96 members x 512^2 x 12
leads; ``--path F``, ``G`` or ``H``: that path of ``chip_smoke.py``, the
parametric, SSFT or nested noise generator; ``--path I`` to ``M``: the
extrapolation, Lagrangian probability, S-PROG, ANVIL or SSEPS nowcast of
``chip_smoke.py``'s paths I-M, for which frames/s stands in for
member-frames/s and ``--no-chain`` and ``--shapes`` do not apply;
``--path N`` to ``R``: the motion solver of ``chip_smoke.py``'s paths
N-R at 512^2, LK with the 12-lead extrapolation of its flow, VET,
Proesmans, DARTS or Farneback, for which retrievals/s stands in, or
frames/s for N; ``--path T`` or ``U``: LINDA at 512^2 with 12 leads on
the bench's numpy rain-rate frames, T deterministic with the domain as
one feature (frames/s), U with blob features, 10 members and BPS;
``--path V``: STEPS blending at the bench's ``blend_512``, 96 members x
512^2 x 12 leads; ``--path W``: the PCA EnKF at ``pca_enkf_256``, 24
members x 256^2 over 12 leads, with its NWP ensemble on the card;
``--path Y``: ``parallel.sharded_steps.forecast`` at 96 members x 512^2 x
12 leads on a 1 x 1 x 1 mesh of an NCCL process group of this process,
for which init and loop seconds are not split), once
to warm up, ``--runs`` times on the host clock (each ending in
``torch.cuda.synchronize()``), then once under ``torch.profiler``.  Prints
one JSON line: the card's name and power limit, each run's init and loop
seconds, the device time by kernel group (the hand kernels K1-K4, the
two chain stages and the two other PWL maps, FFTs, sorts, scatters and
gathers, cuDNN convolutions, matrix products, reductions, elementwise;
the scatter, gather, convolution and product groups are matched first)
and the device's idle share of the profiled run.  The
per-kernel table goes to ``--out`` (default
``build/profile_torch_steps.json``).  ``--no-chain`` turns the fused
match-rim-warp chain off, so that the loop runs K3, K4 and K2 as separate
kernels: the path the chain replaced, for a comparison in one call.
``--shapes`` profiles one more run with the operators' input shapes
recorded (kept apart, so that its host overhead leaves the idle share
alone) and adds the device ms of every PyTorch operator that takes the
LUT build's flattened (members, pixels) field, by operator and shapes:
the 16 tail compares and sums of each lead read off exactly.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import (  # noqa: E402
    BENCH_KWARGS, BLEND_MEMBERS, ENKF_LEVELS, ENKF_MEMBERS, ENKF_SIDE, LINDA_PATHS,
    MOTION_PATHS, N_LEADS, N_MEMBERS, NOISE_PATHS, SHARDED_KWARGS, SIDE, _blend_kw,
    _enkf_inputs, _linda_inputs, _nccl_mesh, bench_inputs, blend_inputs, nowcast_path,
    takes_measure_time,
)
from pysteps_tpu_torch import blending, motion, nowcasts  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as steps_mod  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402

# kernel-name substrings -> group, first match wins
GROUPS = (
    ("pst_resample", "K1 resample"), ("pst_warp", "K2 warp"),
    ("pst_chain_v", "chain match+vert+rim"), ("pst_chain_h", "chain horiz"),
    ("pst_pwl_hier", "pwl hier"), ("pst_pwl_flat", "pwl flat"),
    ("pst_pwl", "K3 pwl"), ("pst_rim", "K4 rim"),
    ("fft", "fft"), ("sort", "sort"), ("radix", "sort"),
    ("scatter", "scatter/gather"), ("gather", "scatter/gather"), ("cudnn", "conv"),
    ("implicit_gemm", "conv"), ("fprop", "conv"), ("convolution", "conv"),
    ("conv2d", "conv"), ("gemm", "matmul"), ("cutlass", "matmul"), ("xmma", "matmul"),
    ("reduce", "reduction"), ("elementwise", "elementwise"),
    ("vectorized", "elementwise"), ("memcpy", "copy"), ("memset", "copy"),
)


def group_of(name):
    low = name.lower()
    for key, group in GROUPS:
        if key in low:
            return group
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile_torch_steps.json"))
    ap.add_argument("--no-chain", action="store_true",
                    help="run the unfused K3 -> K4 -> K2 path in place of the chain")
    ap.add_argument("--shapes", action="store_true",
                    help="add the device ms of the operators on the LUT build's field")
    ap.add_argument("--path", choices=["A", *NOISE_PATHS, *"IJKLM", *MOTION_PATHS, *LINDA_PATHS,
                                       "V", "W", "Y"],
                    default="A", help="chip_smoke.py's path to run (F, G, H: the other noise "
                    "generators; I-M: the other nowcasts; N-R: the motion solvers; T, U: "
                    "LINDA; V: STEPS blending; W: the PCA EnKF; Y: the y-sharded STEPS)")
    args = ap.parse_args()
    moving = args.path in MOTION_PATHS
    linda = args.path in LINDA_PATHS
    blend = args.path in ("V", "W")
    nowcast = args.path in "IJKLMY" or moving or linda or blend
    if nowcast and (args.no_chain or args.shapes):
        raise SystemExit("profile_torch_steps: --no-chain and --shapes are STEPS' options")
    E, side, T, extra_kw = (
        NOISE_PATHS[args.path] if args.path in NOISE_PATHS else (N_MEMBERS, SIDE, N_LEADS, {})
    )
    if args.no_chain:
        steps_mod._chain_available = lambda *a, **k: False
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_steps: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    dev = torch.device("cuda")
    if moving:
        method, n_frames = MOTION_PATHS[args.path]
        frames, _ = bench_inputs(SIDE, n_frames=n_frames)
        x = torch.as_tensor(frames, device=dev)
        flow_fn = motion.get_method(method)
        kw = {"verbose": False} if method in ("vet", "darts") else {}
        E, side = 1, SIDE
        T = N_LEADS if args.path == "N" else 1
        out_shape = (T, side, side) if args.path == "N" else (2, side, side)

        def run(seed):
            t0 = time.time()
            out = flow_fn(x, **kw)
            if args.path == "N":
                out = nowcasts.get_method("extrapolation")(x[-1], out, N_LEADS)
            torch.cuda.synchronize()
            return time.time() - t0, None, None, out
    elif args.path == "V":
        db, nwp, velocity = blend_inputs(SIDE)
        b_args = tuple(torch.as_tensor(x, device=dev) for x in (db, nwp, velocity, velocity[None]))
        f = blending.get_method("steps")
        f_kw = dict(_blend_kw(BLEND_MEMBERS, tempfile.mkdtemp()), measure_time=True)
        E, side = BLEND_MEMBERS, SIDE
        out_shape = (E, T, side, side)

        def run(seed):
            t0 = time.time()
            out, init_s, loop_s = f(*b_args, T, 5.0, **dict(f_kw, seed=seed))
            torch.cuda.synchronize()
            return time.time() - t0, init_s, loop_s, out
    elif args.path == "W":
        obs, obs_ts, nwp, nwp_ts, velocity, t_issue = _enkf_inputs(dev)
        f = blending.get_method("pca_enkf")
        E, side = ENKF_MEMBERS, ENKF_SIDE
        out_shape = (E, T + 1, side, side)

        def run(seed):
            t0 = time.time()
            out, init_s, loop_s = f(obs, obs_ts, nwp, nwp_ts, velocity, 5 * T,
                                    issuetime=t_issue, n_ens_members=E,
                                    n_cascade_levels=ENKF_LEVELS, precip_thr=-10.0,
                                    norain_thr=0.01, seed=seed, measure_time=True)
            torch.cuda.synchronize()
            return time.time() - t0, init_s, loop_s, out
    elif linda:
        rain, velocity = _linda_inputs()
        f = nowcasts.get_method("linda")
        f_kw = dict(LINDA_PATHS[args.path], measure_time=True)
        E, side = f_kw.get("n_ens_members", 1) if args.path == "U" else 1, SIDE
        out_shape = ((E,) if args.path == "U" else ()) + (T, side, side)

        def run(seed):
            t0 = time.time()
            out, init_s, loop_s = f(rain, velocity, T, **f_kw)
            torch.cuda.synchronize()
            return time.time() - t0, init_s, loop_s, out
    elif args.path == "Y":
        from pysteps_tpu_torch.parallel import sharded_steps

        mesh = _nccl_mesh()
        precip_db, velocity = bench_inputs(side)
        out_shape = (E, T, side, side)

        def run(seed):
            t0 = time.time()
            out = sharded_steps.forecast(precip_db, velocity, T, mesh, n_ens_members=E,
                                         **dict(SHARDED_KWARGS, seed=seed))
            torch.cuda.synchronize()
            return time.time() - t0, None, None, out
    elif nowcast:
        f, f_args, f_kw, frames = nowcast_path(args.path, dev)
        timed = takes_measure_time(f)
        shape = tuple(f_args[0].shape[-2:])
        E = f_kw.get("n_ens_members", 1)
        out_shape = ((E, T) if args.path == "M" else (T,)) + shape
        side = shape[0]

        def run(seed):
            t0 = time.time()
            res = f(*f_args, **dict(f_kw, measure_time=True) if timed else f_kw)
            torch.cuda.synchronize()
            out, init_s, loop_s = res if timed else (res, None, None)
            return time.time() - t0, init_s, loop_s, out
    else:
        precip_db, velocity = bench_inputs(side)
        p = torch.as_tensor(precip_db, device=dev)
        v = torch.as_tensor(velocity, device=dev)
        steps = nowcasts.get_method("steps")
        kw = dict(BENCH_KWARGS, n_ens_members=E, measure_time=True, **extra_kw)
        out_shape = (E, T, side, side)

        def run(seed):
            t0 = time.time()
            out, init_s, loop_s = steps(p, v, T, **dict(kw, seed=seed))
            torch.cuda.synchronize()
            return time.time() - t0, init_s, loop_s, out

    _kernels.reset_launches()
    run(1)
    # the flag patches the gate _steps_forecast reads; a run that took the
    # other path would profile the wrong one
    took_chain = _kernels.LAUNCHES["chain_horiz"] > 0
    if not nowcast and took_chain == args.no_chain:
        raise AssertionError(f"--no-chain={args.no_chain}, launches {_kernels.LAUNCHES}")
    torch.cuda.reset_peak_memory_stats()
    runs = [run(2 + i)[:3] for i in range(args.runs)]
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, _, _, out = run(100)
    if tuple(out.shape) != out_shape:
        raise AssertionError(f"output shape {tuple(out.shape)}")

    # device events only: a user annotation (e.g. ``Optimizer.step``) spans
    # kernels that are counted on their own
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    groups = {}
    for e in kernels:
        g = group_of(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    table = sorted(
        ({"kernel": e.key[:160], "group": group_of(e.key), "count": e.count,
          "ms": e.self_device_time_total / 1e3} for e in kernels),
        key=lambda r: -r["ms"],
    )
    mfs = [E * T / r[0] for r in runs]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "path": args.path, "chain": not args.no_chain,
                   "kernels": table}, f, indent=1)
    extra = {}
    if args.shapes:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof_s:
            run(101)
        field = [E, side * side]
        extra["device_ms_on_lut_field_by_op"] = sorted(
            ({"op": e.key, "shapes": e.input_shapes, "count": e.count,
              "device_ms": e.device_time_total / 1e3}
             for e in prof_s.key_averages(group_by_input_shape=True)
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.device_time_total > 0 and field in e.input_shapes),
            key=lambda r: -r["device_ms"],
        )
    print(json.dumps({
        "card": smi, "torch": torch.__version__, "path": args.path, **extra_kw,
        "chain": not args.no_chain, "shape": list(out_shape),
        "runs_wall_init_loop_s": runs,
        "member_frames_per_s": mfs,
        "member_frames_per_s_median": statistics.median(mfs),
        "member_frames_per_s_quartiles": statistics.quantiles(mfs, n=4) if len(mfs) > 1 else mfs,
        "profiled_wall_s": wall, "max_memory_allocated": peak,
        "device_busy_ms": busy_us / 1e3 if kernels else "not measured",
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if kernels else "not measured",
        "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
        "top_kernels": table[:12],
        **extra,
    }), flush=True)
    if args.path == "Y":
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
