"""On-card smoke run of the PyTorch port (``pysteps_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (``CUDA_HOME`` or ``/usr/local/cuda``).
Phases, each printing JSON lines:

1. device: the card's name and power limit (``nvidia-smi``), torch and CUDA
   versions;
2. build: the hand-written kernels of ``pysteps_tpu_torch/csrc`` compiled
   with ``nvcc`` for ``sm_90a`` (one process per source, in parallel);
3. kernels: each of the eleven rows (K1 resample on axis 0 and on axis 1,
   K2 warp, K3 PWL apply, K4 rim from a field and from a mask, the two
   stages of the fused match-rim-warp chain, the hierarchical and the flat
   PWL maps, the CDF counts) at the shapes its path gives it, held against
   its plain PyTorch version on the same CUDA inputs, with its time, the
   plain version's, a library yardstick where PyTorch calls come close,
   and its bound, and each row's registers, static shared memory and
   spills from ``nvcc``'s ptxas report.  Each kernel and library call is
   timed as the median of 5 windows of 100 launches replayed from a CUDA
   graph (device time); each kernel also called eagerly, host included,
   as ``ms_eager``.  The chain and the CDF counts run on the inputs of
   path A's last lead, recorded from one forecast with each lead's
   largest displacements; the CDF counts also on a field whose pixels
   all equal one edge (``ms_one_value``), with the largest share of a
   member's pixels in one bin of their histogram on path E's inputs on a
   ``cdf_bins`` line of its own;
   the chain is timed beside K3 -> K4 -> K2 on those inputs; stage 1,
   K3 and the hierarchical and flat maps also on a LUT that fails their
   prefix-table check (the exact full sum out of line, ``ms_slow_lut``,
   equal to the plain version under ==); stage 1's matches per output are
   counted on the card by its counting instantiation and held against its
   geometry, whose shared memory, ring and blocks per SM (computed, not
   measured) print on a line of their own, as K2's route and tile
   geometry and K4's tile geometry do for each of their rows; K4 from a
   mask reads the bool mask that STEPS gives it;
4. parity: the deterministic STEPS loop at 256^2 through the chain on the
   card against the plain chain on the CPU, same statics;
5. path A, the main path: ``nowcasts.get_method("steps")`` at 96 members
   x 512^2 x 12 leads with the headline configuration, which takes the
   chain; its exact kernel launch counts, read around the timed run;
6. path B: the same at 1024^2 (above the chain's gate: K3, K4, K2);
7. path C: the same at 320^2 (rows of 128 that do not tile into 32: the
   hierarchical PWL map, K4, K2);
8. path D: the public ``match_cdf_pwl_flat`` on 96 members x 512^2;
9. path E: the public ``cdf_counts`` on the 96 x 512^2 fields of path A's
   last lead at the 128 edges its PWL LUT build placed, bit-equal to the
   plain version (whose last 16 counts are the build's exact tail
   counts);
10. noise parity: STEPS' other noise filters built on the card and on the
   CPU from the same aligned 512^2 inputs (the parametric filter with its
   radial PSD and 4 fitted parameters, the SSFT stack at its default 128^2
   windows, the nested stack at ``max_level=3``) and the noise std
   adjustment of the parametric and SSFT filters on both devices from the
   same white draws, each comparison printed with its tolerance, each
   card build's seconds beside it;
11. paths F, G and H: path A's forecast with the parametric filter and
   ``noise_stddev_adj="auto"`` (F), SSFT and "fixed" (G), nested at 6
   leads (H), each with exactly path A's kernel launches at its lead
   count and an ensemble spread above 0 at every lead;
12. paths I-M, the other nowcasts at the JAX bench's sizes (512^2, 12
   leads): ``extrapolation`` of the last dB field (I), the exceedance
   probability of 1 mm/h with slope 2 (J), S-PROG on 3 dB fields with 8
   levels (K), ANVIL on 4 rain-rate fields with 8 levels (L) and SSEPS
   with 24 members and windows of 256 (M), each timed once after a
   warm-up with its exact launch counts and held against a CPU run of
   the port on the same inputs: I and J through the CPU's exact gather;
   K and M through the card's path on the CPU (the same displacement
   bound and PWL map, the plain versions; M on the same white draws over
   4 leads); L's loop from one init, K1 against the exact gather, and
   its whole forecast; M's members must spread at every lead;
13. path S: path A with a callback and ``return_output=False``, whose
   numpy frames must equal a returning run with the same seed within
   1e-5 at a lower peak device memory;
14. tf32: the port's convolutions (STEPS' separable Gaussian window and
   the motion stencils) within 1e-5 of float64 on the CPU, each with the
   error of the same call under PyTorch's default cuDNN flags beside it;
15. paths N-R, the motion solvers of the JAX bench at 512^2 through
   ``motion.get_method`` with their default arguments: Lucas-Kanade on 3
   frames followed by a 12-lead ``extrapolation`` of its flow (N, the
   bench's ``extrap_512``), VET on 3 (O), Proesmans on 2 (P), DARTS on 9
   (Q) and Farneback on 3 (R), each timed once after a warm-up with its
   exact K1 launch counts and held against a CPU run of the port through
   the card's branch (N's extrapolation against the CPU's K1 path on the
   card's flow), its error against the true motion printed, and the
   same method on the card under ``tests/test_motion.py``'s bound on
   that test's frames; O also evaluates VET's cost and gradient at its
   finest scale through K1 and its backward, against autograd of the
   plain version on the same card inputs, with the backward's time;
16. postprocessing: ``ensemblestats.mean``, ``excprob`` of 1 mm/h and
   ``banddepth`` on path A's last lead on the card against the CPU;
17. verification: path A's last lead (96 x 512^2) against the synthetic
   frame of that lead: CRPS, the rank histogram, the reliability diagram
   and ROC of exceeding 1 mm/h, and on the ensemble mean FSS at three
   scales, CSI/POD/FAR, MAE/RMSE/corr, the intensity-scale matrix, the
   binary MSE and SAL, each on the card and on the CPU with its tolerance
   and its card seconds;
18. paths T and U, LINDA at 512^2 with 12 leads through
   ``nowcasts.get_method("linda")`` on the bench's rain-rate frames: T the
   JAX bench's ``linda_512`` (the domain as one feature, deterministic),
   U the module's defaults (up to 25 blob features, 10 members, BPS),
   each timed once after a warm-up with every hand kernel's launch count
   0 (LINDA advects by the exact gather).  T is held against CPU runs of
   the port (one from the card's fitted kernel spectra, one with the
   CPU's own fits, held on the fits' objectives); U's members must spread
   at every lead, and its deterministic parts (features, kernel fits,
   psi, advection mask, AR window, hindcast, error model, one
   perturbation field of one white spectrum) are held against the CPU's;
19. paths V, V', W and X, blending at the JAX bench's operating points
   through ``blending.get_method``: V STEPS blending at ``blend_512`` (96
   members x 512^2 x 12 leads), V' ``blend_1024`` (member chunks of 12,
   bfloat16 output) cut to 6 leads, W the PCA EnKF at ``pca_enkf_256``
   (24 members, 60 minutes, the NWP ensemble on the card), X linear and
   salient blending of the 512^2 extrapolation nowcast; each timed once
   after a warm-up with its exact K1 (and, on V and V', K4 from a mask)
   launches, members that spread at every lead, and a check against the
   CPU on the card's branch: V deterministic at 8 x 256^2 x 6 with the
   CPU given the card's displacement bound, V' chunks of 2 against one
   chunk and its bfloat16 output the float32 one rounded, one EnKF
   correction and nowcast step from one state, X's two methods; skill
   files go to a temporary directory;
20. paths Y, Y', A-ens and Z and the distributed verification, on a
   1 x 1 x 1 mesh of an NCCL process group that the script starts itself
   (rank 0 of 1; no other backend stands in) and destroys before its last
   line: Y ``parallel.sharded_steps.forecast`` at 96 members x 512^2 x 12
   leads with 8 levels and BPS on the bench's inputs, Y' the same at the
   CONUS grid of the JAX dry run (2048^2, 2 members, 3 levels, 1 lead),
   each timed once after a warm-up with its exact K1 and K4-from-a-mask
   launches, and each warm-up's K1 launches on the halo-extended members
   and K4 launch on the mask held against the plain versions at those
   shapes; Y's components at its shapes on its last lead's inputs card
   against CPU (the pencil FFT, the halo warp and ``sharded_warp``, the
   psum matcher, the rim mask) and the whole forecast in law against a
   CPU run at 16 x 128^2 x 6 (a spawned gloo rank); A-ens STEPS' ``mesh=``
   at path A's size as each of 2 "ens" ranks in turn, with each rank's
   launches from the code and the blocks within 3e-2 dB of the unsharded
   forecast (cuFFT rounds a block's batch otherwise); Z RainFARM's
   ``downscale_ensemble`` of the bench's 128^2 coarse field into 24
   realizations of 512^2 with no kernel launched, each realization's
   aggregate against the input and the core card against CPU on the same
   white draws; ``distributed_verify`` over path A's last lead against
   the verification phase's serial scores; V-y
   ``parallel.sharded_blending.blending_scan_sharded`` at V's size and
   keywords, on the arguments ``blending.steps.scan_inputs`` prepares,
   with its K1 launches on the halo-extended members held bit-equal to
   the plain version, its matcher, rim mask and halo warp on its last
   lead's arguments and a small whole loop (8 x 128^2 x 4, the same draws)
   card against CPU, and its law against V's; V-ens blending's ``mesh=``
   at V's size as each of 2 "ens" ranks in turn, with V's launches a
   block and the blocks within 3e-2 dB of the unsharded forecast; W-mesh
   the PCA EnKF at ``pca_enkf_256`` with the mesh against W's forecast,
   the sharded PCA fit against the SVD and ``MaskedEnKF`` with the mesh
   against it without; O-mesh VET at O's size with the mesh (no K1), its
   flow beside O's, ``tests/test_parallel.py``'s VET case against the
   unsharded exact branch and ``tests/test_motion.py``'s truth bound;
21. native: the port's C++ decoders built with the host's ``g++`` and
   ``radolan_decode`` against the NumPy decode, bit for bit;
22. path IO, the operational cycle around the nowcast through the port's
   public entry points: ``datasets.create_synthetic_dataset`` writes a
   512^2 archive of 8 NPZ frames, ``io.archive.find_by_date`` and
   ``io.readers.read_timeseries`` with the NPZ importer read the last 3,
   ``utils.transformation.dB_transform`` and Lucas-Kanade run on the card
   (no kernel launched), then path A's forecast (96 members x 512^2 x 12
   leads, the same configuration and exact launches) hands each lead
   through its callback to the NPZ exporter (``incremental="timestep"``;
   the card's machine has no h5py for the CF NetCDF writer), whose file
   ``io.nowcast_importers.import_netcdf_pysteps`` reads back bit-equal to
   the callback's frames (a SHA-256 a lead) with the importer's geodata;
   a float32 and a bfloat16 card tensor of the last lead are written and
   read back; ``plot_precip_field`` and ``motion_plot`` draw from card
   tensors where matplotlib is installed (the card's machine has none);
   ``scripts.run_vel_pert_analysis.run_analysis`` covers the archive's
   last 6 dates with Lucas-Kanade on the card and
   ``scripts.fit_vel_pert_params.fit_parameters`` fits finite parameters;
   the line gives each step's seconds, the file's size and the peak
   device memory;

each path with the launch counts set to 0 just before it and read just
after.  Then the ``kernels`` summary line (each row's ``launches`` from the
path that runs it) and, last, the ``ok`` line.  Any failed check raises,
and the script exits non-zero without the ``ok`` line.
"""

import contextlib
import datetime
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from pysteps_tpu_torch import blending  # noqa: E402
from pysteps_tpu_torch import cascade as cascade_mod  # noqa: E402
from pysteps_tpu_torch.blending import pca_ens_kalman_filter as pca_enkf_mod  # noqa: E402
from pysteps_tpu_torch.blending import steps as blend_mod  # noqa: E402
from pysteps_tpu_torch import motion, noise, nowcasts  # noqa: E402
from pysteps_tpu_torch.extrapolation import semilagrangian  # noqa: E402
from pysteps_tpu_torch.motion import farneback as farneback_mod  # noqa: E402
from pysteps_tpu_torch.motion import proesmans as proesmans_mod  # noqa: E402
from pysteps_tpu_torch.motion import vet as vet_mod  # noqa: E402
from pysteps_tpu_torch.nowcasts import anvil as anvil_mod  # noqa: E402
from pysteps_tpu_torch.nowcasts import linda as linda_mod  # noqa: E402
from pysteps_tpu_torch.nowcasts import sprog as sprog_mod  # noqa: E402
from pysteps_tpu_torch.nowcasts import sseps as sseps_mod  # noqa: E402
from pysteps_tpu_torch.noise import fftgenerators  # noqa: E402
from pysteps_tpu_torch.nowcasts import steps as steps_mod  # noqa: E402
from pysteps_tpu_torch.ops import _kernels  # noqa: E402
from pysteps_tpu_torch.ops import (  # noqa: E402
    pallas_chain, pallas_dilate, pallas_histmatch, pallas_warp,
)
from pysteps_tpu_torch.ops import warp as warp_mod  # noqa: E402
from pysteps_tpu_torch.postprocessing.probmatching import _prepare_cdf_target  # noqa: E402

sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_blending_checks as blend_checks  # noqa: E402
import torch_parallel_workers as parallel_workers  # noqa: E402
from helpers import make_synthetic_sequence  # noqa: E402
from torch_blending_checks import nanclose as _nanclose  # noqa: E402

N_MEMBERS, SIDE, N_LEADS = 96, 512, 12
AR_ORDER = 2
# the other STEPS paths, each cut in members and leads to keep the run short:
# (members, side, leads)
PATH_B = (32, 1024, 6)
PATH_C = (96, 320, 6)
# STEPS' other noise generators on the main path's grid: (members, side,
# leads, the forecast's other arguments); H cut in leads, as B and C are
NOISE_PATHS = {
    "F": (N_MEMBERS, SIDE, N_LEADS, dict(noise_method="parametric", noise_stddev_adj="auto")),
    "G": (N_MEMBERS, SIDE, N_LEADS, dict(noise_method="ssft", noise_stddev_adj="fixed")),
    "H": (N_MEMBERS, SIDE, 6, dict(noise_method="nested")),
}
# the other nowcasts, at the JAX bench's sizes (bench.py:203-310, 12 leads):
# SSEPS's members, its metadata, and the leads of its card-vs-CPU check
SSEPS_MEMBERS = 24
SSEPS_META = {"accutime": 5, "unit": "dBZ", "transform": "dB", "zerovalue": -15.0,
              "threshold": -10.0, "xpixelsize": 1000.0, "ypixelsize": 1000.0}
SSEPS_PARITY_LEADS = 4
CDF_BINS = 129  # the CDF counts' histogram: k = 0..128 edges at or below a pixel
# memory rate (bytes/s) and non-tensor-core f32 rate (FLOP/s) by card,
# from NVIDIA's data sheets; the SXM part's figures are the default
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


# outputs of earlier paths that later lines are held against: V's law
# scores (V-y) and O's flow (O-mesh)
KEPT = {}


def _law_scores_card(fc, truth):
    """``parallel_workers.law_scores`` on the card: the CRPS over the leads
    and the spread/error ratio, in rain rate, of a dB forecast (E, T, m,
    n) against the rain-rate truth (T, m, n), in float64."""
    fc = torch.as_tensor(fc).double()
    truth = torch.as_tensor(np.asarray(truth), dtype=torch.float64, device=fc.device)
    rr = 10.0 ** (fc / 10.0) * (fc > -10)
    E = rr.shape[0]
    crps = []
    for t in range(rr.shape[1]):
        ens, obs = rr[:, t].reshape(E, -1), truth[t].reshape(-1)
        ok = torch.isfinite(ens).all(dim=0) & torch.isfinite(obs)
        ens, obs = ens[:, ok], obs[ok]
        srt = torch.sort(ens, dim=0).values
        w = (2 * torch.arange(E, device=fc.device, dtype=torch.float64) + 1 - E)[:, None]
        crps.append(float(((ens - obs).abs().mean(dim=0) - (w * srt).sum(dim=0) / E**2).mean()))
    spread = torch.nanmean(rr.std(dim=0))
    err = torch.sqrt(torch.nanmean((torch.nanmean(rr, dim=0) - truth) ** 2))
    return {"crps": float(np.mean(crps)), "spread_error": float(spread / err)}


def card_peaks(name):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    return CARD_PEAKS["H100"]


def bench_inputs(side, velocity=(2.0, 1.0), n_frames=3):
    """The benchmark's inputs (``bench.py:105-122``): ``n_frames``
    synthetic frames in dB with a small perturbation, and a constant
    motion field."""
    frames = make_synthetic_sequence(
        n_frames=n_frames, shape=(side, side), velocity=velocity, seed=42
    )
    precip_db = np.where(
        frames >= 0.1, 10.0 * np.log10(np.maximum(frames, 0.1)), -15.0
    ).astype(np.float32)
    precip_db += 0.1 * np.random.RandomState(7).randn(*precip_db.shape).astype(np.float32)
    vel = np.zeros((2, side, side), np.float32)
    vel[0], vel[1] = velocity
    return precip_db, vel


def bench_rain(side, n_frames=4):
    """The other nowcasts' benchmark inputs in rain rate: four synthetic
    frames, the same sequence as :func:`bench_inputs`' (``bench.py``'s
    ``precip``)."""
    return make_synthetic_sequence(
        n_frames=n_frames, shape=(side, side), velocity=(2.0, 1.0), seed=42
    ).astype(np.float32)


BENCH_KWARGS = dict(
    n_ens_members=N_MEMBERS, n_cascade_levels=8, precip_thr=-10.0,
    kmperpixel=1.0, timestep=5, noise_method="nonparametric",
    vel_pert_method="bps", mask_method="incremental",
    probmatching_method="cdf", domain="spectral", seed=42,
)


def cuda_ms(fn, reps=20, windows=1):
    """Device time of ``fn`` in ms (CUDA events, after a warm-up): the mean
    over ``reps`` launches, the median of ``windows`` such windows."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def steady_ms(fn, reps=100, windows=5):
    """Device time of one call of ``fn`` in ms without the host's share:
    ``reps`` calls captured in one CUDA graph, the graph replayed in
    ``windows`` windows (CUDA events), the median.  A short launch called
    eagerly waits on the Python wrapper (tens of microseconds), so
    :func:`cuda_ms` times the host there, not the kernel."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    del graph
    return statistics.median(times)


def eager_ms(fn):
    """:func:`cuda_ms` over 5 windows of 100 eager calls, the host's share
    included: what the forecast loop pays a call."""
    return cuda_ms(fn, reps=100, windows=5)


def ptxas_report(log_path):
    """Each kernel's registers, static shared memory and spills from the
    ``-Xptxas -v`` report beside the library, by mangled name."""
    out, name = {}, None
    for line in open(log_path).read().splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = hit.group(1)
            out[name] = {"kernel": name}
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if hit and name:
            out[name].update(spill_stores=int(hit.group(1)), spill_loads=int(hit.group(2)))
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[name].update(registers=int(hit.group(1)),
                             smem_static=int(smem.group(1)) if smem else 0)
    return out


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
    """Build and load the kernels; returns the ptxas report by kernel."""
    t0 = time.time()
    path = _kernels.build()
    _kernels.library()
    secs = time.time() - t0
    report = ptxas_report(path.with_suffix(".log"))
    spills = {k: v for k, v in report.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    emit({"phase": "build", "seconds": round(secs, 3), "library": os.path.relpath(path, ROOT),
          "ptxas_report": os.path.relpath(path.with_suffix(".log"), ROOT),
          "kernels": len(report), "spilling": sorted(spills)})
    return report


def _record(name, source, replaces, counter, out, ref, tol, kernel, plain_ms,
            library_ms, library_call, bytes_moved, flops, peaks, path, **extra):
    """One kernel's check and numbers; raises when it disagrees.  ``out``,
    ``ref`` and ``tol`` may be tuples, one entry per output.  ``kernel``
    is the call timed: ``ms`` from a CUDA graph (:func:`steady_ms`),
    ``ms_eager`` called eagerly (:func:`eager_ms`)."""
    torch.cuda.synchronize()
    if not isinstance(out, tuple):
        out, ref, tol = (out,), (ref,), (tol,)
    err = 0.0
    for o, r_, t in zip(out, ref, tol):
        both_nan = torch.isnan(o) & torch.isnan(r_)
        if not torch.equal(torch.isnan(o), torch.isnan(r_)):
            raise AssertionError(f"{name}: NaN sets differ from the plain version")
        e = float(torch.where(both_nan, 0.0, (o - r_).abs()).max())
        if not e <= t:
            raise AssertionError(f"{name}: max |kernel - plain| = {e} > {t}")
        err = max(err, e)
    bw, fl = peaks
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fl * 1e3
    rec = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "counter": counter, "path": path, "launches": None, "max_abs_err": err,
        "tol": list(tol) if len(tol) > 1 else tol[0],
        "ms": steady_ms(kernel), "ms_eager": eager_ms(kernel), "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "library_call": library_call,
        "bytes": bytes_moved, "flops": flops, **extra,
    }
    emit(dict(rec, phase="kernel"))
    return rec


def check_slow(name, kernel, plain, args):
    """Raise unless ``kernel(*args)`` on a LUT that fails its prefix-table
    check equals ``plain(*args)`` under == (NaN where NaN)."""
    out, ref = kernel(*args), plain(*args)
    if not (torch.equal(torch.isnan(out), torch.isnan(ref))
            and torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))):
        raise AssertionError(f"{name}: the fallback for a failing LUT differs from the plain version")


def smooth_displacements(gen, batch, size, amp):
    """Smooth random (batch, 2, size, size) displacements of at most 1.6
    amp px, drawn on ``gen``'s card."""
    dev = gen.device
    yy = torch.linspace(0, 3, size, device=dev)[:, None]
    xx = torch.linspace(0, 2, size, device=dev)[None, :]
    a = torch.rand((batch, 2, 1, 1), generator=gen, device=dev) + 0.5
    return amp * torch.stack([
        a[:, 0] * torch.sin(xx + yy) + 0.1, -a[:, 1] * torch.cos(0.7 * xx - yy)
    ], dim=1)


def member_luts(gen, members, side):
    """Member fields (members, side^2) in dB around the benchmark's last
    frame, drawn on ``gen``'s card, and each member's PWL coefficients
    against that frame."""
    dev = gen.device
    precip_db, _ = bench_inputs(side)
    target = torch.as_tensor(precip_db[-1], device=dev)
    tstate = pallas_histmatch.prepare_target(*_prepare_cdf_target(target))
    noise = torch.randn((members, side, side), generator=gen, device=dev)
    x = (target[None] + 2.0 * noise).reshape(members, -1)
    return x, pallas_histmatch.build_pwl_coeffs(x, tstate)


def _grid_sample_ms(field, disp, timer=None):
    """F.grid_sample (bilinear, zeros padding) of (B, 1, m, n) fields at
    displaced positions, timed by ``timer``: a yardstick close to K1/K2,
    not the same function (no displacement clip, joint 2-D sampling, other
    edge rule)."""
    B, m, n = field.shape
    yy = torch.linspace(-1, 1, m, device=field.device)[:, None].expand(m, n)
    xx = torch.linspace(-1, 1, n, device=field.device)[None, :].expand(m, n)
    grid = torch.stack(
        [xx + disp[:, 0] * (2.0 / (n - 1)), yy + disp[:, 1] * (2.0 / (m - 1))], dim=-1
    )
    f4 = field[:, None]
    return (timer or steady_ms)(
        lambda: F.grid_sample(f4, grid, mode="bilinear", align_corners=True))


def _capture_chain_leads():
    """Path A once, outside any counted run, recording each lead's chain
    call: the largest displacements, and the last lead's inputs (the
    largest displacements of the forecast) with the edges of the PWL LUT
    build that made its LUT."""
    precip_db, velocity = bench_inputs(SIDE)
    dev = torch.device("cuda")
    leads, last, build = [], {}, {}
    real = pallas_chain.match_warp_rim
    real_build = pallas_histmatch.build_pwl_coeffs

    def build_recording(init, tstate):
        coeffs = real_build(init, tstate)
        build["edges"] = coeffs[0]
        return coeffs

    def recording(field, e8, T, q0, zval, ztrg, thr, dy, disp_t, cval, D, kr, r,
                  do_rim=True):
        leads.append({
            "max_abs_dx": float(disp_t[:, 0].abs().max()),
            "max_abs_dy": float(dy.abs().max()),
        })
        last.update(field=field, e8=e8, T=T, q0=q0, zval=zval, ztrg=ztrg, thr=thr,
                    dy=dy, disp_t=disp_t, cval=cval, D=D, kr=kr, r=r, do_rim=do_rim,
                    edges=build["edges"])
        return real(field, e8, T, q0, zval, ztrg, thr, dy, disp_t, cval, D, kr, r,
                    do_rim)

    pallas_chain.match_warp_rim = recording
    pallas_histmatch.build_pwl_coeffs = build_recording
    try:
        out = nowcasts.get_method("steps")(
            torch.as_tensor(precip_db, device=dev), torch.as_tensor(velocity, device=dev),
            N_LEADS, **BENCH_KWARGS)
        last["forecast_last_lead"] = out[:, -1].clone()
        del out
    finally:
        pallas_chain.match_warp_rim = real
        pallas_histmatch.build_pwl_coeffs = real_build
    if len(leads) != N_LEADS:
        raise AssertionError(f"path A called the chain {len(leads)} times, not {N_LEADS}")
    return leads, last


def phase_kernels(peaks, leads, captured, report):
    """Each of the eleven rows against its plain version at the shapes its
    path gives it: K1 on both axes, K4 from a mask and the chain's two
    stages at path A's, K2, K3 and K4 from a field at path B's (K2 and K4
    also at path C's, as the row's ``at_C``), the hierarchical map at path
    C's, the flat map at path D's, the CDF counts at path E's.  ``leads``
    and ``captured`` are :func:`_capture_chain_leads`' record of path A,
    ``report`` :func:`ptxas_report`'s."""

    def ptxas(*names):
        """The report's entries of the kernels a row launches."""
        return [v for k, v in sorted(report.items()) if any(n in k for n in names)]

    def k2_geometry(shape, path):
        """K2's route and tile geometry at D 48 on its own line: computed
        from its layout (``warp_geometry``) and the occupancy API, not
        measured."""
        geo = pallas_warp.warp_geometry(*shape, 48, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        if geo["route"] == "tile":
            geo.update(pallas_warp.warp_info(geo))
        emit({"phase": "k2_geometry", "computed": "from the kernel's layout and the "
              "occupancy API, not measured", "path": path, "shape": list(shape),
              "D": 48, **geo})
        return geo

    def k4_geometry(shape, path):
        """K4's tile geometry at kr 2, r 10 on its own line: computed from
        its layout and the occupancy API, not measured."""
        emit({"phase": "k4_geometry", "computed": "from the kernel's layout and the "
              "occupancy API, not measured", "path": path, "shape": list(shape),
              "R": 12, **pallas_dilate.rim_info(*shape, 2, 10)})

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    recs = []
    E, m = N_MEMBERS, SIDE
    mc = m // 4
    nan = float("nan")
    # paths B and C run the same motion for PATH_B[2] leads
    lead = leads[PATH_B[2] - 1]
    disp_bc = max(lead["max_abs_dx"], lead["max_abs_dy"])

    # K1: per-lead velocity sampling on the coarse grid, 96 members x 2
    # channels sharing one index plane per member, Dc = 12
    vel = torch.randn((E, 2, mc, mc), generator=gen, device=dev)
    disp = smooth_displacements(gen, E, mc, 14.0)
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
            lambda: pallas_warp.axis_resample(fields, idx0, frac, 12, axis),
            cuda_ms(lambda: pallas_warp._axis_resample(fields, idx0, frac, 12, axis), 5),
            _grid_sample_ms(fields, disp.repeat_interleave(2, dim=0)),
            "F.grid_sample bilinear (close, not the same function)",
            nb, 4 * fields.numel(), peaks, "A", shape=list(fields.shape),
            ptxas=ptxas("pst_resample_kernelILi%d" % axis),
            library_ms_eager=_grid_sample_ms(
                fields, disp.repeat_interleave(2, dim=0), eager_ms),
        ))

    # Operations are the least a pixel needs for the function, not what a
    # kernel's design spends: a value is placed among 128 sorted edges or
    # knots (sorted once per member, with their indices) by 8 compares; a
    # PWL map then takes its segment's multiply-add and the dry override's
    # compare and select, the counts one histogram increment
    search_ops = 8
    pwl_ops = search_ops + 4
    R = 12
    rim_ops = 4 * (2 * R + 1)

    def k2_k4(members, side, x, path):
        """K2 (the per-lead output warp, D = 48, displacements up to those of
        path A's lead PATH_B[2]) and K4 (the incremental-mask rim from the
        member fields ``x``, kr=2, r=10)."""
        field = x.reshape(members, side, side).contiguous()
        disp = smooth_displacements(gen, members, side, disp_bc / 1.6)
        dy = disp[:, 1].contiguous()
        disp_t = disp.transpose(-1, -2).contiguous()
        geo = k2_geometry(field.shape, path)
        k2 = _record(
            "K2_warp", "pysteps_tpu_torch/csrc/warp.cu",
            "pysteps_tpu/ops/pallas_warp.py:216", "warp",
            pallas_warp.warp_fused(field, dy, disp_t, 48, nan),
            # the same operations in the same order: equal under ==
            pallas_warp._warp_fused_plain(field, dy, disp_t, 48, nan), 0.0,
            lambda: pallas_warp.warp_fused(field, dy, disp_t, 48, nan),
            cuda_ms(lambda: pallas_warp._warp_fused_plain(field, dy, disp_t, 48, nan), 5),
            _grid_sample_ms(field, disp),
            "F.grid_sample bilinear (close, not the same function)",
            4 * 5 * field.numel(), 12 * field.numel(), peaks, path,
            shape=list(field.shape), warp_route=geo["route"],
            ptxas=ptxas("pst_warp_tile_kernel" if geo["route"] == "tile" else "pst_warp_"),
        )
        k4 = _record(
            "K4_rim_from_field", "pysteps_tpu_torch/csrc/rim.cu",
            "pysteps_tpu/ops/pallas_dilate.py:86", "rim_from_field",
            pallas_dilate.dilated_rim_from_field(field, -10.0, 2, 10),
            pallas_dilate._rim_plain(field, -10.0, 2, 10), 1e-6,
            lambda: pallas_dilate.dilated_rim_from_field(field, -10.0, 2, 10),
            cuda_ms(lambda: pallas_dilate._rim_plain(field, -10.0, 2, 10), 3),
            None, "none: no PyTorch call computes a bounded L1 distance transform",
            4 * 2 * field.numel(), rim_ops * field.numel(), peaks, path,
            shape=list(field.shape), rim_route=pallas_dilate.rim_route(2, 10),
            ptxas=ptxas("pst_rim_tile_kernelIfLb0"),
        )
        k4_geometry(field.shape, path)
        return k2, k4

    # path B: 32 x 1024^2; K3 the PWL apply of the member fields against
    # the benchmark target
    E_b, side_b = PATH_B[0], PATH_B[1]
    xb, (edges_b, d0_b, d1_b, q0_b, zval_b, ztrg_b) = member_luts(gen, E_b, side_b)
    e8_b, T_b = pallas_histmatch.pack_gather_lut(edges_b, d0_b, d1_b)
    k3_args = (xb, e8_b, T_b, q0_b, zval_b, ztrg_b.expand(E_b))
    ref = pallas_histmatch._pwl_apply_gather_plain(*k3_args)
    k2_b, k4_b = k2_k4(E_b, side_b, xb, "B")
    if not bool(pallas_histmatch._pwl_prefix_ok(T_b).all()):
        raise AssertionError("K3: path B's LUTs fail the prefix-table check")
    # the same LUTs with one fine edge of each member's top block made NaN:
    # the check fails, so K3 takes the 15-term sum
    T_b_slow = T_b.clone()
    T_b_slow[:, 7, 14] = float("nan")
    slow_args = k3_args[:2] + (T_b_slow,) + k3_args[3:]
    check_slow("K3", pallas_histmatch.pwl_apply_gather, pallas_histmatch._pwl_apply_gather_plain,
               slow_args)
    k3 = _record(
        "K3_pwl_gather", "pysteps_tpu_torch/csrc/pwl.cu",
        "pysteps_tpu/ops/pallas_histmatch.py:199", "pwl_gather",
        # the prefix tables' sums equal K3's 15-term sums under ==
        pallas_histmatch.pwl_apply_gather(*k3_args), ref, 0.0,
        lambda: pallas_histmatch.pwl_apply_gather(*k3_args),
        cuda_ms(lambda: pallas_histmatch._pwl_apply_gather_plain(*k3_args), 3),
        None, "none: no PyTorch call computes a per-member piecewise-linear map",
        4 * (2 * xb.numel() + e8_b.numel() + T_b.numel() + 3 * E_b),
        pwl_ops * xb.numel(), peaks, "B", shape=list(xb.shape),
        ms_slow_lut=steady_ms(lambda: pallas_histmatch.pwl_apply_gather(*slow_args)),
        ptxas=ptxas("pst_pwl_gather_kernel"),
    )
    del xb, k3_args, ref, slow_args

    # path C: 96 x 320^2; the hierarchical map, and K2 and K4 again
    E_c, side_c = PATH_C[0], PATH_C[1]
    xc, (edges_c, d0_c, d1_c, q0_c, zval_c, ztrg_c) = member_luts(gen, E_c, side_c)
    e16, M3 = pallas_chain.pack_hier_lut(edges_c, d0_c, d1_c)
    hier_args = (xc, e16, M3, q0_c, zval_c, ztrg_c.expand(E_c))
    ref = pallas_histmatch._pwl_apply_hier_plain(*hier_args)
    if not bool(pallas_histmatch._pwl_hier_prefix_ok(e16, M3).all()):
        raise AssertionError("pwl_hier: path C's LUTs fail the prefix-table check")
    # the same LUTs with the last fine edge of each member's top block made
    # NaN: the check fails, so the kernel takes the 7-term sum
    M3_slow = M3.clone()
    M3_slow[:, 6, 15] = nan
    hier_slow = (xc, e16, M3_slow) + hier_args[3:]
    check_slow("pwl_hier", pallas_histmatch.pwl_apply_hier, pallas_histmatch._pwl_apply_hier_plain,
               hier_slow)
    hier = _record(
        "pwl_hier", "pysteps_tpu_torch/csrc/pwl_variants.cu",
        "pysteps_tpu/ops/pallas_histmatch.py:284", "pwl_hier",
        # the prefix tables' sums equal the 7-term sums under ==
        pallas_histmatch.pwl_apply_hier(*hier_args), ref, 0.0,
        lambda: pallas_histmatch.pwl_apply_hier(*hier_args),
        cuda_ms(lambda: pallas_histmatch._pwl_apply_hier_plain(*hier_args), 3),
        None, "none: no PyTorch call computes a per-member piecewise-linear map",
        4 * (2 * xc.numel() + e16.numel() + M3.numel() + 3 * E_c),
        pwl_ops * xc.numel(), peaks, "C", shape=list(xc.shape),
        ms_slow_lut=steady_ms(lambda: pallas_histmatch.pwl_apply_hier(*hier_slow)),
        ptxas=ptxas("pst_pwl_hier_kernel"),
    )
    k2_c, k4_c = k2_k4(E_c, side_c, xc, "C")
    del xc, hier_args, ref, hier_slow
    at_c = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "ms_eager")
    k2_b["at_C"] = {k: k2_c[k] for k in at_c}
    k4_b["at_C"] = {k: k4_c[k] for k in at_c}
    recs += [k2_b, k3, k4_b, hier]

    # K4 at init on path A: the rim of one bool mask, as STEPS passes it
    x, (edges, d0, d1, q0, zval, ztrg) = member_luts(gen, E, m)
    mask = x[:1].reshape(1, m, m) >= -10.0
    mask_f = mask.to(torch.float32)
    recs.append(_record(
        "K4_rim_from_mask", "pysteps_tpu_torch/csrc/rim.cu",
        "pysteps_tpu/ops/pallas_dilate.py:115", "rim_from_mask",
        pallas_dilate.dilated_rim(mask, 2, 10), pallas_dilate._rim_plain(mask_f, 0.5, 2, 10),
        1e-6,
        lambda: pallas_dilate.dilated_rim(mask, 2, 10),
        cuda_ms(lambda: pallas_dilate._rim_plain(mask.to(torch.float32), 0.5, 2, 10), 3),
        None, "none: no PyTorch call computes a bounded L1 distance transform",
        # the bool mask read once, the rim written
        (1 + 4) * mask.numel(), rim_ops * mask.numel(), peaks, "A", shape=list(mask.shape),
        dtype="bool", rim_route=pallas_dilate.rim_route(2, 10),
        ptxas=ptxas("pst_rim_tile_kernelIhLb0"),
    ))
    k4_geometry(mask.shape, "A")

    # the flat map on path D's shapes: 96 x 512^2
    w = pallas_histmatch.flat_weights(d0, d1)
    edges_f = edges.contiguous()
    ref = pallas_histmatch._pwl_apply_plain(x, edges_f, w, q0)
    if not bool(pallas_histmatch._pwl_flat_prefix_ok(edges_f, w).all()):
        raise AssertionError("pwl_flat: path D's LUTs fail the prefix-table check")
    # the last edge of each member made NaN: the kernel takes the 128-term sum
    edges_slow = edges_f.clone()
    edges_slow[:, -1] = nan
    flat_slow = (x, edges_slow, w, q0)
    check_slow("pwl_flat", pallas_histmatch.pwl_apply, pallas_histmatch._pwl_apply_plain,
               flat_slow)
    recs.append(_record(
        "pwl_flat", "pysteps_tpu_torch/csrc/pwl_variants.cu",
        "pysteps_tpu/ops/pallas_histmatch.py:258", "pwl_flat",
        # the prefix table's sums equal the 128-term sums under ==
        pallas_histmatch.pwl_apply(x, edges_f, w, q0), ref, 0.0,
        lambda: pallas_histmatch.pwl_apply(x, edges_f, w, q0),
        cuda_ms(lambda: pallas_histmatch._pwl_apply_plain(x, edges_f, w, q0), 2),
        None, "none: no PyTorch call computes a per-member piecewise-linear map",
        4 * (2 * x.numel() + edges_f.numel() + w.numel() + E),
        # no dry override in this map
        (search_ops + 2) * x.numel(), peaks, "D", shape=list(x.shape),
        ms_slow_lut=steady_ms(lambda: pallas_histmatch.pwl_apply(*flat_slow)),
        ptxas=ptxas("pst_pwl_flat_kernel"),
    ))
    del x, ref, flat_slow

    # the CDF counts on path E's inputs: path A's last lead and its edges
    xe = captured["field"].reshape(E, -1)
    edges_e = captured["edges"].contiguous()
    n_px = xe.shape[1]

    def sort_search():
        return n_px - torch.searchsorted(torch.sort(xe, dim=1).values, edges_e)

    def member_hist(k):
        """The (E, 129) counts of each member's bins ``k`` (E, n_px), the
        members' bins counted in one bincount."""
        k = k + (CDF_BINS * torch.arange(E, device=dev))[:, None]
        return torch.bincount(k.reshape(-1), minlength=E * CDF_BINS).reshape(E, CDF_BINS)

    def bin_count():
        # each pixel's bin k = #{edges <= x} (searchsorted is bucketize's
        # batched form), then the suffix sums #{k > s}
        hist = member_hist(torch.searchsorted(edges_e, xe, right=True))
        return hist.flip(1).cumsum(1).flip(1)[:, 1:]

    # the hot bin, measured: each member's largest bin of the kernel's
    # histogram (k = #{s : x >= sorted[s]}, the plain model's search)
    srt, _ = pallas_histmatch._cdf_sort(edges_e)
    largest = member_hist(pallas_histmatch._tree_count(xe, srt, 7)).max(dim=1)
    emit({"phase": "cdf_bins", "path": "E", "shape": list(xe.shape), "bins": CDF_BINS,
          "largest_bin_share_max": float(largest.values.max()) / n_px,
          "largest_bin_share_median": float(largest.values.float().median()) / n_px,
          "largest_bin_of_member0": int(largest.indices[0]),
          "dry_share_member0": float((xe[0] == xe[0].min()).float().mean())})
    # every pixel of a member equal to one of its edges: all in one bin
    x_one = edges_e[:, 5:6].expand(E, n_px).contiguous()
    one = pallas_histmatch.cdf_counts(x_one, edges_e)
    err_one = float((one - pallas_histmatch._cdf_counts_plain(x_one, edges_e)).abs().max())
    if err_one != 0.0:
        raise AssertionError(f"cdf_counts: one-value field differs from the plain version by {err_one}")
    counts = pallas_histmatch.cdf_counts(xe, edges_e)
    recs.append(_record(
        "cdf_counts", "pysteps_tpu_torch/csrc/cdf.cu",
        "pysteps_tpu/ops/pallas_histmatch.py:236", "cdf_counts",
        counts, pallas_histmatch._cdf_counts_plain(xe, edges_e), 0.0,
        lambda: pallas_histmatch.cdf_counts(xe, edges_e),
        cuda_ms(lambda: pallas_histmatch._cdf_counts_plain(xe, edges_e), 2),
        steady_ms(sort_search),
        "torch.sort + torch.searchsorted (two calls; the same counts only for "
        "sorted edges without NaN)",
        # the field read once, the edges read, the counts written
        4 * xe.numel() + 4 * 2 * edges_e.numel(),
        # the search and one increment a pixel; the per-member sort of the
        # edges and the suffix sum of the 129 bins are negligible beside it
        (search_ops + 1) * xe.numel(), peaks, "E", shape=list(xe.shape),
        library_same_counts=torch.equal(sort_search().to(torch.float32), counts),
        # bincount reads its largest value back to the host, so no CUDA
        # graph: eager device time
        library_hist_ms=cuda_ms(bin_count, 20, 5),
        library_hist_call="torch.searchsorted (bucketize's batched form) + torch.bincount + "
        "torch.cumsum (eager; the same counts only for sorted edges without NaN)",
        library_hist_same_counts=torch.equal(bin_count().to(torch.float32), counts),
        ms_one_value=steady_ms(lambda: pallas_histmatch.cdf_counts(x_one, edges_e)),
        max_abs_err_one_value=err_one,
        ptxas=ptxas("pst_cdf_counts_kernel"),
    ))
    del x_one

    # the chain on path A's own inputs: its last lead, recorded from a
    # forecast at the headline configuration
    a = captured
    field, e8, T, dy, disp_t = a["field"], a["e8"], a["T"], a["dy"], a["disp_t"]
    q0, zval, ztrg, thr, cval = a["q0"], a["zval"], a["ztrg"], a["thr"], a["cval"]
    D, kr, r, do_rim = pallas_warp._round8(a["D"]), a["kr"], a["r"], a["do_rim"]
    B, m, n = field.shape
    ztrg_b = ztrg.expand(B)
    v_args = (field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r, do_rim)
    if not bool(pallas_histmatch._pwl_prefix_ok(T).all()):
        raise AssertionError("chain stage 1: path A's LUTs fail the prefix-table check")
    # the same LUTs with one fine edge of each member's top block made NaN:
    # the check fails, so stage 1 takes K3's 15-term sum
    T_slow = T.clone()
    T_slow[:, 7, 14] = float("nan")

    def unfused():
        """K3 -> K4 -> K2, the path the chain replaces, on the same inputs."""
        matched = pallas_histmatch.pwl_apply_gather(
            field.reshape(B, -1), e8, T, q0, zval, ztrg_b).reshape(field.shape)
        pallas_dilate.dilated_rim_from_field(matched, thr, kr, r)
        return pallas_warp.warp_fused(matched, dy, disp_t, D, cval)

    def plain_v(lut):
        return pallas_chain._chain_v_plain(
            field, e8, lut, q0, zval, ztrg_b, thr, dy, D, kr, r, do_rim)

    C, rim = pallas_chain.chain_match_vert_rim(*v_args)
    C_ref, rim_ref = plain_v(T)
    # the map evaluations stage 1 stores, counted on the card by its
    # counting instantiation, against what its geometry says they must be
    C_c, rim_c, matches = pallas_chain.stage1_matches(*v_args)
    geometry = pallas_chain.stage1_info(m, n, D, kr, r, do_rim)
    emit({"phase": "stage1_geometry", "computed": "from the kernel's geometry and "
          "the occupancy API, not measured", "shape": [m, n], "D": D, "R": kr + r,
          **geometry})
    matches_per_output = matches / field.numel()
    if not (torch.equal(C_c.nan_to_num(), C.nan_to_num()) and torch.equal(rim_c, rim)
            and matches_per_output == geometry["matches_per_output"]):
        raise AssertionError(
            f"chain stage 1: the counting build matched {matches_per_output} pixels per "
            f"output, not {geometry['matches_per_output']}, or gave other outputs")
    slow_args = v_args[:2] + (T_slow,) + v_args[3:]
    C_s, rim_s = pallas_chain.chain_match_vert_rim(*slow_args)
    C_sref, rim_sref = plain_v(T_slow)
    torch.cuda.synchronize()
    if not (torch.equal(torch.isnan(C_s), torch.isnan(C_sref))
            and torch.equal(torch.nan_to_num(C_s), torch.nan_to_num(C_sref))
            and float((rim_s - rim_sref).abs().max()) <= 1e-6):
        raise AssertionError("chain stage 1: the 15-term fallback differs from the plain version")
    timing = {
        "chain_ms": steady_ms(lambda: pallas_chain.match_warp_rim(
            field, e8, T, q0, zval, ztrg, thr, dy, disp_t, cval, D, kr, r, do_rim)),
        "unfused_ms": steady_ms(unfused),
    }
    plane = 4 * field.numel()
    recs.append(_record(
        "chain_match_vert_rim", "pysteps_tpu_torch/csrc/chain.cu",
        "pysteps_tpu/ops/pallas_chain.py:277", "chain_match_vert_rim", (C, rim),
        # C equal under == (NaN where NaN), the rim within 1e-6
        (C_ref, rim_ref), (0.0, 1e-6),
        lambda: pallas_chain.chain_match_vert_rim(*v_args),
        cuda_ms(lambda: plain_v(T), 3),
        None, "none: no PyTorch call computes a PWL map, a resample and a rim",
        # field and dy read, C and the rim written; the LUTs
        4 * plane + 4 * (e8.numel() + T.numel() + 3 * B),
        # the match, one lerp, the rim's two min passes
        (pwl_ops + 6 + rim_ops) * field.numel(), peaks, "A", shape=list(field.shape),
        ms_slow_lut=steady_ms(lambda: pallas_chain.chain_match_vert_rim(*slow_args)),
        matches_per_output=matches_per_output,
        ptxas=ptxas("pst_chain_v_kernelILb0"), leads=leads, **timing,
    ))
    out = pallas_chain.chain_horiz(C, disp_t, D, cval)
    ref = pallas_warp._warp_h_plain(C, disp_t, D, cval)
    span = float(C_ref.max() - C_ref.min())
    recs.append(_record(
        "chain_horiz", "pysteps_tpu_torch/csrc/chain.cu",
        "pysteps_tpu/ops/pallas_chain.py:301", "chain_horiz", out, ref, 1e-5 * span,
        lambda: pallas_chain.chain_horiz(C, disp_t, D, cval),
        cuda_ms(lambda: pallas_warp._warp_h_plain(C, disp_t, D, cval), 5),
        _grid_sample_ms(C, disp_t.transpose(-1, -2)),
        "F.grid_sample bilinear (close, not the same function)",
        # C and the two displacement planes read, the output written
        4 * plane,
        # one lerp and the in-domain test
        12 * field.numel(), peaks, "A", shape=list(field.shape),
        ptxas=ptxas("pst_chain_h_kernel"), **timing,
    ))
    return recs


def _deterministic_run(precip, velocity, device, side, E, T):
    """Deterministic STEPS init + loop with the main path's statics
    (max_disp 48, coarse 4, PWL matcher, the fused chain) on ``device``."""
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
        pwl_match=True, use_chain=True,
    )
    return out.cpu().numpy()


def phase_parity():
    """Card against CPU on the same statics, both through the chain (the
    card's two kernels, the CPU's plain version); a non-integer motion keeps
    sampling positions off the domain edge, where the NaN set would hang
    on FFT rounding."""
    side, E, T = 256, 8, 6
    precip, velocity = bench_inputs(side, velocity=(1.7, 0.6))
    _kernels.reset_launches()
    t0 = time.time()
    gpu = _deterministic_run(precip, velocity, "cuda", side, E, T)
    t1 = time.time()
    if _kernels.LAUNCHES["chain_horiz"] != T:
        raise AssertionError(f"parity: the card's loop did not take the chain: {_kernels.LAUNCHES}")
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


def _check_launches(label, launches, expected):
    expected = dict(dict.fromkeys(launches, 0), **expected)
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches} != expected {expected}")


def _forecast_path(label, E, side, T, expected, name, smi, extra=None):
    """Drive ``nowcasts.get_method("steps")`` at ``E`` members x ``side``^2
    x ``T`` leads with the benchmark's configuration (updated by
    ``extra``): once to warm up, then timed with the launch counts set to 0
    just before and read just after.  Raises unless the counts are
    ``expected`` (every other kernel 0) and the output is a plausible
    forecast whose members spread at every lead."""
    precip_db, velocity = bench_inputs(side)
    dev = torch.device("cuda")
    p = torch.as_tensor(precip_db, device=dev)
    v = torch.as_tensor(velocity, device=dev)
    f = nowcasts.get_method("steps")
    kw = dict(BENCH_KWARGS, n_ens_members=E, **(extra or {}))
    out = f(p, v, T, **kw)
    float(torch.nanmean(out))
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.time()
    out, init_s, loop_s = f(p, v, T, **dict(kw, seed=43, measure_time=True))
    checksum = float(torch.nanmean(out))
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    if tuple(out.shape) != (E, T, side, side):
        raise AssertionError(f"{label}: output shape {tuple(out.shape)}")
    if torch.isinf(out).any():
        raise AssertionError(f"{label}: infinite values in the output")
    finite = torch.isfinite(out).float().mean(dim=(0, 2, 3)).cpu().numpy()
    # only the inflow band (sources outside the domain) may be NaN
    if finite[0] < 0.95 or finite[-1] < 0.75:
        raise AssertionError(f"{label}: finite fraction per lead {finite.tolist()}")
    fin = out[torch.isfinite(out)]
    lo, hi = float(p[-1].min()), float(p[-1].max())
    if float(fin.min()) < lo - 1e-3 or float(fin.max()) > hi + 1e-3:
        raise AssertionError(f"{label}: matched values outside the target's range")
    _check_launches(label, launches, expected)
    # the members' standard deviation, averaged over each lead's pixels
    spread = torch.nanmean(out.std(dim=0).reshape(T, -1), dim=1).cpu().numpy()
    if not bool((spread > 0).all()):
        raise AssertionError(f"{label}: no ensemble spread at some lead: {spread.tolist()}")
    emit({"phase": f"path {label}", "shape": list(out.shape), **(extra or {}),
          "spread_per_lead": spread.tolist(),
          "member_frames_per_s": E * T / wall, "wall_s": wall, "init_s": init_s,
          "loop_s": loop_s, "max_memory_allocated": peak,
          "finite_fraction_first_last_lead": [float(finite[0]), float(finite[-1])],
          "checksum": checksum, "launches": launches,
          "device": name, "nvidia_smi": smi})
    return launches


def _k1_launches(T):
    """K1 launches per axis in one forecast: the init integrates ar_order
    unit steps of 2 velocity samples each and warps the inputs once (each
    sample or warp one launch per axis); every lead takes 2 samples."""
    return AR_ORDER * 2 + 1 + 2 * T


def phase_paths(name, smi, captured):
    """Paths A-E, each with its exact launch counts; returns them by path.
    ``captured`` holds path A's last lead (:func:`_capture_chain_leads`)."""
    by_path = {}
    k1 = _k1_launches(N_LEADS)
    # A: every lead runs the chain's two stages; the init one rim of a mask
    by_path["A"] = _forecast_path("A", N_MEMBERS, SIDE, N_LEADS, {
        "resample_axis0": k1, "resample_axis1": k1, "chain_match_vert_rim": N_LEADS,
        "chain_horiz": N_LEADS, "rim_from_mask": 1}, name, smi)
    # B and C: every lead runs a match, a rim and a warp
    for label, (E, side, T), matcher in (("B", PATH_B, "pwl_gather"),
                                         ("C", PATH_C, "pwl_hier")):
        k1 = _k1_launches(T)
        by_path[label] = _forecast_path(label, E, side, T, {
            "resample_axis0": k1, "resample_axis1": k1, "warp": T, matcher: T,
            "rim_from_field": T, "rim_from_mask": 1}, name, smi)

    # D: the public flat matcher on 96 members x 512^2, held against the
    # gather matcher (the same map in another LUT layout)
    dev = torch.device("cuda")
    precip_db, _ = bench_inputs(SIDE)
    target = torch.as_tensor(precip_db[-1], device=dev)
    tstate = pallas_histmatch.prepare_target(*_prepare_cdf_target(target))
    gen = torch.Generator(device=dev).manual_seed(1)
    fields = target[None] + 2.0 * torch.randn((N_MEMBERS, SIDE, SIDE), generator=gen, device=dev)
    fields = torch.maximum(fields, target.min())
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.time()
    flat = pallas_histmatch.match_cdf_pwl_flat(fields, tstate)
    torch.cuda.synchronize()
    wall = time.time() - t0
    by_path["D"] = dict(_kernels.LAUNCHES)
    _check_launches("D", by_path["D"], {"pwl_flat": 1})
    gather = pallas_histmatch.match_cdf_pwl(fields, tstate)
    err = float((flat - gather).abs().max())
    if tuple(flat.shape) != tuple(fields.shape) or not bool(torch.isfinite(flat).all()):
        raise AssertionError("D: the flat match is not a finite field of the input's shape")
    # the two sum up to 128 terms in other orders: f32's bound for that is
    # 2 x 128 x 2^-24 of the sum of the terms' magnitudes, which the deltas
    # make large where the target's CDF is steep
    _, d0, d1, q0, _, _ = pallas_histmatch.build_pwl_coeffs(fields.reshape(N_MEMBERS, -1), tstate)
    mag = q0.abs() + d0.abs().sum(1) + fields.abs().amax((1, 2)) * d1.abs().sum(1)
    tol = 2 * 128 * 2.0**-24 * float(mag.max())
    if err > tol:
        raise AssertionError(f"D: flat and gather maps differ by {err} > {tol}")
    emit({"phase": "path D", "shape": list(flat.shape), "wall_s": wall,
          "max_abs_diff_flat_vs_gather": err, "tol": tol,
          "launches": by_path["D"], "device": name, "nvidia_smi": smi})
    del fields, flat, gather

    # E: the public cdf_counts on path A's last lead, at the edges its LUT
    # build placed; all 128 counts bit-equal to the plain version, whose
    # last 16 are the build's exact tail counts #(x >= e_j), the same
    # compare and sum
    field, edges = captured["field"], captured["edges"]
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.time()
    counts = pallas_histmatch.cdf_counts(field, edges)
    torch.cuda.synchronize()
    wall = time.time() - t0
    by_path["E"] = dict(_kernels.LAUNCHES)
    _check_launches("E", by_path["E"], {"cdf_counts": 1})
    n_px = field[0].numel()
    if tuple(counts.shape) != (field.shape[0], 128) or not bool(torch.isfinite(counts).all()):
        raise AssertionError(f"E: counts of shape {tuple(counts.shape)} or not finite")
    if not torch.equal(counts, pallas_histmatch._cdf_counts_plain(field.reshape(len(field), -1),
                                                                   edges)):
        raise AssertionError("E: the counts differ from the plain version's")
    # the build sorts its edges, so the counts fall from at most n_px
    if not (bool((counts[:, 1:] <= counts[:, :-1]).all()) and float(counts.max()) <= n_px):
        raise AssertionError("E: the counts do not fall along the sorted edges")
    emit({"phase": "path E", "shape": list(field.shape), "wall_s": wall,
          "equal_to_plain": True, "counts_first_last_member0": [
              float(counts[0, 0]), float(counts[0, -1])],
          "launches": by_path["E"], "device": name, "nvidia_smi": smi})

    # F, G, H: the other noise generators launch exactly what path A does
    for label, (E, side, T, extra) in NOISE_PATHS.items():
        k1 = _k1_launches(T)
        by_path[label] = _forecast_path(label, E, side, T, {
            "resample_axis0": k1, "resample_axis1": k1, "chain_match_vert_rim": T,
            "chain_horiz": T, "rim_from_mask": 1}, name, smi, extra)
    return by_path


def _card_and_cpu(build, x_card, x_cpu):
    """``build`` on the card (once to warm up, then timed) and on the CPU;
    returns (card result, CPU result, card s, CPU s)."""
    build(x_card)
    torch.cuda.synchronize()
    t0 = time.time()
    card = build(x_card)
    torch.cuda.synchronize()
    t1 = time.time()
    cpu = build(x_cpu)
    return card, cpu, t1 - t0, time.time() - t1


def _held(label, card, cpu, rtol, of_max, **extra):
    """Raise unless ``card`` is within ``rtol`` of ``cpu`` (plus ``rtol``
    x max|cpu| absolute with ``of_max``); print the comparison."""
    torch.cuda.synchronize()
    c = torch.as_tensor(card).detach().cpu().double()
    r = torch.as_tensor(cpu).detach().double()
    if c.shape != r.shape or not bool(torch.isfinite(c).all()):
        raise AssertionError(f"noise_parity {label}: shape {tuple(c.shape)} or not finite")
    atol = rtol * float(r.abs().max()) if of_max else 0.0
    excess = float(((c - r).abs() - (atol + rtol * r.abs())).max())
    emit({"phase": "noise_parity", "what": label, "shape": list(c.shape),
          "max_abs_diff": float((c - r).abs().max()),
          "max_rel_diff": float(((c - r).abs() / r.abs().clamp(min=1e-30)).max()),
          "rtol": rtol, "atol": atol, **extra})
    if excess > 0:
        raise AssertionError(f"noise_parity {label}: card and CPU differ beyond rtol {rtol}")


def phase_noise_parity(name, smi):
    """STEPS' other noise filters and the std adjustment built on the card
    and on the CPU from path A's aligned 512^2 inputs (aligned on the card,
    the same tensor copied to the CPU), the adjustment from the same white
    draws on both devices.  Tolerances: the radial PSD and the SSFT and
    nested stacks rtol 1e-4 (the stacks with 1e-4 x max absolute: cuFFT
    against the CPU's FFT in float32), the 4 fitted power-law parameters
    rtol 1e-3 (1e-6 absolute for one at its bound 0) and the parametric
    filter rtol 1e-3, the std adjustments rtol 1e-4."""
    precip_db, velocity = bench_inputs(SIDE)
    dev = torch.device("cuda")
    p = torch.as_tensor(precip_db, device=dev)
    v = torch.as_tensor(velocity, device=dev)
    aligned = steps_mod._lagrangian_alignment(p, v, max_disp=steps_mod._MAX_DISP)
    aligned_cpu = aligned.cpu()
    common = {"device": name, "nvidia_smi": smi}

    ones = torch.ones((SIDE, SIDE))
    psd_card, psd_cpu, s_card, s_cpu = _card_and_cpu(
        lambda x: fftgenerators._param_psd(x, ones.to(x.device)), aligned, aligned_cpu)
    _held("parametric radial PSD", psd_card, psd_cpu, 1e-4, False, card_s=s_card,
          cpu_s=s_cpu, **common)
    init_param = noise.get_method("parametric")[0]
    par_card, par_cpu, s_card, s_cpu = _card_and_cpu(init_param, aligned, aligned_cpu)
    if par_card["field"].device.type != "cuda":
        raise AssertionError("noise_parity: the parametric filter was not built on the card")
    excess = np.abs(par_card["pars"] - par_cpu["pars"]) - (1e-6 + 1e-3 * np.abs(par_cpu["pars"]))
    emit({"phase": "noise_parity", "what": "parametric power-law parameters",
          "card": par_card["pars"].tolist(), "cpu": par_cpu["pars"].tolist(),
          "rtol": 1e-3, "atol": 1e-6, **common})
    if float(excess.max()) > 0:
        raise AssertionError("noise_parity: the fitted power-law parameters differ")
    _held("parametric filter", par_card["field"], par_cpu["field"], 1e-3, False,
          card_s=s_card, cpu_s=s_cpu, **common)

    stacks = {}
    for method, kw in (("ssft", {}), ("nested", {"max_level": 3})):
        init = noise.get_method(method)[0]
        card, cpu, s_card, s_cpu = _card_and_cpu(lambda x: init(x, **kw), aligned, aligned_cpu)
        if card["field"].device.type != "cuda":
            raise AssertionError(f"noise_parity: the {method} stack was not built on the card")
        _held(f"{method} stack {kw}", card["field"], cpu["field"], 1e-4, True,
              card_s=s_card, cpu_s=s_cpu, **common)
        stacks[method] = (card, cpu)

    # the std adjustment: 20 white fields drawn once, handed to both devices
    bp = steps_mod.cascade.get_method("gaussian")((SIDE, SIDE), 8)
    normal = torch.randn((20, SIDE, SIDE), generator=torch.Generator().manual_seed(3))
    real_draw = fftgenerators._white_normal
    fftgenerators._white_normal = lambda g, shape, batch: normal.to(g.device)
    try:
        for label, (card, cpu) in (("parametric", (par_card, par_cpu)),
                                   ("ssft", stacks["ssft"])):
            adjs = noise.utils.compute_noise_stddev_adjs

            def run(F, x):
                return adjs(x[-1], -10.0, float(x.min()), bp, None, F, None, 20)

            run(card, aligned)
            torch.cuda.synchronize()
            t0 = time.time()
            a_card = run(card, aligned)
            torch.cuda.synchronize()
            t1 = time.time()
            a_cpu = run(cpu, aligned_cpu)
            _held(f"noise_stddev_adjs {label}", a_card, a_cpu, 1e-4, False,
                  card_s=t1 - t0, cpu_s=time.time() - t1, **common)
    finally:
        fftgenerators._white_normal = real_draw


def _timed_nowcast(label, f, args, kw, expected, frames, warm_up=None):
    """``f(*args, **kw)`` once to warm up (inside the context ``warm_up``
    where given), then timed with the launch counts set to 0 just before
    and read just after (with ``measure_time=True`` where ``f`` takes it).
    Raises unless the counts are ``expected``; returns (output, record)."""
    with warm_up or contextlib.nullcontext():
        f(*args, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = takes_measure_time(f)
    _kernels.reset_launches()
    t0 = time.time()
    res = f(*args, **dict(kw, measure_time=True)) if timed else f(*args, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    out, init_s, loop_s = res if timed else (res, None, None)
    _check_launches(label, launches, expected)
    if torch.isinf(out).any():
        raise AssertionError(f"{label}: infinite values in the output")
    return out, {"wall_s": wall, "init_s": init_s, "loop_s": loop_s,
                 "frames_per_s": frames / wall, "max_memory_allocated": peak,
                 "launches": launches}


def nowcast_path(label, dev):
    """Path ``label`` (I-M) on ``dev``: (forecast function, positional
    arguments, keyword arguments, frames a forecast makes)."""
    precip_db, velocity = bench_inputs(SIDE)
    rain = bench_rain(SIDE)
    v = torch.as_tensor(velocity, device=dev)
    T = N_LEADS
    if label == "I":  # the bench's LK flow replaced by the given velocity
        return (nowcasts.get_method("extrapolation"),
                (torch.as_tensor(precip_db[-1], device=dev), v, T), {}, T)
    if label == "J":
        return (nowcasts.get_method("lagrangian_probability"),
                (torch.as_tensor(rain[2], device=dev), v, T), dict(threshold=1.0, slope=2), T)
    if label == "K":
        return (nowcasts.get_method("sprog"), (torch.as_tensor(precip_db, device=dev), v, T),
                dict(n_cascade_levels=8, precip_thr=-10.0), T)
    if label == "L":
        return (nowcasts.get_method("anvil"), (torch.as_tensor(rain, device=dev), v, T),
                dict(n_cascade_levels=8), T)
    E = SSEPS_MEMBERS
    return (nowcasts.get_method("sseps"),
            (torch.as_tensor(precip_db, device=dev), dict(SSEPS_META), v, T),
            dict(n_ens_members=E, n_cascade_levels=6, win_size=SIDE // 2,
                 vel_pert_method=None, seed=43), E * T)


def takes_measure_time(f):
    return "measure_time" in inspect.signature(f).parameters


def phase_nowcasts(name, smi):
    """Paths I-M: the extrapolation, Lagrangian probability, S-PROG, ANVIL
    and SSEPS nowcasts through ``nowcasts.get_method`` at the JAX bench's
    sizes, each timed with its exact launch counts and held against a CPU
    run of the port on the same inputs; returns the counts by path."""
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    T = N_LEADS
    precip_db, velocity = bench_inputs(SIDE)
    rain = bench_rain(SIDE)
    v = torch.as_tensor(velocity, device=dev)
    common = {"device": name, "nvidia_smi": smi}
    by_path = {}
    k1 = 3 * T  # per lead: two velocity samples and the warp, one launch an axis each

    # I: 12-lead extrapolation of the last dB field (the bench's LK flow
    # replaced by the given velocity: motion/ is not ported)
    f, args, kw, frames = nowcast_path("I", dev)
    out, rec = _timed_nowcast("I", f, args, kw, {"resample_axis0": k1, "resample_axis1": k1},
                              frames)
    ref = f(precip_db[-1], velocity, T, device="cpu")
    held = _nanclose("I", out, ref, 1e-4)
    by_path["I"] = rec["launches"]
    emit({"phase": "path I", "shape": list(out.shape), **rec, "card_vs_cpu": held, **common})

    # J: exceedance probability of 1 mm/h from the rain rate, slope 2
    f, args, kw, frames = nowcast_path("J", dev)
    out, rec = _timed_nowcast("J", f, args, kw, {"resample_axis0": k1, "resample_axis1": k1},
                              frames)
    ref = f(rain[2], velocity, T, threshold=1.0, slope=2, device="cpu")
    # cuFFT and the CPU's FFT round the window sums differently by about
    # 1e-7 of the largest sum; where few valid pixels share a window (the
    # inflow band) that reaches 1e-4 of a probability
    held = _nanclose("J", out, ref, 1e-4, of_span=False, frac=0.999, mean_rel=1e-6,
                     max_rel=1e-3)
    by_path["J"] = rec["launches"]
    emit({"phase": "path J", "shape": list(out.shape), **rec, "card_vs_cpu": held, **common})

    # K: S-PROG on 3 dB fields, 8 levels; the init aligns with K1 too
    # (2 unit steps of 2 samples and one warp); the CPU runs the card's
    # path (bound 48, PWL map) through the plain versions
    f, args, kw, frames = nowcast_path("K", dev)
    k1_k = AR_ORDER * 2 + 1 + k1
    out, rec = _timed_nowcast("K", f, args, kw, {"resample_axis0": k1_k,
                                                 "resample_axis1": k1_k, "pwl_gather": T},
                              frames)
    card_path = sprog_mod._scan_path(dev, (SIDE, SIDE), v, T)
    real_path = sprog_mod._scan_path
    sprog_mod._scan_path = lambda *a: card_path
    try:
        ref = f(precip_db, velocity, T, device="cpu", **kw)
    finally:
        sprog_mod._scan_path = real_path
    held = _nanclose("K", out, ref, 1e-3, frac=0.999, mean_rel=1e-4)
    by_path["K"] = rec["launches"]
    emit({"phase": "path K", "shape": list(out.shape), **rec, "path": list(card_path),
          "card_vs_cpu": held, **common})

    # L: ANVIL on 4 rain-rate fields as VIL, 8 levels; the loop's bound
    # comes from the velocity (the init takes the exact gather on both)
    f, args, kw, frames = nowcast_path("L", dev)
    out, rec = _timed_nowcast("L", f, args, kw, {"resample_axis0": k1, "resample_axis1": k1},
                              frames)
    ref = f(rain, velocity, T, device="cpu", **kw)
    whole = _nanclose("L whole forecast", out, ref, 1e-3, frac=0.999, mean_rel=1e-6)
    # the warp alone: the loop from the CPU's init, K1 against the exact gather
    w = torch.tensor(cascade_mod.get_method("gaussian")((SIDE, SIDE), 8)["weights_2d"],
                     dtype=torch.float32)
    rain_t, vel_t = torch.as_tensor(rain), torch.as_tensor(velocity)
    window0, phi, mask, rr_mask = anvil_mod._anvil_init(
        rain_t, vel_t, w, torch.ones((SIDE, SIDE), dtype=torch.bool), 2, 50, 1, 1)
    zeros = torch.zeros((SIDE, SIDE))
    dom = torch.zeros((SIDE, SIDE), dtype=torch.bool)
    max_disp = max(int(np.ceil(T * (float(vel_t.abs().max()) + 0.5))) + 2, 3)
    scans = [anvil_mod._anvil_scan(*[x.to(d) for x in (window0, vel_t, phi, mask, rr_mask,
                                                        zeros, zeros, dom)],
                                   T, False, True, 1, 1, max_disp=md)
             for d, md in ((dev, max_disp), (cpu, None))]
    held = _nanclose("L", scans[0], scans[1], 1e-4)
    by_path["L"] = rec["launches"]
    emit({"phase": "path L", "shape": list(out.shape), **rec, "max_disp": max_disp,
          "card_vs_cpu": held, "card_vs_cpu_whole_forecast": whole, **common})

    # M: SSEPS, 24 members, windows of 256, 6 levels, no velocity
    # perturbation: per lead two coarse velocity samples (K1), the match
    # (K3), the rim (K4 from a field) and the warp (K2); the init's rim
    # from a mask
    f, args, kw, frames = nowcast_path("M", dev)
    E = SSEPS_MEMBERS
    out, rec = _timed_nowcast("M", f, args, kw, {
        "resample_axis0": 2 * T, "resample_axis1": 2 * T, "warp": T, "pwl_gather": T,
        "rim_from_field": T, "rim_from_mask": 1}, frames)
    spread = torch.nanmean(out.std(dim=0).reshape(T, -1), dim=1).cpu().numpy()
    if not bool((spread > 0).all()):
        raise AssertionError(f"M: no ensemble spread at some lead: {spread.tolist()}")
    fin = out[torch.isfinite(out)]
    value_range = [float(fin.min()), float(fin.max())]
    # the card's path on the CPU (the same bound and PWL map through the
    # plain versions), both on the same white draws, over the first leads
    Tp = SSEPS_PARITY_LEADS
    vmax = float(np.abs(velocity).max())
    card_path = sseps_mod._scan_path(dev, (SIDE, SIDE), vmax, Tp)
    gen = torch.Generator().manual_seed(11)
    draws = [torch.randn((E, SIDE, SIDE), generator=gen) for _ in range(Tp)]
    real_white, real_path = fftgenerators._white_normal, sseps_mod._scan_path
    runs = []
    try:
        for d in (dev, cpu):
            it = iter(draws)
            fftgenerators._white_normal = lambda g, shape, batch: next(it).to(g.device)
            sseps_mod._scan_path = lambda *a: card_path
            t0 = time.time()
            runs.append(f(precip_db, dict(SSEPS_META), velocity, Tp, device=d, **kw))
            runs[-1] = (runs[-1].cpu(), time.time() - t0)
    finally:
        fftgenerators._white_normal, sseps_mod._scan_path = real_white, real_path
    held = _nanclose("M", runs[0][0], runs[1][0], 1e-3, frac=0.999, mean_rel=1e-4)
    by_path["M"] = rec["launches"]
    emit({"phase": "path M", "shape": list(out.shape), **rec,
          "member_frames_per_s": E * T / rec["wall_s"], "spread_per_lead": spread.tolist(),
          "value_range": value_range,
          "observation_range": [float(precip_db[-1].min()), float(precip_db[-1].max())],
          "path": list(card_path), "card_vs_cpu": dict(held, leads=Tp, card_s=runs[0][1],
                                                       cpu_s=runs[1][1]), **common})
    return by_path


def phase_streaming(name, smi, expected):
    """Path S: path A with a callback and ``return_output=False``: chunks
    of at most 6 leads reach the host, the frames equal a returning run
    of A with the same seed within 1e-5 (the JAX package's own test of
    the mode), and the peak device memory is lower than that run's."""
    dev = torch.device("cuda")
    precip_db, velocity = bench_inputs(SIDE)
    p = torch.as_tensor(precip_db, device=dev)
    v = torch.as_tensor(velocity, device=dev)
    f = nowcasts.get_method("steps")
    kw = dict(BENCH_KWARGS, seed=44)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full = f(p, v, N_LEADS, **kw).cpu().numpy()
    peak_full = torch.cuda.max_memory_allocated()
    frames = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launches()
    t0 = time.time()
    res, init_s, loop_s = f(p, v, N_LEADS, callback=frames.append, return_output=False,
                            measure_time=True, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_launches("S", launches, expected)
    if res is not None or len(frames) != N_LEADS:
        raise AssertionError(f"S: returned {type(res)} with {len(frames)} frames")
    if not all(isinstance(fr, np.ndarray) for fr in frames):
        raise AssertionError("S: the callback did not get numpy frames")
    streamed = np.stack(frames, axis=1)
    if not np.array_equal(np.isnan(streamed), np.isnan(full)):
        raise AssertionError("S: NaN sets of the streamed and the full run differ")
    err = float(np.nanmax(np.abs(streamed - full)))
    if err > 1e-5:
        raise AssertionError(f"S: streamed frames differ from the full run by {err}")
    if peak >= peak_full:
        raise AssertionError(f"S: peak memory {peak} not below the full run's {peak_full}")
    emit({"phase": "path S", "shape": list(streamed.shape), "max_abs_diff_vs_full": err,
          "atol": 1e-5, "max_memory_allocated": peak, "max_memory_allocated_full": peak_full,
          "member_frames_per_s": N_MEMBERS * N_LEADS / wall, "wall_s": wall,
          "init_s": init_s, "loop_s": loop_s, "launches": launches,
          "device": name, "nvidia_smi": smi})
    return launches


# the motion solvers of the JAX bench at 512^2 (bench.py:92-100, :364-380):
# path label -> (registry name, frames)
MOTION_PATHS = {"N": ("lk", 3), "O": ("vet", 3), "P": ("proesmans", 2), "Q": ("darts", 9),
                "R": ("farneback", 3)}
# tests/test_motion.py's cases (its 200^2 frames, seed 3, no perturbation):
# frames, the bound on the flow's relative RMSE against the true (2, 1)
# 20 px from the borders (its lines 32-41), options.  The bench's inputs
# carry a 0.1 dB perturbation over the -15 dB dry floor, which Proesmans
# and Farneback diffuse into the flow there, so the bounds are held on
# the frames they were set for, and the bench's error is printed
MOTION_TRUTH = {"lk": (3, 0.1, {}), "vet": (2, 0.1, {"options": {"maxiter": 150}}),
                "proesmans": (2, 0.1, {}), "darts": (9, 0.6, {}), "farneback": (2, 0.1, {})}
# card against CPU (the card's branch on the CPU, plain K1), in px: every
# pixel and the RMS; a few low-texture pixels of Farneback's 2 x 2 solve
# (its determinant floored at 1e-6 of the trace squared) amplify the
# stencils' rounding.  VET's Adam loop amplifies rounding (a step's
# gradient differs in its last bits between the two), so it is held on
# the flow's RMS difference relative to |v|
MOTION_CARD_VS_CPU_PX = (0.05, 1e-3)
VET_CARD_VS_CPU_REL_RMS = 0.1
# VET's gradient through K1 and its backward against autograd of the plain
# version on the same card inputs, relative to the largest component
VET_GRAD_RTOL = 1e-5
TF32_RTOL = 1e-5  # an IEEE float32 stencil against float64, of max |out|
def _rel_rmse(uv, u_true=2.0, v_true=1.0, margin=20):
    """The flow's RMSE against the true motion, 20 px from the borders,
    relative to its speed (``tests/test_motion.py::_rel_rmse``)."""
    uv = torch.as_tensor(uv).detach().cpu().double()
    u = uv[0, margin:-margin, margin:-margin]
    v = uv[1, margin:-margin, margin:-margin]
    err = torch.sqrt(torch.mean((u - u_true) ** 2 + (v - v_true) ** 2))
    return float(err) / float(np.hypot(u_true, v_true))


def _motion_k1(label):
    """K1's launches per axis on path ``label``, from the code: VET one
    forward an Adam step (100 steps at 2 and 4 sectors a side, 150 at 16
    and 32, with its default ``maxiter`` 100); Proesmans 2 an iteration (the
    consistency of both directions, then their warps, each one batch), 100
    iterations at each of 6 levels (512 down to 16); Farneback 1 an
    iteration (the six coefficient planes in one batch), 5 at each of 4
    levels (512 down to 64, where the next would fall below twice the
    window); the extrapolation after LK 3 a lead (path I)."""
    return {"N": 3 * N_LEADS, "O": 2 * max(100, 80) + 2 * max(100, 150), "P": 2 * 100 * 6,
            "Q": 0, "R": 5 * 4}[label]


def _flow_card_vs_cpu(label, card, cpu):
    """The card's flow against the CPU's: raises beyond the path's
    tolerance; returns the comparison."""
    c = torch.as_tensor(card).detach().cpu().double()
    r = torch.as_tensor(cpu).detach().cpu().double()
    if c.shape != r.shape or not bool(torch.isfinite(c).all()):
        raise AssertionError(f"{label}: card flow of shape {tuple(c.shape)} or not finite")
    diff = (c - r).abs()
    rec = {"max_abs_diff_px": float(diff.max()),
           "rms_diff_px": float(torch.sqrt(torch.mean(diff**2))),
           "cpu_rel_rmse_vs_truth": _rel_rmse(r)}
    if label == "O":
        rec.update(rel_rms_tol=VET_CARD_VS_CPU_REL_RMS)
        ok = rec["rms_diff_px"] <= VET_CARD_VS_CPU_REL_RMS * float(np.hypot(2.0, 1.0))
    else:
        rec.update(tol_max_px=MOTION_CARD_VS_CPU_PX[0], tol_rms_px=MOTION_CARD_VS_CPU_PX[1])
        ok = (rec["max_abs_diff_px"] <= MOTION_CARD_VS_CPU_PX[0]
              and rec["rms_diff_px"] <= MOTION_CARD_VS_CPU_PX[1])
    if not ok:
        raise AssertionError(f"{label}: card and CPU flows disagree: {rec}")
    return rec


def _cpu_flow(method, frames):
    """The port's flow on the CPU through the card's branch: the shift
    warp with the card's bounds (plain K1) for Proesmans and Farneback,
    VET's recentred shift cost; LK and DARTS have one branch."""
    x = torch.as_tensor(frames)
    if method == "proesmans":
        return proesmans_mod._proesmans_full(x[-2], x[-1], 50.0, 6, 100, 0.0, True, False)
    if method == "farneback":
        return farneback_mod._farneback_full(x[-2], x[-1], 4, 5, 7, 1.5, 32, True)
    kw = {"max_disp": "shift", "verbose": False} if method == "vet" else {}
    if method == "darts":
        kw["verbose"] = False
    return motion.get_method(method)(x, device="cpu", **kw)


def _vet_gradient(frames, guesses):
    """One cost-and-gradient evaluation at VET's finest scale (32 x 32
    sectors) on the card at the final sector displacements, through K1 and
    its backward (``AxisResample``), against autograd of the plain
    ``_axis_resample`` on the same card inputs; with each side's backward
    time (CUDA events, median of 10)."""
    dev = torch.device("cuda")
    imgs = frames.astype(np.float64)
    di, dj = vet_mod._global_shift(imgs[0], imgs[1])
    gshift = (vet_mod.round_int(di), vet_mod.round_int(dj))
    x = np.ascontiguousarray(guesses[-1][::-1])  # back to (i, j) order
    cost, md = vet_mod._scale_cost(imgs, ~np.isfinite(imgs).any(axis=0), x, (32, 32), "shift",
                                   gshift, 1e6, dev)
    x = torch.as_tensor(x.ravel(), dtype=torch.float32, device=dev)

    def evaluate():
        xr = x.clone().requires_grad_(True)
        val = cost(xr)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        (g,) = torch.autograd.grad(val, xr)
        stop.record()
        torch.cuda.synchronize()
        return val.detach(), g, start.elapsed_time(stop)

    runs = [evaluate() for _ in range(11)][1:]
    _kernels.reset_launches()
    evaluate()
    k1 = {k: _kernels.LAUNCHES[k] for k in ("resample_axis0", "resample_axis1")}
    if k1 != {"resample_axis0": 1, "resample_axis1": 1}:
        raise AssertionError(f"O gradient: the cost did not run through K1 once an axis: {k1}")
    real = warp_mod.axis_resample
    warp_mod.axis_resample = pallas_warp._axis_resample
    try:
        plain = [evaluate() for _ in range(11)][1:]
    finally:
        warp_mod.axis_resample = real
    val, g, _ = runs[-1]
    pval, pg, _ = plain[-1]
    rel = float((g - pg).abs().max() / pg.abs().max())
    rec = {"sectors": [32, 32], "max_disp": md, "center_shift": list(gshift),
           "cost": float(val), "cost_plain": float(pval),
           "grad_max_rel_diff": rel, "rtol": VET_GRAD_RTOL,
           "backward_ms": statistics.median(r[2] for r in runs),
           "backward_ms_plain": statistics.median(r[2] for r in plain)}
    if not rel <= VET_GRAD_RTOL or abs(float(val) - float(pval)) > 1e-5 * abs(float(pval)):
        raise AssertionError(f"O gradient: K1's autograd and the plain version differ: {rec}")
    return rec


def _truth_on_card(method, **extra):
    """``tests/test_motion.py``'s case of ``method`` on the card (with the
    keywords ``extra``): the relative RMSE against the true motion, which
    must be under its bound."""
    n_frames, bound, kw = MOTION_TRUTH[method]
    kw = dict(kw, **extra)
    frames = make_synthetic_sequence(n_frames=9, shape=(200, 200), velocity=(2.0, 1.0),
                                     seed=3)
    db = (10.0 * np.log10(np.maximum(frames, 0.1))).astype(np.float32)[:n_frames]
    kw = dict(kw, verbose=False) if method in ("vet", "darts") else kw
    rel = _rel_rmse(motion.get_method(method)(torch.as_tensor(db, device="cuda"), **kw))
    if not rel < bound:
        raise AssertionError(f"{method}: relative RMSE {rel} >= {bound} on test_motion's frames")
    return {"rel_rmse": rel, "bound": bound, "frames": [n_frames, 200, 200]}


def phase_motion(name, smi):
    """Paths N-R: each motion solver of the JAX bench through
    ``motion.get_method`` on the card at 512^2 with its default arguments,
    timed once after a warm-up with its exact K1 launch counts; its flow
    against a CPU run of the port through the card's branch and its
    relative RMSE against the true motion; then the same method on the
    card on ``tests/test_motion.py``'s frames, under that test's bound.
    N also extrapolates 12 leads with the LK flow (the bench's
    ``extrap_512``), held against the CPU's K1 path on the card's flow; O
    also checks VET's gradient through K1 against the plain autograd.  Returns the launch counts by path."""
    dev = torch.device("cuda")
    common = {"device": name, "nvidia_smi": smi}
    by_path = {}
    for label, (method, n_frames) in MOTION_PATHS.items():
        frames, _ = bench_inputs(SIDE, n_frames=n_frames)
        x = torch.as_tensor(frames, device=dev)
        f = motion.get_method(method)
        kw = {"verbose": False} if method in ("vet", "darts") else {}

        def run():
            flow = f(x, **kw)
            if label != "N":
                return flow, None
            return flow, nowcasts.get_method("extrapolation")(x[-1], flow, N_LEADS)

        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.time()
        flow, fc = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        k1 = _motion_k1(label)
        _check_launches(label, launches, {"resample_axis0": k1, "resample_axis1": k1})
        if tuple(flow.shape) != (2, SIDE, SIDE) or not flow.is_cuda:
            raise AssertionError(f"{label}: flow of shape {tuple(flow.shape)} on {flow.device}")
        t1 = time.time()
        held = _flow_card_vs_cpu(label, flow, _cpu_flow(method, frames))
        held["cpu_s"] = time.time() - t1
        rec = {"phase": f"path {label}", "method": method, "frames": n_frames,
               "shape": [n_frames, SIDE, SIDE], "wall_s": wall,
               "retrievals_per_s": 1.0 / wall, "max_memory_allocated": peak,
               "rel_rmse_vs_truth": _rel_rmse(flow), "launches": launches,
               "card_vs_cpu": held}
        if label == "N":
            # the extrapolation from the card's flow, against the CPU's K1
            # path (the same bound 48, plain K1) on a copy of that flow
            if tuple(fc.shape) != (N_LEADS, SIDE, SIDE) or torch.isinf(fc).any():
                raise AssertionError(f"N: extrapolation of shape {tuple(fc.shape)}")
            ref, _ = semilagrangian._extrapolate_core(
                x[-1].cpu(), flow.cpu(), [1.0] * N_LEADS, 1, 1, float("nan"),
                torch.zeros((2, SIDE, SIDE)), 1.0, 48)
            rec["extrapolation_card_vs_cpu"] = _nanclose("N", fc, ref, 1e-4)
            rec["frames_per_s"] = N_LEADS / wall
        if label == "O":
            _, guesses = f(x, intermediate_steps=True, **kw)
            rec["gradient"] = _vet_gradient(frames, guesses)
            KEPT["O_flow"] = flow.detach().clone()
        rec["truth_test_motion"] = _truth_on_card(method)
        by_path[label] = launches
        emit({**rec, **common})
        del flow, fc, x
    return by_path


def phase_postprocessing(name, smi, forecast):
    """``ensemblestats.mean``, ``excprob`` of 1 mm/h (0 dB) and
    ``banddepth`` on path A's last lead (96 x 512^2, dB) on the card,
    each held against the same call on the CPU: the exceedances equal,
    the mean and the depths within 1e-5 of their scale."""
    from pysteps_tpu_torch.postprocessing import ensemblestats

    cpu_fc = forecast.cpu()
    rec = {"phase": "postprocessing", "shape": list(forecast.shape), "device": name,
           "nvidia_smi": smi}
    for fname, call, tol in (
            ("mean", lambda X: ensemblestats.mean(X, ignore_nan=True), 1e-5),
            ("excprob", lambda X: ensemblestats.excprob(X, 0.0, ignore_nan=True), 0.0),
            ("banddepth", lambda X: ensemblestats.banddepth(X), 1e-5)):
        card = call(forecast)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: call(forecast), reps=5)
        ref = call(cpu_fc)
        c, r = card.cpu().double(), ref.double()
        if not torch.equal(torch.isnan(c), torch.isnan(r)):
            raise AssertionError(f"postprocessing {fname}: NaN sets differ")
        scale = float(torch.nan_to_num(r).abs().max())
        err = float(torch.nan_to_num(c - r).abs().max())
        if err > tol * scale:
            raise AssertionError(f"postprocessing {fname}: card and CPU differ by {err}")
        rec[fname] = {"ms": ms, "max_abs_diff": err, "scale": scale, "tol_of_scale": tol}
    emit(rec)


def phase_tf32(name, smi):
    """The port's convolutions against float64 on the CPU: STEPS' separable
    Gaussian window (``timeseries/correlation.py::_sep_conv2d``, radius
    30 as the localized AR fit uses it) and the motion stencils (Sobel,
    Farneback's 33-tap window, Proesmans' 3 x 3 average) on path A's last
    observation, each with the relative error of the same call under
    PyTorch's default cuDNN flags beside it (TF32 where the default allows
    it)."""
    from pysteps_tpu_torch.ops import conv as conv_mod
    from pysteps_tpu_torch.timeseries.correlation import _gaussian_kernel1d, _sep_conv2d

    dev = torch.device("cuda")
    precip_db, _ = bench_inputs(SIDE)
    field = torch.as_tensor(precip_db[-1], device=dev)
    k30 = _gaussian_kernel1d(30.0, dev)
    gw = farneback_mod._gauss_kernel(16, 8.0, dev)
    sobel = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=dev) / 8
    lap = torch.tensor(proesmans_mod._LAP, dtype=torch.float32, device=dev)
    cases = (
        ("sep_conv2d gaussian r30", lambda f, k: _sep_conv2d(f, k), k30),
        ("sep_corr farneback 33", lambda f, k: conv_mod.sep_corr(f, k, k), gw),
        ("corr_same sobel", conv_mod.corr_same, sobel),
        ("corr_same proesmans 3x3", conv_mod.corr_same, lap),
    )
    rec = {"phase": "tf32", "cudnn_allow_tf32_default": torch.backends.cudnn.allow_tf32,
           "rtol_of_max": TF32_RTOL, "device": name, "nvidia_smi": smi}
    for label, fn, k in cases:
        ref = fn(field.cpu().double(), k.cpu().double())
        scale = float(ref.abs().max())
        port = fn(field, k).cpu().double()
        # the same calls under PyTorch's default cuDNN flags
        real = conv_mod.ieee_fp32
        conv_mod.ieee_fp32 = contextlib.nullcontext
        try:
            bare = fn(field, k).cpu().double()
        finally:
            conv_mod.ieee_fp32 = real
        err = float((port - ref).abs().max()) / scale
        rec[label] = {"port_max_rel_err": err,
                      "default_flags_max_rel_err": float((bare - ref).abs().max()) / scale}
        if err > TF32_RTOL:
            raise AssertionError(f"tf32: {label} differs from float64 by {err} of max")
    emit(rec)

# LINDA at the JAX bench's size (bench.py:246-257, inputs bench.py:105-122):
# T its linda_512 (the domain as one feature, deterministic), U the module's
# defaults (blob features, 10 members, BPS)
LINDA_MEMBERS = 10
LINDA_MAX_FEATURES = 25
LINDA_PATHS = {
    "T": dict(feature_method="domain", add_perturbations=False),
    "U": dict(feature_method="blob", max_num_features=LINDA_MAX_FEATURES,
              n_ens_members=LINDA_MEMBERS, kmperpixel=1.0, timestep=5, seed=42),
}
# card against CPU: a loop from the same spectra (cuFFT against the CPU's
# FFT), the AR window and the hindcast, of span; psi absolute; the fits'
# objectives relative.  A fit follows rounding from its first step in phi
# (nowcasts/linda.py::_fit_kernels), so the two devices' own fits are held
# on the objective they reach, and their forecasts differ by no more of
# the span than their spectra differ (+ LINDA_SPAN_TOL)
LINDA_SPAN_TOL = 1e-4
LINDA_PSI_TOL = 1e-4
LINDA_OBJECTIVE_RTOL = 0.01
LINDA_ERROR_MODEL_RTOL = 1e-3


class _FitRecorder:
    """Wraps ``linda._fit_kernels``: records each call's arguments and
    spectra, or hands over given spectra in call order."""

    def __init__(self, handed=None):
        self.calls = []
        self.handed = list(handed) if handed is not None else None

    def __enter__(self):
        self.real = linda_mod._fit_kernels

        def fit(src, dst, weights, mask, **kw):
            if self.handed is not None:
                out = self.handed[len(self.calls)].to(src.device)
            else:
                out = self.real(src, dst, weights, mask, **kw)
            self.calls.append(((src, dst, weights, mask), out))
            return out

        linda_mod._fit_kernels = fit
        return self

    def __exit__(self, *exc):
        linda_mod._fit_kernels = self.real


def _fit_objective(args, spectra):
    """The fit's objective of each feature's kernel, on the CPU."""
    src, dst, w, mask = (x.detach().cpu() for x in args)
    k = spectra.detach().cpu()
    maskf = mask.to(torch.float32)
    pred = (linda_mod._conv_kernels(torch.where(mask, src, 0.0), k)
            / linda_mod._conv_mask_norm(k, mask))
    wsel = w * (w > 1e-3) * maskf
    return torch.sum(wsel * (pred - torch.where(mask, dst, 0.0)) ** 2, dim=(1, 2)).double()


def _objectives_held(label, args, card, cpu):
    """Raise unless each feature's objective under the card's spectra is
    within LINDA_OBJECTIVE_RTOL of the CPU's; returns the comparison."""
    oc, orf = _fit_objective(args, card), _fit_objective(args, cpu)
    rel = float(((oc - orf).abs() / orf.abs().clamp(min=1e-30)).max())
    rec = {"objective_max_rel_diff": rel, "tol": LINDA_OBJECTIVE_RTOL,
           "spectra_max_abs_diff": float((card.detach().cpu() - cpu.detach().cpu()).abs().max()),
           "features": int(card.shape[0])}
    if rel > LINDA_OBJECTIVE_RTOL:
        raise AssertionError(f"{label}: the card's fit reaches another objective: {rec}")
    return rec


def _linda_inputs():
    """The bench's LINDA inputs: 3 rain-rate frames and the velocity."""
    _, velocity = bench_inputs(SIDE)
    return bench_rain(SIDE)[:3], velocity


def _timed_linda(label, kw, frames, warm_up=True):
    """LINDA through ``nowcasts.get_method`` on numpy inputs (to the card by
    default): a warm-up (unless ``warm_up`` is False), then one run timed
    with ``measure_time=True``, the launch counts set to 0 just before and
    read just after, which must all be 0; the fits' spectra recorded.
    Returns (output, record, fits)."""
    rain, velocity = _linda_inputs()
    f = nowcasts.get_method("linda")
    if warm_up:
        f(rain, velocity, N_LEADS, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _FitRecorder() as rec:
        _kernels.reset_launches()
        t0 = time.time()
        out, init_s, loop_s = f(rain, velocity, N_LEADS, measure_time=True, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_launches(label, launches, {})
    if not out.is_cuda or torch.isinf(out).any():
        raise AssertionError(f"{label}: output on {out.device} or infinite values")
    return out, {"wall_s": wall, "init_s": init_s, "loop_s": loop_s,
                 "max_memory_allocated": peak, "launches": launches,
                 "frames": frames}, rec.calls


def phase_linda(name, smi):
    """Paths T and U: LINDA at 512^2 with 12 leads through
    ``nowcasts.get_method("linda")``, each timed once with every hand
    kernel's launch count 0.  T (the domain, deterministic; after a
    warm-up) against a CPU run of the port from the card's fitted spectra
    and against the CPU's own fits; U (blob features, 10 members, BPS)
    after its deterministic parts (features, fits, psi, advection mask,
    AR window, hindcast, error model, one perturbation field of one white
    spectrum) are held against the CPU's, which warms the card up for it
    (its init is minutes of host error-model fits, so it runs once), with
    its members spreading at every lead.  Returns the launch counts by
    path."""
    common = {"device": name, "nvidia_smi": smi}
    rain, velocity = _linda_inputs()
    f = nowcasts.get_method("linda")
    by_path = {}

    # T: the bench's linda_512
    kw_t = LINDA_PATHS["T"]
    out, rec, card_fits = _timed_linda("T", kw_t, N_LEADS)
    if tuple(out.shape) != (N_LEADS, SIDE, SIDE):
        raise AssertionError(f"T: output shape {tuple(out.shape)}")
    with _FitRecorder(handed=[k.cpu() for _, k in card_fits]):
        ref = f(rain, velocity, N_LEADS, device="cpu", **kw_t)
    rec["card_vs_cpu_same_spectra"] = _nanclose("T", out, ref, LINDA_SPAN_TOL)
    t1 = time.time()
    with _FitRecorder() as cpu_rec:
        own = f(rain, velocity, N_LEADS, device="cpu", **kw_t)
    rec["cpu_s"] = time.time() - t1
    fits = [_objectives_held(f"T fit {i + 1}", cpu_rec.calls[i][0], card_fits[i][1],
                             cpu_rec.calls[i][1]) for i in range(2)]
    dk = max(x["spectra_max_abs_diff"] for x in fits)
    rec["fits_card_vs_cpu"] = fits
    rec["card_vs_cpu_own_fits"] = _nanclose("T own fits", out, own, dk + LINDA_SPAN_TOL)
    rec["frames_per_s"] = N_LEADS / rec["wall_s"]
    by_path["T"] = rec["launches"]
    emit({"phase": "path T", "method": "linda", "shape": list(out.shape), **kw_t, **rec,
          **common})
    del out, ref, own

    # U: probabilistic LINDA as the JAX module's defaults run it
    kw_u = LINDA_PATHS["U"]
    E = kw_u["n_ens_members"]
    parts = _linda_parts(rain, velocity)
    out, rec, _ = _timed_linda("U", kw_u, E * N_LEADS, warm_up=False)
    if tuple(out.shape) != (E, N_LEADS, SIDE, SIDE):
        raise AssertionError(f"U: output shape {tuple(out.shape)}")
    spread = torch.nanmean(out.std(dim=0).reshape(N_LEADS, -1), dim=1).cpu().numpy()
    if not bool((spread > 0).all()):
        raise AssertionError(f"U: no ensemble spread at some lead: {spread.tolist()}")
    rec["spread_per_lead"] = spread.tolist()
    rec["member_frames_per_s"] = E * N_LEADS / rec["wall_s"]
    rec["parts_card_vs_cpu"] = parts
    by_path["U"] = rec["launches"]
    del out
    emit({"phase": "path U", "method": "linda", **kw_u, "shape": [E, N_LEADS, SIDE, SIDE],
          **rec, **common})
    return by_path


def _linda_parts(rain, velocity):
    """U's deterministic parts on the card and on the CPU from the same
    inputs: the features (the card's are used on both from there); each fit's objective (the CPU's own kernel
    1 against the card's); from the card's spectra, psi, the advection
    mask, the AR window and the one-step hindcast; the error model from
    each hindcast; one perturbation field a member from one white draw."""
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    m = n = SIDE
    out = {}
    # the LoG responses differ in their last bits (cuDNN's float32 sums
    # against the CPU's), so a peak between two pixels of nearly equal
    # response may sit one pixel over: the same features in the same
    # order, each within 1 px
    coords, coords_cpu = (
        linda_mod._detect_features(rain[-1], "blob", LINDA_MAX_FEATURES, {}, d)
        for d in (dev, cpu))
    if coords.shape != coords_cpu.shape or np.abs(coords - coords_cpu).max() > 1.0:
        raise AssertionError(f"U: features differ: {coords} against {coords_cpu}")
    out["features_equal"] = int(np.all(coords == coords_cpu, axis=1).sum())
    out["features"] = int(len(coords))
    print(f"U: {len(coords)} features", flush=True)
    w = linda_mod._compute_window_weights(coords, m, n, 0.2 * m)
    iw = (w / w.sum(axis=0, keepdims=True)).astype(np.float32)
    w = w.astype(np.float32)

    def init(device, handed=None):
        with _FitRecorder(handed) as rec:
            res = linda_mod._linda_init_core(
                torch.as_tensor(rain, device=device), torch.as_tensor(velocity, device=device),
                torch.as_tensor(w, device=device), torch.as_tensor(iw, device=device), 1)
        return res, rec.calls

    t0 = time.time()
    card, calls = init(dev)
    torch.cuda.synchronize()
    out["init_card_s"] = time.time() - t0
    # the CPU's own kernel 1 on the card's inputs, against the card's
    args = calls[0][0]
    own = linda_mod._fit_kernels(*(x.cpu() for x in args))
    out["fit_1"] = _objectives_held("U fit 1", args, calls[0][1], own)
    ref, _ = init(cpu, handed=[k.cpu() for _, k in calls])
    np.testing.assert_array_equal(card[6].cpu().numpy(), ref[6].numpy())
    psi = float((card[4].cpu() - ref[4]).abs().max())
    if psi > LINDA_PSI_TOL:
        raise AssertionError(f"U: psi differs by {psi}")
    out["psi_max_abs_diff"] = {"value": psi, "tol": LINDA_PSI_TOL}
    out["ar_window"] = _nanclose("U ar window", card[5], ref[5], LINDA_SPAN_TOL)

    def hindcast(parts, device):
        return linda_mod._linda_scan(
            parts[8], torch.as_tensor(rain[-2], device=device),
            torch.as_tensor(velocity, device=device), *parts[:4],
            torch.as_tensor(iw, device=device), parts[4], parts[6], None,
            linda_mod._degenerate_perturbations((m, n), device), 1, False, 1, (m, n))[0, 0]

    h_card, h_cpu = hindcast(card, dev), hindcast(ref, cpu)
    out["hindcast"] = _nanclose("U hindcast", h_card, h_cpu, LINDA_SPAN_TOL)

    def error_model(fct):
        fct = fct.cpu().numpy()
        obs = rain[-1]
        err = fct / np.where(obs != 0, obs, np.nan)
        ok = ((fct >= 1.0) & (obs >= 0.5)) | ((fct >= 0.5) & (obs >= 1.0))
        return linda_mod._estimate_error_model(
            np.where(ok, err, np.nan), coords, (m, n), 0.15 * m, 0.25 * m, 0.2 * m,
            device="cpu")

    t0 = time.time()
    pert_card = error_model(h_card)
    out["error_model_host_s"] = time.time() - t0
    pert_cpu = error_model(h_cpu)
    em = {}
    for key in ("s", "loc", "std", "ampl", "weights"):
        a, b = pert_card[key].double(), pert_cpu[key].double()
        d = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        em[key] = d
        if d > LINDA_ERROR_MODEL_RTOL:
            raise AssertionError(f"U: error model {key} differs by {d} of its largest value")
    out["error_model_max_rel_diff"] = {**em, "tol": LINDA_ERROR_MODEL_RTOL,
                                       "fitted_features": int((pert_cpu["std"] > 0).sum())}
    gen = torch.Generator().manual_seed(9)
    white = fftgenerators._spectral_white(gen, (m, n), LINDA_MEMBERS)
    p_card = linda_mod._perturbations_from_white(
        white.to(dev), {k: v.to(dev) for k, v in pert_cpu.items()}, (m, n))
    p_cpu = linda_mod._perturbations_from_white(white, pert_cpu, (m, n))
    out["perturbation"] = _nanclose("U perturbation", p_card, p_cpu, LINDA_SPAN_TOL)
    return out


# the verification phase: path A's last lead against a later synthetic frame
VERIFY_THR_DB = 0.0  # 1 mm/h
VERIFY_SCALES = (4, 16, 64)


def phase_verification(name, smi, forecast):
    """The scores of ``verification/`` on path A's last lead (96 x 512^2,
    dB) against the synthetic frame of that lead (the bench's sequence
    continued to 15 frames): CRPS, the rank histogram, the reliability
    diagram and ROC of exceeding 1 mm/h, and on the ensemble mean FSS at
    three scales, the categorical (CSI, POD, FAR) and continuous (MAE,
    RMSE, corr) scores, the intensity-scale matrix, the binary MSE and
    SAL (in rain rate), each on the card and on the CPU with its
    tolerance and its card seconds."""
    from pysteps_tpu_torch import verification as ver
    from pysteps_tpu_torch.verification import ensscores, probscores, spatialscores

    frames, _ = bench_inputs(SIDE, n_frames=3 + N_LEADS)
    obs_np = frames[-1]
    dev = torch.device("cuda")
    ens = {"cuda": forecast, "cpu": forecast.cpu()}
    obs = {"cuda": torch.as_tensor(obs_np, device=dev), "cpu": torch.as_tensor(obs_np)}
    mean = {k: torch.nanmean(v, dim=0) for k, v in ens.items()}
    prob = {k: torch.mean((torch.nan_to_num(v, nan=-99.0) >= VERIFY_THR_DB).float(), dim=0)
            for k, v in ens.items()}

    def rain_rate(x):
        return torch.where(x > -10.0, 10.0 ** (x / 10.0), 0.0)

    scores = {
        "CRPS": (lambda d: probscores.CRPS(ens[d], obs[d]), 1e-4),
        "rankhist": (lambda d: ensscores.rankhist(ens[d], obs[d]), 1e-6),
        "reldiag": (lambda d: probscores.reldiag(prob[d], obs[d], VERIFY_THR_DB), 1e-6),
        "ROC": (lambda d: probscores.ROC_curve(prob[d], obs[d], VERIFY_THR_DB,
                                               compute_area=True), 1e-6),
        **{f"FSS scale {s}": ((lambda d, s=s: spatialscores.fss(
            mean[d], obs[d], VERIFY_THR_DB, s)), 1e-4) for s in VERIFY_SCALES},
        "det_cat_fct": (lambda d: ver.detcatscores.det_cat_fct(
            mean[d], obs[d], VERIFY_THR_DB, "csi, pod, far"), 1e-6),
        "det_cont_fct": (lambda d: ver.detcontscores.det_cont_fct(
            mean[d], obs[d], "mae, rmse, corr_p"), 1e-4),
        "intensity_scale": (lambda d: spatialscores.intensity_scale(
            mean[d], obs[d], "fss", [VERIFY_THR_DB, 5.0, 10.0], VERIFY_SCALES), 1e-4),
        "binary_mse": (lambda d: spatialscores.binary_mse(mean[d], obs[d], VERIFY_THR_DB)[0],
                       1e-4),
        # host code on the two devices' ensemble means, which differ in
        # their last bits (the order of nanmean's sums)
        "SAL": (lambda d: ver.get_method("sal")(rain_rate(mean[d]), rain_rate(obs[d])), 1e-5),
    }
    rec = {"phase": "verification", "shape": list(forecast.shape), "thr_db": VERIFY_THR_DB,
           "device": name, "nvidia_smi": smi}
    for label, (fn, tol) in scores.items():
        fn("cuda")
        torch.cuda.synchronize()
        t0 = time.time()
        card = fn("cuda")
        torch.cuda.synchronize()
        card_s = time.time() - t0
        ref = fn("cpu")
        c = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in _leaves(card)])
        r = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in _leaves(ref)])
        if c.shape != r.shape or not np.array_equal(np.isnan(c), np.isnan(r)):
            raise AssertionError(f"verification {label}: card {c} against CPU {r}")
        scale = max(float(np.nanmax(np.abs(r))), 1e-30)
        diff = float(np.nanmax(np.abs(c - r))) if np.isfinite(r).any() else 0.0
        rec[label] = {"card": c.tolist() if c.size <= 8 else None, "max_abs_diff": diff,
                      "of_max": diff / scale, "tol_of_max": tol, "card_s": card_s}
        if diff > tol * scale:
            raise AssertionError(f"verification {label}: card and CPU differ: {rec[label]}")
    emit(rec)


# blending at the JAX bench's operating points (bench.py:78-87, :257-343):
# STEPS blending's members, the leads, members a chunk and grid of V', the
# PCA EnKF's members and grid, the grid, members and leads of V's
# card-vs-CPU check, and the blend ramp of X (minutes)
BLEND_MEMBERS = 96
BLEND_CHUNK_SIDE, BLEND_CHUNK_LEADS, BLEND_CHUNK = 1024, 6, 12
ENKF_MEMBERS, ENKF_SIDE, ENKF_LEVELS = 24, 256, 6
BLEND_PARITY = (256, 8, 6)
LINEAR_RAMP = (10.0, 50.0)
# the leads (minutes) at which pca_enkf_256 takes the NWP ensemble as it is
# (the inflation of the observations has decayed to 0.02), held against the
# JAX package's run on the same inputs by
# tests/test_torch_enkf.py::test_pca_enkf_256_schedule_against_jax; each of
# the other cycles makes one nowcast step
ENKF_FULL_NWP_LEADS = [55, 60]
# K1 and K4 at a path's own shapes against their plain versions: K1 within
# this share of its field's largest magnitude (a lerp of two taps), K4 (a
# bounded integer distance, scaled) within an absolute 1e-6
K1_PATH_TOL, K4_PATH_TOL = 1e-5, 1e-6


class _PathKernelInputs:
    """While entered, a copy of the inputs of the last K1 launch of each
    (axis, field shape, index shape, bound) and of the last K4 launch from
    a mask of each (shape, radii); the wrappers compute and count as they
    do without it.  On leaving, each copy is held against the plain
    version (``rows``) and freed, so that no copy outlives the warm-up;
    ``k1`` and ``k4`` then map each key to its number of launches."""

    def __init__(self, label):
        self.label, self.rows = label, None

    def __enter__(self):
        self.k1, self.k4 = {}, {}
        self._k1, self._rim = pallas_warp._axis_resample_launch, pallas_dilate._rim

        def k1(field, idx0, frac, D, axis):
            key = (int(axis), tuple(field.shape), tuple(idx0.shape), int(D))
            n = self.k1.get(key, (0,))[0]
            self.k1[key] = (n + 1, field.clone(), idx0.clone(), frac.clone())
            return self._k1(field, idx0, frac, D, axis)

        def rim(x, thr, strict, kr, r, counter):
            if counter == "rim_from_mask":
                key = (tuple(x.shape), int(kr), int(r))
                n = self.k4.get(key, (0,))[0]
                self.k4[key] = (n + 1, x.clone())
            return self._rim(x, thr, strict, kr, r, counter)

        pallas_warp._axis_resample_launch, pallas_dilate._rim = k1, rim
        return self

    def __exit__(self, exc_type, *exc):
        pallas_warp._axis_resample_launch, pallas_dilate._rim = self._k1, self._rim
        if exc_type is None:
            self.rows = self._held(self.label)
        self.k1 = {key: v[0] for key, v in self.k1.items()}
        self.k4 = {key: v[0] for key, v in self.k4.items()}

    def _held(self, label):
        """Each captured launch again through its wrapper on the card and
        through its plain version on the same tensors; raises past
        ``K1_PATH_TOL`` / ``K4_PATH_TOL`` or where the NaN sets differ."""

        def row(name, out, ref, tol, **extra):
            torch.cuda.synchronize()
            if not torch.equal(torch.isnan(out), torch.isnan(ref)):
                raise AssertionError(f"{label} {name}: NaN sets differ from the plain version")
            err = float(torch.nan_to_num(out - ref).abs().max())
            if not err <= tol:
                raise AssertionError(f"{label} {name} at {extra}: |kernel - plain| {err} > {tol}")
            return dict(name=name, max_abs_err=err, tol=tol, **extra)

        rows = []
        for (axis, shape, ishape, D), (n, field, idx0, frac) in sorted(self.k1.items()):
            scale = float(torch.nan_to_num(field).abs().max())
            rows.append(row(f"K1_resample_axis{axis}",
                            pallas_warp.axis_resample(field, idx0, frac, D, axis),
                            pallas_warp._axis_resample(field, idx0, frac, D, axis),
                            K1_PATH_TOL * scale, shape=list(shape), index_shape=list(ishape),
                            D=D, launches_in_warm_up=n))
        for (shape, kr, r), (n, mask) in sorted(self.k4.items()):
            rows.append(row("K4_rim_from_mask", pallas_dilate.dilated_rim(mask, kr, r),
                            pallas_dilate._rim_plain((mask > 0).to(torch.float32), 0.5, kr, r),
                            K4_PATH_TOL, shape=list(shape), dtype=str(mask.dtype), kr=kr, r=r,
                            launches_in_warm_up=n))
        return rows


def blend_inputs(side):
    """The bench's blending inputs (``bench.py:257-262``): the first 3 of
    4 dB frames, one NWP model (the last frame repeated over 13 leads plus
    0.3 randn from ``RandomState(1)``) and the motion field."""
    precip_db, velocity = bench_inputs(side, n_frames=4)
    db = precip_db[:3]
    nwp = np.repeat(db[-1][None], N_LEADS + 1, axis=0)
    nwp = (nwp + 0.3 * np.random.RandomState(1).randn(*nwp.shape)).astype(np.float32)[None]
    return db, nwp, velocity


def _blend_kw(E, skill_dir, **extra):
    """The bench's ``blending.steps.forecast`` keywords (``bench.py:274-280``),
    updated by ``extra``."""
    return dict(dict(n_ens_members=E, n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0,
                     seed=43, noise_method="nonparametric", vel_pert_method=None,
                     outdir_path_skill=skill_dir), **extra)


def _spread(out, T):
    spread = torch.nanmean(out.float().std(dim=0).reshape(T, -1), dim=1).cpu().numpy()
    if not bool((spread > 0).all()):
        raise AssertionError(f"no ensemble spread at some lead: {spread.tolist()}")
    return spread.tolist()


def _blend_path(label, side, T, E, skill_dir, expected, **extra):
    """STEPS blending through ``blending.get_method("steps")`` at ``E``
    members x ``side``^2 x ``T`` leads on the bench's inputs: a warm-up,
    then one run timed with its exact launch counts.  The warm-up's last
    K1 and K4 launches of each shape are then held against the plain
    versions (:class:`_PathKernelInputs`, before the timed run), among
    them the composite's warp at the path's bound and the per-lead rim,
    on all members of a chunk.  Returns (record, output)."""
    db, nwp, velocity = blend_inputs(side)
    dev = torch.device("cuda")
    args = (torch.as_tensor(db, device=dev), torch.as_tensor(nwp, device=dev),
            torch.as_tensor(velocity, device=dev), torch.as_tensor(velocity[None], device=dev),
            T, 5.0)
    f = blending.get_method("steps")
    captured = _PathKernelInputs(label)
    out, rec = _timed_nowcast(label, f, args, _blend_kw(E, skill_dir, **extra), expected, E * T,
                              warm_up=captured)
    if tuple(out.shape) != (E, T, side, side) or not out.is_cuda:
        raise AssertionError(f"{label}: output {tuple(out.shape)} on {out.device}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: non-finite values in the output")
    rec["spread_per_lead"] = _spread(out, T)
    rec["member_frames_per_s"] = E * T / rec["wall_s"]
    rec["max_disp"] = blend_mod._scan_bound(
        float(np.abs(velocity).max()), T, 5.0, False, None, None, 1.0, (side, side))
    rec["value_range"] = [float(out.min()), float(out.max())]
    members = (extra.get("member_chunk") or E, side, side)
    for axis in (0, 1):
        if (axis, members, members, rec["max_disp"]) not in captured.k1:
            raise AssertionError(f"{label}: no K1 launch on axis {axis} at {members}, bound "
                                 f"{rec['max_disp']}: {sorted(captured.k1)}")
    if not any(key[0] == members for key in captured.k4):
        raise AssertionError(f"{label}: no K4 launch at {members}: {sorted(captured.k4)}")
    rec["kernels_at_path_shapes"] = captured.rows
    return rec, out


def _enkf_inputs(dev):
    """The bench's PCA EnKF inputs (``bench.py:312-343``): 4 dB frames at
    256^2 (the first 2 observed), 24 NWP members of 13 leads (the third
    frame plus 0.5 randn from ``RandomState(1)``) on the device, and the
    timestamps of a 60-minute horizon."""
    precip_db, velocity = bench_inputs(ENKF_SIDE, n_frames=4)
    t0 = datetime.datetime(2021, 6, 29, 12, 0)
    obs_ts = np.array([t0 - datetime.timedelta(minutes=5), t0])
    nwp_ts = np.array([t0 + datetime.timedelta(minutes=5 * i) for i in range(N_LEADS + 1)])
    rng = np.random.RandomState(1)
    nwp = np.stack([
        np.repeat(precip_db[2][None], N_LEADS + 1, axis=0)
        + 0.5 * rng.randn(N_LEADS + 1, ENKF_SIDE, ENKF_SIDE)
        for _ in range(ENKF_MEMBERS)]).astype(np.float32)
    return precip_db[:2], obs_ts, torch.as_tensor(nwp, device=dev), nwp_ts, velocity, t0


def phase_blending(name, smi):
    """Paths V, V', W and X, each timed once after a warm-up with its exact
    launch counts; returns the counts by path.

    V, STEPS blending at the bench's ``blend_512`` (96 members x 512^2 x
    12 leads, 8 levels, nonparametric noise, the resampled CDF target, the
    incremental mask): a lead samples the blended velocity twice on the
    coarse grid and warps the composite (K1, one launch an axis each, all
    members in one launch) and redraws the incremental mask (K4 from a
    mask), which the init draws once.  V', ``blend_1024`` (member chunks
    of 12, bfloat16 output) cut to 6 leads: each chunk runs V's loop.  W,
    the PCA EnKF at ``pca_enkf_256``: each nowcast cycle samples the
    velocity twice and warps the members (K1), a cycle that takes the NWP
    ensemble as it is launches nothing.  X, linear and salient blending of
    the 512^2 extrapolation nowcast (path I's launches) with the bench's
    NWP stack in rain rate.  Every path's skill files go to a temporary
    directory."""
    common = {"device": name, "nvidia_smi": smi}
    by_path = {}
    T = N_LEADS
    with tempfile.TemporaryDirectory() as skill_dir:
        rec, out = _blend_path("V", SIDE, T, BLEND_MEMBERS, skill_dir, {
            "resample_axis0": 3 * T, "resample_axis1": 3 * T, "rim_from_mask": 1 + T})
        KEPT["V_law"] = rec["law"] = _law_scores_card(out, bench_rain(SIDE, n_frames=3 + T)[3:])
        del out
        side, E, Tp = BLEND_PARITY
        db, nwp, velocity = blend_inputs(side)
        det = _blend_kw(E, skill_dir, noise_method=None, resample_distribution=False)
        rec["card_vs_cpu"] = blend_checks.steps_card_vs_cpu("V card vs CPU", db, nwp, velocity,
                                                            Tp, det)
        by_path["V"] = rec["launches"]
        emit({"phase": "path V", "method": "blending.steps", "shape":
              [BLEND_MEMBERS, T, SIDE, SIDE], **rec, **common})

        Tc, chunks = BLEND_CHUNK_LEADS, BLEND_MEMBERS // BLEND_CHUNK
        rec, out = _blend_path("V'", BLEND_CHUNK_SIDE, Tc, BLEND_MEMBERS, skill_dir, {
            "resample_axis0": 3 * Tc * chunks, "resample_axis1": 3 * Tc * chunks,
            "rim_from_mask": 1 + Tc * chunks}, member_chunk=BLEND_CHUNK,
            output_dtype="bfloat16")
        if out.dtype != torch.bfloat16:
            raise AssertionError(f"V': output dtype {out.dtype}")
        del out
        rec["chunk_check"] = blend_checks.chunk_check("V' chunks", db, nwp, velocity, Tp, det)
        by_path["V'"] = rec["launches"]
        emit({"phase": "path V'", "method": "blending.steps", "shape":
              [BLEND_MEMBERS, Tc, BLEND_CHUNK_SIDE, BLEND_CHUNK_SIDE],
              "member_chunk": BLEND_CHUNK, "output_dtype": "bfloat16", **rec, **common})

    # W: the PCA EnKF through its nowcaster class (what the registry's
    # forecast builds), whose full-NWP leads fix the launch count
    dev = torch.device("cuda")
    obs, obs_ts, nwp, nwp_ts, velocity, t0 = _enkf_inputs(dev)
    cfg = pca_enkf_mod.EnKFCombinationConfig(
        n_ens_members=ENKF_MEMBERS, n_cascade_levels=ENKF_LEVELS, precip_threshold=-10.0,
        norain_threshold=0.01, seed=43)

    def caster():
        return pca_enkf_mod.EnKFCombinationNowcaster(
            obs, nwp, velocity, 5 * T, enkf_combination_config=cfg, obs_timestamps=obs_ts,
            nwp_timestamps=nwp_ts, issuetime=t0, measure_time=True)

    blending.get_method("pca_enkf")(obs, obs_ts, nwp, nwp_ts, velocity, 5 * T, issuetime=t0,
                                    n_ens_members=ENKF_MEMBERS, n_cascade_levels=ENKF_LEVELS,
                                    precip_thr=-10.0, norain_thr=0.01, seed=42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = caster()
    _kernels.reset_launches()
    t_start = time.time()
    out, init_s, loop_s = run.compute_forecast()
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(_kernels.LAUNCHES)
    if run.full_nwp_leads != ENKF_FULL_NWP_LEADS:
        raise AssertionError(f"W: the full NWP at {run.full_nwp_leads} min, not at "
                             f"{ENKF_FULL_NWP_LEADS}")
    cycles = T - len(ENKF_FULL_NWP_LEADS)
    _check_launches("W", launches, {"resample_axis0": 3 * cycles, "resample_axis1": 3 * cycles})
    if tuple(out.shape) != (ENKF_MEMBERS, T + 1, ENKF_SIDE, ENKF_SIDE) or torch.isinf(out).any():
        raise AssertionError(f"W: output {tuple(out.shape)} or infinite values")
    rec = {"wall_s": wall, "init_s": init_s, "loop_s": loop_s,
           "member_frames_per_s": ENKF_MEMBERS * T / wall,
           "max_memory_allocated": torch.cuda.max_memory_allocated(), "launches": launches,
           "nowcast_cycles": cycles, "full_nwp_leads": run.full_nwp_leads,
           "spread_per_lead": _spread(out[:, 1:], T),
           "max_disp": pca_enkf_mod._max_disp(dev, (ENKF_SIDE, ENKF_SIDE))}
    del out, run
    # one cycle at the bench's size: the NWP ensemble at its first lead as
    # the background, its second as the observation, a pool of 30 noise
    # cascades
    rec["card_vs_cpu"] = blend_checks.enkf_card_vs_cpu("W cycle card vs CPU", nwp.cpu(),
                                                       velocity, ENKF_LEVELS, 30)
    by_path["W"] = launches
    emit({"phase": "path W", "method": "blending.pca_enkf",
          "shape": [ENKF_MEMBERS, T + 1, ENKF_SIDE, ENKF_SIDE], **rec, **common})
    del nwp

    # X: linear and salient blending over the extrapolation nowcast
    db, nwp, velocity = blend_inputs(SIDE)
    meta = {"transform": "dB", "unit": "mm/h", "threshold": -10.0, "zerovalue": -15.0}
    rr_nwp = (10.0 ** (nwp[0, 1:] / 10.0)).astype(np.float32)
    launches_x = {}
    for method in ("linear_blending", "salient_blending"):
        f = blending.get_method(method)
        args = (torch.as_tensor(db[-1], device=dev), meta, torch.as_tensor(velocity, device=dev),
                T, 5.0, "extrapolation")
        kw = dict(precip_nwp=torch.as_tensor(rr_nwp, device=dev),
                  start_blending=LINEAR_RAMP[0], end_blending=LINEAR_RAMP[1])
        out, rec = _timed_nowcast(f"X {method}", f, args, kw,
                                  {"resample_axis0": 3 * T, "resample_axis1": 3 * T}, T)
        if tuple(out.shape) != (T, SIDE, SIDE) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"X {method}: output {tuple(out.shape)} or non-finite")
        ref = f(db[-1], meta, velocity, T, 5.0, "extrapolation", precip_nwp=rr_nwp,
                start_blending=LINEAR_RAMP[0], end_blending=LINEAR_RAMP[1], device="cpu")
        if method == "linear_blending":
            held = _nanclose(f"X {method}", out, ref, 1e-4)
        else:
            # the saliency ranks the two fields' difference densely: values
            # within rounding of each other may take neighbouring ranks
            held = _nanclose(f"X {method}", out, ref, 1e-4, frac=0.999, mean_rel=1e-5,
                             max_rel=1e-2)
        launches_x[method] = rec["launches"]
        emit({"phase": "path X", "method": method, "shape": list(out.shape),
              "blend_ramp_min": list(LINEAR_RAMP), **rec, "card_vs_cpu": held, **common})
    if launches_x["linear_blending"] != launches_x["salient_blending"]:
        raise AssertionError(f"X: the two methods launched differently: {launches_x}")
    by_path["X"] = launches_x["linear_blending"]
    return by_path



# the sharded paths of parallel/ and RainFARM, on a 1 x 1 x 1 NCCL mesh of
# this process (one card): Y the y-sharded STEPS at the headline size with
# the bench's inputs (bench.py:105-138), Y' the CONUS grid of the JAX
# package's dry run (__graft_entry__.py:182-196), Z the bench's
# rainfarm_512 (bench.py:88, :345-354): (members, side, leads[, levels])
PATH_Y = (N_MEMBERS, SIDE, N_LEADS)
PATH_Y2 = (2, 2048, 1, 3)
SHARDED_KWARGS = dict(n_cascade_levels=8, precip_thr=-10.0, kmperpixel=1.0, timestep=5,
                      seed=42, vel_pert_method="bps")
RAINFARM_512 = (4, 24)  # factor of the 128^2 coarse field, realizations
SHARDED_SPAN_TOL = 1e-5  # card against CPU, of the inputs' largest magnitude
# STEPS' ens-sharded blocks against the unsharded forecast, dB
# (tests/test_parallel.py:46-48)
ENS_BLOCK_ATOL = 3e-2
PARALLEL_LAW_TOL = 0.1  # MODEL_PARITY.json's tol_rel for the law check
RAINFARM_CORE_TOL = 1e-4


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _nccl_mesh():
    """A 1 x 1 x 1 mesh on an NCCL process group of this process alone
    (rank 0 of 1, a free local port).  Fails where NCCL cannot start: no
    other backend stands in."""
    import torch.distributed as dist

    from pysteps_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    mesh = make_mesh(ens=1, y=1, x=1, device_type="cuda")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the mesh runs on {dist.get_backend()}, not nccl")
    return mesh


class _Capture:
    """Keeps the last call's arguments of the functions ``names`` of
    ``module`` while entered; the calls compute as they do without it."""

    def __init__(self, module, names):
        self.mod, self.names, self.args = module, names, {}

    def _before(self, name):
        pass

    def __enter__(self):
        self.orig = {n: getattr(self.mod, n) for n in self.names}

        def wrap(n, f):
            def call(*args):
                self._before(n)
                self.args[n] = args
                return f(*args)
            return call

        for n, f in self.orig.items():
            setattr(self.mod, n, wrap(n, f))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.mod, n, f)


class _ShardedCapture(_Capture):
    """Keeps the last call's arguments of sharded_steps' matcher, mask and
    warp while a forecast runs, and the time of the first noise draw (the
    loop's start, after a synchronization)."""

    def __init__(self):
        from pysteps_tpu_torch.parallel import sharded_steps

        super().__init__(sharded_steps, ("_match_cdf_psum", "_dilated_mask_from_ext",
                                         "_warp_from_ext", "_spectral_white"))
        self.loop_t0 = None

    def _before(self, name):
        if name == "_spectral_white" and self.loop_t0 is None:
            torch.cuda.synchronize()
            self.loop_t0 = time.time()


def _span_check(label, card, cpu, tol, scale=None):
    """max |card - cpu| within ``tol`` of ``scale`` (default: max |cpu|)."""
    wide = torch.complex128 if cpu.is_complex() else torch.float64
    card, cpu = card.detach().cpu().to(wide), cpu.detach().cpu().to(wide)
    if card.shape != cpu.shape or not torch.equal(torch.isnan(card), torch.isnan(cpu)):
        raise AssertionError(f"{label}: shapes or NaN sets differ")
    scale = float(cpu.abs().nan_to_num().max()) if scale is None else scale
    diff = float((card - cpu).abs().nan_to_num().max())
    if diff > tol * max(scale, 1e-30):
        raise AssertionError(f"{label}: card and CPU differ by {diff} > {tol} x {scale}")
    return {"max_abs_diff": diff, "of_scale": diff / max(scale, 1e-30), "tol": tol}


def _sharded_components(cap, mesh):
    """Y's components at Y's shapes on the last lead's inputs, card against
    CPU: the pencil FFT against ``torch.fft``, the halo warp (the scan's
    and the public ``sharded_warp``) against ``warp_shifted``'s plain
    version, the psum matcher and the rim mask against themselves on the
    CPU as one block (``mesh=None``)."""
    from pysteps_tpu_torch.parallel import dist_fft, halo

    field, tstate, size, _ = cap.args["_match_cdf_psum"]
    m, n = field.shape[-2:]
    out = {"shape": list(field.shape)}
    spec = dist_fft.rfft2_local(field, mesh)
    ref = torch.fft.rfft2(field.cpu())
    out["rfft2_local"] = _span_check("Y rfft2_local", spec[..., : n // 2 + 1], ref,
                                     SHARDED_SPAN_TOL)
    out["irfft2_local"] = _span_check("Y irfft2_local", dist_fft.irfft2_local(spec, (m, n), mesh),
                                      field.cpu(), SHARDED_SPAN_TOL)
    cpu_t = tuple(t.cpu() for t in tstate)
    span = float(tstate[0][-1] - tstate[0][0])
    out["match_cdf_psum"] = _span_check(
        "Y _match_cdf_psum", cap.orig["_match_cdf_psum"](field, tstate, size, mesh),
        cap.orig["_match_cdf_psum"](field.cpu(), cpu_t, size, None), SHARDED_SPAN_TOL, span)
    ext, h, thr, kr, r, _ = cap.args["_dilated_mask_from_ext"]
    out["rim_mask"] = _span_check(
        "Y rim mask", cap.orig["_dilated_mask_from_ext"](ext, h, thr, kr, r, mesh),
        cap.orig["_dilated_mask_from_ext"](ext.cpu(), h, thr, kr, r, None), 1e-6)
    ext, disp, h, precip_min, _ = cap.args["_warp_from_ext"]
    warped = warp_mod.warp_shifted(ext.cpu(), halo._pad_rows(disp.cpu(), h), h, mode="nearest")
    ref = torch.where(halo._inside(disp.cpu(), 0, m), warped[..., h:-h, :], precip_min)
    scale = float(ext.abs().max())
    out["warp_from_ext"] = _span_check(
        "Y halo warp", cap.orig["_warp_from_ext"](ext, disp, h, precip_min, mesh), ref,
        SHARDED_SPAN_TOL, scale)
    # the public warp against the unsharded one: positions in the extended
    # block round at its row numbers, so their fractions differ by up to
    # an ulp of m + 2 halo, times the field's span
    f0, d0 = ext[0, h:-h].contiguous(), disp[0].contiguous()
    ulp = 2.0 ** (int(np.ceil(np.log2(m + 2 * h))) - 23)
    out["sharded_warp"] = _span_check(
        "Y sharded_warp", halo.sharded_warp(f0, d0, mesh, h),
        warp_mod.warp_shifted(f0.cpu(), d0.cpu(), h, cval=0.0), ulp,
        float(f0.max() - f0.min()))
    out["halo"] = h
    return out


def _sharded_law(mesh):
    """``sharded_steps`` at 16 x 128^2 x 6 on the card against the same
    on a CPU mesh (a spawned gloo rank), by the MODEL_PARITY.json recipe:
    CRPS and spread/error over the leads, 2 seeds."""
    from pysteps_tpu_torch.parallel import sharded_steps

    workers = parallel_workers
    db, vel, truth = workers.law_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        cpu = workers.run_group(workers.law_cpu, tmp, world=1)[0]
    card, cpu_s = [], []
    for seed in workers.LAW_SEEDS:
        out = sharded_steps.forecast(db, vel, 6, mesh, seed=seed, **workers.LAW_KW)
        card.append(workers.law_scores(out.cpu().numpy(), truth))
        cpu_s.append(workers.law_scores(cpu[f"law_{seed}"], truth))
    (c_card, r_card), (c_cpu, r_cpu) = np.mean(card, axis=0), np.mean(cpu_s, axis=0)
    rec = {"crps_card": c_card, "crps_cpu": c_cpu, "spread_error_card": r_card,
           "spread_error_cpu": r_cpu, "tol_rel": PARALLEL_LAW_TOL,
           "members_side_leads": [workers.LAW_KW["n_ens_members"], 128, 6]}
    if abs(c_card - c_cpu) > PARALLEL_LAW_TOL * c_cpu or \
            abs(r_card - r_cpu) > PARALLEL_LAW_TOL * r_cpu:
        raise AssertionError(f"Y law: card and CPU differ: {rec}")
    return rec


def _sharded_path(label, mesh, E, side, T, inputs, kw, expected, name, smi):
    """``sharded_steps.forecast`` once to warm up, keeping the last call's
    inputs of its matcher, mask and warp (:class:`_ShardedCapture`) and of
    each K1 and K4 launch, whose copies are held against the plain
    versions on leaving (:class:`_PathKernelInputs`); then timed with the
    launch counts set to 0 just before and read just after.  Raises
    unless K1 ran on both axes on the halo-extended members (E, side +
    2 halo, side) at the halo's bound and K4 on the (1, side, side) mask,
    the counts are ``expected``, the output is finite with values in the
    target's range and its members spread at every lead.  Returns (record,
    capture)."""
    from pysteps_tpu_torch.parallel import sharded_steps

    precip_db, velocity = inputs
    kernels = _PathKernelInputs(label)
    with kernels, _ShardedCapture() as cap:
        out = sharded_steps.forecast(precip_db, velocity, T, mesh, n_ens_members=E, **kw)
        torch.cuda.synchronize()
    del out
    h = cap.args["_warp_from_ext"][2]
    block = (E, side + 2 * h, side)
    for axis in (0, 1):
        if (axis, block, block, h) not in kernels.k1:
            raise AssertionError(f"{label}: no K1 launch on axis {axis} at {block}, bound {h}: "
                                 f"{sorted(kernels.k1)}")
    if not any(key[0] == (1, side, side) for key in kernels.k4):
        raise AssertionError(f"{label}: no K4 launch at (1, {side}, {side}): "
                             f"{sorted(kernels.k4)}")
    torch.cuda.reset_peak_memory_stats()
    with _ShardedCapture() as timing:
        _kernels.reset_launches()
        t0 = time.time()
        out = sharded_steps.forecast(precip_db, velocity, T, mesh, n_ens_members=E,
                                     **dict(kw, seed=kw["seed"] + 1))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    init_s = timing.loop_t0 - t0
    if tuple(out.shape) != (E, T, side, side) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{label}: output {tuple(out.shape)} not finite of its shape")
    # matched values lie in the last input's range, the inflow fill is the
    # inputs' minimum
    lo, hi = float(np.min(precip_db)), float(np.max(precip_db[-1]))
    if float(out.min()) < lo - 1e-3 or float(out.max()) > hi + 1e-3:
        raise AssertionError(f"{label}: values outside the inputs' range")
    _check_launches(label, launches, expected)
    spread = out.std(dim=0).reshape(T, -1).mean(dim=1).cpu().numpy()
    if not bool((spread > 0).all()):
        raise AssertionError(f"{label}: no ensemble spread at some lead: {spread.tolist()}")
    rec = {"phase": f"path {label}", "shape": list(out.shape), "mesh": [1, 1, 1],
           "backend": "nccl", "member_frames_per_s": E * T / wall, "wall_s": wall,
           "init_s": init_s, "loop_s": wall - init_s, "max_memory_allocated": peak,
           "spread_per_lead": spread.tolist(), "launches": launches,
           "expected_launches": expected, "halo": h, "kernels_at_path_shapes": kernels.rows,
           "device": name, "nvidia_smi": smi}
    return rec, cap


def _ens_blocks_path(mesh, name, smi):
    """A-ens: STEPS' ``mesh=`` branch at path A's size with its members
    over an "ens" dimension of 2 ranks, each rank's block run in turn on
    the one card (``parallel_workers.as_ens_rank`` on the 1-rank NCCL
    mesh), each timed with the launch counts set to 0 just before and read
    just after.  Raises unless each block's counts are those of the code
    (``parallel_workers.block_launches``: path A's) and the blocks put
    together have the unsharded forecast's NaN set and its values within
    ``ENS_BLOCK_ATOL``.  Not bit for bit: cuFFT's plans depend on the
    batch, so a block's transforms round unlike the whole ensemble's, and
    the CDF match hands that on (on the CPU the blocks are bit-equal:
    tests/test_torch_parallel.py).  Returns block 0's counts."""
    E, side, T = N_MEMBERS, SIDE, N_LEADS
    precip_db, velocity = bench_inputs(side)
    p = torch.as_tensor(precip_db, device="cuda")
    v = torch.as_tensor(velocity, device="cuda")
    f = nowcasts.get_method("steps")
    kw = dict(BENCH_KWARGS, n_ens_members=E, seed=43)
    whole = f(p, v, T, **kw)
    blocks, recs = [], []
    for block in ((0, E // 2), (E // 2, E)):
        with parallel_workers.as_ens_rank(block):
            torch.cuda.synchronize()
            _kernels.reset_launches()
            t0 = time.time()
            out = f(p, v, T, mesh=mesh, **kw)
            torch.cuda.synchronize()
            wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
        expected = parallel_workers.block_launches(block, E, T)
        _check_launches(f"A-ens block {block}", launches, expected)
        if tuple(out.shape) != (block[1] - block[0], T, side, side):
            raise AssertionError(f"A-ens block {block}: output {tuple(out.shape)}")
        blocks.append(out)
        recs.append({"block": list(block), "wall_s": wall,
                     "member_frames_per_s": (block[1] - block[0]) * T / wall,
                     "launches": launches, "expected_launches": expected})
    joined = torch.cat(blocks)
    diff = torch.nan_to_num(joined - whole).abs()
    against = {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
               "bit_equal_share": float((diff == 0).float().mean()), "atol": ENS_BLOCK_ATOL}
    if not torch.equal(torch.isnan(whole), torch.isnan(joined)) or \
            against["max_abs_diff"] > ENS_BLOCK_ATOL:
        raise AssertionError(f"A-ens: the blocks differ from the unsharded forecast: {against}")
    emit({"phase": "path A-ens", "shape": list(joined.shape), "ens_ranks": 2,
          "blocks": recs, "against_unsharded": against, "device": name, "nvidia_smi": smi})
    return recs[0]["launches"]


def _rainfarm_path(name, smi):
    """Z: ``downscale_ensemble`` of the bench's 128^2 coarse field by 4
    into 24 realizations, timed once after a warm-up with every kernel
    count 0; each realization's aggregate back to 128^2 against the input,
    and the core on the card against the CPU on the same white draws
    (with and without the Gaussian kernel)."""
    from pysteps_tpu_torch.downscaling import rainfarm
    from pysteps_tpu_torch.utils.dimension import aggregate_fields

    factor, members = RAINFARM_512
    coarse = np.asarray(bench_rain(SIDE, n_frames=3)[2][::4, ::4], np.float64)
    rainfarm.downscale_ensemble(coarse, factor, members, seed=42)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.time()
    out = rainfarm.downscale_ensemble(coarse, factor, members, seed=43)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    _check_launches("Z", launches, {})
    if tuple(out.shape) != (members, SIDE, SIDE) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"Z: output {tuple(out.shape)} not finite of its shape")
    agg = aggregate_fields(out, factor, axis=(-2, -1)).cpu().double().numpy()
    scale = max(float(np.abs(coarse).max()), 1e-6)
    agg_err = float(np.abs(agg - coarse[None]).max(axis=(1, 2)).max()) / scale
    if agg_err > 2e-3:  # tests/test_downscaling.py:68-73
        raise AssertionError(f"Z: aggregates miss the input by {agg_err} of its max")
    alpha = rainfarm._estimate_alpha(coarse, rainfarm._compute_freq_array(coarse))
    white = torch.rand((members, SIDE, SIDE), generator=torch.Generator().manual_seed(5))
    p = torch.as_tensor(coarse, dtype=torch.float32)
    a32 = float(np.float32(alpha))

    def core_on(dev, kernel):
        return rainfarm._downscale_core(p.to(dev), p.to(dev), a32, white.to(dev), 0.0,
                                        factor, kernel, False, False)

    core = {str(k): _span_check(f"Z core ({k})", core_on("cuda", k), core_on("cpu", k),
                                RAINFARM_CORE_TOL) for k in (None, "gaussian")}
    emit({"phase": "path Z", "shape": list(out.shape), "fields_per_s": members / wall,
          "wall_s": wall, "alpha": alpha, "aggregate_max_err_of_max": agg_err,
          "core_card_vs_cpu": core, "launches": launches, "device": name,
          "nvidia_smi": smi})
    return launches


def _distributed_verification(mesh, forecast, name, smi):
    """``distributed_verify`` on the 1-rank mesh over path A's last lead
    against the serial scores of the verification phase: contingency
    counts exact (int64), CSI / POD / FAR within 1e-6, CRPS and FSS within
    1e-5 (relative)."""
    from pysteps_tpu_torch.verification import detcatscores, probscores, spatialscores
    from pysteps_tpu_torch.verification import parallel as vparallel

    frames, _ = bench_inputs(SIDE, n_frames=3 + N_LEADS)
    obs = torch.as_tensor(frames[-1], device="cuda")
    mean = torch.nanmean(forecast, dim=0)
    rec = {"phase": "distributed verification", "shape": list(forecast.shape),
           "mesh": [1, 1, 1], "backend": "nccl", "device": name, "nvidia_smi": smi}
    accum, compute = vparallel.distributed_verify("det_cat", mesh, thr=VERIFY_THR_DB)
    state = accum(mean[None], obs[None])
    serial = detcatscores.det_cat_fct_init(VERIFY_THR_DB)
    detcatscores.det_cat_fct_accum(serial, mean, obs)
    for k in ("hits", "false_alarms", "misses", "correct_negatives"):
        if state[k].dtype != torch.int64 or int(state[k]) != int(serial[k]):
            raise AssertionError(f"distributed {k}: {state[k]} against {serial[k]}")
    checks = {"det_cat": ([compute(state, s) for s in ("CSI", "POD", "FAR")],
                          [detcatscores.det_cat_fct_compute(serial, s)
                           for s in ("CSI", "POD", "FAR")], 1e-6)}
    accum, compute = vparallel.distributed_verify("CRPS", mesh)
    checks["CRPS"] = ([compute(accum(forecast[None], obs[None]))],
                      [probscores.CRPS(forecast, obs)], 1e-5)
    for sc in VERIFY_SCALES:
        accum, compute = vparallel.distributed_verify("FSS", mesh, thr=VERIFY_THR_DB, scale=sc)
        checks[f"FSS scale {sc}"] = ([compute(accum(mean[None], obs[None]))],
                                     [spatialscores.fss(mean, obs, VERIFY_THR_DB, sc)], 1e-5)
    rec["counts"] = {k: int(state[k]) for k in ("hits", "false_alarms", "misses",
                                                "correct_negatives")}
    for label, (dist_v, serial_v, rtol) in checks.items():
        d = np.array([float(v) for v in dist_v])
        s_ = np.array([float(v) for v in serial_v])
        rel = float(np.max(np.abs(d - s_) / np.maximum(np.abs(s_), 1e-30)))
        rec[label] = {"distributed": d.tolist(), "serial": s_.tolist(), "max_rel_diff": rel,
                      "rtol": rtol}
        if rel > rtol:
            raise AssertionError(f"distributed {label}: {rec[label]}")
    emit(rec)


# the mesh= of blending, the PCA EnKF and VET, on the same mesh:
# V-y the spatially sharded blending loop at blend_512, V-ens blending's
# member blocks at V's size, W-mesh the PCA EnKF at pca_enkf_256, O-mesh
# VET at O's size.  V-y's captured matcher, rim mask and halo warp are held
# card against CPU on their first members; its whole loop at (members,
# side, leads) on the same handed draws within a share of the span
BLEND_Y_CPU_MEMBERS = 16
BLEND_Y_PARITY = (8, 128, 4)
BLEND_Y_SPAN_TOL = 1e-3
HALO_WARP_TOL = 1e-6  # of the extended block's largest magnitude
# the sharded PCA fit against the SVD: components with variance (above
# 1e-6 of the largest), up to sign, as tests/test_torch_parallel_blending.py
# holds them, and the variances within 1e-4 of the largest (the Gram
# matrix sums W's 45,379 rainy boxes in float32; the CPU test's 1e-5 is at
# 1,000 features); the masked EnKF's correction with the mesh within
# tests/test_torch_enkf.py's 1e-4 of its largest value
PCA_COMP_TOL, PCA_VAR_RTOL, ENKF_MESH_TOL = 1e-4, 1e-4, 1e-4
# VET with the mesh (the exact gather) against unsharded VET on the card's
# exact branch at tests/test_parallel.py:222-241's case (64^2, sectors
# (8, 4), 40 iterations), within its 0.1 px.  At O's size its flow is not
# held to O's (the shift branch through K1): VET's Adam loop amplifies the
# two warps' difference (0.158 px RMS and 0.464 px at most between the
# port's two branches on the CPU at 512^2); it is held on
# tests/test_motion.py's truth bound instead, as O is
VET_MESH_SMALL = (64, ((8, 4), (8, 4)), 40)
VET_MESH_PX = 0.1


def _to_device(obj, dev):
    """A copy of a blending params or state dataclass with every tensor on
    ``dev``."""
    import dataclasses

    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(dev) for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


def _blend_sharded_components(cap, mesh):
    """V-y's matcher (the binned resampled target), rim mask and halo warp
    on the first members of their last lead's arguments, card against the
    CPU as one block (``mesh=None``): the matcher and the rim mask
    bit-equal, the halo warp within ``HALO_WARP_TOL`` of the block's
    largest magnitude."""
    n = BLEND_Y_CPU_MEMBERS
    orig = cap.orig

    def cpu(a):
        return a.cpu() if isinstance(a, torch.Tensor) else a

    def first(args):
        return [a[:n] if isinstance(a, torch.Tensor) and a.ndim else a for a in args]

    out = {"members": n}
    margs = first(cap.args["_match_cdf_psum_binned"][:-1])
    card = orig["_match_cdf_psum_binned"](*margs, mesh)
    ref = orig["_match_cdf_psum_binned"](*map(cpu, margs), None)
    out["match_cdf_psum_binned"] = _span_check("V-y matcher", card, ref, 0.0)
    field, thr, kr, r, _ = cap.args["_dilated_mask_halo"]
    out["rim_mask"] = _span_check(
        "V-y rim mask", orig["_dilated_mask_halo"](field[:n], thr, kr, r, mesh),
        orig["_dilated_mask_halo"](field[:n].cpu(), thr, kr, r, None), 0.0)
    ext, disp, h, cval, _ = cap.args["_warp_from_ext"]
    out["warp_from_ext"] = _span_check(
        "V-y halo warp", orig["_warp_from_ext"](ext[:n], disp[:n], h, cval, mesh),
        orig["_warp_from_ext"](ext[:n].cpu(), disp[:n].cpu(), h, cval, None), HALO_WARP_TOL,
        float(ext[:n].abs().max()))
    out["shape"], out["halo"] = list(field.shape), h
    return out


def _blend_scan_card_vs_cpu(mesh):
    """The whole sharded blending loop at ``BLEND_Y_PARITY`` on the card
    (the NCCL mesh) against the CPU (one block), from the same CPU-prepared
    inputs and the same white spectra and picks handed in."""
    from pysteps_tpu_torch.parallel import sharded_blending as sb

    E, side, T = BLEND_Y_PARITY
    db, nwp, velocity = blend_inputs(side)
    with tempfile.TemporaryDirectory() as skill_dir:
        inp = blend_mod.scan_inputs(db, nwp, velocity, velocity[None], T, 5.0, device="cpu",
                                    **_blend_kw(E, skill_dir))
    # the port's own draws (Hermitian where irfft2 needs it), made on the
    # CPU once
    gen = torch.Generator().manual_seed(11)
    white = [fftgenerators._spectral_white(gen, (side, side), E) for _ in range(T)]
    picks = [torch.rand((E, side * side), generator=gen) < 0.5 for _ in range(T)]

    def run(params, state, m, dev):
        w_it, p_it = (x.to(dev) for x in white), (x.to(dev) for x in picks)
        draw, bern = sb._fft_noise_draw, sb._bernoulli
        sb._fft_noise_draw = lambda gen, shape, batch, domain, full: next(w_it)
        sb._bernoulli = lambda gen, p, shape: next(p_it)
        try:
            return sb.blending_scan_sharded(params, state, T, m, vmax_bound=inp.vmax_bound,
                                            **inp.statics)
        finally:
            sb._fft_noise_draw, sb._bernoulli = draw, bern

    dev = torch.device("cuda")
    card = run(_to_device(inp.params, dev), _to_device(inp.state, dev), mesh, dev)
    cpu = run(inp.params, inp.state, None, torch.device("cpu"))
    span = float(cpu.max() - cpu.min())
    return dict(_span_check("V-y loop", card, cpu, BLEND_Y_SPAN_TOL, span),
                shape=[E, T, side, side])


def _blend_sharded_path(mesh, name, smi):
    """V-y: ``sharded_blending.blending_scan_sharded`` at V's size and
    keywords (``blend_512``), driven with the arguments that
    ``blending.steps.forecast`` prepares for its loop
    (``blending.steps.scan_inputs``), once to warm up inside
    :class:`_PathKernelInputs` (K1 at the halo-extended members (E, side +
    2 halo, side) held bit-equal to its plain version) and :class:`_Capture`,
    then timed, preparation included, with the launch counts set to 0 just
    before and read just after: K1 once an axis a lead (the composite's
    halo warp; the velocity is sampled by the exact gather, as JAX's), K4
    once (the init mask; the lead's rim comes from max-pools, as JAX's).
    Then its components and a small whole loop card against CPU, and its
    law against V's."""
    from pysteps_tpu_torch.parallel import sharded_blending as sb

    E, side, T = BLEND_MEMBERS, SIDE, N_LEADS
    db, nwp, velocity = blend_inputs(side)
    dev = torch.device("cuda")
    args = (torch.as_tensor(db, device=dev), torch.as_tensor(nwp, device=dev),
            torch.as_tensor(velocity, device=dev), torch.as_tensor(velocity[None], device=dev),
            T, 5.0)
    expected = {"resample_axis0": T, "resample_axis1": T, "rim_from_mask": 1}

    def prepare_and_run(kw):
        inp = blend_mod.scan_inputs(*args, **kw)
        torch.cuda.synchronize()
        t_loop = time.time()
        out = sb.blending_scan_sharded(inp.params, inp.state, inp.int_steps, mesh,
                                       vmax_bound=inp.vmax_bound, **inp.statics)
        return inp, out, t_loop

    with tempfile.TemporaryDirectory() as skill_dir:
        kw = _blend_kw(E, skill_dir)
        kernels = _PathKernelInputs("V-y")
        with kernels, _Capture(sb, ("_match_cdf_psum_binned", "_dilated_mask_halo",
                                    "_warp_from_ext")) as cap:
            inp, out, _ = prepare_and_run(kw)
            torch.cuda.synchronize()
        del out
        h = sb._halo(T, inp.vmax_bound, inp.statics["struct_radius"], inp.statics["mask_rim"],
                     side)
        block = (E, side + 2 * h, side)
        for axis in (0, 1):
            if (axis, block, block, h) not in kernels.k1:
                raise AssertionError(f"V-y: no K1 launch on axis {axis} at {block}, bound {h}: "
                                     f"{sorted(kernels.k1)}")
        k1_rows = [r for r in kernels.rows if r["name"].startswith("K1") and
                   tuple(r["shape"]) == block]
        if len(k1_rows) != 2 or any(r["max_abs_err"] != 0.0 for r in k1_rows):
            raise AssertionError(f"V-y: K1 at {block} is not bit-equal to its plain version: "
                                 f"{k1_rows}")
        del inp
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.time()
        inp, out, t_loop = prepare_and_run(kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _check_launches("V-y", launches, expected)
    if tuple(out.shape) != (E, T, side, side) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"V-y: output {tuple(out.shape)} not finite of its shape")
    rec = {"phase": "path V-y", "method": "sharded_blending.blending_scan_sharded",
           "shape": list(out.shape), "mesh": [1, 1, 1], "backend": "nccl",
           "member_frames_per_s": E * T / wall, "wall_s": wall, "init_s": t_loop - t0,
           "loop_s": wall - (t_loop - t0), "max_memory_allocated": peak,
           "spread_per_lead": _spread(out, T), "launches": launches,
           "expected_launches": expected, "halo": h, "kernels_at_path_shapes": kernels.rows}
    law = _law_scores_card(out, bench_rain(side, n_frames=3 + T)[3:])
    del out
    ref = KEPT["V_law"]
    rec["law_vs_V"] = {"V_y": law, "V": ref, "tol_rel": PARALLEL_LAW_TOL}
    if any(abs(law[k] - ref[k]) > PARALLEL_LAW_TOL * abs(ref[k]) for k in ref):
        raise AssertionError(f"V-y law: the sharded and unsharded blends differ: {rec['law_vs_V']}")
    rec["components_card_vs_cpu"] = _blend_sharded_components(cap, mesh)
    del cap
    rec["loop_card_vs_cpu"] = _blend_scan_card_vs_cpu(mesh)
    emit({**rec, "device": name, "nvidia_smi": smi})
    return launches


def _blend_ens_blocks_path(mesh, name, smi):
    """V-ens: ``blending.get_method("steps")`` with ``mesh=`` at V's size as
    each of 2 "ens" ranks in turn (``parallel_workers.as_ens_rank``), each
    timed with the launch counts set to 0 just before and read just after:
    a block launches V's kernels (3 K1 an axis a lead and 1 + T K4 from a
    mask: its launches serve all its members).  The blocks put together
    have the unsharded card forecast's NaN set and its values within
    ``ENS_BLOCK_ATOL`` (every rank draws every member's noise and picks,
    but cuFFT rounds a block's batch otherwise).  Returns block 0's
    counts."""
    E, side, T = BLEND_MEMBERS, SIDE, N_LEADS
    db, nwp, velocity = blend_inputs(side)
    dev = torch.device("cuda")
    args = (torch.as_tensor(db, device=dev), torch.as_tensor(nwp, device=dev),
            torch.as_tensor(velocity, device=dev), torch.as_tensor(velocity[None], device=dev),
            T, 5.0)
    f = blending.get_method("steps")
    expected = {"resample_axis0": 3 * T, "resample_axis1": 3 * T, "rim_from_mask": 1 + T}
    blocks, recs = [], []
    with tempfile.TemporaryDirectory() as skill_dir:
        kw = _blend_kw(E, skill_dir)
        whole = f(*args, **kw)
        for block in ((0, E // 2), (E // 2, E)):
            with parallel_workers.as_ens_rank(block):
                torch.cuda.synchronize()
                _kernels.reset_launches()
                t0 = time.time()
                out = f(*args, mesh=mesh, **kw)
                torch.cuda.synchronize()
                wall = time.time() - t0
            launches = dict(_kernels.LAUNCHES)
            _check_launches(f"V-ens block {block}", launches, expected)
            if tuple(out.shape) != (block[1] - block[0], T, side, side):
                raise AssertionError(f"V-ens block {block}: output {tuple(out.shape)}")
            blocks.append(out)
            recs.append({"block": list(block), "wall_s": wall,
                         "member_frames_per_s": (block[1] - block[0]) * T / wall,
                         "launches": launches, "expected_launches": expected})
    joined = torch.cat(blocks)
    diff = torch.nan_to_num(joined - whole).abs()
    against = {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
               "bit_equal_share": float((diff == 0).float().mean()), "atol": ENS_BLOCK_ATOL}
    if not torch.equal(torch.isnan(whole), torch.isnan(joined)) or \
            against["max_abs_diff"] > ENS_BLOCK_ATOL:
        raise AssertionError(f"V-ens: the blocks differ from the unsharded forecast: {against}")
    emit({"phase": "path V-ens", "method": "blending.steps", "shape": list(joined.shape),
          "ens_ranks": 2, "blocks": recs, "against_unsharded": against, "device": name,
          "nvidia_smi": smi})
    return recs[0]["launches"]


def _pca_fit_against_svd(Xc, mesh):
    """``utils.pca._fit_pca_sharded`` on the mesh against the SVD of the
    same centred matrix on the card: the variances, and every component
    with variance up to its sign (the last component of a centred
    ensemble has none and is rounding in both)."""
    from pysteps_tpu_torch.utils import pca

    vt, var = pca._fit_pca_sharded(Xc, mesh)
    _, S, vt_svd = torch.linalg.svd(Xc, full_matrices=False)
    var_svd = S**2 / (Xc.shape[0] - 1)
    keep = var_svd > 1e-6 * var_svd.max()
    sign = torch.sign((vt * vt_svd).sum(dim=1, keepdim=True))
    comp_err = float((vt * sign - vt_svd)[keep].abs().max())
    var_err = float(((var - var_svd).abs() / var_svd.max()).max())
    rec = {"shape": list(Xc.shape), "components_with_variance": int(keep.sum()),
           "max_abs_diff_components": comp_err, "tol": PCA_COMP_TOL,
           "max_var_diff_over_largest": var_err, "var_rtol": PCA_VAR_RTOL}
    if comp_err > PCA_COMP_TOL or var_err > PCA_VAR_RTOL:
        raise AssertionError(f"W-mesh: the sharded PCA fit and the SVD differ: {rec}")
    return rec


def _enkf_mesh_path(mesh, name, smi):
    """W-mesh: the PCA EnKF at ``pca_enkf_256`` through its nowcaster with
    ``mesh=`` (the combination loop runs replicated, so it launches W's
    kernels, 3 K1 an axis a nowcast cycle), timed with the launch counts
    set to 0 just before and read just after, against W's forecast without
    the mesh; the sharded PCA fit (one shard) against the SVD on one
    correction's stacked ensembles (the NWP ensemble's first lead as the
    background, its second as the observation, their rainy boxes), and
    ``MaskedEnKF.correct_step`` with the mesh against it without."""
    from pysteps_tpu_torch.blending.ens_kalman_filter_methods import MaskedEnKF

    dev = torch.device("cuda")
    T = N_LEADS
    obs, obs_ts, nwp, nwp_ts, velocity, t0 = _enkf_inputs(dev)
    cfg = pca_enkf_mod.EnKFCombinationConfig(
        n_ens_members=ENKF_MEMBERS, n_cascade_levels=ENKF_LEVELS, precip_threshold=-10.0,
        norain_threshold=0.01, seed=43)

    def caster(m):
        return pca_enkf_mod.EnKFCombinationNowcaster(
            obs, nwp, velocity, 5 * T, enkf_combination_config=cfg, obs_timestamps=obs_ts,
            nwp_timestamps=nwp_ts, issuetime=t0, measure_time=True, mesh=m)

    plain, _, _ = caster(None).compute_forecast()
    run = caster(mesh)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t_start = time.time()
    out, init_s, loop_s = run.compute_forecast()
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(_kernels.LAUNCHES)
    cycles = T - len(ENKF_FULL_NWP_LEADS)
    _check_launches("W-mesh", launches, {"resample_axis0": 3 * cycles,
                                         "resample_axis1": 3 * cycles})
    if run.full_nwp_leads != ENKF_FULL_NWP_LEADS:
        raise AssertionError(f"W-mesh: the full NWP at {run.full_nwp_leads}")
    rec = {"phase": "path W-mesh", "method": "blending.pca_enkf",
           "shape": list(out.shape), "mesh": [1, 1, 1], "backend": "nccl", "wall_s": wall,
           "init_s": init_s, "loop_s": loop_s, "member_frames_per_s": ENKF_MEMBERS * T / wall,
           "launches": launches, "against_W": _nanclose("W-mesh", out, plain, 1e-4)}
    del out, plain, run
    bg, ob = nwp[:, 1], nwp[:, 2]
    X = torch.cat([bg.reshape(ENKF_MEMBERS, -1), ob.reshape(ENKF_MEMBERS, -1)])
    rainy = (X >= -10.0).any(dim=0)
    Xr = X[:, rainy]
    rec["pca_fit_vs_svd"] = _pca_fit_against_svd(Xr - Xr.mean(dim=0), mesh)

    class Cfg:
        n_ens_members, precip_threshold, norain_threshold = ENKF_MEMBERS, -10.0, 0.01

    def correct(m):
        params = type("P", (), {"combination_kwargs": {"mesh": m,
                                                       "iterative_prob_matching": False}})()
        return MaskedEnKF(Cfg(), params).correct_step(bg, ob)[0]

    card, ref = correct(mesh), correct(None)
    err = float((card - ref).abs().max() / ref.abs().max())
    rec["masked_enkf_mesh_vs_svd"] = {"max_abs_diff_over_max": err, "tol": ENKF_MESH_TOL}
    if not err <= ENKF_MESH_TOL:
        raise AssertionError(f"W-mesh: MaskedEnKF with the mesh differs: {err}")
    emit({**rec, "device": name, "nvidia_smi": smi})
    return launches


def _vet_mesh_path(mesh, name, smi):
    """O-mesh: VET at O's size and inputs with ``mesh=``, timed once (no
    warm-up) with the launch counts set to 0 just before and read just
    after: no K1, by the JAX package's design (each row block warps the
    replicated template by the exact gather).  Its flow beside O's (the
    card's shift branch through K1) and both against the true motion;
    ``tests/test_parallel.py``'s case with the mesh against unsharded VET
    on the card's exact branch, within its 0.1 px at every pixel; and
    ``tests/test_motion.py``'s case with the mesh under its truth bound."""
    dev = torch.device("cuda")
    frames, _ = bench_inputs(SIDE, n_frames=MOTION_PATHS["O"][1])
    x = torch.as_tensor(frames, device=dev)
    f = motion.get_method("vet")
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.time()
    flow = f(x, verbose=False, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    _check_launches("O-mesh", launches, {})
    diff = (flow - KEPT["O_flow"]).abs().double()
    against_o = {"max_abs_diff_px": float(diff.max()),
                 "rms_diff_px": float(torch.sqrt(torch.mean(diff**2))),
                 "rel_rmse_vs_truth_O": _rel_rmse(KEPT["O_flow"])}
    side, sectors, maxiter = VET_MESH_SMALL
    small = make_synthetic_sequence(n_frames=2, shape=(side, side), velocity=(2.0, 1.0), seed=4)
    small = torch.as_tensor(np.where(small >= 0.1, 10 * np.log10(np.maximum(small, 0.1)),
                                     -15.0).astype(np.float32), device=dev)
    kw = dict(sectors=sectors, options={"maxiter": maxiter}, verbose=False)
    small_diff = float((f(small, mesh=mesh, **kw) - f(small, max_disp=None, **kw)).abs().max())
    if small_diff > VET_MESH_PX:
        raise AssertionError(f"O-mesh: sharded and unsharded VET differ by {small_diff} px")
    emit({"phase": "path O-mesh", "method": "vet", "shape": [3, SIDE, SIDE], "mesh": [1, 1, 1],
          "backend": "nccl", "wall_s": wall, "retrievals_per_s": 1.0 / wall,
          "rel_rmse_vs_truth": _rel_rmse(flow), "launches": launches, "beside_O": against_o,
          "truth_test_motion": _truth_on_card("vet", mesh=mesh),
          "small_case_vs_unsharded": {"max_abs_diff_px": small_diff, "tol_px": VET_MESH_PX,
                                      "side": side, "maxiter": maxiter},
          "device": name, "nvidia_smi": smi})
    return launches


def phase_parallel(name, smi, forecast):
    """Paths Y, Y', A-ens and Z, the distributed verification and paths V-y,
    V-ens, W-mesh and O-mesh (see the module docstring); the process group
    is destroyed at the end, and on failure."""
    import torch.distributed as dist

    t0 = time.time()
    by_path = {}
    mesh = _nccl_mesh()
    try:
        E, side, T = PATH_Y
        rec, cap = _sharded_path(
            "Y", mesh, E, side, T, bench_inputs(side), SHARDED_KWARGS,
            {"resample_axis0": T, "resample_axis1": T, "rim_from_mask": 1}, name, smi)
        rec["components_card_vs_cpu"] = _sharded_components(cap, mesh)
        del cap
        rec["law_card_vs_cpu"] = _sharded_law(mesh)
        emit(rec)
        by_path["Y"] = rec["launches"]
        E, side, T, levels = PATH_Y2
        rec, cap = _sharded_path(
            "Y'", mesh, E, side, T, parallel_workers.conus_inputs(side, side),
            dict(SHARDED_KWARGS, n_cascade_levels=levels, vel_pert_method=None, seed=13),
            {"resample_axis0": T, "resample_axis1": T, "rim_from_mask": 1}, name, smi)
        del cap
        emit(rec)
        by_path["Y'"] = rec["launches"]
        torch.cuda.empty_cache()
        by_path["A-ens"] = _ens_blocks_path(mesh, name, smi)
        by_path["Z"] = _rainfarm_path(name, smi)
        _distributed_verification(mesh, forecast, name, smi)
        by_path["V-y"] = _blend_sharded_path(mesh, name, smi)
        torch.cuda.empty_cache()
        by_path["V-ens"] = _blend_ens_blocks_path(mesh, name, smi)
        by_path["W-mesh"] = _enkf_mesh_path(mesh, name, smi)
        by_path["O-mesh"] = _vet_mesh_path(mesh, name, smi)
    finally:
        dist.destroy_process_group()
    emit({"phase": "parallel", "seconds": time.time() - t0, "device": name, "nvidia_smi": smi})
    return by_path


def phase_native(name, smi):
    """native: the port's C++ decoders (``pysteps_tpu_torch/native``) built
    with the host's ``g++`` into ``build/`` and loaded; ``radolan_decode``
    of one synthetic 512^2 frame against the NumPy decode of the same
    bytes (the low 12 bits times the precision in float32, bit 13 no
    data, rows flipped), bit for bit."""
    from pysteps_tpu_torch import native

    t0 = time.time()
    lib = native.get_lib()
    build_s = time.time() - t0
    if lib is None:
        raise AssertionError("native: the decoder library did not build or load")
    raw = np.random.RandomState(0).randint(0, 2**16, size=SIDE * SIDE).astype(np.uint16)
    out = native.radolan_decode(raw, SIDE, 0.1)
    vals = (raw & 0x0FFF).astype(np.float32) * np.float32(0.1)
    ref = np.where(raw & 0x2000, np.float32(np.nan), vals).reshape(SIDE, SIDE)[::-1]
    if out is None or not np.array_equal(out.view(np.uint32), ref.view(np.uint32)):
        raise AssertionError("native: radolan_decode differs from the NumPy decode")
    emit({"phase": "native", "library": os.path.relpath(lib._name, ROOT), "build_s": build_s,
          "omp_threads": lib.omp_thread_count(), "radolan_decode": {
              "shape": [SIDE, SIDE], "bit_equal_to_numpy": True,
              "no_data_share": float(np.isnan(ref).mean())},
          "device": name, "nvidia_smi": smi})


# path IO: the radar archive of 512^2 NPZ frames that the cycle reads (3
# inputs for the forecast), and the stretch of it that the vel-pert
# analysis covers (Lucas-Kanade on 3 frames at each of its dates)
IO_FRAMES = 8
IO_VP_DATES = 6
IO_VP_MAX_LEAD = 15  # minutes: 3 lead times for the 3 parameters of a*t^b+c
IO_TENSOR_MEMBERS = 8  # members of the last lead written from card tensors


def _io_cycle_files(tmp, start):
    """Path IO's archive: ``datasets.create_synthetic_dataset``'s NPZ
    frames under ``tmp`` and their source entry, as an rc file holds it."""
    from pysteps_tpu_torch import datasets

    _, geodata = datasets.create_synthetic_dataset(
        tmp, n_frames=IO_FRAMES, shape=(SIDE, SIDE), velocity=(2.0, 1.0), seed=42,
        start_time=start.strftime("%Y%m%d%H%M"))
    source = {"root_path": tmp, "path_fmt": "synthetic", "fn_pattern": "synthetic_%Y%m%d%H%M",
              "fn_ext": "npz", "importer": "npz", "timestep": 5, "importer_kwargs": {}}
    return geodata, source


def phase_io(name, smi):
    """Path IO: the operational cycle around the nowcast through the port's
    public entry points (see the module docstring).  Raises unless the
    re-imported forecast equals, bit for bit, the frames the callback
    handed to the exporter (a SHA-256 a lead), its metadata holds the
    importer's geodata, the forecast launched exactly path A's kernels,
    the card's float32 and bfloat16 tensors write what they read back to,
    and the fitted perturbation parameters are finite.  Returns the
    forecast's launch counts."""
    import hashlib
    import importlib.util

    from pysteps_tpu_torch import io
    from pysteps_tpu_torch.scripts import fit_vel_pert_params, run_vel_pert_analysis
    from pysteps_tpu_torch.utils import transformation

    dev = torch.device("cuda")
    secs = {}
    start = datetime.datetime(2026, 8, 17, 12, 0)
    when = start + datetime.timedelta(minutes=5 * (IO_FRAMES - 1))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        geodata, source = _io_cycle_files(tmp, start)
        secs["archive"] = time.time() - t0

        t0 = time.time()
        fns = io.archive.find_by_date(when, tmp, source["path_fmt"], source["fn_pattern"],
                                      source["fn_ext"], source["timestep"], num_prev_files=2)
        rain, _, meta = io.readers.read_timeseries(fns, io.get_method("npz", "importer"))
        secs["import"] = time.time() - t0
        if (rain.shape != (3, SIDE, SIDE) or not np.isfinite(rain).all()
                or any(meta[k] != v for k, v in geodata.items())):
            raise AssertionError(f"IO: imported {rain.shape} with metadata {meta}")

        torch.cuda.synchronize()
        _kernels.reset_launches()
        t0 = time.time()
        db, db_meta = transformation.dB_transform(rain, meta)
        velocity = motion.get_method("lucaskanade")(db)
        torch.cuda.synchronize()
        secs["motion"] = time.time() - t0
        _check_launches("IO motion", dict(_kernels.LAUNCHES), {})
        if not (db.is_cuda and velocity.is_cuda) or tuple(velocity.shape) != (2, SIDE, SIDE):
            raise AssertionError(f"IO: flow of shape {tuple(velocity.shape)} on {velocity.device}")

        outdir = os.path.join(tmp, "forecast")
        exporter = io.get_method("npz", "exporter")(
            outdir, "forecast", when, 5, N_LEADS, (SIDE, SIDE), db_meta,
            n_ens_members=N_MEMBERS, incremental="timestep")
        sums, write_s = [], [0.0]

        def callback(frames):
            t = time.time()
            sums.append(hashlib.sha256(np.ascontiguousarray(frames)).hexdigest())
            io.export_forecast_dataset(frames, exporter)
            write_s[0] += time.time() - t

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launches()
        t0 = time.time()
        res = nowcasts.get_method("steps")(db, velocity, N_LEADS, callback=callback,
                                           return_output=False, **BENCH_KWARGS)
        torch.cuda.synchronize()
        secs["forecast"] = time.time() - t0 - write_s[0]
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        k1 = _k1_launches(N_LEADS)
        _check_launches("IO", launches, {
            "resample_axis0": k1, "resample_axis1": k1, "chain_match_vert_rim": N_LEADS,
            "chain_horiz": N_LEADS, "rim_from_mask": 1})
        if res is not None or len(sums) != N_LEADS:
            raise AssertionError(f"IO: returned {type(res)} after {len(sums)} leads")
        t0 = time.time()
        io.close_forecast_files(exporter)
        secs["export"] = write_s[0] + time.time() - t0
        path = os.path.join(outdir, "forecast.npz")
        size = os.path.getsize(path)

        t0 = time.time()
        fc, fc_meta = io.nowcast_importers.import_netcdf_pysteps(path, onerror="raise")
        secs["reimport"] = time.time() - t0
        if fc.shape != (N_MEMBERS, N_LEADS, SIDE, SIDE) or fc.dtype != np.float32:
            raise AssertionError(f"IO: re-imported {fc.shape} {fc.dtype}")
        for t in range(N_LEADS):
            if hashlib.sha256(np.ascontiguousarray(fc[:, t])).hexdigest() != sums[t]:
                raise AssertionError(f"IO: lead {t} of the file differs from the callback's")
        geo_keys = ("projection", "institution", "x1", "x2", "y1", "y2", "xpixelsize",
                    "ypixelsize", "cartesian_unit", "yorigin")
        if any(fc_meta[k] != geodata[k] for k in geo_keys) or fc_meta["transform"] != "dB":
            raise AssertionError(f"IO: the file's metadata {fc_meta} lost the geodata")
        finite = float(np.isfinite(fc[:, -1]).mean())
        if finite < 0.75:
            raise AssertionError(f"IO: finite share {finite} at the last lead")

        # the card's own tensors, float32 and bfloat16, through the exporter
        lead = torch.as_tensor(fc[:IO_TENSOR_MEMBERS, -1], device=dev)
        tensor_dtypes = []
        for dtype in (torch.float32, torch.bfloat16):
            x = lead.to(dtype)[:, None]
            exp = io.get_method("npz", "exporter")(
                outdir, f"lead_{dtype}", when, 5, 1, (SIDE, SIDE), db_meta,
                n_ens_members=IO_TENSOR_MEMBERS)
            io.export_forecast_dataset(x, exp)
            io.close_forecast_files(exp)
            back, _ = io.nowcast_importers.import_netcdf_pysteps(
                os.path.join(outdir, f"lead_{dtype}.npz"), onerror="raise")
            if not np.array_equal(back, x.float().cpu().numpy(), equal_nan=True):
                raise AssertionError(f"IO: a {dtype} card tensor wrote other values")
            tensor_dtypes.append(str(dtype))

        # the plots, where matplotlib is installed
        pngs = None
        if importlib.util.find_spec("matplotlib") is not None:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            from pysteps_tpu_torch import visualization

            t0 = time.time()
            pngs = {}
            for label, draw in (
                    ("precip", lambda ax: visualization.plot_precip_field(
                        lead[0], units="dBZ", geodata=fc_meta, ax=ax)),
                    ("motion", lambda ax: visualization.motion_plot(
                        velocity, geodata=fc_meta, ax=ax))):
                fig, ax = plt.subplots()
                draw(ax)
                png = os.path.join(tmp, f"{label}.png")
                fig.savefig(png, dpi=60)
                plt.close(fig)
                pngs[label] = os.path.getsize(png)
                if pngs[label] == 0:
                    raise AssertionError(f"IO: the {label} plot is empty")
            secs["plots"] = time.time() - t0

        # the motion-perturbation analysis over the archive's last dates,
        # Lucas-Kanade on the card, and the fit of its growth curves
        t0 = time.time()
        results = run_vel_pert_analysis.run_analysis(
            when - datetime.timedelta(minutes=5 * (IO_VP_DATES - 1)), when, source,
            "lucaskanade", IO_VP_MAX_LEAD, num_prev_files=2)
        p_par, p_perp = fit_vel_pert_params.fit_parameters(results)
        secs["vel_pert"] = time.time() - t0
        if p_par is None or not (np.isfinite(p_par).all() and np.isfinite(p_perp).all()):
            raise AssertionError(f"IO: fitted perturbation parameters {p_par}, {p_perp}")
    emit({"phase": "path IO", "shape": [N_MEMBERS, N_LEADS, SIDE, SIDE], "exporter": "npz",
          "seconds": secs, "file_bytes": size, "max_memory_allocated": peak,
          "leads_bit_equal_to_callback": N_LEADS, "finite_fraction_last_lead": finite,
          "card_tensors_exported": tensor_dtypes, "png_bytes": pngs,
          "plots": "drawn" if pngs else "not drawn: matplotlib is not installed",
          "vel_pert": {"lead_times": sorted(results), "p_par": [float(v) for v in p_par],
                       "p_perp": [float(v) for v in p_perp]},
          "launches": launches, "device": name, "nvidia_smi": smi})
    return launches


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in _leaves(y)]
    return [x]



def main():
    t0 = time.time()
    name, smi = phase_device()
    peaks = card_peaks(name)
    report = phase_build()
    leads, captured = _capture_chain_leads()
    recs = phase_kernels(peaks, leads, captured, report)
    phase_parity()
    phase_noise_parity(name, smi)
    by_path = phase_paths(name, smi, captured)
    by_path.update(phase_nowcasts(name, smi))
    by_path["S"] = phase_streaming(name, smi, by_path["A"])
    phase_tf32(name, smi)
    by_path.update(phase_motion(name, smi))
    phase_postprocessing(name, smi, captured["forecast_last_lead"])
    phase_verification(name, smi, captured["forecast_last_lead"])
    by_path.update(phase_linda(name, smi))
    by_path.update(phase_blending(name, smi))
    by_path.update(phase_parallel(name, smi, captured["forecast_last_lead"]))
    phase_native(name, smi)
    by_path["IO"] = phase_io(name, smi)
    for rec in recs:
        rec["launches"] = by_path[rec["path"]][rec["counter"]]
        rec["launches_by_path"] = {k: v[rec["counter"]] for k, v in by_path.items()}
        if rec["launches"] < 1:
            raise AssertionError(f"{rec['name']} was never launched on path {rec['path']}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("library_call", "path", "shape", "launches_by_path", "at_C", "chain_ms",
             "unfused_ms", "ms_eager", "library_ms_eager", "ms_slow_lut", "matches_per_output",
             "library_same_counts", "library_hist_ms", "library_hist_call",
             "library_hist_same_counts", "ms_one_value", "max_abs_err_one_value", "dtype",
             "warp_route", "rim_route", "ptxas")
    emit({"kernels": [{k: r[k] for k in keys} | {k: r[k] for k in extra if k in r}
                      for r in recs],
          "card": smi, "peaks": {"bytes_per_s": peaks[0], "f32_flop_per_s": peaks[1]},
          "script_s": time.time() - t0})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
