"""
Build, load and count the hand-written CUDA kernels of ``csrc/``.

The sources have a plain C interface and are compiled by ``nvcc`` for
``sm_90a`` into one shared library, loaded with ``ctypes``.  The build
runs at first use into ``build/pysteps_tpu_torch/`` beside the package (the
library name carries a digest of the sources and flags, so an edited
source rebuilds); ``nvcc``'s register and spill report lands beside the
library as ``<library>.log``.  Nothing here runs at import time: the CPU tests import
every module of the port on machines without ``nvcc`` or a card.

``LAUNCHES`` counts, per kernel entry point, the launches made through the
wrappers; a run sets the counts to 0 with :func:`reset_launches` and reads
them afterwards to show which kernels its path went through.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pysteps_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the H100's shared memory a block may opt into (227 KB) and its SMs; the
# tile geometries are worked out against them on any machine, and a launch
# asks the card for its own SM count (:func:`sm_count`)
SMEM_LIMIT = 232_448
H100_SMS = 132

LAUNCHES = dict.fromkeys(
    (
        "resample_axis0", "resample_axis1", "warp", "pwl_gather",
        "rim_from_field", "rim_from_mask", "chain_match_vert_rim",
        "chain_horiz", "pwl_hier", "pwl_flat", "cdf_counts",
    ),
    0,
)

_vp, _ll, _i, _f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_pll, _pi = ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # field, idx0, frac, out, batch, rep, m, n, D, axis, stream
    "pst_resample": (_vp, _vp, _vp, _vp, _ll, _i, _i, _i, _i, _i, _vp),
    # field, dy, disp_t, scratch (th 0 only), out, batch, m, n, D, cval,
    # masked, th (0: the two-pass kernels), tw, cols, smem bytes, stream
    "pst_warp": (_vp, _vp, _vp, _vp, _vp, _ll, _i, _i, _i, _f, _i, _i, _i, _i, _ll, _vp),
    # smem bytes -> blocks per SM
    "pst_warp_info": (_ll, _pi),
    # x, e8, T, scal, out, batch, N, stream
    "pst_pwl_gather": (_vp, _vp, _vp, _vp, _vp, _ll, _ll, _vp),
    # x, is_bytes, thr, strict, scratch (kr + r > 254 only), out, batch, m,
    # n, kr, r, stream
    "pst_rim": (_vp, _i, _f, _i, _vp, _vp, _ll, _i, _i, _i, _i, _vp),
    # batch, m, n, kr, r -> H, W, smem bytes, blocks, blocks per SM
    "pst_rim_info": (_ll, _i, _i, _i, _i, _pi, _pi, _pll, _pll, _pi),
    # field, e8, T, scal, dy, C, mask, batch, m, n, D, kr, r, thr, do_rim, stream
    "pst_chain_v": (_vp,) * 7 + (_ll, _i, _i, _i, _i, _i, _f, _i, _vp),
    # the same, then the device word that receives the matches, stream
    "pst_chain_v_count": (_vp,) * 7 + (_ll, _i, _i, _i, _i, _i, _f, _i, _vp, _vp),
    # m, n, D, kr, r, do_rim -> smem bytes, ring rows, blocks per SM, matches
    "pst_chain_v_info": (_i,) * 6 + (_pll, _pi, _pi, _pll),
    # C, disp_t, out, batch, m, n, D, cval, stream
    "pst_chain_h": (_vp, _vp, _vp, _ll, _i, _i, _i, _f, _vp),
    # x, e16, M3, scal, out, batch, N, stream
    "pst_pwl_hier": (_vp, _vp, _vp, _vp, _vp, _ll, _ll, _vp),
    # x, edges, w, q0, out, batch, N, stream
    "pst_pwl_flat": (_vp, _vp, _vp, _vp, _vp, _ll, _ll, _vp),
    # x, edges, work (int32 (batch, 129), zeroed by the entry point), out
    # (f32), batch, N, stream
    "pst_cdf_counts": (_vp, _vp, _vp, _vp, _ll, _ll, _vp),
}

_lib = None
_lock = threading.Lock()
_sm_count = {}


def sm_count(device):
    """The SMs of CUDA ``device``."""
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_count[device]


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "pysteps_tpu_torch are compiled at first use"
        )
    return found


def build():
    """Compile every ``csrc/*.cu`` (one ``nvcc`` process per source, all
    started together), link them into one shared library and return its
    path.  Returns at once when the library for these sources exists."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"libpst_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        outs = [proc.communicate()[0] for proc in procs]  # wait for all
        for src, proc, out in zip(sources, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-gencode",
             "arch=compute_90a,code=sm_90a", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        lib_path.with_suffix(".log").write_text(
            "\n".join(f"== {src.name}\n{out}" for src, out in zip(sources, outs))
        )
        os.replace(tmp_lib, lib_path)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check_inputs(name, tensors, dtypes):
    """Raise unless every tensor is a contiguous CUDA tensor of its dtype
    on one device (the kernels take raw pointers)."""
    device = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: all inputs must be on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def launch(name, device, *args):
    """Call C entry point ``name`` on ``device``'s current stream; raise if
    the launch was refused."""
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
