"""The PyTorch port stands alone: no module of it (nor ``chip_smoke.py``)
imports JAX, optax or the JAX package, a forecast runs without loading JAX, and
the entry points default to CUDA and raise where it is absent."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# chip_smoke.py, the checks it shares with the card tests and the module
# the spawned ranks of the parallel tests import
PACKAGE_FILES = sorted((ROOT / "pysteps_tpu_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "torch_blending_checks.py",
    ROOT / "tests" / "torch_parallel_workers.py"]


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "pysteps_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def _edits_sys_path(tree):
    """Whether the module calls a method of ``sys.path`` or assigns to it
    (or to a slice of it)."""
    def is_sys_path(node):
        return (isinstance(node, ast.Attribute) and node.attr == "path"
                and isinstance(node.value, ast.Name) and node.value.id == "sys")

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and is_sys_path(node.func.value)):
            return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if is_sys_path(t) or (isinstance(t, ast.Subscript) and is_sys_path(t.value)):
                    return True
    return False


@pytest.mark.parametrize("path", PACKAGE_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_package_does_not_touch_sys_path(path):
    """No module of the package inserts into ``sys.path`` (the JAX
    package's ``datasets`` reaches into the test tree so; the port keeps its
    own generator)."""
    assert not _edits_sys_path(ast.parse(path.read_text(), filename=str(path)))


def test_sys_path_check_sees_edits():
    for code in ("import sys\nsys.path.insert(0, 'x')", "import sys\nsys.path[:0] = ['x']",
                 "import sys\nsys.path.append('x')", "import sys\nsys.path += ['x']"):
        assert _edits_sys_path(ast.parse(code)), code
    assert not _edits_sys_path(ast.parse("import os\nos.path.join('a', 'b')"))


def test_forbidden_names_tell_the_prefix_apart():
    assert _forbidden("pysteps_tpu.ops.warp") and _forbidden("jax.numpy")
    assert _forbidden("optax")
    assert not _forbidden("pysteps_tpu_torch.ops.warp")


def test_forecast_runs_without_loading_jax():
    code = """
import sys
import numpy as np
from pysteps_tpu_torch import nowcasts
rng = np.random.default_rng(0)
precip = np.where(rng.random((3, 32, 32)) > 0.5, 20.0 * rng.random((3, 32, 32)), -15.0)
velocity = np.ones((2, 32, 32), np.float32)
out = nowcasts.get_method("steps")(
    precip.astype(np.float32), velocity, 2, n_ens_members=2, n_cascade_levels=4,
    precip_thr=-10.0, kmperpixel=1.0, timestep=5, domain="spectral", seed=1,
    device="cpu",
)
assert tuple(out.shape) == (2, 2, 32, 32), out.shape
# the forecast through the exporter and back, the plots and the scripts
import datetime, tempfile
import pysteps_tpu_torch
from pysteps_tpu_torch import io
from pysteps_tpu_torch.scripts import fit_vel_pert_params, run_vel_pert_analysis
d = tempfile.mkdtemp()
meta = {"unit": "dBZ", "x1": 0.0, "x2": 32.0, "y1": 0.0, "y2": 32.0, "yorigin": "upper"}
exp = io.get_method("netcdf", "exporter")(d, "fc", datetime.datetime(2026, 8, 17), 5, 2,
                                          (32, 32), meta, n_ens_members=2)
io.export_forecast_dataset(out, exp)
io.close_forecast_files(exp)
back, _ = io.nowcast_importers.import_netcdf_pysteps(d + "/fc.nc", onerror="raise")
assert np.array_equal(back, out.numpy(), equal_nan=True)
import matplotlib
matplotlib.use("Agg")
from pysteps_tpu_torch import visualization
visualization.plot_precip_field(out[0, -1], units="dBZ")
assert "jax" not in sys.modules and "pysteps_tpu" not in sys.modules
print("ok")
"""
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_default_device_is_cuda(monkeypatch):
    from pysteps_tpu_torch import nowcasts
    from pysteps_tpu_torch._device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    precip = np.zeros((3, 16, 16), np.float32)
    velocity = np.zeros((2, 16, 16), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        nowcasts.get_method("steps")(precip, velocity, 2, precip_thr=-10.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None, precip)
    assert resolve_device(None, torch.zeros(1)).type == "cpu"
    assert resolve_device("cpu").type == "cpu"



def _numpy_entry_points():
    """(name, call) of the entry points that take numpy input; ``call``
    takes the ``device`` keyword and returns the entry point's first
    output tensor."""
    from pysteps_tpu_torch.cascade import bandpass_filters, decomposition
    from pysteps_tpu_torch.noise import fftgenerators, motion
    from pysteps_tpu_torch.timeseries import autoregression as ar
    from pysteps_tpu_torch.utils import conversion, spectral, transformation

    rng = np.random.default_rng(3)
    R = np.maximum(rng.gamma(0.8, 3.0, (32, 32)) - 1.0, 0.0).astype(np.float32)
    meta = {"unit": "mm/h", "transform": None, "threshold": 0.1, "zerovalue": 0.0,
            "accutime": 5.0}
    series = rng.normal(size=(4, 8, 8)).astype(np.float32)
    phi = np.array([[0.5, 0.2, 0.3]], np.float32)
    return [
        ("dB_transform", lambda device: transformation.dB_transform(R, device=device)[0]),
        ("boxcox_transform",
         lambda device: transformation.boxcox_transform(R, device=device)[0]),
        ("sqrt_transform", lambda device: transformation.sqrt_transform(R, device=device)[0]),
        ("NQ_transform", lambda device: transformation.NQ_transform(R, device=device)[0]),
        ("to_rainrate", lambda device: conversion.to_rainrate(R, meta, device=device)[0]),
        ("to_raindepth", lambda device: conversion.to_raindepth(R, meta, device=device)[0]),
        ("to_reflectivity",
         lambda device: conversion.to_reflectivity(R, meta, device=device)[0]),
        ("remove_rain_norain_discontinuity",
         lambda device: spectral.remove_rain_norain_discontinuity(R, device=device)),
        ("decomposition_fft", lambda device: decomposition.decomposition_fft(
            R, bandpass_filters.filter_gaussian(R.shape, 4), device=device)["cascade_levels"]),
        ("estimate_ar_params_yw",
         lambda device: ar.estimate_ar_params_yw([0.9, 0.7], device=device)),
        ("estimate_ar_params_ols", lambda device: ar.estimate_ar_params_ols(
            series, 1, check_stationarity=False, device=device)),
        ("iterate_ar_model",
         lambda device: ar.iterate_ar_model(series[None, -2:], phi, device=device)),
        ("initialize_nonparam_2d_fft_filter", lambda device:
         fftgenerators.initialize_nonparam_2d_fft_filter(R, device=device)["field"]),
        ("initialize_bps", lambda device: motion.initialize_bps(
            series[:2], 1.0, 5, seed=1, device=device)["V_par"]),
    ] + (_numpy_nowcast_entry_points() + _numpy_motion_entry_points()
         + _numpy_linda_feature_and_score_entry_points() + _numpy_blending_entry_points()
         + _numpy_downscaling_and_dimension_entry_points())


def _numpy_downscaling_and_dimension_entry_points():
    """RainFARM and the dimension utilities on 16^2 numpy inputs."""
    from pysteps_tpu_torch.downscaling import rainfarm
    from pysteps_tpu_torch.utils import dimension

    rng = np.random.default_rng(8)
    rain = np.maximum(rng.gamma(0.8, 3.0, (16, 16)) - 1.0, 0.0)
    stack = rain[None].repeat(2, 0).astype(np.float32)
    meta = {"unit": "mm/h", "xpixelsize": 1.0, "ypixelsize": 1.0, "x1": 0.0, "x2": 16.0,
            "y1": 0.0, "y2": 16.0}
    return [
        ("rainfarm.downscale", lambda device: rainfarm.downscale(rain, 2, seed=1,
                                                                 device=device)),
        ("rainfarm.downscale_ensemble", lambda device: rainfarm.downscale_ensemble(
            rain, 2, 2, seed=1, device=device)),
        ("aggregate_fields", lambda device: dimension.aggregate_fields(
            stack, 2, axis=1, device=device)),
        ("aggregate_fields_space", lambda device: dimension.aggregate_fields_space(
            stack, meta, 2.0, device=device)[0]),
        ("clip_domain", lambda device: dimension.clip_domain(
            stack, meta, (2.0, 9.0, 3.0, 12.0), device=device)[0]),
        ("square_domain", lambda device: dimension.square_domain(
            stack[:, :12], meta, device=device)[0]),
    ]


def _numpy_nowcast_entry_points():
    """The extrapolation and nowcast entry points on 32^2 numpy inputs."""
    from pysteps_tpu_torch import nowcasts
    from pysteps_tpu_torch.extrapolation import interface as extrap, semilagrangian
    from pysteps_tpu_torch.nowcasts import utils as nowcast_utils

    rng = np.random.default_rng(4)
    rain = np.maximum(rng.gamma(0.8, 3.0, (4, 32, 32)) - 1.0, 0.0).astype(np.float32)
    db = np.where(rain >= 0.1, 10.0 * np.log10(np.maximum(rain, 0.1)), -15.0)
    vel = np.full((2, 32, 32), 0.7, np.float32)
    meta = {"accutime": 5, "threshold": -10.0, "xpixelsize": 1000.0}

    def main_loop(device):
        out = nowcast_utils.nowcast_main_loop(
            rain[-1], vel, rain[-1], 2, "semilagrangian", lambda s, p: (s, s),
            device=device)
        return torch.as_tensor(out)  # host numpy frames, as in the JAX package

    return [
        ("extrapolate", lambda device: semilagrangian.extrapolate(
            db[-1], vel, 2, device=device)),
        ("eulerian_persistence", lambda device: extrap.eulerian_persistence(
            db[-1], vel, 2, device=device)),
        ("nowcast_main_loop", main_loop),
        ("extrapolation.forecast", lambda device: nowcasts.get_method("extrapolation")(
            db[-1], vel, 2, device=device)),
        ("lagrangian_probability.forecast", lambda device: nowcasts.get_method(
            "lagrangian_probability")(rain[-1], vel, 2, 1.0, device=device)),
        ("sprog.forecast", lambda device: nowcasts.get_method("sprog")(
            db[-3:], vel, 2, n_cascade_levels=4, precip_thr=-10.0, device=device)),
        ("anvil.forecast", lambda device: nowcasts.get_method("anvil")(
            rain, vel, 2, n_cascade_levels=4, device=device)),
        ("sseps.forecast", lambda device: nowcasts.get_method("sseps")(
            db[-3:], meta, vel, 2, n_ens_members=2, n_cascade_levels=4, win_size=16,
            noise_kwargs={"win_size": 16}, device=device)),
    ]


def _numpy_motion_entry_points():
    """The motion, feature, tracking and post-processing entry points on
    32^2 numpy inputs; those that return host arrays are wrapped so that
    the CPU call gives a tensor (the card call raises before)."""
    from pysteps_tpu_torch import motion
    from pysteps_tpu_torch.feature import shitomasi
    from pysteps_tpu_torch.postprocessing import ensemblestats, probmatching
    from pysteps_tpu_torch.tracking import lucaskanade
    from pysteps_tpu_torch.utils import images, interpolate

    rng = np.random.default_rng(5)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    frames = np.stack([
        20.0 * np.exp(-((xx - 12 - 1.5 * t) ** 2 + (yy - 14 - t) ** 2) / 40.0)
        + rng.normal(0, 0.5, (32, 32)) for t in range(6)]).astype(np.float32)
    ens = np.maximum(rng.gamma(0.8, 3.0, (4, 32, 32)) - 1.0, 0.0).astype(np.float32)
    pts = np.array([[10.0, 12.0], [20.5, 15.0], [14.0, 22.0]], np.float32)
    grid = np.arange(32, dtype=np.float32)
    small = {"proesmans": {"num_iter": 5, "verbose": False},
             "vet": {"sectors": (4, 2), "verbose": False}, "darts": {"verbose": False},
             "lk": {"fd_kwargs": {"max_corners": 20}, "lk_kwargs": {"winsize": (10, 10)}},
             "constant": {"max_shift": 4}}
    entries = [
        (f"motion.get_method({name!r})",
         lambda device, name=name: motion.get_method(name)(
             frames[:2] if name in ("proesmans", "vet", None) else frames,
             device=device, **small.get(name, {})))
        for name in ("lk", "constant", "darts", "proesmans", "farneback", "vet", None)
    ]
    return entries + [
        ("shitomasi.detection", lambda device: torch.as_tensor(
            shitomasi.detection(frames[0], device=device))),
        ("shitomasi.detection_batch", lambda device: torch.as_tensor(
            shitomasi.detection_batch(frames[:2], device=device)[0])),
        ("lucaskanade.track_features", lambda device: torch.as_tensor(
            lucaskanade.track_features(frames[0], frames[1], pts, winsize=(10, 10),
                                       device=device)[1])),
        ("lucaskanade.track_features_batch", lambda device: torch.as_tensor(
            lucaskanade.track_features_batch(frames[:1], frames[1:2], [pts], winsize=(10, 10),
                                             device=device)[0][1])),
        ("idwinterp2d", lambda device: interpolate.idwinterp2d(
            pts, pts[:, 0], grid, grid, device=device)),
        ("rbfinterp2d", lambda device: interpolate.rbfinterp2d(
            pts, pts[:, 0], grid, grid, device=device)),
        ("morph_opening", lambda device: images.morph_opening(frames[0], 1.0, 3,
                                                              device=device)),
        ("morph_opening_batch", lambda device: images.morph_opening_batch(
            frames[:2], [1.0, 1.0], 3, device=device)),
        ("ensemblestats.mean", lambda device: ensemblestats.mean(ens, device=device)),
        ("ensemblestats.excprob",
         lambda device: ensemblestats.excprob(ens, 1.0, device=device)),
        ("ensemblestats.banddepth",
         lambda device: ensemblestats.banddepth(ens, device=device)),
        ("nonparam_match_empirical_cdf", lambda device:
         probmatching.nonparam_match_empirical_cdf(ens[0], ens[1], device=device)),
        ("compute_empirical_cdf", lambda device: probmatching.compute_empirical_cdf(
            grid[:9], grid[:8], device=device)),
        ("pmm_init", lambda device: probmatching.pmm_init(
            grid, grid / 31, grid, grid / 31, device=device)["cdf_1"]),
        ("shift_scale", lambda device: probmatching.shift_scale(
            ens[0], "mm/h", 0.3, 4.0, device=device)[2]),
        ("resample_distributions", lambda device: probmatching.resample_distributions(
            ens[0], ens[1], 0.5, device=device)),
    ]


def _numpy_linda_feature_and_score_entry_points():
    """LINDA, the blob detector and the scores on 32^2
    numpy inputs; host results are wrapped as tensors (the card call
    raises before)."""
    from pysteps_tpu_torch import nowcasts, verification
    from pysteps_tpu_torch.feature import blob
    from pysteps_tpu_torch.verification import ensscores, probscores, spatialscores

    rng = np.random.default_rng(6)
    yy, xx = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    rain = np.stack([
        8.0 * np.exp(-((xx - 12 - t) ** 2 + (yy - 14 - 0.5 * t) ** 2) / 30.0)
        for t in range(3)]).astype(np.float32)
    vel = np.zeros((2, 32, 32), np.float32)
    vel[0], vel[1] = 1.0, 0.5
    ens = np.maximum(rng.gamma(0.8, 3.0, (4, 32, 32)) - 1.0, 0.0).astype(np.float32)
    obs = ens[0] * 0.8 + 0.1

    def score(f):
        return lambda device: torch.as_tensor(np.asarray(f(device), np.float64))

    return [
        ("linda.forecast", lambda device: nowcasts.get_method("linda")(
            rain, vel, 2, feature_method="domain", add_perturbations=False, device=device)),
        ("blob.detection", lambda device: torch.as_tensor(blob.detection(rain[-1],
                                                                         device=device))),
        ("det_cat_fct", score(lambda device: verification.get_method("csi")(
            ens[1], obs, thr=1.0, device=device))),
        ("det_cont_fct", score(lambda device: verification.get_method("rmse")(
            ens[1], obs, device=device))),
        ("CRPS", score(lambda device: probscores.CRPS(ens, obs, device=device))),
        ("reldiag", score(lambda device: probscores.reldiag(
            np.mean(ens > 1.0, axis=0), obs, 1.0, min_count=1, device=device)[0])),
        ("ROC_curve", score(lambda device: probscores.ROC_curve(
            np.mean(ens > 1.0, axis=0), obs, 1.0, device=device)[0])),
        ("rankhist", score(lambda device: ensscores.rankhist(ens, obs, device=device))),
        ("ensemble_skill", score(lambda device: ensscores.ensemble_skill(
            ens, obs, "rmse", device=device))),
        ("fss", score(lambda device: spatialscores.fss(ens[1], obs, 1.0, 4, device=device))),
        ("binary_mse", score(lambda device: spatialscores.binary_mse(
            ens[1], obs, 1.0, device=device)[0])),
    ]


def _numpy_blending_entry_points():
    """The blending registry's methods, PCA and the blending helpers on
    32^2 numpy inputs; host results are wrapped as tensors (the card call
    raises before)."""
    from pysteps_tpu_torch import blending
    from pysteps_tpu_torch.blending import skill_scores, steps
    from pysteps_tpu_torch.blending import utils as butils
    from pysteps_tpu_torch.utils import pca

    rng = np.random.default_rng(7)
    rain = np.maximum(rng.gamma(0.8, 3.0, (3, 32, 32)) - 1.0, 0.0).astype(np.float32)
    db = np.where(rain >= 0.1, 10.0 * np.log10(np.maximum(rain, 0.1)), -15.0).astype(np.float32)
    vel = np.full((2, 32, 32), 0.7, np.float32)
    nwp = (db[-1] + rng.normal(0, 0.5, (3, 32, 32))).astype(np.float32)
    meta = {"transform": "dB", "unit": "mm/h", "threshold": -10.0, "zerovalue": -15.0}
    skill = {"outdir_path_skill": str(ROOT / "build" / "skill_unused")}
    return [
        ("blending.steps", lambda device: blending.get_method("steps")(
            db, nwp[None], vel, vel[None], 2, 5, n_ens_members=2, n_cascade_levels=4,
            precip_thr=-10.0, kmperpixel=1.0, device=device, **skill)),
        ("blending.linear_blending", lambda device: blending.get_method("linear_blending")(
            db[-1], meta, vel, 2, 5, "extrapolation", precip_nwp=10 ** (nwp[:2] / 10),
            start_blending=0, end_blending=15, device=device)),
        ("blending.salient_blending", lambda device: blending.get_method("salient_blending")(
            db[-1], meta, vel, 2, 5, "extrapolation", precip_nwp=10 ** (nwp[:2] / 10),
            start_blending=0, end_blending=15, device=device)),
        ("blending.pca_enkf", lambda device: blending.get_method("pca_enkf")(
            db[-2:], None, np.stack([nwp, nwp + 0.1]), None, vel, 2, n_ens_members=2,
            n_cascade_levels=4, device=device)),
        ("spatial_correlation", lambda device: torch.as_tensor(
            skill_scores.spatial_correlation(db, nwp, np.zeros((32, 32), bool),
                                             device=device))),
        ("blend_means_sigmas", lambda device: steps.blend_means_sigmas(
            [[1.0], [2.0]], [[1.0], [1.5]], [[0.5], [0.5], [0.1]], device=device)[0]),
        ("pca_transform", lambda device: pca.pca_transform(
            db.reshape(3, -1), device=device)),
        ("decompose_NWP", lambda device: torch.as_tensor(butils.decompose_NWP(
            nwp, "m", num_cascade_levels=4, device=device)["means"])),
        ("compute_smooth_dilated_mask", lambda device: butils.compute_smooth_dilated_mask(
            db[-1] > 0, 4, device=device)),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _numpy_entry_points()])
def test_numpy_input_goes_to_cuda_by_default(name, monkeypatch):
    """numpy input runs where the caller says: on the CPU with
    ``device="cpu"``, else on the card, and so raises without CUDA."""
    call = dict(_numpy_entry_points())[name]
    assert call("cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(None)


# modules imported in a fresh process with pandas, matplotlib and h5py
# hidden: the package itself (it imports io and datasets), the modules it
# does not import, and an importer run without h5py
_FRESH_PROCESS = {
    "pysteps_tpu_torch": "import pysteps_tpu_torch as m; m.io.get_method('npz', 'importer')",
    "pysteps_tpu_torch.decorators": "import pysteps_tpu_torch.decorators",
    "pysteps_tpu_torch.scripts.run_vel_pert_analysis":
        "import pysteps_tpu_torch.scripts.run_vel_pert_analysis",
    "pysteps_tpu_torch.scripts.fit_vel_pert_params":
        "import pysteps_tpu_torch.scripts.fit_vel_pert_params",
}


@pytest.mark.parametrize("module", ["pysteps_tpu_torch.feature.tstorm",
                                    "pysteps_tpu_torch.tracking.tdating",
                                    "pysteps_tpu_torch.verification.plots",
                                    "pysteps_tpu_torch.verification.salscores",
                                    *_FRESH_PROCESS])
def test_host_modules_import_without_pandas_and_matplotlib(module, monkeypatch):
    """tstorm, tdating, SAL and the plots import with pandas and
    matplotlib hidden; tstorm's centroids and labels run without them.
    The package, its decorators and scripts import in a fresh process with
    h5py hidden as well, and an importer that needs h5py says so."""
    import importlib

    if module in _FRESH_PROCESS:
        code = """
import sys
for name in ("pandas", "matplotlib", "matplotlib.pyplot", "h5py"):
    sys.modules[name] = None
""" + _FRESH_PROCESS[module] + """
from pysteps_tpu_torch.io import importers
try:
    importers.import_odim_hdf5("missing.h5")
except ImportError as err:
    assert "h5py" in str(err), err
else:
    raise AssertionError("an HDF5 importer ran without h5py")
assert "jax" not in sys.modules and "pandas" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
"""
        res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert res.stdout.strip().endswith("ok")
        return

    for name in ("pandas", "matplotlib", "matplotlib.pyplot"):
        monkeypatch.setitem(sys.modules, name, None)
    for name in ("pysteps_tpu_torch.feature.tstorm", "pysteps_tpu_torch.tracking.tdating",
                 "pysteps_tpu_torch.verification.plots",
                 "pysteps_tpu_torch.verification.salscores"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    mod = importlib.import_module(module)
    tstorm = importlib.import_module("pysteps_tpu_torch.feature.tstorm")
    yy, xx = np.meshgrid(np.arange(48), np.arange(48), indexing="ij")
    field = 50.0 * np.exp(-((xx - 20) ** 2 + (yy - 24) ** 2) / 30.0)
    assert tstorm.detection(field, minsize=5, output_feat=True).tolist() == [[20, 24]]
    assert tstorm._detect(field, minsize=5)[1].max() == 1
    with pytest.raises(ImportError, match="pandas"):
        tstorm.detection(field, minsize=5)
    if module.endswith("plots"):
        with pytest.raises(ImportError):
            mod.plot_rankhist(np.ones(3) / 3)


def test_native_loads_without_jax():
    """The port's native decoders build and load with no JAX in the
    process."""
    code = """
import sys
import numpy as np
from pysteps_tpu_torch import native
assert native.get_lib() is not None
out = native.radolan_decode(np.arange(16, dtype=np.uint16), 4)
assert out.shape == (4, 4) and out.dtype == np.float32
# the io importer that decodes through it
import os, tempfile
from pysteps_tpu_torch.io import importers
path = os.path.join(tempfile.mkdtemp(), "ry.bin")
with open(path, "wb") as f:
    f.write(b"RY201608171200 GP    4x    4" + b"\x03" + np.arange(16, dtype="<u2").tobytes())
precip, _, meta = importers.import_dwd_radolan(path)
assert np.array_equal(precip, out) and meta["institution"] == "DWD"
assert "jax" not in sys.modules and "pysteps_tpu" not in sys.modules
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
