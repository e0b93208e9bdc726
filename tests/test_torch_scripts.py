"""The port's ``scripts``: the motion-perturbation analysis and its fit on
a 64^2 synthetic archive with ``device="cpu"``, against the JAX package's
on the same archive, and both scripts' ``main(argv)`` on a temporary rc
file.

The optical flow is DARTS, which ``tests/test_torch_motion.py`` holds
within 1e-3 px of JAX's (``PX_TOL``; about 1e-6 px on this archive) at a
small part of Lucas-Kanade's CPU time.  The moment sums are held
within what that bound allows: each projected difference moves by at most
2 x 1e-3 px x ``vsf`` a pixel.
"""

import datetime
import pickle

import numpy as np
import pytest

import pysteps_tpu
from pysteps_tpu import config as jconfig
from pysteps_tpu.scripts import fit_vel_pert_params as jfit
from pysteps_tpu.scripts import run_vel_pert_analysis as jrun
from pysteps_tpu_torch import config, datasets
from pysteps_tpu_torch.scripts import fit_vel_pert_params as tfit
from pysteps_tpu_torch.scripts import run_vel_pert_analysis as trun

PX_TOL = 1e-3
START = datetime.datetime(2026, 8, 17, 12, 0)
N_FRAMES = 16


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    root = tmp_path_factory.mktemp("archive")
    _, meta = datasets.create_synthetic_dataset(
        str(root), n_frames=N_FRAMES, shape=(64, 64), velocity=(2.0, 1.0), seed=4,
        start_time=START.strftime("%Y%m%d%H%M"))
    source = {"root_path": str(root), "path_fmt": "synthetic",
              "fn_pattern": "synthetic_%Y%m%d%H%M", "fn_ext": "npz", "importer": "npz",
              "timestep": 5, "importer_kwargs": {}}
    return root, source, meta


@pytest.fixture(scope="module")
def analyses(archive):
    _, source, _ = archive
    end = START + datetime.timedelta(minutes=5 * (N_FRAMES - 1))
    kw = dict(num_prev_files=5)  # DARTS' 5 time steps
    port = trun.run_analysis(START, end, source, "darts", 30, device="cpu", **kw)
    ref = jrun.run_analysis(START, end, source, "darts", 30, **kw)
    return port, ref


def _vsf(meta):
    return 60.0 / 5 * meta["xpixelsize"] / 1000.0


def test_run_analysis_against_jax(archive, analyses):
    _, _, meta = archive
    port, ref = analyses
    assert sorted(port) == sorted(ref) == [5.0, 10.0, 15.0, 20.0, 25.0, 30.0]
    step = 2 * PX_TOL * _vsf(meta)
    for lt in ref:
        p, r = port[lt], ref[lt]
        n = r["n_samples"]
        assert p["n_samples"] == n and n > 0
        for key in ("dp_par_sum", "dp_perp_sum"):
            assert abs(p[key] - r[key]) <= step * n, (lt, key)
        for key, lin in (("dp_par_sq_sum", "dp_par_sum"), ("dp_perp_sq_sum", "dp_perp_sum")):
            # |a^2 - b^2| <= (2|b| + step) step, summed over the samples
            bound = step * (2 * np.sqrt(r[key] * n) + step * n)
            assert abs(p[key] - r[key]) <= bound, (lt, key)


def test_fit_parameters_against_jax(analyses):
    port, ref = analyses
    lt, sp, sq = tfit.compute_stds(port)
    jlt, jsp, jsq = jfit.compute_stds(ref)
    np.testing.assert_array_equal(lt, jlt)
    np.testing.assert_allclose(sp, jsp, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(sq, jsq, rtol=1e-3, atol=1e-3)
    p_par, p_perp = tfit.fit_parameters(port)
    j_par, j_perp = jfit.fit_parameters(ref)
    assert p_par is not None and j_par is not None
    assert np.isfinite(p_par).all() and np.isfinite(p_perp).all()
    # the fitted curves, not their parameters (a flat optimum trades a, b, c)
    for a, b, std in ((p_par, j_par, jsp), (p_perp, j_perp, jsq)):
        np.testing.assert_allclose(tfit.growth_curve(lt, *a), jfit.growth_curve(lt, *b),
                                   rtol=1e-2, atol=1e-2 * std.max())
    # the same results through both fits give the same parameters
    for a, b in zip(tfit.fit_parameters(ref), jfit.fit_parameters(ref)):
        np.testing.assert_array_equal(a, b)


def test_accumulate_pair_matches_jax():
    rng = np.random.RandomState(0)
    v1 = rng.randn(2, 16, 16)
    v2 = v1 + 0.3 * rng.randn(2, 16, 16)
    v1[0, 0, 0] = np.nan
    for mask in (False, True):
        assert (trun.accumulate_pair({}, v1, v2, 5.0, use_precip_mask=mask)
                == jrun.accumulate_pair({}, v1, v2, 5.0, use_precip_mask=mask))


def test_main_against_jax(archive, tmp_path, monkeypatch):
    """Both scripts' command lines on an rc file whose "synthetic" source is
    the archive: the same lead times and samples, and a fit plot."""
    root, _, _ = archive
    rc = datasets.create_default_pystepsrc(str(root), config_dir=str(tmp_path))
    monkeypatch.setattr(config, "rcparams", config.load_config_file(rc, dryrun=True))
    monkeypatch.setattr(pysteps_tpu, "rcparams", jconfig.load_config_file(rc, dryrun=True))
    end = START + datetime.timedelta(minutes=5 * (N_FRAMES - 1))
    args = [START.strftime("%Y%m%d%H%M"), end.strftime("%Y%m%d%H%M"), "synthetic", "darts", "20"]
    trun.main(args + [str(tmp_path / "port.pkl"), "--device", "cpu"])
    jrun.main(args + [str(tmp_path / "jax.pkl")])
    with open(tmp_path / "port.pkl", "rb") as f:
        port = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    assert sorted(port) == sorted(ref) and len(ref) > 0
    assert [port[k]["n_samples"] for k in sorted(port)] == [
        ref[k]["n_samples"] for k in sorted(ref)]
    # the accumulated file goes on from the first
    trun.main(args + [str(tmp_path / "twice.pkl"), "--device", "cpu",
                      "--accum", str(tmp_path / "port.pkl")])
    with open(tmp_path / "twice.pkl", "rb") as f:
        twice = pickle.load(f)
    assert all(twice[k]["n_samples"] == 2 * port[k]["n_samples"] for k in port)

    tfit.main([str(tmp_path / "twice.pkl"), "--plot", str(tmp_path / "fit.png")])
    assert (tmp_path / "fit.png").stat().st_size > 0
