"""The slice as a whole: the operational cycle around the nowcast, run
through each package's public entry points at 64^2 -- a synthetic radar
archive on disk, ``io.archive.find_by_date`` and ``io.readers.read_timeseries``
with the NPZ importer, the dB transform, a deterministic STEPS forecast of 3
leads whose callback writes each lead into the CF NetCDF exporter
(``incremental="timestep"``), the forecast read back with
``import_netcdf_pysteps`` and drawn with ``plot_precip_field`` and
``motion_plot``.

The JAX package runs on the CPU, the port with ``device="cpu"``.  The two
re-imported forecasts agree within 1e-3 x span with equal NaN positions,
the tolerance of ``tests/test_torch_steps.py::test_deterministic_forecast``;
each file holds, bit for bit, what its callback was handed, and the two
files carry equal attributes.
"""

import datetime
import hashlib
import importlib

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

SIDE = 64
LEADS = 3
START = datetime.datetime(2026, 8, 17, 12, 0)
STEPS_KW = dict(n_ens_members=2, n_cascade_levels=6, precip_thr=-10.0, kmperpixel=1.0,
                timestep=5, noise_method=None, vel_pert_method=None,
                mask_method="incremental", probmatching_method="cdf", domain="spectral",
                seed=42)


def _modules(pkg):
    return {name: importlib.import_module(f"{pkg}.{name}") for name in (
        "io", "datasets", "nowcasts", "utils.transformation", "visualization")}


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """One archive for both packages, written by the port's ``datasets``
    (``tests/test_torch_datasets_decorators.py`` holds it equal to JAX's)."""
    from pysteps_tpu_torch import datasets

    root = tmp_path_factory.mktemp("archive")
    datasets.create_synthetic_dataset(
        str(root), n_frames=6, shape=(SIDE, SIDE), velocity=(1.7, 0.6), seed=42,
        start_time=START.strftime("%Y%m%d%H%M"))
    return root


def _cycle(pkg, root, outdir, **device):
    m = _modules(pkg)
    io = m["io"]
    when = START + datetime.timedelta(minutes=25)
    fns = io.archive.find_by_date(when, str(root), "synthetic", "synthetic_%Y%m%d%H%M",
                                  "npz", 5, num_prev_files=2)
    precip, _, meta = io.readers.read_timeseries(fns, io.get_method("npz", "importer"))
    assert precip.shape == (3, SIDE, SIDE) and isinstance(precip, np.ndarray)
    db, db_meta = m["utils.transformation"].dB_transform(precip, meta, threshold=0.1,
                                                        zerovalue=-15.0, **device)
    velocity = np.zeros((2, SIDE, SIDE), np.float32)
    velocity[0], velocity[1] = 1.7, 0.6

    exporter = io.get_method("netcdf", "exporter")(
        str(outdir), "forecast", when, 5, LEADS, (SIDE, SIDE), db_meta | {"unit": "dBZ"},
        n_ens_members=STEPS_KW["n_ens_members"], incremental="timestep", complevel=1)
    sums = []

    def callback(frames):
        sums.append(hashlib.sha256(np.ascontiguousarray(frames, np.float32)).hexdigest())
        io.export_forecast_dataset(frames, exporter)

    m["nowcasts"].get_method("steps")(db, velocity, LEADS, callback=callback,
                                      return_output=False, **STEPS_KW, **device)
    io.close_forecast_files(exporter)
    path = str(outdir / "forecast.nc")
    fc, fc_meta = io.nowcast_importers.import_netcdf_pysteps(path, onerror="raise")

    vis = m["visualization"]
    pngs = []
    for name, draw in (("precip", lambda ax: vis.plot_precip_field(
            fc[0, -1], ptype="intensity", units="dBZ", geodata=fc_meta, ax=ax)),
            ("motion", lambda ax: vis.motion_plot(velocity, geodata=fc_meta, ax=ax, step=8))):
        fig, ax = plt.subplots()
        draw(ax)
        pngs.append(outdir / f"{name}.png")
        fig.savefig(pngs[-1], dpi=40)
        plt.close(fig)
    return dict(fc=fc, meta=fc_meta, geodata=meta, sums=sums, path=path, pngs=pngs)


@pytest.fixture(scope="module")
def cycles(archive, tmp_path_factory):
    return {
        "port": _cycle("pysteps_tpu_torch", archive, tmp_path_factory.mktemp("port"),
                       device="cpu"),
        "jax": _cycle("pysteps_tpu", archive, tmp_path_factory.mktemp("jax")),
    }


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_file_holds_what_the_callback_wrote(cycles, pkg):
    c = cycles[pkg]
    fc = c["fc"]
    assert fc.shape == (STEPS_KW["n_ens_members"], LEADS, SIDE, SIDE)
    assert len(c["sums"]) == LEADS
    for t in range(LEADS):
        lead = np.ascontiguousarray(fc[:, t], np.float32)
        assert hashlib.sha256(lead).hexdigest() == c["sums"][t], t
    assert np.isfinite(fc).mean() > 0.5
    for png in c["pngs"]:
        assert png.stat().st_size > 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_metadata_round_trips_the_geodata(cycles, pkg):
    c = cycles[pkg]
    geo, meta = c["geodata"], c["meta"]
    for key in ("x1", "x2", "y1", "y2", "xpixelsize", "ypixelsize", "yorigin",
                "cartesian_unit"):
        assert meta[key] == geo[key], key
    assert meta["unit"] == "dBZ" and meta["transform"] == "dB"
    np.testing.assert_array_equal(meta["leadtimes"], [5.0, 10.0, 15.0])


def test_port_cycle_against_jax(cycles):
    ref, out = cycles["jax"]["fc"], cycles["port"]["fc"]
    assert np.array_equal(np.isnan(ref), np.isnan(out))
    span = float(np.nanmax(ref) - np.nanmin(ref))
    err = float(np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(out))))
    assert err <= 1e-3 * span, (err, span)
    np.testing.assert_equal({k: v for k, v in cycles["port"]["meta"].items()
                             if k not in ("zerovalue", "threshold")},
                            {k: v for k, v in cycles["jax"]["meta"].items()
                             if k not in ("zerovalue", "threshold")})


def test_files_carry_equal_attributes(cycles):
    from test_torch_io import _assert_same_attrs

    _assert_same_attrs(cycles["port"]["path"], cycles["jax"]["path"])
