"""The rest of the port's ``utils/`` against the JAX package on the CPU:
``dimension`` value by value (every aggregation method, ``trim``, the
time and space aggregations, ``clip_domain``, ``square_domain`` both
ways), ``get_fft`` against ``jnp.fft``, ``projection.lonlat_grid`` for the
eight projections (1e-6 degrees), ``reprojection`` against JAX's,
``profiling`` on the CPU and ``utils.get_method``'s table.

Aggregations hold JAX's within 1e-6 relative (float32 sums in another
order); everything else is exact or within the tolerance named."""

import datetime as dt
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysteps_tpu.utils import dimension as jdim
from pysteps_tpu.utils import interface as jinterface
from pysteps_tpu.utils import projection as jproj
from pysteps_tpu.utils import reprojection as jreproj
from pysteps_tpu_torch import utils as tutils
from pysteps_tpu_torch.exceptions import MissingOptionalDependency
from pysteps_tpu_torch.utils import dimension, fft, profiling, projection, reprojection


def _field(shape=(4, 12, 18), nan=False, seed=0):
    x = np.random.RandomState(seed).gamma(1.0, 2.0, shape).astype(np.float32)
    if nan:
        x[..., 2, 3] = np.nan
        x[..., 5:7, :] = np.nan
    return x


def _close(port, ref, rtol=1e-6):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=1e-6, equal_nan=True)


METHODS = ["mean", "sum", "nanmean", "nansum", "min", "max", "nanmin", "nanmax"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("trim", [False, True])
def test_aggregate_fields_against_jax(method, trim):
    x = _field(nan=method.startswith("nan"))
    ws, axis = (5, 2) if trim else (3, 1)  # 18 = 3 x 6; 5 leaves 3 columns
    port = dimension.aggregate_fields(x, ws, axis=axis, method=method, trim=trim, device="cpu")
    _close(port, jdim.aggregate_fields(x, ws, axis=axis, method=method, trim=trim))
    if not trim:
        with pytest.raises(ValueError):
            dimension.aggregate_fields(x, 5, axis=2, method=method, device="cpu")


def test_aggregate_fields_all_nan_block_and_several_axes():
    x = _field(nan=True)
    x[:, 6:8, 0:2] = np.nan  # a block with no value: nanmin / nanmax give NaN
    for method in ("nanmin", "nanmax", "nanmean"):
        _close(dimension.aggregate_fields(x, 2, axis=(1, 2), method=method, device="cpu"),
               jdim.aggregate_fields(x, 2, axis=(1, 2), method=method))
    _close(dimension.aggregate_fields(x, [2, 3], axis=[1, 2], method="sum", device="cpu"),
           jdim.aggregate_fields(x, [2, 3], axis=[1, 2], method="sum"))
    with pytest.raises(ValueError):
        dimension.aggregate_fields(x, [2, 3], axis=[1], device="cpu")


def _meta(unit="mm/h"):
    t0 = dt.datetime(2024, 5, 1, 12, 0)
    return {"unit": unit, "accutime": 5, "xpixelsize": 1000.0, "ypixelsize": 1000.0,
            "timestamps": [t0 + dt.timedelta(minutes=5 * i) for i in range(6)],
            "x1": 0.0, "x2": 18000.0, "y1": 0.0, "y2": 12000.0, "yorigin": "upper"}


@pytest.mark.parametrize("unit,ignore_nan", [("mm/h", False), ("mm", False), ("mm/h", True)])
def test_aggregate_fields_time_against_jax(unit, ignore_nan):
    x = _field((6, 12, 18), nan=ignore_nan)
    port, pm = dimension.aggregate_fields_time(x, _meta(unit), 15, ignore_nan, device="cpu")
    ref, rm = jdim.aggregate_fields_time(x, _meta(unit), 15, ignore_nan)
    _close(port, ref)
    assert pm == rm
    same, sm = dimension.aggregate_fields_time(x, _meta(unit), 5, device="cpu")
    _close(same, x)


@pytest.mark.parametrize("ndim", [2, 3, 4])
def test_aggregate_fields_space_against_jax(ndim):
    x = _field((2, 3, 12, 18)[4 - ndim:])
    port, pm = dimension.aggregate_fields_space(x, _meta(), (2000.0, 3000.0), device="cpu")
    ref, rm = jdim.aggregate_fields_space(x, _meta(), (2000.0, 3000.0))
    _close(port, ref)
    assert pm == rm


@pytest.mark.parametrize("yorigin", ["upper", "lower"])
def test_clip_domain_against_jax(yorigin):
    x = _field()
    meta = dict(_meta(), yorigin=yorigin)
    port, pm = dimension.clip_domain(x, meta, (2500.0, 11000.0, 1200.0, 7600.0), device="cpu")
    ref, rm = jdim.clip_domain(x, meta, (2500.0, 11000.0, 1200.0, 7600.0))
    _close(port, ref, rtol=0)
    assert pm == rm


@pytest.mark.parametrize("method", ["pad", "crop"])
@pytest.mark.parametrize("shape", [(3, 12, 18), (3, 18, 12)])
def test_square_domain_against_jax(method, shape):
    x = _field(shape, nan=True)
    port, pm = dimension.square_domain(x, {}, method, device="cpu")
    ref, rm = jdim.square_domain(x, {}, method)
    _close(port, ref, rtol=0)
    assert pm == rm
    if method == "pad":
        back, bm = dimension.square_domain(port, pm, inverse=True)
        _close(back, x, rtol=0)
        assert bm == {}
    else:
        with pytest.raises(ValueError):
            dimension.square_domain(port, pm, inverse=True)


def test_dimension_numpy_goes_to_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dimension.aggregate_fields(_field(), 3, axis=1)
    assert dimension.aggregate_fields(torch.ones(6, 6), 3).device.type == "cpu"


@pytest.mark.parametrize("name", ["fft2", "ifft2", "rfft2", "fftshift", "ifftshift"])
def test_get_fft_against_jnp(name):
    x = _field((2, 12, 18))[0]
    port = getattr(fft.get_fft((12, 18)), name)(torch.as_tensor(x))
    ref = getattr(jnp.fft, name)(x)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


def test_get_fft_irfft2_fftn_and_aliases():
    x = _field((2, 12, 18))[0]
    spec = np.fft.rfft2(x).astype(np.complex64)
    for get in (fft.get_fft, fft.get_numpy, fft.get_scipy, fft.get_pyfftw):
        ns = get((12, 18))
        np.testing.assert_allclose(ns.irfft2(torch.as_tensor(spec)).numpy(),
                                   np.asarray(jnp.fft.irfft2(spec, s=(12, 18))), atol=1e-5)
        assert ns.shape == (12, 18) and not hasattr(ns, "fftn")
        np.testing.assert_array_equal(ns.fftfreq(7), np.fft.fftfreq(7))
    ns = fft.get_fft((12, 18), fftn_shape=(2, 12, 18))
    np.testing.assert_allclose(ns.fftn(torch.as_tensor(x)).numpy(),
                               np.asarray(jnp.fft.fftn(x)), rtol=1e-5, atol=1e-4)


PROJ4 = {
    "longlat": "+proj=longlat +ellps=WGS84",
    "merc": "+proj=merc +lon_0=0 +lat_ts=0 +ellps=WGS84",
    "stere": "+proj=stere +lat_0=90 +lon_0=25 +lat_ts=60 +a=6371288",
    "aea": "+proj=aea +lon_0=144.75 +lat_0=-37.85 +lat_1=-18 +lat_2=-36 +ellps=GRS80",
    "tmerc": "+proj=utm +zone=33 +ellps=WGS84",
    "somerc": "+proj=somerc +lat_0=46.9524055555 +lon_0=7.4395833333 +k_0=1"
              " +x_0=600000 +y_0=200000 +ellps=bessel",
    "aeqd": "+proj=aeqd +lon_0=10 +lat_0=50 +R=6371000",
    "laea": "+proj=laea +lat_0=55 +lon_0=10 +x_0=1950000 +y_0=-2100000 +ellps=WGS84",
}
# a point of each projection's domain: the grid spans 200 km around it
CENTRES = {"longlat": (2.0, 48.0), "merc": (10.0, 50.0), "stere": (19.1, 59.7),
           "aea": (145.0, -37.0), "tmerc": (14.0, 46.0), "somerc": (8.2, 46.8),
           "aeqd": (12.0, 52.0), "laea": (2.0, 48.0)}


@pytest.mark.parametrize("name", list(PROJ4))
def test_lonlat_grid_against_jax(name):
    p = projection.Proj(PROJ4[name])
    x0, y0 = p(*CENTRES[name])
    step = 0.05 if name == "longlat" else 5000.0
    xs = x0 + step * np.arange(-20, 21)
    ys = y0 + step * np.arange(-15, 16)
    lon, lat = projection.lonlat_grid(PROJ4[name], xs, ys)
    jlon, jlat = jproj.lonlat_grid(PROJ4[name], xs, ys)
    np.testing.assert_allclose(lon, jlon, atol=1e-6, rtol=0)
    np.testing.assert_allclose(lat, jlat, atol=1e-6, rtol=0)
    assert projection.parse_proj4(PROJ4[name]) == jproj.parse_proj4(PROJ4[name])


def test_unsupported_projection():
    assert projection.lonlat_grid("+proj=geos +h=35785831", [0.0], [0.0]) is None
    with pytest.raises(MissingOptionalDependency):
        projection.Proj("+proj=geos +h=35785831")


def _grid_meta(proj4, x1, y1, px, shape):
    m, n = shape
    return {"projection": proj4, "x1": x1, "x2": x1 + n * px, "y1": y1,
            "y2": y1 + m * px, "xpixelsize": px, "ypixelsize": px, "yorigin": "upper",
            "unit": "mm/h", "cartesian_unit": "m"}


@pytest.mark.parametrize("cross", [False, True])
def test_reproject_grids_against_jax(cross):
    src_p = PROJ4["laea"]
    sp = projection.Proj(src_p)
    x0, y0 = sp(8.0, 50.0)
    src = _field((2, 40, 48))
    meta_src = _grid_meta(src_p, x0 - 96000, y0 - 80000, 4000.0, (40, 48))
    if cross:
        dst_p = PROJ4["stere"]
        dx, dy = projection.Proj(dst_p)(8.0, 50.0)
        meta_dst = _grid_meta(dst_p, dx - 60000, dy - 50000, 5000.0, (20, 24))
    else:
        meta_dst = _grid_meta(src_p, x0 - 50000, y0 - 40000, 2500.0, (32, 40))
    dst = np.zeros((20, 24) if cross else (32, 40))
    out, meta = reprojection.reproject_grids(torch.as_tensor(src), dst, meta_src, meta_dst)
    ref, rmeta = jreproj.reproject_grids(src, dst, meta_src, meta_dst)
    np.testing.assert_allclose(out, ref, rtol=1e-12, equal_nan=True)
    assert meta == rmeta
    alias, _ = reprojection.reprojection(src, dst, meta_src, meta_dst)
    np.testing.assert_array_equal(alias, out)


def test_unstructured2regular_against_jax():
    rng = np.random.RandomState(2)
    clon = 7.0 + 2.0 * rng.rand(300)
    clat = 49.0 + 2.0 * rng.rand(300)
    src = rng.rand(2, 3, 300).astype(np.float32)
    dst_p = PROJ4["laea"]
    x0, y0 = projection.Proj(dst_p)(8.0, 50.0)
    meta_dst = _grid_meta(dst_p, x0 - 60000, y0 - 60000, 10000.0, (12, 12))
    meta_src = {"clon": clon, "clat": clat, "unit": "mm/h"}
    out, meta = reprojection.unstructured2regular(src, meta_src, meta_dst)
    ref, rmeta = jreproj.unstructured2regular(src, meta_src, meta_dst)
    np.testing.assert_array_equal(out, ref)
    assert meta.keys() == rmeta.keys()
    with pytest.raises(KeyError):
        reprojection.unstructured2regular(src, {"clon": clon}, meta_dst)


def test_profiling_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path), host=True) as logdir:
        with profiling.annotate("pst-region"):
            torch.fft.rfft2(torch.ones(16, 16))
    files = list(tmp_path.glob("trace_*.json"))
    assert logdir == str(tmp_path) and len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "pst-region" in names
    t = profiling.Timer()
    with t("a"):
        torch.ones(8).sum()
    with t("a"):
        pass
    with t("b"):
        pass
    assert set(t.totals) == {"a", "b"} and t.totals["a"] >= 0
    assert "a" in t.report() and t.report().count("ms") == 2
    assert profiling.device_memory_stats("cpu") == {}


def test_get_method_answers_for_jax_names():
    names = set(jinterface._methods)
    assert set(tutils.interface._methods) == names
    for name in names:
        assert tutils.get_method(name).__name__ == jinterface.get_method(name).__name__
    assert tutils.get_method(None) is tutils.interface.donothing
    x = torch.ones(3)
    y, meta = tutils.get_method("none")(x, {"a": 1})
    assert torch.equal(x, y) and y is not x and meta == {"a": 1}
    for name in ("numpy", "scipy", "pyfftw"):
        assert tutils.get_method(name, shape=(8, 8)).shape == (8, 8)
        with pytest.raises(KeyError):
            tutils.get_method(name)
    with pytest.raises(ValueError, match="Unknown method"):
        tutils.get_method("no-such-method")
