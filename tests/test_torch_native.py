"""The port's native decoders (``pysteps_tpu_torch/native``) against the JAX
package's (``pysteps_tpu/native``) on the same bytes, bit for bit.

The port builds its own copy of the C++ sources with the system ``g++``
into the repo's ``build/``; the test fails, not skips, where that build
fails, so that the NumPy fallback is never what is tested.  The GRIB2
payloads come from ``helpers.encode_grib2`` and reach the decoders as
``pysteps_tpu/io/_grib2.py`` hands them over (its calls are recorded)."""

import ctypes
from pathlib import Path

import numpy as np
import pytest

import pysteps_tpu.native as jnative
from helpers import encode_grib2
from pysteps_tpu.io import _grib2
from pysteps_tpu_torch import native as tnative
from pysteps_tpu_torch.native import build as tbuild

ROOT = Path(__file__).resolve().parents[1]


def _bits_equal(a, b):
    assert a is not None and b is not None
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_library_builds_into_the_repos_build_dir():
    lib = tnative.get_lib()
    assert lib is not None, "the port's native library did not build"
    path = Path(lib._name)
    assert path == tbuild.lib_path() and path.is_file()
    assert path.parent == ROOT / "build" / "pysteps_tpu_torch"
    assert "pysteps_tpu/native" not in str(path)
    assert lib.omp_thread_count() >= 1


@pytest.mark.parametrize("size,precision", [(64, 0.1), (100, 0.01)])
def test_radolan_decode(size, precision):
    rng = np.random.RandomState(size)
    raw = rng.randint(0, 2**16, size=size * size + 7).astype(np.uint16)
    _bits_equal(tnative.radolan_decode(raw, size, precision),
                jnative.radolan_decode(raw, size, precision))


@pytest.mark.parametrize("bytes_per_px", [1, 2])
def test_pgm_decode(bytes_per_px):
    rng = np.random.RandomState(bytes_per_px)
    n = 1000
    raw = rng.randint(0, 256, size=n * bytes_per_px).astype(np.uint8)
    raw[:4] = 255  # no data (8-bit), or 65535 (16-bit)
    nodata = 255.0 if bytes_per_px == 1 else 65535.0
    args = (raw.tobytes(), n, bytes_per_px, nodata, 64.0, 2.0)
    _bits_equal(tnative.pgm_decode(*args), jnative.pgm_decode(*args))


def test_calibrate_u16():
    raw = np.random.RandomState(2).randint(0, 2**16, size=(50, 40)).astype(np.uint16)
    raw[0, :3] = 65535
    raw[1, :3] = 0
    args = (raw, 0.01, -32.0, 65535.0, 0.0, -15.0)
    _bits_equal(tnative.calibrate_u16(*args), jnative.calibrate_u16(*args))


def test_lut_apply_u8_through_the_loaded_libraries():
    """``lut_apply_u8`` is bound in ``get_lib`` but has no wrapper: both
    libraries' symbol, called on the same bytes and table."""
    rng = np.random.RandomState(3)
    raw = rng.randint(0, 256, size=4096).astype(np.uint8)
    lut = rng.rand(256).astype(np.float32)
    lut[7] = np.nan
    outs = []
    for lib in (tnative.get_lib(), jnative.get_lib()):
        out = np.empty(raw.size, np.float32)
        lib.lut_apply_u8(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         lut.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), raw.size)
        outs.append(out)
    _bits_equal(*outs)
    _bits_equal(outs[0], lut[raw])


@pytest.mark.parametrize("packing,name", [("simple", "grib_unpack_simple"),
                                          ("complex", "grib_unpack_complex"),
                                          ("png", "grib_png_unpack")])
def test_grib_unpack(tmp_path, monkeypatch, packing, name):
    rng = np.random.RandomState(0)
    field = np.round(rng.exponential(2.0, (40, 60)), 3)
    field[3, 7] = -3.0
    path = tmp_path / f"test_{packing}.grib2"
    path.write_bytes(encode_grib2(field, packing=packing))
    calls = []
    orig = getattr(jnative, name)

    def recording(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(jnative, name, recording)
    _grib2.read_messages(str(path))
    assert len(calls) == 1
    port = getattr(tnative, name)(*calls[0])
    _bits_equal(port, orig(*calls[0]))
    np.testing.assert_allclose(np.sort(port), np.sort(field.ravel()), atol=2e-3)


def test_every_function_returns_none_without_the_library(monkeypatch):
    raw16 = np.zeros(16, np.uint16)
    calls = [
        lambda m: m.radolan_decode(raw16, 4),
        lambda m: m.pgm_decode(bytes(16), 16, 1, 255.0, 0.0, 1.0),
        lambda m: m.calibrate_u16(raw16, 1.0, 0.0, 65535.0, 0.0),
        lambda m: m.grib_unpack_simple(bytes(16), 16, 8, 0.0, 0, 0),
        lambda m: m.grib_unpack_complex(bytes(16), 16, 8, 0.0, 0, 0, 1, 0, 8, 16, 1, 16, 8,
                                        0, 0, 0, 0, 0),
        lambda m: m.grib_png_unpack(bytes(16), 16, 0.0, 0, 0),
    ]
    for mod in (tnative, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", True)
        assert mod.get_lib() is None
        for call in calls:
            assert call(mod) is None
