"""
Native (C++/OpenMP) decode kernels for the IO data plane, bound via ctypes
(counterpart of ``pysteps_tpu/native``; host code, no tensors).

The library builds lazily on first use with the system g++ into the
repo's ``build/`` (``native/build.py``); every function returns None when
the toolchain or the library is unavailable, so that its callers fall
back to their NumPy path.
"""

import ctypes

import numpy as np

_lib = None
_tried = False


def get_lib():
    """Load (building if needed) the native decoder library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from pysteps_tpu_torch.native.build import build

    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.radolan_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_float,
        ]
        lib.pgm_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_float,
        ]
        lib.lut_apply_u8.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.calibrate_u16.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.omp_thread_count.restype = ctypes.c_int
        lib.grib_unpack_simple.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.grib_unpack_simple.restype = ctypes.c_int
        lib.grib_unpack_complex.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.grib_unpack_complex.restype = ctypes.c_int
        lib.grib_png_unpack.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.grib_png_unpack.restype = ctypes.c_int
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def radolan_decode(raw_u16, size, precision=0.1):
    """Native RADOLAN decode; returns float32 (size, size) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw_u16[: size * size], dtype=np.uint16)
    out = np.empty((size, size), dtype=np.float32)
    lib.radolan_decode(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size, ctypes.c_float(precision),
    )
    return out


def pgm_decode(raw_bytes, n_pixels, bytes_per_px, nodata, offset, gain):
    """Native PGM payload decode; returns float32 1-D array or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.frombuffer(raw_bytes, dtype=np.uint8)
    out = np.empty(n_pixels, dtype=np.float32)
    lib.pgm_decode(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_pixels, bytes_per_px, ctypes.c_float(nodata),
        ctypes.c_float(offset), ctypes.c_float(gain),
    )
    return out


def calibrate_u16(raw_u16, gain, offset, nodata, undetect, undetect_value=0.0):
    """Native ODIM-style linear calibration; returns float32 array or None."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw_u16, dtype=np.uint16)
    out = np.empty(raw.shape, dtype=np.float32)
    lib.calibrate_u16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size, ctypes.c_float(gain), ctypes.c_float(offset),
        ctypes.c_float(nodata), ctypes.c_float(undetect),
        ctypes.c_float(undetect_value),
    )
    return out


def _f32_out(n):
    out = np.empty(int(n), dtype=np.float32)
    return out, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def grib_unpack_simple(payload, n, nbits, R, E, D):
    """Native GRIB2 template-5.0 unpack; float32 (n,) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "grib_unpack_simple"):
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out, outp = _f32_out(n)
    rc = lib.grib_unpack_simple(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n), int(nbits), ctypes.c_float(R), int(E), int(D), outp,
    )
    return out if rc == 0 else None


def grib_unpack_complex(payload, n, nbits, R, E, D, ng, width_ref, width_bits,
                        len_ref, len_inc, last_len, len_bits, mvm, order,
                        ival1, ival2, gmin):
    """Native GRIB2 template-5.2/5.3 unpack; float32 (n,) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "grib_unpack_complex"):
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out, outp = _f32_out(n)
    rc = lib.grib_unpack_complex(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.size, int(n), int(nbits), ctypes.c_float(R), int(E), int(D),
        int(ng), int(width_ref), int(width_bits), int(len_ref), int(len_inc),
        int(last_len), int(len_bits), int(mvm), int(order), int(ival1),
        int(ival2), int(gmin), outp,
    )
    return out if rc == 0 else None


def grib_png_unpack(payload, n, R, E, D):
    """Native GRIB2 template-5.41 (PNG) unpack; float32 (n,) or None."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "grib_png_unpack"):
        return None
    src = np.frombuffer(payload, dtype=np.uint8)
    out, outp = _f32_out(n)
    rc = lib.grib_png_unpack(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.size, int(n), ctypes.c_float(R), int(E), int(D), outp,
    )
    return out if rc == 0 else None
