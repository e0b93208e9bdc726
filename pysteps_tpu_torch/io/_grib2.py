"""
Minimal GRIB2 reader for NCEP/MRMS products
(reference: pysteps/io/importers.py:244 via pygrib/ecCodes, unavailable
here).

Section parsing lives here; payload unpacking runs in the native C++
kernels (pysteps_tpu_torch/native/grib2.cpp) with NumPy/PIL fallbacks.  Supported
grids: template 3.0 (regular lat/lon).  Supported data representations:
5.0 (simple), 5.2/5.3 (complex packing [+ spatial differencing]),
5.41 (PNG — the MRMS default).
"""

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

from pysteps_tpu_torch.exceptions import DataModelError


def _uint(buf, lo, hi):
    """Big-endian unsigned int from 1-based inclusive octet range."""
    return int.from_bytes(buf[lo - 1 : hi], "big")


def _sint(buf, lo, hi):
    """GRIB signed int: sign-magnitude, NOT two's complement."""
    raw = _uint(buf, lo, hi)
    nbits = 8 * (hi - lo + 1)
    sign_bit = 1 << (nbits - 1)
    return -(raw & ~sign_bit) if raw & sign_bit else raw


@dataclass
class Grib2Message:
    discipline: int = 0
    datetime: tuple = ()
    # grid (template 3.0)
    ni: int = 0
    nj: int = 0
    lat1: float = 0.0
    lon1: float = 0.0
    lat2: float = 0.0
    lon2: float = 0.0
    di: float = 0.0
    dj: float = 0.0
    scan_mode: int = 0
    shape_of_earth: int = 255
    # product
    parameter_category: int = 0
    parameter_number: int = 0
    # data
    values: np.ndarray = field(default_factory=lambda: np.empty(0))

    @property
    def projparams(self):
        """Best-effort proj params (pygrib-alike; MRMS grids are lat/lon)."""
        shapes = {
            0: {"R": 6367470}, 1: {"R": 6367470}, 2: {"ellps": "IAU76"},
            4: {"ellps": "GRS80"}, 5: {"ellps": "WGS84"},
            6: {"R": 6371229}, 8: {"datum": "WGS84", "R": 6371200},
        }
        params = {"proj": "longlat"}
        params.update(shapes.get(self.shape_of_earth, {"R": 6371229}))
        return params


def _unpack_bits_numpy(payload, n, nbits):
    """Fallback bit-stream unpack: n big-endian nbits integers."""
    if nbits == 0:
        return np.zeros(n, dtype=np.int64)
    bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    bits = bits[: n * nbits].reshape(n, nbits).astype(np.int64)
    weights = 1 << np.arange(nbits - 1, -1, -1, dtype=np.int64)
    return bits @ weights


def _decode_simple(sec5, payload, n):
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _sint(sec5, 16, 17)
    D = _sint(sec5, 18, 19)
    nbits = sec5[19]

    from pysteps_tpu_torch import native

    out = native.grib_unpack_simple(payload, n, nbits, R, E, D)
    if out is not None:
        return out
    x = _unpack_bits_numpy(payload, n, nbits)
    return ((R + x * 2.0**E) / 10.0**D).astype(np.float32)


def _decode_complex(sec5, payload, n):
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _sint(sec5, 16, 17)
    D = _sint(sec5, 18, 19)
    nbits = sec5[19]
    mvm = sec5[22]
    ng = _uint(sec5, 32, 35)
    width_ref = sec5[35]
    width_bits = sec5[36]
    len_ref = _uint(sec5, 38, 41)
    len_inc = sec5[41]
    last_len = _uint(sec5, 43, 46)
    len_bits = sec5[46]

    template = _uint(sec5, 10, 11)
    order = 0
    ival1 = ival2 = gmin = 0
    if template == 3:
        order = sec5[47]
        extra = sec5[48]
        off = 0
        vals = []
        for _ in range(order + 1):  # ival1 [, ival2], gmin
            vals.append(_sint(payload, off + 1, off + extra))
            off += extra
        if order == 1:
            ival1, gmin = vals
        else:
            ival1, ival2, gmin = vals
        payload = payload[off:]

    from pysteps_tpu_torch import native

    out = native.grib_unpack_complex(
        payload, n, nbits, R, E, D, ng, width_ref, width_bits, len_ref,
        len_inc, last_len, len_bits, mvm, order, ival1, ival2, gmin,
    )
    if out is not None:
        return out

    # ---- NumPy fallback ----
    def padded(nvals, bits, start_bit):
        end = start_bit + nvals * bits
        vals = (
            _unpack_bits_numpy(payload[start_bit // 8 :], nvals, bits)
            if bits
            else np.zeros(nvals, dtype=np.int64)
        )
        return vals, (end + 7) // 8 * 8

    pos = 0
    refs, pos = padded(ng, nbits, pos)
    widths, pos = padded(ng, width_bits, pos)
    widths = widths + width_ref
    lens, pos = padded(ng, len_bits, pos)
    lens = lens * len_inc + len_ref
    if ng:
        lens[-1] = last_len
    if lens.sum() != n:
        raise DataModelError("complex packing: group lengths != grid size")

    vals = np.empty(n, dtype=np.int64)
    miss = np.zeros(n, dtype=bool)
    bitbuf = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
    i = 0
    for g in range(ng):
        w, ln = int(widths[g]), int(lens[g])
        if w == 0:
            if mvm == 1 and nbits and refs[g] == (1 << nbits) - 1:
                miss[i : i + ln] = True
            else:
                vals[i : i + ln] = refs[g]
        else:
            chunk = bitbuf[pos : pos + ln * w].reshape(ln, w).astype(np.int64)
            x = chunk @ (1 << np.arange(w - 1, -1, -1, dtype=np.int64))
            if mvm == 1:
                m = x == (1 << w) - 1
                miss[i : i + ln] = m
            vals[i : i + ln] = refs[g] + x
            pos += ln * w
        i += ln

    if order > 0:
        idx = np.flatnonzero(~miss)
        d = vals[idx].astype(np.int64)
        d[order:] += gmin
        d[0] = ival1
        if order == 2:
            if len(d) > 1:
                d[1] = ival2
            for k in range(2, len(d)):
                d[k] += 2 * d[k - 1] - d[k - 2]
        else:
            for k in range(1, len(d)):
                d[k] += d[k - 1]
        vals[idx] = d

    out = ((R + vals * 2.0**E) / 10.0**D).astype(np.float32)
    out[miss] = np.nan
    return out


def _decode_png(sec5, payload, n):
    R = struct.unpack(">f", sec5[11:15])[0]
    E = _sint(sec5, 16, 17)
    D = _sint(sec5, 18, 19)

    from pysteps_tpu_torch import native

    out = native.grib_png_unpack(payload, n, R, E, D)
    if out is not None:
        return out

    # PIL fallback
    import io as _io

    from PIL import Image

    img = Image.open(_io.BytesIO(payload))
    arr = np.asarray(img)
    if arr.ndim == 3:  # RGB(A): big-endian multi-byte sample
        x = np.zeros(arr.shape[:2], dtype=np.int64)
        for c in range(arr.shape[2]):
            x = (x << 8) | arr[..., c].astype(np.int64)
    else:
        x = arr.astype(np.int64)
    return ((R + x.ravel() * 2.0**E) / 10.0**D).astype(np.float32)


_DECODERS = {0: _decode_simple, 2: _decode_complex, 3: _decode_complex,
             41: _decode_png}


def read_messages(filename):
    """Parse every GRIB2 message in a (possibly gzipped) file."""
    opener = gzip.open if str(filename).endswith(".gz") else open
    with opener(filename, "rb") as f:
        buf = f.read()
    if buf[:2] == b"\x1f\x8b":  # gzipped despite the extension
        buf = gzip.decompress(buf)

    messages = []
    off = 0
    while True:
        start = buf.find(b"GRIB", off)
        if start < 0:
            break
        ind = buf[start : start + 16]
        if len(ind) < 16 or ind[7] != 2:
            raise DataModelError(f"{filename}: not GRIB edition 2")
        total_len = int.from_bytes(ind[8:16], "big")
        messages.append(_parse_message(buf[start : start + total_len], filename))
        off = start + total_len
    if not messages:
        raise DataModelError(f"{filename}: no GRIB messages found")
    return messages


def _parse_message(buf, filename):
    msg = Grib2Message(discipline=buf[6])
    pos = 16
    sec3 = sec5 = sec6 = sec7 = None
    sections = {}
    while pos < len(buf):
        if buf[pos : pos + 4] == b"7777":
            break
        length = int.from_bytes(buf[pos : pos + 4], "big")
        number = buf[pos + 4]
        sections[number] = buf[pos : pos + length]
        if number == 3:
            sec3 = sections[3]
        elif number == 5:
            sec5 = sections[5]
        elif number == 6:
            sec6 = sections[6]
        elif number == 7:
            sec7 = sections[7]
            _finish_field(msg, sec3, sec5, sec6, sec7, sections.get(1),
                          sections.get(4), filename)
        pos += length
    return msg


def _finish_field(msg, sec3, sec5, sec6, sec7, sec1, sec4, filename):
    if sec1 is not None and len(sec1) >= 19:
        msg.datetime = (
            _uint(sec1, 13, 14), sec1[14], sec1[15], sec1[16], sec1[17],
            sec1[18],
        )
    if sec4 is not None and len(sec4) >= 11:
        msg.parameter_category = sec4[9]
        msg.parameter_number = sec4[10]

    if sec3 is None or sec5 is None or sec7 is None:
        raise DataModelError(f"{filename}: incomplete GRIB2 message")

    grid_template = _uint(sec3, 13, 14)
    if grid_template != 0:
        raise DataModelError(
            f"{filename}: unsupported grid template 3.{grid_template} "
            "(only regular lat/lon is implemented)"
        )
    msg.shape_of_earth = sec3[14]
    msg.ni = _uint(sec3, 31, 34)
    msg.nj = _uint(sec3, 35, 38)
    msg.lat1 = _sint(sec3, 47, 50) * 1e-6
    msg.lon1 = _uint(sec3, 51, 54) * 1e-6
    msg.lat2 = _sint(sec3, 56, 59) * 1e-6
    msg.lon2 = _uint(sec3, 60, 63) * 1e-6
    msg.di = _uint(sec3, 64, 67) * 1e-6
    msg.dj = _uint(sec3, 68, 71) * 1e-6
    msg.scan_mode = sec3[71]

    n_points = _uint(sec3, 7, 10)
    n_packed = _uint(sec5, 6, 9)
    drs_template = _uint(sec5, 10, 11)
    if drs_template not in _DECODERS:
        raise DataModelError(
            f"{filename}: unsupported data representation template "
            f"5.{drs_template} (supported: 0, 2, 3, 41)"
        )
    values = _DECODERS[drs_template](sec5, sec7[5:], n_packed)

    if sec6 is not None and sec6[5] == 0:  # bitmap present
        bitmap = np.unpackbits(
            np.frombuffer(sec6[6:], dtype=np.uint8)
        )[:n_points].astype(bool)
        full = np.full(n_points, np.nan, dtype=np.float32)
        full[bitmap] = values
        values = full
    elif values.size != n_points:
        raise DataModelError(
            f"{filename}: decoded {values.size} values, grid has {n_points}"
        )

    grid = values.reshape(msg.nj, msg.ni)
    # scanning mode: bit 1 (0x80) -i direction, bit 2 (0x40) +j (south->north)
    if msg.scan_mode & 0x80:
        grid = grid[:, ::-1]
    if msg.scan_mode & 0x40:
        grid = grid[::-1]
    msg.values = grid
