"""
Minimal NetCDF reader facade used by the NetCDF-based importers
(bom_rf3, saf_crri — reference: pysteps/io/importers.py:440,1557 via the
netCDF4 package, which is not available here).

NetCDF-4 files are HDF5 containers → read with h5py.  Classic NetCDF-3
files → read with scipy.io.netcdf_file.  Both are wrapped in a common
``Dataset`` API exposing the small netCDF4 subset the importers need:
``.variables[name][:]``, per-variable ``ncattrs()``/``getncattr``/attribute
access, global ``getncattr``, and ``close()``.
"""

import numpy as np


def _decode(value):
    """Attribute values: bytes -> str, 0-d arrays -> scalars."""
    if isinstance(value, bytes):
        return value.decode("utf-8", errors="replace")
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return _decode(value[()])
        if value.dtype.kind == "S":
            return b"".join(value.ravel()).decode("utf-8", errors="replace")
        if value.size == 1:
            return _decode(value.ravel()[0])
        return value
    if isinstance(value, np.generic):
        return value.item()
    return value


class _Variable:
    """netCDF4.Variable-alike over either an h5py dataset or a scipy var."""

    def __init__(self, data, attrs):
        self._data = data
        self._attrs = {k: _decode(v) for k, v in attrs.items()}

    def __getitem__(self, key):
        out = np.asarray(self._data[key] if key is not Ellipsis else self._data[...])
        # apply CF unpacking conventions if present
        fill = self._attrs.get("_FillValue", self._attrs.get("missing_value"))
        scale = self._attrs.get("scale_factor")
        offset = self._attrs.get("add_offset")
        if fill is not None and out.dtype.kind in "iuf":
            out = np.where(out == fill, np.nan, out.astype(float))
        if scale is not None:
            out = out * scale
        if offset is not None:
            out = out + offset
        return out

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        return iter(self[:])

    def ncattrs(self):
        return list(self._attrs)

    def getncattr(self, name):
        return self._attrs[name]

    def __getattr__(self, name):
        try:
            return self._attrs[name]
        except KeyError:
            raise AttributeError(name) from None


class Dataset:
    """Open a NetCDF-4 (HDF5) or classic NetCDF-3 file read-only."""

    def __init__(self, filename):
        with open(filename, "rb") as f:
            magic = f.read(8)
        if magic[:3] == b"CDF":
            from scipy.io import netcdf_file

            self._nc = netcdf_file(filename, "r", mmap=False)
            self._h5 = None
            self.variables = {
                name: _Variable(var.data, var._attributes)
                for name, var in self._nc.variables.items()
            }
            self._gattrs = {
                k: _decode(v) for k, v in self._nc._attributes.items()
            }
        elif magic[:8] == b"\x89HDF\r\n\x1a\n":
            import h5py

            self._h5 = h5py.File(filename, "r")
            self._nc = None
            self.variables = {}
            self._h5.visititems(self._collect)
            self._gattrs = {k: _decode(v) for k, v in self._h5.attrs.items()}
        else:
            raise ValueError(f"{filename}: not a NetCDF (classic or HDF5) file")

    def _collect(self, name, obj):
        import h5py

        if isinstance(obj, h5py.Dataset):
            # flat files use the bare name; nested groups keep the full path
            key = name if "/" in name else name.split("/")[-1]
            self.variables[key] = _Variable(obj, dict(obj.attrs))

    def ncattrs(self):
        return list(self._gattrs)

    def getncattr(self, name):
        return self._gattrs[name]

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_gattrs")[name]
        except KeyError:
            raise AttributeError(name) from None

    def close(self):
        if self._h5 is not None:
            self._h5.close()
        if self._nc is not None:
            self._nc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def num2date(times, units, calendar="standard"):
    """CF time decode for the common '<unit> since <epoch>' encodings
    (reference relies on netCDF4.num2date)."""
    from datetime import datetime, timedelta

    parts = units.split("since")
    if len(parts) != 2:
        raise ValueError(f"unsupported time units: {units}")
    step = parts[0].strip().lower()
    epoch_str = parts[1].strip().replace("T", " ").split("+")[0].strip()
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d"):
        try:
            epoch = datetime.strptime(epoch_str[: len(fmt) + 7], fmt)
            break
        except ValueError:
            continue
    else:
        raise ValueError(f"cannot parse time epoch: {epoch_str}")
    seconds_per = {
        "seconds": 1.0, "second": 1.0, "secs": 1.0, "s": 1.0,
        "minutes": 60.0, "minute": 60.0, "mins": 60.0,
        "hours": 3600.0, "hour": 3600.0,
        "days": 86400.0, "day": 86400.0,
    }[step]
    arr = np.atleast_1d(np.asarray(times, float))
    out = np.array([epoch + timedelta(seconds=float(v) * seconds_per) for v in arr])
    return out if np.ndim(times) else out[0]
