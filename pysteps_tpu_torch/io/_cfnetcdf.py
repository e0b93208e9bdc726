"""
CF-1.7 NetCDF-4 *writer* built directly on h5py.

The reference writes its forecasts with the netCDF4 package
(pysteps/io/exporters.py:370-666).  netCDF4 is not available here, but a
NetCDF-4 file *is* an HDF5 file whose dimensions are HDF5 dimension
scales — so the writer below produces standard ``.nc`` files readable by
netCDF4/xarray/ncdump, using only h5py:

- dimensions        -> dimension-scale datasets (coordinate variables) or
                       anonymous scale datasets for dims without coords
- unlimited dims    -> maxshape=None + chunked storage (incremental modes)
- attributes        -> plain HDF5 attributes (UTF-8 strings / typed scalars)
- compression       -> gzip (equivalent to netCDF4 zlib complevel)

Also hosts the PROJ.4 <-> CF grid-mapping conversion used by the exporter
and the nowcast importer (reference: io/exporters.py:896,
io/nowcast_importers.py:224).  More projection types than the reference's
(stere, aea) are covered: laea, merc, tmerc/utm and aeqd have standard CF
grid-mapping names.
"""

import numpy as np


class NcWriter:
    """Minimal netCDF4-compatible writer over an h5py.File."""

    def __init__(self, filename):
        import h5py

        self._h5py = h5py
        self.f = h5py.File(filename, "w")
        self.dims = {}  # name -> (dataset, unlimited)

    # -- attributes ------------------------------------------------------
    @staticmethod
    def set_attrs(obj, attrs):
        for key, val in attrs.items():
            if val is None:
                continue
            obj.attrs[key] = val

    def set_global_attrs(self, attrs):
        self.set_attrs(self.f, attrs)

    # -- dimensions & variables ------------------------------------------
    def create_dimension(self, name, size, values=None, dtype=None, attrs=None):
        """A dimension with (optional) coordinate values.  ``size=None``
        makes it unlimited (values appended later via set_coord)."""
        unlimited = size is None
        n = 0 if unlimited else int(size)
        if values is not None:
            values = np.asarray(values)
            n = len(values)
            dtype = dtype or values.dtype
        ds = self.f.create_dataset(
            name,
            shape=(n,),
            maxshape=(None,) if unlimited else (n,),
            dtype=dtype or np.float32,
            chunks=(max(n, 1),) if unlimited else None,
        )
        if values is not None:
            ds[:] = values
        ds.make_scale(name)
        if values is None and attrs is None:
            # netCDF4's marker for a dimension without a coordinate variable
            ds.attrs["NAME"] = np.bytes_(
                f"This is a netCDF dimension but not a netCDF variable."
                f" {n:10d}"
            )
        if attrs:
            self.set_attrs(ds, attrs)
        self.dims[name] = ds
        return ds

    def set_coord(self, name, index, value):
        """Append/assign one coordinate value on an unlimited dimension."""
        ds = self.dims[name]
        if ds.shape[0] <= index:
            ds.resize((index + 1,))
        ds[index] = value

    def create_variable(
        self, name, dims, dtype=np.float32, fill_value=None, complevel=0,
        attrs=None, scalar=False,
    ):
        if scalar:
            var = self.f.create_dataset(name, shape=(), dtype=dtype)
            if attrs:
                self.set_attrs(var, attrs)
            return var
        shape = tuple(self.dims[d].shape[0] for d in dims)
        maxshape = tuple(
            None if self.dims[d].maxshape[0] is None else self.dims[d].shape[0]
            for d in dims
        )
        kwargs = {}
        if complevel:
            kwargs.update(compression="gzip", compression_opts=int(complevel))
        if any(m is None for m in maxshape) or complevel:
            # chunking required for unlimited/compressed datasets
            kwargs["chunks"] = tuple(max(1, s if m is not None else 1)
                                     for s, m in zip(shape, maxshape))
        var = self.f.create_dataset(
            name, shape=shape, maxshape=maxshape, dtype=dtype,
            fillvalue=fill_value, **kwargs,
        )
        for i, d in enumerate(dims):
            var.dims[i].attach_scale(self.dims[d])
        if fill_value is not None:
            var.attrs.create("_FillValue", fill_value, dtype=dtype)
        if attrs:
            self.set_attrs(var, attrs)
        return var

    @staticmethod
    def grow(var, axis, size):
        """Resize an unlimited axis of ``var`` up to ``size``."""
        if var.shape[axis] < size:
            shape = list(var.shape)
            shape[axis] = size
            var.resize(tuple(shape))

    def close(self):
        self.f.close()


# -- PROJ.4 <-> CF grid mapping -------------------------------------------

def proj4_to_grid_mapping(proj4str):
    """(var_name, grid_mapping_name, params) for a PROJ.4 string; var_name
    is None for projections without a CF mapping (reference:
    io/exporters.py:896-940, extended with laea/merc/tmerc/utm/aeqd)."""
    from pysteps_tpu_torch.utils.projection import parse_proj4

    d = parse_proj4(proj4str)
    params = {
        "false_easting": float(d.get("x_0", 0.0)),
        "false_northing": float(d.get("y_0", 0.0)),
    }
    proj = d.get("proj")
    if proj == "stere":
        name = "polar_stereographic"
        params["straight_vertical_longitude_from_pole"] = float(d.get("lon_0", 0))
        params["latitude_of_projection_origin"] = float(d.get("lat_0", 90))
        if "lat_ts" in d:
            params["standard_parallel"] = float(d["lat_ts"])
        elif "k_0" in d or "k" in d:
            params["scale_factor_at_projection_origin"] = float(
                d.get("k_0", d.get("k"))
            )
        return name, name, params
    if proj == "aea":
        params["longitude_of_central_meridian"] = float(d.get("lon_0", 0))
        params["latitude_of_projection_origin"] = float(d.get("lat_0", 0))
        sp = [float(d[k]) for k in ("lat_1", "lat_2") if k in d]
        if sp:
            params["standard_parallel"] = sp[0] if len(sp) == 1 else sp
        return "proj", "albers_conical_equal_area", params
    if proj == "laea":
        params["longitude_of_projection_origin"] = float(d.get("lon_0", 0))
        params["latitude_of_projection_origin"] = float(d.get("lat_0", 0))
        return "proj", "lambert_azimuthal_equal_area", params
    if proj == "aeqd":
        params["longitude_of_projection_origin"] = float(d.get("lon_0", 0))
        params["latitude_of_projection_origin"] = float(d.get("lat_0", 0))
        return "proj", "azimuthal_equidistant", params
    if proj == "merc":
        params["longitude_of_projection_origin"] = float(d.get("lon_0", 0))
        if "lat_ts" in d:
            params["standard_parallel"] = float(d["lat_ts"])
        else:
            params["scale_factor_at_projection_origin"] = float(
                d.get("k_0", d.get("k", 1.0))
            )
        return "proj", "mercator", params
    if proj in ("tmerc", "utm"):
        if proj == "utm":
            zone = int(d["zone"])
            params["longitude_of_central_meridian"] = float(zone * 6 - 183)
            params["scale_factor_at_central_meridian"] = 0.9996
            params["false_easting"] = 500000.0
            params["false_northing"] = 10000000.0 if d.get("south") else 0.0
            params["latitude_of_projection_origin"] = 0.0
        else:
            params["longitude_of_central_meridian"] = float(d.get("lon_0", 0))
            params["latitude_of_projection_origin"] = float(d.get("lat_0", 0))
            params["scale_factor_at_central_meridian"] = float(
                d.get("k_0", d.get("k", 1.0))
            )
        return "proj", "transverse_mercator", params
    return None, None, params


def grid_mapping_to_proj4(attrs):
    """CF grid-mapping attrs -> PROJ.4 string (reference:
    io/nowcast_importers.py:224-244, extended beyond polar_stereographic)."""
    name = attrs.get("grid_mapping_name")
    if isinstance(name, bytes):
        name = name.decode()
    parts = []

    def get(key, default=None):
        val = attrs.get(key, default)
        if hasattr(val, "item") and np.ndim(val) == 0:
            val = val.item()
        return val

    if name == "polar_stereographic":
        parts = [
            "+proj=stere",
            f"+lon_0={get('straight_vertical_longitude_from_pole', 0)}",
            f"+lat_0={get('latitude_of_projection_origin', 90)}",
        ]
        if "standard_parallel" in attrs:
            parts.append(f"+lat_ts={get('standard_parallel')}")
        if "scale_factor_at_projection_origin" in attrs:
            parts.append(f"+k_0={get('scale_factor_at_projection_origin')}")
    elif name == "albers_conical_equal_area":
        parts = [
            "+proj=aea",
            f"+lon_0={get('longitude_of_central_meridian', 0)}",
            f"+lat_0={get('latitude_of_projection_origin', 0)}",
        ]
        sp = get("standard_parallel")
        if sp is not None:
            sp = np.atleast_1d(sp)
            parts.append(f"+lat_1={sp[0]}")
            if len(sp) > 1:
                parts.append(f"+lat_2={sp[1]}")
    elif name == "lambert_azimuthal_equal_area":
        parts = [
            "+proj=laea",
            f"+lon_0={get('longitude_of_projection_origin', 0)}",
            f"+lat_0={get('latitude_of_projection_origin', 0)}",
        ]
    elif name == "azimuthal_equidistant":
        parts = [
            "+proj=aeqd",
            f"+lon_0={get('longitude_of_projection_origin', 0)}",
            f"+lat_0={get('latitude_of_projection_origin', 0)}",
        ]
    elif name == "mercator":
        parts = ["+proj=merc", f"+lon_0={get('longitude_of_projection_origin', 0)}"]
        if "standard_parallel" in attrs:
            parts.append(f"+lat_ts={get('standard_parallel')}")
    elif name == "transverse_mercator":
        parts = [
            "+proj=tmerc",
            f"+lon_0={get('longitude_of_central_meridian', 0)}",
            f"+lat_0={get('latitude_of_projection_origin', 0)}",
            f"+k_0={get('scale_factor_at_central_meridian', 1.0)}",
        ]
    else:
        return None
    parts.append(f"+x_0={get('false_easting', 0.0)}")
    parts.append(f"+y_0={get('false_northing', 0.0)}")
    return " ".join(parts)
