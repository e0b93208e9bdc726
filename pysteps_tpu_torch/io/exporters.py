"""
Forecast exporters (reference: pysteps/io/exporters.py:125,241,370,666,753).

Stateful exporter dicts with the reference's three-call protocol:
``initialize_forecast_exporter_xxx`` -> ``export_forecast_dataset`` ->
``close_forecast_files``.  Incremental writing modes ("timestep" /
"member") are supported.

Every exporter takes numpy arrays or the port's own outputs: torch tensors
on any device, float32 or bfloat16, read back to the host once a call.

Backends: HDF5 (h5py; replaces the reference's CF-NetCDF writer, which
needs netCDF4), NPZ (self-contained numpy), GeoTIFF (gated on GDAL), and
Kineros2 text.
"""

import os

import numpy as np

from pysteps_tpu_torch._device import to_numpy


def initialize_forecast_exporter_hdf5(
    outpath, outfnprefix, startdate, timestep, n_timesteps, shape, metadata,
    n_ens_members=1, datatype=np.float32, incremental=None, **kwargs,
):
    """HDF5 exporter (stands in for the reference's CF-1.7 NetCDF exporter,
    io/exporters.py:370)."""
    import h5py

    if incremental not in (None, "timestep", "member"):
        raise ValueError(f"unknown incremental mode {incremental}")
    os.makedirs(outpath, exist_ok=True)
    fname = os.path.join(outpath, f"{outfnprefix}.h5")
    f = h5py.File(fname, "w")
    dset = f.create_dataset(
        "precip_forecast",
        shape=(n_ens_members, n_timesteps) + tuple(shape),
        dtype=datatype,
        compression="gzip",
        compression_opts=1,
    )
    meta_grp = f.create_group("metadata")
    for key, val in (metadata or {}).items():
        try:
            meta_grp.attrs[key] = val if val is not None else "None"
        except TypeError:
            meta_grp.attrs[key] = str(val)
    meta_grp.attrs["startdate"] = str(startdate)
    meta_grp.attrs["timestep"] = timestep

    return {
        "method": "hdf5",
        "file": f,
        "dataset": dset,
        "num_timesteps": n_timesteps,
        "num_ens_members": n_ens_members,
        "shape": tuple(shape),
        "metadata": metadata,
        "incremental": incremental,
        "timestep_index": 0,
        "member_index": 0,
    }


def initialize_forecast_exporter_netcdf(
    outpath,
    outfnprefix,
    startdate,
    timestep,
    n_timesteps,
    shape,
    metadata,
    n_ens_members=1,
    datatype=np.float32,
    incremental=None,
    fill_value=None,
    scale_factor=None,
    offset=None,
    complevel=9,
    **kwargs,
):
    """CF-1.7 NetCDF exporter (reference: io/exporters.py:370-666), written
    directly as NetCDF-4/HDF5 with h5py (no netCDF4 dependency): dimensions
    are HDF5 dimension scales, unlimited axes back the incremental modes.
    lon/lat grids come from the built-in projections
    (:mod:`pysteps_tpu_torch.utils.projection`) instead of pyproj."""
    from pysteps_tpu_torch.io._cfnetcdf import NcWriter, proj4_to_grid_mapping
    from pysteps_tpu_torch.utils.projection import lonlat_grid

    if incremental not in (None, "timestep", "member"):
        raise ValueError(
            f"unknown option {incremental}: incremental must be "
            "'timestep' or 'member'"
        )
    timesteps_list = list(n_timesteps) if isinstance(n_timesteps, list) else None
    num_timesteps = (
        len(timesteps_list) if timesteps_list is not None else int(n_timesteps)
    )
    if incremental == "timestep":
        num_timesteps = None
    elif incremental == "member":
        n_ens_members = None
    n_ens_gt_one = bool(n_ens_members and n_ens_members > 1)

    os.makedirs(outpath, exist_ok=True)
    nc = NcWriter(os.path.join(outpath, outfnprefix + ".nc"))
    nc.set_global_attrs(
        {
            "Conventions": "CF-1.7",
            "title": "pysteps-generated nowcast",
            "institution": kwargs.get(
                "institution", "the pySTEPS community (https://pysteps.github.io)"
            ),
            "source": "pysteps_tpu_torch",
            "history": "",
            "references": kwargs.get("references", ""),
            "comment": kwargs.get("comment", ""),
            "projection": metadata.get("projection", ""),
        }
    )

    h, w = shape
    var_name, var_standard_name, var_long_name, var_unit = {
        "mm/h": ("precip_intensity", None,
                 "instantaneous precipitation rate", "mm h-1"),
        "mm": ("precip_accum", None, "accumulated precipitation", "mm"),
        "dBZ": ("reflectivity", "equivalent_reflectivity_factor",
                "equivalent reflectivity factor", "dBZ"),
    }.get(metadata["unit"], (None,) * 4)
    if var_name is None:
        raise ValueError("unknown unit %s" % metadata["unit"])

    # cell-centre coordinates (reference: io/exporters.py:538-543)
    xr = np.linspace(metadata["x1"], metadata["x2"], w + 1)[:-1]
    xr += 0.5 * (xr[1] - xr[0])
    yr = np.linspace(metadata["y1"], metadata["y2"], h + 1)[:-1]
    yr += 0.5 * (yr[1] - yr[0])
    if metadata.get("yorigin") == "upper":
        yr = np.flip(yr)

    cunit = metadata.get("cartesian_unit", "m")
    nc.create_dimension(
        "x", w, values=xr.astype(np.float32),
        attrs={"axis": "X", "standard_name": "projection_x_coordinate",
               "long_name": "x-coordinate in Cartesian system", "units": cunit},
    )
    nc.create_dimension(
        "y", h, values=yr.astype(np.float32),
        attrs={"axis": "Y", "standard_name": "projection_y_coordinate",
               "long_name": "y-coordinate in Cartesian system", "units": cunit},
    )

    lonlat = (
        lonlat_grid(metadata["projection"], xr, yr)
        if metadata.get("projection")
        else None
    )
    if lonlat is not None:
        var_lon = nc.create_variable(
            "lon", ("y", "x"), dtype=np.float64,
            attrs={"standard_name": "longitude",
                   "long_name": "longitude coordinate",
                   "units": "degrees_east"},
        )
        var_lon[:] = lonlat[0]
        var_lat = nc.create_variable(
            "lat", ("y", "x"), dtype=np.float64,
            attrs={"standard_name": "latitude",
                   "long_name": "latitude coordinate",
                   "units": "degrees_north"},
        )
        var_lat[:] = lonlat[1]

    gm_var_name, gm_name, gm_params = (
        proj4_to_grid_mapping(metadata["projection"])
        if metadata.get("projection")
        else (None, None, {})
    )
    if gm_var_name is not None:
        nc.create_variable(
            gm_var_name, (), dtype=np.int32, scalar=True,
            attrs={"grid_mapping_name": gm_name, **gm_params},
        )

    dims = ()
    if incremental == "member" or n_ens_gt_one:
        nc.create_dimension(
            "ens_number", n_ens_members,
            values=(
                np.arange(1, n_ens_members + 1, dtype=np.int64)
                if incremental != "member"
                else None
            ),
            dtype=np.int64,
            attrs={"long_name": "ensemble member",
                   "standard_name": "realization", "units": ""},
        )
        dims += ("ens_number",)
    time_values = None
    if incremental != "timestep":
        if timesteps_list is not None:
            time_values = np.asarray(timesteps_list, np.int64) * timestep * 60
        else:
            time_values = np.arange(1, num_timesteps + 1, dtype=np.int64) * (
                timestep * 60
            )
    nc.create_dimension(
        "time", num_timesteps, values=time_values, dtype=np.int64,
        attrs={"long_name": "forecast time",
               "units": "seconds since %s"
               % startdate.strftime("%Y-%m-%d %H:%M:%S")},
    )
    dims += ("time", "y", "x")

    var_attrs = {
        "long_name": var_long_name,
        "coordinates": "y x",
        "units": var_unit,
    }
    if var_standard_name:
        var_attrs["standard_name"] = var_standard_name
    if gm_var_name:
        var_attrs["grid_mapping"] = gm_var_name
    if scale_factor is not None:
        var_attrs["scale_factor"] = scale_factor
    if offset is not None:
        var_attrs["add_offset"] = offset
    var_f = nc.create_variable(
        var_name, dims, dtype=datatype, fill_value=fill_value,
        complevel=complevel, attrs=var_attrs,
    )

    return {
        "method": "netcdf",
        "ncfile": nc,
        "var_F": var_f,
        "var_name": var_name,
        "var_dims": dims,
        "scale_factor": scale_factor,
        "offset": offset,
        "startdate": startdate,
        "timestep": timestep,
        "timesteps": timesteps_list if timesteps_list is not None else n_timesteps,
        "metadata": metadata,
        "incremental": incremental,
        "num_timesteps": num_timesteps,
        "num_ens_members": n_ens_members if n_ens_members else 1,
        "shape": tuple(shape),
        "timestep_index": 0,
        "member_index": 0,
    }


def initialize_forecast_exporter_npz(
    outpath, outfnprefix, startdate, timestep, n_timesteps, shape, metadata,
    n_ens_members=1, datatype=np.float32, incremental=None, **kwargs,
):
    """NPZ exporter: buffers in memory, writes one compressed file."""
    if incremental not in (None, "timestep", "member"):
        raise ValueError(f"unknown incremental mode {incremental}")
    os.makedirs(outpath, exist_ok=True)
    return {
        "method": "npz",
        "fname": os.path.join(outpath, f"{outfnprefix}.npz"),
        "buffer": np.full(
            (n_ens_members, n_timesteps) + tuple(shape), np.nan, dtype=datatype
        ),
        "num_timesteps": n_timesteps,
        "num_ens_members": n_ens_members,
        "shape": tuple(shape),
        "metadata": metadata,
        "startdate": startdate,
        "timestep": timestep,
        "incremental": incremental,
        "timestep_index": 0,
        "member_index": 0,
    }


def initialize_forecast_exporter_geotiff(
    outpath, outfnprefix, startdate, timestep, n_timesteps, shape, metadata,
    n_ens_members=1, incremental=None, **kwargs,
):
    """GeoTIFF exporter (reference: io/exporters.py:125-240): one file per
    lead time named '<outfnprefix>_<startdate:%Y%m%d%H%M>_<leadtime>.tif'
    with one float32 band per ensemble member.  Written by the built-in
    TIFF encoder (:mod:`pysteps_tpu_torch.io._geotiff_write`) instead of GDAL."""
    if len(shape) != 2:
        raise ValueError("shape has %d elements, 2 expected" % len(shape))
    if incremental == "member":
        raise ValueError(
            "incremental writing of GeoTIFF files with"
            " the 'member' option is not supported"
        )
    os.makedirs(outpath, exist_ok=True)
    return {
        "method": "geotiff",
        "outpath": outpath,
        "outfnprefix": outfnprefix,
        "startdate": startdate,
        "timestep": timestep,
        "num_timesteps": n_timesteps,
        "num_ens_members": n_ens_members,
        "shape": tuple(shape),
        "metadata": metadata,
        "incremental": incremental,
        "timestep_index": 0,
        "member_index": 0,
    }


def _geotiff_filename(exporter, i):
    lead = (i + 1) * exporter["timestep"]
    stamp = exporter["startdate"].strftime("%Y%m%d%H%M")
    return os.path.join(
        exporter["outpath"],
        f"{exporter['outfnprefix']}_{stamp}_{lead:03d}.tif",
    )


def initialize_forecast_exporter_kineros(
    outpath, outfnprefix, startdate, timestep, n_timesteps, shape, metadata,
    n_ens_members=1, incremental=None, **kwargs,
):
    """Kineros2 rainfall-input text exporter (reference: io/exporters.py:241).

    Every grid point becomes an individual rain gauge ("RG") element; one
    ``<prefix>_N<member>.pre`` file is written per ensemble member, each
    containing a per-element TIME/INTENSITY (mm/h) or TIME/DEPTH (mm,
    cumulative) series — reference ``_export_kineros``
    (io/exporters.py:832-863).
    """
    if incremental is not None:
        raise ValueError("kineros: incremental writing is not supported")
    os.makedirs(outpath, exist_ok=True)
    n_ens_members = int(min(99, n_ens_members))
    h, w = shape

    unit = metadata.get("unit", "mm/h")
    if unit == "mm/h":
        var_name, var_unit = "Intensity", "mm/hr"
    elif unit == "mm":
        var_name, var_unit = "Depth", "mm"
    else:
        raise ValueError(f"kineros: unsupported unit {unit}")

    # gauge coordinates: cell centres on the metadata grid
    xr = np.linspace(metadata["x1"], metadata["x2"], w + 1)[:-1]
    xr += 0.5 * (xr[1] - xr[0])
    yr = np.linspace(metadata["y1"], metadata["y2"], h + 1)[:-1]
    yr += 0.5 * (yr[1] - yr[0])
    xy_coords = np.stack(np.meshgrid(xr, yr))

    fns = []
    for i in range(n_ens_members):
        fn = os.path.join(outpath, f"{outfnprefix}_N{i:02d}.pre")
        with open(fn, "w") as fd:
            fd.write("! pysteps_tpu_torch-generated nowcast.\n")
            fd.write(f"! Member = {i:02d}.\n")
            fd.write(f"! Startdate = {startdate.strftime('%c')}.\n")
        fns.append(fn)

    return {
        "method": "kineros",
        "outpath": outpath,
        "outfnprefix": outfnprefix,
        "ncfile": fns,
        "XY_coords": xy_coords,
        "var_name": var_name,
        "var_unit": var_unit,
        "num_timesteps": n_timesteps,
        "num_ens_members": n_ens_members,
        "shape": tuple(shape),
        "metadata": metadata,
        "startdate": startdate,
        "timestep": timestep,
        "fields": [],
        "incremental": None,
        "timestep_index": 0,
        "member_index": 0,
    }


def export_forecast_dataset(field, exporter):
    """Write a (ens, t, m, n), (t, m, n), (ens, m, n) or (m, n) block
    depending on the incremental mode (reference: io/exporters.py:666).
    A tensor is read back to the host here, once."""
    field = to_numpy(field)
    inc = exporter["incremental"]
    shape = exporter["shape"]

    if inc is None:
        if exporter["num_ens_members"] > 1:
            expected = (exporter["num_ens_members"], exporter["num_timesteps"]) + shape
        else:
            expected = (exporter["num_timesteps"],) + shape
            field = field[None] if field.shape == expected else field
        if field.ndim == 3:
            field = field[None]
        _write_block(exporter, field, slice(None), slice(None))
    elif inc == "timestep":
        t = exporter["timestep_index"]
        if field.ndim == 2:
            field = field[None]
        _write_block(exporter, field[:, None], slice(None), slice(t, t + 1))
        exporter["timestep_index"] = t + 1
    elif inc == "member":
        j = exporter["member_index"]
        _write_block(exporter, field[None], slice(j, j + 1), slice(None))
        exporter["member_index"] = j + 1


def _write_block(exporter, block, ens_slice, time_slice):
    block = to_numpy(block)
    if exporter["method"] == "hdf5":
        exporter["dataset"][ens_slice, time_slice] = block
    elif exporter["method"] == "npz":
        exporter["buffer"][ens_slice, time_slice] = block
    elif exporter["method"] == "kineros":
        exporter["fields"].append(np.array(block))
    elif exporter["method"] == "netcdf":
        _write_block_netcdf(exporter, block, ens_slice, time_slice)
    elif exporter["method"] == "geotiff":
        _write_block_geotiff(exporter, block, time_slice)


def _write_block_netcdf(exporter, block, ens_slice, time_slice):
    nc, var = exporter["ncfile"], exporter["var_F"]
    block = np.asarray(block)
    # pack if scale_factor/add_offset are set (netCDF4-python convention:
    # stored = (value - add_offset) / scale_factor)
    if exporter["scale_factor"] is not None or exporter["offset"] is not None:
        scale = exporter["scale_factor"] or 1.0
        off = exporter["offset"] or 0.0
        block = (block - off) / scale
        if np.issubdtype(var.dtype, np.integer):
            block = np.round(block)
    dims = exporter["var_dims"]
    has_ens = dims[0] == "ens_number"
    inc = exporter["incremental"]
    if inc == "timestep":
        t = exporter["timestep_index"]
        nc.grow(var, 1 if has_ens else 0, t + 1)
        timesteps = exporter["timesteps"]
        step_idx = timesteps[t] if isinstance(timesteps, list) else t + 1
        nc.set_coord("time", t, step_idx * exporter["timestep"] * 60)
    elif inc == "member":
        j = exporter["member_index"]
        nc.grow(var, 0, j + 1)
        nc.set_coord("ens_number", j, j + 1)
    if has_ens:
        var[ens_slice, time_slice] = block
    else:
        var[time_slice] = block[0]


def _write_block_geotiff(exporter, block, time_slice):
    from pysteps_tpu_torch.io._geotiff_write import write_geotiff

    block = np.asarray(block, np.float32)  # (ens, t, h, w)
    start = time_slice.start or 0
    for i in range(block.shape[1]):
        write_geotiff(
            _geotiff_filename(exporter, start + i),
            block[:, i],
            exporter["metadata"],
            nodata="nan",
        )


def close_forecast_files(exporter):
    """Finalize the exporter (reference: io/exporters.py:753)."""
    if exporter["method"] == "hdf5":
        exporter["file"].close()
    elif exporter["method"] == "netcdf":
        exporter["ncfile"].close()
    elif exporter["method"] == "geotiff":
        pass  # one self-contained file per lead time, already written
    elif exporter["method"] == "npz":
        np.savez_compressed(
            exporter["fname"],
            precip_forecast=exporter["buffer"],
            metadata=np.asarray(exporter["metadata"], dtype=object),
            startdate=str(exporter["startdate"]),
            timestep=exporter["timestep"],
        )
    elif exporter["method"] == "kineros":
        # per-element (gauge) series, one file per member
        # (reference: io/exporters.py:832-863)
        fields = np.concatenate(exporter["fields"], axis=1)  # (ens, t, h, w)
        n_t = exporter["num_timesteps"]
        timestep = exporter["timestep"]
        xgrid = exporter["XY_coords"][0].flatten()
        ygrid = exporter["XY_coords"][1].flatten()
        timemin = [(t + 1) * timestep for t in range(n_t)]
        for n in range(exporter["num_ens_members"]):
            series = fields[n].reshape((n_t, -1))
            if exporter["var_name"] == "Depth":
                series = np.cumsum(series, axis=0)
            with open(exporter["ncfile"][n], "a") as fd:
                for m in range(series.shape[1]):
                    fd.write("BEGIN RG%03d\n" % (m + 1))
                    fd.write("  X = %.2f, Y = %.2f\n" % (xgrid[m], ygrid[m]))
                    fd.write("  N = %i\n" % n_t)
                    fd.write("  TIME        %s\n" % exporter["var_name"].upper())
                    fd.write("! (min)        (%s)\n" % exporter["var_unit"])
                    for t in range(n_t):
                        fd.write("{:6.1f}  {:11.2f}\n".format(timemin[t], series[t, m]))
                    fd.write("END\n\n")
