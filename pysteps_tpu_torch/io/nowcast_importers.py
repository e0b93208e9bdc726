"""
Re-import framework-written forecasts
(reference: pysteps/io/nowcast_importers.py:85).
"""

import numpy as np

from pysteps_tpu_torch.exceptions import DataModelError

# CF variable name -> (unit, accutime, transform)
# (reference: io/nowcast_importers.py:128-156)
_CF_VARIABLES = {
    "precip_intensity": ("mm/h", None, None),
    "precip_accum": ("mm", None, None),
    "hourly_precip_accum": ("mm", 60.0, None),
    "reflectivity": ("dBZ", None, "dB"),
}


def import_netcdf_pysteps(filename, onerror="warn", **kwargs):
    """Import a forecast written by the NetCDF/HDF5/NPZ exporters.

    CF-1.7 ``.nc`` files follow the reference's read path
    (io/nowcast_importers.py:85-215): locate a known variable name,
    rebuild geodata from the x/y coordinate vectors, and recover the
    projection from the CF grid mapping (or the ``projection`` global
    attribute the exporter also writes).
    """
    onerror = onerror.lower()
    if onerror not in ("warn", "raise"):
        raise ValueError("'onerror' keyword must be 'warn' or 'raise'.")
    try:
        if filename.endswith(".npz"):
            data = np.load(filename, allow_pickle=True)
            precip = data["precip_forecast"]
            metadata = (
                data["metadata"].item() if "metadata" in data.files else {}
            )
            return precip, metadata
        import h5py

        if filename.endswith((".h5", ".hdf5")):
            with h5py.File(filename, "r") as f:
                precip = f["precip_forecast"][...]
                metadata = dict(f["metadata"].attrs) if "metadata" in f else {}
            return precip, metadata
        return _import_cf_netcdf(filename)
    except (OSError, KeyError, ValueError, DataModelError) as err:
        if onerror == "warn":
            print(f"error importing {filename}: {err}")
            return None, None
        raise


def _import_cf_netcdf(filename):
    from pysteps_tpu_torch.io._cfnetcdf import grid_mapping_to_proj4
    from pysteps_tpu_torch.io._netcdf import Dataset, num2date

    with Dataset(filename) as ds:
        var_name = next(
            (name for name in _CF_VARIABLES if name in ds.variables), None
        )
        if var_name is None:
            raise DataModelError(
                "Non CF compliant file: no supported variable name "
                f"({', '.join(_CF_VARIABLES)}) in {filename}"
            )
        unit, accutime, transform = _CF_VARIABLES[var_name]
        # _Variable.__getitem__ applies CF unpacking (scale_factor,
        # add_offset, _FillValue -> NaN), matching netCDF4's auto-scaling
        precip = np.asarray(ds.variables[var_name][...], float).squeeze()

        metadata = {}
        time_var = ds.variables["time"]
        seconds = np.asarray(time_var[:], float)
        metadata["leadtimes"] = seconds / 60.0
        metadata["timestamps"] = np.array(
            num2date(seconds, time_var.getncattr("units"))
        )

        projection = None
        for name, var in ds.variables.items():
            if "grid_mapping_name" in var.ncattrs():
                projection = grid_mapping_to_proj4(
                    {k: var.getncattr(k) for k in var.ncattrs()}
                )
                break
        if projection is None and "projection" in ds.ncattrs():
            projection = ds.getncattr("projection") or None
        if projection:
            metadata["projection"] = projection

        x = np.asarray(ds.variables["x"][:], float)
        y = np.asarray(ds.variables["y"][:], float)
        metadata["xpixelsize"] = abs(x[1] - x[0])
        metadata["ypixelsize"] = abs(y[1] - y[0])
        metadata["x1"] = x.min() - 0.5 * metadata["xpixelsize"]
        metadata["x2"] = x.max() + 0.5 * metadata["xpixelsize"]
        metadata["y1"] = y.min() - 0.5 * metadata["ypixelsize"]
        metadata["y2"] = y.max() + 0.5 * metadata["ypixelsize"]
        metadata["yorigin"] = "upper" if len(y) > 1 and y[0] > y[-1] else "lower"
        metadata["cartesian_unit"] = (
            ds.variables["x"].getncattr("units")
            if "units" in ds.variables["x"].ncattrs()
            else "m"
        )

        if accutime is None and metadata["leadtimes"].size > 1:
            accutime = metadata["leadtimes"][1] - metadata["leadtimes"][0]
        metadata["accutime"] = accutime
        metadata["unit"] = unit
        metadata["transform"] = transform
        metadata["zerovalue"] = np.nanmin(precip)
        wet = precip[precip > metadata["zerovalue"]]
        metadata["threshold"] = (
            np.nanmin(wet) if wet.size else metadata["zerovalue"]
        )
    return precip, metadata
