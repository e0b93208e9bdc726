"""
Visualization utilities (reference: pysteps/visualization/utils.py:80,107,189,
282,403): PROJ.4 parsing, cartopy CRS construction, geodata reprojection and
the geogrid/basemap-axis helpers used by every plot function.

parse_proj4_string here is a dependency-free tokenizer (the reference routes
through pyproj.Proj(...).crs.to_dict()); cartopy/pyproj-backed functions are
gated behind MissingOptionalDependency like the reference.
"""

import numpy as np

from pysteps_tpu_torch.exceptions import MissingOptionalDependency

try:
    import cartopy.crs as ccrs

    CARTOPY_IMPORTED = True
except ImportError:
    CARTOPY_IMPORTED = False
    ccrs = None

try:
    import pyproj

    PYPROJ_IMPORTED = True
except ImportError:
    PYPROJ_IMPORTED = False

# +proj value -> cartopy CRS class name (reference: visualization/utils.py:29-42)
_PROJ_TO_CARTOPY_NAME = {
    "tmerc": "TransverseMercator",
    "laea": "LambertAzimuthalEqualArea",
    "lcc": "LambertConformal",
    "merc": "Mercator",
    "utm": "UTM",
    "stere": "Stereographic",
    "aea": "AlbersEqualArea",
    "aeqd": "AzimuthalEquidistant",
    # cartopy's epsg(2056) bounds are too strict for somerc; stereographic is
    # the conventional stand-in (reference: visualization/utils.py:37-40)
    "somerc": "Stereographic",
    "geos": "Geostationary",
}

_PROJ_KW_TO_CARTOPY = {
    "lon_0": "central_longitude",
    "lat_0": "central_latitude",
    "lat_ts": "true_scale_latitude",
    "x_0": "false_easting",
    "y_0": "false_northing",
    "k": "scale_factor",
    "zone": "zone",
}

_GLOBE_KW_TO_CARTOPY = {
    "a": "semimajor_axis",
    "b": "semiminor_axis",
    "datum": "datum",
    "ellps": "ellipse",
    "f": "flattening",
    "rf": "inverse_flattening",
}


def parse_proj4_string(proj4str):
    """Parse a PROJ.4 projection string into a {key: value} dict
    (reference: visualization/utils.py:80-104).

    Values are converted to int/float where possible; bare flags (e.g.
    ``+no_defs``) map to True.
    """
    out = {}
    for token in proj4str.split():
        if not token.startswith("+"):
            continue
        token = token[1:]
        if "=" in token:
            key, _, value = token.partition("=")
            for cast in (int, float):
                try:
                    value = cast(value)
                    break
                except ValueError:
                    continue
            out[key] = value
        else:
            out[token] = True
    return out


def proj4_to_cartopy(proj4str):
    """Convert a PROJ.4 string to a cartopy CRS object
    (reference: visualization/utils.py:107-186)."""
    if not CARTOPY_IMPORTED:
        raise MissingOptionalDependency(
            "cartopy required for proj4_to_cartopy but not installed"
        )

    proj_dict = parse_proj4_string(proj4str)
    proj_name = proj_dict.get("proj", "longlat")
    if proj_name in ("longlat", "latlong", "lonlat", "latlon"):
        return ccrs.PlateCarree()

    if proj_name not in _PROJ_TO_CARTOPY_NAME:
        raise ValueError(f"Unsupported projection: {proj_name}")
    crs_cls = getattr(ccrs, _PROJ_TO_CARTOPY_NAME[proj_name])

    crs_kwargs = {}
    globe_kwargs = {}
    for key, value in proj_dict.items():
        if key in _PROJ_KW_TO_CARTOPY:
            crs_kwargs[_PROJ_KW_TO_CARTOPY[key]] = value
        elif key in _GLOBE_KW_TO_CARTOPY:
            globe_kwargs[_GLOBE_KW_TO_CARTOPY[key]] = value
    if "lat_1" in proj_dict and "lat_2" in proj_dict:
        crs_kwargs["standard_parallels"] = (proj_dict["lat_1"], proj_dict["lat_2"])
    if "R" in proj_dict:
        globe_kwargs["semimajor_axis"] = proj_dict["R"]
        globe_kwargs["semiminor_axis"] = proj_dict["R"]

    globe = ccrs.Globe(**globe_kwargs) if globe_kwargs else None
    if crs_cls is ccrs.Mercator:
        crs_kwargs.pop("false_easting", None)
        crs_kwargs.pop("false_northing", None)
    return crs_cls(globe=globe, **crs_kwargs)


def reproject_geodata(geodata, t_proj4str, return_grid=None):
    """Reproject a geodata dict to a new projection; optionally return the
    projected grid coordinates (reference: visualization/utils.py:189-279)."""
    if not PYPROJ_IMPORTED:
        raise MissingOptionalDependency(
            "pyproj required for reproject_geodata but not installed"
        )

    geodata = geodata.copy()
    x1, x2 = geodata["x1"], geodata["x2"]
    y1, y2 = geodata["y1"], geodata["y2"]
    shape = (
        int((y2 - y1) / geodata["ypixelsize"]),
        int((x2 - x1) / geodata["xpixelsize"]),
    )
    transformer = pyproj.Transformer.from_crs(
        pyproj.CRS.from_proj4(geodata["projection"]),
        pyproj.CRS.from_proj4(t_proj4str),
        always_xy=True,
    )

    if return_grid is not None:
        if return_grid == "coords":
            # cell centres
            y_coord = np.linspace(y1, y2, shape[0], endpoint=False)
            y_coord += geodata["ypixelsize"] / 2.0
            x_coord = np.linspace(x1, x2, shape[1], endpoint=False)
            x_coord += geodata["xpixelsize"] / 2.0
        elif return_grid == "quadmesh":
            # cell corners
            y_coord = np.linspace(y1, y2, shape[0] + 1)
            x_coord = np.linspace(x1, x2, shape[1] + 1)
        else:
            raise ValueError(f"unknown return_grid value {return_grid}")
        x_grid, y_grid = np.meshgrid(x_coord, y_coord)
        gx, gy = transformer.transform(x_grid.ravel(), y_grid.ravel())
        geodata["X_grid"] = gx.reshape(x_grid.shape)
        geodata["Y_grid"] = gy.reshape(y_grid.shape)

    x1t, y1t = transformer.transform(x1, y1)
    x2t, y2t = transformer.transform(x2, y2)
    geodata.update(
        projection=t_proj4str,
        x1=x1t,
        x2=x2t,
        y1=y1t,
        y2=y2t,
        regular_grid=False,
        xpixelsize=None,
        ypixelsize=None,
    )
    return geodata


def get_geogrid(nlat, nlon, geodata=None):
    """Cell-centre coordinate grids + plot extent for a field
    (reference: visualization/utils.py:282-400).

    Returns (x_grid, y_grid, extent, regular_grid, origin); origin follows
    geodata["yorigin"] ("upper" when geodata is None).
    """
    if geodata is None:
        x_grid, y_grid = np.meshgrid(np.arange(nlon), np.arange(nlat))
        return x_grid, np.flipud(y_grid), (0, nlon - 1, 0, nlat - 1), True, "upper"

    x_lo, x_hi = sorted((geodata["x1"], geodata["x2"]))
    y_lo, y_hi = sorted((geodata["y1"], geodata["y2"]))
    x, xstep = np.linspace(x_lo, x_hi, nlon, endpoint=False, retstep=True)
    y, ystep = np.linspace(y_lo, y_hi, nlat, endpoint=False, retstep=True)
    x_grid, y_grid = np.meshgrid(x + xstep / 2.0, y + ystep / 2.0)
    if geodata["yorigin"] == "upper":
        y_grid = np.flipud(y_grid)
    extent = (geodata["x1"], geodata["x2"], geodata["y1"], geodata["y2"])
    return x_grid, y_grid, extent, geodata.get("regular_grid", True), geodata["yorigin"]


def get_basemap_axis(extent, geodata=None, ax=None, map_kwargs=None):
    """Return a plotting axis; draw a cartopy basemap when geodata carries a
    projection and cartopy is available (reference: visualization/utils.py:403-456)."""
    import matplotlib.pyplot as plt

    from pysteps_tpu_torch.visualization import basemaps

    if map_kwargs is None:
        map_kwargs = {}

    geo_ok = (
        geodata is not None
        and geodata.get("projection") is not None
        and CARTOPY_IMPORTED
    )
    is_geoaxis = ax is not None and hasattr(ax, "projection")
    if geo_ok and not is_geoaxis:
        ax = basemaps.plot_geography(geodata["projection"], extent, **map_kwargs)
    elif ax is None:
        ax = plt.gca()
    return ax
