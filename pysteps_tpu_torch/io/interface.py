"""IO registry + entry-point plugin discovery
(reference: pysteps/io/interface.py:22-79,132)."""

from pysteps_tpu_torch.io import exporters, importers

# the port's own plugin group, so that a plugin written for the JAX package
# never loads here
ENTRY_POINT_GROUP = "pysteps_tpu_torch.plugins.importers"

_importer_methods = {
    "fmi_pgm": importers.import_fmi_pgm,
    "mch_gif": importers.import_mch_gif,
    "knmi_hdf5": importers.import_knmi_hdf5,
    "odim_hdf5": importers.import_odim_hdf5,
    "opera_hdf5": importers.import_opera_hdf5,
    "mch_hdf5": importers.import_mch_hdf5,
    "dwd_hdf5": importers.import_dwd_hdf5,
    "dwd_radolan": importers.import_dwd_radolan,
    "npz": importers.import_npz,
    "mrms_grib": importers.import_mrms_grib,
    "bom_rf3": importers.import_bom_rf3,
    "fmi_geotiff": importers.import_fmi_geotiff,
    "saf_crri": importers.import_saf_crri,
    # gated (proprietary metranet library, gated in the reference too)
    "mch_metranet": importers.import_mch_metranet,
}

_exporter_methods = {
    "hdf5": exporters.initialize_forecast_exporter_hdf5,
    "netcdf": exporters.initialize_forecast_exporter_netcdf,
    "npz": exporters.initialize_forecast_exporter_npz,
    "geotiff": exporters.initialize_forecast_exporter_geotiff,
    "kineros": exporters.initialize_forecast_exporter_kineros,
}


def discover_importers():
    """Load importer plugins from the :data:`ENTRY_POINT_GROUP` entry
    points (reference: io/interface.py:45-79)."""
    try:
        from importlib import metadata as importlib_metadata

        for ep in importlib_metadata.entry_points(group=ENTRY_POINT_GROUP):
            _importer_methods[ep.name.replace("importer_", "")] = ep.load()
    except Exception:  # noqa: BLE001 — plugin discovery is best-effort
        pass


def get_method(name, method_type):
    """Resolve an importer or exporter by name
    (reference: io/interface.py:132)."""
    if method_type == "importer":
        table = _importer_methods
    elif method_type == "exporter":
        table = _exporter_methods
    else:
        raise ValueError(
            f"unknown method type {method_type}; must be 'importer' or 'exporter'"
        )
    name = name.lower()
    try:
        return table[name]
    except KeyError:
        raise ValueError(
            f"unknown {method_type} {name}; available: {list(table)}"
        ) from None


def importers_info():
    """Print the importers available in the module and in the registry
    (reference: io/interface.py:82-129).  Returns both name lists."""
    from pprint import pprint

    module_importers = [n for n in dir(importers) if n.startswith("import_")]
    print("\nImporters available in the pysteps_tpu_torch.io.importers module")
    pprint(module_importers)

    registered = [f.__name__ for f in _importer_methods.values()]
    print("\nImporters available in the pysteps_tpu_torch.io.get_method interface")
    pprint([(name, f.__name__) for name, f in _importer_methods.items()])
    return module_importers, registered


discover_importers()
