from pysteps_tpu_torch.io import archive, exporters, importers, nowcast_importers  # noqa: F401
from pysteps_tpu_torch.io.exporters import (  # noqa: F401
    close_forecast_files,
    export_forecast_dataset,
    initialize_forecast_exporter_hdf5,
    initialize_forecast_exporter_kineros,
    initialize_forecast_exporter_netcdf,
    initialize_forecast_exporter_npz,
)
from pysteps_tpu_torch.io.interface import get_method  # noqa: F401
from pysteps_tpu_torch.io.readers import read_timeseries  # noqa: F401
