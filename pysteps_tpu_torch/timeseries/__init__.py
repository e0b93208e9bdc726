from pysteps_tpu_torch.timeseries import autoregression, correlation  # noqa: F401
