from pysteps_tpu_torch.feature import shitomasi  # noqa: F401
