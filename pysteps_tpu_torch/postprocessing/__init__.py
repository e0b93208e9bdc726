from pysteps_tpu_torch.postprocessing import probmatching  # noqa: F401
