from pysteps_tpu_torch.extrapolation import semilagrangian  # noqa: F401
