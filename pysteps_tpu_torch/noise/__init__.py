from pysteps_tpu_torch.noise import fftgenerators, motion  # noqa: F401
