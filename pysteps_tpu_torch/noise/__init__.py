from pysteps_tpu_torch.noise import fftgenerators, motion, utils  # noqa: F401
from pysteps_tpu_torch.noise.interface import get_method  # noqa: F401
