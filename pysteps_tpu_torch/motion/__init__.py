from pysteps_tpu_torch.motion.interface import get_method  # noqa: F401
from pysteps_tpu_torch.motion.lucaskanade import dense_lucaskanade  # noqa: F401
