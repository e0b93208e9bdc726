from pysteps_tpu_torch.cascade import bandpass_filters, decomposition  # noqa: F401
from pysteps_tpu_torch.cascade.interface import get_method  # noqa: F401
