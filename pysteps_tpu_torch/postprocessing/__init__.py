from pysteps_tpu_torch.postprocessing import ensemblestats, probmatching  # noqa: F401
from pysteps_tpu_torch.postprocessing.interface import (  # noqa: F401
    add_postprocessor,
    get_method,
)
