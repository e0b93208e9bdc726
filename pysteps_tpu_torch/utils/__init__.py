from pysteps_tpu_torch.utils import (  # noqa: F401
    arrays,
    check_norain,
    cleansing,
    conversion,
    images,
    interpolate,
    pca,
    spectral,
    tapering,
    transformation,
)
