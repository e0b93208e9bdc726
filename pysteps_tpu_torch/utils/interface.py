"""String registry for utility methods (counterpart of
``pysteps_tpu/utils/interface.py``; reference:
pysteps/utils/interface.py:28,182-243): the JAX package's name table."""

from pysteps_tpu_torch.utils import (
    arrays,
    cleansing,
    conversion,
    dimension,
    fft,
    images,
    interpolate,
    pca,
    spectral,
    tapering,
    transformation,
)


def donothing(R, metadata=None, *args, **kwargs):
    """A copy of ``R`` (a tensor's clone, an array's copy) and ``metadata``."""
    copy = getattr(R, "clone", None) or getattr(R, "copy", None)
    return (copy() if copy else R), metadata


_methods = {
    "none": donothing,
    # arrays
    "centred_coord": arrays.compute_centred_coord_array,
    # cleansing
    "decluster": cleansing.decluster,
    "detect_outliers": cleansing.detect_outliers,
    # conversion
    "mm/h": conversion.to_rainrate,
    "rainrate": conversion.to_rainrate,
    "mm": conversion.to_raindepth,
    "raindepth": conversion.to_raindepth,
    "dbz": conversion.to_reflectivity,
    "reflectivity": conversion.to_reflectivity,
    # dimension
    "accumulate": dimension.aggregate_fields_time,
    "clip": dimension.clip_domain,
    "square": dimension.square_domain,
    "upscale": dimension.aggregate_fields_space,
    # images
    "morph_opening": images.morph_opening,
    # interpolation
    "rbfinterp2d": interpolate.rbfinterp2d,
    "idwinterp2d": interpolate.idwinterp2d,
    # pca
    "pca_transform": pca.pca_transform,
    "pca_backtransform": pca.pca_backtransform,
    # spectral
    "rapsd": spectral.rapsd,
    "rm_rdisc": spectral.remove_rain_norain_discontinuity,
    # tapering
    "compute_mask_window_function": tapering.compute_mask_window_function,
    "compute_window_function": tapering.compute_window_function,
    # transformation
    "boxcox": transformation.boxcox_transform,
    "box-cox": transformation.boxcox_transform,
    "db": transformation.dB_transform,
    "decibel": transformation.dB_transform,
    "log": transformation.boxcox_transform,
    "nqt": transformation.NQ_transform,
    "sqrt": transformation.sqrt_transform,
}


def get_method(name, **kwargs):
    """Resolve a utility method by name.  FFT backend names ("numpy",
    "scipy", "pyfftw") all resolve to the ``torch.fft`` namespace and need
    a ``shape`` kwarg (reference: utils/interface.py:240)."""
    if name is None:
        name = "none"
    name = name.lower()
    if name in ("numpy", "scipy", "pyfftw"):
        if "shape" not in kwargs:
            raise KeyError("mandatory keyword argument shape not given")
        return fft.get_fft(**kwargs)
    try:
        return _methods[name]
    except KeyError:
        raise ValueError(
            f"Unknown method {name}\nSupported methods: {list(_methods)}"
        ) from None
