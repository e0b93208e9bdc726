"""Noise-generator registry (counterpart of
``pysteps_tpu/noise/interface.py``): each name maps to its pair
(initializer, generator)."""

from pysteps_tpu_torch.noise import fftgenerators, motion

_noise_methods = {
    "parametric": (
        fftgenerators.initialize_param_2d_fft_filter,
        fftgenerators.generate_noise_2d_fft_filter,
    ),
    "nonparametric": (
        fftgenerators.initialize_nonparam_2d_fft_filter,
        fftgenerators.generate_noise_2d_fft_filter,
    ),
    "ssft": (
        fftgenerators.initialize_nonparam_2d_ssft_filter,
        fftgenerators.generate_noise_2d_ssft_filter,
    ),
    "nested": (
        fftgenerators.initialize_nonparam_2d_nested_filter,
        fftgenerators.generate_noise_2d_ssft_filter,
    ),
    "bps": (motion.initialize_bps, motion.generate_bps),
}


def get_method(name):
    if name is None:
        raise ValueError("name is None")
    try:
        return _noise_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown noise method {name}; available: {list(_noise_methods)}"
        ) from None
