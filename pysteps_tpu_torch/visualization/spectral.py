"""1-D power spectrum plot (reference: pysteps/visualization/spectral.py:18);
frequencies and powers may be numpy or torch tensors on any device."""

import matplotlib.pyplot as plt
import numpy as np

from pysteps_tpu_torch._device import to_numpy

def plot_spectrum1d(
    fft_freq,
    fft_power,
    x_units=None,
    y_units=None,
    wavelength_ticks=None,
    color="k",
    lw=1.0,
    label=None,
    ax=None,
    **kwargs,
):
    """Log-log radially averaged power spectrum plot
    (reference: visualization/spectral.py:18)."""
    if ax is None:
        ax = plt.gca()
    fft_freq = to_numpy(fft_freq)
    fft_power = to_numpy(fft_power)
    mask = fft_freq > 0
    ax.plot(
        10 * np.log10(fft_freq[mask]),
        10 * np.log10(fft_power[mask]),
        color=color, lw=lw, label=label,
    )
    ax.set_xlabel(f"10 log10(frequency){f' [{x_units}]' if x_units else ''}")
    ax.set_ylabel(f"10 log10(power){f' [{y_units}]' if y_units else ''}")
    if wavelength_ticks is not None:
        wavelength_ticks = np.asarray(wavelength_ticks, float)
        ticks = 10 * np.log10(1.0 / wavelength_ticks)
        ax.set_xticks(ticks)
        ax.set_xticklabels([f"{w:g}" for w in wavelength_ticks])
        ax.set_xlabel(f"wavelength{f' [{x_units}]' if x_units else ''}")
    if label:
        ax.legend()
    return ax
