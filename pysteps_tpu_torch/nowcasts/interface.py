"""Nowcast-method registry (counterpart of
``pysteps_tpu/nowcasts/interface.py``): every method of the JAX package's
registry."""

from pysteps_tpu_torch.nowcasts import (
    anvil,
    extrapolation,
    lagrangian_probability,
    linda,
    sprog,
    sseps,
    steps,
)


def _eulerian_forecast(precip, velocity, timesteps, **kwargs):
    from pysteps_tpu_torch.extrapolation.interface import eulerian_persistence

    return eulerian_persistence(precip, velocity, timesteps, **kwargs)


_nowcast_methods = {
    "eulerian": _eulerian_forecast,
    "extrapolation": extrapolation.forecast,
    "lagrangian": extrapolation.forecast,
    "lagrangian_probability": lagrangian_probability.forecast,
    "probability": lagrangian_probability.forecast,
    "sprog": sprog.forecast,
    "steps": steps.forecast,
    "anvil": anvil.forecast,
    "sseps": sseps.forecast,
    "linda": linda.forecast,
}


def get_method(name):
    """The forecast function registered under ``name``."""
    if name is None:
        raise ValueError("name is None")
    try:
        return _nowcast_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown nowcasting method {name}; available: {list(_nowcast_methods)}"
        ) from None
