"""The STEPS nowcast of the port, ``nowcasts.get_method("steps")``, as a
benchmark entry: one call is one forecast request."""


def program(request, config, seed, device, measure_time=False, output_dtype="float32"):
    """The port's forecast of ``request``'s frames along its velocity (host
    numpy).  Returns (out (E, T, m, n), init s, loop s), the two seconds
    None unless ``measure_time``."""
    from pysteps_tpu_torch import nowcasts

    res = nowcasts.get_method("steps")(
        request["frames"], request["velocity"], int(config["leads"]), **config["kwargs"],
        seed=seed, measure_time=measure_time, output_dtype=output_dtype, device=device,
    )
    return res if measure_time else (res, None, None)
