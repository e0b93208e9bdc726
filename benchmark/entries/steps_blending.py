"""STEPS blending of the port, ``blending.get_method("steps")``, as a
benchmark entry: the nowcast handing over to one NWP model, one call a
forecast request.  The NWP fields move along the radar's flow.  The skill
directory holds no file (it is never made), so every request regresses the
NWP skill towards the default climatology and none reads what another
left."""

import os

SKILL_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "benchmark_cache", "no_skill_files")


def program(request, config, seed, device, measure_time=False, output_dtype="float32"):
    """The port's blended forecast of ``request``'s frames and NWP fields
    (host numpy).  Returns (out (E, T, m, n), init s, loop s), the two
    seconds None unless ``measure_time``."""
    from pysteps_tpu_torch import blending

    velocity = request["velocity"]
    res = blending.get_method("steps")(
        request["frames"], request["nwp"], velocity, velocity[None], int(config["leads"]),
        float(config["timestep"]), **config["kwargs"], seed=seed,
        outdir_path_skill=SKILL_DIR, measure_time=measure_time, output_dtype=output_dtype,
        device=device,
    )
    return res if measure_time else (res, None, None)
