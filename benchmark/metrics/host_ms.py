"""Host gate: the forecast call's wall less the port's own init and loop
seconds (``measure_time``), ms a forecast: input checks, ``check_norain``,
host numpy copies and the transfer of the inputs."""

from benchmark.metrics import mean_of


def read(ctx):
    wall, init, loop = (mean_of(ctx, k) for k in ("latency_s", "init_s", "loop_s"))
    if None in (wall, init, loop):
        return None
    return 1e3 * (wall - init - loop)
