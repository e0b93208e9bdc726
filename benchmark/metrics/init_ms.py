"""Init: the port's ``measure_time`` init seconds a forecast, ms (alignment,
decomposition, AR fit, noise filter, BPS draws, the first mask)."""

from benchmark.metrics import mean_of


def read(ctx):
    v = mean_of(ctx, "init_s")
    return None if v is None else 1e3 * v
