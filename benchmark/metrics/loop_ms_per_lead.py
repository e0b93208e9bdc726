"""The lead loop: the port's ``measure_time`` loop seconds a forecast over
its leads, ms a lead."""

from benchmark.metrics import mean_of


def read(ctx):
    v = mean_of(ctx, "loop_s")
    return None if v is None else 1e3 * v / ctx["T"]
