"""Lead loop: kernel-launch calls (runtime or driver, each once) made inside
the port's ``pst.loop`` span, a request and a lead, from the traced
requests."""

from benchmark.harness.spans import per_request


def read(ctx):
    return per_request(ctx, "launches", "pst.loop", leads=True)
