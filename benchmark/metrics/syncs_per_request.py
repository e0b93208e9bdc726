"""Host-blocking calls a request made inside the port's ``pst.`` spans: every
``*Synchronize`` and every memcpy that is not asynchronous (each once),
from the traced requests."""

from benchmark.harness.spans import of


def read(ctx):
    sp = of(ctx)
    if not sp or not sp["requests"] or not sp["span_n"]:
        return None
    return sum(sp["syncs"].values()) / sp["requests"]
