"""The most device memory allocated during the window
(``torch.cuda.max_memory_allocated``, reset when the window starts), GiB."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
