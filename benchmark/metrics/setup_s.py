"""Seconds from the process's start to the window's: imports, the CUDA
context, the kernels loaded from ``build/`` (built there by nvcc on a first
run), the request pool made from the seed and two warm-up requests."""


def read(ctx):
    return ctx["setup_s"]
