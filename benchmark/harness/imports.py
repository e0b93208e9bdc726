"""The check that nothing of JAX, nor the JAX package, is loaded: module
names are compared by their top-level name (before the first dot) as a
whole, so ``pysteps_tpu_torch`` is not ``pysteps_tpu``."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pysteps_tpu")


def forbidden_loaded(modules=None):
    """The sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
