"""Plugin-extensible forecast diagnostics (counterpart of
``pysteps_tpu/postprocessing/diagnostics.py``): empty by default, filled
by entry-point plugins of the port's own group, so that a plugin written
for the JAX package never loads here."""

ENTRY_POINT_GROUP = "pysteps_tpu_torch.plugins.diagnostics"

_diagnostics = {}


def add_diagnostic(name, function):
    """Register a diagnostic postprocessor."""
    if name in _diagnostics:
        raise ValueError(f"diagnostic {name} already registered")
    _diagnostics[name] = function


def get_diagnostic(name):
    try:
        return _diagnostics[name]
    except KeyError:
        raise ValueError(
            f"unknown diagnostic {name}; available: {list(_diagnostics)}"
        ) from None


def discover_diagnostics():
    """Load diagnostics from the :data:`ENTRY_POINT_GROUP` entry points
    (best effort: a plugin that fails to load is left out)."""
    try:
        from importlib import metadata as importlib_metadata

        for ep in importlib_metadata.entry_points(group=ENTRY_POINT_GROUP):
            _diagnostics[ep.name] = ep.load()
    except Exception:  # noqa: BLE001 — best-effort discovery
        pass


discover_diagnostics()
