"""Post-processing registry (counterpart of
``pysteps_tpu/postprocessing/interface.py``)."""

from pysteps_tpu_torch.postprocessing import diagnostics, ensemblestats, probmatching

_postprocessing_methods = {
    "ensemblestats.mean": ensemblestats.mean,
    "ensemblestats.excprob": ensemblestats.excprob,
    "ensemblestats.banddepth": ensemblestats.banddepth,
    "probmatching.nonparam_match_empirical_cdf": probmatching.nonparam_match_empirical_cdf,
    "probmatching.pmm": probmatching.pmm_compute,
}

_diagnostics_methods = diagnostics._diagnostics
discover_postprocessors = diagnostics.discover_diagnostics


def print_postprocessors_info(module_name, interface_methods, module_methods):
    """Print which post-processors a module provides and which the
    interface registers."""
    print(f"\nPostprocessors available in the {module_name} module")
    for name in sorted(module_methods):
        print(f"  {name}")
    print("\nPostprocessors available in the interface")
    for name in sorted(interface_methods):
        print(f"  {name}")


def postprocessors_info():
    """Print every post-processor, module against interface; returns both
    sets."""
    module_methods = sorted(
        {n.split(".", 1)[1] for n in _postprocessing_methods} | set(_diagnostics_methods)
    )
    interface_methods = sorted(_postprocessing_methods) + sorted(_diagnostics_methods)
    print_postprocessors_info("pysteps_tpu_torch.postprocessing", interface_methods,
                              module_methods)
    return set(module_methods), set(interface_methods)


def add_postprocessor(name, function, _methods=None):
    """Register an external post-processor."""
    table = _methods if _methods is not None else _postprocessing_methods
    if name in table:
        raise ValueError(f"postprocessor {name} already registered")
    table[name] = function


def get_method(name):
    try:
        return _postprocessing_methods[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown postprocessing method {name}; "
            f"available: {list(_postprocessing_methods)}"
        ) from None
