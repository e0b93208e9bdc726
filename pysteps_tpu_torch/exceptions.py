"""The port's exceptions (counterpart of ``pysteps_tpu/exceptions.py``)."""


class MissingOptionalDependency(Exception):
    """Raised when an optional dependency is needed but not found."""


class DataModelError(Exception):
    """Raised when a file does not conform to the expected data model."""


class DirectoryNotEmpty(Exception):
    """Raised when a directory that must be empty is not."""
