"""
Shared decorators (reference: pysteps/decorators.py:44,112,153,253,288).
"""

import functools
import warnings

import numpy as np
import torch


def postprocess_import(fillna=np.nan, dtype="float32"):
    """Cast + fill importer outputs (reference: decorators.py:44)."""
    from pysteps_tpu_torch.io.importers import postprocess_import as _pp

    return _pp(fillna=fillna, dtype=dtype)


def check_input_frames(minimum_input_frames=2, maximum_input_frames=np.inf, just_ndim=False):
    """Validate motion-method inputs (reference: decorators.py:112)."""

    def wrap(motion_method):
        @functools.wraps(motion_method)
        def _motion(input_images, *args, **kwargs):
            # a tensor is read by its shape only: one on the card stays there
            if not isinstance(input_images, torch.Tensor):
                input_images = np.asarray(input_images)
            if input_images.ndim != 3:
                raise ValueError(
                    "input_images must be a three-dimensional (t, m, n) array"
                )
            if not just_ndim:
                n = input_images.shape[0]
                if n < minimum_input_frames:
                    raise ValueError(
                        f"need at least {minimum_input_frames} input frames, got {n}"
                    )
                if n > maximum_input_frames:
                    raise ValueError(
                        f"need at most {maximum_input_frames} input frames, got {n}"
                    )
            return motion_method(input_images, *args, **kwargs)

        return _motion

    return wrap


def prepare_interpolator(nchunks=4):
    """Grid chunking + trivial-case handling for interpolators
    (reference: decorators.py:153)."""

    def wrap(interpolator):
        @functools.wraps(interpolator)
        def _interpolator(xy_coord, values, xgrid, ygrid, **kwargs):
            if not isinstance(values, torch.Tensor):
                values = np.asarray(values)
            if values.ndim == 1:
                nvar = 1
            else:
                nvar = values.shape[1]
            # all values identical -> constant field; a tensor is compared
            # on its own device and only its first value is read back
            first = values.reshape(-1)[0]
            if isinstance(values, torch.Tensor):
                ref = first.expand_as(values)
                same = bool(torch.allclose(values.double(), ref.double()))
                first = float(first)
            else:
                same = np.allclose(values, first)
            if same:
                shape = (nvar, len(ygrid), len(xgrid))
                out = np.full(shape, first, dtype=float)
                return out[0] if values.ndim == 1 else out
            return interpolator(xy_coord, values, xgrid, ygrid, **kwargs)

        return _interpolator

    return wrap


def memoize(maxsize=10):
    """Hash-keyed LRU cache with array support (reference: decorators.py:253)."""

    def wrap(fn):
        cache = {}
        order = []

        @functools.wraps(fn)
        def _fn(*args, **kwargs):
            def keyify(v):
                if isinstance(v, np.ndarray):
                    return (v.shape, v.dtype.str, v.tobytes()[:256])
                if isinstance(v, torch.Tensor):
                    # the first 256 bytes, as for an array, and the device
                    head = v.detach().reshape(-1)[: max(1, 256 // v.element_size())]
                    raw = head.cpu().contiguous().view(torch.uint8).numpy()
                    return (tuple(v.shape), str(v.dtype), str(v.device), raw.tobytes())
                return v

            key = (
                tuple(keyify(a) for a in args),
                tuple(sorted((k, keyify(v)) for k, v in kwargs.items())),
            )
            try:
                hash(key)
            except TypeError:
                return fn(*args, **kwargs)
            if key in cache:
                return cache[key]
            out = fn(*args, **kwargs)
            cache[key] = out
            order.append(key)
            if len(order) > maxsize:
                cache.pop(order.pop(0), None)
            return out

        return _fn

    return wrap


def deprecate_args(old_new_args, deprecation_release):
    """Rename deprecated keyword arguments with a warning
    (reference: decorators.py:288)."""

    def wrap(fn):
        @functools.wraps(fn)
        def _fn(*args, **kwargs):
            for old, new in old_new_args.items():
                if old in kwargs:
                    warnings.warn(
                        f"argument {old} is deprecated since "
                        f"{deprecation_release}; use {new}",
                        DeprecationWarning,
                    )
                    kwargs.setdefault(new, kwargs.pop(old))
            return fn(*args, **kwargs)

        return _fn

    return wrap
