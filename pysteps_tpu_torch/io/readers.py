"""
Time-series reader (reference: pysteps/io/readers.py:17-80).
"""

import numpy as np


def read_timeseries(inputfns, importer, timestep=None, **kwargs):
    """Stack importer outputs into (T, m, n); missing files become
    all-NaN frames (reference: io/readers.py:17).

    Returns (precip, quality, metadata).
    """
    filenames, timestamps = inputfns
    template = None
    template_meta = None
    for fn in filenames:
        if fn is not None:
            template, _, template_meta = importer(fn, **kwargs)
            break
    if template is None:
        return None, None, None

    frames = []
    qualities = []
    threshold = np.inf
    for fn in filenames:
        if fn is None:
            frames.append(np.full(template.shape, np.nan, dtype=template.dtype))
            qualities.append(None)
            continue
        precip, quality, meta = importer(fn, **kwargs)
        frames.append(precip)
        qualities.append(quality)
        threshold = min(threshold, meta.get("threshold", np.inf))

    metadata = dict(template_meta)
    metadata["timestamps"] = np.asarray(timestamps)
    if np.isfinite(threshold):
        metadata["threshold"] = threshold
    quality_out = (
        np.stack([q for q in qualities]) if all(q is not None for q in qualities)
        else None
    )
    return np.stack(frames), quality_out, metadata
