"""
Filename-pattern archive browsing (reference: pysteps/io/archive.py:19-136).
"""

import fnmatch
import os
from datetime import datetime, timedelta


def find_by_date(
    date,
    root_path,
    path_fmt,
    fn_pattern,
    fn_ext,
    timestep,
    num_prev_files=0,
    num_next_files=0,
    silent=False,
):
    """Find archive files around a date by strftime patterns
    (reference: io/archive.py:19).

    Returns (filenames, timestamps); missing files yield None entries.
    """
    filenames = []
    timestamps = []
    for i in range(num_prev_files + num_next_files + 1):
        t = date + timedelta(
            minutes=timestep * (i - num_prev_files)
        )
        fn = _find_matching_filename(t, root_path, path_fmt, fn_pattern, fn_ext)
        if fn is None and not silent:
            print(f"no input data found for {t}")
        filenames.append(fn)
        timestamps.append(t)
    return filenames, timestamps


def _find_matching_filename(date, root_path, path_fmt, fn_pattern, fn_ext):
    path = os.path.join(root_path, datetime.strftime(date, path_fmt))
    fn = datetime.strftime(date, fn_pattern) + "." + fn_ext
    full = os.path.join(path, fn)
    if os.path.exists(full):
        return full
    # wildcard support in the pattern
    if "*" in fn or "?" in fn:
        if os.path.isdir(path):
            for cand in sorted(os.listdir(path)):
                if fnmatch.fnmatch(cand, fn):
                    return os.path.join(path, cand)
    return None
