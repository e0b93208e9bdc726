"""Build the native decoder library with the system toolchain.

The library builds into ``build/pysteps_tpu_torch/`` beside the package
(the repo's ``build/``, which git ignores), named by a digest of the
sources and flags, so that an edited source builds a new library.
Run ``python -m pysteps_tpu_torch.native.build`` to build it verbosely.
"""

import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = [_DIR / "decoders.cpp", _DIR / "grib2.cpp"]
BUILD_DIR = _DIR.parents[1] / "build" / "pysteps_tpu_torch"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-fopenmp"]


def lib_path():
    """Where the library of the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in SOURCES:
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libpst_native_{digest.hexdigest()[:16]}.so"


def build(force=False, verbose=False):
    """Compile the native sources into the shared library; returns its
    path, or None where the toolchain fails.  Concurrent builds each
    compile into a directory of their own and rename into place."""
    path = lib_path()
    if path.exists() and not force:
        return str(path)
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp_lib = Path(tmp) / path.name
            subprocess.run(["g++", *FLAGS, *map(str, SOURCES), "-o", str(tmp_lib), "-lz"],
                           check=True, capture_output=not verbose)
            os.replace(tmp_lib, path)
        return str(path)
    except (subprocess.CalledProcessError, OSError) as err:
        if verbose:
            print(f"native build failed: {err}", file=sys.stderr)
        return None


if __name__ == "__main__":
    built = build(force=True, verbose=True)
    print(built or "build failed")
