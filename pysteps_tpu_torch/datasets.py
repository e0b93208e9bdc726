"""
Example-data handling (reference: pysteps/datasets.py:286,337,409).

The reference downloads the pysteps-data archives from GitHub.  In
zero-egress environments that path is gated; ``create_synthetic_dataset``
provides a local stand-in with the same (precip, metadata) contract so
examples and tests run offline.
"""

import os

import numpy as np

from pysteps_tpu_torch.exceptions import MissingOptionalDependency

_EVENT_TABLE = {
    # case name -> (source, shape, n_frames) — mirrors the reference's event
    # table (datasets.py:38-49) with synthetic stand-ins
    "fmi": ("fmi", (512, 512), 24),
    "mch": ("mch", (512, 512), 24),
    "fmi2": ("fmi", (512, 512), 24),
    "mch2": ("mch", (512, 512), 24),
    "bom": ("bom", (512, 512), 24),
    "knmi": ("knmi", (512, 512), 24),
    "saf": ("saf", (512, 512), 24),
}


def make_synthetic_sequence(
    n_frames=6, shape=(256, 256), velocity=(2.0, 1.0), seed=42,
    evolution=0.0,
):
    """Advecting rain-cell sequence (the repo's test generator, kept here
    so that the package never imports from its test tree).  With ``evolution`` > 0, each frame
    additionally carries an AR(1) multiplicative growth/decay field in the
    Lagrangian frame (scale = ``evolution`` in log-space), so the sequence
    is NOT pure advection: a perfect advection model still faces genuine,
    unpredictable temporal evolution.  Pure advection (evolution=0) makes
    model-parity scores degenerate — an exact Lagrangian model scores ~0
    error and any quality comparison collapses to comparing boundary
    artifacts."""
    rng = np.random.RandomState(seed)
    m, n = shape
    yy, xx = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")

    # correlated texture: power-law filtered white noise
    noise = rng.randn(m, n)
    fy = np.fft.fftfreq(m)[:, None]
    fx = np.fft.rfftfreq(n)[None, :]
    r = np.sqrt(fy**2 + fx**2)
    r[0, 0] = 1.0
    filt = r ** (-1.5)
    filt[0, 0] = 0.0
    texture = np.fft.irfft2(np.fft.rfft2(noise) * filt, s=shape)
    texture = (texture - texture.mean()) / texture.std()

    # several rain cells
    base = np.zeros(shape)
    for cx, cy, amp, sc in [
        (0.3, 0.4, 12.0, 28.0),
        (0.55, 0.55, 8.0, 40.0),
        (0.7, 0.3, 15.0, 22.0),
        (0.4, 0.7, 6.0, 35.0),
    ]:
        base += amp * np.exp(
            -(((xx - cx * n) ** 2 + (yy - cy * m) ** 2) / (2 * sc**2))
        )

    field0 = base * np.exp(0.6 * texture)
    field0[field0 < 0.5] = 0.0

    u, v = velocity
    ky = np.fft.fftfreq(m)[:, None]
    kx = np.fft.fftfreq(n)[None, :]

    def smooth_field():
        w = rng.randn(m, n)
        g = np.fft.irfft2(np.fft.rfft2(w) * filt, s=shape)
        return g / max(g.std(), 1e-12)

    growth = np.zeros(shape)
    rho = 0.7  # AR(1) persistence of the growth/decay field
    frames = []
    for t in range(n_frames):
        field_t = field0
        if evolution > 0.0:
            if t > 0:
                growth = rho * growth + np.sqrt(1 - rho**2) * smooth_field()
            field_t = field0 * np.exp(evolution * growth)
        # exact shift by (u, v) per frame via Fourier phase shift
        shift_y, shift_x = v * t, u * t
        F = np.fft.fft2(field_t)
        phase = np.exp(-2j * np.pi * (ky * shift_y + kx * shift_x))
        f = np.real(np.fft.ifft2(F * phase))
        f[f < 0.1] = 0.0
        frames.append(f)
    return np.stack(frames)


def info():
    """Print the table of available example cases (reference: datasets.py:69)."""
    print("\nAvailable datasets:\n")
    print(f"{'Case':<8} {'Source':<8} {'Shape':<12} {'Frames':<6}\n")
    for case, (source, shape, n_frames) in _EVENT_TABLE.items():
        print(f"{case:<8} {source:<8} {str(shape):<12} {n_frames:<6}")


class ShowProgress:
    """urllib reporthook printing a text progress bar
    (reference: datasets.py:90-161)."""

    def __init__(self, bar_length=20):
        self._bar_length = bar_length
        self._prev_width = 0

    def __call__(self, count, block_size, total_size):
        import sys

        done = count * block_size
        if total_size > 0:
            frac = min(done / total_size, 1.0)
            filled = int(self._bar_length * frac)
            bar = "=" * filled + " " * (self._bar_length - filled)
            msg = f"\r[{bar}] {frac * 100:5.1f}%  ({done / 1e6:.1f} MB)"
        else:
            msg = f"\r{done / 1e6:.1f} MB"
        sys.stdout.write(msg.ljust(self._prev_width))
        self._prev_width = len(msg)
        sys.stdout.flush()

    def end(self, message="Done."):
        import sys

        sys.stdout.write("\n" + message + "\n")
        sys.stdout.flush()


def download_mrms_data(dir_path, initial_date, final_date, timestep=2,
                       nodelay=False):
    """Download MRMS PrecipRate GRIB2 files for a time window
    (reference: datasets.py:164-283).  Requires network egress."""
    import time as _time
    import urllib.request
    from datetime import timedelta

    timestep -= timestep % 2  # archive granularity is 2 min
    if timestep <= 0:
        raise ValueError("timestep must be >= 2 minutes")
    base = ("https://mtarchive.geol.iastate.edu/{date:%Y/%m/%d}/mrms/ncep/"
            "PrecipRate/PrecipRate_00.00_{date:%Y%m%d-%H%M}00.grib2.gz")
    date, count = initial_date, 0
    while date <= final_date:
        url = base.format(date=date)
        dest = os.path.join(
            dir_path, "mrms", f"{date:%Y/%m/%d}", os.path.basename(url)
        )
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            urllib.request.urlretrieve(url, dest)  # noqa: S310
        except Exception as err:  # noqa: BLE001
            raise MissingOptionalDependency(
                f"could not download MRMS data ({err}); offline environment?"
            ) from err
        count += 1
        if not nodelay and count % 30 == 0:
            _time.sleep(5)  # be gentle on the archive server
        date = date + timedelta(minutes=timestep)


def download_pysteps_data(dir_path, force=True):
    """Download the pysteps example data (reference: datasets.py:286).

    Requires network egress; in offline environments use
    :func:`create_synthetic_dataset` instead."""
    import urllib.request

    url = "https://github.com/pySTEPS/pysteps-data/archive/master.zip"
    try:
        os.makedirs(dir_path, exist_ok=True)
        dest = os.path.join(dir_path, "pysteps-data.zip")
        urllib.request.urlretrieve(url, dest)  # noqa: S310
    except Exception as err:  # noqa: BLE001
        raise MissingOptionalDependency(
            f"could not download pysteps example data ({err}); "
            "use create_synthetic_dataset for offline operation"
        ) from err


def create_default_pystepsrc(
    pysteps_data_dir, config_dir=None, file_name="pysteps_tpu_rc", dryrun=False
):
    """Write a default rc file pointing at a data directory
    (reference: datasets.py:337)."""
    import json

    params = {
        "outputs": {"path_workdir": os.path.join(pysteps_data_dir, "tmp")},
        "silent_import": False,
        "plot": {"motion_plot": "quiver", "colorscale": "pysteps"},
        "data_sources": {
            "synthetic": {
                "root_path": pysteps_data_dir,
                "path_fmt": "synthetic",
                "fn_pattern": "synthetic_%Y%m%d%H%M",
                "fn_ext": "npz",
                "importer": "npz",
                "timestep": 5,
                "importer_kwargs": {},
            }
        },
    }
    config_dir = config_dir or os.path.join(
        os.environ.get("HOME", "."), ".pysteps_tpu"
    )
    path = os.path.join(config_dir, file_name)
    if not dryrun:
        os.makedirs(config_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(params, f, indent=2)
    return path


def create_synthetic_dataset(
    dir_path, n_frames=24, shape=(512, 512), velocity=(2.0, 1.0), seed=42,
    start_time="202608171200", timestep=5,
):
    """Generate a synthetic radar archive on disk (offline stand-in for
    download_pysteps_data): NPZ frames laid out for io.archive.find_by_date."""
    import datetime as dt

    frames = make_synthetic_sequence(
        n_frames=n_frames, shape=shape, velocity=velocity, seed=seed
    )
    t0 = dt.datetime.strptime(start_time, "%Y%m%d%H%M")
    outdir = os.path.join(dir_path, "synthetic")
    os.makedirs(outdir, exist_ok=True)
    metadata = {
        "projection": None, "institution": "synthetic",
        "x1": 0.0, "y1": 0.0,
        "x2": float(shape[1] * 1000), "y2": float(shape[0] * 1000),
        "xpixelsize": 1000.0, "ypixelsize": 1000.0,
        "cartesian_unit": "m", "yorigin": "upper",
        "unit": "mm/h", "transform": None,
        "accutime": float(timestep), "zerovalue": 0.0, "threshold": 0.1,
    }
    paths = []
    for i in range(n_frames):
        t = t0 + dt.timedelta(minutes=timestep * i)
        fname = os.path.join(
            outdir, "synthetic_" + t.strftime("%Y%m%d%H%M") + ".npz"
        )
        np.savez_compressed(
            fname, precip=frames[i].astype(np.float32),
            metadata=np.asarray(metadata, dtype=object),
        )
        paths.append(fname)
    return paths, metadata


def load_dataset(case="fmi", frames=14):
    """Load a dataset case (reference: datasets.py:409).

    Looks for a local archive under rcparams; falls back to generating a
    synthetic sequence in memory."""
    shape = _EVENT_TABLE.get(case, ("synthetic", (512, 512), 24))[1]
    precip = make_synthetic_sequence(n_frames=frames, shape=shape)
    metadata = {
        "unit": "mm/h", "transform": None, "accutime": 5,
        "zerovalue": 0.0, "threshold": 0.1,
        "xpixelsize": 1000.0, "ypixelsize": 1000.0,
        "x1": 0.0, "y1": 0.0,
        "x2": float(shape[1] * 1000), "y2": float(shape[0] * 1000),
        "yorigin": "upper", "projection": None,
    }
    return precip, metadata
