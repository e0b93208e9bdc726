"""The one traffic generator: a pool of forecast requests made on the host
from ``--seed`` and a traffic file's parameters.

A request is what a weather service hands the nowcast each radar cycle:
the newest ``frames`` radar composites in dB (rain rate 10 log10(R), -15
where dry, as pysteps' ``dB_transform`` with threshold 0.1 mm/h and
zerovalue -15 gives them, with 0.1 dB of noise as a composite has), and a
motion field in pixels per time step (the x component first), on the
configuration's ``shape``.  A configuration with ``nwp_models`` adds an NWP
stack (models, leads + 1, m, n): the newest frame carried on along the flow
one more step a lead, plus ``nwp_noise_db`` of white noise.

Each pool entry is a field of rain cells placed and scaled by the seed,
textured by power-law noise, thresholded at the entry's wet fraction and
advected backwards along a smooth flow (a uniform drift plus a rotation
and a deformation about the centre).  Every seed draws the same set of
wet fractions and drift speeds, in another order, so that seeds change
the inputs and not the amount of work.

Traffic parameters (all in the traffic file):
  pool               entries made at set-up; request i uses entry i % pool
  wet_fraction       [lo, hi]: the pool's wet fractions, evenly spaced
  drift_px           [lo, hi]: the uniform drift speeds, evenly spaced
  swirl_px           the most that the rotation and the deformation add
                     at the domain's corners, each
  cells              [lo, hi]: rain cells a field
  evolution          weight of the fresh texture each earlier frame gets
"""

import numpy as np
from scipy import ndimage

DRY_DB = -15.0
NOISE_DB = 0.1


def _texture(rng, shape, beta=1.5):
    """Power-law filtered white noise, standardized."""
    m, n = shape
    w = rng.standard_normal(shape)
    r = np.sqrt(np.fft.fftfreq(m)[:, None] ** 2 + np.fft.rfftfreq(n)[None, :] ** 2)
    r[0, 0] = 1.0
    filt = r ** (-beta)
    filt[0, 0] = 0.0
    g = np.fft.irfft2(np.fft.rfft2(w) * filt, s=shape)
    return (g - g.mean()) / max(g.std(), 1e-12)


def flow_field(rng, shape, drift, swirl):
    """A (2, m, n) float32 flow: ``drift`` pixels a step in a direction drawn
    from ``rng``, plus a rotation and a deformation about the centre that
    each add at most ``swirl`` pixels a step at the corners."""
    m, n = shape
    yy, xx = np.meshgrid(np.arange(m, dtype=np.float64), np.arange(n, dtype=np.float64),
                         indexing="ij")
    cy, cx = (m - 1) / 2.0, (n - 1) / 2.0
    corner = np.hypot(cy, cx)
    ang = rng.uniform(0.0, 2.0 * np.pi)
    omega = rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 1.0) * swirl / corner
    delta = rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 1.0) * swirl / corner
    u = drift * np.cos(ang) - omega * (yy - cy) + delta * (xx - cx)
    v = drift * np.sin(ang) + omega * (xx - cx) - delta * (yy - cy)
    return np.stack([u, v]).astype(np.float32)


def rain_sequence(rng, shape, n_frames, wet_fraction, flow, n_cells, evolution):
    """(n_frames, m, n) float32 dB frames, the newest last: a field of
    ``n_cells`` rain cells whose wet share is ``wet_fraction``, each earlier
    frame the newest one carried back along ``flow`` one more step and
    given ``evolution`` of fresh texture."""
    m, n = shape
    yy, xx = np.meshgrid(np.arange(m, dtype=np.float64), np.arange(n, dtype=np.float64),
                         indexing="ij")
    base = np.zeros(shape)
    for _ in range(n_cells):
        cy, cx = rng.uniform(0.1, 0.9, size=2) * (m, n)
        amp = rng.uniform(5.0, 15.0)
        scale = rng.uniform(0.04, 0.1) * min(m, n)
        base += amp * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2.0 * scale**2))
    latent = np.log(base + 0.05 * base.max()) + 0.6 * _texture(rng, shape)
    frames = []
    for k in range(n_frames):
        steps = n_frames - 1 - k  # the newest frame is not moved
        # a point x of an earlier frame reaches x + steps * flow at the newest
        coords = np.stack([yy + steps * flow[1], xx + steps * flow[0]])
        moved = ndimage.map_coordinates(latent, coords, order=1, mode="nearest")
        if steps:
            moved = moved + evolution * _texture(rng, shape)
        frames.append(moved)
    frames = np.stack(frames)
    thr = np.quantile(frames[-1], 1.0 - wet_fraction)
    scale = np.std(frames[-1][frames[-1] > thr]) + 1e-12
    # from -10 dB (0.1 mm/h) at the edge of rain to at most 25 dB (316 mm/h)
    z = np.maximum(frames - thr, 0.0) / scale
    db = np.where(frames > thr, -10.0 + 35.0 * (1.0 - np.exp(-z / 3.0)), DRY_DB)
    db = db + NOISE_DB * rng.standard_normal(db.shape)
    return db.astype(np.float32)


def nwp_stack(rng, last, flow, leads, models, noise_db):
    """(models, leads + 1, m, n) float32: the newest frame ``last`` carried
    on along ``flow`` one more step a lead (lead 0 is ``last`` itself), each
    field with ``noise_db`` of white noise."""
    m, n = last.shape
    yy, xx = np.meshgrid(np.arange(m, dtype=np.float64), np.arange(n, dtype=np.float64),
                         indexing="ij")
    fields = [ndimage.map_coordinates(last, [yy - t * flow[1], xx - t * flow[0]], order=1,
                                      mode="nearest") for t in range(leads + 1)]
    stack = np.repeat(np.stack(fields)[None], models, axis=0)
    return (stack + noise_db * rng.standard_normal(stack.shape)).astype(np.float32)


def make_pool(traffic, config, seed):
    """The pool of requests of a run, each a dict with ``frames`` (F, m, n),
    ``velocity`` (2, m, n) and, as the configuration says, ``nwp`` (models,
    leads + 1, m, n), float32 numpy."""
    shape = tuple(int(v) for v in config["shape"])
    size = int(traffic["pool"])
    rng = np.random.default_rng([int(seed), 0x5eed])
    wet = np.linspace(*traffic["wet_fraction"], size)[rng.permutation(size)]
    drift = np.linspace(*traffic["drift_px"], size)[rng.permutation(size)]
    cells = rng.integers(traffic["cells"][0], traffic["cells"][1] + 1, size=size)
    pool = []
    for i in range(size):
        r = np.random.default_rng([int(seed), i])
        flow = flow_field(r, shape, float(drift[i]), float(traffic["swirl_px"]))
        frames = rain_sequence(r, shape, int(config["frames"]), float(wet[i]), flow,
                               int(cells[i]), float(traffic["evolution"]))
        req = {"frames": frames, "velocity": flow}
        if config.get("nwp_models"):
            req["nwp"] = nwp_stack(r, frames[-1], flow, int(config["leads"]),
                                   int(config["nwp_models"]), float(config["nwp_noise_db"]))
        pool.append(req)
    return pool
