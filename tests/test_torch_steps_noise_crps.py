"""STEPS' other noise generators in the PyTorch port against the JAX
package through the public ``forecast`` on the CPU, by the
``MODEL_PARITY.json`` recipe of ``tests/test_torch_steps.py``: CRPS
against the synthetic truth and the spread/error ratio, averaged over 2
seeds, within 10% of the JAX package's (the two draw different random
numbers).  128^2, 16 members, 6 leads, seeds 11 and 22, as that test
runs the nonparametric method; here the headline configuration with the
parametric filter and "auto" noise std adjustment, SSFT (``win_size=64``)
with "fixed", and nested (``max_level=2``).

The two packages' BPS velocity draws have the same law (mean |eps| 0.709
for JAX and 0.717 for the port over 200 seeds), but at seeds 11 and 22
JAX's happen to be larger (mean |eps| 0.87 and 0.80 against 0.60 and 0.66
for 12 members), which raises JAX's CRPS by several percent in every
method; without velocity perturbation the two agree within 1%."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_steps import KW, SIDE, _inputs, _scores, _to_db  # noqa: E402

from pysteps_tpu import nowcasts as jnowcasts  # noqa: E402
from pysteps_tpu_torch import nowcasts as tnowcasts  # noqa: E402

CASES = {
    "parametric": dict(noise_method="parametric", noise_stddev_adj="auto"),
    "ssft": dict(noise_method="ssft", noise_stddev_adj="fixed",
                 noise_kwargs={"win_size": SIDE // 2}),
    "nested": dict(noise_method="nested", noise_kwargs={"max_level": 2}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stochastic_forecast_crps_parity(case):
    frames, velocity = _inputs(n_frames=9, evolution=0.2)
    precip = _to_db(frames[:3])
    truth = frames[3:]
    j, t = [], []
    for seed in (11, 22):
        kw = dict(KW, n_ens_members=16, seed=seed, **CASES[case])
        j.append(_scores(jnowcasts.get_method("steps")(precip, velocity, 6, **kw), truth))
        out = tnowcasts.get_method("steps")(precip, velocity, 6, device="cpu", **kw)
        assert out.shape == (16, 6, SIDE, SIDE)
        assert float(out.float().std(dim=0).nanmean()) > 0
        t.append(_scores(out.numpy(), truth))
    (c_j, r_j), (c_t, r_t) = np.mean(j, axis=0), np.mean(t, axis=0)
    assert abs(c_t - c_j) / c_j <= 0.1, (c_t, c_j)
    assert abs(r_t - r_j) / r_j <= 0.1, (r_t, r_j)
