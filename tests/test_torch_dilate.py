"""Kernel K4 (bounded L1 rim) of the PyTorch port through its plain
version, both entry points, against both JAX rim kernels (Pallas interpret
mode) and the JAX reduce-window path.  The rim takes values k / (r + 1)
computed from integers, so the tolerance is atol 1e-6."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.nowcasts import utils as jutils
from pysteps_tpu.ops import pallas_dilate as jpd
from pysteps_tpu_torch.nowcasts import utils as tutils
from pysteps_tpu_torch.ops import pallas_dilate as tpd


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jpd, "INTERPRET", True)


@pytest.mark.parametrize("kr,r", [(1, 1), (2, 10), (3, 6)])
def test_k4_plain_matches_jax_rims(kr, r):
    rng = np.random.default_rng(kr * 10 + r)
    fields = rng.normal(0.0, 10.0, (2, 64, 128)).astype(np.float32)
    thr = 12.0
    f_t = torch.from_numpy(fields)
    from_field = tpd.dilated_rim_from_field(f_t, thr, kr, r).numpy()
    from_mask = tpd.dilated_rim(f_t >= thr, kr, r).numpy()
    via_utils = tutils.compute_dilated_mask_from_field(f_t, thr, kr, r).numpy()
    for b in range(2):
        f = jnp.asarray(fields[b])
        ref_xla = np.asarray(jutils.compute_dilated_mask(f >= thr, kr, r))
        ref_whole = np.asarray(jpd.dilated_rim_from_field_pallas(f, thr, kr, r))
        ref_bands = np.asarray(jpd.dilated_rim_pallas(f >= thr, kr, r))
        for ref in (ref_xla, ref_whole, ref_bands):
            np.testing.assert_allclose(from_field[b], ref, atol=1e-6)
            np.testing.assert_allclose(from_mask[b], ref, atol=1e-6)
            np.testing.assert_allclose(via_utils[b], ref, atol=1e-6)


def test_k4_mask_semantics_and_maxpool_reference():
    """The mask entry point counts every positive value as wet (as the
    JAX kernels do), an empty mask gives an empty rim, and the port's own
    max-pool formulation agrees with K4's plain version."""
    rng = np.random.default_rng(0)
    mask = (rng.random((1, 48, 64)) > 0.97).astype(np.float32) * 0.3
    kr, r = 2, 4
    out = tpd.dilated_rim(torch.from_numpy(mask), kr, r).numpy()
    ref = np.asarray(jutils.compute_dilated_mask(jnp.asarray(mask[0]), kr, r))
    np.testing.assert_allclose(out[0], ref, atol=1e-6)

    m = torch.from_numpy(mask) > 0
    d = tutils.binary_dilation(m, kr).float()
    acc = d.clone()
    for _ in range(r):
        d = tutils._cross_dilate(d)
        acc = acc + (d > 0)
    np.testing.assert_allclose(out, (acc / (r + 1)).numpy(), atol=1e-6)
    empty = tpd.dilated_rim(torch.zeros((1, 16, 16)), kr, r)
    assert float(empty.abs().max()) == 0.0
