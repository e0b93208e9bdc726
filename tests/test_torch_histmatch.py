"""Kernel K3 (PWL gather apply) of the PyTorch port through its plain
version, the LUT build around it, and the sort matchers, held against the
JAX package on the CPU (Pallas in interpret mode).

Tolerances: integer counts equal; LUT floats within 1e-5 relative; the
PWL apply within 1e-5 x scale against the Pallas kernel (as the JAX
package's own kernel tests) and 1e-4 x span against the f64 flat sum (as
its chain tests); the sort matchers within 1e-6 x span.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu.postprocessing import probmatching as jpm
from pysteps_tpu_torch.ops import pallas_histmatch as tph
from pysteps_tpu_torch.postprocessing import probmatching as tpm


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)


def _case(shape, seed, n_members=2):
    """A radar-like dB target with a dry floor, and member fields near it."""
    rng = np.random.default_rng(seed)
    target = np.where(
        rng.random(shape) > 0.55, rng.gamma(2.0, 6.0, shape) + 5.0, -15.0
    ).astype(np.float32)
    fields = np.stack([
        np.maximum(target + rng.normal(0.0, 2.0, shape), target.min())
        for _ in range(n_members)
    ]).astype(np.float32)
    return target, fields


def _tstates(target):
    ranked_j, zv_j = jpm._prepare_cdf_target(jnp.asarray(target))
    ranked_t, zv_t = tpm._prepare_cdf_target(torch.from_numpy(target))
    np.testing.assert_array_equal(np.asarray(ranked_j), ranked_t.numpy())
    return jph.prepare_target(ranked_j, zv_j), tph.prepare_target(ranked_t, zv_t)


def test_prepare_target_and_lut_build():
    target, fields = _case((64, 128), 1)
    ts_j, ts_t = _tstates(target)
    for a, b in zip(ts_j, ts_t):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ts_j[2]), ts_t[2].numpy())
    coeffs_t = tph.build_pwl_coeffs(torch.from_numpy(fields.reshape(2, -1)), ts_t)
    e8_t, T_t = tph.pack_gather_lut(*coeffs_t[:3])
    for b in range(2):
        coeffs_j = jph.build_pwl_coeffs(jnp.asarray(fields[b].reshape(-1)), ts_j)
        for cj, ct in zip(coeffs_j, coeffs_t):
            ct = ct[b] if ct.ndim else ct
            scale = max(float(np.abs(np.asarray(cj)).max()), 1e-6)
            np.testing.assert_allclose(np.asarray(cj), ct.numpy(), atol=1e-5 * scale)
        e8_j, T_j = jph.pack_gather_lut(*coeffs_j[:3])
        np.testing.assert_allclose(np.asarray(e8_j)[:, 0], e8_t[b].numpy(), rtol=1e-5)
        scale = float(np.abs(np.asarray(T_j)).max())
        np.testing.assert_allclose(np.asarray(T_j), T_t[b].numpy(), atol=1e-5 * scale)


def test_k3_plain_matches_pallas_gather():
    """The same LUT through both: the plain version sums the 15 fine terms
    in the Pallas kernel's order."""
    target, fields = _case((128, 128), 2)
    ts_j, _ = _tstates(target)
    for b in range(2):
        init = jnp.asarray(fields[b].reshape(-1))
        edges, d0, d1, q0, zv, zt = jph.build_pwl_coeffs(init, ts_j)
        e8, T = jph.pack_gather_lut(edges, d0, d1)
        ref = np.asarray(jph.pwl_apply_gather(init, e8, T, q0, zv, zt))
        out = tph.pwl_apply_gather(
            torch.from_numpy(fields[b].reshape(1, -1)),
            torch.tensor(np.asarray(e8).reshape(1, 8)),
            torch.tensor(np.asarray(T))[None],
            torch.tensor([float(q0)]), torch.tensor([float(zv)]),
            torch.tensor([float(zt)]),
        )[0].numpy()
        scale = np.abs(ref).max()
        assert np.abs(out - ref).max() < 1e-5 * scale


@pytest.mark.parametrize("shape", [(40, 128), (48, 100)])
def test_k3_any_size_matches_flat_f64_reference(shape):
    """Rows that are not a multiple of 32 (and a size that is not even a
    multiple of 128): the port's match_cdf_pwl still applies through K3
    and agrees with the flat K-edge sum in f64."""
    target, fields = _case(shape, 3)
    _, ts_t = _tstates(target)
    x = torch.from_numpy(fields.reshape(2, -1))
    edges, d0, d1, q0, zval, ztrg = (
        c.double().numpy() for c in tph.build_pwl_coeffs(x, ts_t)
    )
    out = tph.match_cdf_pwl(torch.from_numpy(fields), ts_t).numpy().reshape(2, -1)
    xs = fields.reshape(2, -1).astype(np.float64)
    for b in range(2):
        cum = (xs[b][:, None] >= edges[b][None, :]).astype(np.float64)
        ref = q0[b] + cum @ d0[b] + xs[b] * (cum @ d1[b])
        ref = np.where(xs[b] == zval[b], ztrg, ref)
        # the f64 reference's own tolerance (f32 sums of steep segments)
        span = ref.max() - ref.min()
        assert np.abs(out[b] - ref).max() < 1e-4 * max(span, 1.0)


@pytest.mark.parametrize("exact", [True, False])
def test_match_cdf_presorted(exact):
    """Exact (two stable sorts) and packed (single-key int64 sorts with the
    JAX package's uint32 bit layout) against JAX, per member."""
    target, fields = _case((64, 64), 4, n_members=3)
    ranked_j, zv_j = jpm._prepare_cdf_target(jnp.asarray(target))
    ranked_t, zv_t = tpm._prepare_cdf_target(torch.from_numpy(target))
    out = tpm._match_cdf_presorted(
        torch.from_numpy(fields), ranked_t, zv_t, exact=exact
    ).numpy()
    span = float(np.ptp(target))
    for b in range(3):
        ref = np.asarray(
            jpm._match_cdf_presorted(jnp.asarray(fields[b]), ranked_j, zv_j, exact=exact)
        )
        assert np.abs(out[b] - ref).max() <= 1e-6 * span


def test_prepare_cdf_matcher_selects_by_argument():
    """pwl=True gives the PWL matcher, which agrees with the JAX package's
    match_cdf_pwl (gather kernel in interpret mode); pwl=False the packed
    sort matcher, which agrees with the JAX package's CPU matcher."""
    target, fields = _case((64, 128), 5)
    ts_j, _ = _tstates(target)
    f = torch.from_numpy(fields)
    match, state = tpm.prepare_cdf_matcher(torch.from_numpy(target), True)
    assert match is tph.match_cdf_pwl
    pwl = match(f, state).numpy()
    match_j, state_j = jpm.prepare_cdf_matcher(jnp.asarray(target))
    match, state = tpm.prepare_cdf_matcher(torch.from_numpy(target), False)
    srt = match(f, state).numpy()
    span = float(np.ptp(target))
    for b in range(2):
        ref = np.asarray(jph.match_cdf_pwl(jnp.asarray(fields[b]), ts_j))
        assert np.abs(pwl[b] - ref).max() < 1e-5 * np.abs(ref).max()
        ref = np.asarray(match_j(jnp.asarray(fields[b]), state_j))
        assert np.abs(srt[b] - ref).max() <= 1e-6 * span
    assert tph.supported((512, 512)) and not tph.supported((48, 100))


def test_prepare_target_bins_like_jax():
    """The bin scale is a true division, as the JAX package's: with
    ``(B_T - 1.0) / span`` PyTorch multiplies by a rounded reciprocal,
    which for this target is one ulp off and moves a bin boundary of C_t
    (and with it a knot's target quantile by one bin)."""
    rng = np.random.default_rng(9)
    for _ in range(3):  # the member fields drawn before the target
        rng.normal(0.0, 1.0, (128, 128))
    target = np.sort(np.maximum(rng.normal(0.5, 3.0, 128 * 128), 0.0)).astype(np.float32)
    ts_j = jph.prepare_target(jnp.asarray(target), jnp.float32(target[0]))
    ts_t = tph.prepare_target(torch.from_numpy(target), torch.tensor(target[0]))
    assert np.float32(ts_j[4]) == np.float32(ts_t[4].item())
    np.testing.assert_array_equal(np.asarray(ts_j[2]), ts_t[2].numpy())
    spans = np.random.default_rng(0).random(2000).astype(np.float32) * 50 + 0.1
    for span in spans:
        t = torch.tensor([0.0, span], dtype=torch.float32)
        ref = np.float32(tph.B_T - 1.0) / np.float32(span)
        assert tph.prepare_target(t, t[0])[4].item() == ref
