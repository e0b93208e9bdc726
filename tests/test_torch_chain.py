"""The fused match-rim-warp chain of the PyTorch port through its plain
version, held against the JAX package's ``pallas_chain.match_warp_rim``
(Pallas in interpret mode) on the CPU; its LUT layout and gates.

Inputs follow ``tests/test_pallas_chain.py::_setup``: a 3-member batch,
each member with its own field and so its own LUT, and displacements
scaled per member up to beyond D (pins the clip to [p - D, p + D] with D
rounded up to 8, and the out-of-domain fill).  Tolerances are the JAX
package's chain test's (``tests/test_pallas_chain.py:73-81``): the warp
within 1e-4 x span with identical NaN sets, the rim within 1e-6.
"""

import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pysteps_tpu.nowcasts import steps as jsteps
from pysteps_tpu.ops import pallas_chain as jpc
from pysteps_tpu.ops import pallas_dilate as jpd
from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu.ops import pallas_warp as jpw
from pysteps_tpu.ops import warp as jwarp
from pysteps_tpu_torch.nowcasts import steps as tsteps
from pysteps_tpu_torch.ops import pallas_chain as tpc
from pysteps_tpu_torch.ops import pallas_histmatch as tph

AMPS = (1.0, 4.0, 8.0)  # displacement scale per member: 8 x 3.8 px > D


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    for mod in (jpc, jpd, jph, jpw):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _setup(m, n):
    """(fields (3, m, n), JAX target state, dy (3, m, n), disp_t
    (3, 2, n, m)) as numpy, from ``test_pallas_chain.py::_setup``'s recipe
    with one seed per member."""
    fields, dys, disp_ts = [], [], []
    for b, amp in enumerate(AMPS):
        rng = np.random.RandomState(b)
        fields.append(rng.randn(m, n).astype(np.float32) * 3)
        if b == 0:
            target = np.sort(rng.gamma(2, 1, m * n)).astype(np.float32)
        dy = amp * (3.3 + 0.5 * np.sin(np.linspace(0, 4, m))[:, None] * np.ones((m, n)))
        dx = amp * (-2.1 + 0.3 * np.cos(np.linspace(0, 3, n))[None, :] * np.ones((m, n)))
        dys.append(dy.astype(np.float32))
        disp_ts.append(np.stack([dx.T, dy.T]).astype(np.float32))
    tstate = jph.prepare_target(jnp.asarray(target), jnp.asarray(target[0]))
    return np.stack(fields), tstate, np.stack(dys), np.stack(disp_ts)


def _luts(fields, tstate):
    """Per-member JAX coefficients and gather LUTs, stacked as numpy."""
    coeffs = [jph.build_pwl_coeffs(jnp.asarray(f.reshape(-1)), tstate) for f in fields]
    luts = [jph.pack_gather_lut(*c[:3]) for c in coeffs]
    e8 = np.stack([np.asarray(e)[:, 0] for e, _ in luts])
    T = np.stack([np.asarray(t) for _, t in luts])
    scal = np.array([[float(c[i]) for i in (3, 4, 5)] for c in coeffs], np.float32)
    return coeffs, luts, e8, T, scal


@pytest.mark.parametrize(
    "shape,D,do_rim,kr,r",
    [
        ((256, 256), 16, True, 3, 5),
        ((256, 256), 13, False, 2, 10),
        ((128, 256), 13, True, 2, 10),
        ((128, 256), 16, False, 3, 5),
        ((128, 256), 16, True, 3, 5),
    ],
)
def test_chain_plain_matches_pallas(shape, D, do_rim, kr, r):
    m, n = shape
    fields, tstate, dy, disp_t = _setup(m, n)
    coeffs, luts, e8, T, scal = _luts(fields, tstate)
    thr, cval = 6.0, float("nan")  # ~1% of the gamma(2, 1) target is wet
    out, rim = tpc.match_warp_rim(
        torch.from_numpy(fields), torch.from_numpy(e8), torch.from_numpy(T),
        torch.from_numpy(scal[:, 0]), torch.from_numpy(scal[:, 1]),
        torch.from_numpy(scal[:, 2]), thr, torch.from_numpy(dy),
        torch.from_numpy(disp_t), cval, D, kr, r, do_rim=do_rim,
    )
    assert out.shape == rim.shape == (3, m, n)
    for b in range(3):
        c = coeffs[b]
        ref, ref_rim = jpc.match_warp_rim(
            jnp.asarray(fields[b]), luts[b][0], luts[b][1], c[3], c[4], c[5],
            jnp.float32(thr), jnp.asarray(dy[b]), jnp.asarray(disp_t[b]),
            jnp.float32(cval), D, kr, r, do_rim=do_rim,
        )
        ref, got = np.asarray(ref), out[b].numpy()
        assert np.array_equal(np.isnan(ref), np.isnan(got))
        assert np.isnan(ref).any()  # sources outside the domain get cval
        span = np.nanmax(ref) - np.nanmin(ref)
        err = np.nanmax(np.abs(np.nan_to_num(ref) - np.nan_to_num(got)))
        assert err < 1e-4 * max(span, 1.0), (b, err, span)
        np.testing.assert_allclose(np.asarray(ref_rim), rim[b].numpy(), atol=1e-6)
        if do_rim:
            assert 0.0 < float(rim[b].mean()) < 1.0


def test_chain_clip_rule_rounds_d_up_to_8():
    """D = 13 and D = 16 give the same chain (both clip at 16), D = 8 a
    different one once the displacement exceeds 8."""
    m, n = 128, 256
    fields, tstate, dy, disp_t = _setup(m, n)
    _, _, e8, T, scal = _luts(fields, tstate)
    args = [torch.from_numpy(a) for a in (fields, e8, T, scal[:, 0], scal[:, 1], scal[:, 2])]

    def run(D):
        return tpc.match_warp_rim(
            *args, 1.0, torch.from_numpy(dy), torch.from_numpy(disp_t),
            float("nan"), D, 2, 10,
        )[0]

    a, b, c = run(13), run(16), run(8)
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert not torch.equal(torch.nan_to_num(a[2]), torch.nan_to_num(c[2]))


@pytest.mark.parametrize("halo,do_rim,ok", [(11, True, False), (12, True, True), (0, False, True)])
def test_chain_halo_must_hold_the_rim(halo, do_rim, ok):
    """Stage 1's halo sets the kernel's work, not its result, but the rim
    reads kr + r rows of it: a smaller halo is refused on any device."""
    fields, tstate, dy, _ = _setup(128, 128)
    _, _, e8, T, scal = _luts(fields, tstate)
    args = [torch.from_numpy(a) for a in (fields, e8, T, scal[:, 0], scal[:, 1], scal[:, 2])]
    run = lambda h: tpc.chain_match_vert_rim(  # noqa: E731
        *args, 1.0, torch.from_numpy(dy), 16, 2, 10, do_rim, halo=h)
    if not ok:
        with pytest.raises(ValueError):
            run(halo)
        return
    got, ref = run(halo), run(None)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_pack_hier_lut_matches_jax():
    fields, tstate, _, _ = _setup(128, 128)
    x = torch.from_numpy(fields.reshape(3, -1))
    coeffs_t = tph.build_pwl_coeffs(x, tph.prepare_target(
        torch.from_numpy(np.array(tstate[0])), torch.tensor(float(tstate[1]))))
    e16_t, M3_t = tpc.pack_hier_lut(*coeffs_t[:3])
    assert e16_t.shape == (3, 16) and M3_t.shape == (3, 72, 16)
    for b in range(3):
        # same coefficients into both packers
        edges, d0, d1 = (jnp.asarray(c[b].numpy()) for c in coeffs_t[:3])
        e16_j, M3_j = jpc.pack_hier_lut(edges, d0, d1)
        np.testing.assert_array_equal(np.asarray(e16_j)[:, 0], e16_t[b].numpy())
        M3_j = np.asarray(M3_j)
        M3_j, M3_tb = np.asarray(M3_j), M3_t[b].numpy()
        # fine edges and deltas split identically; the prefix rows sum 8
        # deltas per block, whose order may differ by one rounding, and the
        # split of a prefix then differs while its sum (a + b) + c does not
        for k in range(3):
            rows = slice(24 * k, 24 * k + 21)
            np.testing.assert_array_equal(M3_j[rows], M3_tb[rows])
        full_j = (M3_j[:24] + M3_j[24:48]) + M3_j[48:]
        full_t = (M3_tb[:24] + M3_tb[24:48]) + M3_tb[48:]
        np.testing.assert_allclose(full_t, full_j, rtol=0, atol=1e-6 * np.abs(full_j).max())
    # the a and b splits are bf16-exact: their low 16 bits are zero
    bits = M3_t[:, :48].contiguous().view(torch.int32)
    assert int((bits & 0xFFFF).abs().max()) == 0


@pytest.mark.parametrize("rim,ok", [(0, True), (12, True), (tpc.MAX_RIM, True),
                                    (tpc.MAX_RIM + 1, False)])
def test_chain_gate_refuses_rims_stage1_cannot_take(rim, ok):
    """Stage 1 keeps rim distances in bytes, so its launch refuses kr + r
    above ``MAX_RIM`` (``CV_MAX_R`` in ``csrc/chain.cu``), where JAX's
    chain has no limit: the STEPS gate then takes the unfused path."""
    src = (Path(tpc.__file__).parent.parent / "csrc" / "chain.cu").read_text()
    assert re.search(r"#define CV_MAX_R (\d+)", src).group(1) == str(tpc.MAX_RIM)
    assert tsteps._chain_available("cdf", 1, 48, (512, 512), True, rim=rim) == ok
    assert not tsteps._chain_available("cdf", 1, 48, (512, 512), False, rim=rim)


@pytest.mark.parametrize("shape", [(512, 512), (1024, 1024), (320, 320), (128, 256)])
def test_gates_agree_with_jax(monkeypatch, shape):
    """``supported`` and ``_chain_available`` against the JAX package's
    (with its Pallas switch on, as on the TPU)."""
    monkeypatch.setattr(jwarp, "_use_pallas_cache", True)
    monkeypatch.delenv("PYSTEPS_TPU_NO_CHAIN", raising=False)
    assert tpc.supported(shape) == jpc.supported(shape)
    assert tpc.supported(shape) == (shape in ((512, 512), (128, 256)))
    for pm in ("cdf", "mean", None):
        for order in (0, 1):
            for md in (48, None):
                ref = jsteps._chain_available(pm, order, md, shape)
                assert tsteps._chain_available(pm, order, md, shape, True) == ref
                assert not tsteps._chain_available(pm, order, md, shape, False)
    jax.clear_caches()


def test_stage1_shared_memory_limit():
    """Where stage 1's ring outgrows the H100's 227 KB a block: on a field
    taller than the ring (1000 rows) with the STEPS rim, D = 320 fits
    (a ring of 705 rows, 229,248 B) and D = 328 does not (721 rows,
    234,368 B), as the card's launch finds; a field no taller than the ring
    fits at any D; the 512^2 main path takes 55,168 B."""
    from pysteps_tpu_torch.ops import _kernels

    fits = tpc.stage1_info(1000, 64, 320, 2, 10, device="cpu")
    over = tpc.stage1_info(1000, 64, 328, 2, 10, device="cpu")
    assert (fits["ring_rows"], fits["smem_bytes"], fits["fits"]) == (705, 229_248, True)
    assert (over["ring_rows"], over["smem_bytes"], over["fits"]) == (721, 234_368, False)
    assert fits["smem_bytes"] <= _kernels.SMEM_LIMIT < over["smem_bytes"]
    assert tpc.stage1_info(1000, 64, 321, 2, 10, device="cpu") == over  # D rounds to 328
    short = tpc.stage1_info(512, 512, 4000, 2, 10, device="cpu")
    assert short["ring_rows"] == 512 and short["fits"]
    main = tpc.stage1_info(512, 512, 48, 2, 10, device="cpu")
    assert (main["ring_rows"], main["smem_bytes"], main["blocks_per_sm"]) == (161, 55_168, None)
    assert main["matches_per_output"] == (2 * 76 + 6 * 88) / 512
    assert tpc.stage1_info(512, 512, 48, 2, 10, do_rim=False,
                                    device="cpu")["matches_per_output"] == 1
    with pytest.raises(ValueError):
        tpc.stage1_info(512, 512, 48, 4, tpc.MAX_RIM - 3, device="cpu")
