"""The hand-written kernels of the PyTorch port on the card (K1-K4, the
two stages of the fused chain, the hierarchical and flat PWL maps, the
CDF counts),
against their plain PyTorch versions on the same CUDA inputs, at shapes
that the main path never gives them (grids that are not multiples of 8 or
32, one pixel, a rim radius wider than the grid or than a 48 KB block,
fields at the chain gate's edge, members with distinct LUTs).
``chip_smoke.py`` holds them at the main path's shapes.

Every test needs a CUDA card and skips without one.  On the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py -q

Tolerances: 1e-5 x span for chain stage 2 (its lerp against the plain
version's), none for K1-K3, chain stage 1's C and the hierarchical and
flat maps (the same operations in the same order, or prefix tables equal
to the sum: equal under ==, NaN where NaN),
1e-6 for the rims (small integers held in floats), exact for the CDF
counts (integers; also against the CPU model of their kernel,
``pallas_histmatch._cdf_counts_search_plain``).
"""

import numpy as np
import pytest
import torch

from pysteps_tpu_torch.ops import (
    _kernels, pallas_chain, pallas_dilate, pallas_histmatch, pallas_warp,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(out, ref, tol):
    torch.cuda.synchronize()
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    assert out.shape == ref.shape
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    err = float(np.nanmax(np.abs(np.nan_to_num(out) - np.nan_to_num(ref)), initial=0.0))
    assert err <= tol, (err, tol)


def _disp(gen, dev, B, m, n, amp):
    """Smooth (B, 2, m, n) displacements of about +-amp pixels."""
    yy = torch.linspace(0, 3, m, device=dev)[:, None]
    xx = torch.linspace(0, 2, n, device=dev)[None, :]
    a = torch.rand((B, 2, 1, 1), generator=gen, device=dev) + 0.5
    return amp * torch.stack(
        [a[:, 0] * torch.sin(xx + yy) + 0.1, -a[:, 1] * torch.cos(0.7 * xx - yy)], dim=1
    )


def _k1_inputs(gen, dev, B, rep, m, n, axis, amp=20.0):
    """Fields (B * rep, m, n) and their shared (B, m, n) index planes."""
    field = torch.randn((B * rep, m, n), generator=gen, device=dev)
    pos = torch.arange((m, n)[axis], device=dev, dtype=torch.float32)
    pos = pos[:, None] if axis == 0 else pos[None, :]
    c = pos + _disp(gen, dev, B, m, n, amp)[:, 1 - axis]
    idx0 = torch.floor(c).to(torch.int32).contiguous()
    frac = (c - torch.floor(c)).contiguous()
    return field, idx0, frac


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("rep", [1, 2, 3])
@pytest.mark.parametrize("D", [5, 13, 300])
@pytest.mark.parametrize("shape", [(37, 53), (40, 128)])
def test_k1_resample(dev, axis, rep, D, shape):
    """|disp| reaches 20 > D: pins the clip to [p - D, p + D], then the
    edges (D = 300 is wider than the grid: no clip); ``rep`` fields share
    one index plane.  53 columns take the scalar streams, 128 the 16-byte
    ones; two launches in a row."""
    gen = torch.Generator(device=dev).manual_seed(axis + 10 * rep + D + shape[1])
    m, n = shape
    field, idx0, frac = _k1_inputs(gen, dev, 3, rep, m, n, axis)
    before = _kernels.LAUNCHES[f"resample_axis{axis}"]
    out = pallas_warp.axis_resample(field, idx0, frac, D, axis)
    again = pallas_warp.axis_resample(field, idx0, frac, D, axis)
    assert _kernels.LAUNCHES[f"resample_axis{axis}"] == before + 2
    ref = pallas_warp._axis_resample(field, idx0, frac, D, axis)
    _close(out, ref, 0.0)
    _close(again, ref, 0.0)


@pytest.mark.parametrize("axis", [0, 1])
def test_k1_unaligned_and_many_planes(dev, axis):
    """Streams that start off a 16-byte boundary take the scalar path; 70000
    index planes need two grid chunks of 65535."""
    gen = torch.Generator(device=dev).manual_seed(7 + axis)
    m, n = 8, 16
    field, idx0, frac = _k1_inputs(gen, dev, 70000, 1, m, n, axis, amp=5.0)
    flat = torch.empty(idx0.numel() + 1, dtype=torch.int32, device=dev)
    shifted = flat[1:].view(idx0.shape)
    shifted.copy_(idx0)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    out = pallas_warp.axis_resample(field, shifted, frac, 3, axis)
    _close(out, pallas_warp._axis_resample(field, idx0, frac, 3, axis), 0.0)
    out = pallas_warp.axis_resample(field, idx0, frac, 3, axis)
    _close(out, pallas_warp._axis_resample(field, idx0, frac, 3, axis), 0.0)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("D", [13, 48])
def test_k2_warp(dev, masked, D):
    """D = 13 is rounded up to 16 by the wrapper; the grid is no multiple
    of 8."""
    gen = torch.Generator(device=dev).manual_seed(D + masked)
    B, m, n = 2, 37, 53
    field = torch.randn((B, m, n), generator=gen, device=dev) * 5.0 + 10.0
    disp = _disp(gen, dev, B, m, n, 20.0)
    dy = disp[:, 1].contiguous()
    disp_t = disp.transpose(-1, -2).contiguous()
    before = _kernels.LAUNCHES["warp"]
    out = pallas_warp.warp_fused(field, dy, disp_t, D, float("nan"), masked)
    assert _kernels.LAUNCHES["warp"] == before + 1
    ref = pallas_warp._warp_fused_plain(field, dy, disp_t, -(-D // 8) * 8, float("nan"), masked)
    assert masked == bool(torch.isnan(ref).any())
    _close(out, ref, 0.0)


def _k2_inputs(gen, dev, shape, amp, specials=True):
    """A field and its displacement planes; with ``specials`` NaN and
    +-inf pixels in the field and in both displacement planes."""
    B, m, n = shape
    field = torch.randn(shape, generator=gen, device=dev) * 5.0 + 10.0
    disp = _disp(gen, dev, B, m, n, amp)
    if specials:
        for t in (field, disp):
            flat = t.view(-1)
            idx = torch.randint(0, flat.numel(), (3 * max(1, flat.numel() // 300),),
                                generator=gen, device=dev)
            vals = torch.tensor([float("nan"), float("inf"), float("-inf")], device=dev)
            flat[idx] = vals.repeat(len(idx) // 3)
    return field, disp[:, 1].contiguous(), disp.transpose(-1, -2).contiguous()


@pytest.mark.parametrize("geometry", [
    (16, None), (8, None), (1, None),  # strips of 16, 8 and 1 rows
    (16, 16), (4, 64), (2, 7),  # column tiles: halo clipped at both edges
])
@pytest.mark.parametrize("D", [8, 13, 48, 200])
@pytest.mark.parametrize("shape", [(3, 37, 53), (2, 70, 130)])
def test_k2_tiles(dev, shape, D, geometry):
    """K2's tile kernel at forced geometries (rows and columns no multiple
    of the tile, D = 200 wider than both fields), with NaN and +-inf in the
    field and the displacement, both ``masked`` values: equal to the plain
    version, one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(D + shape[2] + geometry[0])
    field, dy, disp_t = _k2_inputs(gen, dev, shape, 1.3 * D)
    th, tw = geometry
    D8 = pallas_warp._round8(D)
    geo = pallas_warp.warp_tile(*shape, D8, th, tw or shape[2])
    for masked in (True, False):
        before = _kernels.LAUNCHES["warp"]
        out = pallas_warp._warp_launch(field, dy, disp_t, D8, float("nan"), masked, geo)
        assert _kernels.LAUNCHES["warp"] == before + 1
        ref = pallas_warp._warp_fused_plain(field, dy, disp_t, D8, float("nan"), masked)
        _close(out, ref, 0.0)


@pytest.mark.parametrize("shape,D", [
    ((32, 1024, 1024), 48),  # path B
    ((96, 320, 320), 48),  # path C
    ((1, 2, 57000), 30000),  # the widest tile: one row of 57000 columns
    ((1, 2, 60000), 30000),  # no tile fits: the two-pass kernels
    ((3, 20, 1500), 2000),  # column tiles whose halo is the whole row
])
def test_k2_routes(dev, shape, D):
    """``warp_fused`` at the geometry it computes, both routes; the tile
    kernel refuses the geometry with a column or 4 bytes of shared memory
    less; equal to the plain version, one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(shape[2])
    field, dy, disp_t = _k2_inputs(gen, dev, shape, 60.0 if D < 100 else 1.2 * D)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    geo = pallas_warp.warp_geometry(*shape, D, sms)
    assert geo["route"] == pallas_warp.warp_route(shape[1], shape[2], D)
    if geo["route"] == "tile":
        assert pallas_warp.warp_info(geo)["blocks_per_sm"] >= 1
        for short in ({"cols": geo["cols"] - 1}, {"smem_bytes": geo["smem_bytes"] - 4}):
            with pytest.raises(RuntimeError, match="pst_warp"):
                pallas_warp._warp_launch(field, dy, disp_t, pallas_warp._round8(D),
                                         float("nan"), True, {**geo, **short})
    for masked in (True, False):
        before = _kernels.LAUNCHES["warp"]
        out = pallas_warp.warp_fused(field, dy, disp_t, D, float("nan"), masked)
        assert _kernels.LAUNCHES["warp"] == before + 1
        ref = pallas_warp._warp_fused_plain(
            field, dy, disp_t, pallas_warp._round8(D), float("nan"), masked)
        _close(out, ref, 0.0)


def test_k2_geometry_on_the_paths(dev):
    """Tiles of 16 rows on paths B (256 columns) and C (strips), 4 blocks
    an SM (the kernel's register budget)."""
    for shape, tw in (((32, 1024, 1024), 256), ((96, 320, 320), 320)):
        geo = pallas_warp.warp_geometry(*shape, 48)
        assert (geo["th"], geo["tw"]) == (16, tw)
        assert pallas_warp.warp_info(geo)["blocks_per_sm"] == 4


def _pwl_case(gen, dev, B, N):
    """Per-member PWL coefficients for a (B, N) field (each member drawn
    with its own scale, so each has its own LUT), the field and the
    target's dry value."""
    size = max(N, 256)
    target = torch.randn(size, generator=gen, device=dev) * 4.0
    target = torch.where(target > -1.0, target, -1.0)
    ranked = torch.sort(target).values
    tstate = pallas_histmatch.prepare_target(ranked, ranked[0])
    scale = torch.linspace(2.0, 4.0, B, device=dev)[:, None]
    x = torch.randn((B, size), generator=gen, device=dev) * scale
    x = torch.where(x > -2.0, x, -2.0)
    return pallas_histmatch.build_pwl_coeffs(x, tstate), x[:, :N].contiguous()


@pytest.mark.parametrize("N", [1, 1000, 40 * 128])
def test_k3_pwl_gather(dev, N):
    """Any pixel count works: no row tiling, no rows % 32 trap."""
    gen = torch.Generator(device=dev).manual_seed(N)
    B = 3
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, N)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    ztrg = ztrg.expand(B)
    before = _kernels.LAUNCHES["pwl_gather"]
    out = pallas_histmatch.pwl_apply_gather(x, e8, T, q0, zval, ztrg)
    assert _kernels.LAUNCHES["pwl_gather"] == before + 1
    ref = pallas_histmatch._pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    _close(out, ref, 0.0)


def _spoil_one(T):
    """The LUT with member 1's row 5 shuffled and member 2's row 3 given a
    NaN fine edge: both fail the prefix-table check."""
    T = T.clone()
    T[1, 5, :15] = T[1, 5, :15].flip(0)
    T[2, 3, 7] = float("nan")
    return T


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("N", [1, 3, 5, 4096 * 256 + 1])
def test_k3_alignment_and_failing_luts(dev, N, offset):
    """K3 on inputs that start ``offset`` floats past a 16-byte boundary
    (the output is a fresh allocation: offset 0 vectorises, the others go
    scalar), N below, at and above a vector and a block, members whose
    LUT fails the prefix-table check, NaN and ``x == zval`` pixels: equal
    to the plain version, one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(N + offset)
    B = 4
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, N)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    T = _spoil_one(T)
    ok = pallas_histmatch._pwl_prefix_ok(T).tolist()
    assert ok == [True, False, False, True]
    x = x.clone()
    x[:, 0] = zval
    if N > 2:
        x[:, 2] = float("nan")
    flat = torch.empty(B * N + offset, device=dev)
    xs = flat[offset:].view(B, N)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 4 * offset
    ztrg = ztrg.expand(B)
    before = _kernels.LAUNCHES["pwl_gather"]
    out = pallas_histmatch.pwl_apply_gather(xs, e8, T, q0, zval, ztrg)
    assert _kernels.LAUNCHES["pwl_gather"] == before + 1
    ref = pallas_histmatch._pwl_apply_gather_plain(x, e8, T, q0, zval, ztrg)
    _close(out, ref, 0.0)
    assert bool((out[:, 0] == ztrg).all())


@pytest.mark.parametrize("N", [1, 1000, 200 * 128])
def test_pwl_hier(dev, N):
    """Any pixel count; pixels below the first block start give q0."""
    gen = torch.Generator(device=dev).manual_seed(N + 1)
    B = 3
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, N)
    x[:, :1] = edges[:, :1] - 1.0
    e16, M3 = pallas_chain.pack_hier_lut(edges, d0, d1)
    ztrg = ztrg.expand(B)
    before = _kernels.LAUNCHES["pwl_hier"]
    out = pallas_histmatch.pwl_apply_hier(x, e16, M3, q0, zval, ztrg)
    assert _kernels.LAUNCHES["pwl_hier"] == before + 1
    ref = pallas_histmatch._pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg)
    _close(out, ref, 0.0)
    _close(out[:, 0], q0, 0.0)


@pytest.mark.parametrize("N", [1, 1000, 40 * 128])
def test_pwl_flat(dev, N):
    gen = torch.Generator(device=dev).manual_seed(N + 2)
    B = 3
    (edges, d0, d1, q0, _, _), x = _pwl_case(gen, dev, B, N)
    w = torch.cat([torch.stack([d0, d0 * 0.0, d0 * 0.0, d1, d1 * 0.0, d1 * 0.0], dim=1),
                   torch.zeros((B, 2, 128), device=dev)], dim=1).contiguous()
    before = _kernels.LAUNCHES["pwl_flat"]
    out = pallas_histmatch.pwl_apply(x, edges.contiguous(), w, q0)
    assert _kernels.LAUNCHES["pwl_flat"] == before + 1
    ref = pallas_histmatch._pwl_apply_plain(x, edges, w, q0)
    _close(out, ref, 0.0)


def _offset(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` floats past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + offset, device=x.device)
    xs = flat[offset:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 == 4 * offset
    return xs


def _specials(x, zval):
    """Pixels NaN, +-inf, below every edge and at the dry value."""
    x = x.clone()
    vals = [float("nan"), float("inf"), float("-inf"), -1e6]
    for k, v in enumerate(vals[: x.shape[1]]):
        x[:, k] = v
    if x.shape[1] > 4:
        x[:, 4] = zval
    return x


def _hier_luts(edges, d0, d1):
    """Five members' hierarchical LUTs: 0 and 4 as built; 1 a NaN fine
    edge, 2 an infinite d0 term, 3 two block starts out of order (all fail
    the prefix check)."""
    edges, d0 = edges.clone(), d0.clone()
    edges[1, 77] = float("nan")
    d0[2, 19] = float("inf")
    edges[3, [40, 48]] = edges[3, [48, 40]]
    e16, M3 = pallas_chain.pack_hier_lut(edges, d0, d1)
    assert pallas_histmatch._pwl_hier_prefix_ok(e16, M3).tolist() == [
        True, False, False, False, True]
    return e16, M3


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("N", [1, 3, 5, 8191, 8193, 320 * 320])
def test_pwl_hier_alignment_and_failing_luts(dev, N, offset):
    """The hierarchical kernel on inputs ``offset`` floats past a 16-byte
    boundary, N below a vector, a block (8,192 pixels) +-1 and path C's
    320^2, members whose LUT fails the prefix check beside members that
    pass, NaN, +-inf, below-range and dry pixels: equal to the plain
    version, one launch a call."""
    gen = torch.Generator(device=dev).manual_seed(N + offset + 11)
    B = 5
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, N)
    e16, M3 = _hier_luts(edges, d0, d1)
    x = _specials(x, zval)
    ztrg = ztrg.expand(B)
    before = _kernels.LAUNCHES["pwl_hier"]
    out = pallas_histmatch.pwl_apply_hier(_offset(x, offset), e16, M3, q0, zval, ztrg)
    assert _kernels.LAUNCHES["pwl_hier"] == before + 1
    _close(out, pallas_histmatch._pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg), 0.0)


def _flat_luts(edges, d0, d1):
    """Five members' flat LUTs: 0 and 4 as built; 1 an infinite weight, 2 a
    NaN weight, 3 two distinct edges swapped (all fail the prefix check)."""
    w = pallas_histmatch.flat_weights(d0, d1)
    edges = edges.clone()
    w[1, 0, 100] = float("inf")
    w[2, 4, 50] = float("nan")
    edges[3, [30, 90]] = edges[3, [90, 30]]
    assert pallas_histmatch._pwl_flat_prefix_ok(edges, w).tolist() == [
        True, False, False, False, True]
    return edges.contiguous(), w


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("N", [1, 3, 5, 16383, 16385, 512 * 512])
def test_pwl_flat_alignment_and_failing_luts(dev, N, offset):
    """The flat kernel as the hierarchical one above: blocks of 16,384
    pixels +-1 and path D's 512^2 a member."""
    gen = torch.Generator(device=dev).manual_seed(N + offset + 12)
    B = 5
    (edges, d0, d1, q0, zval, _), x = _pwl_case(gen, dev, B, N)
    edges, w = _flat_luts(edges, d0, d1)
    x = _specials(x, zval)
    before = _kernels.LAUNCHES["pwl_flat"]
    out = pallas_histmatch.pwl_apply(_offset(x, offset), edges, w, q0)
    assert _kernels.LAUNCHES["pwl_flat"] == before + 1
    _close(out, pallas_histmatch._pwl_apply_plain(x, edges, w, q0), 0.0)


@pytest.mark.parametrize("weight", [float("inf"), float("nan")])
def test_pwl_flat_non_finite_weights(dev, weight):
    """One weight +inf or NaN in every member: the plain version (and the
    JAX package on the CPU) gives NaN at every pixel whose edge for it is
    not selected (inf x 0), and so must the kernel.  A kernel that adds
    only the selected weights gives finite values there."""
    gen = torch.Generator(device=dev).manual_seed(13)
    B = 3
    (edges, d0, d1, q0, _, _), x = _pwl_case(gen, dev, B, 40 * 128)
    w = pallas_histmatch.flat_weights(d0, d1)
    w[:, 0, 100] = weight
    edges = edges.contiguous()
    ref = pallas_histmatch._pwl_apply_plain(x, edges, w, q0)
    below = x < edges[:, 100:101]
    assert bool(below.any()) and bool(torch.isnan(ref[below]).all())
    _close(pallas_histmatch.pwl_apply(x, edges, w, q0), ref, 0.0)


@pytest.mark.parametrize("path", ["C", "D"])
def test_pwl_maps_at_the_path_shapes(dev, path):
    """The hierarchical map at path C's 96 x 320^2 and the flat map at path
    D's 96 x 512^2, member LUTs as STEPS builds them: equal to the plain
    versions."""
    gen = torch.Generator(device=dev).manual_seed(14)
    B, N = (96, 320 * 320) if path == "C" else (96, 512 * 512)
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, N)
    if path == "C":
        e16, M3 = pallas_chain.pack_hier_lut(edges, d0, d1)
        args = (x, e16, M3, q0, zval, ztrg.expand(B))
        assert bool(pallas_histmatch._pwl_hier_prefix_ok(e16, M3).all())
        _close(pallas_histmatch.pwl_apply_hier(*args),
               pallas_histmatch._pwl_apply_hier_plain(*args), 0.0)
    else:
        args = (x, edges.contiguous(), pallas_histmatch.flat_weights(d0, d1), q0)
        assert bool(pallas_histmatch._pwl_flat_prefix_ok(*args[1:3]).all())
        _close(pallas_histmatch.pwl_apply(*args), pallas_histmatch._pwl_apply_plain(*args), 0.0)


NEG_NAN = np.array(0xFFC00000, np.uint32).view(np.float32)  # NaN, sign bit set
CDF_CASES = ["unsorted", "all_equal", "tie_runs", "signed_zero", "infinite", "one_nan",
             "all_nan", "negative_nan", "nan_pixels", "hot_value", "one_value"]


def cdf_case(name, n=1024, seed=0):
    """Pixels (n,) and 128 edges of one named case of the CDF counts, as
    numpy f32: a field on a half-unit grid (many pixels tie with an edge)
    and unsorted edges, most of them pixel values, then the case's twist.
    The CPU tests of the kernel's model share them."""
    rng = np.random.default_rng(seed)
    x = (np.round(rng.normal(0.0, 2.0, n) * 2.0) / 2.0).astype(np.float32)
    edges = np.concatenate([x[rng.integers(0, n, 96)], rng.normal(0.0, 3.0, 32)])
    edges = rng.permutation(edges).astype(np.float32)
    if name == "all_equal":
        edges[:] = x[n // 2]
    elif name == "tie_runs":
        edges = np.repeat(edges[:16], 8)[rng.permutation(128)]
    elif name == "signed_zero":
        edges[rng.permutation(128)[:40]] = np.where(np.arange(40) % 2, 0.0, -0.0)
        x[rng.permutation(n)[: n // 4]] = np.where(np.arange(n // 4) % 2, 0.0, -0.0)
    elif name == "infinite":
        edges[rng.permutation(128)[:20]] = np.where(np.arange(20) % 2, np.inf, -np.inf)
        k = min(n, 6)
        x[:k] = np.array([np.inf, -np.inf, np.inf, -np.inf, 0.0, np.inf])[:k]
    elif name == "one_nan":
        edges[37] = np.nan
    elif name == "all_nan":
        edges[:] = np.nan
    elif name == "negative_nan":
        edges[rng.permutation(128)[:5]] = NEG_NAN
        edges[:3] = [-np.inf, np.nan, np.inf]
    elif name == "nan_pixels":
        x[rng.permutation(n)[: n // 10]] = np.nan
        x[rng.permutation(n)[: min(n, 7)]] = NEG_NAN
    elif name == "hot_value":
        # 90% of the pixels share one value, itself an edge: one bin holds them
        x[rng.permutation(n)[: 9 * n // 10]] = -15.0
        edges[5] = -15.0
    elif name == "one_value":
        # every pixel equals one edge's value
        x[:] = edges[5]
    else:
        assert name == "unsorted"
    return x, edges


def _cdf_inputs(dev, case, B, N, offset=0):
    """B members of ``case`` (member b from seed b), on the card; with
    ``offset`` floats before the field in its buffer, so that its data
    pointer leaves 16-byte alignment."""
    cases = [cdf_case(case, N, seed=b) for b in range(B)]
    buf = torch.empty(B * N + offset, device=dev)
    x = buf[offset:].view(B, N)
    x.copy_(torch.from_numpy(np.stack([c[0] for c in cases])))
    return x, torch.from_numpy(np.stack([c[1] for c in cases])).to(dev)


def _check_cdf(x, edges):
    """The kernel bit-equal to the plain version and to the CPU model of
    its algorithm, one counted launch a call."""
    before = _kernels.LAUNCHES["cdf_counts"]
    out = pallas_histmatch.cdf_counts(x, edges)
    assert _kernels.LAUNCHES["cdf_counts"] == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == edges.shape
    assert torch.equal(out, pallas_histmatch._cdf_counts_plain(x, edges))
    model = pallas_histmatch._cdf_counts_search_plain(x.cpu(), edges.cpu())
    assert torch.equal(out.cpu(), model)
    return out


@pytest.mark.parametrize("N", [1, 1000, 512 * 512])
@pytest.mark.parametrize("B", [1, 96])
def test_cdf_counts(dev, B, N):
    """Exact counts, bit-equal to the plain version, with unsorted edges, a
    NaN edge, a -inf edge, an edge tied with pixels and a NaN pixel.  Two
    launches in a row: the second gets the first's freed count buffer from
    the allocator, so counts left in it would show."""
    gen = torch.Generator(device=dev).manual_seed(B * 7 + N)
    x = torch.round(torch.randn((B, N), generator=gen, device=dev) * 4.0) / 4.0
    edges = torch.randn((B, 128), generator=gen, device=dev) * 1.5
    edges[:, 0] = float("nan")
    edges[:, 1] = float("-inf")
    edges[:, 2] = x[:, 0]
    x[:, -1] = float("nan")
    ref = pallas_histmatch._cdf_counts_plain(x, edges)
    before = _kernels.LAUNCHES["cdf_counts"]
    first = pallas_histmatch.cdf_counts(x, edges)
    assert _kernels.LAUNCHES["cdf_counts"] == before + 1
    second = pallas_histmatch.cdf_counts(x, edges)
    assert _kernels.LAUNCHES["cdf_counts"] == before + 2
    torch.cuda.synchronize()
    assert first.dtype == torch.float32 and first.shape == (B, 128)
    assert torch.equal(first, ref) and torch.equal(second, ref)
    assert bool((ref[:, 0] == 0).all()) and bool((ref[:, 1] == N - 1).all())
    # the JAX function's form: one field of any shape, edges (128,)
    one = pallas_histmatch.cdf_counts(x[0].reshape(1, N), edges[0])
    assert torch.equal(one, ref[0])


@pytest.mark.parametrize("N", [1, 1001, 512 * 512])
@pytest.mark.parametrize("case", CDF_CASES)
def test_cdf_counts_cases(dev, case, N):
    """Each case of the model's CPU tests on the card, 3 members: sorted
    ties, +-0, +-inf, NaN edges (one, all, sign bit set), NaN pixels, a
    hot bin, one value; N = 1, 1001 (neither a multiple of 4 nor of 128) and 512^2."""
    _check_cdf(*_cdf_inputs(dev, case, 3, N))


@pytest.mark.parametrize("N", [7, 1001, 512 * 512])
def test_cdf_counts_unaligned_field(dev, N):
    """A field whose data pointer is one float past 16-byte alignment: each
    member row starts off its alignment, so the scalar head and tail and
    the vectors between them all run."""
    x, edges = _cdf_inputs(dev, "nan_pixels", 3, N, offset=1)
    assert x.data_ptr() % 16 == 4
    _check_cdf(x, edges)


@pytest.mark.parametrize("case", ["hot_value", "one_value"])
def test_cdf_counts_hot_bin_at_path_e(dev, case):
    """Path E's 96 x 262,144 with 90% and with all of each member's pixels
    in one bin."""
    out = _check_cdf(*_cdf_inputs(dev, case, 96, 512 * 512))
    if case == "one_value":
        assert bool((out.max(dim=1).values == 512 * 512).all())


def _spoil(T):
    """Make members 0 and 1 fail stage 1's prefix-table check (so take the
    15-term fallback): a row whose first fine edge lies above its last, a
    NaN edge."""
    T = T.clone()
    T[0, 6, 0] = T[0, 6, 14] + 1.0
    if T.shape[0] > 1:
        T[1, 3, 7] = float("nan")
    return T


@pytest.mark.parametrize("lut", ["built", "spoilt"])
@pytest.mark.parametrize(
    "shape,D,kr,r,do_rim",
    [
        ((3, 37, 53), 13, 2, 10, True),
        ((2, 37, 53), 48, 3, 5, False),
        ((1, 9, 10), 8, 1, 40, True),  # rim wider than the grid and the strip
        ((2, 384, 768), 48, 2, 10, True),  # 1,179,648 B: just inside the gate
        ((2, 512, 512), 48, 2, 10, True),
        ((3, 300, 200), 48, 2, 10, True),  # no multiple of the strip or step
        ((300, 64, 128), 48, 2, 10, True),  # 600 blocks: more than one wave
        ((2, 700, 64), 0, 2, 10, True),  # taps of a zero bound
        ((2, 200, 100), 48, 3, 20, True),  # 4 wet words a row over many steps
        ((1, 150, 70), 16, 5, 40, True),  # a rim beyond 31 columns: the word walk
    ],
)
def test_chain_stages(dev, shape, D, kr, r, do_rim, lut):
    """Both stages and the whole chain against the plain versions, with
    displacements up to 1.5 D (taps anywhere in stage 1's ring) and a
    different LUT per member; ``spoilt`` LUTs take stage 1's 15-term
    fallback on members 0 and 1.  Stage 1's C is equal under ==; each
    stage launches twice."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + D)
    B, m, n = shape
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, m * n)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    assert bool(pallas_histmatch._pwl_prefix_ok(T).all())
    if lut == "spoilt":
        T = _spoil(T)
        assert not bool(pallas_histmatch._pwl_prefix_ok(T)[:2].any())
    field = x.reshape(B, m, n).contiguous()
    disp = _disp(gen, dev, B, m, n, 1.5 * max(D, 2))
    dy = disp[:, 1].contiguous()
    disp_t = disp.transpose(-1, -2).contiguous()
    nan = float("nan")
    # a threshold that leaves ~0.5% of the matched pixels wet
    matched = pallas_histmatch._pwl_apply_gather_plain(
        field.reshape(B, -1), e8, T, q0, zval, ztrg.expand(B))
    thr = float(torch.quantile(matched, 0.995))
    before = dict(_kernels.LAUNCHES)
    C, rim = pallas_chain.chain_match_vert_rim(
        field, e8, T, q0, zval, ztrg, thr, dy, D, kr, r, do_rim)
    C_ref, rim_ref = pallas_chain._chain_v_plain(
        field, e8, T, q0, zval, ztrg.expand(B), thr, dy, -(-D // 8) * 8, kr, r, do_rim)
    span = float(C_ref.max() - C_ref.min())
    _close(C, C_ref, 0.0)
    _close(rim, rim_ref, 1e-6)
    if do_rim:
        assert 0.0 < float(rim.mean()) < 1.0
    out = pallas_chain.chain_horiz(C, disp_t, D, nan)
    _close(out, pallas_warp._warp_h_plain(C, disp_t, -(-D // 8) * 8, nan), 1e-5 * span)
    full, full_rim = pallas_chain.match_warp_rim(
        field, e8, T, q0, zval, ztrg, thr, dy, disp_t, nan, D, kr, r, do_rim)
    ref, ref_rim = pallas_chain._match_warp_rim_plain(
        field, e8, T, q0, zval, ztrg, thr, dy, disp_t, nan, D, kr, r, do_rim)
    _close(full, ref, 1e-5 * span)
    _close(full_rim, ref_rim, 1e-6)
    assert bool(torch.isnan(ref).any())
    assert _kernels.LAUNCHES["chain_match_vert_rim"] == before["chain_match_vert_rim"] + 2
    assert _kernels.LAUNCHES["chain_horiz"] == before["chain_horiz"] + 2


@pytest.mark.parametrize("halo", [12, 20, 49])
def test_chain_halo_changes_work_not_result(dev, halo):
    """Stage 1 keeps every row a tap can reach and no longer reads the
    halo: any halo that holds the rim gives the default's result bit for
    bit."""
    gen = torch.Generator(device=dev).manual_seed(halo)
    B, m, n, D = 2, 300, 160, 48
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, m * n)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    field = x.reshape(B, m, n).contiguous()
    dy = _disp(gen, dev, B, m, n, 1.5 * D)[:, 1].contiguous()
    args = (field, e8, T, q0, zval, ztrg, 0.0, dy, D, 2, 10, True)
    C, rim = pallas_chain.chain_match_vert_rim(*args)
    C_h, rim_h = pallas_chain.chain_match_vert_rim(*args, halo=halo)
    assert torch.equal(C, C_h) and torch.equal(rim, rim_h)


def test_chain_stage1_geometry_and_limits(dev):
    """Stage 1's ring, shared memory and matches per output at path A's
    shape; a ring beyond the card's shared memory, and a rim radius beyond
    a byte distance, are refused and raise."""
    info = pallas_chain.stage1_info(512, 512, 48, 2, 10)
    assert info["ring_rows"] == 2 * 32 + 49 + 48
    # 8 strips of 64 columns, each matched with 12 columns on either side
    # that lie in the field: 76 + 6 x 88 + 76 columns a row
    assert info["matches_per_output"] == (2 * 76 + 6 * 88) / 512
    assert 48 * 1024 < info["smem_bytes"] < 64 * 1024 and info["blocks_per_sm"] >= 1
    assert pallas_chain.stage1_info(512, 512, 48, 2, 10, do_rim=False)["matches_per_output"] == 1
    B, m, n = 1, 1000, 64
    f = torch.zeros((B, m, n), device=dev)
    e8, T = torch.zeros((B, 8), device=dev), torch.zeros((B, 8, 48), device=dev)
    q = torch.zeros(B, device=dev)
    with pytest.raises(RuntimeError):
        pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 400, 2, 10)
    with pytest.raises(RuntimeError):
        pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 8, 100, 200)
    # the shared-memory limit falls where stage1_info computes it
    fits = pallas_chain.stage1_info(m, n, 320, 2, 10, device="cpu")
    over = pallas_chain.stage1_info(m, n, 328, 2, 10, device="cpu")
    assert fits["fits"] and not over["fits"]
    assert pallas_chain.stage1_info(m, n, 320, 2, 10)["smem_bytes"] == fits["smem_bytes"]
    pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 320, 2, 10)
    with pytest.raises(RuntimeError):
        pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 328, 2, 10)
    # the rim limit falls at MAX_RIM, as the STEPS gate assumes
    pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 8, 4, pallas_chain.MAX_RIM - 4)
    with pytest.raises(RuntimeError):
        pallas_chain.chain_match_vert_rim(f, e8, T, q, q, q, 0.0, f, 8, 4, pallas_chain.MAX_RIM - 3)
    torch.cuda.synchronize()


@pytest.mark.parametrize(
    "shape,D,kr,r,do_rim",
    [
        ((2, 512, 512), 48, 2, 10, True),
        ((2, 512, 512), 48, 2, 10, False),
        ((3, 300, 200), 48, 2, 10, True),
        ((2, 700, 64), 0, 2, 10, True),
        ((1, 150, 70), 16, 5, 40, True),
    ],
)
def test_chain_stage1_matches_each_window_pixel_once(dev, shape, D, kr, r, do_rim):
    """The counting instantiation stores the map of every window pixel once:
    its count is the geometry's matches per output times the batch's
    pixels, and its outputs are the launched kernel's."""
    gen = torch.Generator(device=dev).manual_seed(sum(shape))
    B, m, n = shape
    (edges, d0, d1, q0, zval, ztrg), x = _pwl_case(gen, dev, B, m * n)
    e8, T = pallas_histmatch.pack_gather_lut(edges, d0, d1)
    field = x.reshape(B, m, n).contiguous()
    dy = _disp(gen, dev, B, m, n, 1.5 * max(D, 2))[:, 1].contiguous()
    args = (field, e8, T, q0, zval, ztrg, 0.0, dy, D, kr, r, do_rim)
    before = dict(_kernels.LAUNCHES)
    C_c, rim_c, matches = pallas_chain.stage1_matches(*args)
    assert _kernels.LAUNCHES == before
    C, rim = pallas_chain.chain_match_vert_rim(*args)
    assert torch.equal(C.nan_to_num(), C_c.nan_to_num()) and torch.equal(rim, rim_c)
    info = pallas_chain.stage1_info(m, n, D, kr, r, do_rim)
    assert matches == round(info["matches_per_output"] * B * m * n)


@pytest.mark.parametrize("kr,r", [(1, 1), (2, 10), (3, 6)])
@pytest.mark.parametrize("shape", [(2, 37, 53), (1, 9, 10)])
def test_k4_rim(dev, kr, r, shape):
    """Both entry points; (9, 10) is narrower than the rim radius."""
    gen = torch.Generator(device=dev).manual_seed(kr * 10 + r)
    field = torch.rand(shape, generator=gen, device=dev)
    before = dict(_kernels.LAUNCHES)
    out = pallas_dilate.dilated_rim_from_field(field, 0.9, kr, r)
    _close(out, pallas_dilate._rim_plain(field, 0.9, kr, r), 1e-6)
    mask = (field >= 0.9).to(torch.float32)
    out_m = pallas_dilate.dilated_rim(mask, kr, r)
    _close(out_m, pallas_dilate._rim_plain(mask, 0.5, kr, r), 1e-6)
    _close(out_m, out, 1e-6)
    assert _kernels.LAUNCHES["rim_from_field"] == before["rim_from_field"] + 1
    assert _kernels.LAUNCHES["rim_from_mask"] == before["rim_from_mask"] + 1


def _rim_field(gen, dev, shape, nan_frac=0.03):
    """Uniform [0, 1) fields with a share of NaN pixels."""
    field = torch.rand(shape, generator=gen, device=dev)
    nan = torch.rand(shape, generator=gen, device=dev) < nan_frac
    return torch.where(nan, float("nan"), field)


@pytest.mark.parametrize("kr,r", [
    (0, 0),  # R = 0: only wet pixels count
    (2, 10),  # the STEPS rim
    (3, 28),  # R = 31, the last funnel-shift radius
    (3, 30),  # R = 33: the word walk
    (4, 250),  # R = 254, the tile kernel's limit
    (5, 250),  # R = 255: the two-pass kernels
])
@pytest.mark.parametrize("shape", [
    (5, 130, 67),  # neither side a multiple of the tile
    (1, 9, 10),  # every R but 0 wider than the field
    (1, 512, 512),  # the STEPS init mask
    (300, 64, 64),  # more blocks than one wave
])
def test_k4_rim_tiles(dev, kr, r, shape):
    """Both entry points on fields with NaN pixels against the plain
    version, two calls in a row, each call one launch of its counter."""
    gen = torch.Generator(device=dev).manual_seed(kr + 7 * r + shape[1])
    field = _rim_field(gen, dev, shape)
    field[:, 0, 0] = 1.0  # at least one wet pixel a member
    thr = 0.97
    ref = pallas_dilate._rim_plain(field, thr, kr, r)
    mask = field >= thr
    for _ in range(2):
        before = dict(_kernels.LAUNCHES)
        out = pallas_dilate.dilated_rim_from_field(field, thr, kr, r)
        out_m = pallas_dilate.dilated_rim(mask, kr, r)
        after = dict(_kernels.LAUNCHES)
        _close(out, ref, 1e-6)
        _close(out_m, ref, 1e-6)
        assert after == dict(before, rim_from_field=before["rim_from_field"] + 1,
                             rim_from_mask=before["rim_from_mask"] + 1)
    assert 0.0 < float(ref.mean()) < 1.0


@pytest.mark.parametrize("thr", [float("inf"), float("-inf")])
def test_k4_rim_infinite_thresholds(dev, thr):
    """+inf: only +inf pixels are wet; -inf: all but NaN."""
    gen = torch.Generator(device=dev).manual_seed(3)
    field = _rim_field(gen, dev, (3, 70, 150), nan_frac=0.2)
    field[0, 5, 9] = float("inf")
    out = pallas_dilate.dilated_rim_from_field(field, thr, 2, 10)
    _close(out, pallas_dilate._rim_plain(field, thr, 2, 10), 1e-6)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.float32, torch.int32])
def test_k4_rim_mask_dtypes(dev, dtype):
    """The mask entry point reads bool, uint8 and float32 masks as given
    (wet where > 0: a float mask's values in (0, 1) and not its NaN or
    negative ones); other dtypes are made bool first."""
    gen = torch.Generator(device=dev).manual_seed(4)
    u = torch.rand((2, 97, 131), generator=gen, device=dev)
    vals = torch.where(u > 0.98, u - 0.5, torch.where(u < 0.01, -u, 0.0))
    if dtype == torch.float32:
        vals = torch.where(u < 0.003, float("nan"), vals)
        mask = vals
    else:
        mask = (vals > 0).to(dtype) * (3 if dtype != torch.bool else 1)
    ref = pallas_dilate._rim_plain((vals > 0).to(torch.float32), 0.5, 2, 10)
    before = _kernels.LAUNCHES["rim_from_mask"]
    _close(pallas_dilate.dilated_rim(mask, 2, 10), ref, 1e-6)
    assert _kernels.LAUNCHES["rim_from_mask"] == before + 1


def test_k4_rim_route_and_geometry(dev):
    """The tile kernel up to MAX_RIM; its tile rows fill the card for the
    STEPS init mask and stay 128 for a large batch."""
    assert pallas_dilate.rim_route(4, pallas_dilate.MAX_RIM - 4) == "tile"
    assert pallas_dilate.rim_route(4, pallas_dilate.MAX_RIM - 3) == "two_pass"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    init = pallas_dilate.rim_info(1, 512, 512, 2, 10)
    assert init["W"] == 128 and init["H"] == 8 and init["blocks"] >= sms
    big = pallas_dilate.rim_info(32, 1024, 1024, 2, 10)
    assert big["H"] == 128 and big["blocks"] == 32 * 8 * 8
    assert big["blocks_per_sm"] == 8
    with pytest.raises(RuntimeError):
        pallas_dilate.rim_info(1, 64, 64, 4, pallas_dilate.MAX_RIM - 3)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    f = torch.zeros((2, 16, 16), device=dev)
    idx = torch.zeros((2, 16, 16), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pallas_warp.axis_resample(f, idx.float(), f, 4, 0)
    with pytest.raises(ValueError):
        pallas_warp.axis_resample(f.transpose(1, 2), idx, f, 4, 0)
    with pytest.raises(ValueError):
        pallas_warp.warp_fused(f, f, f, 8, 0.0)
    with pytest.raises(ValueError):
        pallas_dilate.dilated_rim_from_field(f.double(), 0.5, 1, 1)
    e8, T = torch.zeros((2, 8), device=dev), torch.zeros((2, 8, 48), device=dev)
    q = torch.zeros(2, device=dev)
    with pytest.raises(ValueError):
        pallas_chain.match_warp_rim(f, e8, T, q, q, q, 0.0, f, f, 0.0, 8, 2, 10)
    with pytest.raises(ValueError):
        pallas_histmatch.pwl_apply_hier(
            f.reshape(2, -1), q[:, None].expand(2, 16), T, q, q, q)
    with pytest.raises(ValueError):
        pallas_histmatch.pwl_apply(f.reshape(2, -1), T.reshape(2, -1)[:, :100], T, q)
    x, edges = torch.zeros((2, 256), device=dev), torch.zeros((2, 128), device=dev)
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x, edges.cpu())
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(torch.zeros((256, 2), device=dev).t(), edges)
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x.double(), edges)
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x, edges[:, :64])
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x, torch.zeros((128, 2), device=dev).t())
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x[:1], edges)
    with pytest.raises(ValueError):
        pallas_histmatch.cdf_counts(x, edges[None])
