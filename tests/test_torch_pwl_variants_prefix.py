"""The prefix-table evaluation of the hierarchical and flat PWL maps
(``csrc/pwl_variants.cu``), through their plain models
``pallas_histmatch._pwl_apply_hier_prefix_plain`` and
``_pwl_apply_flat_prefix_plain``, held on the CPU against the full sums
(``_pwl_apply_hier_plain``, ``_pwl_apply_plain``) and the JAX package's
``pwl_apply_hier`` and ``pwl_apply`` (Pallas in interpret mode), on LUTs
that the JAX package's ``build_pwl_coeffs`` builds from numpy-seeded fields
with a dry floor (duplicated edges, ``zval`` pixels); pixels equal to an
edge, below the first edge, NaN and +-inf.  Also the search tree the two
kernels share, their prefix checks and fallbacks, the IEEE result of the
flat map on non-finite weights, and the split of a member's pixels over
the blocks of ``common.cuh::pst_stream``.

Tolerances: none between a model and its full sum (equal under ==, NaN
where NaN).  Against JAX 1e-5 x scale, the coefficient of
``tests/test_torch_pwl_variants.py``; JAX sums the same f32 terms on its
matrix unit in another order, and the difference of two orders grows with
the terms, not with the result, so the scale is the size of the sum,
|q0| + sum |d0| + max |x| sum |d1| (the bound of ``chip_smoke.py``'s path D
check has the same form).  These dB fields' dry edge makes steep segments
(sum |d0| up to 77,869): the results' own magnitude would be the scale of
two orders' rounding only on LUTs without them.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pysteps_tpu.ops import pallas_chain as jpc
from pysteps_tpu.ops import pallas_histmatch as jph
from pysteps_tpu.postprocessing import probmatching as jpm
from pysteps_tpu_torch.ops import pallas_chain as tpc
from pysteps_tpu_torch.ops import pallas_histmatch as tph


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jph, "INTERPRET", True)
    monkeypatch.setattr(jpc, "INTERPRET", True)


def _equal(a, b):
    """Equal under == with the same NaN set."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a), torch.nan_to_num(b))


def _member(shape, seed):
    """One member: a dB field with a dry floor and JAX's LUT for it, as
    numpy; after the build, pixels set to edges, below the first edge, NaN
    and +-inf.  Returns (field, edges, d0, d1, (q0, zval, ztrg))."""
    rng = np.random.default_rng(seed)
    target = np.where(
        rng.random(shape) > 0.55, rng.gamma(2.0, 6.0, shape) + 5.0, -15.0
    ).astype(np.float32)
    field = np.maximum(target + rng.normal(0.0, 2.0, shape), -15.0).astype(np.float32)
    field[rng.random(shape) < 0.3] = -15.0  # the dry floor: zval pixels
    ranked, zv = jpm._prepare_cdf_target(jnp.asarray(target))
    coeffs = jph.build_pwl_coeffs(jnp.asarray(field.reshape(-1)), jph.prepare_target(ranked, zv))
    edges, d0, d1 = (np.array(c) for c in coeffs[:3])
    x = field.reshape(-1)
    pick = rng.choice(x.size, 40, replace=False)
    x[pick[:20]] = edges[rng.integers(0, 128, 20)]
    x[pick[20:25]] = edges[0] - np.float32([0.5, 1.0, 3.0, 10.0, 1e6])
    x[pick[25:30]] = np.nan
    x[pick[30:33]] = np.inf
    x[pick[33:36]] = -np.inf
    return field, edges, d0, d1, tuple(float(coeffs[i]) for i in (3, 4, 5))


def _batch(shape, seeds):
    """Members of ``_member`` stacked; the LUTs as torch tensors."""
    ms = [_member(shape, s) for s in seeds]
    x = torch.from_numpy(np.stack([m[0].reshape(-1) for m in ms]))
    edges, d0, d1 = (torch.from_numpy(np.stack([m[i] for m in ms])) for i in (1, 2, 3))
    q0, zval, ztrg = (torch.tensor([m[4][i] for m in ms], dtype=torch.float32)
                      for i in range(3))
    return x, edges, d0, d1, q0, zval, ztrg, ms


def _jax_close(out, ref, x, edges, d0, d1, q0):
    """Within 1e-5 x scale of JAX, NaN where JAX has NaN, on the pixels
    other than +-inf (there x * slope is inf or NaN by the last rounding of
    a slope that should be 0); the scale is the size of the sum (see the
    module's docstring)."""
    keep = ~torch.isinf(x)
    out, ref = out[keep], ref[keep]
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    xmax = float(x[keep & (x >= edges[0])].nan_to_num().abs().max())
    scale = abs(float(q0)) + float(d0.abs().sum()) + xmax * float(d1.abs().sum())
    assert float((out[fin] - ref[fin]).abs().max()) <= 1e-5 * scale


SHAPES = [((64, 128), (1, 2)), ((320, 320), (3, 4)), ((40, 128), (5, 6))]


@pytest.mark.parametrize("shape,seeds", SHAPES)
def test_hier_prefix_model_is_the_7_term_sum_and_jax(shape, seeds):
    """320^2 is path C's field (800 rows of 128, tiled in 16s); 40 rows is
    no multiple of 32."""
    x, edges, d0, d1, q0, zval, ztrg, ms = _batch(shape, seeds)
    e16, M3 = tpc.pack_hier_lut(edges, d0, d1)
    assert bool(tph._pwl_hier_prefix_ok(e16, M3).all())
    assert bool((edges[:, 1:] == edges[:, :-1]).any(dim=1).all())  # the dry floor
    assert bool(((x < e16[:, :1]) & torch.isfinite(x)).any(dim=1).all())
    assert bool((x == zval[:, None]).any(dim=1).all())
    out = tph._pwl_apply_hier_prefix_plain(x, e16, M3, q0, zval, ztrg)
    assert _equal(out, tph._pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg))
    assert _equal(tph.pwl_apply_hier(x, e16, M3, q0, zval, ztrg), out)
    below = (x < e16[:, :1]) & torch.isfinite(x)  # -inf gives q0 + (0 + -inf * 0)
    assert torch.equal(out[below], q0[:, None].expand_as(x)[below])
    for b, m in enumerate(ms):
        e16_j, M3_j = jpc.pack_hier_lut(*(jnp.asarray(a) for a in m[1:4]))
        ref = jph.pwl_apply_hier(jnp.asarray(x[b].numpy()), e16_j, M3_j, *m[4])
        _jax_close(out[b], torch.from_numpy(np.array(ref)), x[b], edges[b], d0[b], d1[b], q0[b])


@pytest.mark.parametrize("shape,seeds", SHAPES)
def test_flat_prefix_model_is_the_128_term_sum_and_jax(shape, seeds):
    x, edges, d0, d1, q0, _, _, _ = _batch(shape, seeds)
    w = tph.flat_weights(d0, d1)
    assert bool(tph._pwl_flat_prefix_ok(edges, w).all())
    out = tph._pwl_apply_flat_prefix_plain(x, edges, w, q0)
    assert _equal(out, tph._pwl_apply_plain(x, edges, w, q0))
    assert _equal(tph.pwl_apply(x, edges, w, q0), out)
    for b in range(x.shape[0]):
        ref = jph.pwl_apply(jnp.asarray(x[b].numpy()), jnp.asarray(edges[b].numpy()),
                            jnp.asarray(w[b].numpy()), jnp.float32(q0[b]))
        _jax_close(out[b], torch.from_numpy(np.array(ref)), x[b], edges[b], d0[b], d1[b], q0[b])


@pytest.mark.parametrize("levels", [4, 7])
def test_tree_count_is_the_number_of_edges_at_or_below(levels):
    """The level-order tree of both kernels counts #{j : x >= e_j} for
    nondecreasing edges with repeats and +-inf, for values on, between and
    beyond them, NaN (count 0) and +-inf."""
    rng = np.random.default_rng(levels)
    n = 1 << levels
    e = np.sort(rng.integers(-6, 6, (3, n)).astype(np.float32), axis=1)
    e[1, :2], e[2, -3:] = -np.inf, np.inf
    x = np.concatenate([rng.uniform(-8, 8, (3, 200)), e, e + 0.5, e - 0.5,
                        np.float32([[np.nan, np.inf, -np.inf]] * 3)], axis=1).astype(np.float32)
    t = tph._tree_count(torch.from_numpy(x), torch.from_numpy(e), levels)
    ref = (x[:, :, None] >= e[:, None, :]).sum(axis=2)
    np.testing.assert_array_equal(t.numpy(), ref)
    src = tph._tree_src(levels)
    assert sorted(src[1:]) == list(range(1, n))


def _spoilt_hier(edges, d0, d1):
    """Per member, a LUT that fails the hierarchical check: a block's fine
    edges out of order, a NaN fine edge, an infinite d0 and a NaN d1 term,
    two block starts swapped; member 0 is left as built."""
    edges, d0, d1 = edges.clone(), d0.clone(), d1.clone()
    edges[1, [42, 45]] = edges[1, [45, 42]]
    edges[2, 77] = float("nan")
    d0[3, 19] = float("inf")
    d1[4, 100] = float("nan")
    edges[5, [40, 48]] = edges[5, [48, 40]]
    return edges, d0, d1


def test_hier_check_refuses_and_falls_back():
    x, edges, d0, d1, q0, zval, ztrg, _ = _batch((64, 128), range(10, 16))
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    edges, d0, d1 = _spoilt_hier(edges, d0, d1)
    e16, M3 = tpc.pack_hier_lut(edges, d0, d1)
    ok = tph._pwl_hier_prefix_ok(e16, M3)
    assert ok.tolist() == [True] + [False] * 5
    out = tph._pwl_apply_hier_prefix_plain(x, e16, M3, q0, zval, ztrg)
    assert _equal(out, tph._pwl_apply_hier_plain(x, e16, M3, q0, zval, ztrg))
    # the tables alone would differ on the fine edges out of order and on
    # the swapped block starts
    g = tph._tree_count(x, e16, 4)
    count = (x[:, :, None] >= e16[:, None, :]).sum(dim=2)
    assert not torch.equal(g[5], count[5]) and torch.equal(g[0], count[0])
    a0, a1 = tph._pwl_hier_prefix_acc(x, e16, M3)
    naive = torch.where(x == zval[:, None], ztrg[:, None], q0[:, None] + (a0 + x * a1))
    assert not _equal(naive[1], out[1]) and not _equal(naive[5], out[5])
    assert _equal(naive[0], out[0])

def test_flat_check_refuses_and_falls_back():
    x, edges, d0, d1, q0, _, _, _ = _batch((64, 128), range(20, 25))
    w = tph.flat_weights(d0, d1)
    edges, w = edges.clone(), w.clone()
    edges[1, [30, 90]] = edges[1, [90, 30]]
    edges[2, 0] = float("nan")
    w[3, 1, 64] = float("inf")
    w[4, 5, 127] = float("nan")
    assert tph._pwl_flat_prefix_ok(edges, w).tolist() == [True] + [False] * 4
    out = tph._pwl_apply_flat_prefix_plain(x, edges, w, q0)
    assert _equal(out, tph._pwl_apply_plain(x, edges, w, q0))
    assert _equal(tph.pwl_apply(x, edges, w, q0), out)
    # the unordered member: the tree's count is not the number of edges
    # at or below, so the table alone would give other values
    t = tph._tree_count(x[1:2], edges[1:2], 7)
    assert not torch.equal(t, (x[1:2, :, None] >= edges[1:2, None, :]).sum(dim=2))


@pytest.mark.parametrize("weight", [float("inf"), float("nan")])
def test_flat_non_finite_weight_is_ieee_like_jax(weight):
    """A weight w[0, 100] of +inf (or NaN): JAX's ``pwl_apply`` gives NaN
    at every pixel below edge 100 (inf x 0 in its product) and +inf at or
    above it (NaN everywhere for a NaN weight), and so do the plain version,
    the prefix model and the wrapper.  A sum that skips the unselected
    terms (what the flat kernel did before its repair) is finite below."""
    field, edges, d0, d1, (q0, _, _) = _member((40, 128), 7)
    x = np.nan_to_num(field.reshape(-1), nan=0.0, posinf=0.0, neginf=0.0)
    w = tph.flat_weights(torch.from_numpy(d0)[None], torch.from_numpy(d1)[None])[0].numpy()
    w[0, 100] = weight
    ref = np.array(jph.pwl_apply(jnp.asarray(x), jnp.asarray(edges), jnp.asarray(w),
                                 jnp.float32(q0)))
    args = (torch.from_numpy(x)[None], torch.from_numpy(edges)[None],
            torch.from_numpy(w)[None], torch.tensor([q0]))
    below = x < edges[100]
    assert below.any() and (~below).any()
    if weight == np.inf:
        assert np.array_equal(np.isnan(ref), below) and np.isposinf(ref[~below]).all()
    else:
        assert np.isnan(ref).all()
    for out in (tph._pwl_apply_plain(*args), tph._pwl_apply_flat_prefix_plain(*args),
                tph.pwl_apply(*args)):
        out = out[0].numpy()
        assert np.array_equal(np.isnan(out), np.isnan(ref))
        assert np.array_equal(np.isposinf(out), np.isposinf(ref))
    if weight == np.inf:
        W0, W1 = tph._flat_terms(torch.from_numpy(w)[None])
        on = torch.from_numpy(x)[:, None] >= torch.from_numpy(edges)[None]
        skipped = q0 + torch.where(on, W0, 0.0).sum(1) + torch.from_numpy(x) * torch.where(
            on, W1, 0.0).sum(1)
        assert bool(torch.isfinite(skipped[torch.from_numpy(below)]).all())


def test_hier_non_finite_table_entry_stays_in_its_block():
    """An infinite d0 term f of block g0 (in M3's first split): the port
    (plain version and prefix model, which falls back) follows IEEE within
    the block, NaN below the term's edge (inf x 0) and +inf at or above
    it, and leaves every other pixel as without the entry.  JAX's CPU build
    selects the column by a one-hot product, so inf x 0 reaches the other
    blocks: NaN at exactly their pixels whose own fine compare f hits (XLA
    makes d * float(x >= e) a select), none below the term's edge in block
    g0.  What the TPU gives is not known (ROADMAP C)."""
    field, edges, d0, d1, (q0, zval, ztrg) = _member((40, 128), 9)
    x = np.nan_to_num(field.reshape(-1), nan=0.0, posinf=0.0, neginf=0.0)
    e16, M3 = (np.array(a) for a in jpc.pack_hier_lut(*(jnp.asarray(a) for a in (edges, d0, d1))))
    g = (x[:, None] >= e16[:, 0][None]).sum(axis=1)
    f = 6
    sel = (M3[0:24] + M3[24:48]) + M3[48:72]
    blocks = [k for k in range(16) if ((g == k + 1) & (x < sel[f, k]) & (x != zval)).any()
              and ((g == k + 1) & (x >= sel[f, k])).any()]
    g0 = blocks[0]
    bad = M3.copy()
    bad[7 + f, g0] = np.inf
    args = (torch.from_numpy(x)[None], torch.from_numpy(e16[:, 0])[None],
            torch.from_numpy(bad)[None], *(torch.tensor([v]) for v in (q0, zval, ztrg)))
    assert not bool(tph._pwl_hier_prefix_ok(args[1], args[2]).any())
    port = tph._pwl_apply_hier_plain(*args)[0].numpy()
    assert np.array_equal(port, tph._pwl_apply_hier_prefix_plain(*args)[0].numpy(),
                          equal_nan=True)
    clean = tph._pwl_apply_hier_plain(args[0], args[1], torch.from_numpy(M3)[None],
                                      *args[3:])[0].numpy()
    wet = x != zval
    blk = (g == g0 + 1) & wet
    assert np.array_equal(np.isnan(port), blk & (x < sel[f, g0]))
    assert np.array_equal(np.isposinf(port), blk & (x >= sel[f, g0]))
    assert np.array_equal(port[~blk], clean[~blk])
    ref = np.array(jph.pwl_apply_hier(jnp.asarray(x), jnp.asarray(e16), jnp.asarray(bad),
                                      q0, zval, ztrg))
    own_f = sel[f][np.clip(g - 1, 0, 15)]
    hits = (g > 0) & (g != g0 + 1) & (x >= own_f) & wet
    assert hits.any()
    assert np.array_equal(np.isnan(ref), hits)
    assert np.array_equal(np.isposinf(ref), np.isposinf(port))


def _stream_cover(N, x_off, o_off, pix):
    """How ``common.cuh::pst_stream`` splits one member's N pixels over
    blocks of ``pix``, the input and output rows starting ``x_off`` and
    ``o_off`` floats past a 16-byte boundary: per pixel, the times a block
    maps it; and the first pixel of every 16-byte vector."""
    count = np.zeros(N, np.int64)
    starts = []
    nbx = -(-N // pix)
    for bx in range(nbx):
        p0, p1 = bx * pix, min(bx * pix + pix, N)
        if (x_off - o_off) % 4:  # the member goes scalar
            count[p0:p1] += 1
            continue
        head = min((4 - x_off) % 4, N)
        nv = (N - head) // 4
        tail = head + 4 * nv
        if bx == 0:
            count[:head] += 1
        if bx == nbx - 1:
            count[tail:] += 1
        v0, v1 = p0 // 4, min(p1 // 4, nv)
        if v1 > v0:
            count[head + 4 * v0:head + 4 * v1] += 1
            starts.append(head + 4 * np.arange(v0, v1))
    return count, np.concatenate(starts or [np.zeros(0, np.int64)])


@pytest.mark.parametrize("pix", [8192, 16384])
@pytest.mark.parametrize("N", [1, 3, 5, 8191, 8193, 102400, 262144 + 7])
def test_stream_blocks_cover_each_pixel_once(N, pix):
    """The hierarchical map's blocks of 8,192 pixels (path C's 102,400 are
    12.5 of them) and the flat map's of 16,384: every pixel mapped once, for
    each offset of the input and output rows; vectors start on 16-byte
    boundaries of both."""
    for x_off in range(4):
        for o_off in range(4):
            count, starts = _stream_cover(N, x_off, o_off, pix)
            assert (count == 1).all()
            if (x_off - o_off) % 4 == 0:
                assert ((starts + x_off) % 4 == 0).all()
                assert len(starts) == (N - min((4 - x_off) % 4, N)) // 4
            else:
                assert len(starts) == 0
