"""K8's node-range mode as the card runs it (csrc/coeff_scatter.cu): the
rank's rows cut into tiles of ``node_tile_rows`` rows, the live points
listed by tile (the sort), then each tile's sums formed whole and
written once. On the CPU the plain versions run:

  * a tile's f64 sums fit the block's shared memory at every degree 0-12,
    a block of few rows is cut into enough tiles to fill the card, and the
    wrapper's shapes are the kernel's (csrc/coeff_scatter.cu);
  * ``node_buckets_plain`` (the sort the first launch makes: each segment
    of NODE_SORT_POINTS points' live points in tile order) lists every
    live point (its leaf in the block, its cotangent non-zero and, under
    the sentinel, inside the root) exactly once, in the run of its tile
    and segment, at its row, with its coordinates and cotangent, and no
    dead point, at splits 1, 2, 3 and 5 of the small tree, for a block no
    point reaches, a block of no rows, no points and three segments;
  * a plain model of the tile pass built on that sort, summed tile by
    tile, gives ``coeff_scatter_nodes_plain`` and the VJP of hpsdf_tpu's
    query within 1e-12;
  * ``chip_smoke``'s comparison of a kernel's sort run by run takes
    another order within a run and refuses a point replaced, moved to
    another run or given a wrong weight, and a run boundary moved; its
    two wrong gradients are caught.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu_torch import basis, consts
from hpsdf_tpu_torch import parallel as P
from hpsdf_tpu_torch.query import (NODE_MIN_TILES, NODE_SORT_POINTS,
                                   NODE_TILE_ELEMS, NODE_TILE_MAX_ROWS,
                                   _node_buckets_plain, _to_unit,
                                   coeff_scatter_nodes_plain,
                                   node_buckets_plain, node_tile_rows)

import chip_smoke
from .test_torch_node_axis import CFG, GRAD_ATOL, SPLITS, node_query
from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf

# a tile of a few rows, so that the small tree's blocks hold many tiles
SMALL_TILE = 6


@pytest.fixture(scope="module")
def trees():
    cfg = hp.Config(**CFG)
    jt = hp.build_octree(cfg, sphere_sdf(radius=0.3))
    return jt, carry(jt, cfg)


@pytest.fixture(scope="module")
def points():
    """Points straddling the root, cotangents with some zeros."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=1501)
    w[rng.random(1501) < 0.1] = 0.0
    return rng.uniform(-0.6, 0.6, (1501, 3)), w


def live_points(block, pts, leaf, w, outside_value_max):
    n = leaf.long() - block.lo
    live = (n >= 0) & (n < block.hi - block.lo) & (w != 0)
    if outside_value_max:
        live &= torch.all(_to_unit(block, pts).abs() <= 0.5, dim=-1)
    return live


def check_buckets(block, pts, leaf, w, outside_value_max, T):
    """The plain sort lists each live point once, in the run of its tile
    and segment, at its row, and nothing else; each segment's runs follow
    one another from its start."""
    sort = _node_buckets_plain(block, pts, leaf, w, outside_value_max, T)
    offsets, items = sort
    rows = max(block.hi - block.lo, 0)
    n_tiles, G = -(-rows // T), -(-pts.shape[0] // NODE_SORT_POINTS)
    assert offsets.dtype == items.dtype == torch.int32
    assert offsets.shape == (G, n_tiles + 1)
    assert items.shape == (pts.shape[0], 2)
    assert not offsets[:, 0].any()
    assert bool((offsets[:, 1:] >= offsets[:, :-1]).all())
    run, it = chip_smoke.bucket_records(sort)
    live = live_points(block, pts, leaf, w, outside_value_max)
    idx = it[:, 0]
    assert torch.equal(torch.sort(idx).values, torch.nonzero(live).flatten())
    seg, tile = run // max(n_tiles, 1), run % max(n_tiles, 1)
    assert torch.equal(seg, idx // NODE_SORT_POINTS)
    assert torch.equal(tile * T + it[:, 1], leaf.long()[idx] - block.lo)
    assert bool((it[:, 1] >= 0).all() and (it[:, 1] < T).all())
    return sort


def tile_model(block, pts, w, sort, T):
    """The tile pass by plain torch on a sort: each tile's T x C sums of w
    times the basis products at the points its runs list, the tiles
    concatenated."""
    C = consts.coeff_count(block.deg_used)
    rows = max(block.hi - block.lo, 0)
    n_tiles = -(-rows // T)
    run, it = chip_smoke.bucket_records(sort)
    tile = run % max(n_tiles, 1)
    idx_t, norms = basis._tables(block.deg_used, pts)
    tiles = []
    for t in range(n_tiles):
        s = torch.zeros((T, C), dtype=torch.float64)
        mine = tile == t
        r = it[mine, 1]
        row = t * T + r
        d = block.depth[row]
        clamped = _to_unit(block, pts[it[mine, 0]]).clamp(-0.5, 0.5)
        local = (clamped - block.centre[row]) \
            * torch.exp2((d + 1).double())[:, None]
        L = basis.legendre_all(local, block.deg_used)
        phi = (L[:, 0, idx_t[:, 0]] * L[:, 1, idx_t[:, 1]]
               * L[:, 2, idx_t[:, 2]] * norms[d.long()])
        s.index_add_(0, r, w[it[mine, 0], None] * phi)
        tiles.append(s)
    return (torch.cat(tiles)[:rows] if tiles
            else torch.zeros((0, C), dtype=torch.float64))


@pytest.mark.parametrize("deg", range(13))
def test_tile_rows_fit_a_tile(deg):
    """A tile's T x C sums fit the NODE_TILE_ELEMS a block holds in shared
    memory, T is even and the most that fit, up to NODE_TILE_MAX_ROWS; a
    block of few rows is cut
    into at least NODE_MIN_TILES tiles where two rows a tile allow, and
    never into longer tiles than fit."""
    C = consts.coeff_count(deg)
    T = node_tile_rows(deg)
    assert T >= 1 and T % 2 == 0
    assert T * C <= NODE_TILE_ELEMS and T <= NODE_TILE_MAX_ROWS
    # the most even count that fits: a tile two rows longer would not
    assert (T + 2) * C > NODE_TILE_ELEMS or T == NODE_TILE_MAX_ROWS
    for rows in (1, 2, 3, 527, 2_340, 4 * NODE_MIN_TILES + 1, 1_198_376):
        t = node_tile_rows(deg, rows)
        assert 2 <= t <= T and t % 2 == 0
        if t < T:
            assert -(-rows // t) >= NODE_MIN_TILES or t == 2


@pytest.mark.parametrize("size", SPLITS)
@pytest.mark.parametrize("outside_value_max", [False, True])
def test_buckets_list_each_live_point_once(trees, points, size,
                                           outside_value_max):
    _, tt = trees
    pts, w = (torch.as_tensor(x) for x in points)
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    _, leaves = node_query(blocks, tt, pts)
    seen = torch.zeros(pts.shape[0], dtype=torch.long)
    for b in blocks:
        for T in (node_tile_rows(tt.deg_used, b.hi - b.lo), SMALL_TILE):
            sort = check_buckets(b, pts, leaves, w, outside_value_max, T)
            if T == SMALL_TILE:
                seen[chip_smoke.bucket_records(sort)[1][:, 0]] += 1
    # over the blocks every point with a weight is listed once
    any_live = (w != 0)
    if outside_value_max:
        any_live &= torch.all(_to_unit(tt, pts).abs() <= 0.5, dim=-1)
    assert torch.equal(seen, any_live.long())


def test_buckets_of_idle_and_empty_blocks(trees):
    """A block no point reaches lists nothing in each of its tiles; a block
    of no rows has no tiles; no points list nothing; and at more points
    than a segment holds the runs of each segment list its own points."""
    _, tt = trees
    pts = torch.as_tensor(np.random.default_rng(9).uniform(
        0.3, 0.45, (257, 3)))
    blocks = [P.node_block(tt, 5, k) for k in range(5)]
    _, leaves = node_query(blocks, tt, pts)
    w = torch.ones(pts.shape[0], dtype=torch.float64)
    idle = [b for b in blocks
            if not bool(((leaves >= b.lo) & (leaves < b.hi)).any())]
    assert idle
    for b in idle:
        offsets, _ = check_buckets(b, pts, leaves, w, False, SMALL_TILE)
        assert offsets.shape[1] > 2 and not offsets.any()
    rows = tt.child_idx.shape[0]
    empty = dataclasses.replace(
        P.node_block(tt, 1, 0), lo=rows, hi=rows,
        **{k: getattr(tt, k)[rows:] for k in P._ARRAYS})
    offsets, _ = check_buckets(empty, pts, leaves, w, True, SMALL_TILE)
    assert offsets.shape == (1, 1) and not offsets.any()
    none = pts[:0]
    for b in blocks:
        sort = check_buckets(b, none, leaves[:0], w[:0], True, SMALL_TILE)
        assert sort[0].shape[0] == 0
        got = tile_model(b, none, w[:0], sort, SMALL_TILE)
        assert not got.any() and got.shape[0] == b.hi - b.lo
    many = torch.as_tensor(np.random.default_rng(4).uniform(
        -0.5, 0.5, (2 * NODE_SORT_POINTS + 77, 3)))
    lv = node_query(blocks, tt, many)[1]
    wm = torch.as_tensor(np.random.default_rng(5).normal(size=many.shape[0]))
    for b in blocks[:2]:
        sort = check_buckets(b, many, lv, wm, False, SMALL_TILE)
        assert sort[0].shape[0] == -(-many.shape[0] // NODE_SORT_POINTS)
        np.testing.assert_allclose(
            tile_model(b, many, wm, sort, SMALL_TILE).numpy(),
            coeff_scatter_nodes_plain(b, many, lv, wm).numpy(), rtol=0,
            atol=GRAD_ATOL)


@pytest.mark.parametrize("size", SPLITS)
@pytest.mark.parametrize("outside_value_max", [False, True])
def test_tile_model_sums_to_the_vjp(trees, points, size,
                                    outside_value_max):
    jt, tt = trees
    pts, w = (torch.as_tensor(x) for x in points)
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    _, leaves = node_query(blocks, tt, pts)
    for small in (False, True):
        got = []
        for b in blocks:
            T = SMALL_TILE if small else node_tile_rows(tt.deg_used,
                                                        b.hi - b.lo)
            sort = _node_buckets_plain(b, pts, leaves, w,
                                       outside_value_max, T)
            g = tile_model(b, pts, w, sort, T)
            np.testing.assert_allclose(
                g.numpy(), coeff_scatter_nodes_plain(
                    b, pts, leaves, w, outside_value_max).numpy(),
                rtol=0, atol=GRAD_ATOL)
            got.append(g)
        got = torch.cat(got)

        def f(c):
            return jnp.sum(jnp.asarray(points[1]) * hp.query(
                dataclasses.replace(jt, coeffs=c), jnp.asarray(points[0]),
                outside_value_max=outside_value_max))

        jg = np.asarray(jax.grad(f)(jt.coeffs))
        np.testing.assert_allclose(got.numpy(), jg, rtol=0, atol=GRAD_ATOL)


def test_bucket_comparison_takes_any_order_and_refuses_errors(trees,
                                                              points):
    """chip_smoke.buckets_match holds a kernel's sort (offsets, items) to
    the plain one run by run: the plain sort with each run's points in
    reverse order matches; a point listed in place of another, two points
    of different runs swapped, a wrong row, or a run one longer and the
    next one shorter do not."""
    _, tt = trees
    pts, w = (torch.as_tensor(x) for x in points)
    blocks = [P.node_block(tt, 2, k) for k in range(2)]
    _, leaves = node_query(blocks, tt, pts)
    b = blocks[1]
    plain = _node_buckets_plain(b, pts, leaves, w, False, SMALL_TILE)
    offsets, items = plain
    o = offsets[0].long()
    runs = [(int(o[t]), int(o[t + 1])) for t in range(o.numel() - 1)
            if o[t + 1] - o[t] > 1]
    assert len(runs) > 2

    def mutated(change):
        it, off = items.clone(), offsets.clone()
        change(it, off)
        return off, it

    def reverse(it, off):
        for a, e in runs:
            it[a:e] = items[a:e].flip(0)

    assert chip_smoke.buckets_match(mutated(reverse), plain)
    (a, _), (c, _) = runs[0], runs[1]

    def replaced(it, off):
        it[a] = items[a + 1]

    def swapped(it, off):
        it[a], it[c] = items[c], items[a]

    def row(it, off):
        it[a, 1] += 1

    def moved(it, off):
        t = int(torch.nonzero(o == runs[0][1]).flatten()[0])
        off[0, t] += 1

    for change in (replaced, swapped, row, moved):
        assert not chip_smoke.buckets_match(mutated(change), plain)


@pytest.mark.parametrize("size", (1, 3))
def test_wrong_gradients_are_caught(trees, points, size):
    """chip_smoke.k8n_teeth's two wrong results (a tile's sums dropped, one
    point's largest term counted twice) each fail the check against the
    plain gradient, on each block of the split."""
    _, tt = trees
    pts, w = (torch.as_tensor(x) for x in points)
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    _, leaves = node_query(blocks, tt, pts)
    for b in blocks:
        want = coeff_scatter_nodes_plain(b, pts, leaves, w)
        assert chip_smoke.rel_err(want, want) <= chip_smoke.GRAD_RTOL64
        assert chip_smoke.k8n_teeth(want, want, b, pts, leaves, w,
                                    SMALL_TILE) == [True, True]


def test_tile_constants_are_the_kernels():
    """The wrapper's tile and segment shapes are those csrc/coeff_scatter.cu
    compiles: kTileElems, kTileMaxRows and kSortThreads * kSortPer."""
    import os
    import re

    import hpsdf_tpu_torch
    with open(os.path.join(os.path.dirname(hpsdf_tpu_torch.__file__), "csrc",
                           "coeff_scatter.cu")) as fh:
        src = fh.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)[ *;]",
                             src).group(1))

    assert const("kTileElems") == NODE_TILE_ELEMS
    assert const("kTileMaxRows") == NODE_TILE_MAX_ROWS
    assert "kSortPoints = kSortThreads * kSortPer;" in src
    assert const("kSortThreads") * const("kSortPer") == NODE_SORT_POINTS
