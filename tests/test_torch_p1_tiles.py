"""Kernel P1's tile table and block-level tile cull, on the CPU.

The kernel scans the rows in tiles of ``TILE`` and skips, for each block of
``BLOCK_PTS`` points, the tiles that ``tile_skip`` proves hold no winner.
These tests hold the torch mirror of that cull (``block_tile_visits``)
against the dense plain scan: the scan over the tiles a block visits gives
exactly the dense scan's (best_d2, best_idx), at the fit's own points, at
uniform points, on the surface (where the seed bound is about 0) and on
edges shared by triangles of two tiles."""

import numpy as np
import pytest
import torch

import hpsdf_tpu_torch as T
from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen
from hpsdf_tpu_torch.mesh import tiles_sdf as ts

from .test_torch_query import few_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def rows4():
    """icosphere(0.3, 4): 5,120 triangles in 8,192 kd rows, 32 tiles."""
    return build_bvh(build_mesh(*gen.icosphere(0.3, 4)),
                     device="cpu").tri_rows


def test_tile_boxes_icosphere5():
    rows = build_bvh(build_mesh(*gen.icosphere(0.3, 5)),
                     device="cpu").tri_rows
    n_rows, boxes = ts.tile_boxes(rows)
    assert n_rows.dtype == torch.int32 and boxes.shape == (128, 6)
    assert int((n_rows == ts.TILE).sum()) == 80
    assert int((n_rows == 0).sum()) == 48
    v = rows[:, :9].reshape(-1, 3, 3)
    real = (v.abs() < ts.HUGE).reshape(-1, 9).all(dim=1)
    assert int(real.sum()) == 20480
    tile = torch.arange(rows.shape[0]) // ts.TILE
    lo, hi = boxes[tile, None, :3], boxes[tile, None, 3:]
    inside = ((v >= lo) & (v <= hi)).all(dim=-1).all(dim=-1)
    assert bool(inside[real].all())
    assert bool(torch.isfinite(boxes[n_rows > 0]).all())


def test_tile_boxes_padding_slivers_and_mixed_rows():
    rng = np.random.default_rng(0)
    rows = np.full((3 * ts.TILE, 9), ts.HUGE * 10, np.float32)
    # tile 0: real rows 0..99 and 150, padding between them
    rows[:100] = rng.uniform(-0.4, 0.4, (100, 9))
    rows[150] = rng.uniform(-0.4, 0.4, 9)
    # tile 1: real rows and one sliver (c on the line through a and b)
    rows[256:300] = rng.uniform(-0.4, 0.4, (44, 9))
    rows[300, :6] = [0.0, 0.0, 0.0, 0.2, 0.1, 0.0]
    rows[300, 6:] = [0.1, 0.05, 1e-9]
    # tile 2: one row with some coordinates huge and some not
    rows[512:520] = rng.uniform(-0.4, 0.4, (8, 9))
    rows[520, :3] = 0.1
    n_rows, boxes = ts.tile_boxes(torch.as_tensor(rows))
    assert n_rows.tolist() == [151, 45, 9]
    real0 = torch.as_tensor(np.concatenate([rows[:100], rows[150:151]]))
    v = real0.reshape(-1, 3, 3)
    np.testing.assert_array_equal(boxes[0, :3], v.amin(dim=(0, 1)))
    np.testing.assert_array_equal(boxes[0, 3:], v.amax(dim=(0, 1)))
    for k in (1, 2):
        assert bool((boxes[k, :3] == -np.inf).all())
        assert bool((boxes[k, 3:] == np.inf).all())
    # an unbounded tile is never skipped
    far = torch.tensor([5.0, 5.0, 5.0])
    skip = ts.tile_skip(boxes, far, far + 0.01, torch.tensor(0.0))
    assert skip.tolist() == [True, False, False]


def test_tile_table_on_cpu(rows4):
    table = ts.tile_table(rows4)
    n_rows, boxes = ts.tile_boxes(rows4)
    assert torch.equal(table.n_rows, n_rows)
    assert torch.equal(table.boxes, boxes)
    assert table.staged is None          # staged only for the kernel
    pts = torch.as_tensor(np.random.default_rng(1).uniform(
        -0.5, 0.5, (300, 3)).astype(np.float32))
    # CPU points take the plain scan, table or not; the kernel refuses them
    for got, want in zip(ts.closest_tri_tiles(rows4, pts, table),
                         ts.closest_tri_tiles_plain(rows4, pts)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unsupported device"):
        ts._launch(rows4, pts, table)


def _fit_batches():
    """The F batches of a small slice fit of the analytic sphere, f32."""
    cfg = T.Config(target_error=1e-4, max_depth=4, max_degree=3,
                   continuity=False)
    out = []

    def F(p):
        out.append(p.to(torch.float32))
        return torch.linalg.norm(p, dim=-1) - 0.3

    T.build_octree(cfg, F, device="cpu")
    return out


def _surface_points(rows, rng):
    """Each real triangle's vertex a and a random point inside it, in row
    order (so a block of points is a compact patch of the surface)."""
    v = rows[:, :9].reshape(-1, 3, 3)
    real = (v.abs() < ts.HUGE).reshape(-1, 9).all(dim=1)
    v = v[real]
    w = torch.as_tensor(rng.dirichlet((1.0, 1.0, 1.0), v.shape[0]),
                        dtype=torch.float32)
    inner = (w[:, :, None] * v).sum(dim=1)
    return torch.stack([v[:, 0], inner], dim=1).reshape(-1, 3)


def _shared_edge_points(rows):
    """Midpoints of edges whose two triangles lie in different tiles."""
    v = rows[:, :9].reshape(-1, 3, 3).numpy()
    real = np.flatnonzero((np.abs(v) < ts.HUGE).reshape(-1, 9).all(axis=1))
    first = {}
    mids = []
    for r in real:
        for i, j in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((tuple(v[r, i]), tuple(v[r, j]))))
            if key in first and first[key] // ts.TILE != r // ts.TILE:
                mids.append(0.5 * (v[r, i] + v[r, j]))
            first.setdefault(key, r)
    return torch.as_tensor(np.asarray(mids, np.float32))


def _point_sets(rows):
    rng = np.random.default_rng(7)
    fit = _fit_batches()
    return {
        # every fit batch, cut to its first 12 blocks
        "fit": torch.cat([b[: 12 * ts.BLOCK_PTS] for b in fit]),
        "uniform": torch.as_tensor(
            rng.uniform(-0.5, 0.5, (8 * ts.BLOCK_PTS, 3)).astype(np.float32)),
        "surface": _surface_points(rows, rng)[: 16 * ts.BLOCK_PTS],
        "shared_edges": _shared_edge_points(rows),
    }


@pytest.fixture(scope="module")
def point_sets(rows4):
    return _point_sets(rows4)


@pytest.mark.parametrize("name", ["fit", "uniform", "surface",
                                  "shared_edges"])
def test_cull_scan_equals_dense_scan(rows4, point_sets, name):
    pts = point_sets[name]
    assert pts.shape[0] > ts.BLOCK_PTS
    d2_dense, idx_dense = ts.closest_tri_tiles_plain(rows4, pts)
    visits = ts.block_tile_visits(rows4, pts)
    n_rows, _ = ts.tile_boxes(rows4)
    # the dense winner's tile is visited by the winner's block
    blk = torch.arange(pts.shape[0]) // ts.BLOCK_PTS
    assert bool(visits[blk, idx_dense.long() // ts.TILE].all())
    # the ascending scan over the visited tiles gives the dense result
    for b in range(visits.shape[0]):
        p = pts[b * ts.BLOCK_PTS:(b + 1) * ts.BLOCK_PTS]
        ids = torch.cat([torch.arange(k * ts.TILE,
                                      k * ts.TILE + int(n_rows[k]))
                         for k in torch.nonzero(visits[b]).flatten()])
        d2, idx = ts.closest_tri_tiles_plain(rows4[ids], p)
        sl = slice(b * ts.BLOCK_PTS, b * ts.BLOCK_PTS + p.shape[0])
        assert torch.equal(d2, d2_dense[sl])
        assert torch.equal(ids[idx.long()].to(torch.int32), idx_dense[sl])
    if name in ("fit", "surface"):
        # points in compact blocks: the cull skips most non-empty tiles
        share = float(visits.sum()) / (visits.shape[0]
                                       * int((n_rows > 0).sum()))
        assert share < 0.5, share
