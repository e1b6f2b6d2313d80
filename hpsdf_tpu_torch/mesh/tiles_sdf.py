"""Exact closest triangle per point by a tiled points x triangles scan.

The port of ``hpsdf_tpu/mesh/pallas_sdf.py`` (the Pallas TPU kernel
``closest_tri_tiles``). ``closest_tri_tiles`` is kernel P1: on CUDA tensors
it launches ``csrc/closest_tri.cu``; on CPU tensors it runs
``closest_tri_tiles_plain``, a chunked torch scan of the same function,
which is also what the kernel is held against on the card.

Contract (as the TPU kernel's): tri_rows f32 (T, >=9), of which lanes 0..8
(the vertices) are read; pts f32 (B, 3). Returns best_d2 f32[B] and
best_idx i32[B] into tri_rows, the lowest index on ties, clipped to
[0, T-1]. Padding rows of coordinate 1e30 never win.

The kernel reads the rows in tiles of ``TILE`` and the points in blocks of
``BLOCK_PTS``. ``tile_boxes`` is its tile table (rows to scan and the box
of the real rows of each tile), ``tile_table`` that table with the rows
staged for the kernel, made once per set of rows, ``tile_skip`` its cull
test for one block of points, line for line as in the source, and
``block_tile_visits`` the whole cull in torch: which tiles each block
scans. The CPU tests hold the cull against the dense scan with these.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels

_EPS = 1e-30
# plain-scan chunk: (points x triangles) f32 tiles of 8M elements keep the
# ~30 live temporaries of the cascade around 1 GB
_PT_CHUNK = 8192
_TRI_CHUNK = 1024

TILE = 256              # rows per tile (kTile in csrc/closest_tri.cu)
BLOCK_PTS = 256         # points per block of the kernel (kBlockPts)
HUGE = 1e29             # a real row has every vertex coordinate below this
# a triangle whose smallest altitude is below 2^-10 of its longest edge
# (|ab x ac|^2 <= 2^-20 e_max^4) is a sliver: its tile is never skipped
SLIVER = 2.0 ** -20
CULL_REL = 2.0 ** -12   # the cull's safety margin (kCullRel)
STAGE = 12              # staged floats per row (kStage)
# a block's shared memory holds two staged tiles (24 KB) and its list of
# tiles to scan, 4 bytes a tile, within the H100's 227 KB
MAX_TILES = (232448 - 2 * TILE * STAGE * 4) // 4


def _closest_d2(px, py, pz, ax, ay, az, bx, by, bz, cx, cy, cz):
    """Squared distance from points (P, 1) components to triangles (1, T)
    components -> (P, T): the region cascade of tri.closest_point_triangle
    without the feature code, as pallas_sdf._closest_d2 computes it."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az

    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz

    bpx, bpy, bpz = px - bx, py - by, pz - bz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz

    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ca = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    def guard(x):
        return torch.where(x.abs() > _EPS, x, _EPS)

    t_ab = d1 / guard(d1 - d3)
    t_ca = d2 / guard(d2 - d6)
    den_bc = (d4 - d3) + (d5 - d6)
    t_bc = (d4 - d3) / guard(den_bc)

    denom = guard(va + vb + vc)
    v = vb / denom
    w = vc / denom

    # closest-point components by the same first-true-wins cascade
    def pick(face, on_bc, on_ca, on_ab, vc_, vb_, va_):
        out = face
        for mask, val in ((in_bc, on_bc), (in_ca, on_ca), (in_ab, on_ab),
                          (in_c, vc_), (in_b, vb_), (in_a, va_)):
            out = torch.where(mask, val, out)
        return out

    qx = pick(ax + abx * v + acx * w, bx + (cx - bx) * t_bc,
              ax + acx * t_ca, ax + abx * t_ab, cx, bx, ax)
    qy = pick(ay + aby * v + acy * w, by + (cy - by) * t_bc,
              ay + acy * t_ca, ay + aby * t_ab, cy, by, ay)
    qz = pick(az + abz * v + acz * w, bz + (cz - bz) * t_bc,
              az + acz * t_ca, az + abz * t_ab, cz, bz, az)

    dx, dy, dz = px - qx, py - qy, pz - qz
    return dx * dx + dy * dy + dz * dz


def _check(tri_rows: torch.Tensor, pts: torch.Tensor) -> None:
    if tri_rows.dtype != torch.float32 or tri_rows.dim() != 2 \
            or tri_rows.shape[1] < 9 or tri_rows.shape[0] == 0:
        raise ValueError("tri_rows must be f32 (T >= 1, >= 9), got "
                         f"{tri_rows.dtype} {tuple(tri_rows.shape)}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be f32 (B, 3), got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    if tri_rows.device != pts.device:
        raise ValueError(f"tri_rows on {tri_rows.device}, pts on "
                         f"{pts.device}")


def closest_tri_tiles_plain(tri_rows: torch.Tensor, pts: torch.Tensor):
    """P1 as a chunked torch scan, on any device: running min over triangle
    chunks with a strict '<', the lowest index within a chunk by the min of
    a masked iota (as the TPU kernel)."""
    _check(tri_rows, pts)
    B, T = pts.shape[0], tri_rows.shape[0]
    dev = pts.device
    best_d2 = torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
    best_idx = torch.zeros(B, dtype=torch.int64, device=dev)
    verts = tri_rows[:, :9]
    for ps in range(0, B, _PT_CHUNK):
        p = pts[ps: ps + _PT_CHUNK]
        px, py, pz = p[:, 0:1], p[:, 1:2], p[:, 2:3]
        bd = best_d2[ps: ps + _PT_CHUNK]
        bi = best_idx[ps: ps + _PT_CHUNK]
        for ts in range(0, T, _TRI_CHUNK):
            t = verts[ts: ts + _TRI_CHUNK].T[:, None, :]          # (9, 1, ct)
            d2 = _closest_d2(px, py, pz, *t)                        # (P, ct)
            loc_min = d2.amin(dim=1)
            ii = torch.arange(d2.shape[1], device=dev)
            loc_arg = torch.where(d2 <= loc_min[:, None], ii,
                                  d2.shape[1]).amin(dim=1)
            better = loc_min < bd
            bi.copy_(torch.where(better, loc_arg + ts, bi))
            bd.copy_(torch.where(better, loc_min, bd))
    return best_d2, best_idx.clamp(0, T - 1).to(torch.int32)


def tile_boxes(tri_rows: torch.Tensor):
    """The tile table of ``tri_rows`` in tiles of ``TILE`` rows: (n_rows
    i32[n_tiles], boxes f32[n_tiles, 6]).

    A row is padding when every vertex coordinate is at least ``HUGE`` in
    magnitude, real when every one is below it. ``n_rows`` is a tile's
    last row that is not padding, plus one (0 for an empty tile): the
    kernel scans that prefix, and where the real rows form a prefix, as in
    ``build_bvh``'s kd layout, it is their count. ``boxes`` holds (min xyz,
    max xyz) over the tile's real rows. A tile holding a sliver or a row
    that is neither real nor padding gets the unbounded box (-inf, +inf),
    which the cull never skips."""
    T = tri_rows.shape[0]
    n_tiles = -(-T // TILE)
    v = torch.full((n_tiles * TILE, 9), float("inf"), dtype=torch.float32,
                   device=tri_rows.device)
    v[:T] = tri_rows[:, :9]
    mag = v.abs()
    real = (mag < HUGE).all(dim=1)
    pad = (mag >= HUGE).all(dim=1)
    a, b, c = v[:, 0:3], v[:, 3:6], v[:, 6:9]
    ab, ac, bc = b - a, c - a, c - b
    cross2 = (torch.linalg.cross(ab, ac) ** 2).sum(dim=1)
    e2 = torch.stack([(e * e).sum(dim=1) for e in (ab, ac, bc)]).amax(dim=0)
    sliver = real & ~(cross2 > SLIVER * e2 * e2)
    unbounded = ((~real & ~pad) | sliver).view(n_tiles, TILE).any(dim=1)

    pos = torch.arange(1, TILE + 1, dtype=torch.int32,
                       device=tri_rows.device)
    n_rows = torch.where(~pad.view(n_tiles, TILE), pos, 0).amax(dim=1)
    tri = v.view(n_tiles, TILE, 3, 3)
    inf = torch.tensor(float("inf"), device=tri_rows.device)
    lo = torch.where(real.view(n_tiles, TILE, 1),
                     tri.amin(dim=2), inf).amin(dim=1)
    hi = torch.where(real.view(n_tiles, TILE, 1),
                     tri.amax(dim=2), -inf).amax(dim=1)
    lo = torch.where(unbounded[:, None], -inf, lo)
    hi = torch.where(unbounded[:, None], inf, hi)
    return n_rows.to(torch.int32), torch.cat([lo, hi], dim=1).contiguous()


def _box_d2(boxes, pmin, pmax):
    """Squared distance between each tile box and the box [pmin, pmax], in
    the kernel's order of operations."""
    gap = torch.clamp(torch.maximum(boxes[:, :3] - pmax, pmin - boxes[:, 3:]),
                      min=0.0)
    g = gap * gap
    return (g[:, 0] + g[:, 1]) + g[:, 2]


def _box_far2(boxes, pmin, pmax):
    """Squared distance between the farthest corners of each tile box and
    the box [pmin, pmax]: a bound on the distance from any point of the
    block to the tile's nearest triangle, which the seed minimises."""
    far = torch.maximum(boxes[:, 3:] - pmin, pmax - boxes[:, :3])
    g = far * far
    return (g[:, 0] + g[:, 1]) + g[:, 2]


def tile_skip(boxes, pmin, pmax, u):
    """The kernel's cull test for one block of points whose box is [pmin,
    pmax] (f32 (3,)) and whose seed bound is ``u`` (the largest of its
    points' best d2 over the seed tile): True where the tile's box lies
    farther than sqrt(u) (1 + CULL_REL) + CULL_REL S from the block's box,
    S the largest coordinate magnitude of the two boxes. Such a tile holds
    no triangle any of the block's points could reach with d2 <= u."""
    bd2 = _box_d2(boxes, pmin, pmax)
    s = torch.maximum(torch.maximum(pmin.abs(), pmax.abs()).amax(),
                      boxes.abs().amax(dim=1))
    lim = torch.sqrt(u) * (1.0 + CULL_REL) + CULL_REL * s
    return bd2 > lim * lim


def block_tile_visits(tri_rows: torch.Tensor, pts: torch.Tensor):
    """The kernel's cull in torch: bool[n_blocks, n_tiles], the tiles each
    block of ``BLOCK_PTS`` points scans in its full pass. A block seeds
    with the non-empty tile whose box's farthest corner is nearest its own
    box (``_box_far2``; the lowest such index), takes u, the largest of its
    points' best d2 over that tile, and scans the seed tile and every
    non-empty tile ``tile_skip`` keeps."""
    _check(tri_rows, pts)
    n_rows, boxes = tile_boxes(tri_rows)
    full = n_rows > 0
    out = torch.zeros((-(-pts.shape[0] // BLOCK_PTS), n_rows.shape[0]),
                      dtype=torch.bool, device=pts.device)
    if not bool(full.any()):
        return out
    for blk in range(out.shape[0]):
        p = pts[blk * BLOCK_PTS:(blk + 1) * BLOCK_PTS]
        pmin, pmax = p.amin(dim=0), p.amax(dim=0)
        key = torch.where(full, _box_far2(boxes, pmin, pmax),
                          float("inf"))
        seed = int(torch.nonzero(full & (key == key[full].min()))[0])
        rows = tri_rows[seed * TILE: seed * TILE + int(n_rows[seed])]
        u = closest_tri_tiles_plain(rows, p)[0].amax()
        keep = full & ~tile_skip(boxes, pmin, pmax, u)
        keep[seed] = True
        out[blk] = keep
    return out


class TileTable(NamedTuple):
    """What kernel P1 reads of one set of rows besides the points, made once
    per set of rows by ``tile_table``: ``tile_boxes``'s (n_rows, boxes) and,
    for rows on a CUDA device, the rows staged by the kernel's prep
    (``STAGE`` floats a row, None on the CPU)."""
    n_rows: torch.Tensor
    boxes: torch.Tensor
    staged: torch.Tensor | None


def tile_table(tri_rows: torch.Tensor) -> TileTable:
    """The tile table of ``tri_rows`` and, on a CUDA device, the rows staged
    for kernel P1. Make it once where the rows are fixed (``mesh_sdf``
    does) and pass it to every ``closest_tri_tiles`` call on them."""
    if tri_rows.dtype != torch.float32 or tri_rows.dim() != 2 \
            or tri_rows.shape[1] < 9 or tri_rows.shape[0] == 0:
        raise ValueError("tri_rows must be f32 (T >= 1, >= 9), got "
                         f"{tri_rows.dtype} {tuple(tri_rows.shape)}")
    n_rows, boxes = tile_boxes(tri_rows)
    if tri_rows.device.type != "cuda":
        return TileTable(n_rows, boxes, None)
    T = tri_rows.shape[0]
    if n_rows.shape[0] > MAX_TILES:
        raise ValueError(f"closest_tri_tiles: {T} rows make more than "
                         f"{MAX_TILES} tiles of {TILE}")
    if tri_rows.stride(1) != 1:
        raise ValueError("tri_rows lanes must be contiguous")
    staged = torch.empty((n_rows.shape[0] * TILE, STAGE),
                         dtype=torch.float32, device=tri_rows.device)
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_stage_rows(
        tri_rows.data_ptr(), T, tri_rows.stride(0), staged.data_ptr(),
        _kernels.stream_of(tri_rows)), "stage_rows")
    return TileTable(n_rows, boxes, staged)


def closest_tri_tiles(tri_rows: torch.Tensor, pts: torch.Tensor,
                      table: TileTable | None = None):
    """Exact closest triangle per point: kernel P1 on CUDA tensors, the
    plain scan on CPU tensors. ``table`` is ``tile_table(tri_rows)``, made
    here when not given. Returns (best_d2 f32[B], best_idx i32[B])."""
    _check(tri_rows, pts)
    if pts.device.type == "cpu":
        return closest_tri_tiles_plain(tri_rows, pts)
    return _launch(tri_rows, pts, table)


def _launch(tri_rows, pts, table=None, cull=True):
    """Kernel P1, with its block-level tile cull unless ``cull`` is False
    (the dense scan, for timing: the result is the same bit for bit). Each
    block's count of tiles and of rows scanned in its full pass is kept in
    ``closest_tri_tiles.visits``, i32[n_blocks, 2]."""
    _check(tri_rows, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"closest_tri_tiles: unsupported device {pts.device}")
    if table is None:
        table = tile_table(tri_rows)
    n_tiles = table.n_rows.shape[0]
    if table.staged is None or n_tiles != -(-tri_rows.shape[0] // TILE) \
            or table.staged.device != pts.device:
        raise ValueError("closest_tri_tiles: table is not tile_table(tri_rows) "
                         f"on {pts.device}")
    pts = pts.contiguous()
    B = pts.shape[0]
    dev = pts.device
    best_d2 = torch.empty(B, dtype=torch.float32, device=dev)
    best_idx = torch.empty(B, dtype=torch.int32, device=dev)
    visits = torch.zeros((-(-B // BLOCK_PTS), 2), dtype=torch.int32,
                         device=dev)
    if B == 0:
        return best_d2, best_idx
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_closest_tri(
        table.staged.data_ptr(), table.n_rows.data_ptr(),
        table.boxes.data_ptr(), n_tiles, pts.data_ptr(), B, int(cull),
        best_d2.data_ptr(), best_idx.data_ptr(), visits.data_ptr(),
        _kernels.stream_of(pts)), "closest_tri")
    closest_tri_tiles.launches += 1
    closest_tri_tiles.visits = visits
    return best_d2, best_idx


closest_tri_tiles.launches = 0
closest_tri_tiles.visits = None
