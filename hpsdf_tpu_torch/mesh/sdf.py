"""Batched mesh signed distance (the counterpart of ``hpsdf_tpu/mesh/sdf.py``;
reference Mesh::SignedDistanceAtPt + BVH::ClosestTriangleToPt,
Source/Meshing/Mesh.cpp:42-63 and Source/Meshing/BVH.cpp:263-342).

``signed_distance``        -- BVH walk (descend-nearer / push-farther):
                              kernel K11 (``closest_bvh``, csrc/bvh_walk.cu).
``signed_distance_brute``  -- O(T) chunked scan, the differential oracle
                              (Mesh.cpp:42-51).
``signed_distance_tiles``  -- the closest triangle by kernel P1
                              (``tiles_sdf.closest_tri_tiles``).
``signed_distance_hybrid`` -- the two-level kd-cluster prune with an exact
                              refine, kernel K10 (``hybrid_closest``,
                              csrc/hybrid.cu), and a certified error that
                              escalates to wider prunes, then to P1.
``mesh_sdf``               -- wraps a mesh as a batched F for build_octree.

Each kernel's wrapper launches it on CUDA tensors and runs its plain torch
version (``closest_bvh_plain``, ``hybrid_closest_plain``) on CPU tensors.
The sign is taken on the best triangle alone (``_signed_from_best``: kernel
K14, ``signed_from_best_kernel``, csrc/sign.cu, on CUDA tensors; its plain
version ``signed_from_best_plain`` on CPU tensors).

Sign convention (Baerentzen-Aanaes): sign(dot(pseudo_normal(feature),
p - closest)), with the pseudo-normal picked by the closest simplex
(vertex / edge / face) -- reference Mesh.cpp:162-242.
"""

from __future__ import annotations

import torch

from .. import _device, _kernels
from ..accel import row_gather_plain
from . import bvh as _bvh
from . import tri as _tri
from .bvh import BVH, build_bvh
from .core import TriMesh
from .tiles_sdf import closest_tri_tiles, tile_table

# the hybrid prune (hpsdf_tpu/mesh/sdf.py:381-394)
CLUSTER = 256            # rows per level-1 prune unit (subclusters = /8)
HYBRID_K1 = 48           # level-1 clusters kept
HYBRID_K2 = 48           # subclusters refined (K2 * 32 candidate rows)
# the plain version's chunk: points x candidate rows per gather, as
# HYBRID_CHUNK (2,048 points) at the default widths
PLAIN_CANDIDATES = 2048 * HYBRID_K2 * 32
# tiles -> hybrid crossover of mesh_sdf(method="auto"), as in hpsdf_tpu
AUTO_TILES_MAX = 65536
MAX_SMEM = 232448        # shared memory a block of K10 may use on the H100
HYBRID_WARPS = 8         # K10's points a block at most, a warp each
HYBRID_CHUNKS = 256      # K10's chunks (heap subtrees of clusters) at most
# K10's cascade stops at a box farther than its best row by more than this
# share of the coordinates' scale 1 + |x| + |y| + |z| (csrc/hybrid.cu kReach)
HYBRID_REACH = 1e-5
BVH_MAX_ROWS = 2 ** 30   # K11's rows: heap ids up to 2 T2 - 1 in an i32
BVH_MAX_STACK = 32       # K11's stack entries, a lane of the warp each


def _tri_parts(rows):
    a = rows[..., _bvh._V0:_bvh._V0 + 3]
    b = rows[..., _bvh._V1:_bvh._V1 + 3]
    c = rows[..., _bvh._V2:_bvh._V2 + 3]
    return a, b, c


def _pseudo_normal(rows, feature):
    """Select the feature's pseudo-normal from a packed triangle row."""
    out = rows[..., _bvh._FN:_bvh._FN + 3]
    for k in range(3):
        vpn = rows[..., _bvh._VPN + 3 * k:_bvh._VPN + 3 * k + 3]
        out = torch.where((feature == k)[..., None], vpn, out)
    for k in range(3):
        epn = rows[..., _bvh._EPN + 3 * k:_bvh._EPN + 3 * k + 3]
        out = torch.where((feature == 3 + k)[..., None], epn, out)
    return out


def _signed(rows, p):
    a, b, c = _tri_parts(rows)
    closest, feature = _tri.closest_point_triangle(p, a, b, c)
    pn = _pseudo_normal(rows, feature)
    diff = p - closest
    dist = torch.linalg.norm(diff, dim=-1)
    return torch.where(torch.sum(pn * diff, dim=-1) >= 0.0, 1.0, -1.0) * dist


def signed_from_best_plain(tri_rows, best_idx, p):
    """K14's plain version, whatever the device: the best triangle's row by
    the plain row gather (zeros for an index outside the table), then
    ``_signed``."""
    return _signed(row_gather_plain(tri_rows, best_idx), p)


def _signed_from_best(tri_rows, best_idx, p):
    """Final sign + distance evaluation on the best triangle only: kernel
    K14 on CUDA tensors, the plain version on CPU tensors. tri_rows (T2,
    TRI_W) f32, best_idx (B,) int32 (as every closest-triangle search
    returns it; the plain version takes any integer type), p (B, 3) f32 ->
    (B,) f32."""
    if p.device.type == "cpu":
        return signed_from_best_plain(tri_rows, best_idx, p)
    return signed_from_best_kernel(tri_rows, best_idx, p)


def signed_from_best_kernel(tri_rows, best_idx, p, with_feature=False):
    """K14 (csrc/sign.cu): one launch, a thread a point, reading the best
    row's lanes straight from ``tri_rows``. Refuses tensors off the card
    and indices that are not int32. With ``with_feature`` also returns the
    closest feature's code (B,) int8 (``tri.FEAT_*``)."""
    if best_idx.dim() != 1 or best_idx.shape[0] != p.shape[0] \
            or best_idx.dtype != torch.int32 \
            or best_idx.device != p.device:
        raise ValueError(f"best_idx must be int32 ({p.shape[0]},) on "
                         f"{p.device}, got {best_idx.dtype} "
                         f"{tuple(best_idx.shape)} on {best_idx.device}")
    if p.device.type != "cuda":
        raise ValueError(f"signed_from_best_kernel: tensors on {p.device}, "
                         "not a CUDA device")
    _check_pts(p, tri_rows)
    _check_rows("signed_from_best_kernel", tri_rows)
    if tri_rows.shape[1] < _bvh._EPN + 9:
        raise ValueError(f"signed_from_best_kernel: rows of "
                         f"{tri_rows.shape[1]} lanes, the pseudo-normals need "
                         f"{_bvh._EPN + 9}")
    p, idx = p.contiguous(), best_idx.contiguous()
    out = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    feat = torch.empty(p.shape[0], dtype=torch.int8, device=p.device) \
        if with_feature else None
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_signed_from_best(
        tri_rows.data_ptr(), tri_rows.shape[0], tri_rows.stride(0),
        idx.data_ptr(), p.data_ptr(),
        p.shape[0], out.data_ptr(), 0 if feat is None else feat.data_ptr(),
        _kernels.stream_of(p)), "signed_from_best")
    signed_from_best_kernel.launches += 1
    return (out, feat) if with_feature else out


signed_from_best_kernel.launches = 0


def _tri_d2(rows, p):
    """Squared distance from p (..., 3) to the triangles of rows (..., >= 9),
    the reference's cascade, x + y then + z."""
    a, b, c = _tri_parts(rows)
    closest, _ = _tri.closest_point_triangle(p, a, b, c)
    d = (p - closest) ** 2
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def _check_pts(p, *tensors):
    if p.dtype != torch.float32 or p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"pts must be f32 (B, 3), got {p.dtype} "
                         f"{tuple(p.shape)}")
    for t in tensors:
        if t.dtype != torch.float32 or t.device != p.device:
            raise ValueError(f"mesh arrays must be f32 on {p.device}, got "
                             f"{t.dtype} on {t.device}")


def _check_rows(what, tri_rows):
    if tri_rows.stride(1) != 1 or tri_rows.stride(0) % 4 \
            or tri_rows.data_ptr() % 16 or tri_rows.shape[1] < 9:
        raise ValueError(f"{what}: tri_rows lanes must be contiguous, with "
                         "rows of >= 9 lanes 16-byte aligned")


# --------------------------------------------------------------------------
# K11: the BVH walk
# --------------------------------------------------------------------------

def closest_bvh_plain(bvh: BVH, p: torch.Tensor, max_iters: int | None = None,
                      with_stats: bool = False):
    """K11's plain version, the lockstep loop of
    ``hpsdf_tpu.mesh.sdf._closest_bvh_impl`` in torch: a greedy seed
    descent, then one node visit an iteration (descend nearer, push farther,
    or pop) until no walk is active; a walk stops after ``max_iters``
    iterations (None: 4 T2, exact). Returns (best_d2 f32[B], best_idx
    i32[B]) and, with ``with_stats``, i32[B, 2], the node rows and triangle
    rows each walk read (the seed's included), and bool[2 T2], the heap ids
    whose rows any walk read (node n < T2, triangle row n - T2)."""
    node_rows, tri_rows = bvh.node_rows, bvh.tri_rows
    _check_pts(p, node_rows, tri_rows)
    T2 = tri_rows.shape[0]
    if max_iters is None:
        max_iters = 4 * T2
    B, dev = p.shape[0], p.device

    def child_d2(nid):
        nrow = node_rows[nid]
        return (_tri.aabb_dist2(p, nrow[:, 0:3], nrow[:, 3:6]),
                _tri.aabb_dist2(p, nrow[:, 6:9], nrow[:, 9:12]))

    top_node = node_rows.shape[0] - 1
    seen = torch.zeros(2 * T2, dtype=torch.bool, device=dev)
    seed = torch.ones(B, dtype=torch.int64, device=dev)
    for _ in range(max(bvh.depth, 0)):
        seen[seed] = True
        dl, dr = child_d2(seed.clamp(1, top_node))
        seed = torch.where(dl <= dr, 2 * seed, 2 * seed + 1)
    best_idx = (seed - T2).clamp(0, T2 - 1)
    seen[T2 + best_idx] = True
    best_d2 = _tri_d2(tri_rows[best_idx], p)
    n_nodes = torch.full((B,), max(bvh.depth, 0), dtype=torch.int32,
                         device=dev)
    n_leaves = torch.ones(B, dtype=torch.int32, device=dev)

    S = bvh.depth + 1
    stack = torch.zeros((B, S), dtype=torch.int64, device=dev)
    lane = torch.arange(S, device=dev)[None, :]
    sp = torch.zeros(B, dtype=torch.int64, device=dev)
    cur = torch.ones(B, dtype=torch.int64, device=dev)
    active = torch.ones(B, dtype=torch.bool, device=dev)
    it = 0
    while bool(active.any()):
        if with_stats:
            seen[cur[active]] = True
        is_leaf = cur >= T2
        leaf = active & is_leaf
        node = active & ~is_leaf
        row = (cur - T2).clamp(0, T2 - 1)
        d2 = _tri_d2(tri_rows[row], p)
        better = leaf & (d2 < best_d2)
        best_d2 = torch.where(better, d2, best_d2)
        best_idx = torch.where(better, row, best_idx)

        dl, dr = child_d2(cur.clamp(1, top_node))
        l_near = dl <= dr
        near = torch.where(l_near, 2 * cur, 2 * cur + 1)
        far = torch.where(l_near, 2 * cur + 1, 2 * cur)
        descend = node & (torch.minimum(dl, dr) < best_d2)
        push = descend & (torch.maximum(dl, dr) < best_d2)
        stack = torch.where(push[:, None] & (lane == sp[:, None]),
                            far[:, None], stack)
        sp = sp + push.long()
        can_pop = active & ~descend & (sp > 0)
        sp_pop = (sp - 1).clamp(min=0)
        top = stack.gather(1, sp_pop[:, None])[:, 0]
        cur = torch.where(descend, near, torch.where(can_pop, top, cur))
        sp = torch.where(can_pop, sp_pop, sp)
        n_nodes += node.int()
        n_leaves += leaf.int()
        it += 1
        active = active & (descend | can_pop) & (it < max_iters)
    out = (best_d2, best_idx.to(torch.int32))
    if with_stats:
        return out + (torch.stack([n_nodes, n_leaves], dim=1), seen)
    return out


def closest_bvh(bvh: BVH, p: torch.Tensor, max_iters: int | None = None):
    """The closest triangle per point by the BVH walk: kernel K11 on CUDA
    tensors, ``closest_bvh_plain`` on CPU tensors. Returns (best_d2 f32[B],
    best_idx i32[B] into ``bvh.tri_rows``)."""
    _check_pts(p, bvh.node_rows, bvh.tri_rows)
    if p.device.type == "cpu":
        return closest_bvh_plain(bvh, p, max_iters)
    return _bvh_launch(bvh, p, max_iters)


def _bvh_check(T2: int, depth: int):
    """K11's limits: heap ids 1 .. 2 T2 - 1 in i32, and a stack of
    ``depth`` + 1 entries in the 32 lanes of a warp."""
    if T2 > BVH_MAX_ROWS:
        raise ValueError(f"closest_bvh: {T2} rows exceed the kernel's 2^30")
    if depth + 1 > BVH_MAX_STACK:
        raise ValueError(f"closest_bvh: a heap of depth {depth} needs a "
                         f"stack of {depth + 1} entries, more than the "
                         f"kernel's {BVH_MAX_STACK} (a lane of the warp an "
                         "entry)")


def _bvh_launch(bvh: BVH, p, max_iters=None, with_stats=False):
    """Kernel K11 on the BVH's node rows and, for the leaves, its vertex
    rows; with ``with_stats`` also the visits i32[B, 2] (as
    ``closest_bvh_plain``'s)."""
    _check_pts(p, bvh.node_rows, bvh.tri_rows)
    if p.device.type != "cuda":
        raise ValueError(f"closest_bvh: unsupported device {p.device}")
    _bvh_check(bvh.n_leaves, bvh.depth)
    rows, node_rows = bvh.vertex_rows, bvh.node_rows
    _check_rows("closest_bvh", rows)
    T2 = rows.shape[0]
    if not node_rows.is_contiguous() or node_rows.shape[1] != 16 \
            or node_rows.data_ptr() % 16:
        raise ValueError("closest_bvh: node_rows must be contiguous (T2, 16)")
    if max_iters is None:
        max_iters = 4 * T2
    p = p.contiguous()
    B = p.shape[0]
    best_d2 = torch.empty(B, dtype=torch.float32, device=p.device)
    best_idx = torch.empty(B, dtype=torch.int32, device=p.device)
    visits = torch.empty((B, 2), dtype=torch.int32, device=p.device) \
        if with_stats else None
    if B:
        lib = _kernels.load()
        _kernels.check(lib, lib.hpsdf_bvh_walk(
            node_rows.data_ptr(), rows.data_ptr(), rows.stride(0),
            T2, bvh.depth, p.data_ptr(), B, int(max_iters),
            best_d2.data_ptr(), best_idx.data_ptr(),
            visits.data_ptr() if with_stats else None,
            _kernels.stream_of(p)), "bvh_walk")
        closest_bvh.launches += 1
    return (best_d2, best_idx, visits) if with_stats else (best_d2, best_idx)


closest_bvh.launches = 0


def signed_distance(bvh: BVH, pts, max_iters: int | None = None
                    ) -> torch.Tensor:
    """Signed distances by the BVH walk (K11). pts (B, 3) -> (B,) f32.
    Exact by default; ``max_iters`` bounds the work (the greedy seed keeps a
    capped result a true upper bound with the right sign)."""
    p = pts.to(torch.float32)
    _, best_idx = closest_bvh(bvh, p, max_iters)
    return _signed_from_best(bvh.tri_rows, best_idx, p)


def signed_distance_brute(tri_rows, pts, chunk: int = 128) -> torch.Tensor:
    """O(T) scan oracle (Mesh::SignedDistanceAtPt without BVH,
    Mesh.cpp:42-51). tri_rows: (T2, TRI_W) packed rows. pts (B, 3) -> (B,)
    f32."""
    p = pts.to(torch.float32)
    B, T2 = p.shape[0], tri_rows.shape[0]
    best_d2 = torch.full((B,), float("inf"), dtype=torch.float32,
                         device=p.device)
    best_row = torch.zeros((B, tri_rows.shape[1]), dtype=tri_rows.dtype,
                           device=p.device)
    for s in range(0, T2, chunk):
        rows = tri_rows[s: s + chunk]
        a, b, c = _tri_parts(rows[None])                       # (1, ch, 3)
        closest, _ = _tri.closest_point_triangle(p[:, None, :], a, b, c)
        d2 = torch.sum((p[:, None, :] - closest) ** 2, dim=-1)  # (B, ch)
        d2b, k = torch.min(d2, dim=-1)
        better = d2b < best_d2
        best_row = torch.where(better[:, None], rows[k], best_row)
        best_d2 = torch.where(better, d2b, best_d2)
    return _signed(best_row, p)


def signed_distance_tiles(tri_rows, pts, table=None) -> torch.Tensor:
    """Exact signed distances: the closest triangle by kernel P1, then the
    sign on it. ``table``: ``tiles_sdf.tile_table(tri_rows)``, made by P1's
    wrapper when not given. pts (B, 3) -> (B,) f32."""
    p = pts.to(torch.float32)
    _, best_idx = closest_tri_tiles(tri_rows, p, table)
    return _signed_from_best(tri_rows, best_idx, p)


# --------------------------------------------------------------------------
# K10: the hybrid prune (kd clusters, then subclusters, then an exact refine)
# --------------------------------------------------------------------------

def cluster_aabbs(bvh: BVH):
    """(NC, 3) lo / hi boxes of the level-1 kd clusters (the heap level
    whose nodes cover CLUSTER leaf rows). Dummy-padded clusters inherit BIG
    coordinates and are never kept by the prune."""
    T2 = bvh.n_leaves
    cs = min(CLUSTER, T2)
    first = max(T2 // cs, 1)
    nr = bvh.node_rows[first:2 * first]
    lo = torch.minimum(nr[:, 0:3], nr[:, 6:9]).contiguous()
    hi = torch.maximum(nr[:, 3:6], nr[:, 9:12]).contiguous()
    return lo, hi


def _layout(node_lo, node_rows, tri_rows, k1, k2):
    """The prune's shape, as _hybrid_closest derives it: (nc, first, sub,
    two_level, k1 and k2 clipped to what there is)."""
    T2 = tri_rows.shape[0]
    cs = min(CLUSTER, T2)
    nc = node_lo.shape[0]
    first = max(T2 // cs, 1)
    two_level = cs >= 8 and 4 * first + 4 * nc <= node_rows.shape[0]
    sub = cs // 8 if two_level else cs
    if k1 < 1 or k2 < 1:
        raise ValueError(f"hybrid_closest: k1 = {k1}, k2 = {k2} must be >= 1")
    if nc < 1 or nc * cs > T2:
        raise ValueError(f"hybrid_closest: {nc} clusters of {cs} rows do not "
                         f"fit {T2} rows (node_lo is not cluster_aabbs')")
    k1 = min(k1, nc)
    k2 = min(k2, 8 * k1) if two_level else k2
    return nc, first, sub, two_level, k1, k2


def _select_min(d2, k):
    """The k smallest entries of each row of d2 (B, N) (ties to the lower
    index), as indices in ascending order (B, k), and the smallest entry
    left out (B,), +inf where none is (k >= N: every index)."""
    n = d2.shape[-1]
    if k >= n:
        idx = torch.arange(n, device=d2.device).expand(d2.shape[0], n)
        return idx, torch.full(d2.shape[:-1], float("inf"), dtype=d2.dtype,
                               device=d2.device)
    order = torch.sort(d2, dim=-1, stable=True).indices
    bound = d2.gather(1, order[:, k:k + 1])[:, 0]
    return order[:, :k].sort(dim=-1).values, bound


def _axes_dist2(p, lo, hi):
    """Squared point-box distances, p (B, 3) against lo/hi (N, 3) or (B, N,
    3) -> (B, N), the axes added x + y then + z as the kernels add them."""
    if lo.dim() == 2:
        lo, hi = lo[None], hi[None]
    return _tri.aabb_dist2(p[:, None, :], lo, hi)


def _hybrid_shape(nc, k1, k2, two_level):
    """K10's launch shape for these (clipped) widths: (NCH chunks, warps a
    block, list capacities cap1 and cap2 in keys, shared memory in bytes).
    A list of k takes min(2 (k + 1), n + 32) keys rounded up to a power of
    two, so a compaction keeps k + 1 and admits as many; where 8 warps do
    not fit in MAX_SMEM a block takes fewer, and where one does not, the
    lists' spare room halves down to the 32 keys a step adds (min(k + 33,
    n + 32) keys: a compaction every 32 keys that join)."""
    nch = min(nc // 32, HYBRID_CHUNKS) if nc >= 64 else 1
    n2 = 8 * k1

    def ideal(k, n):
        want, c = min(2 * (k + 1), n + 32), 64
        while c < want:
            c <<= 1
        return c

    def smem(w, c1, c2):
        return 8 * w * (c1 + c2) + 4 * w * nch + 24 * nch

    c1, c2 = ideal(k1, nc), ideal(k2, n2) if two_level else 0
    for w in range(HYBRID_WARPS, 0, -1):
        if smem(w, c1, c2) <= MAX_SMEM:
            return nch, w, c1, c2, smem(w, c1, c2)
    e1, e2 = c1 - k1 - 1, c2 - k2 - 1
    while True:
        e1, e2 = max(32, e1 // 2), max(32, e2 // 2)
        c1 = min(k1 + 1 + e1, nc + 32)
        c2 = min(k2 + 1 + e2, n2 + 32) if two_level else 0
        if smem(1, c1, c2) <= MAX_SMEM:
            return nch, 1, c1, c2, smem(1, c1, c2)
        if e1 == e2 == 32:
            raise ValueError(f"hybrid_closest: {nc} clusters with k1 = {k1}, "
                             f"k2 = {k2} need {smem(1, c1, c2)} bytes of "
                             "shared memory")


def hybrid_closest_plain(node_lo, node_hi, node_rows, tri_rows, p,
                         k1: int = HYBRID_K1, k2: int = HYBRID_K2,
                         with_blocks: bool = False):
    """K10's plain version, following ``hpsdf_tpu.mesh.sdf._hybrid_closest``
    with an exact selection (the reference's ``approx_max_k`` is an exact
    top-k on the CPU): the k1 nearest clusters, the k2 nearest of their
    subclusters, the exact cascade over those rows. Returns (best_d2 f32[B],
    best_idx i32[B], bound f32[B]) and, with ``with_blocks``, the kept
    (sub)cluster ids i64[B, K] and their rows' count each. ``bound`` is the
    exact minimum squared box distance over everything pruned. Chunked over
    the points to bound the gather's memory; the chunks do not change a
    result."""
    _check_pts(p, node_lo, node_hi, node_rows, tri_rows)
    nc, first, sub, two_level, k1, k2 = _layout(node_lo, node_rows,
                                                tri_rows, k1, k2)
    B, dev = p.shape[0], p.device
    best_d2 = torch.empty(B, dtype=torch.float32, device=dev)
    best_idx = torch.empty(B, dtype=torch.int32, device=dev)
    bound = torch.empty(B, dtype=torch.float32, device=dev)
    n_blocks = k2 if two_level else k1
    blocks = torch.empty((B, n_blocks), dtype=torch.int64, device=dev)
    chunk = max(1, PLAIN_CANDIDATES // (n_blocks * sub))
    eight = torch.arange(8, device=dev)
    for s in range(0, B, chunk):
        pb = p[s:s + chunk]
        cidx, bd = _select_min(_axes_dist2(pb, node_lo, node_hi), k1)
        if two_level:
            # rows 4n .. 4n+3 of cluster heap node n = first + c hold its 8
            # subclusters' boxes, two a row; subcluster j of c is 8 c + j
            rows = node_rows[4 * (first + cidx)[..., None]
                             + torch.arange(4, device=dev)]   # (b, K1, 4, 16)
            slo = torch.stack([rows[..., 0:3], rows[..., 6:9]],
                              dim=-2).reshape(pb.shape[0], -1, 3)
            shi = torch.stack([rows[..., 3:6], rows[..., 9:12]],
                              dim=-2).reshape(pb.shape[0], -1, 3)
            sidx, bd2 = _select_min(_axes_dist2(pb, slo, shi), k2)
            subids = (cidx[:, :, None] * 8 + eight).reshape(pb.shape[0], -1)
            bid = subids.gather(1, sidx)
            bd = torch.minimum(bd, bd2)
        else:
            bid = cidx
        rows_idx = (bid[:, :, None] * sub
                    + torch.arange(sub, device=dev)).reshape(pb.shape[0], -1)
        d2 = _tri_d2(tri_rows[rows_idx], pb[:, None, :])
        d2b, j = torch.min(d2, dim=-1)          # the first: the lowest row
        best_d2[s:s + chunk] = d2b
        best_idx[s:s + chunk] = rows_idx.gather(1, j[:, None])[:, 0].int()
        bound[s:s + chunk] = bd
        blocks[s:s + chunk] = bid
    if with_blocks:
        return best_d2, best_idx, bound, blocks, sub
    return best_d2, best_idx, bound


def hybrid_closest(node_lo, node_hi, node_rows, tri_rows, p,
                   k1: int = HYBRID_K1, k2: int = HYBRID_K2):
    """Two-level pruned closest triangle: kernel K10 on CUDA tensors,
    ``hybrid_closest_plain`` on CPU tensors. node_lo / node_hi:
    ``cluster_aabbs(bvh)``; tri_rows: the packed rows or the BVH's
    ``vertex_rows`` (the same results; K10 reads the latter faster).
    Returns (best_d2 f32[B], best_idx i32[B], bound f32[B]);
    ``max(0, sqrt(best_d2) - sqrt(bound))`` is a guaranteed bound on the
    distance's error (``_dist_err_bound``)."""
    _check_pts(p, node_lo, node_hi, node_rows, tri_rows)
    if p.device.type == "cpu":
        return hybrid_closest_plain(node_lo, node_hi, node_rows, tri_rows, p,
                                    k1, k2)
    return _hybrid_launch(node_lo, node_hi, node_rows, tri_rows, p, k1, k2)


def _hybrid_launch(node_lo, node_hi, node_rows, tri_rows, p, k1=HYBRID_K1,
                   k2=HYBRID_K2, with_stats=False):
    """Kernel K10; with ``with_stats`` also i32[B, 4], each point's work:
    chunks visited, cluster and subcluster box distances taken, rows
    scanned."""
    _check_pts(p, node_lo, node_hi, node_rows, tri_rows)
    if p.device.type != "cuda":
        raise ValueError(f"hybrid_closest: unsupported device {p.device}")
    nc, first, sub, two_level, k1, k2 = _layout(node_lo, node_rows,
                                                tri_rows, k1, k2)
    _check_rows("hybrid_closest", tri_rows)
    if nc != first:
        raise ValueError(f"hybrid_closest: {nc} clusters, not the {first} "
                         "of cluster_aabbs, whose heap the kernel prunes by")
    if tri_rows.shape[0] >= 2 ** 31:
        raise ValueError("hybrid_closest: too many rows for 32-bit indices")
    if not (node_lo.is_contiguous() and node_hi.is_contiguous()
            and node_rows.is_contiguous() and node_rows.shape[1] == 16
            and node_rows.data_ptr() % 16 == 0):
        raise ValueError("hybrid_closest: node_lo, node_hi (NC, 3) and "
                         "node_rows (N, 16) must be contiguous")
    shape = _hybrid_shape(nc, k1, k2, two_level)
    p = p.contiguous()
    B, dev = p.shape[0], p.device
    best_d2 = torch.empty(B, dtype=torch.float32, device=dev)
    best_idx = torch.empty(B, dtype=torch.int32, device=dev)
    bound = torch.empty(B, dtype=torch.float32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev) \
        if with_stats else None
    if B:
        lib = _kernels.load()
        _kernels.check(lib, lib.hpsdf_hybrid(
            node_lo.data_ptr(), node_hi.data_ptr(), node_rows.data_ptr(),
            tri_rows.data_ptr(), tri_rows.stride(0), nc, first, sub, k1, k2,
            int(two_level), *shape, p.data_ptr(), B, best_d2.data_ptr(),
            best_idx.data_ptr(), bound.data_ptr(),
            stats.data_ptr() if with_stats else None,
            _kernels.stream_of(p)), "hybrid")
        hybrid_closest.launches += 1
    if with_stats:
        return best_d2, best_idx, bound, stats
    return best_d2, best_idx, bound


hybrid_closest.launches = 0


def _dist_err_bound(d2, bound):
    """Guaranteed distance error of a pruned result: the true distance is
    >= min(found, sqrt(min pruned lower bound))."""
    return torch.clamp(torch.sqrt(d2) - torch.sqrt(torch.clamp(bound,
                                                               min=0.0)),
                       min=0.0)


def signed_distance_hybrid(bvh: BVH, pts, k1: int = HYBRID_K1,
                           k2: int = HYBRID_K2, atol: float = 0.0,
                           with_stats: bool = False):
    """Signed distances by the two-level cluster prune with an exact refine
    (K10). Every point carries a guaranteed error bound; points whose bound
    exceeds ``atol`` escalate to 4x the prune widths, then to the exact
    tile scan (P1). atol = 0 therefore matches signed_distance_brute up to
    the argmin's tie order. The masks and indices stay on the points'
    device. With ``with_stats`` also returns (points escalated once, points
    escalated to P1)."""
    p = pts.to(torch.float32)
    lo, hi = cluster_aabbs(bvh)
    verts = bvh.vertex_rows
    d2, idx, bd = hybrid_closest(lo, hi, bvh.node_rows, verts, p, k1, k2)
    bad = torch.nonzero(_dist_err_bound(d2, bd) > atol).flatten()
    n_bad = n_worse = 0
    if bad.numel():
        n_bad = bad.numel()
        d2b, idxb, bdb = hybrid_closest(lo, hi, bvh.node_rows, verts,
                                        p[bad], 4 * k1, 4 * k2)
        idx = idx.clone()
        idx[bad] = idxb
        worse = torch.nonzero(_dist_err_bound(d2b, bdb) > atol).flatten()
        if worse.numel():
            n_worse = worse.numel()
            _, idxw = closest_tri_tiles(bvh.tri_rows, p[bad[worse]])
            idx[bad[worse]] = idxw
    out = _signed_from_best(bvh.tri_rows, idx, p)
    return (out, (n_bad, n_worse)) if with_stats else out


def hybrid_sdf_fn(bvh: BVH, k1: int = HYBRID_K1, k2: int = HYBRID_K2):
    """Batched F: (K, 3) -> (K,) by the fixed-K hybrid prune (K10, no
    escalation: the distance error is bounded by the pruned boxes' slack,
    ~1e-4 at most on the reference's 1.3M-triangle differential). F casts
    the points to f32 and returns the caller's dtype."""
    lo, hi = cluster_aabbs(bvh)
    node_rows, tri_rows, verts = bvh.node_rows, bvh.tri_rows, bvh.vertex_rows

    def F(pts):
        p = pts.to(torch.float32)
        _, idx, _ = hybrid_closest(lo, hi, node_rows, verts, p, k1, k2)
        return _signed_from_best(tri_rows, idx, p).to(pts.dtype)

    F.method = "hybrid"
    return F


def mesh_sdf(mesh: TriMesh, bvh: BVH | None = None,
             max_iters: int | None = None, method: str = "auto", *,
             device=_device.DEFAULT):
    """Wrap a mesh as a batched SDF callable F: (K, 3) -> (K,) for
    build_octree (MeshingUnitTests.cpp:110-138 + HPUnitTests.cpp:60-61),
    with the reference's parameters in its order
    (hpsdf_tpu/mesh/sdf.py:444-445).

    ``method``: "tiles" (the exact dense scan, kernel P1), "hybrid" (the
    kd-cluster prune with an exact refine, kernel K10, fixed K), "bvh" (the
    walk, kernel K11, bounded by ``max_iters``: by default 48 * depth
    iterations, which with the greedy seed is exact near the surface and a
    tight upper bound deep inside; 0 means exact), or "auto" (tiles up to
    AUTO_TILES_MAX rows, hybrid above). F casts the points to f32 and
    returns the caller's dtype; ``F.method`` names the method taken. The
    mesh's rows live on the BVH's device; without a ``bvh``, one is built on
    ``device``. F takes points there.
    """
    if bvh is None:
        bvh = build_bvh(mesh, device)
    if method == "auto":
        method = "tiles" if bvh.n_leaves <= AUTO_TILES_MAX else "hybrid"
    if method == "hybrid":
        return hybrid_sdf_fn(bvh)
    if method == "tiles":
        tri_rows = bvh.tri_rows
        table = tile_table(tri_rows)        # once for every call of F

        def F_tiles(pts):
            return signed_distance_tiles(tri_rows, pts, table).to(pts.dtype)

        F_tiles.method = "tiles"
        return F_tiles
    if method != "bvh":
        raise ValueError(f"unknown mesh_sdf method {method!r}")
    if max_iters is None:
        max_iters = 48 * max(bvh.depth, 1)
    elif max_iters == 0:
        max_iters = None

    def F_bvh(pts):
        return signed_distance(bvh, pts, max_iters=max_iters).to(pts.dtype)

    F_bvh.method = "bvh"
    return F_bvh
