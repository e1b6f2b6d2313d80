"""Batched mesh signed distance (the counterpart of ``hpsdf_tpu/mesh/sdf.py``;
reference Mesh::SignedDistanceAtPt, Source/Meshing/Mesh.cpp:42-63).

``signed_distance_brute`` -- O(T) chunked scan, the differential oracle
                             (Mesh.cpp:42-51).
``signed_distance_tiles`` -- the closest triangle by kernel P1
                             (``tiles_sdf.closest_tri_tiles``), then the sign
                             on that one triangle.
``mesh_sdf``              -- wraps a mesh as a batched F for build_octree.

Sign convention (Baerentzen-Aanaes): sign(dot(pseudo_normal(feature),
p - closest)), with the pseudo-normal picked by the closest simplex
(vertex / edge / face) -- reference Mesh.cpp:162-242.

The hybrid prune and the BVH walk are not ported yet (ROADMAP.md, queue 1
'Mesh -> SDF'); ``mesh_sdf`` raises for them.
"""

from __future__ import annotations

import torch

from .. import _device
from ..accel import row_gather
from . import bvh as _bvh
from . import tri as _tri
from .bvh import BVH, build_bvh
from .core import TriMesh
from .tiles_sdf import closest_tri_tiles, tile_table

# tiles -> hybrid crossover of mesh_sdf(method="auto"), as in hpsdf_tpu
AUTO_TILES_MAX = 65536


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


def _signed_from_best(tri_rows, best_idx, p):
    """Final sign + distance evaluation on the best triangle only; its row
    is fetched by the row gather (kernel G on CUDA tensors)."""
    return _signed(row_gather(tri_rows, best_idx), p)


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


def mesh_sdf(mesh: TriMesh, bvh: BVH | None = None,
             max_iters: int | None = None, method: str = "auto", *,
             device=_device.DEFAULT):
    """Wrap a mesh as a batched SDF callable F: (K, 3) -> (K,) for
    build_octree (MeshingUnitTests.cpp:110-138 + HPUnitTests.cpp:60-61),
    with the reference's parameters in its order
    (hpsdf_tpu/mesh/sdf.py:444-445).

    ``method``: "tiles" (exact dense scan, kernel P1 on CUDA tensors) or
    "auto" (tiles up to AUTO_TILES_MAX triangles). ``max_iters`` bounds the
    BVH walk of the "bvh" and "hybrid" methods, which are not ported yet;
    the exact tile scan has no use for it. F casts the points to f32 and
    returns the caller's dtype. The mesh's rows live on the BVH's device;
    without a ``bvh``, one is built on ``device``. F takes points there.
    """
    if bvh is None:
        bvh = build_bvh(mesh, device)
    if method == "auto":
        if bvh.n_leaves > AUTO_TILES_MAX:
            raise NotImplementedError(
                f"mesh_sdf(method='auto') on {bvh.n_leaves} rows picks the "
                "hybrid prune, which is not ported to hpsdf_tpu_torch yet "
                "(ROADMAP.md, queue 1 'Mesh -> SDF')")
        method = "tiles"
    if method in ("hybrid", "bvh"):
        raise NotImplementedError(
            f"mesh_sdf(method={method!r}) is not ported to hpsdf_tpu_torch "
            "yet (ROADMAP.md, queue 1 'Mesh -> SDF')")
    if method != "tiles":
        raise ValueError(f"unknown mesh_sdf method {method!r}")
    tri_rows = bvh.tri_rows
    table = tile_table(tri_rows)        # once for every call of F

    def F_tiles(pts):
        return signed_distance_tiles(tri_rows, pts, table).to(pts.dtype)

    F_tiles.method = "tiles"
    return F_tiles
