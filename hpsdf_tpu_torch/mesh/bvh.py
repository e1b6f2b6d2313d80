"""Packed triangle rows over a median-split (kd) order, plus the implicit
perfect-heap BVH laid over it (the counterpart of ``hpsdf_tpu/mesh/bvh.py``;
reference Meshing::BVH, Source/Meshing/BVH.cpp).

The host build takes the native kd order and row packing
(``hpsdf_tpu_torch.native``) when available, else numpy, as
``hpsdf_tpu/mesh/bvh.py`` does; ``build_bvh`` puts the finished rows on the
given device as f32 tensors. The dense tile scan (``tiles_sdf``) reads only
``tri_rows``; ``node_rows`` (both children's AABBs per heap node) serves the
BVH walk (kernel K11) and the hybrid prune (kernel K10). ``from_numpy`` and
``to_numpy`` carry a BVH's arrays between packages or devices.

Dummy padding triangles (coordinates 1e30) fill the leaf level to a power
of two; their squared distance overflows f32 to +inf and never wins.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _device
from .. import native
from . import tri as _tri
from .core import TriMesh

BIG = 1e30
TRI_W = 32            # packed triangle row width
# triangle row lanes
_V0, _V1, _V2 = 0, 3, 6          # vertices
_FN = 9                          # face normal
_VPN = 12                        # 3 vertex pseudo-normals (12, 15, 18)
_EPN = 21                        # 3 edge pseudo-normals (21, 24, 27)


def pack_triangles(mesh: TriMesh, order: np.ndarray) -> np.ndarray:
    """(T2, TRI_W) f32 rows: vertices, face normal, vertex and edge
    pseudo-normals -- everything the distance + sign evaluation needs from
    one row."""
    T = order.size
    rows = np.full((T, TRI_W), 0.0, np.float32)
    fc = mesh.faces[order]
    v = mesh.vertices
    rows[:, _V0:_V0 + 3] = v[fc[:, 0]]
    rows[:, _V1:_V1 + 3] = v[fc[:, 1]]
    rows[:, _V2:_V2 + 3] = v[fc[:, 2]]
    rows[:, _FN:_FN + 3] = mesh.face_normals[order]
    for k in range(3):
        rows[:, _VPN + 3 * k:_VPN + 3 * k + 3] = mesh.vertex_pn[fc[:, k]]
        rows[:, _EPN + 3 * k:_EPN + 3 * k + 3] = mesh.edge_pn[order, k]
    return rows


@dataclasses.dataclass(frozen=True)
class BVH:
    node_rows: torch.Tensor  # f32[T2, 16] heap nodes 1..T2-1: [lmin lmax rmin rmax pad]
    tri_rows: torch.Tensor   # f32[T2, TRI_W] kd-ordered packed triangles
    n_tris: int              # real triangles
    depth: int               # log2(T2)

    @property
    def n_leaves(self) -> int:
        return self.tri_rows.shape[0]

    @functools.cached_property
    def vertex_rows(self) -> torch.Tensor:
        """The vertex lanes of ``tri_rows`` as a contiguous (T2, 12) f32
        copy, 48 bytes a row, made at first use and kept: the rows the hybrid
        prune's cascade (kernel K10) and the BVH walk's leaves (kernel K11)
        read, lanes 0..8 of every triangle, which in a 128-byte packed row
        cost two 32-byte sectors and here come in whole 128-byte lines (32
        consecutive rows). Row indices are ``tri_rows``'; the kernels and
        their plain versions give the same results on either."""
        return self.tri_rows[:, :12].contiguous()


def kd_order(cent: np.ndarray, T2: int) -> np.ndarray:
    """Recursive median-split ordering of T2 slots (the first cent.shape[0]
    real centroids, the rest dummy slots pushed to segment tails), such that
    every power-of-two-aligned index range is a compact spatial box."""
    T = cent.shape[0]
    coords = np.full((T2, 3), BIG, np.float32)
    coords[:T] = cent.astype(np.float32)
    order = np.arange(T2)
    half = T2
    while half > 2:
        # per-segment extents -> split axis; segments are equal-size
        # contiguous runs, so everything vectorizes as (nseg, half) blocks
        c = coords[order]
        nseg = T2 // half
        cs = c.reshape(nseg, half, 3)
        ext = cs.max(axis=1) - cs.min(axis=1)            # (nseg, 3)
        axis = np.argmax(ext, axis=1)                    # (nseg,)
        key = np.take_along_axis(
            cs, axis[:, None, None], axis=2)[..., 0]     # (nseg, half)
        idx = np.argsort(key, axis=1, kind="stable")     # within segments
        order = np.take_along_axis(order.reshape(nseg, half), idx,
                                   axis=1).reshape(-1)
        half //= 2
    return order


def build_bvh(mesh: TriMesh, device=_device.DEFAULT) -> BVH:
    """Median-split (kd) triangle ordering + level-by-level AABB unions over
    a perfect heap (replaces BVH::Create, BVH.cpp:217-260), on ``device``.
    With the native library the rows equal ``hpsdf_tpu``'s bit for bit; the
    numpy kd order may break ties otherwise."""
    device = _device.resolve(device)
    T = mesh.n_faces
    cent = mesh.vertices[mesh.faces].mean(axis=1)
    T2 = 1 << max(0, (T - 1).bit_length())
    # native nth_element recursion when available (the numpy path pays a
    # full argsort per level)
    full = native.kd_order(cent, T2)
    if full is None:
        full = kd_order(cent, T2)
    # dummy slots end at segment tails, not one global suffix: scatter the
    # real triangles to their kd slots and leave BIG rows elsewhere
    slots = np.flatnonzero(full < T)
    tri_rows = native.pack_tri_rows(
        mesh.vertices, mesh.faces, mesh.face_normals, mesh.vertex_pn,
        mesh.edge_pn, full[slots], slots, T2, BIG)
    if tri_rows is None:
        tri_rows = np.full((T2, TRI_W), BIG, np.float32)
        tri_rows[slots] = pack_triangles(mesh, full[slots])

    node_rows = native.bvh_node_rows(tri_rows)
    if node_rows is None:
        # leaf AABBs (dummies get +BIG boxes), then level-by-level unions up
        # the heap: leaves are heap ids T2..2*T2-1, and every internal row
        # stores both children's AABBs
        tris = tri_rows[:, :9].reshape(T2, 3, 3).astype(np.float64)
        cur_min, cur_max = _tri.triangle_aabbs(tris)
        node_rows = np.zeros((max(T2, 1), 16), np.float32)
        first = T2 // 2
        while first >= 1:
            l_min, l_max = cur_min[0::2], cur_max[0::2]
            r_min, r_max = cur_min[1::2], cur_max[1::2]
            idx = np.arange(first, 2 * first)
            node_rows[idx, 0:3] = l_min
            node_rows[idx, 3:6] = l_max
            node_rows[idx, 6:9] = r_min
            node_rows[idx, 9:12] = r_max
            cur_min = np.minimum(l_min, r_min)
            cur_max = np.maximum(l_max, r_max)
            first //= 2

    return from_numpy(node_rows, tri_rows, T, max(0, (T - 1).bit_length()),
                      device=device)


def from_numpy(node_rows, tri_rows, n_tris: int, depth: int, *,
               device=_device.DEFAULT) -> BVH:
    """A BVH from its arrays (numpy, or anything ``np.asarray`` reads, such
    as an ``hpsdf_tpu`` BVH's), as f32 tensors on ``device``."""
    device = _device.resolve(device)

    def put(a):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(a if a.flags.writeable else a.copy(),
                               device=device)

    return BVH(node_rows=put(node_rows), tri_rows=put(tri_rows),
               n_tris=int(n_tris), depth=int(depth))


def to_numpy(bvh: BVH):
    """(node_rows, tri_rows, n_tris, depth) with the rows as numpy f32."""
    return (bvh.node_rows.cpu().numpy(), bvh.tri_rows.cpu().numpy(),
            bvh.n_tris, bvh.depth)
