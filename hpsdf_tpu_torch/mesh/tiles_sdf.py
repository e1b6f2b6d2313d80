"""Exact closest triangle per point by a dense points x triangles scan.

The port of ``hpsdf_tpu/mesh/pallas_sdf.py`` (the Pallas TPU kernel
``closest_tri_tiles``). ``closest_tri_tiles`` is kernel P1: on CUDA tensors
it launches ``csrc/closest_tri.cu``; on CPU tensors it runs
``closest_tri_tiles_plain``, a chunked torch scan of the same function,
which is also what the kernel is held against on the card.

Contract (as the TPU kernel's): tri_rows f32 (T, >=9), of which lanes 0..8
(the vertices) are read; pts f32 (B, 3). Returns best_d2 f32[B] and
best_idx i32[B] into tri_rows, the lowest index on ties, clipped to
[0, T-1]. Padding rows of coordinate 1e30 never win.
"""

from __future__ import annotations

import torch

from .. import _kernels

_EPS = 1e-30
# plain-scan chunk: (points x triangles) f32 tiles of 8M elements keep the
# ~30 live temporaries of the cascade around 1 GB
_PT_CHUNK = 8192
_TRI_CHUNK = 1024


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


def closest_tri_tiles(tri_rows: torch.Tensor, pts: torch.Tensor):
    """Exact closest triangle per point: kernel P1 on CUDA tensors, the
    plain scan on CPU tensors. Returns (best_d2 f32[B], best_idx i32[B])."""
    _check(tri_rows, pts)
    if pts.device.type == "cpu":
        return closest_tri_tiles_plain(tri_rows, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"closest_tri_tiles: unsupported device {pts.device}")
    if tri_rows.stride(1) != 1:
        raise ValueError("tri_rows lanes must be contiguous")
    pts = pts.contiguous()
    B, T = pts.shape[0], tri_rows.shape[0]
    best_d2 = torch.empty(B, dtype=torch.float32, device=pts.device)
    best_idx = torch.empty(B, dtype=torch.int32, device=pts.device)
    if B == 0:
        return best_d2, best_idx
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_closest_tri(
        tri_rows.data_ptr(), T, tri_rows.stride(0), pts.data_ptr(), B,
        best_d2.data_ptr(), best_idx.data_ptr(), _kernels.stream_of(pts)),
        "closest_tri")
    closest_tri_tiles.launches += 1
    return best_d2, best_idx


closest_tri_tiles.launches = 0
