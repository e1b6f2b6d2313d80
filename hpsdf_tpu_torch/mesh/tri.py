"""Closest point on a triangle and box distances, in torch (the counterpart
of ``hpsdf_tpu/mesh/tri.py``; reference Source/Meshing/Utility.cpp:5-139,
Ericson RTCD 5.1.5).

Feature codes: 0,1,2 = vertices a,b,c; 3,4,5 = edges ab,bc,ca; 6 = face.
A branch-free where-cascade over arbitrary leading batch shapes.
"""

from __future__ import annotations

import torch

FEAT_A, FEAT_B, FEAT_C = 0, 1, 2
FEAT_AB, FEAT_BC, FEAT_CA = 3, 4, 5
FEAT_FACE = 6
_EPS = 1e-30


def _guard(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x.abs() > _EPS, x, _EPS)


def closest_point_triangle(p, a, b, c):
    """Closest point on triangle (a, b, c) to p, plus the feature code.

    p, a, b, c: (..., 3), broadcastable. Returns (closest (..., 3),
    feature (...,) i32).
    """
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = torch.sum(ab * ap, dim=-1)
    d2 = torch.sum(ac * ap, dim=-1)

    bp = p - b
    d3 = torch.sum(ab * bp, dim=-1)
    d4 = torch.sum(ac * bp, dim=-1)

    cp = p - c
    d5 = torch.sum(ab * cp, dim=-1)
    d6 = torch.sum(ac * cp, dim=-1)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # region predicates, in Ericson's order
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    in_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    in_ca = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    in_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    t_ab = d1 / _guard(d1 - d3)
    t_ca = d2 / _guard(d2 - d6)
    t_bc = (d4 - d3) / _guard((d4 - d3) + (d5 - d6))

    denom = _guard(va + vb + vc)
    v = vb / denom
    w = vc / denom
    face_pt = a + ab * v[..., None] + ac * w[..., None]

    # priority cascade (first true wins)
    feature = torch.full(d1.shape, FEAT_FACE, dtype=torch.int32,
                         device=d1.device)
    for mask, code in ((in_bc, FEAT_BC), (in_ca, FEAT_CA), (in_ab, FEAT_AB),
                       (in_c, FEAT_C), (in_b, FEAT_B), (in_a, FEAT_A)):
        feature = torch.where(mask, code, feature)

    pt = face_pt
    for code, q in ((FEAT_BC, b + (c - b) * t_bc[..., None]),
                    (FEAT_CA, a + ac * t_ca[..., None]),
                    (FEAT_AB, a + ab * t_ab[..., None]),
                    (FEAT_C, c), (FEAT_B, b), (FEAT_A, a)):
        pt = torch.where((feature == code)[..., None], q, pt)
    return pt, feature


def aabb_dist2(p, box_min, box_max):
    """Squared distance from points to AABBs (ClosestPtOnAABB, reference
    Source/Meshing/Utility.cpp:100-139). Shapes (..., 3), broadcastable.
    The axes are added in order, x + y then + z, as the kernels add them."""
    d = (torch.clamp(box_min - p, min=0.0) + torch.clamp(p - box_max, min=0.0))
    d2 = d * d
    return (d2[..., 0] + d2[..., 1]) + d2[..., 2]


def triangle_aabbs(tris):
    """(T, 3, 3) triangle vertices -> (T, 3) min, (T, 3) max (numpy, as
    ``build_bvh``'s host build holds them)."""
    return tris.min(axis=1), tris.max(axis=1)
