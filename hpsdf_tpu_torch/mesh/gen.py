"""Procedural mesh generation + .obj writing (a copy of
``hpsdf_tpu/mesh/gen.py``).

The reference benchmarks its meshing stack on a 1.6M-triangle asset
(`Ramesses.obj`, Source/Tests/MeshingBenchmarks.cpp:24-111) that is absent
from the mount (.MISSING_LARGE_BLOBS). This module generates watertight
meshes of arbitrary scale so parse / half-edge / BVH / signed-distance can
be exercised and benchmarked at and beyond reference scale:

  * ``icosphere``  -- fully vectorized subdivision (one np.unique per level
    instead of a Python dict): subdiv 8 = 1,310,720 triangles in ~2 s.
  * ``bumpy_sphere`` -- icosphere with a deterministic radial displacement
    field, a closer analogue of a scanned asset (non-constant curvature,
    anisotropic triangles) than the perfect sphere.
  * ``save_obj``   -- fast writer so the .obj parser (Python and native C++)
    can be benchmarked at reference scale.
"""

from __future__ import annotations

import numpy as np


def _icosahedron():
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.asarray([
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)], np.float64)
    f = np.asarray([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)], np.int64)
    return v, f


def subdivide(v: np.ndarray, f: np.ndarray):
    """One vectorized loop-subdivision step (midpoint only, no smoothing).
    Each triangle becomes 4; every edge gains one midpoint vertex."""
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])  # (3F, 2)
    key = (np.minimum(e[:, 0], e[:, 1]).astype(np.int64) * len(v)
           + np.maximum(e[:, 0], e[:, 1]))
    uniq, inv = np.unique(key, return_inverse=True)
    mid_idx = (len(v) + inv).reshape(3, -1).T                       # (F, 3)
    ua = (uniq // len(v)).astype(np.int64)
    ub = (uniq % len(v)).astype(np.int64)
    mids = (v[ua] + v[ub]) * 0.5
    v2 = np.concatenate([v, mids])
    a, b, c = f[:, 0], f[:, 1], f[:, 2]
    ab, bc, ca = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    f2 = np.concatenate([
        np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
        np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return v2, f2


def icosphere(radius: float = 0.3, subdivisions: int = 3,
              centre=(0.0, 0.0, 0.0)):
    """Watertight subdivided icosahedron: 20 * 4**subdivisions triangles
    (subdiv 8 = 1,310,720 -- the reference's 1.6M-tri benchmark scale)."""
    v, f = _icosahedron()
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    return v + np.asarray(centre, np.float64), f.astype(np.int32)


def bumpy_sphere(radius: float = 0.3, subdivisions: int = 6,
                 amplitude: float = 0.15, centre=(0.0, 0.0, 0.0)):
    """Icosphere with a deterministic multi-frequency radial displacement --
    a scanned-asset stand-in with non-trivial curvature (watertight)."""
    v, f = _icosahedron()
    for _ in range(subdivisions):
        v, f = subdivide(v, f)
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    bump = (np.sin(5.1 * n[:, 0] + 1.3) * np.sin(4.3 * n[:, 1])
            + 0.5 * np.sin(9.7 * n[:, 2] + 0.7) * np.sin(8.3 * n[:, 0]))
    r = radius * (1.0 + amplitude * 0.5 * bump[:, None])
    return n * r + np.asarray(centre, np.float64), f.astype(np.int32)


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Write a minimal v/f .obj (the format ObjParser.cpp:87-136 reads).
    Vectorized formatting: ~1 s for a 1.3M-triangle mesh."""
    with open(path, "w") as fh:
        np.savetxt(fh, vertices, fmt="v %.8g %.8g %.8g")
        np.savetxt(fh, np.asarray(faces, np.int64) + 1, fmt="f %d %d %d")
