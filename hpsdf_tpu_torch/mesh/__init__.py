"""Mesh -> SDF pipeline (the counterpart of ``hpsdf_tpu.mesh``).

  gen.py       <- procedural watertight meshes (copied)
  core.py      <- Mesh: half-edges + pseudo-normals (numpy path)
  tri.py       <- closest point on a triangle, in torch
  bvh.py       <- packed triangle rows + perfect-heap BVH (host build)
  tiles_sdf.py <- kernel P1: dense closest-triangle scan (replaces the
                  Pallas kernel in hpsdf_tpu/mesh/pallas_sdf.py)
  sdf.py       <- signed distance and the F callable for build_octree
"""

from .core import TriMesh, build_mesh, NotWatertightError
from .bvh import BVH, build_bvh, pack_triangles
from .tiles_sdf import closest_tri_tiles, closest_tri_tiles_plain
from .sdf import (mesh_sdf, signed_distance_brute, signed_distance_tiles,
                  AUTO_TILES_MAX)

__all__ = [
    "TriMesh", "build_mesh", "NotWatertightError", "BVH", "build_bvh",
    "pack_triangles", "closest_tri_tiles", "closest_tri_tiles_plain",
    "mesh_sdf", "signed_distance_brute", "signed_distance_tiles",
    "AUTO_TILES_MAX",
]
