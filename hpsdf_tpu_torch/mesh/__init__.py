"""Mesh -> SDF pipeline (the counterpart of ``hpsdf_tpu.mesh``).

  obj.py       <- ObjParser: .obj parsing, native or numpy (copied)
  core.py      <- Mesh: half-edges + pseudo-normals, native or numpy
  tri.py       <- closest point on a triangle, box distances, in torch
  bvh.py       <- packed triangle rows + perfect-heap BVH (host build,
                  native or numpy)
  nn.py        <- NNOctree: nearest-neighbour point index (copied)
  tiles_sdf.py <- kernel P1: dense closest-triangle scan (replaces the
                  Pallas kernel in hpsdf_tpu/mesh/pallas_sdf.py)
  sdf.py       <- signed distance: the BVH walk (kernel K11), the hybrid
                  prune (kernel K10), the sign on the best triangle
                  (kernel K14), the scans, and the F callable for
                  build_octree
"""

from .obj import load_obj
from .core import TriMesh, build_mesh, mesh_from_obj, NotWatertightError
from .bvh import BVH, build_bvh, pack_triangles
from .nn import PointIndex
from .tiles_sdf import closest_tri_tiles, closest_tri_tiles_plain
from .sdf import (mesh_sdf, signed_distance, signed_distance_brute,
                  signed_distance_tiles, signed_distance_hybrid,
                  hybrid_sdf_fn, hybrid_closest, hybrid_closest_plain,
                  closest_bvh, closest_bvh_plain, cluster_aabbs,
                  signed_from_best_kernel, signed_from_best_plain,
                  AUTO_TILES_MAX)

__all__ = [
    "load_obj", "TriMesh", "build_mesh", "mesh_from_obj",
    "NotWatertightError", "BVH", "build_bvh", "pack_triangles", "PointIndex",
    "closest_tri_tiles", "closest_tri_tiles_plain", "mesh_sdf",
    "signed_distance", "signed_distance_brute", "signed_distance_tiles",
    "signed_distance_hybrid", "hybrid_sdf_fn", "hybrid_closest",
    "hybrid_closest_plain", "closest_bvh", "closest_bvh_plain",
    "cluster_aabbs", "signed_from_best_kernel", "signed_from_best_plain",
    "AUTO_TILES_MAX",
]
