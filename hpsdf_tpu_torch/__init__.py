"""hpsdf_tpu_torch -- the PyTorch/CUDA port of hpsdf_tpu.

hp-adaptive Legendre-octree fitting of a batched SDF, queries with
analytic gradients, CSG rebuilds, the packed read layout, sphere tracing,
field slices and inverse rendering, on torch tensors. Module names follow
``hpsdf_tpu``, which stays the reference the port is tested against; this
package imports neither it nor jax. Tensors on a CUDA device go through hand-written CUDA
kernels (``csrc/``, built by nvcc on first use); tensors on the CPU take
the plain torch version of each kernel.

The mesh -> SDF path lives in ``hpsdf_tpu_torch.mesh``. The continuity
post-process (``hpsdf_tpu_torch.continuity``, which ``build_octree`` runs
when ``Config.continuity`` is set, as it is by default), phase timing
(``hpsdf_tpu_torch.profiling``) and sharding on ``torch.distributed``
(``hpsdf_tpu_torch.parallel``) are submodules imported by name, as in
hpsdf_tpu.
"""

from .config import Config, NearnessWeighting
from .tree import Octree, save, load, from_numpy, to_numpy
from .api import (build_octree, query, query_with_gradient, query_grid,
                  as_sdf, union_sdf, subtract_sdf, intersect_sdf)
from .accel import pack_tree
from .viz import output_function_slice, function_slice
from .render import (trace, camera_rays, intersect_aabb,
                     render as render_image)
# ``render`` is the submodule (the function is exported as
# ``render_image``), as in hpsdf_tpu
from . import inverse, parallel, render

__all__ = [
    "Config", "NearnessWeighting", "Octree", "save", "load", "from_numpy",
    "to_numpy", "build_octree", "query", "query_with_gradient", "query_grid",
    "as_sdf", "union_sdf", "subtract_sdf", "intersect_sdf", "pack_tree",
    "trace", "render_image", "camera_rays", "intersect_aabb", "render",
    "output_function_slice", "function_slice", "inverse", "parallel",
]
__version__ = "0.1.0"
