"""hpsdf_tpu_torch -- the PyTorch/CUDA port of hpsdf_tpu.

hp-adaptive Legendre-octree fitting of a batched SDF, and queries with
analytic gradients, on torch tensors. Module names follow ``hpsdf_tpu``,
which stays the reference the port is tested against; this package imports
neither it nor jax. Tensors on a CUDA device go through hand-written CUDA
kernels (``csrc/``, built by nvcc on first use); tensors on the CPU take
the plain torch version of each kernel.

The mesh -> SDF path lives in ``hpsdf_tpu_torch.mesh``.
"""

from .config import Config, NearnessWeighting
from .tree import Octree, save, load, from_numpy, to_numpy
from .api import build_octree, query, query_with_gradient, query_grid

__all__ = [
    "Config", "NearnessWeighting", "Octree", "save", "load", "from_numpy",
    "to_numpy", "build_octree", "query", "query_with_gradient", "query_grid",
]
__version__ = "0.1.0"
