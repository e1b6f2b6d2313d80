"""The port's whole slice at small size against hpsdf_tpu: procedural mesh
-> half-edges and pseudo-normals -> packed rows -> mesh F -> f64 fit ->
query, on the config of tests/test_mesh.py:104-116. The mesh is
icosphere(0.3, 1): the coarse stage alone evaluates F at 3M points, which
at subdivision 2 takes either side well over 15 s on a CPU.

The JAX side fits F = signed_distance_brute over its own rows, the plain
reference of the tiles kernel; the port fits mesh_sdf(method="tiles") on
CPU tensors, i.e. the plain version of kernel P1. F is f32 in both, so
the two differ by f32 rounding order only. The icosphere is symmetric, so
mirror-image cells tie in error up to rounding (see test_torch_build.py):
the tree's size and degree histogram must be equal, and queries agree to
1e-6.
"""

import numpy as np
import jax.numpy as jnp
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import mesh as JM
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch.mesh import gen

from .test_torch_query import few_torch_threads  # noqa: F401
from .util import uniform_pts


def test_slice_mesh_to_query():
    v, f = gen.icosphere(0.3, 1)
    kw = dict(target_error=1e-5, continuity=False, max_depth=4,
              max_degree=4, fit_dtype="float64")

    rows = JM.build_bvh(JM.build_mesh(v, f)).tri_rows
    jt = hp.build_octree(
        hp.Config(**kw),
        lambda p: JM.signed_distance_brute(rows, p).astype(p.dtype))

    F = TM.mesh_sdf(TM.build_mesh(v, f), method="tiles", device="cpu")
    tt = T.build_octree(T.Config(**kw), F, device="cpu")

    assert tt.n_nodes == jt.n_nodes
    n = jt.n_nodes
    for k in ("depth", "degree"):
        np.testing.assert_array_equal(
            np.bincount(getattr(tt, k).numpy()[:n] + 1),
            np.bincount(np.asarray(getattr(jt, k))[:n] + 1), err_msg=k)

    pts = uniform_pts(5000, seed=4)
    want = np.asarray(hp.query(jt, jnp.asarray(pts)))
    got = T.query(tt, torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and both fit the mesh: the subdiv-1 faceting error is ~3e-2
    assert np.abs(got - (np.linalg.norm(pts, axis=-1) - 0.3)).max() < 0.06
