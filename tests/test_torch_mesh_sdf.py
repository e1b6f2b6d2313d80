"""The mesh -> SDF path of hpsdf_tpu_torch against hpsdf_tpu: the plain
version of kernel P1 (closest_tri_tiles_plain, which CPU tensors take)
against the Pallas kernel in interpret mode, as tests/test_pallas_sdf.py
runs it; signed distances against the brute-force oracle; and the port's
own mesh, BVH and row packing."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import mesh as JM
from hpsdf_tpu.mesh import pallas_sdf
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch.mesh import gen, tiles_sdf

from .test_torch_query import few_torch_threads  # noqa: F401
from .util import cube_mesh, uniform_pts


def _mesh(name):
    if name == "cube":
        return cube_mesh(half=0.2)
    return gen.icosphere(0.3, 3)


@pytest.fixture(scope="module", params=["cube", "ico"])
def meshes(request):
    v, f = _mesh(request.param)
    jbvh = JM.build_bvh(JM.build_mesh(v, f))
    return v, f, np.array(jbvh.tri_rows)        # writable copy


@pytest.mark.parametrize("n", [1, 7, 130])
def test_closest_tri_plain_matches_pallas(meshes, n):
    _, _, rows = meshes
    pts = uniform_pts(n, seed=n).astype(np.float32)
    d2_j, idx_j = pallas_sdf.closest_tri_tiles(jnp.asarray(rows),
                                               jnp.asarray(pts))
    d2_t, idx_t = TM.closest_tri_tiles(torch.as_tensor(rows),
                                       torch.as_tensor(pts))
    assert d2_t.dtype == torch.float32 and idx_t.dtype == torch.int32
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=0,
                               atol=1e-7)
    # idx is equal wherever the best triangle leads the second best by more
    # than the tolerance. Triangles sharing the closest vertex or edge tie
    # up to rounding, and XLA contracts the cascade's a*b+c into FMAs where
    # torch does not, so there either index must reach the same d2.
    t = torch.as_tensor(rows)[:, :9].T[:, None, :]
    p = torch.as_tensor(pts)
    full = tiles_sdf._closest_d2(p[:, 0:1], p[:, 1:2], p[:, 2:3],
                                 *t).numpy()                        # (n, T)
    srt = np.sort(full, axis=1)
    clear = srt[:, 1] - srt[:, 0] > 1e-7
    idx_j = np.asarray(idx_j)
    np.testing.assert_array_equal(idx_t.numpy()[clear], idx_j[clear])
    ar = np.arange(n)
    np.testing.assert_allclose(full[ar, idx_t.numpy()], full[ar, idx_j],
                               rtol=0, atol=1e-7)


def test_signed_distance_tiles_and_brute(meshes):
    _, _, rows = meshes
    pts = uniform_pts(300, seed=11)
    want = np.asarray(JM.signed_distance_brute(jnp.asarray(rows),
                                               jnp.asarray(pts)))
    rt, pt = torch.as_tensor(rows), torch.as_tensor(pts)
    np.testing.assert_allclose(TM.signed_distance_tiles(rt, pt).numpy(),
                               want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(TM.signed_distance_brute(rt, pt).numpy(),
                               want, rtol=0, atol=1e-6)


def test_port_mesh_and_rows_match(meshes):
    v, f, rows = meshes
    jm, tm = JM.build_mesh(v, f), TM.build_mesh(v, f)
    for k in ("face_normals", "vertex_pn", "edge_pn"):
        np.testing.assert_allclose(getattr(tm, k), getattr(jm, k), rtol=0,
                                   atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(tm.twin, jm.twin)
    tb = TM.build_bvh(tm, device="cpu")
    assert tb.tri_rows.shape == rows.shape and tb.tri_rows.dtype == \
        torch.float32
    pts = uniform_pts(300, seed=12)
    want = np.asarray(JM.signed_distance_brute(jnp.asarray(rows),
                                               jnp.asarray(pts)))
    got = TM.signed_distance_tiles(tb.tri_rows, torch.as_tensor(pts))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # pack_triangles lays out the same lanes for the same order
    order = np.arange(f.shape[0])
    np.testing.assert_allclose(TM.pack_triangles(tm, order),
                               JM.bvh.pack_triangles(jm, order), rtol=0,
                               atol=1e-7)


def test_mesh_sdf_auto_takes_tiles_and_keeps_dtype():
    v, f = gen.icosphere(0.3, 2)
    F = TM.mesh_sdf(TM.build_mesh(v, f), device="cpu")
    assert F.method == "tiles"
    pts = torch.as_tensor(uniform_pts(200, seed=14))
    vals = F(pts)
    assert vals.dtype == torch.float64
    r = np.linalg.norm(pts.numpy(), axis=-1)
    np.testing.assert_allclose(vals.numpy(), r - 0.3, atol=0.02)
    # the hybrid prune and the BVH walk run too, and agree with the scan
    brute = TM.signed_distance_brute(
        TM.build_bvh(TM.build_mesh(v, f), device="cpu").tri_rows, pts)
    for method in ("hybrid", "bvh"):
        Fm = TM.mesh_sdf(TM.build_mesh(v, f), method=method, device="cpu")
        assert Fm.method == method
        got = Fm(pts)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), brute.numpy(), rtol=0,
                                   atol=1e-6)
