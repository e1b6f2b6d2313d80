"""The port's host side of the mesh pipeline against hpsdf_tpu: .obj
parsing (native and numpy), mesh_from_obj, PointIndex, the box helpers of
tri.py, and the native host library (half-edges, pseudo-normals, the BVH
build), mirroring tests/test_mesh.py and tests/test_native.py. Host arrays
are f64 or exact integers: they are compared for equality, or to 1e-12
where the native and numpy pseudo-normal passes add in other orders (as
tests/test_native.py allows)."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import mesh as JM
from hpsdf_tpu.mesh import obj as JO
from hpsdf_tpu.mesh import tri as JT
from hpsdf_tpu.mesh.core import mesh_from_obj as j_mesh_from_obj
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch import native
from hpsdf_tpu_torch.mesh import bvh as TB
from hpsdf_tpu_torch.mesh import core as TC
from hpsdf_tpu_torch.mesh import gen
from hpsdf_tpu_torch.mesh import tri as TT

from .test_torch_query import few_torch_threads  # noqa: F401
from .util import cube_mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SYNTH = """# all three face formats, a quad, negative indices
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
vn 0 0 1
vn 0 1 0
vt 0.5 0.5
f 1 2 3
f 1/1/1 2/1/2 4/1/1
f 1//2 3//1 4//2
f -4 -3 -2 -1
"""


@pytest.fixture
def numpy_paths(monkeypatch):
    """The port's native library switched off, as HPSDF_NO_NATIVE=1 does."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


@pytest.fixture
def native_lib():
    if not native.available():
        pytest.skip("the native library cannot be built here (no g++)")


@pytest.mark.parametrize("use_native", [True, False])
def test_load_obj_round_trip(tmp_path, native_lib, use_native):
    v, f = gen.icosphere(0.3, 2)
    path = str(tmp_path / "ico.obj")
    gen.save_obj(path, v, f)
    tv, tf, tn = TM.load_obj(path, native=use_native)
    jv, jf, jn = JO.load_obj(path, native=use_native)
    assert tv.dtype == np.float64 and tf.dtype == np.int32
    np.testing.assert_array_equal(tf, f)
    np.testing.assert_allclose(tv, v, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-12)


def test_load_obj_formats_native_and_numpy(tmp_path, native_lib):
    path = str(tmp_path / "synth.obj")
    with open(path, "w") as fh:
        fh.write(SYNTH)
    vn_, fn_, nn_ = TM.load_obj(path, native=True)
    vp, fp, np_ = TM.load_obj(path, native=False)
    np.testing.assert_array_equal(fn_, fp)
    np.testing.assert_array_equal(vn_, vp)
    np.testing.assert_allclose(nn_, np_, rtol=0, atol=1e-12)
    assert fn_.shape == (5, 3)                   # the quad fans into two


def test_mesh_from_obj_matches_reference(tmp_path):
    v, f = gen.bumpy_sphere(0.3, 2)
    path = str(tmp_path / "bumpy.obj")
    gen.save_obj(path, v, f)
    tm, jm = TM.mesh_from_obj(path), j_mesh_from_obj(path)
    assert tm.n_faces == f.shape[0] == 320
    for k in ("vertices", "faces", "twin"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    for k in ("face_normals", "vertex_pn", "edge_pn"):
        np.testing.assert_allclose(getattr(tm, k), getattr(jm, k), rtol=0,
                                   atol=1e-12, err_msg=k)


def test_point_index_matches_reference():
    """Insert, nearest, remove and nearest again through both packages
    (MeshingUnitTests.cpp:59-89's oracle at 5,000 points)."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (5000, 3))
    q = rng.uniform(-1, 1, (700, 3))
    t = TM.PointIndex.empty().insert(pts)
    j = JM.PointIndex.empty().insert(pts)
    for idx_t, idx_j, dist in ((t, j, 0.05), (t.remove(np.arange(2500)),
                                              j.remove(np.arange(2500)), 0.2)):
        ti, td = idx_t.nearest(q, max_distance=dist)
        ji, jd = idx_j.nearest(q, max_distance=dist)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
        assert (ti >= 2500 if dist == 0.2 else ti >= 0).any()
        assert not np.isin(ti, np.arange(2500)).any() or dist == 0.05
    assert (t.nearest(q, max_distance=0.05)[0] == -1).any()  # misses too
    ids, d = t.nearest(pts, max_distance=0.05)
    np.testing.assert_array_equal(ids, np.arange(5000))
    assert np.all(d == 0.0)


def test_box_helpers_match_reference():
    rng = np.random.default_rng(6)
    p = rng.uniform(-1, 1, (300, 3))
    lo = rng.uniform(-0.5, 0.0, (300, 3))
    hi = lo + rng.uniform(0.0, 0.5, (300, 3))
    got = TT.aabb_dist2(torch.as_tensor(p), torch.as_tensor(lo),
                        torch.as_tensor(hi))
    want = np.asarray(JT.aabb_dist2(jnp.asarray(p), jnp.asarray(lo),
                                    jnp.asarray(hi)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)
    assert float(got.min()) == 0.0
    tris = rng.uniform(-1, 1, (50, 3, 3))
    for a, b in zip(TT.triangle_aabbs(tris), JT.triangle_aabbs(tris)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("maker", ["cube", "ico3"])
def test_native_half_edges_and_geometry_match_numpy(maker, native_lib,
                                                    monkeypatch):
    v, f = cube_mesh() if maker == "cube" else gen.icosphere(0.3, 3)
    m_nat = TC.build_mesh(v, f)
    twins = native.half_edge_twins(np.asarray(f, np.int32), len(v))
    np.testing.assert_array_equal(twins.reshape(-1, 3), m_nat.twin)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    assert not native.available()
    m_np = TC.build_mesh(v, f)
    for k in ("face_normals", "vertex_pn", "edge_pn", "twin"):
        np.testing.assert_allclose(getattr(m_nat, k), getattr(m_np, k),
                                   rtol=0, atol=1e-12, err_msg=k)
    with pytest.raises(TC.NotWatertightError):
        TC.build_mesh(v, np.asarray(f)[:-1])


def test_native_rejects_open_mesh(native_lib):
    v, f = cube_mesh()
    with pytest.raises(TC.NotWatertightError):
        native.half_edge_twins(np.asarray(f, np.int32)[:-1], len(v))
    with pytest.raises(TC.NotWatertightError):
        TC.build_mesh(v, np.asarray(f)[:-1])


def test_build_bvh_bit_equal_to_reference(native_lib):
    """With the native kd order and packing on both sides, the port's rows
    are the reference's bit for bit."""
    v, f = gen.bumpy_sphere(0.3, 4)
    tb = TM.build_bvh(TM.build_mesh(v, f), device="cpu")
    jb = JM.build_bvh(JM.build_mesh(v, f))
    np.testing.assert_array_equal(tb.tri_rows.numpy(), np.asarray(jb.tri_rows))
    np.testing.assert_array_equal(tb.node_rows.numpy(),
                                  np.asarray(jb.node_rows))
    assert (tb.n_tris, tb.depth) == (jb.n_tris, jb.depth) == (5120, 13)


def test_bvh_numpy_path_matches_native(native_lib, numpy_paths):
    """The numpy build may order ties otherwise (test_native.py): its node
    rows are the exact heap unions of its own leaves, and both BVHs give
    the same signed distances."""
    v, f = gen.icosphere(0.3, 3)
    mesh = TM.build_mesh(v, f)
    bp = TM.build_bvh(mesh, device="cpu")               # numpy paths
    jb = JM.build_bvh(JM.build_mesh(v, f))              # native
    tris = bp.tri_rows.numpy()[:, :9].reshape(-1, 3, 3).astype(np.float64)
    lo, hi = TT.triangle_aabbs(tris)
    T2 = tris.shape[0]
    first = T2 // 2
    while first >= 1:
        idx = np.arange(first, 2 * first)
        nr = bp.node_rows.numpy()[idx]
        np.testing.assert_array_equal(nr[:, 0:3], lo[0::2].astype(np.float32))
        np.testing.assert_array_equal(nr[:, 9:12], hi[1::2].astype(np.float32))
        lo = np.minimum(lo[0::2], lo[1::2])
        hi = np.maximum(hi[0::2], hi[1::2])
        first //= 2
    bn = TB.from_numpy(np.asarray(jb.node_rows), np.asarray(jb.tri_rows),
                       jb.n_tris, jb.depth, device="cpu")
    pts = torch.as_tensor(np.random.default_rng(3).uniform(
        -0.5, 0.5, (256, 3)).astype(np.float32))
    np.testing.assert_allclose(TM.signed_distance(bp, pts).numpy(),
                               TM.signed_distance(bn, pts).numpy(), rtol=0,
                               atol=1e-6)


def test_no_native_env_forces_numpy():
    """HPSDF_NO_NATIVE=1 keeps the library unloaded; the numpy paths still
    build a mesh."""
    code = ("import sys\n"
            "from hpsdf_tpu_torch import native\n"
            "from hpsdf_tpu_torch.mesh import build_mesh, gen\n"
            "m = build_mesh(*gen.icosphere(0.3, 1))\n"
            "sys.exit(0 if not native.available() and m.n_faces == 80 "
            "else 1)\n")
    env = dict(os.environ, HPSDF_NO_NATIVE="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
