"""The BVH walk of hpsdf_tpu_torch (kernel K11's plain version, which CPU
tensors take) against hpsdf_tpu's ``_closest_bvh_impl``, and the signed
distances and mesh F built on it, mirroring tests/test_mesh.py.

Tolerances. d2: 1e-7 absolute (the same cascade; XLA contracts a*b+c into
FMAs where torch does not, so a decision of the walk can flip only where
two distances are within an ulp). best_idx: equal, or a triangle that
reaches the same d2 within 1e-7 (triangles sharing the closest vertex or
edge tie). Signed distances: 1e-6 against the brute-force scan, 1e-5
against the analytic box (the reference's own tolerance)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import mesh as JM
from hpsdf_tpu.mesh import sdf as JS
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch.mesh import bvh as TB
from hpsdf_tpu_torch.mesh import gen
from hpsdf_tpu_torch.mesh import sdf as TS

from .test_torch_query import few_torch_threads  # noqa: F401
from .util import cube_mesh, uniform_pts

D2_ATOL = 1e-7
SIGNED_ATOL = 1e-6


@pytest.fixture(scope="module")
def ico():
    v, f = gen.icosphere(0.3, 3)              # 1,280 triangles, 2,048 rows
    jb = JM.build_bvh(JM.build_mesh(v, f))
    tb = TB.from_numpy(np.asarray(jb.node_rows), np.asarray(jb.tri_rows),
                       jb.n_tris, jb.depth, device="cpu")
    return jb, tb


def _pts(n, seed):
    return uniform_pts(n, seed=seed).astype(np.float32)


@pytest.mark.parametrize("cap", ["exact", "default", "small"])
def test_closest_bvh_plain_matches_reference(ico, cap):
    jb, tb = ico
    max_iters = {"exact": None, "default": 48 * jb.depth, "small": 12}[cap]
    pts = _pts(256, seed=len(cap))
    d2_j, idx_j = map(np.asarray, JS._closest_bvh_impl(
        jb, jnp.asarray(pts), max_iters=max_iters))
    d2_t, idx_t, visits, seen = TS.closest_bvh_plain(
        tb, torch.as_tensor(pts), max_iters, with_stats=True)
    assert d2_t.dtype == torch.float32 and idx_t.dtype == torch.int32
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=0, atol=D2_ATOL)
    diff = idx_t.numpy() != idx_j
    own = TS._tri_d2(tb.tri_rows[idx_t.long()], torch.as_tensor(pts))
    np.testing.assert_allclose(own.numpy()[diff], d2_j[diff], rtol=0,
                               atol=D2_ATOL)
    # the seed descent reads depth node rows and one triangle; each
    # iteration after it one row of either kind
    iters = visits[:, 0] - jb.depth + visits[:, 1] - 1
    assert bool((visits[:, 0] >= jb.depth).all())
    assert bool((visits[:, 1] >= 1).all())
    assert int(iters.max()) <= (max_iters or 4 * tb.n_leaves)
    assert int(iters.min()) >= 1
    if cap == "small":
        assert int(iters.max()) == 12            # the cap cut some walks
    # the rows read at least once: the root, a leaf each, at most all
    assert bool(seen[1]) and not bool(seen[0])
    assert int(seen[tb.n_leaves:].sum()) >= 1
    assert int(seen.sum()) <= int(visits.sum())


def test_signed_distance_exact_matches_brute(ico):
    _, tb = ico
    pts = torch.as_tensor(_pts(256, seed=2))
    got = TM.signed_distance(tb, pts)
    want = TM.signed_distance_brute(tb.tri_rows, pts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SIGNED_ATOL)


def test_cube_signed_distance_matches_box_sdf():
    """The reference's cube check (tests/test_mesh.py): the walk's signed
    distance is the analytic box SDF."""
    v, f = cube_mesh(half=0.2)
    bvh = TM.build_bvh(TM.build_mesh(v, f), device="cpu")
    pts = uniform_pts(500, seed=1)
    q = np.abs(pts) - 0.2
    want = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
            + np.minimum(q.max(axis=-1), 0.0))
    got = TM.signed_distance(bvh, torch.as_tensor(pts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_mesh_sdf_bvh_method(ico):
    """method="bvh": the reference's max_iters rule (default 48 * depth,
    0 exact); values agree with the reference's F."""
    jb, tb = ico
    mesh = TM.build_mesh(*gen.icosphere(0.3, 3))
    jmesh = JM.build_mesh(*gen.icosphere(0.3, 3))
    p64 = uniform_pts(256, lo=-0.4, hi=0.4, seed=3)
    brute = TM.signed_distance_brute(tb.tri_rows, torch.as_tensor(p64))
    for max_iters in (None, 0, 10):
        F = TM.mesh_sdf(mesh, tb, max_iters=max_iters, method="bvh",
                        device="cpu")
        assert F.method == "bvh"
        got = F(torch.as_tensor(p64))
        assert got.dtype == torch.float64
        ref = np.asarray(JS.mesh_sdf(jmesh, jb, max_iters=max_iters,
                                     method="bvh")(jnp.asarray(p64)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=SIGNED_ATOL)
        if max_iters == 0:
            np.testing.assert_allclose(got.numpy(), brute.numpy(), rtol=0,
                                       atol=SIGNED_ATOL)
        # a capped walk keeps the seed's upper bound: never nearer
        assert bool((got.abs() >= brute.abs() - SIGNED_ATOL).all())


def test_from_numpy_round_trip(ico):
    jb, tb = ico
    nr, tr, n, depth = TB.to_numpy(tb)
    np.testing.assert_array_equal(nr, np.asarray(jb.node_rows))
    np.testing.assert_array_equal(tr, np.asarray(jb.tri_rows))
    assert (n, depth) == (jb.n_tris, jb.depth) == (1280, 11)
    back = TB.from_numpy(nr, tr, n, depth, device="cpu")
    assert torch.equal(back.tri_rows, tb.tri_rows)
    assert torch.equal(back.node_rows, tb.node_rows)


def test_bvh_launch_refuses_cpu_and_counts_nothing(ico):
    """K11's launch takes CUDA tensors or raises; the plain path on CPU
    tensors adds nothing to the kernel's launch count."""
    _, tb = ico
    before = TS.closest_bvh.launches
    pts = torch.full((4, 3), 0.2, dtype=torch.float32)
    TS.closest_bvh(tb, pts)
    assert TS.closest_bvh.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        TS._bvh_launch(tb, pts)
    with pytest.raises(ValueError, match="f32"):
        TS.closest_bvh(tb, pts.double())
