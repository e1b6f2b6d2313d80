"""The hybrid prune of hpsdf_tpu_torch (kernel K10's plain version, which
CPU tensors take) against hpsdf_tpu's ``_hybrid_closest``, and the signed
distances built on it, mirroring tests/test_mesh_scale.py.

Tolerances. d2: 1e-7 absolute, as P1's tests (both sides run the same
cascade, but XLA contracts a*b+c into FMAs where torch does not). best_idx:
equal, or a triangle that reaches the same d2 within 1e-7 (triangles that
share the closest vertex or edge tie, and the two packages order their
candidates differently). bound: equal to within 2^-21 relative (a few f32
ulps), because XLA contracts the reference's box distances
d_x^2 + d_y^2 + d_z^2 into two FMAs; the port's plain version and its
kernel round them alike, so on the card the two bounds are checked bit for
bit.
Signed distances: 1e-6 against the brute-force scan."""

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
from .util import cube_mesh

D2_ATOL = 1e-7
BOUND_RTOL = 2.0 ** -21
SIGNED_ATOL = 1e-6


def _both(v, f):
    """The reference's BVH and the port's copy of its arrays (CPU)."""
    jb = JM.build_bvh(JM.build_mesh(v, f))
    tb = TB.from_numpy(np.asarray(jb.node_rows), np.asarray(jb.tri_rows),
                       jb.n_tris, jb.depth, device="cpu")
    return jb, tb


@pytest.fixture(scope="module")
def bumpy():
    v, f = gen.bumpy_sphere(0.3, 5)          # 20,480 triangles, NC 128
    return _both(v, f)


def _pts(n, seed, lo=-0.5, hi=0.5):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _assert_idx(tb, pts, idx_t, idx_j, d2_j):
    """Equal indices, or the port's row reaches the reference's d2."""
    rows = tb.tri_rows[torch.as_tensor(idx_t).long()]
    own = TS._tri_d2(rows, torch.as_tensor(pts)).numpy()
    diff = idx_t != idx_j
    np.testing.assert_allclose(own[diff], d2_j[diff], rtol=0, atol=D2_ATOL)


def _against_reference(jb, tb, pts, k1, k2):
    lo, hi = JS.cluster_aabbs(jb)
    d2_j, idx_j, bd_j = map(np.asarray, JS._hybrid_closest(
        lo, hi, jb.node_rows, jb.tri_rows, jnp.asarray(pts), k1, k2))
    tlo, thi = TS.cluster_aabbs(tb)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    d2_t, idx_t, bd_t = TM.hybrid_closest(tlo, thi, tb.node_rows,
                                          tb.tri_rows, torch.as_tensor(pts),
                                          k1, k2)
    assert d2_t.dtype == bd_t.dtype == torch.float32
    assert idx_t.dtype == torch.int32
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=0, atol=D2_ATOL)
    np.testing.assert_allclose(bd_t.numpy(), bd_j, rtol=BOUND_RTOL, atol=0)
    _assert_idx(tb, pts, idx_t.numpy(), idx_j, d2_j)
    return d2_t, idx_t, bd_t


@pytest.mark.parametrize("k", [(48, 48), (8, 8), (3, 40)])
def test_hybrid_plain_matches_reference(bumpy, k):
    jb, tb = bumpy
    pts = _pts(384, seed=sum(k))
    _, _, bd = _against_reference(jb, tb, pts, *k)
    assert bool(torch.isfinite(bd).all())        # NC 128 > k1: bounds finite


@pytest.mark.parametrize("shape", ["tetrahedron", "cube", "ico1"])
def test_hybrid_small_meshes(shape):
    """Under 8 rows the prune has one level (a tetrahedron: 4 rows); under
    256 one cluster, so k1 >= NC keeps everything (the cube: 16 rows, the
    icosphere of 80 triangles: 128 rows)."""
    if shape == "tetrahedron":
        v = np.asarray([(0.2, 0.2, 0.2), (-0.2, -0.2, 0.2),
                        (-0.2, 0.2, -0.2), (0.2, -0.2, -0.2)])
        f = np.asarray([(0, 1, 2), (0, 3, 1), (0, 2, 3), (1, 3, 2)],
                       np.int32)
    elif shape == "cube":
        v, f = cube_mesh(half=0.2)
    else:
        v, f = gen.icosphere(0.3, 1)
    jb, tb = _both(v, f)
    nc, _, sub, two_level, k1, _ = TS._layout(
        TS.cluster_aabbs(tb)[0], tb.node_rows, tb.tri_rows, 48, 48)
    assert (nc, k1) == (1, 1)
    assert two_level == (shape != "tetrahedron")
    pts = _pts(200, seed=5)
    _, _, bd = _against_reference(jb, tb, pts, 48, 48)
    # one cluster kept whole and every subcluster kept: nothing was pruned
    assert bool(torch.isinf(bd).all())
    got = TS.signed_distance_hybrid(tb, torch.as_tensor(pts))
    want = TS.signed_distance_brute(tb.tri_rows, torch.as_tensor(pts))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SIGNED_ATOL)


def test_select_min_is_exact_and_ordered():
    """The plain selection keeps the k smallest (ties to the lower index),
    in ascending index order, and bounds with the (k+1)-th smallest."""
    d2 = torch.tensor([[0.5, 0.1, 0.1, 0.0, 0.7, 0.1],
                       [3.0, 2.0, 1.0, 0.0, 2.0, 2.0]])
    idx, bound = TS._select_min(d2, 3)
    assert idx.tolist() == [[1, 2, 3], [1, 2, 3]]
    assert bound.tolist() == pytest.approx([0.1, 2.0])
    idx, bound = TS._select_min(d2, 6)
    assert idx.tolist() == [list(range(6))] * 2
    assert bool(torch.isinf(bound).all())


def test_signed_distance_hybrid_exact(bumpy):
    """atol = 0: every point whose certificate fails escalates (4x widths,
    then P1), so the result is the exact signed distance."""
    _, tb = bumpy
    pts = torch.as_tensor(_pts(512, seed=0))
    want = TS.signed_distance_brute(tb.tri_rows, pts)
    got, (n_bad, n_worse) = TS.signed_distance_hybrid(
        tb, pts, k1=8, k2=8, with_stats=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SIGNED_ATOL)
    assert 0 < n_bad <= 512 and 0 <= n_worse <= n_bad
    got = TS.signed_distance_hybrid(tb, pts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=SIGNED_ATOL)


def test_hybrid_error_bound_is_sound(bumpy):
    """The guaranteed bound dominates the fixed-K error (weak K)."""
    _, tb = bumpy
    pts = torch.as_tensor(_pts(512, seed=1))
    lo, hi = TS.cluster_aabbs(tb)
    d2, _, bd = TS.hybrid_closest(lo, hi, tb.node_rows, tb.tri_rows, pts,
                                  8, 8)
    bound = TS._dist_err_bound(d2, bd)
    # torch's vectorised CPU sqrt can differ from numpy's in the last bit:
    # an ulp at 1.0 covers the distances here (all below 1)
    np.testing.assert_allclose(
        bound.numpy(), JS._dist_err_bound(d2.numpy(), bd.numpy()), rtol=0,
        atol=2.0 ** -23)
    true_d = TS.signed_distance_brute(tb.tri_rows, pts).abs()
    err = torch.sqrt(d2) - true_d
    assert bool((err >= -1e-6).all())
    assert bool((err <= bound + 1e-6).all())
    assert bool((bound > 0).any())               # the weak prune misses


def test_hybrid_sdf_fn_near_surface(bumpy):
    """The fit-time F (fixed K, no escalation) keeps the caller's dtype,
    stays within its certificate everywhere and near-exact near the
    surface, and agrees with the reference's F."""
    jb, tb = bumpy
    p64 = _pts(384, seed=2, lo=-0.4, hi=0.4).astype(np.float64)
    F = TS.hybrid_sdf_fn(tb)
    assert F.method == "hybrid"
    got = F(torch.as_tensor(p64))
    assert got.dtype == torch.float64
    want = TS.signed_distance_brute(tb.tri_rows, torch.as_tensor(p64))
    err = (got - want).abs().numpy()
    near = np.abs(want.numpy()) < 0.1
    assert near.any() and err[near].max() < 1e-4
    ref = np.asarray(JS.hybrid_sdf_fn(jb)(jnp.asarray(p64, jnp.float32)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SIGNED_ATOL)


def test_mesh_sdf_auto_picks_hybrid_above_threshold(bumpy, monkeypatch):
    """auto takes tiles up to AUTO_TILES_MAX rows and the hybrid prune
    above (the reference's test lowers the threshold; here also a mesh of
    81,920 triangles, 131,072 rows, above the real one)."""
    jb, tb = bumpy
    mesh = TM.build_mesh(*gen.bumpy_sphere(0.3, 5))
    assert TM.mesh_sdf(mesh, tb, device="cpu").method == "tiles"
    pts = torch.as_tensor(_pts(256, seed=3, lo=-0.4, hi=0.4))
    want = TS.signed_distance_brute(tb.tri_rows, pts)
    monkeypatch.setattr(TS, "AUTO_TILES_MAX", 1)
    F = TM.mesh_sdf(mesh, tb, device="cpu")
    assert F.method == "hybrid"
    np.testing.assert_allclose(F(pts).numpy(), want.numpy(), rtol=0,
                               atol=2e-3)
    monkeypatch.undo()

    big = TM.build_mesh(*gen.bumpy_sphere(0.3, 6))
    F = TM.mesh_sdf(big, device="cpu")
    assert F.method == "hybrid"
    bvh = TM.build_bvh(big, device="cpu")
    assert bvh.n_leaves > TS.AUTO_TILES_MAX
    p = torch.as_tensor(_pts(128, seed=4))
    exact = TS.signed_distance_tiles(bvh.tri_rows, p)
    got = TS.signed_distance_hybrid(bvh, p)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0,
                               atol=SIGNED_ATOL)
    near = exact.abs() < 0.1
    np.testing.assert_allclose(F(p)[near].numpy(), exact[near].numpy(),
                               rtol=0, atol=1e-4)


def test_hybrid_launch_refuses_cpu_and_counts_nothing(bumpy):
    """K10's launch takes CUDA tensors or raises; the plain path on CPU
    tensors adds nothing to the kernel's launch count."""
    _, tb = bumpy
    before = TS.hybrid_closest.launches
    lo, hi = TS.cluster_aabbs(tb)
    pts = torch.zeros((4, 3), dtype=torch.float32)
    TS.hybrid_closest(lo, hi, tb.node_rows, tb.tri_rows, pts)
    assert TS.hybrid_closest.launches == before == 0
    with pytest.raises(ValueError, match="unsupported device"):
        TS._hybrid_launch(lo, hi, tb.node_rows, tb.tri_rows, pts)
    with pytest.raises(ValueError, match="f32"):
        TS.hybrid_closest(lo, hi, tb.node_rows, tb.tri_rows, pts.double())
