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


# --------------------------------------------------------------------------
# The invariants kernel K10 (csrc/hybrid.cu) relies on for an exact
# selection, and a mirror of its selection held to the plain version's.
# --------------------------------------------------------------------------

NONE = (1 << 64) - 1                 # above every key
ROUND = 64                           # rows between cascade stops: 32 lanes
                                     # x kRounds (csrc/hybrid.cu)


@pytest.fixture(scope="module")
def bumpy6():
    """bumpy_sphere(0.3, 6): 81,920 triangles, 131,072 rows, NC 512, so
    the kernel's chunks are 16 heap subtrees of 32 clusters."""
    return TM.build_bvh(TM.build_mesh(*gen.bumpy_sphere(0.3, 6)),
                        device="cpu")


def _node_boxes(node_rows, nodes):
    """The boxes of heap nodes (>= 2), as their parents' rows hold them."""
    r = node_rows[nodes // 2]
    off = (6 * (nodes % 2))[:, None] + torch.arange(6)
    box = r.gather(1, off)
    return box[:, :3], box[:, 3:]


def _child_boxes(node_rows, nodes):
    r = node_rows[nodes]
    return (r[:, 0:3], r[:, 3:6]), (r[:, 6:9], r[:, 9:12])


@pytest.mark.parametrize("build", ["reference", "port"])
def test_heap_boxes_contain_children(bumpy, build):
    """Every heap node's box (in its parent's row) contains both children's
    boxes (in its own row) bit for bit, so it contains every descendant's,
    cluster_aabbs' boxes among them: the kernel's chunk and cluster
    distances are lower bounds of their descendants'."""
    if build == "reference":
        _, tb = bumpy
    else:
        tb = TM.build_bvh(TM.build_mesh(*gen.bumpy_sphere(0.3, 5)),
                          device="cpu")
    T2 = tb.n_leaves
    nodes = torch.arange(2, T2)
    lo, hi = _node_boxes(tb.node_rows, nodes)
    for clo, chi in _child_boxes(tb.node_rows, nodes):
        assert bool((lo <= clo).all()) and bool((hi >= chi).all())
    clo, chi = TS.cluster_aabbs(tb)
    nc = clo.shape[0]
    lo, hi = _node_boxes(tb.node_rows, nc + torch.arange(nc))
    assert bool((lo <= clo).all()) and bool((hi >= chi).all())


def test_box_distance_monotone_under_containment(bumpy):
    """aabb_dist2 in f32 never falls below a containing box's, on random
    points, points inside boxes and points on their faces: a child's
    distance >= its parent's, a cluster's >= its chunk's, a subcluster's
    >= its cluster's."""
    _, tb = bumpy
    T2 = tb.n_leaves
    rng = np.random.default_rng(7)
    nodes = torch.arange(2, T2)
    lo, hi = _node_boxes(tb.node_rows, nodes)
    real = (hi < 1e29).all(dim=1)
    pick = torch.as_tensor(rng.choice(int(real.sum()), 64, replace=False))
    inner = lo[real][pick] + (hi[real][pick] - lo[real][pick]) * 0.25
    pts = torch.cat([torch.as_tensor(_pts(96, seed=8)), inner,
                     lo[real][pick]])                  # (224, 3)
    d_parent = TS._axes_dist2(pts, lo, hi)             # (224, T2 - 2)
    for clo, chi in _child_boxes(tb.node_rows, nodes):
        assert bool((TS._axes_dist2(pts, clo, chi) >= d_parent).all())
    assert bool((d_parent == 0).any())
    # clusters against their chunk (the kernel's chunk j: node NCH + j)
    clo, chi = TS.cluster_aabbs(tb)
    nc = clo.shape[0]
    nch = nc // 32
    alo, ahi = _node_boxes(tb.node_rows,
                           nch + torch.arange(nc) // (nc // nch))
    assert bool((TS._axes_dist2(pts, clo, chi)
                 >= TS._axes_dist2(pts, alo, ahi)).all())


def _key(d, idx):
    return (int(np.float32(d).view(np.uint32)) << 32) | int(idx)


class _List:
    """The kernel's candidate list (csrc/hybrid.cu ``List``) of ``cap`` keys:
    a key joins only below the threshold, a compaction keeps the k + 1
    smallest."""

    def __init__(self, k, cap):
        self.k, self.cap = k, cap
        self.a, self.thr, self.compactions = [], NONE, 0

    def push(self, keys):
        assert len(keys) <= 32
        self.a += [x for x in keys if x < self.thr]
        assert len(self.a) <= self.cap
        if len(self.a) > self.cap - 32 or (self.thr == NONE
                                           and len(self.a) > self.k):
            self.a = sorted(self.a)[:self.k + 1]
            self.thr = self.a[self.k]
            self.compactions += 1

    def finish(self):
        self.a = sorted(self.a)
        bound = (np.uint32(self.a[self.k] >> 32).view(np.float32)
                 if len(self.a) > self.k else np.float32(np.inf))
        self.a = self.a[:self.k]
        return bound


def _kernel_select(tb, p, k1, k2, shortest=False):
    """K10 for one point, step for step as csrc/hybrid.cu runs it, with the
    lists the launch's shape gives (``shortest``: min(k + 33, n + 32) keys,
    what the shape falls back to where one warp's lists do not fit): the
    chunks nearest first until one lies above the threshold, the clusters
    into a list, then the kept clusters' subclusters in ascending key order
    until a cluster lies above the second threshold; then the kept blocks'
    rows nearest box first, ROUND at a time, until a box lies beyond the
    best row by more than the reach. Returns (the kept (sub)cluster ids
    ascending, bound, chunks visited, NCH, best_d2, best row, rows
    scanned)."""
    lo, hi = TS.cluster_aabbs(tb)
    nc, first, _, two_level, k1, k2 = TS._layout(lo, tb.node_rows,
                                                 tb.tri_rows, k1, k2)
    assert first == nc
    nch, _, cap1, cap2, _ = TS._hybrid_shape(nc, k1, k2, two_level)
    assert nch == (min(nc // 32, 256) if nc >= 64 else 1)
    if shortest:
        cap1, cap2 = min(k1 + 33, nc + 32), min(k2 + 33, 8 * k1 + 32)
    g = nc // nch
    if nch > 1:
        alo, ahi = _node_boxes(tb.node_rows, nch + torch.arange(nch))
        chunk = TS._axes_dist2(p[None], alo, ahi)[0].numpy()
    else:
        chunk = np.zeros(1, np.float32)
    d_clu = TS._axes_dist2(p[None], lo, hi)[0].numpy()
    L1 = _List(k1, cap1)
    visited = 0
    for j in sorted(range(nch), key=lambda j: _key(chunk[j], j)):
        if _key(chunk[j], 0) >> 32 > L1.thr >> 32:
            break
        visited += 1
        for c0 in range(j * g, (j + 1) * g, 32):
            L1.push([_key(d_clu[c], c) for c in range(c0, min(c0 + 32,
                                                              (j + 1) * g))])
    bound = L1.finish()
    kept = L1.a
    if two_level:
        L2 = _List(k2, cap2)
        for t in range(0, len(kept), 4):
            if kept[t] >> 32 > L2.thr >> 32:
                break
            keys = []
            for key in kept[t:t + 4]:
                c = key & 0xffffffff
                rows = tb.node_rows[4 * (first + c) + torch.arange(4)]
                blo = torch.stack([rows[:, 0:3], rows[:, 6:9]], 1)
                bhi = torch.stack([rows[:, 3:6], rows[:, 9:12]], 1)
                d = TS._axes_dist2(p[None], blo.reshape(8, 3),
                                   bhi.reshape(8, 3))[0].numpy()
                keys += [_key(d[s], 8 * c + s) for s in range(8)]
            L2.push(keys)
        bound = min(bound, L2.finish())
        kept = L2.a
    sub = TS._layout(lo, tb.node_rows, tb.tri_rows, k1, k2)[2]
    rows = torch.as_tensor([(key & 0xffffffff) * sub + r for key in kept
                            for r in range(sub)])
    box = np.asarray([key >> 32 for key in kept], np.uint32).view(np.float32)
    reach = np.float32(TS.HYBRID_REACH * (1.0 + float(p.abs().sum())))
    best, best_row, q0 = np.float32(np.inf), -1, 0
    for q0 in range(0, rows.numel(), ROUND):
        r = np.sqrt(best) + reach
        if box[q0 // sub] > r * r:
            break
        d2 = TS._tri_d2(tb.tri_rows[rows[q0:q0 + ROUND]], p[None]).numpy()
        m = d2.min()
        row = int(rows[q0:q0 + ROUND][torch.as_tensor(d2 == m)].min())
        if m < best or (m == best and row < best_row):  # ties: lowest row
            best, best_row = m, row
    else:
        q0 = rows.numel()
    return (sorted(k & 0xffffffff for k in kept), bound, visited, nch, best,
            best_row, q0)


def _selection_points(points, n=48):
    if points == "uniform":
        return torch.as_tensor(_pts(n, seed=11))
    m = TM.build_mesh(*gen.bumpy_sphere(0.3, 6))
    rng = np.random.default_rng(12)
    t = rng.integers(0, m.n_faces, n)
    w = rng.dirichlet(np.ones(3), n)
    on = (w[:, :, None] * m.vertices[m.faces[t]]).sum(axis=1)
    return torch.as_tensor((on + rng.uniform(-1e-3, 1e-3, (n, 1))
                            * m.face_normals[t]).astype(np.float32))


def _selection_against_plain(tb, p, k, points, shortest=False):
    lo, hi = TS.cluster_aabbs(tb)
    d2, idx, bd, blocks, sub = TS.hybrid_closest_plain(
        lo, hi, tb.node_rows, tb.tri_rows, p, *k, with_blocks=True)
    visited, scanned = [], []
    for n in range(p.shape[0]):
        kept, bound, v, nch, best, row, q = _kernel_select(
            tb, p[n], *k, shortest=shortest)
        assert kept == blocks[n].tolist()
        assert np.float32(bound).view(np.uint32) \
            == bd[n].numpy().view(np.uint32)
        assert best.view(np.uint32) == d2[n].numpy().view(np.uint32)
        assert row == int(idx[n])
        visited.append(v)
        scanned.append(q)
    if k[0] < 64:                      # the chunk prune skipped chunks
        assert min(visited) < nch
    if points == "near":               # and the cascade rows
        assert min(scanned) < blocks.shape[1] * sub
    if points == "near" and k == (2, 3):
        assert bool((bd == 0).any())   # more than k boxes at distance 0


@pytest.mark.parametrize("points", ["uniform", "near"])
@pytest.mark.parametrize("k", [(48, 48), (2, 3), (8, 8), (192, 192),
                               (512, 4096)])
def test_kernel_selection_matches_plain(bumpy6, k, points):
    """The kernel's selection (the chunk prune, the thresholded lists, the
    subclusters nearest cluster first) keeps the plain version's sets and
    gives its bound bit for bit: at the default and escalation widths, at
    k >= n (all kept, bound +inf) and on points near the surface, which lie
    inside several boxes at distance 0 (ties broken by index)."""
    _selection_against_plain(bumpy6, _selection_points(points), k, points)


@pytest.mark.parametrize("points", ["uniform", "near"])
@pytest.mark.parametrize("k", [(2, 3), (48, 48), (192, 192)])
def test_kernel_selection_with_the_shortest_lists(bumpy6, k, points):
    """The same with the shortest lists the launch's shape may give, k + 33
    keys (a compaction every 32 keys that join), as at widths whose lists
    outgrow one warp's room at their full length."""
    _selection_against_plain(bumpy6, _selection_points(points, 24), k, points,
                             shortest=True)


def _warp_sort(a):
    """csrc/hybrid.cu ``warp_sort``: the bitonic network over the next power
    of two, every merge ascending with a mirrored first step, comparators
    reaching past n skipped (their entry would be +inf)."""
    a, n = list(a), len(a)
    size_all = 32
    while size_all < n:
        size_all <<= 1
    size = 2
    while size <= size_all:
        stride = size >> 1
        while stride > 0:
            for p in range(size_all >> 1):
                i = ((p & ~(stride - 1)) << 1) | (p & (stride - 1))
                j = i ^ (size - 1) if stride == size >> 1 else i + stride
                assert i < j
                if j < n and a[i] > a[j]:
                    a[i], a[j] = a[j], a[i]
            stride >>= 1
        size <<= 1
    return a


def test_warp_sort_sorts_any_length():
    """The compaction's sort touches only the list's n keys and sorts them,
    whatever n: lists need not be a power of two long."""
    rng = np.random.default_rng(17)
    for n in [0, 1, 2, 31, 32, 33, 66, 97, 128, 161, 300, 545]:
        keys = rng.choice(1 << 40, n, replace=False).tolist()
        assert _warp_sort(keys) == sorted(keys)
    ties = [_key(0.0, i) for i in rng.permutation(70)]   # distance-0 keys
    assert _warp_sort(ties) == sorted(ties)


def test_hybrid_shape_fits_every_width_that_fit_before():
    """Every (NC, k1, k2) the one-block-a-point kernel took (4 (NC + 9 k1 +
    k2) bytes of shared memory within MAX_SMEM - 2048; 4 (NC + k1) with one
    level) gets a launch shape within MAX_SMEM whose lists compact (cap - 32
    >= k + 1, or >= every key the list is offered); the default and
    escalation widths at NC 8,192 keep 8 warps a block."""
    limit = (TS.MAX_SMEM - 2048) // 4
    for nc in [1 << e for e in range(16)]:
        for two in (False, True):
            k1 = np.arange(1, nc + 1)
            k2 = np.minimum(8 * k1, limit - nc - 9 * k1) if two else 0 * k1
            ok = k2 >= 1 if two else nc + k1 <= limit
            for a, b in zip(k1[ok].tolist(), k2[ok].tolist()):
                nch, w, c1, c2, smem = TS._hybrid_shape(nc, a, b, two)
                assert 1 <= w <= TS.HYBRID_WARPS and smem <= TS.MAX_SMEM
                assert smem == 8 * w * (c1 + c2) + 4 * w * nch + 24 * nch
                assert c1 - 32 >= min(a + 1, nc)
                assert not two or c2 - 32 >= min(b + 1, 8 * a)
    for k in (48, 192):
        assert TS._hybrid_shape(8192, k, k, True)[1] == TS.HYBRID_WARPS
    with pytest.raises(ValueError, match="shared memory"):
        TS._hybrid_shape(8192, 8192, 65536, True)


def test_plain_selection_tie_heavy(bumpy6):
    """Mesh vertices where clusters meet lie inside more than k1 cluster
    boxes: the k1-th smallest key is 0, the plain version keeps the
    lowest-index clusters at distance 0 and bounds with 0."""
    tb = bumpy6
    lo, hi = TS.cluster_aabbs(tb)
    p = tb.tri_rows[:tb.n_tris:7, 0:3]                 # triangles' vertex a
    d = TS._axes_dist2(p, lo, hi)
    zeros = (d == 0).sum(dim=1)
    k1 = 2
    heavy = zeros > k1
    assert bool(heavy.any())
    cidx, bound = TS._select_min(d, k1)
    assert bool((bound[heavy] == 0).all())
    for n in torch.nonzero(heavy).flatten().tolist():
        want = torch.nonzero(d[n] == 0).flatten()[:k1]
        assert cidx[n].tolist() == want.tolist()


def test_rows_within_reach_of_their_boxes(bumpy6):
    """The cascade's stop: every triangle lies in its subcluster's box (bit
    for bit), and no row's plain squared distance falls below its box's by
    more than the reach allows, at random points and points on and near
    the surface."""
    tb = bumpy6
    lo, hi = TS.cluster_aabbs(tb)
    nc, first, sub, _, _, _ = TS._layout(lo, tb.node_rows, tb.tri_rows, 48,
                                         48)
    T2 = tb.n_leaves
    n_sub = T2 // sub
    rng = np.random.default_rng(13)
    pick = torch.as_tensor(rng.choice(tb.n_tris // sub, 256, replace=False))
    nodes = 8 * first + pick                   # the subclusters' heap nodes
    blo, bhi = _node_boxes(tb.node_rows, nodes)
    assert n_sub == 8 * nc
    rows = pick[:, None] * sub + torch.arange(sub)
    v = tb.tri_rows[rows, :9].reshape(256, sub, 3, 3)
    assert bool((v >= blo[:, None, None]).all())
    assert bool((v <= bhi[:, None, None]).all())
    on = v[:, :4].mean(dim=2).reshape(-1, 3)   # centroids: on the surface
    pts = torch.cat([torch.as_tensor(_pts(64, seed=14)), on,
                     on + torch.as_tensor(_pts(on.shape[0], 15, -1e-3,
                                               1e-3))])
    d_box = TS._axes_dist2(pts, blo, bhi)                       # (P, 256)
    d_tri = TS._tri_d2(tb.tri_rows[rows.reshape(-1)][None],
                       pts[:, None]).reshape(pts.shape[0], 256, sub)
    reach = TS.HYBRID_REACH * (1 + pts.abs().sum(dim=1))
    low = torch.clamp(torch.sqrt(d_box) - reach[:, None], min=0) ** 2
    assert bool((d_tri.min(dim=2).values >= low).all())


def test_hybrid_bounds_count_the_kernels_work():
    """chip_smoke.hybrid_bounds prices K10's own per-point counts (the NCH
    chunk boxes, the clusters and subclusters it took, the rows it
    scanned) and, without them, every box and row of the plain version."""
    import chip_smoke as cs
    B, nc, k1, sub = 10, 8192, 48, 32
    lo = torch.zeros((nc, 3))
    pts = torch.zeros((B, 3))
    blocks = torch.arange(B * 48).reshape(B, 48)
    stats = torch.tensor([[3, 96, 40, 100]] * B, dtype=torch.int32)
    own = cs.hybrid_bounds(lo, pts, blocks, sub, k1, stats)
    ops = (B * 256 + B * 96 + B * 40) * cs.BOX_OPS \
        + B * 100 * cs.P1_OPS_PER_PAIR
    assert own[2] == pytest.approx(ops / cs.F32_PEAK * 1e3)
    full = cs.hybrid_bounds(lo, pts, blocks, sub, k1)
    ops = B * ((nc + 8 * k1) * cs.BOX_OPS + 48 * sub * cs.P1_OPS_PER_PAIR)
    assert full[2] == pytest.approx(ops / cs.F32_PEAK * 1e3)
    nbytes = B * 24 + nc * 24 + B * 48 * sub * 36
    assert own[3] == full[3] == pytest.approx(nbytes / cs.HBM_RATE * 1e3)
    assert own[0] == max(own[2], own[3])
    assert own[1] == full[1] == "bytes"     # 10 points: the cluster boxes


def test_vertex_rows_give_the_packed_rows_results(bumpy):
    """The BVH's vertex_rows, which the main path hands K10 as its rows, are
    the packed rows' lanes 0..11 in contiguous 48-byte rows, made once, and
    the prune gives the same results on them as on the packed rows."""
    _, tb = bumpy
    verts = tb.vertex_rows
    assert verts is tb.vertex_rows
    assert verts.shape == (tb.n_leaves, 12) and verts.is_contiguous()
    assert torch.equal(verts, tb.tri_rows[:, :12])
    lo, hi = TS.cluster_aabbs(tb)
    p = torch.as_tensor(_pts(256, seed=16))
    for a, b in zip(TS.hybrid_closest(lo, hi, tb.node_rows, verts, p),
                    TS.hybrid_closest(lo, hi, tb.node_rows, tb.tri_rows, p)):
        assert torch.equal(a, b)
