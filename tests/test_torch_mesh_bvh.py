"""The BVH walk of hpsdf_tpu_torch (kernel K11's plain version, which CPU
tensors take) against hpsdf_tpu's ``_closest_bvh_impl``, and the signed
distances and mesh F built on it, mirroring tests/test_mesh.py.

Tolerances. d2: 1e-7 absolute (the same cascade; XLA contracts a*b+c into
FMAs where torch does not, so a decision of the walk can flip only where
two distances are within an ulp). best_idx: equal, or a triangle that
reaches the same d2 within 1e-7 (triangles sharing the closest vertex or
edge tie). Signed distances: 1e-6 against the brute-force scan, 1e-5
against the analytic box (the reference's own tolerance).

Kernel K11 walks a warp a point: it loads the heap subtree a few levels deep
under the node where the walk stands (a window), computes its distances in
parallel, then replays the sequential walk's decisions from them until the
walk leaves the window. ``window_walk`` runs those steps on the CPU, one
point at a time, with the plain version's arithmetic, and must give
``closest_bvh_plain``'s d2, index and visits bit for bit: the replay is the
plain walk, decision for decision, whatever the window's depth."""

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
from hpsdf_tpu_torch.mesh import tri as TT

from .test_torch_query import few_torch_threads  # noqa: F401
from .util import cube_mesh, uniform_pts

D2_ATOL = 1e-7
SIGNED_ATOL = 1e-6
WINDOW_LEVELS = 5        # csrc/bvh_walk.cu kLevels: internal levels a window


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


# --------------------------------------------------------------------------
# K11's window replay, mirrored on the CPU
# --------------------------------------------------------------------------

def window_walk(bvh, p, max_iters=None, levels=WINDOW_LEVELS):
    """K11's steps for one point p (3,): the greedy seed and then the walk,
    each a window at a time. A window under heap node r (at level L) holds
    ``levels`` levels of internal nodes, and the leaves' level too where it
    comes next (or every level down to the leaves): item j (heap order from
    1) is heap id r 2^k + j - 2^k at k = floor(log2 j). Its distances are
    computed at once (the children's boxes of a node, the triangle of a
    leaf, from ``vertex_rows``) and turned into masks, bit j for item j:
    the nodes whose right child is the nearer, and, against the best, the
    nodes that descend, those that push and the leaves that improve (again
    whenever the best drops). The walk's visits are replayed from the bits,
    until the walk descends below the window or pops to a node outside it,
    and the next window is the one under that node. Returns (d2, index,
    (node rows, triangle rows), rounds)."""
    node_rows, rows = bvh.node_rows, bvh.vertex_rows
    T2, depth = bvh.n_leaves, bvh.depth
    max_iters = 4 * T2 if max_iters is None else max_iters
    p1 = p[None, :]
    rounds = [0]

    def bits(flags):
        return sum(1 << j for j, f in enumerate(flags, start=1) if f)

    def window(r):
        """(L, n, item values (dl, dr) or (d2, 0), right mask)"""
        L = r.bit_length() - 1
        n = min(levels, depth - L) + (depth - L <= levels)
        j = torch.arange(1, 1 << n)
        k = torch.as_tensor([int(x).bit_length() - 1 for x in j.tolist()])
        g = (r << k) + j - (1 << k)
        dl, dr = torch.zeros(j.shape[0]), torch.zeros(j.shape[0])
        inner = g < T2
        nrow = node_rows[g[inner]]
        dl[inner] = TT.aabb_dist2(p1, nrow[:, 0:3], nrow[:, 3:6])
        dr[inner] = TT.aabb_dist2(p1, nrow[:, 6:9], nrow[:, 9:12])
        dl[~inner] = TS._tri_d2(rows[g[~inner] - T2], p1)
        rounds[0] += 1
        items = list(zip(inner.tolist(), dl.tolist(), dr.tolist()))
        right = bits(i and not a <= b for i, a, b in items)
        return L, n, [None] + items, right

    def against(items, best):
        """(descend, push, better) masks"""
        return (bits(i and min(a, b) < best for i, a, b in items[1:]),
                bits(i and max(a, b) < best for i, a, b in items[1:]),
                bits(not i and a < best for i, a, b in items[1:]))

    cur = 1                                   # the seed, a window a round
    while True:
        L, n, items, right = window(cur)
        j = 1
        while cur < T2 and j < (1 << n):
            b = right >> j & 1
            cur, j = 2 * cur + b, 2 * j + b
        if cur >= T2:
            break
    best, idx = items[j][1], cur - T2
    n_nodes, n_leaves = depth, 1

    # the walk; at least one visit, as the plain loop
    max_iters = max(max_iters, 1)
    stack, it, cur, fresh = [], 0, 1, True
    while True:
        if fresh:                             # a new window under cur
            r = cur
            L, n, items, right = window(r)
            desc, push, better = against(items, best)
            j, fresh = 1, False
        while cur < T2:                       # descend while nearer
            n_nodes += 1
            if not desc >> j & 1:
                break
            b = right >> j & 1
            if push >> j & 1:
                stack.append(2 * cur + 1 - b)
            cur, j = 2 * cur + b, 2 * j + b
            it += 1
            if it >= max_iters:
                return best, idx, (n_nodes, n_leaves), rounds[0]
            if j >= 1 << n:                   # below the window
                fresh = True
                break
        if fresh:
            continue
        if cur >= T2:                         # a leaf
            n_leaves += 1
            if better >> j & 1:
                best, idx = items[j][1], cur - T2
                desc, push, better = against(items, best)
        if not stack:
            break
        it += 1
        if it >= max_iters:
            break
        cur = stack.pop()
        k = cur.bit_length() - 1 - L          # still inside the window?
        fresh = not (0 <= k < n and cur >> k == r)
        if not fresh:
            j = (1 << k) + cur - (r << k)
    return best, idx, (n_nodes, n_leaves), rounds[0]


def _window_walks(bvh, pts, max_iters, levels=WINDOW_LEVELS):
    out = [window_walk(bvh, p, max_iters, levels) for p in pts]
    return (torch.tensor([o[0] for o in out], dtype=torch.float32),
            torch.tensor([o[1] for o in out], dtype=torch.int32),
            torch.tensor([o[2] for o in out], dtype=torch.int32),
            torch.tensor([o[3] for o in out]))


@pytest.fixture(scope="module")
def heaps(ico):
    """BVHs of depth 4 (the 12-triangle cube, shallower than a window),
    5 and 7 (icosphere(0.3, 0) and (0.3, 1); 7 is no multiple of the
    window) and 11 (the module's icosphere(0.3, 3))."""
    out = {"cube": TM.build_bvh(TM.build_mesh(*cube_mesh(half=0.2)),
                                device="cpu"),
           "ico3": ico[1]}
    for s in (0, 1):
        out[f"ico{s}"] = TM.build_bvh(TM.build_mesh(*gen.icosphere(0.3, s)),
                                      device="cpu")
    return out


@pytest.mark.parametrize("cap", ["exact", "default", "small", "zero"])
@pytest.mark.parametrize("heap,depth", [("cube", 4), ("ico0", 5),
                                        ("ico1", 7), ("ico3", 11)])
def test_window_replay_matches_plain_walk(heaps, heap, depth, cap):
    """The window replay gives the plain walk's d2, index and visits bit for
    bit at the exact, default (48 x depth) and small caps, and at a cap of 0
    (one visit, as the plain loop makes at least one)."""
    bvh = heaps[heap]
    assert bvh.depth == depth
    max_iters = {"exact": None, "default": 48 * depth, "small": 12,
                 "zero": 0}[cap]
    pts = torch.as_tensor(_pts(128, seed=depth))
    d2_p, idx_p, vis_p, _ = TS.closest_bvh_plain(bvh, pts, max_iters,
                                                 with_stats=True)
    d2_w, idx_w, vis_w, rounds = _window_walks(bvh, pts, max_iters)
    assert torch.equal(d2_w, d2_p)
    assert torch.equal(idx_w, idx_p)
    assert torch.equal(vis_w, vis_p)
    iters = vis_p[:, 0] - depth + vis_p[:, 1] - 1
    if cap == "small":
        assert int(iters.max()) == 12             # the cap cut some walks
    if cap == "zero":
        assert bool((iters == 1).all())
    # a round serves several visits: the seed's windows and the walk's
    assert int(rounds.min()) >= 1
    if depth == 11 and cap == "exact":
        assert 3 * int(rounds.sum()) < int(iters.sum())


@pytest.mark.parametrize("levels", [4, 6])
def test_window_replay_any_depth(heaps, levels):
    """The replay is the plain walk whatever the window's depth: four and
    six levels give the same bits as five."""
    bvh = heaps["ico3"]
    pts = torch.as_tensor(_pts(96, seed=levels))
    want = TS.closest_bvh_plain(bvh, pts, 48 * bvh.depth, with_stats=True)
    got = _window_walks(bvh, pts, 48 * bvh.depth, levels)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)


def test_bvh_limits_have_their_own_messages():
    """K11's wrapper names the limit a BVH breaks: its rows (heap ids in an
    i32) or its depth (a stack entry a lane of the warp)."""
    TS._bvh_check(2 ** 30, 30)
    with pytest.raises(ValueError, match="rows exceed the kernel's 2"):
        TS._bvh_check(2 ** 31, 31)
    with pytest.raises(ValueError, match="depth 32 needs a stack of 33"):
        TS._bvh_check(1024, 32)


def test_chip_smoke_cube_is_the_tests_cube():
    """chip_smoke.py's depth-4 heap for K11 is built from this cube."""
    import chip_smoke
    v, f = chip_smoke.cube_mesh(0.2)
    v2, f2 = cube_mesh(half=0.2)
    np.testing.assert_array_equal(v, v2)
    np.testing.assert_array_equal(f, f2)
    bvh = TM.build_bvh(TM.build_mesh(v, f), device="cpu")
    assert bvh.depth == 4


def test_chip_smoke_bvh_bounds_count_the_plain_walks(ico):
    """K11's bound in chip_smoke.py: two box distances a node row read and
    a cascade a triangle row read, against the bytes of the points, the
    outputs and each row read once."""
    import chip_smoke as cs
    _, tb = ico
    pts = torch.as_tensor(_pts(64, seed=5))
    _, _, vis, seen = TS.closest_bvh_plain(tb, pts, None, with_stats=True)
    bound, kind, ops_ms, bytes_ms = cs.bvh_bounds(tb, pts, vis, seen)
    nodes, leaves = vis.double().sum(dim=0).tolist()
    want_ops = (nodes * 2 * cs.BOX_OPS + leaves * cs.P1_OPS_PER_PAIR) \
        / cs.F32_PEAK * 1e3
    T2 = tb.n_leaves
    want_bytes = (64 * 20 + int(seen[:T2].sum()) * 48
                  + int(seen[T2:].sum()) * 36) / cs.HBM_RATE * 1e3
    assert ops_ms == pytest.approx(want_ops, rel=1e-12)
    assert bytes_ms == pytest.approx(want_bytes, rel=1e-12)
    assert bound == max(ops_ms, bytes_ms)
    assert kind == ("operations" if ops_ms >= bytes_ms else "bytes")
