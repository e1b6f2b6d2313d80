"""The continuity post-process of hpsdf_tpu_torch against hpsdf_tpu's, on
the CPU: the same trees, carried across with ``tree.from_numpy``.

Tolerances. The assembly is a copy of the reference's numpy, so face pairs,
rows and columns are equal and values agree to 1e-15 of the largest. The
plain matvec adds in the COO's order, as XLA's segment_sum on the CPU does:
1e-13 of the largest entry. The solves run the same recurrences in f64, but
XLA fuses the axpys into FMAs and takes its dot products in another order,
so iterates differ at rounding level and CG amplifies that: on fitted trees
the iteration counts are equal and the coefficients agree to 1e-10 of the
largest; on the random coefficients of ``_mixed_depth_tree(8)`` (degree 8,
noise at every mode) the amplification reaches ~1e-7 and the count can move
by one (87 against 86), so that solve is held to 1e-6 and to the jump
reduction that tests/test_continuity.py asks of the reference.
"""

import dataclasses
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import hpsdf_tpu as hp
from hpsdf_tpu import continuity as JC
from hpsdf_tpu import oracle
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import continuity as TC

from .test_continuity import _mixed_depth_tree, two_sphere_sdf
from .test_reference_oracle import sphere_jax
from .test_torch_query import _ARRAYS, few_torch_threads  # noqa: F401
from .test_torch_query import port_config

V_RTOL = 1e-15          # assembled values, relative to the largest
MATVEC_RTOL = 1e-13     # plain matvec against segment_sum
SOLVE_RTOL = 1e-10      # solutions on fitted trees, relative to max|c|
NOISE_RTOL = 1e-6       # the random-coefficient tree's solution
# hpsdf_tpu.oracle.scipy_continuity (tests/test_reference_oracle.py:249-262)
ORACLE_MAX, ORACLE_RMS = 1e-5, 1e-6
# off every mirror plane of the cell grid (tests/test_torch_build.py)
_OFFSET = np.array([0.0131, -0.0217, 0.0093])


def carry(jt, **cfg):
    """The hpsdf_tpu tree ``jt`` as a port tree on the CPU."""
    config = port_config(dataclasses.replace(jt.config, **cfg))
    return T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                        jt.n_nodes, jt.deg_used, jt.depth_used, config,
                        device="cpu")


@pytest.fixture(scope="module")
def two_sphere():
    return hp.build_octree(hp.Config(target_error=1e-8, continuity=False),
                           two_sphere_sdf())


@pytest.fixture(scope="module")
def mixed_depth():
    return _mixed_depth_tree(8)


@pytest.fixture(params=["two_sphere", "mixed_depth"])
def jtree(request):
    return request.getfixturevalue(request.param)


def test_face_pairs_equal(jtree):
    tt = carry(jtree)
    sj, st = JC._LeafView(jtree), TC._LeafView(tt)
    for got, want in zip(TC.leaf_face_pairs(st.child_idx, st.n),
                         JC.leaf_face_pairs(sj.child_idx, sj.n)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(st.coeff_start, sj.coeff_start)
    assert st.n_coeffs == sj.n_coeffs


def test_assembly_equal(jtree):
    _, R, C, V = JC.assemble_face_matrix(jtree)
    _, R2, C2, V2 = TC.assemble_face_matrix(carry(jtree))
    assert R.size > 0
    np.testing.assert_array_equal(R2, R)
    np.testing.assert_array_equal(C2, C)
    assert np.abs(V2 - V).max() <= V_RTOL * np.abs(V).max()


def _system(jt, seed=0):
    st, R, C, V = JC.assemble_face_matrix(jt)
    x = np.random.default_rng(seed).normal(size=st.n_coeffs)
    return st.n_coeffs, R, C, V, x


@pytest.mark.parametrize("layout", ["coo", "csr"])
def test_plain_matvec_matches_segment_sum(mixed_depth, layout):
    n, R, C, V, x = _system(mixed_depth)
    s = 8.0
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(V * x[C]), jnp.asarray(R), num_segments=n)) + s * x
    t = torch.as_tensor
    if layout == "coo":
        y, pap = TC.cg_matvec_plain(t(R), t(C), t(V), s, t(x))
    else:
        y, pap = TC.cg_matvec(TC.csr(t(R), t(C), t(V), n), s, t(x))
    scale = np.abs(want).max()
    assert np.abs(y.numpy() - want).max() <= MATVEC_RTOL * scale
    assert abs(float(pap) - x @ want) <= MATVEC_RTOL * abs(x @ want)


def test_csr_layout(mixed_depth):
    n, R, C, V, _ = _system(mixed_depth)
    A = TC.csr(torch.as_tensor(R), torch.as_tensor(C), torch.as_tensor(V), n)
    order = np.argsort(R, kind="stable")
    np.testing.assert_array_equal(A.cols.numpy(), C[order])
    np.testing.assert_array_equal(A.vals.numpy(), V[order])
    np.testing.assert_array_equal(
        A.rowptr.numpy(), np.searchsorted(R[order], np.arange(n + 1)))
    assert A.rowptr.dtype == A.cols.dtype == torch.int32 and A.n == n


def test_k9_bounds_count_what_it_moves(mixed_depth):
    """chip_smoke.py's bounds for K9: each entry's value and column and the
    row offsets read once, p read once, y written once; an f64 FMA an entry
    and two a row. K9u: five vectors read, three written."""
    n, R, C, V, _ = _system(mixed_depth)
    A = TC.csr(torch.as_tensor(R), torch.as_tensor(C), torch.as_tensor(V), n)
    nnz = R.size
    k9, k9u = chip_smoke.cg_bytes(A)
    ms = 1e3 / chip_smoke.HBM_RATE
    assert k9 == pytest.approx((12 * nnz + 4 * (n + 1) + 16 * n) * ms,
                               rel=1e-12)
    assert k9u == pytest.approx(64 * n * ms, rel=1e-12)
    assert chip_smoke.cg_ops(A) == pytest.approx(
        (2 * nnz + 4 * n) / chip_smoke.F64_PEAK * 1e3, rel=1e-12)


def test_cg_counters_apart():
    """chip_smoke.py reads K9, K9u and the persistent CG launch from three
    counters of their own: a launch of one kernel moves no other's count."""
    c = chip_smoke.counters()
    wrappers = [c[k] for k in ("cg_matvec", "cg_update", "cg_chunk")]
    assert len({(id(fn), attr) for fn, attr in wrappers}) == 3
    assert c["cg_chunk"] == (TC._chunk_launch, "launches")
    chip_smoke.reset_counts()
    assert all(chip_smoke.read_counts()[k] == 0
               for k in ("cg_matvec", "cg_update", "cg_chunk"))


def test_k9u_ops_bound():
    """chip_smoke.py's operation bound for K9u: six f64 FMAs a row, under its
    byte bound (eight vectors of f64) at any n."""
    for n in (1, 40960, 2606040):
        ops = chip_smoke.update_ops(n)
        assert ops == pytest.approx(12 * n / chip_smoke.F64_PEAK * 1e3,
                                    rel=1e-12)
        assert ops < 64 * n / chip_smoke.HBM_RATE * 1e3


def test_plain_update():
    rng = np.random.default_rng(1)
    p, Ap, x, r = rng.normal(size=(4, 1000))
    minv = 1.0 / rng.uniform(1.0, 9.0, 1000)
    t = torch.as_tensor
    got = TC.cg_update(0.3, 2.0, t(p), t(Ap), t(minv), t(x), t(r))
    r1 = r - 0.3 * Ap
    z = minv * r1
    want = (x + 0.3 * p, r1, z + (r1 @ z / 2.0) * p, r1 @ z, r1 @ r1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-14, atol=0)


def _logged_iters(text):
    return [int(m) for m in re.findall(r"\[hpsdf continuity\].* iters=(\d+)",
                                       text)]


@pytest.mark.parametrize("name", ["two_sphere", "sphere"])
def test_enforce_continuity_matches_hpsdf_tpu(name, request, capsys):
    if name == "two_sphere":
        jt = request.getfixturevalue("two_sphere")
    else:
        jt = hp.build_octree(hp.Config(target_error=1e-6, continuity=False,
                                       max_depth=4, max_degree=4),
                             sphere_jax)
    jt = dataclasses.replace(jt, config=dataclasses.replace(
        jt.config, continuity=True, enable_logging=True))
    want = np.asarray(JC.enforce_continuity(jt, cg="f64").coeffs)
    got = TC.enforce_continuity(carry(jt), cg="f64")
    iters = _logged_iters(capsys.readouterr().out)
    assert len(iters) == 2 and iters[0] == iters[1] > 0, iters
    assert got.coeffs.dtype == torch.float64
    assert np.abs(got.coeffs.numpy() - want).max() <= \
        SOLVE_RTOL * np.abs(want).max()


def test_random_coefficient_solve(mixed_depth):
    n, R, C, V, _ = _system(mixed_depth)
    t = torch.as_tensor
    st = JC._LeafView(mixed_depth)
    coeffs = np.asarray(mixed_depth.coeffs)
    leaf = np.flatnonzero(st.degree[: st.n] >= 0)
    c0 = coeffs[np.repeat(leaf, st.widths[leaf]),
                np.concatenate([np.arange(w) for w in st.widths[leaf]])]
    diag = np.full(n, 8.0)
    np.add.at(diag, R[R == C], V[R == C])
    xj, kj, _ = JC._cg_solve(jnp.asarray(R), jnp.asarray(C), jnp.asarray(V),
                             8.0, jnp.asarray(diag), jnp.asarray(8.0 * c0),
                             jnp.asarray(c0), n=n, tol=1e-6,
                             max_iter=2 * n)
    xt, kt, resid = TC._cg_solve_plain(t(R), t(C), t(V), 8.0, t(diag),
                                       t(8.0 * c0), t(c0), n=n, tol=1e-6,
                                       max_iter=2 * n)
    assert abs(kt - int(kj)) <= 1
    assert resid <= 1e-6 * np.linalg.norm(8.0 * c0)
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= NOISE_RTOL * np.abs(xj).max()

    # and the solve reduces the cross-depth face jumps on the x = 0 plane
    tt = carry(mixed_depth)
    smoothed = TC.enforce_continuity(tt)
    yz = np.random.default_rng(3).uniform(-0.49, -0.01, (5000, 2))

    def jumps(tree):
        L = np.stack([np.full(len(yz), -1e-9), yz[:, 0], yz[:, 1]], 1)
        Rp = np.stack([np.full(len(yz), 1e-9), yz[:, 0], yz[:, 1]], 1)
        return (T.query(tree, torch.as_tensor(L))
                - T.query(tree, torch.as_tensor(Rp))).abs().numpy()

    assert jumps(smoothed).mean() < 0.3 * jumps(tt).mean()


def test_matches_scipy_oracle():
    """tests/test_reference_oracle.py:249-262 with the port's solve."""
    cfg = hp.Config(target_error=1e-6, continuity=False,
                    continuity_strength=8.0, max_depth=4, max_degree=4,
                    nearness_weighting=hp.NearnessWeighting.NONE,
                    fit_dtype="float64")
    tree = hp.build_octree(cfg, sphere_jax)
    ours = TC.enforce_continuity(carry(tree))
    orc = oracle.scipy_continuity(tree, 8.0)
    pts = np.random.default_rng(5).uniform(-0.5, 0.5, (100_000, 3))
    qa = T.query(ours, torch.as_tensor(pts)).numpy()
    qb = np.asarray(hp.query(orc, jnp.asarray(pts)))
    d = np.abs(qa - qb)
    assert d.max() <= ORACLE_MAX, d.max()
    assert np.sqrt(np.mean(d ** 2)) <= ORACLE_RMS


def test_build_octree_runs_continuity(capsys):
    """build_octree with continuity=True (tests/test_continuity.py:217-225)
    against hpsdf_tpu's: the same tree, the same iterations, coefficients
    within SOLVE_RTOL, and the field within 0.01 of the sphere."""
    c = _OFFSET * 1.0
    cj, ct = jnp.asarray(c), torch.as_tensor(c)
    kw = dict(target_error=1e-7, continuity=True, continuity_strength=8.0,
              enable_logging=True)
    jt = hp.build_octree(hp.Config(**kw),
                         lambda p: jnp.linalg.norm(p - cj, axis=-1) - 0.3)
    tt = T.build_octree(T.Config(**kw),
                        lambda p: torch.linalg.norm(p - ct, dim=-1) - 0.3,
                        device="cpu")
    out = capsys.readouterr().out
    iters = _logged_iters(out)
    assert len(iters) == 2 and iters[0] == iters[1] > 0, iters
    assert "continuity post-process done" in out
    assert tt.n_nodes == jt.n_nodes
    for k in ("child_idx", "depth", "degree"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)))
    want = np.asarray(jt.coeffs)
    assert np.abs(tt.coeffs.numpy() - want).max() <= \
        SOLVE_RTOL * np.abs(want).max()
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, (100_000, 3))
    got = T.query(tt, torch.as_tensor(pts)).numpy()
    assert np.abs(got - (np.linalg.norm(pts - c, axis=-1) - 0.3)).max() \
        < 0.01


def test_cg_modes_and_mesh(mixed_depth):
    tt = carry(mixed_depth)
    f64 = TC.enforce_continuity(tt, cg="f64").coeffs
    for mode in ("mixed", "auto"):
        assert torch.equal(TC.enforce_continuity(tt, cg=mode).coeffs, f64)
    assert not torch.equal(f64, tt.coeffs)
    with pytest.raises(TypeError, match="DeviceMesh"):
        TC.enforce_continuity(tt, mesh=object())
    with pytest.raises(ValueError, match="cg"):
        TC.enforce_continuity(tt, cg="f32")


# --------------------------------------------------------------------------
# The face operator (K9's input on the solve's path)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform():
    """A fitted tree of one depth: the sphere at depth 4, every leaf at the
    coarse stage's degree."""
    return hp.build_octree(hp.Config(target_error=1e-6, continuity=False,
                                     max_depth=4, max_degree=4), sphere_jax)


@pytest.fixture(scope="module")
def mixed_degree():
    """chip_smoke.mixed_degree_tree: seeded leaf degrees 0-5 and one leaf at
    degree 12, so same-depth faces between unequal degrees, and the widest
    row block."""
    from hpsdf_tpu import tree as JT
    return JT.pack(*chip_smoke.mixed_degree_tree(),
                   hp.Config(target_error=1e-6, continuity=True,
                             continuity_strength=8.0,
                             root_min=chip_smoke.SYNTH_ROOT[0],
                             root_max=chip_smoke.SYNTH_ROOT[1]))


@pytest.fixture(params=["two_sphere", "mixed_depth", "uniform",
                        "mixed_degree"])
def any_tree(request):
    return request.getfixturevalue(request.param)


def _operator(jt, s=8.0):
    tt = carry(jt)
    st = TC._LeafView(tt)
    a, b, d = TC.leaf_face_pairs(st.child_idx, st.n)
    op, diag = TC.face_operator(st, a, b, d, s)
    return st, (a, b, d), op.to("cpu"), diag


def test_face_matvec_matches_coo(any_tree):
    """The plain K9 on the face operator against the port's COO matvec and
    against segment_sum on hpsdf_tpu's COO, at MATVEC_RTOL of max|y|."""
    st, _, op, _ = _operator(any_tree)
    n, R, C, V, x = _system(any_tree)
    s = 8.0
    assert op.n == n and op.nnz == R.size
    t = torch.as_tensor
    got, pap = TC.face_matvec_plain(op, s, t(x))
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(V * x[C]), jnp.asarray(R), num_segments=n)) + s * x
    coo, _ = TC.cg_matvec_plain(t(R), t(C), t(V), s, t(x))
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= MATVEC_RTOL * scale
    assert np.abs(got.numpy() - coo.numpy()).max() <= MATVEC_RTOL * scale
    assert abs(float(pap) - x @ want) <= MATVEC_RTOL * abs(x @ want)
    y2, pap2 = TC.cg_matvec(op, s, t(x))      # CPU tensors: the plain version
    assert torch.equal(y2, got) and torch.equal(pap2, pap)


def test_face_operator_diagonal(any_tree):
    """The Jacobi diagonal from the face lists against the COO's np.add.at
    diagonal, entry by entry at 1e-15."""
    _, _, _, diag = _operator(any_tree)
    n, R, C, V, _ = _system(any_tree)
    want = np.full(n, 8.0)
    on = R == C
    np.add.at(want, R[on], V[on])
    assert np.all(np.abs(diag - want) <= 1e-15 * want)


def test_face_slots_hold_each_pair_once_a_side(any_tree):
    """Every same-depth pair (a, b, d) sits once in a's slot 2d (its
    neighbour on the + side) and once in b's slot 2d + 1, and nothing
    else fills a slot; cross-depth pairs fill none."""
    st, (a, b, d), op, _ = _operator(any_tree)
    leaf_ids = np.flatnonzero(st.degree[: st.n] >= 0)
    pos = {int(v): i for i, v in enumerate(leaf_ids)}
    slots = op.slots.numpy()
    want = np.full(slots.shape, -1, np.int32)
    same = st.depth[a] == st.depth[b]
    assert same.any()
    for ai, bi, di in zip(a[same], b[same], d[same]):
        for own, nbr, side in ((ai, bi, 0), (bi, ai, 1)):
            assert want[pos[int(own)], 2 * di + side, 0] == -1
            want[pos[int(own)], 2 * di + side] = (st.coeff_start[nbr],
                                                  st.degree[nbr])
    np.testing.assert_array_equal(slots, want)
    leaves = op.leaves.numpy()
    np.testing.assert_array_equal(leaves[:, 0], st.coeff_start[leaf_ids])
    np.testing.assert_array_equal(leaves[:, 1] - leaves[:, 0],
                                  st.widths[leaf_ids])
    np.testing.assert_array_equal(leaves[:, 2] & 255, st.degree[leaf_ids])
    np.testing.assert_array_equal(leaves[:, 2] >> 8, st.depth[leaf_ids])
    assert (leaves[:, 3] >= 0).any() == (~same).any()


def test_face_operator_mixed_degrees(mixed_degree):
    """The fixture holds a same-depth face between unequal degrees and a
    degree-12 leaf with same-depth faces; the operator's rectangular modes
    and 455-row block match the COO there."""
    st, (a, b, d), op, _ = _operator(mixed_degree)
    same = st.depth[a] == st.depth[b]
    assert (st.degree[a][same] != st.degree[b][same]).any()
    twelve = (st.degree[a] == 12) | (st.degree[b] == 12)
    assert (same & twelve).any()
    assert op.group == 32 and int((op.leaves[:, 1] - op.leaves[:, 0]).max()) \
        == 455
    n, R, C, V, x = _system(mixed_degree, seed=4)
    got, _ = TC.face_matvec_plain(op, 0.0, torch.as_tensor(x))
    want = np.zeros(n)
    np.add.at(want, R, V * x[C])
    assert np.abs(got.numpy() - want).max() <= \
        MATVEC_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", ["mixed_depth", "uniform"])
def test_logged_nnz_matches_hpsdf_tpu(name, request, capsys):
    """enforce_continuity assembles no same-depth entry, yet logs the nnz of
    the reference's COO (the patterns' sizes plus the numeric entries) and
    its n."""
    jt = request.getfixturevalue(name)
    jt = dataclasses.replace(jt, config=dataclasses.replace(
        jt.config, continuity=True, enable_logging=True))
    JC.enforce_continuity(jt, cg="f64")
    TC.enforce_continuity(carry(jt), cg="f64")
    logged = re.findall(r"\[hpsdf continuity\] (n=\d+ nnz=\d+)",
                        capsys.readouterr().out)
    assert len(logged) == 2 and logged[0] == logged[1], logged


def test_face_bounds_count_what_it_moves(mixed_depth):
    """chip_smoke.py's bounds for K9 on the face operator: its five arrays
    read once, p read once and y written once; the persistent iteration adds
    x, r and 1/diag read and x, r and p written. Operations: per same-depth
    face 2C FMAs and the neighbour's terms on the leaf's modes, an FMA a
    cross-depth entry, two a row; six a row more an iteration."""
    _, _, op, _ = _operator(mixed_depth)
    k9, it = chip_smoke.face_bytes(op)
    arrays = sum(t.numel() * t.element_size() for t in
                 (op.leaves, op.slots, op.xrowptr, op.xcols, op.xvals))
    ms = 1e3 / chip_smoke.HBM_RATE
    assert k9 == pytest.approx((arrays + 16 * op.n) * ms, rel=1e-12)
    assert it == pytest.approx((arrays + 56 * op.n) * ms, rel=1e-12)
    # every leaf of this tree has degree 8 (C = 165): a same-depth face
    # costs 2 * 165 + sum over t <= 8 of (t + 1)(9 - t)
    faces = int((op.slots[:, :, 0] >= 0).sum())
    per_face = 2 * 165 + sum((t + 1) * (9 - t) for t in range(9))
    fmas = faces * per_face + op.xvals.shape[0] + 2 * op.n
    k9_ops, it_ops = chip_smoke.face_ops(op)
    assert k9_ops == pytest.approx(2 * fmas / chip_smoke.F64_PEAK * 1e3,
                                   rel=1e-12)
    assert it_ops == pytest.approx(
        2 * (fmas + 6 * op.n) / chip_smoke.F64_PEAK * 1e3, rel=1e-12)
