"""Gradients of the port's reads (hpsdf_tpu_torch on CPU tensors: the plain
versions of kernels G, K2/K5 and K1, which the backward kernels G-bwd, K7
and K8 are held to on the card) against jax.grad on hpsdf_tpu, on the same
numpy inputs: ``values_at``, the raw gradients of
``values_and_gradient_at``, ``row_gather``, ``repack_folded`` and
``query`` at basis degrees 1, 3 and 5 on
``chip_smoke.synthetic_tree`` (points straddling the root), and the trace's
implicit VJP on a fitted sphere, against jax.grad of
``render._trace_core`` and against finite differences of the
Newton-refined hit root (as tests/test_render.py:64-117).

The port's meta lanes (0-7) of the packed rows take no gradient (they are
the tree's topology, and inverse rendering rebuilds them from a constant);
the reference's autodiff also differentiates the leaf frame there, so rows
are compared on their coefficient lanes. Tolerances, relative to the
largest entry of the reference gradient (sums reorder): 1e-5 in f32, 1e-10
in f64, 1e-4 for the trace's VJP.
"""

import dataclasses
import unittest.mock as mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import render as JR
from hpsdf_tpu import tree as JT
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import render as TR
from hpsdf_tpu_torch.query import coeff_scatter_kernel, query_vjp_plain

import chip_smoke

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads, port_config  # noqa: F401
from .util import sphere_sdf

DEGREES = (1, 3, 5)
N_PTS = 600
RTOL32, RTOL64, RTOL_TRACE = 1e-5, 1e-10, 1e-4
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")
C0 = TA.COEFF_LANE


def _close(got, want, rtol):
    """Within rtol of the reference's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.fixture(scope="module", params=DEGREES, ids=lambda d: f"deg{d}")
def trees(request):
    deg = request.param
    cfg = hp.Config(continuity=False, root_min=chip_smoke.SYNTH_ROOT[0],
                    root_max=chip_smoke.SYNTH_ROOT[1])
    jt = JT.pack(*chip_smoke.synthetic_tree(deg, seed=deg), cfg)
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    lo, hi = jt.root_aabb
    pad = 0.1 * (hi - lo)
    rng = np.random.default_rng(200 + deg)
    pts = rng.uniform(lo - pad, hi + pad, (N_PTS, 3))
    return jt, tt, jp, tp, pts, rng


def _torch_tables(tp):
    rows = tp.rows.clone().requires_grad_(True)
    grid = tp.grid.clone().requires_grad_(True)
    return dataclasses.replace(tp, rows=rows, grid=grid), rows, grid


def test_values_at_grad(trees):
    _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    w = rng.standard_normal(N_PTS).astype(np.float32)

    def f(rows, grid, P):
        pk = dataclasses.replace(jp, rows=rows, grid=grid)
        return jnp.sum(jnp.asarray(w) * JA.values_at(pk, P))

    want = jax.grad(f, argnums=(0, 1, 2))(jp.rows, jp.grid, jnp.asarray(p32))
    pk, rows, grid = _torch_tables(tp)
    P = torch.as_tensor(p32).requires_grad_(True)
    (torch.as_tensor(w) * TA.values_at(pk, P)).sum().backward()
    _close(rows.grad[:, C0:], np.asarray(want[0])[:, C0:], RTOL32)
    _close(grid.grad[:, C0:], np.asarray(want[1])[:, C0:], RTOL32)
    assert not rows.grad[:, :C0].any() and not grid.grad[:, :C0].any()
    _close(P.grad, want[2], RTOL32)


def test_point_gradient(trees):
    _, _, jp, tp, pts, rng = trees
    p32 = jnp.asarray(pts.astype(np.float32))
    u = rng.standard_normal((N_PTS, 3)).astype(np.float32)

    def grad_p(rows, grid):
        pk = dataclasses.replace(jp, rows=rows, grid=grid)
        return jax.grad(lambda P: jnp.sum(JA.values_at(pk, P)))(p32)

    want = grad_p(jp.rows, jp.grid)
    want_rows, want_grid = jax.grad(
        lambda r, g: jnp.sum(jnp.asarray(u) * grad_p(r, g)),
        argnums=(0, 1))(jp.rows, jp.grid)
    pk, rows, grid = _torch_tables(tp)
    got = TA.values_and_gradient_at(pk, torch.tensor(np.asarray(p32)),
                                    N_PTS)[1]
    _close(got.detach(), want, RTOL32)
    (torch.as_tensor(u) * got).sum().backward()
    _close(rows.grad[:, C0:], np.asarray(want_rows)[:, C0:], RTOL32)
    _close(grid.grad[:, C0:], np.asarray(want_grid)[:, C0:], RTOL32)


def test_row_gather_grad(trees):
    _, _, jp, tp, _, rng = trees
    n = tp.rows.shape[0]
    idx = rng.integers(-8, n + 8, 4 * n).astype(np.int32)
    cot = rng.standard_normal((idx.size, tp.width)).astype(np.float32)
    ok = jnp.asarray((idx >= 0) & (idx < n))[:, None]
    clip = jnp.asarray(np.clip(idx, 0, n - 1))
    # zeros outside [0, n), negative indices included (G2's rule)
    want = jax.grad(lambda tab: jnp.sum(jnp.asarray(cot) * jnp.where(
        ok, tab[clip], 0.0)))(jp.rows)
    table = tp.rows.clone().requires_grad_(True)
    (torch.as_tensor(cot) * TA.row_gather(table, torch.as_tensor(idx))) \
        .sum().backward()
    _close(table.grad, want, RTOL32)


def test_repack_folded_grad(trees):
    jt, tt, jp, tp, _, rng = trees
    js, ts = JA.pack_support(jt, grid_depth=1), TA.pack_support(tt,
                                                                grid_depth=1)
    folded = (np.asarray(jt.coeffs) * np.asarray(js.fold)).astype(np.float32)
    cr = rng.standard_normal(tp.rows.shape).astype(np.float32)
    cg = rng.standard_normal(tp.grid.shape).astype(np.float32)

    def f(F):
        pk = JA.repack_folded(jp, js, F)
        return jnp.sum(jnp.asarray(cr) * pk.rows) \
            + jnp.sum(jnp.asarray(cg) * pk.grid)

    want = jax.grad(f)(jnp.asarray(folded))
    F = torch.as_tensor(folded).requires_grad_(True)
    pk = TA.repack_folded(tp, ts, F)
    np.testing.assert_array_equal(pk.rows.detach().numpy(),
                                  np.asarray(JA.repack_folded(jp, js,
                                                              folded).rows))
    ((torch.as_tensor(cr) * pk.rows).sum()
     + (torch.as_tensor(cg) * pk.grid).sum()).backward()
    _close(F.grad, want, RTOL32)


@pytest.mark.parametrize("outside_value_max", [True, False])
def test_query_grad(trees, outside_value_max):
    jt, tt, _, _, pts, rng = trees
    w = rng.standard_normal(N_PTS)
    P = jnp.asarray(pts)

    def f(c):
        v = hp.query(dataclasses.replace(jt, coeffs=c), P,
                     outside_value_max=outside_value_max)
        if outside_value_max:       # the sentinel is a constant
            v = jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v)
        return jnp.sum(jnp.asarray(w) * v)

    want = jax.grad(f)(jt.coeffs)
    coeffs = tt.coeffs.clone().requires_grad_(True)
    v = T.query(dataclasses.replace(tt, coeffs=coeffs), torch.as_tensor(pts),
                outside_value_max)
    (torch.as_tensor(w) * v).sum().backward()
    _close(coeffs.grad, want, RTOL64)
    np.testing.assert_array_equal(
        query_vjp_plain(tt, torch.as_tensor(pts), torch.as_tensor(w),
                           outside_value_max).numpy(), coeffs.grad.numpy())


# --------------------------------------------------------------------------
# The trace's implicit VJP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                    max_degree=3)
    jt = hp.build_octree(cfg, sphere_sdf(radius=0.3))
    return jt, carry(jt, cfg)


def _rays():
    o, d = JR.camera_rays((0.1, -0.05, -1.8), (0.0, 0.0, 0.0), width=24,
                          height=24, fov_deg=30.0)
    return np.array(o, np.float32), np.array(d, np.float32)


def test_trace_vjp(sphere):
    jt, tt = sphere
    o, d = _rays()
    dt = np.random.default_rng(9).standard_normal(o.shape[0]) \
        .astype(np.float32)
    tree32 = JR._tree_f32(jt)
    packed = JA.pack_tree(jt)
    static = JR._static_of(tree32, packed, JR.HIT_EPS, 200)

    def f(c):
        t, _, _ = JR._trace_core(static, packed.rows, packed.grid,
                                 tree32.child_idx, tree32.centre,
                                 tree32.depth, c, jnp.asarray(o),
                                 jnp.asarray(d), jnp.float32(5.0))
        return jnp.sum(jnp.asarray(dt) * t)

    want = jax.grad(f)(tree32.coeffs)
    coeffs = tt.coeffs.clone().requires_grad_(True)
    res = T.trace(dataclasses.replace(tt, coeffs=coeffs), o, d, t_max=5.0)
    assert res.hit.any() and not res.hit.all()
    (torch.as_tensor(dt) * res.t).sum().backward()
    _close(coeffs.grad, want, RTOL_TRACE)
    with pytest.raises(RuntimeError, match="origins or directions"):
        T.trace(tt, torch.as_tensor(o).requires_grad_(True), d)


_FACES = [(a, e) for a in range(3) for e in (0, 1)] + [("edge", None)]


@pytest.mark.parametrize("where", _FACES, ids=lambda x: (
    "edge" if x[0] == "edge" else f"axis{x[0]}_{('lo', 'hi')[x[1]]}"))
def test_trace_face_rule(sphere, where, few_torch_threads):  # noqa: F811
    """Rays whose hit p = o + t d lies exactly on a face of the root, or on
    an edge: the clamp's derivative in dfdt is 1/2 on that axis, as
    jax.jvp through jnp.clip gives it. trace_vjp_plain (the CPU route of
    the trace's implicit VJP, which K8's trace form is held to) against
    hpsdf_tpu's _trace_bwd called with the same residuals. o, t and d are
    dyadic, so o + t d is exact in f32; one ray missed."""
    jt, tt = sphere
    rng = np.random.default_rng(23)
    n = 6
    p = np.round(rng.uniform(-0.5, 0.5, (n, 3)) * 1024) / 1024
    axis, end = where
    if axis == "edge":
        p[:, 0], p[:, 2] = 0.5, -0.5
        on = [0, 2]
    else:
        p[:, axis] = (-0.5, 0.5)[end]
        on = [axis]
    d = rng.integers(1, 17, (n, 3)) * rng.choice([-1.0, 1.0], (n, 3)) / 16
    t = np.full(n, 1.5)
    o = (p - t[:, None] * d).astype(np.float32)
    d, t = d.astype(np.float32), t.astype(np.float32)
    hit = np.arange(n) != n - 1
    dt = rng.standard_normal(n).astype(np.float32)
    hits = o + t[:, None] * d
    assert np.all(np.abs(hits[:, on]) == 0.5)
    tree32 = JR._tree_f32(jt)
    static = JR._static_of(tree32, JA.pack_tree(jt), JR.HIT_EPS, 200)
    res = (tree32.child_idx, tree32.centre, tree32.depth, tree32.coeffs,
           *(jnp.asarray(x) for x in (o, d, t, hit)))
    want = JR._trace_bwd(static, res, (jnp.asarray(dt), None, None))[5]
    got = TR.trace_vjp_plain(TR._tree_f32(tt), *(torch.as_tensor(x) for x in
                                                  (o, d, t, hit, dt)))
    assert np.abs(np.asarray(want)).max() > 0
    _close(got, want, RTOL_TRACE)


def test_face_rays(sphere, few_torch_threads):  # noqa: F811
    """chip_smoke.face_rays (the rays of [grad2]'s face check) hit each face
    of the root and an edge exactly in f32, the others inside; off_faces
    (the rays K8's trace form and the kernel it replaced both hold to the
    clamp's slope 1) keeps just the inside ones; and trace_vjp_plain on
    the face rays differs from the same sum with slope 1 on the faces,
    while on the inside rays it does not."""
    _, tt = sphere
    rays, kind = chip_smoke.face_rays(tt, 512, 62)
    o, d, t, hit = rays
    unit = (o + t[:, None] * d).numpy()
    for k, (axes, _) in enumerate(chip_smoke.TRACE_FACE_KINDS):
        assert np.all(np.abs(unit[kind.numpy() == k][:, list(axes)]) == 0.5)
    assert np.all(np.abs(unit[kind.numpy() < 0]) < 0.5)
    assert torch.equal(chip_smoke.off_faces(tt, rays), kind < 0)
    dt = torch.as_tensor(np.random.default_rng(3).standard_normal(512)
                         .astype(np.float32))
    tree32 = TR._tree_f32(tt)
    terms = chip_smoke._dfdt_terms(tt, (o + t[:, None] * d).double(), d)
    assert terms.shape == (512, 3 * tt.coeffs.shape[1])
    for face in (False, True):
        m = (kind >= 0) if face else (kind < 0)
        got = TR.trace_vjp_plain(tree32, *(x[m] for x in rays), dt[m])
        with mock.patch.object(TR, "clip_slope", lambda u: (
                u.abs() <= 0.5).to(u.dtype)):
            old = TR.trace_vjp_plain(tree32, *(x[m] for x in rays), dt[m])
        err = float((got - old).abs().max() / old.abs().max())
        assert (err > 0.1) if face else (err == 0.0)


def test_trace_vjp_matches_fd(sphere):
    """The VJP against finite differences of the exact hit root of
    f(o + t d) = 0, Newton-refined in f64 for each perturbed coefficient
    vector (the marched t is step-quantised)."""
    _, tt = sphere
    o = np.asarray([[0.02, -0.03, -2.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    coeffs = tt.coeffs.clone().requires_grad_(True)
    res = T.trace(dataclasses.replace(tt, coeffs=coeffs), o, d, t_max=5.0)
    assert bool(res.hit[0])
    res.t[0].backward()
    g = coeffs.grad.numpy()
    t_march = float(res.t[0].detach())
    o64, d64 = torch.as_tensor(o, dtype=torch.float64), \
        torch.as_tensor(d, dtype=torch.float64)

    def t_root(c):
        tr = dataclasses.replace(tt, coeffs=torch.as_tensor(c))
        t = torch.tensor(t_march, dtype=torch.float64, requires_grad=True)
        for _ in range(20):
            v = T.query(tr, o64 + t * d64, outside_value_max=False)[0]
            (dv,) = torch.autograd.grad(v, t)
            t = (t - v / dv).detach().requires_grad_(True)
        return float(t.detach())

    base = tt.coeffs.numpy()
    eps = 1e-5
    for k in np.argsort(-np.abs(g).ravel())[:4]:
        ij = np.unravel_index(k, g.shape)
        cp, cm = base.copy(), base.copy()
        cp[ij] += eps
        cm[ij] -= eps
        fd = (t_root(cp) - t_root(cm)) / (2 * eps)
        assert abs(fd - g[ij]) < 1e-2 * max(1.0, abs(fd)), (ij, fd, g[ij])


@pytest.mark.parametrize("kernel", ["packed_grad", "coeff_scatter",
                                    "row_scatter", "row_scatter_csr"])
def test_backward_kernels_refuse_cpu(trees, kernel):
    """The backward kernels' wrappers launch on CUDA tensors or raise; only
    the dispatchers (row_scatter, trace_vjp) take the plain versions, and
    only for CPU tensors."""
    _, tt, _, tp, pts, _ = trees
    p32 = torch.as_tensor(pts[:8].astype(np.float32))
    with pytest.raises(ValueError, match="CUDA|unsupported device"):
        if kernel == "packed_grad":
            TA.packed_grad_kernel(tp, p32, torch.zeros(8), 0)
        elif kernel == "coeff_scatter":
            coeff_scatter_kernel(tt, torch.zeros(8, dtype=torch.float64),
                                 pts=torch.as_tensor(pts[:8]))
        elif kernel == "row_scatter":
            TA.row_scatter(torch.zeros((4, 8), device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"),
                           3)
        else:
            TA.row_scatter(torch.zeros((4, 8), device="meta"),
                           torch.zeros(4, dtype=torch.int32, device="meta"),
                           3, (torch.zeros(4, dtype=torch.int32,
                                           device="meta"),
                               torch.zeros(4, dtype=torch.int32,
                                           device="meta")))
