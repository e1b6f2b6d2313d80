"""The derivatives of the port's reads that the backward kernels K1v, K1h,
K8g, K5h and K7's form 2 compute on the card, held on CPU tensors (where
autograd differentiates the plain versions those kernels are held to)
against jax.grad / jax.vjp of hpsdf_tpu on the same numpy inputs:

  * ``query`` with respect to the points (K1v), both ``outside_value_max``;
  * ``query_with_gradient`` with respect to the coefficients (K8g) and the
    points (K1h);
  * ``query_packed`` with respect to the tables and the points;
  * ``normals`` with respect to the tables (K7's form 2) and the points
    (K5h's normals mode);
  * ``values_and_gradient_at`` with respect to the points (K5h's second
    mode), the reference's eikonal term, jax.grad of ``values_at``
    differentiated once more;

at basis degrees 0, 1, 3, 5 and 12 on ``chip_smoke.synthetic_tree``, at
points straddling the root, points on its faces, edges and corners, and
the ``query_grid`` endpoints. Tolerances, of the reference's largest entry
(sums reorder): 1e-10 in f64, 1e-5 in f32, 1e-4 for the f32 Hessian
products.

At a point on a face of the root the clamp's derivative is 1/2, as
``jnp.clip``'s (its maximum and minimum split the tie): ``test_face_rule``.
Where the gradient is exactly zero (every point of a degree-0 tree),
hpsdf_tpu's autodiff of the unit gradient is NaN (sqrt's derivative at 0
times a zero cotangent); the port gives the limit below the floor, wn /
floor, which a degree-0 basis multiplies by zero derivatives. The tie at
the floor itself splits as ``jnp.maximum`` does (``test_unit_vector_tie``).

Then the three paths of ``chip_smoke.py``'s ``[grad2]`` at a small size,
two steps each, each step's loss and gradients against hpsdf_tpu's at the
same parameters.
"""

import dataclasses
import importlib

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
from hpsdf_tpu_torch import basis as TB
from hpsdf_tpu_torch import render as TR
from hpsdf_tpu_torch.mesh import build_mesh, gen

import chip_smoke

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads, port_config  # noqa: F401
from .util import sphere_sdf

DEGREES = (0, 1, 3, 5, 12)
N_PTS = 300
RTOL64, RTOL32, RTOL_HVP = 1e-10, 1e-5, 1e-4
# the module, which the package's ``query`` function shadows
TQ = importlib.import_module("hpsdf_tpu_torch.query")
C0 = TA.COEFF_LANE
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


def _close(got, want, rtol):
    """Within rtol of the reference's largest entry; a gradient autograd
    left as None (no path from the input) is zero."""
    want = np.asarray(want, np.float64)
    got = np.zeros_like(want) if got is None else np.asarray(
        got.detach() if torch.is_tensor(got) else got, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _lo_hi():
    return (np.asarray(chip_smoke.SYNTH_ROOT[0], np.float64),
            np.asarray(chip_smoke.SYNTH_ROOT[1], np.float64))


def _face_points(rng, n_face=4):
    """Points on each of the root's six faces, on edges and on corners."""
    lo, hi = _lo_hi()
    out = []
    for axis in range(3):
        for end in (lo, hi):
            p = rng.uniform(lo, hi, (n_face, 3))
            p[:, axis] = end[axis]
            out.append(p)
    p = rng.uniform(lo, hi, (4, 3))
    p[:, 0], p[:, 1] = lo[0], hi[1]                    # an edge
    out += [p, np.asarray([lo, hi])]                   # two corners
    return np.concatenate(out)


def _grid_points(res=4):
    """``query_grid``'s points: linspace over the root, both ends in."""
    lo, hi = _lo_hi()
    axes = [np.linspace(lo[a], hi[a], res) for a in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def _synthetic(deg, seed):
    cfg = hp.Config(continuity=False, root_min=chip_smoke.SYNTH_ROOT[0],
                    root_max=chip_smoke.SYNTH_ROOT[1])
    jt = JT.pack(*chip_smoke.synthetic_tree(deg, seed=seed), cfg)
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    return jt, tt


@pytest.fixture(scope="module", params=DEGREES, ids=lambda d: f"deg{d}")
def trees(request):
    deg = request.param
    jt, tt = _synthetic(deg, seed=deg)
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    lo, hi = _lo_hi()
    pad = 0.1 * (hi - lo)
    rng = np.random.default_rng(300 + deg)
    pts = np.concatenate([rng.uniform(lo - pad, hi + pad, (N_PTS, 3)),
                          _face_points(rng), _grid_points()])
    return deg, jt, tt, jp, tp, pts, rng


def _same_as_autograd(loss, pts, want, tol=0.0):
    """The entry point's autograd (loss(P).backward()) gives the plain VJP
    ``want`` at the points, within ``tol`` of its largest entry. Where the
    output does not depend on the points (degree 0), there is no graph and
    ``want`` is zero."""
    P = torch.as_tensor(pts).requires_grad_(True)
    out = loss(P)
    if not out.requires_grad:
        assert not want.any()
        return
    out.backward()
    _close(P.grad, want.numpy(), tol) if tol else \
        np.testing.assert_array_equal(P.grad.numpy(), want.numpy())


def _tables(tp):
    rows = tp.rows.clone().requires_grad_(True)
    grid = tp.grid.clone().requires_grad_(True)
    return dataclasses.replace(tp, rows=rows, grid=grid), rows, grid


@pytest.mark.parametrize("outside_value_max", [True, False])
def test_query_points_vjp(trees, outside_value_max, few_torch_threads):  # noqa: F811
    _, jt, tt, _, _, pts, rng = trees
    w = rng.standard_normal(pts.shape[0])

    def f(P):
        v = hp.query(jt, P, outside_value_max=outside_value_max)
        if outside_value_max:       # the sentinel is a constant
            v = jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v)
        return jnp.sum(jnp.asarray(w) * v)

    want = jax.grad(f)(jnp.asarray(pts))
    got = TQ.query_points_vjp_plain(tt, torch.as_tensor(pts),
                                    torch.as_tensor(w), outside_value_max)
    _close(got, want, RTOL64)
    _same_as_autograd(lambda P: (torch.as_tensor(w) * T.query(
        tt, P, outside_value_max)).sum(), pts, got)


def test_query_with_gradient_vjp(trees, few_torch_threads):  # noqa: F811
    """K8g and K1h's plain version against jax.vjp of query_with_gradient
    (the sentinel masked out of the values). At degree 0 the gradient is
    zero everywhere: the reference's VJP to the coefficients is NaN, the
    port's is that of the values alone."""
    deg, jt, tt, _, _, pts, rng = trees
    wv = rng.standard_normal(pts.shape[0])
    wn = rng.standard_normal(pts.shape)

    def f(c, P):
        v, n = hp.query_with_gradient(dataclasses.replace(jt, coeffs=c), P)
        return jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v), n

    _, pull = jax.vjp(f, jt.coeffs, jnp.asarray(pts))
    got = TQ.query_with_gradient_vjp_plain(
        tt, torch.as_tensor(pts), torch.as_tensor(wv), torch.as_tensor(wn))
    want = pull((jnp.asarray(wv), jnp.asarray(wn)))
    if deg == 0:
        # NaN wherever the zero gradient's norm is in the graph: the
        # coefficients (the points do not enter a degree-0 basis)
        assert np.isnan(np.asarray(want[0])).any()
        assert not np.asarray(want[1]).any()
        want = (jax.grad(lambda c: jnp.sum(jnp.asarray(wv) * f(
            c, jnp.asarray(pts))[0]))(jt.coeffs), want[1])
        alone = TQ.query_with_gradient_vjp_plain(
            tt, torch.as_tensor(pts), torch.as_tensor(wv),
            torch.zeros(pts.shape, dtype=torch.float64))
        for g, a in zip(got, alone):
            np.testing.assert_array_equal(g.numpy(), a.numpy())
    _close(got[0], want[0], RTOL64)
    _close(got[1], want[1], RTOL64)
    # the entry point's autograd, the coefficients and the points at once
    coeffs = tt.coeffs.clone().requires_grad_(True)
    P = torch.as_tensor(pts).requires_grad_(True)
    v, n = T.query_with_gradient(dataclasses.replace(tt, coeffs=coeffs), P)
    v = torch.where(v == TQ.OUTSIDE_VALUE, 0.0, v)
    ((torch.as_tensor(wv) * v).sum()
     + (torch.as_tensor(wn) * n).sum()).backward()
    np.testing.assert_array_equal(coeffs.grad.numpy(), got[0].numpy())
    _close(P.grad, got[1].numpy(), 0.0)


def test_query_packed_vjp(trees, few_torch_threads):  # noqa: F811
    """query_packed's VJP: values_at's with the weights zeroed outside the
    root (the f32-max sentinel is a constant)."""
    _, _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    w = rng.standard_normal(p32.shape[0]).astype(np.float32)

    def f(rows, grid, P):
        v = JA.query_packed(dataclasses.replace(jp, rows=rows, grid=grid), P)
        return jnp.sum(jnp.asarray(w) * jnp.where(
            v == jnp.finfo(jnp.float32).max, 0.0, v))

    want = jax.grad(f, argnums=(0, 1, 2))(jp.rows, jp.grid, jnp.asarray(p32))
    pk, rows, grid = _tables(tp)
    P = torch.as_tensor(p32).requires_grad_(True)
    v = TA.query_packed(pk, P)
    (torch.as_tensor(w) * torch.where(v == TA.F32_MAX, 0.0, v)).sum() \
        .backward()
    _close(rows.grad[:, C0:], np.asarray(want[0])[:, C0:], RTOL32)
    _close(grid.grad[:, C0:], np.asarray(want[1])[:, C0:], RTOL32)
    _close(P.grad, want[2], RTOL32)


def test_normals_vjp(trees, few_torch_threads):  # noqa: F811
    """K7's form 2 (the tables, 1e-5) and K5h's normals mode (the points,
    1e-4) against jax.vjp of render._normals_at. The meta lanes take no
    gradient in the port (they are the tree's topology); the reference's
    autodiff differentiates them, so the tables are compared on their
    coefficient lanes. At degree 0 (a zero gradient) the reference's VJP
    to the tables is NaN, the port's zero."""
    deg, _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    wn = rng.standard_normal(p32.shape).astype(np.float32)
    d_rows, d_grid, d_p = TA.normals_vjp_plain(tp, torch.as_tensor(p32),
                                               torch.as_tensor(wn))
    _, pull = jax.vjp(
        lambda r, g, P: JR._normals_at(dataclasses.replace(jp, rows=r,
                                                           grid=g), P),
        jp.rows, jp.grid, jnp.asarray(p32))
    want = pull(jnp.asarray(wn))
    assert not d_rows[:, :C0].any() and not d_grid[:, :C0].any()
    if deg == 0:
        assert np.isnan(np.asarray(want[0])[:, C0:]).any()
        assert not np.asarray(want[2]).any()
        for g in (d_rows, d_grid, d_p):
            assert not g.any()
        return
    _close(d_rows[:, C0:], np.asarray(want[0])[:, C0:], RTOL32)
    _close(d_grid[:, C0:], np.asarray(want[1])[:, C0:], RTOL32)
    _close(d_p, want[2], RTOL_HVP)
    # the entry point's autograd takes the same route (its sums in
    # another order)
    pk, rows, _ = _tables(tp)
    P = torch.as_tensor(p32).requires_grad_(True)
    (torch.as_tensor(wn) * TA.normals(pk, P)).sum().backward()
    _close(P.grad, d_p.numpy(), 1e-6)
    _close(rows.grad, d_rows.numpy(), 1e-6)


def test_normals_tables_vjp_from_saved(trees, few_torch_threads):  # noqa: F811
    """K7's form 2 from what K5's normals forward saves (the row's key and
    the unnormalised gradient, ``normals_save_plain``): the normals bit
    for bit ``normals_plain``'s, each key's row the row ``locate`` reads,
    and the tables' VJP from the saved values
    (``normals_tables_vjp_plain``) bit for bit ``normals_vjp_plain``'s,
    which test_normals_vjp holds to jax.vjp of render._normals_at. Both
    VJPs run on one intra-op thread: with more, the CPU's accumulation
    into the tables is not reproducible from one call to the next (at
    degree 12, either VJP against itself)."""
    deg, _, _, _, tp, pts, _ = trees
    rng = np.random.default_rng(900 + deg)
    p32 = torch.as_tensor(pts.astype(np.float32))
    wn = torch.as_tensor(rng.standard_normal(p32.shape).astype(np.float32))
    n, saved = TA.normals_save_plain(tp, p32)
    assert saved.shape == (p32.shape[0], 4) and saved.dtype == torch.float32
    assert torch.equal(n, TA.normals_plain(tp, p32))
    key = saved[:, 0].contiguous().view(torch.int32).long()
    G3 = 8 ** tp.grid_depth
    assert int(key.min()) >= 0 and int(key.max()) < G3 + tp.rows.shape[0]
    keyed = torch.where((key < G3)[:, None], tp.grid[key.clamp(max=G3 - 1)],
                        tp.rows[(key - G3).clamp(min=0)])
    unit = TQ.clip_half(TA.to_unit(tp, p32))
    assert torch.equal(keyed, TA.locate(tp, unit))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = TA.normals_tables_vjp_plain(tp, p32, saved, wn)
        want = TA.normals_vjp_plain(tp, p32, wn)[:2]
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("wants", ["tables", "points", "both"])
def test_normals_forward_saves_for_form2(wants, monkeypatch,
                                         few_torch_threads):  # noqa: F811
    """With the kernel wrappers replaced by their plain versions, _Normals
    asks K5 for NORMALS_SAVE and saves (points, saved values) wherever the
    tables or the points need a gradient (K5h starts from them too); its
    backward hands the saved values to K7's form 2 where the tables need a
    gradient, and its gradients stay within 1e-5 (tables, coefficient
    lanes) and 1e-4 (points) of jax.vjp of render._normals_at."""
    jt, tt = _synthetic(3, seed=3)
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    rng = np.random.default_rng(910)
    lo, hi = _lo_hi()
    p32 = rng.uniform(lo, hi, (200, 3)).astype(np.float32)
    wn = rng.standard_normal(p32.shape).astype(np.float32)
    modes, form2 = [], []

    def k5(pt, pts, mode, outside_max=False, n_grad=0):
        modes.append(mode)
        return TA.normals_save_plain(pt, pts) if mode == TA.NORMALS_SAVE \
            else TA.normals_plain(pt, pts)

    def k7(pt, pts, cot, form, saved=None):
        form2.append(saved)
        return TA.normals_tables_vjp_plain(pt, pts, saved, cot)

    monkeypatch.setattr(TA, "packed_eval_kernel", k5)
    monkeypatch.setattr(TA, "packed_grad_kernel", k7)
    monkeypatch.setattr(TA, "packed_hvp_kernel",
                        lambda pt, pts, mode, w=None, cot3=None, saved=None:
                        TA.normals_points_vjp_plain(pt, pts, saved, cot3))
    tables = wants in ("tables", "both")
    rows = tp.rows.clone().requires_grad_(tables)
    grid = tp.grid.clone().requires_grad_(tables)
    P = torch.as_tensor(p32).requires_grad_(wants != "tables")
    n = TA._Normals.apply(rows, grid, P,
                          dataclasses.replace(tp, rows=rows, grid=grid))
    saved = n.grad_fn.saved_tensors
    assert modes == [TA.NORMALS_SAVE]
    assert len(saved) == 2 and saved[0] is P
    (torch.as_tensor(wn) * n).sum().backward()
    assert len(form2) == int(tables)
    if tables:
        assert form2[0] is saved[1]
    _, pull = jax.vjp(
        lambda r, g, Q: JR._normals_at(dataclasses.replace(jp, rows=r,
                                                           grid=g), Q),
        jp.rows, jp.grid, jnp.asarray(p32))
    want = pull(jnp.asarray(wn))
    if tables:
        _close(rows.grad[:, C0:], np.asarray(want[0])[:, C0:], RTOL32)
        _close(grid.grad[:, C0:], np.asarray(want[1])[:, C0:], RTOL32)
    if wants != "tables":
        _close(P.grad, want[2], RTOL_HVP)


def test_values_and_gradient_points_vjp(trees, few_torch_threads):  # noqa: F811
    """K5h's second mode: the VJP to the points of the values and of the
    raw gradients of the first n points, against jax.vjp of values_at and
    of jax.grad of values_at (the reference's eikonal term)."""
    _, _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    n = p32.shape[0] // 2
    w = rng.standard_normal(p32.shape[0]).astype(np.float32)
    u = rng.standard_normal((n, 3)).astype(np.float32)

    def f(P):
        g = jax.grad(lambda Q: jnp.sum(JA.values_at(jp, Q)))(P[:n])
        return JA.values_at(jp, P), g

    _, pull = jax.vjp(f, jnp.asarray(p32))
    (want,) = pull((jnp.asarray(w), jnp.asarray(u)))
    got = TA.values_and_gradient_vjp_plain(tp, torch.as_tensor(p32),
                                           torch.as_tensor(w),
                                           torch.as_tensor(u))
    _close(got, want, RTOL_HVP)
    _close(TA.values_and_gradient_at(tp, torch.as_tensor(p32), n)[1],
           jax.grad(lambda Q: jnp.sum(JA.values_at(jp, Q)))(
               jnp.asarray(p32[:n])), RTOL32)

    def loss(P):
        v, g = TA.values_and_gradient_at(tp, P, n)
        return (torch.as_tensor(w) * v).sum() + (torch.as_tensor(u) * g).sum()

    _same_as_autograd(loss, p32, got, 1e-6)


# --------------------------------------------------------------------------
# The face rule
# --------------------------------------------------------------------------

_FACES = [(a, e) for a in range(3) for e in (0, 1)] + [("edge", None)]


@pytest.mark.parametrize("where", _FACES, ids=lambda x: (
    "edge" if x[0] == "edge" else f"axis{x[0]}_{('lo', 'hi')[x[1]]}"))
def test_face_rule(where, few_torch_threads):  # noqa: F811
    """At points exactly on a face of the root, or on an edge, the clamp's
    derivative is 1/2 on that axis, as jnp.clip's: values_at's point VJP,
    values_and_gradient_at's gradients and their point VJP, query's and
    query_with_gradient's point VJPs equal jax.grad's."""
    jt, tt = _synthetic(3, seed=3)
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    lo, hi = _lo_hi()
    rng = np.random.default_rng(17)
    p = rng.uniform(lo, hi, (6, 3))
    axis, end = where
    if axis == "edge":
        p[:, 0], p[:, 2] = hi[0], lo[2]
        on = [0, 2]
    else:
        p[:, axis] = (lo, hi)[end][axis]
        on = [axis]
    unit = (p - 0.5 * (lo + hi)) / (hi - lo)
    assert np.all(np.abs(unit[:, on]) == 0.5)
    p32 = p.astype(np.float32)
    w = rng.standard_normal(6)
    u = rng.standard_normal((6, 3))

    # values_at's point VJP and values_and_gradient_at's gradients
    def vsum(Q):
        return jnp.sum(jnp.asarray(w, jnp.float32) * JA.values_at(jp, Q))

    want = jax.grad(vsum)(jnp.asarray(p32))
    P = torch.as_tensor(p32).requires_grad_(True)
    (torch.as_tensor(w, dtype=torch.float32) * TA.values_at(tp, P)).sum() \
        .backward()
    _close(P.grad, want, RTOL32)
    raw = jax.grad(lambda Q: jnp.sum(JA.values_at(jp, Q)))(jnp.asarray(p32))
    _, g = TA.values_and_gradient_at(tp, torch.as_tensor(p32), 6)
    _close(g, raw, RTOL32)
    _, pull = jax.vjp(lambda Q: (JA.values_at(jp, Q), jax.grad(
        lambda R: jnp.sum(JA.values_at(jp, R)))(Q)), jnp.asarray(p32))
    wu = (jnp.asarray(w, jnp.float32), jnp.asarray(u, jnp.float32))
    _close(TA.values_and_gradient_vjp_plain(
        tp, torch.as_tensor(p32), torch.as_tensor(w, dtype=torch.float32),
        torch.as_tensor(u, dtype=torch.float32)), pull(wu)[0], RTOL_HVP)
    # query's and query_with_gradient's point VJPs, in f64
    want = jax.grad(lambda Q: jnp.sum(jnp.asarray(w) * hp.query(jt, Q)))(
        jnp.asarray(p))
    _close(TQ.query_points_vjp_plain(tt, torch.as_tensor(p),
                                     torch.as_tensor(w)), want, RTOL64)
    _, pull = jax.vjp(lambda Q: hp.query_with_gradient(jt, Q),
                      jnp.asarray(p))
    _close(TQ.query_with_gradient_vjp_plain(
        tt, torch.as_tensor(p), torch.as_tensor(w), torch.as_tensor(u))[1],
        pull((jnp.asarray(w), jnp.asarray(u)))[0], RTOL64)


def _unit_vector_vjp(g, wn, floor):
    """The VJP of g / max(|g|, floor), the floor's tie split as
    jnp.maximum splits it (hpsdf::unit_vector_vjp)."""
    nrm = torch.linalg.norm(g, dim=-1, keepdim=True)
    den = torch.clamp(nrm, min=floor)
    t = torch.where(nrm > floor, 1.0, torch.where(nrm == floor, 0.5, 0.0))
    n = g / den
    return (wn - t * n * (n * wn).sum(-1, keepdim=True)) / den


def _k8g_formula(tree, pts, wv, wn):
    """K8g's sum by plain torch, point by point as csrc/coeff_scatter.cu
    states it: a point is live where it lies inside the root with wv not
    zero, or wn is not zero; its leaf's row gets w' P_m + sum_a gb_a s_a
    dP_m/dx_a, w' = wv inside the root and 0 outside, s_a = 2^(depth+1) /
    size_a, gb the unit vector's VJP at g s, g the leaf frame's gradient
    from the row's coefficients."""
    deg = tree.deg_used
    unit = TQ._to_unit(tree, pts)
    inside = torch.all(unit.abs() <= 0.5, dim=-1)
    live = (inside & (wv != 0)) | torch.any(wn != 0, dim=-1)
    u = TQ.clip_half(unit)
    row = TQ.descend(tree, u).long()
    d = tree.depth[row]
    scale = torch.exp2((d + 1).double())[:, None]
    L, dL = TB.legendre_all_with_derivative((u - tree.centre[row]) * scale,
                                            deg)
    idx, norms = TB._tables(deg, pts)
    nrm = norms[d.long()]
    i, j, k = idx[:, 0], idx[:, 1], idx[:, 2]
    phi = L[:, 0, i] * L[:, 1, j] * L[:, 2, k] * nrm
    dphi = torch.stack([dL[:, 0, i] * L[:, 1, j] * L[:, 2, k],
                        L[:, 0, i] * dL[:, 1, j] * L[:, 2, k],
                        L[:, 0, i] * L[:, 1, j] * dL[:, 2, k]], 1) \
        * nrm[:, None]
    g = (tree.coeffs[row][:, None, :] * dphi).sum(-1)
    sa = scale * torch.as_tensor(1.0 / tree.config.root_sizes)
    gb = _unit_vector_vjp(g * sa, wn, 1e-30)
    terms = torch.where(inside, wv, 0.0)[:, None] * phi \
        + ((gb * sa)[:, :, None] * dphi).sum(1)
    return torch.zeros_like(tree.coeffs).index_add_(0, row[live],
                                                    terms[live])


@pytest.mark.parametrize("deg", [0, 3, 6, 12])
def test_k8g_formula(deg, few_torch_threads):  # noqa: F811
    """The sum K8g forms on the card (its source's formula, point by point)
    equals query_with_gradient_vjp_plain's coefficient half, the version
    the kernel is held to, within RTOL64: at points straddling the root,
    on its faces, edges and corners, with a third of wv and a third of
    wn's rows zero (a ninth of the points both, so dead); above degree 0
    both equal jax.vjp of hpsdf_tpu's query_with_gradient."""
    jt, tt = _synthetic(deg, seed=40 + deg)
    lo, hi = _lo_hi()
    rng = np.random.default_rng(60 + deg)
    pts = np.concatenate([rng.uniform(lo - 0.1 * (hi - lo),
                                      hi + 0.1 * (hi - lo), (N_PTS, 3)),
                          _face_points(rng)])
    wv = rng.standard_normal(pts.shape[0])
    wv[rng.random(pts.shape[0]) < 1 / 3] = 0.0
    wn = rng.standard_normal(pts.shape)
    wn[rng.random(pts.shape[0]) < 1 / 3] = 0.0
    P, WV, WN = (torch.as_tensor(x) for x in (pts, wv, wn))
    dead = (WV == 0) & torch.all(WN == 0, dim=-1)
    assert 0 < int(dead.sum()) < pts.shape[0]
    want = TQ.query_with_gradient_vjp_plain(tt, P, WV, WN)[0]
    assert float(want.abs().max()) > 0
    _close(_k8g_formula(tt, P, WV, WN), want.numpy(), RTOL64)
    if deg:
        def f(c):
            v, n = hp.query_with_gradient(dataclasses.replace(jt, coeffs=c),
                                          jnp.asarray(pts))
            return jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v), n

        _, pull = jax.vjp(f, jt.coeffs)
        _close(want, pull((jnp.asarray(wv), jnp.asarray(wn)))[0], RTOL64)


def test_legendre_second_derivative(few_torch_threads):  # noqa: F811
    """L''_p by its recurrence against numpy's Legendre series and
    against autograd of the three-term recurrence, p = 0..12."""
    x = torch.linspace(-1.0, 1.0, 41, dtype=torch.float64)
    _, dL = TB.legendre_all_with_derivative(x, 12)
    d2L = TB.legendre_second_derivative(dL, 12)
    for p in range(13):
        c = np.zeros(p + 1)
        c[p] = 1.0
        np.testing.assert_allclose(
            d2L[:, p].numpy(), np.polynomial.legendre.legval(
                x.numpy(), np.polynomial.legendre.legder(c, 2)),
            rtol=0, atol=1e-9 * max(1.0, p ** 4))
    xg = x.clone().requires_grad_(True)
    (d1,) = torch.autograd.grad(TB.legendre_all(xg, 12).sum(0).sum(), xg,
                                create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), xg)
    _close(d2, d2L.sum(-1).numpy(), 1e-12)


@pytest.mark.parametrize("dt,floor", [(np.float64, 1e-30),
                                      (np.float32, 1e-12)])
def test_unit_vector_tie(dt, floor, few_torch_threads):  # noqa: F811
    """g / max(|g|, floor) at |g| exactly the floor, below it, above it and
    at zero: the VJP splits the tie as jnp.maximum does; at zero it is wn /
    floor, where the reference's autodiff gives NaN."""
    g = np.asarray([[floor, 0.0, 0.0], [0.0, 0.0, floor / 4],
                    [0.3, -0.4, 1.2], [0.0, 0.0, 0.0]], dt)
    wn = np.asarray([[1.0, 2.0, -1.0]] * 4, dt)
    gt = torch.as_tensor(g).requires_grad_(True)
    (torch.as_tensor(wn) * TQ.unit_vector(gt, floor)).sum().backward()
    _, pull = jax.vjp(lambda x: x / jnp.maximum(
        jnp.linalg.norm(x, axis=-1, keepdims=True), floor), jnp.asarray(g))
    (want,) = pull(jnp.asarray(wn))
    want = np.asarray(want)
    assert np.isnan(want[3]).all()
    np.testing.assert_allclose(gt.grad.numpy()[:3], want[:3], rtol=1e-6)
    np.testing.assert_array_equal(gt.grad.numpy()[3], wn[3] / dt(floor))
    # the tie: half the norm's share, (wn - n (n . wn) / 2) / floor
    assert gt.grad[0, 0] == pytest.approx(0.5 / floor, rel=1e-6)


# --------------------------------------------------------------------------
# [grad2]'s paths at a small size
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sphere():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                    max_degree=3)
    jt = hp.build_octree(cfg, sphere_sdf(radius=0.3))
    return jt, carry(jt, cfg)


def _adam(params, steps, loss_fn, check, lr):
    """``steps`` Adam steps on ``params`` by the port, ``check`` called with
    each step's parameters, loss and gradients first."""
    opt = torch.optim.Adam(params, lr=lr)
    for _ in range(steps):
        opt.zero_grad()
        loss = loss_fn(*params)
        loss.backward()
        check([p.detach().clone() for p in params], float(loss.detach()),
              [p.grad.clone() for p in params])
        opt.step()


def test_path_projection(sphere, few_torch_threads):  # noqa: F811
    jt, tt = sphere
    lo, hi = (np.asarray(x) for x in jt.root_aabb)
    p = torch.as_tensor(chip_smoke.root_points(lo, hi, 256, seed=4))

    def jstep(P):
        f = hp.query(jt, P, outside_value_max=False)
        fg = jax.grad(lambda Q: 0.5 * jnp.sum(
            hp.query(jt, Q, outside_value_max=False) ** 2))(P)
        den = jnp.sum(fg * fg, -1, keepdims=True)
        return P - jnp.where(den > 0, fg * (f * f)[:, None] / den, 0.0), f

    for _ in range(2):
        want_p, want_f = jstep(jnp.asarray(p.numpy()))
        new, f = chip_smoke.projection_step(tt, p)
        _close(f, want_f, RTOL64)
        _close(new - p, np.asarray(want_p) - p.numpy(), RTOL64)
        p = new
    assert float(f.abs().mean()) < 0.05


def test_path_oriented_fit(sphere, few_torch_threads):  # noqa: F811
    jt, tt = sphere
    v, f = gen.icosphere(0.3, 2)
    mesh = build_mesh(v, f)
    pts, n_t = chip_smoke.oriented_samples(mesh, 256, seed=5)
    P, NT = torch.as_tensor(pts), torch.as_tensor(n_t)

    def jloss(c, shift):
        tr = dataclasses.replace(jt, coeffs=c)
        Q = jnp.asarray(pts) + shift
        n = hp.query_with_gradient(tr, Q)[1]
        return jnp.mean(hp.query(tr, Q) ** 2) + jnp.mean(
            1.0 - jnp.sum(n * jnp.asarray(n_t), -1))

    def check(params, loss, grads):
        c, s = (jnp.asarray(x.numpy()) for x in params)
        want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1))(c, s)
        assert loss == pytest.approx(float(want_loss), rel=1e-12)
        for g, w in zip(grads, want):
            _close(g, w, RTOL64)

    params = [tt.coeffs.clone().requires_grad_(True),
              torch.zeros(3, dtype=torch.float64, requires_grad=True)]
    _adam(params, 2, lambda c, s: chip_smoke.oriented_fit_loss(
        tt, c, s, P, NT), check, chip_smoke.FIT_LR)


def test_path_oriented_fit_centres(sphere, few_torch_threads):  # noqa: F811
    """Path (d): path (b)'s loss with respect to the centres as well (K1c
    on the card), two Adam steps, each step's loss and gradients against
    jax's at the same parameters."""
    jt, tt = sphere
    v, f = gen.icosphere(0.3, 2)
    mesh = build_mesh(v, f)
    pts, n_t = chip_smoke.oriented_samples(mesh, 256, seed=6)
    P, NT = torch.as_tensor(pts), torch.as_tensor(n_t)

    def jloss(c, shift, x):
        tr = dataclasses.replace(jt, coeffs=c, centre=x)
        Q = jnp.asarray(pts) + shift
        n = hp.query_with_gradient(tr, Q)[1]
        return jnp.mean(hp.query(tr, Q) ** 2) + jnp.mean(
            1.0 - jnp.sum(n * jnp.asarray(n_t), -1))

    def check(params, loss, grads):
        c, s, x = (jnp.asarray(p.numpy()) for p in params)
        want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
            c, s, x)
        assert loss == pytest.approx(float(want_loss), rel=1e-12)
        for g, w in zip(grads, want):
            _close(g, w, RTOL64)
        assert float(grads[2].abs().max()) > 0

    params = [tt.coeffs.clone().requires_grad_(True),
              torch.zeros(3, dtype=torch.float64, requires_grad=True),
              tt.centre.clone().requires_grad_(True)]
    _adam(params, 2, lambda c, s, x: chip_smoke.oriented_fit_loss(
        tt, c, s, P, NT, centre=x), check, chip_smoke.FIT_LR)


def test_path_normal_map(sphere, few_torch_threads):  # noqa: F811
    jt, tt = sphere
    o, d = TR.camera_rays((0.5, 0.4, -1.6), (0.0, 0.0, 0.0), width=16,
                          height=16, device="cpu")
    res = T.trace(tt, o, d, t_max=5.0)
    hits = (o + res.t[:, None] * d)[res.hit]
    assert hits.shape[0] > 20
    n_t = hits / torch.linalg.norm(hits, dim=-1, keepdim=True)
    tp, ts = TA.pack_tree(tt), TA.pack_support(tt)
    jp, js = JA.pack_tree(jt), JA.pack_support(jt)
    H, NT = jnp.asarray(hits.numpy()), jnp.asarray(n_t.numpy())

    def jloss(F, shift):
        pk = JA.repack_folded(jp, js, F)
        Q = H + shift
        n = JR._normals_at(pk, Q)
        v = JA.values_at(pk, Q)
        g = jax.grad(lambda R: jnp.sum(JA.values_at(pk, R)))(Q)
        gn = jnp.sqrt(jnp.sum(g * g, -1) + 1e-12)
        return (jnp.mean(1.0 - jnp.sum(n * NT, -1)) + jnp.mean(v * v)
                + chip_smoke.NMAP_EIKONAL * jnp.mean((gn - 1.0) ** 2))

    def check(params, loss, grads):
        F, s = (jnp.asarray(x.numpy()) for x in params)
        want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1))(F, s)
        assert loss == pytest.approx(float(want_loss), rel=1e-5)
        for g, w in zip(grads, want):
            _close(g, w, chip_smoke.NMAP_RTOL)

    folded = (tt.coeffs * ts.fold).to(torch.float32)
    params = [folded.clone().requires_grad_(True),
              torch.zeros(3, requires_grad=True)]
    _adam(params, 2, lambda F, s: chip_smoke.normal_map_loss(
        tp, ts, F, s, hits, n_t), check, chip_smoke.NMAP_LR)


# --------------------------------------------------------------------------
# Routes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["query_vjp", "query_vjp_hess",
                                    "query_centre_vjp",
                                    "coeff_scatter_grad", "packed_hvp",
                                    "packed_grad_form2"])
def test_kernel_wrappers_refuse_cpu(kernel, few_torch_threads):  # noqa: F811
    """The new backward kernels' wrappers launch on CUDA tensors or raise;
    only the entry points take the plain versions, for CPU tensors."""
    _, tt = _synthetic(2, seed=2)
    tp = TA.pack_tree(tt, grid_depth=1)
    p64 = torch.zeros((4, 3), dtype=torch.float64)
    w64 = torch.zeros(4, dtype=torch.float64)
    p32, w32 = p64.float(), w64.float()
    with pytest.raises(ValueError, match="CUDA"):
        leaf = torch.zeros(4, dtype=torch.int32)
        if kernel == "query_vjp":
            TQ.query_vjp_kernel(tt, p64, leaf, w64)
        elif kernel == "query_vjp_hess":
            TQ.query_vjp_kernel(tt, p64, leaf, w64, p64)
        elif kernel == "query_centre_vjp":
            TQ.query_vjp_kernel(tt, p64, leaf, w64, points=False,
                                centre=True)
        elif kernel == "coeff_scatter_grad":
            TQ.coeff_scatter_grad_kernel(tt, p64, w64, p64)
        elif kernel == "packed_hvp":
            TA.packed_hvp_kernel(tp, p32, TA.VALUES_GRAD_VJP, w32, p32)
        else:
            TA.packed_grad_kernel(tp, p32, p32, 2)


@pytest.mark.parametrize("entry", ["query", "query_with_gradient",
                                   "query_packed", "normals",
                                   "values_and_gradient_at"])
def test_device_tensors_take_the_autograd_functions(entry, monkeypatch,
                                                    few_torch_threads):  # noqa: F811
    """On a device other than the CPU a read whose points require a
    gradient goes through its autograd function (whose backward is the
    kernels), where it used to be refused."""
    _, tt = _synthetic(2, seed=2)
    tp = TA.pack_tree(tt, grid_depth=1)
    fn = {"query": (TQ, "_Query"),
          "query_with_gradient": (TQ, "_QueryWithGradient"),
          "query_packed": (TA, "_QueryPacked"),
          "normals": (TA, "_Normals"),
          "values_and_gradient_at": (TA, "_ValuesAndGradient")}[entry]
    taken = []
    monkeypatch.setattr(getattr(*fn), "apply",
                        lambda *args: taken.append(args) or "taken")
    dt = torch.float64 if entry.startswith("query_w") or entry == "query" \
        else torch.float32
    meta = torch.zeros((4, 3), dtype=dt, device="meta", requires_grad=True)
    if entry == "query":
        out = T.query(tt, meta)
    elif entry == "query_with_gradient":
        out = T.query_with_gradient(tt, meta)
    elif entry == "values_and_gradient_at":
        out = TA.values_and_gradient_at(tp, meta, 2)
    else:
        out = getattr(TA, entry)(tp, meta)
    assert out == "taken" and len(taken) == 1 and taken[0][2] is meta


def test_points_and_rays_still_refused(monkeypatch, few_torch_threads):  # noqa: F811
    """What stays refused: the sharded reads with respect to the points
    (``parallel.shard_query``) and the rays (``parallel.shard_trace``),
    which the reference does not differentiate either, and ``trace`` with
    respect to the origins or directions; each raises before any
    collective or launch. ``query`` and ``query_with_gradient`` with
    respect to tree.centre no longer refuse (K1c)."""
    from hpsdf_tpu_torch import parallel

    _, tt = _synthetic(2, seed=2)
    pts = torch.zeros((4, 3), dtype=torch.float64, requires_grad=True)
    rays = torch.zeros((4, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient to the points"):
        parallel.shard_query(tt, pts, object())
    for o, d in ((rays, torch.ones((4, 3))), (torch.zeros((4, 3)), rays)):
        with pytest.raises(RuntimeError, match="no gradient to the points "
                                               "or rays"):
            parallel.shard_trace(tt, o, d, object())
    with pytest.raises(RuntimeError, match="origins or directions"):
        T.trace(tt, rays, torch.ones((4, 3)))
    tc = dataclasses.replace(tt, centre=tt.centre.clone().requires_grad_())
    meta = torch.zeros((4, 3), dtype=torch.float64, device="meta")
    taken = []
    for fn, cls in ((T.query, TQ._Query),
                    (T.query_with_gradient, TQ._QueryWithGradient)):
        monkeypatch.setattr(cls, "apply",
                            lambda *args: taken.append(args) or "taken")
        assert fn(tc, meta) == "taken"
    assert [a[-1] is tc.centre for a in taken] == [True, True]


def _centre_rays():
    """ROADMAP's reproduction of the trace's dropped centre gradient: the
    degree-3 synthetic tree, 16 rays along +z from z = -1.25 within 0.3 of
    the root's centre in x and y."""
    lo, hi = (np.asarray(x, np.float64) for x in chip_smoke.SYNTH_ROOT)
    cfg = T.Config(continuity=False, root_min=tuple(lo), root_max=tuple(hi))
    from hpsdf_tpu_torch import tree as TT
    tt = TT.pack(*chip_smoke.synthetic_tree(3, seed=3), cfg, device="cpu")
    rng = np.random.default_rng(3)
    o = np.zeros((16, 3))
    o[:, :2] = 0.5 * (lo + hi)[:2] + rng.uniform(-0.3, 0.3, (16, 2))
    o[:, 2] = -1.25
    d = np.tile([0.0, 0.0, 1.0], (16, 1))
    return tt, *(torch.as_tensor(x, dtype=torch.float32) for x in (o, d))


@pytest.mark.parametrize("packed", [False, True],
                         ids=["unpacked", "packed"])
def test_trace_refuses_a_centre_gradient(packed, monkeypatch,
                                         few_torch_threads):  # noqa: F811
    """``trace`` with ``tree.centre`` requiring a gradient raises the
    port's RuntimeError on the CPU, with the packed tables given and
    without, before it packs or marches (the reference's zeros there are a
    placeholder, not the derivative); ``tree.coeffs`` keeps its gradient,
    the same with and without the tables."""
    tt, o, d = _centre_rays()
    kw = {"packed": TA.pack_tree(tt)} if packed else {}
    tc = dataclasses.replace(tt, centre=tt.centre.clone().requires_grad_())
    for name in ("pack_tree", "_march"):
        monkeypatch.setattr(TR, name, lambda *a, **k: pytest.fail(
            "trace packed or marched before refusing the centres"))
    with pytest.raises(RuntimeError, match="tree.centre"):
        T.trace(tc, o, d, t_max=20.0, **kw)
    monkeypatch.undo()
    grads = []
    for args in ({}, kw):
        C = tt.coeffs.clone().requires_grad_(True)
        res = T.trace(dataclasses.replace(tt, coeffs=C), o, d, t_max=20.0,
                      **args)
        assert res.t.requires_grad and int(res.hit.sum()) > 0
        (g,) = torch.autograd.grad(torch.where(res.hit, res.t, 0.0).sum(), C)
        grads.append(g)
    assert bool(torch.isfinite(grads[0]).all()) and grads[0].abs().max() > 0
    assert torch.equal(grads[0], grads[1])


def test_grad2_helpers():
    """chip_smoke's points for [grad2] (a sixteenth on the faces, the rest
    inside or, padded, some outside) and its wrong results: a moved entry
    and, where the face entries are not zero, the face rule undone, each
    failing the check that the right result passes."""
    lo, hi = _lo_hi()
    p = chip_smoke.root_points(lo, hi, 1024, seed=1)
    unit = (p - 0.5 * (lo + hi)) / (hi - lo)
    assert np.all(np.abs(unit) <= 0.5)
    assert (np.abs(unit) == 0.5).any(axis=1).sum() == 1024 // 16
    q = chip_smoke.root_points(lo, hi, 1024, seed=1, pad=0.1)
    assert (np.abs((q - 0.5 * (lo + hi)) / (hi - lo)) > 0.5).any()
    want = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (64, 3)))
    face = torch.zeros((64, 3), dtype=torch.bool)
    face[::8, 1] = True
    assert chip_smoke.rel_err(want.clone(), want) == 0.0
    assert chip_smoke.grad2_teeth(want.clone(), want, 1e-10, face) == [
        True, True]
    assert chip_smoke.grad2_teeth(want.clone(), want, 1e-10) == [True]
    zero = torch.zeros((4, 3), dtype=torch.float64)
    assert chip_smoke.grad2_teeth(zero, zero, 1e-4,
                                  torch.ones((4, 3), dtype=torch.bool)) \
        == [True]


@pytest.mark.parametrize("deg", [0, 3, 5, 12])
def test_grad2_operation_counts(deg):
    """chip_smoke's operation counts of the backward kernels, which set
    their bounds: the sums by hand (three operations a term, each kind of
    pair product once a point), no value sum in K1v, K1h, K8g or K5h, and
    K1's frame the part of k1_ops outside its four sums."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T_ = (deg + 1) * (deg + 2) // 2
    dep = 5
    assert chip_smoke.product_sum_ops(deg, 9, 6) == 27 * C + 6 * T_
    assert chip_smoke.k1_ops(deg, dep, False) \
        == chip_smoke.k1_frame_ops(deg, dep, 0) + 3 * C + T_
    assert chip_smoke.k1_ops(deg, dep, True) \
        == chip_smoke.k1_frame_ops(deg, dep, 1) + 11 * C + 3 * T_
    assert chip_smoke.k1v_ops(deg, dep) \
        == chip_smoke.k1_frame_ops(deg, dep, 1) + 9 * C + 3 * T_
    assert chip_smoke.k1h_ops(deg, dep) \
        == chip_smoke.k1_frame_ops(deg, dep, 2) + 27 * C + 6 * T_
    assert chip_smoke.k8g_ops(deg, dep) \
        == chip_smoke.k1v_ops(deg, dep) + 12 * C
    assert chip_smoke.k5h_ops(deg) \
        == 49 + 30 * max(deg - 1, 0) + 27 * C + 6 * T_
    assert chip_smoke.k7f2_ops(deg) \
        == chip_smoke.k7_ops(deg, 1) + 9 * C + 3 * T_
