"""K5h from what its forward saves, held on CPU tensors against jax.vjp of
hpsdf_tpu on the same numpy inputs.

K5h (``accel.packed_hvp_kernel``) starts from the record its forward
saved and locates no row: the normals' forward (K5's NORMALS_SAVE) saves
each point's row key and unnormalised gradient, the fused read
(VALUES_AND_GRAD_SAVE) each point's row key. Their plain versions:

  * ``normals_save_plain`` and ``values_and_gradient_save_plain``, the
    forwards with what they save: the outputs bit for bit the plain
    forwards', the keys ``locate_key_plain``'s, each naming the row
    ``locate`` reads (``keyed_rows``);
  * ``normals_points_vjp_plain`` (from the saved record) against jax.vjp of
    ``render._normals_at`` with respect to the points, and
    ``values_and_gradient_points_vjp_plain`` (from the saved keys) against
    jax.vjp of ``accel.values_at`` and of jax.grad(values_at) on the first
    n points, within RTOL_HVP of the reference's largest entry;

at the ``trees`` fixture's degrees (0, 1, 3, 5, 12), on points straddling
the root, on its faces, edges and corners (``jnp.clip``'s 1/2), and at
degree 0, where the unit vector's VJP is its limit below the floor, wn /
1e-12, and the points' VJP zero. Then, with the kernel wrappers replaced by
these plain versions, each autograd function's forward saves exactly when
a gradient needs it, and hands what it saved to K5h.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import accel as JA
from hpsdf_tpu import render as JR
from hpsdf_tpu_torch import accel as TA

import chip_smoke

from .test_torch_point_grad import (RTOL32, RTOL_HVP, TQ, _close, _lo_hi,
                                    _synthetic, trees)  # noqa: F401
from .test_torch_query import few_torch_threads  # noqa: F401


def _normals_pull(jp, p32, wn):
    """jax.vjp of render._normals_at with respect to the points."""
    _, pull = jax.vjp(lambda P: JR._normals_at(jp, P), jnp.asarray(p32))
    return np.asarray(pull(jnp.asarray(wn))[0])


def _values_pull(jp, p32, n, w, u):
    """jax.vjp, with respect to the points, of the values and of
    jax.grad(values_at) at the first n points (the reference's eikonal
    term)."""
    def f(P):
        g = jax.grad(lambda Q: jnp.sum(JA.values_at(jp, Q)))(P[:n])
        return JA.values_at(jp, P), g

    _, pull = jax.vjp(f, jnp.asarray(p32))
    return np.asarray(pull((jnp.asarray(w), jnp.asarray(u)))[0])


def test_saved_keys_name_the_located_rows(trees, few_torch_threads):  # noqa: F811
    """Both saving forwards give the plain forwards' outputs bit for bit
    and ``locate_key_plain``'s keys, and each key names the row ``locate``
    reads."""
    _, _, _, _, tp, pts, _ = trees
    p32 = torch.as_tensor(pts.astype(np.float32))
    n = p32.shape[0] // 2
    nrm, saved = TA.normals_save_plain(tp, p32)
    v, g, keys = TA.values_and_gradient_save_plain(tp, p32, n)
    assert keys.dtype == torch.int32 and keys.shape == (p32.shape[0],)
    assert torch.equal(nrm, TA.normals_plain(tp, p32))
    for a, b in zip((v, g), TA.values_and_gradient_at_plain(tp, p32, n)):
        assert torch.equal(a, b)
    unit = TQ.clip_half(TA.to_unit(tp, p32))
    assert torch.equal(keys, TA.locate_key_plain(tp, unit))
    assert torch.equal(saved[:, 0].contiguous().view(torch.int32), keys)
    assert torch.equal(TA.keyed_rows(tp, keys), TA.locate(tp, unit))


def test_normals_points_vjp_from_saved(trees, few_torch_threads):  # noqa: F811
    """K5h's normals mode from the saved record against jax.vjp of
    render._normals_at (1e-4 of its largest entry), and within 1e-6 of
    autograd of ``normals_plain`` (``normals_vjp_plain``), which locates.
    At degree 0 the gradient is zero: the unit vector's VJP is wn / 1e-12,
    the limit below the floor, and the points' VJP is zero, as the
    reference's."""
    deg, _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    wn = rng.standard_normal(p32.shape).astype(np.float32)
    P, WN = torch.as_tensor(p32), torch.as_tensor(wn)
    _, saved = TA.normals_save_plain(tp, P)
    got = TA.normals_points_vjp_plain(tp, P, saved, WN)
    want = _normals_pull(jp, p32, wn)
    if deg == 0:
        assert not saved[:, 1:].any()
        torch.testing.assert_close(TA._unit_vjp(saved, WN), WN / 1e-12,
                                   rtol=1e-6, atol=0)
        assert not got.any() and not want.any()
        return
    _close(got, want, RTOL_HVP)
    _close(got, TA.normals_vjp_plain(tp, P, WN)[2].numpy(), 1e-6)


def test_values_and_gradient_points_vjp_from_keys(trees,
                                                  few_torch_threads):  # noqa: F811
    """K5h's second mode from the saved keys against jax.vjp of values_at
    and of jax.grad(values_at) on the first n points (1e-4), and within
    1e-6 of autograd of ``values_and_gradient_at_plain``, which locates."""
    _, _, _, jp, tp, pts, rng = trees
    p32 = pts.astype(np.float32)
    n = p32.shape[0] // 2
    w = rng.standard_normal(p32.shape[0]).astype(np.float32)
    u = rng.standard_normal((n, 3)).astype(np.float32)
    P = torch.as_tensor(p32)
    keys = TA.values_and_gradient_save_plain(tp, P, n)[2]
    got = TA.values_and_gradient_points_vjp_plain(
        tp, P, keys, torch.as_tensor(w), torch.as_tensor(u))
    _close(got, _values_pull(jp, p32, n, w, u), RTOL_HVP)
    _close(got, TA.values_and_gradient_vjp_plain(
        tp, P, torch.as_tensor(w), torch.as_tensor(u)).numpy(), 1e-6)


_FACES = [(a, e) for a in range(3) for e in (0, 1)] + [("edge", None)]


@pytest.mark.parametrize("where", _FACES, ids=lambda x: (
    "edge" if x[0] == "edge" else f"axis{x[0]}_{('lo', 'hi')[x[1]]}"))
def test_saved_vjps_face_rule(where, few_torch_threads):  # noqa: F811
    """At points exactly on a face of the root, or on an edge, both VJPs
    from the saved values take jnp.clip's 1/2 on that axis: equal to
    jax.vjp's within 1e-4, and not to the VJP with the clamp's slope taken
    as 1 there."""
    jt, tt = _synthetic(3, seed=3)
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    lo, hi = _lo_hi()
    rng = np.random.default_rng(27)
    p = rng.uniform(lo, hi, (6, 3))
    axis, end = where
    on = [0, 2] if axis == "edge" else [axis]
    if axis == "edge":
        p[:, 0], p[:, 2] = hi[0], lo[2]
    else:
        p[:, axis] = (lo, hi)[end][axis]
    p32 = p.astype(np.float32)
    assert np.all(np.abs(TA.to_unit(tp, torch.as_tensor(p32))[:, on].numpy())
                  == 0.5)
    wn = rng.standard_normal(p32.shape).astype(np.float32)
    w = rng.standard_normal(p32.shape[0]).astype(np.float32)
    P = torch.as_tensor(p32)
    _, saved = TA.normals_save_plain(tp, P)
    keys = TA.values_and_gradient_save_plain(tp, P, 6)[2]
    for got, want in (
            (TA.normals_points_vjp_plain(tp, P, saved, torch.as_tensor(wn)),
             _normals_pull(jp, p32, wn)),
            (TA.values_and_gradient_points_vjp_plain(
                tp, P, keys, torch.as_tensor(w), torch.as_tensor(wn)),
             _values_pull(jp, p32, 6, w, wn))):
        _close(got, want, RTOL_HVP)
        assert np.abs(want[:, on]).max() > 0
        doubled = got.clone()
        doubled[:, on] *= 2
        with pytest.raises(AssertionError):
            _close(doubled, want, RTOL_HVP)


def test_wrong_key_fails(trees, few_torch_threads):  # noqa: F811
    """chip_smoke's wrong key (each point given the key of the point half
    the points away) moves both VJPs beyond 1e-4 wherever they are not
    zero: the check the card's K5h is held to has teeth on the keys."""
    deg, _, _, _, tp, pts, rng = trees
    p32 = torch.as_tensor(pts.astype(np.float32))
    _wrong_key_moves(tp, p32, rng, deg)


def test_wrong_key_fails_in_key_order(trees, few_torch_threads):  # noqa: F811
    """The wrong key's tooth holds with the points in key order too, as the
    card's check of K5h's direct branch (a warp on few rows) gives them,
    where the point before a point mostly shares its key."""
    deg, _, _, _, tp, pts, rng = trees
    p32 = torch.as_tensor(pts.astype(np.float32))
    keys = TA.normals_save_plain(tp, p32)[1][:, 0].contiguous().view(
        torch.int32)
    p32 = p32[torch.argsort(keys, stable=True)]
    _wrong_key_moves(tp, p32, rng, deg)


def test_staged_warps_count_runs():
    """chip_smoke.hvp_staged_warps counts the warps whose keys form more
    than HVP_STAGE_MIN runs, a lane past the end taking key 0, as K5h
    decides its branch."""
    m = chip_smoke.HVP_STAGE_MIN
    warp = [torch.full((32,), 7, dtype=torch.int32),
            torch.arange(32, dtype=torch.int32),
            (torch.arange(32) * (m + 1) // 32).to(torch.int32),
            (torch.arange(32) * m // 32).to(torch.int32),
            torch.tensor([5, 6] * (m // 2), dtype=torch.int32)]
    assert [chip_smoke.hvp_staged_warps(k) for k in warp] == [
        (0, 1), (1, 1), (1, 1), (0, 1), (1, 1)]
    assert chip_smoke.hvp_staged_warps(torch.cat(warp)) == (3, 5)


def _wrong_key_moves(tp, p32, rng, deg):
    """Both VJPs from chip_smoke's wrong key beyond 1e-4 of the right ones
    at the points p32, wherever those are not zero."""
    n = p32.shape[0] // 2
    wn = torch.as_tensor(rng.standard_normal(p32.shape).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal(p32.shape[0]).astype(np.float32))
    _, saved = TA.normals_save_plain(tp, p32)
    keys = TA.values_and_gradient_save_plain(tp, p32, n)[2]
    bad = chip_smoke.wrong_key(keys)
    assert bad.dtype == torch.int32 and not torch.equal(bad, keys)
    bad_saved = saved.clone()
    bad_saved[:, 0] = bad.view(torch.float32)
    for want, wrong in (
            (TA.normals_points_vjp_plain(tp, p32, saved, wn),
             TA.normals_points_vjp_plain(tp, p32, bad_saved, wn)),
            (TA.values_and_gradient_points_vjp_plain(tp, p32, keys, w,
                                                     wn[:n]),
             TA.values_and_gradient_points_vjp_plain(tp, p32, bad, w,
                                                     wn[:n]))):
        if want.any():
            assert chip_smoke.rel_err(wrong, want) > RTOL_HVP
    assert deg <= 1 or TA.normals_points_vjp_plain(tp, p32, saved,
                                                   wn).any()


def _replaced_wrappers(monkeypatch, calls):
    """The kernel wrappers replaced by their plain versions, each call
    recorded in ``calls``: (wrapper, mode or form, what it was given)."""
    def k5(pt, pts, mode, outside_max=False, n_grad=0):
        calls.append(("k5", mode, None))
        if mode == TA.NORMALS_SAVE:
            return TA.normals_save_plain(pt, pts)
        if mode == TA.VALUES_AND_GRAD_SAVE:
            return TA.values_and_gradient_save_plain(pt, pts, n_grad)
        if mode == TA.VALUES_AND_GRAD:
            return TA.values_and_gradient_at_plain(pt, pts, n_grad)
        return TA.normals_plain(pt, pts)

    def k7(pt, pts, cot, form, saved=None):
        calls.append(("k7", form, saved))
        if form == 2:
            return TA.normals_tables_vjp_plain(pt, pts, saved, cot)
        return (TA.values_at_vjp_plain if form == 0
                else TA.point_gradient_vjp_plain)(pt, pts, cot)

    def k5h(pt, pts, mode, w=None, cot3=None, saved=None):
        calls.append(("k5h", mode, saved))
        if mode == TA.NORMALS_VJP:
            return TA.normals_points_vjp_plain(pt, pts, saved, cot3)
        return TA.values_and_gradient_points_vjp_plain(pt, pts, saved, w,
                                                       cot3)

    monkeypatch.setattr(TA, "packed_eval_kernel", k5)
    monkeypatch.setattr(TA, "packed_grad_kernel", k7)
    monkeypatch.setattr(TA, "packed_hvp_kernel", k5h)


def _setup(wants):
    jt, tt = _synthetic(3, seed=3)
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    lo, hi = _lo_hi()
    rng = np.random.default_rng(911)
    p32 = rng.uniform(lo, hi, (200, 3)).astype(np.float32)
    tables = wants in ("tables", "both")
    rows = tp.rows.clone().requires_grad_(tables)
    grid = tp.grid.clone().requires_grad_(tables)
    P = torch.as_tensor(p32).requires_grad_(wants != "tables")
    return jp, dataclasses.replace(tp, rows=rows, grid=grid), rows, grid, \
        P, p32, rng


@pytest.mark.parametrize("wants", ["tables", "points", "both"])
def test_values_and_gradient_forward_saves_keys(wants, monkeypatch,
                                                few_torch_threads):  # noqa: F811
    """_ValuesAndGradient asks for VALUES_AND_GRAD_SAVE and saves (points,
    keys) exactly where the points need a gradient, the points alone
    otherwise; its backward hands the saved keys to K5h, and the points'
    gradient stays within 1e-4 of jax.vjp's."""
    calls = []
    _replaced_wrappers(monkeypatch, calls)
    jp, pk, rows, grid, P, p32, rng = _setup(wants)
    n = 120
    w = rng.standard_normal(p32.shape[0]).astype(np.float32)
    u = rng.standard_normal((n, 3)).astype(np.float32)
    v, g = TA._ValuesAndGradient.apply(rows, grid, P, pk, n)
    saved = v.grad_fn.saved_tensors
    points = wants != "tables"
    assert calls == [("k5", TA.VALUES_AND_GRAD_SAVE if points
                      else TA.VALUES_AND_GRAD, None)]
    assert len(saved) == (2 if points else 1) and saved[0] is P
    ((torch.as_tensor(w) * v).sum() + (torch.as_tensor(u) * g).sum()) \
        .backward()
    hvp = [c for c in calls if c[0] == "k5h"]
    assert len(hvp) == int(points)
    if points:
        assert hvp[0][1] == TA.VALUES_GRAD_VJP and hvp[0][2] is saved[1]
        _close(P.grad, _values_pull(jp, p32, n, w, u), RTOL_HVP)
    assert (rows.grad is not None) == (wants != "points")


@pytest.mark.parametrize("wants", ["tables", "points", "both"])
def test_normals_forward_saves_for_k5h(wants, monkeypatch,
                                       few_torch_threads):  # noqa: F811
    """_Normals (which ``normals`` applies where the tables or the points
    need a gradient) asks for NORMALS_SAVE and hands the saved record to
    K7's form 2 where the tables need a gradient and to K5h where the
    points do; the gradients stay within 1e-5 (tables, coefficient lanes)
    and 1e-4 (points) of jax.vjp of render._normals_at."""
    calls = []
    _replaced_wrappers(monkeypatch, calls)
    jp, pk, rows, grid, P, p32, rng = _setup(wants)
    wn = rng.standard_normal(p32.shape).astype(np.float32)
    n = TA._Normals.apply(rows, grid, P, pk)
    saved = n.grad_fn.saved_tensors
    assert calls == [("k5", TA.NORMALS_SAVE, None)]
    assert len(saved) == 2 and saved[0] is P
    (torch.as_tensor(wn) * n).sum().backward()
    tables, points = wants != "points", wants != "tables"
    assert [c[0] for c in calls[1:]] == ["k7"] * tables + ["k5h"] * points
    assert all(c[2] is saved[1] for c in calls[1:])
    _, pull = jax.vjp(
        lambda r, g, Q: JR._normals_at(dataclasses.replace(jp, rows=r,
                                                           grid=g), Q),
        jp.rows, jp.grid, jnp.asarray(p32))
    want = pull(jnp.asarray(wn))
    C0 = TA.COEFF_LANE
    if tables:
        _close(rows.grad[:, C0:], np.asarray(want[0])[:, C0:], RTOL32)
        _close(grid.grad[:, C0:], np.asarray(want[1])[:, C0:], RTOL32)
    if points:
        _close(P.grad, want[2], RTOL_HVP)


@pytest.mark.parametrize("deg", [0, 3, 5, 12])
def test_k5h_operation_counts(deg):
    """chip_smoke's operation counts a point of K5h from the saved record,
    which set its bound, by hand: the frame (9), the three recurrences and
    their first and second derivatives (30 (deg - 1); the second's 10 only
    where the Hessian is summed), the k-run sums S_0, S_1 and S_2 (an FMA,
    two operations, a term a sum; S_2 only with the Hessian), each kind of
    pair product once a pair (6; 3 without the Hessian) and an FMA a pair
    for each entry summed (6 of the Hessian, 3 of the gradient in the
    values mode), and the chain (40; the unit vector's VJP 20 more in the
    normals mode). Below the replaced kernel's count (``k5h_ops``) but at
    degree 0."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T_ = (deg + 1) * (deg + 2) // 2
    rec = max(deg - 1, 0)
    ops = chip_smoke.k5h_saved_ops
    assert ops(deg, values=False) \
        == 9 + 30 * rec + 2 * 3 * C + 6 * T_ + 2 * 6 * T_ + 40 + 20
    assert ops(deg, values=True) \
        == 9 + 30 * rec + 2 * 3 * C + 6 * T_ + 2 * 9 * T_ + 40
    assert ops(deg, values=True, hess=False) \
        == 9 + 20 * rec + 2 * 2 * C + 3 * T_ + 2 * 3 * T_ + 40
    if deg:
        assert ops(deg, values=False) < chip_smoke.k5h_ops(deg)
        assert ops(deg, values=True) < chip_smoke.k5h_ops(deg)


@pytest.mark.parametrize("entry", ["normals", "values_and_gradient_at"])
def test_entry_points_save_only_for_a_gradient(entry, monkeypatch):
    """On a device other than the CPU the entry points launch the saving
    modes only through their autograd functions, which they apply only
    where a gradient is needed: without one, ``normals`` asks K5 for
    NORMALS and ``values_and_gradient_at`` for VALUES_AND_GRAD."""
    _, tt = _synthetic(2, seed=2)
    tp = TA.pack_tree(tt, grid_depth=1)
    modes, applied = [], []
    monkeypatch.setattr(TA, "packed_eval_kernel",
                        lambda pt, pts, mode, outside_max=False, n_grad=0:
                        modes.append(mode) or "launched")
    fn = {"normals": (TA._Normals, TA.NORMALS,
                      lambda p: TA.normals(tp, p)),
          "values_and_gradient_at": (TA._ValuesAndGradient,
                                     TA.VALUES_AND_GRAD,
                                     lambda p: TA.values_and_gradient_at(
                                         tp, p, 2))}[entry]
    monkeypatch.setattr(fn[0], "apply",
                        lambda *args: applied.append(args) or "applied")
    assert fn[2](torch.zeros((4, 3), device="meta")) == "launched"
    assert modes == [fn[1]] and not applied
    P = torch.zeros((4, 3), device="meta", requires_grad=True)
    assert fn[2](P) == "applied"
    with torch.no_grad():
        assert fn[2](P) == "launched"
    assert modes == [fn[1]] * 2 and len(applied) == 1
