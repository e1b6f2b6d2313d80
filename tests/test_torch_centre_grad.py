"""The derivative of the port's ``query`` and ``query_with_gradient`` with
respect to ``tree.centre``, which K1c (``query_vjp_kernel(...,
centre=True)``) computes on the card, held on CPU tensors (where autograd
differentiates the plain versions K1c is held to) against jax.grad /
jax.vjp of hpsdf_tpu on the same numpy inputs:

  * ``query_centre_vjp_plain`` from the forward's leaf, both
    ``outside_value_max``, and with the unit gradient's cotangent, at basis
    degrees 0, 3, 6 and 12 on ``chip_smoke.synthetic_tree``, at points
    inside the root, on its faces, an edge and corners, and outside;
    within 1e-10 of the reference's largest entry;
  * the clamp: the centres enter after it, so a point on a face takes no
    slope of 1/2, and a point outside moves its leaf's centre; under the
    sentinel only query_with_gradient's unit gradient reaches it there;
  * inside the root, where the clamp's slope is 1, each leaf's centre
    gradient is minus the sum of its points' gradients times the root's
    sizes (the relation K1c's formula and K1v's share);
  * K1c's row range: node blocks of 1, 2, 3 and 5 (``parallel.node_block``)
    each answering the points whose leaf they hold, concatenated, give the
    whole tree's gradient;
  * the autograd functions hand the forward's leaf to one K1c launch,
    with the points' gradient in the same launch where they need one.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import tree as JT
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import parallel as P

import chip_smoke

from .test_torch_query import few_torch_threads, port_config  # noqa: F401

DEGREES = (0, 3, 6, 12)
SPLITS = (1, 2, 3, 5)
RTOL64 = 1e-10
BLOCK_ATOL = 1e-12
N_PTS = 384
# the module, which the package's ``query`` function shadows
TQ = importlib.import_module("hpsdf_tpu_torch.query")
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


def _close(got, want, rtol=RTOL64):
    """Within rtol of the reference's largest entry."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _tree(deg, seed):
    lo, hi = chip_smoke.SYNTH_ROOT
    cfg = hp.Config(continuity=False, root_min=lo, root_max=hi)
    jt = JT.pack(*chip_smoke.synthetic_tree(deg, seed=seed), cfg)
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    return jt, tt


def _points(n, seed):
    """n points over the root grown by a tenth a side, a sixteenth on its
    faces (``chip_smoke.root_points``), then four on an edge and the two
    corners."""
    lo, hi = (np.asarray(x, np.float64) for x in chip_smoke.SYNTH_ROOT)
    rng = np.random.default_rng(seed)
    edge = rng.uniform(lo, hi, (4, 3))
    edge[:, 0], edge[:, 2] = hi[0], lo[2]
    return np.concatenate([chip_smoke.root_points(lo, hi, n, seed, pad=0.1),
                           edge, np.asarray([lo, hi])])


@pytest.fixture(scope="module", params=DEGREES, ids=lambda d: f"deg{d}")
def case(request):
    deg = request.param
    jt, tt = _tree(deg, seed=deg)
    pts = _points(N_PTS, seed=700 + deg)
    rng = np.random.default_rng(800 + deg)
    return deg, jt, tt, pts, rng.standard_normal(pts.shape[0]), \
        rng.standard_normal(pts.shape)


def _masked(v):
    return jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v)


def _jax_query(jt, pts, w, outside_value_max):
    def f(c):
        v = hp.query(dataclasses.replace(jt, centre=c), jnp.asarray(pts),
                     outside_value_max=outside_value_max)
        return jnp.sum(jnp.asarray(w) * (_masked(v) if outside_value_max
                                         else v))
    return np.asarray(jax.grad(f)(jt.centre))


def _jax_query_with_gradient(jt, pts, wv, wn):
    def f(c):
        v, n = hp.query_with_gradient(dataclasses.replace(jt, centre=c),
                                      jnp.asarray(pts))
        return _masked(v), n
    _, pull = jax.vjp(f, jt.centre)
    return np.asarray(pull((jnp.asarray(wv), jnp.asarray(wn)))[0])


@pytest.mark.parametrize("outside_value_max", [True, False])
def test_query_centre_vjp(case, outside_value_max, few_torch_threads):  # noqa: F811
    """K1c's plain version for ``query`` from the forward's leaf: equal to
    the descent's bit for bit and to jax.grad of hpsdf_tpu's query with
    respect to the centres; the entry point's autograd on CPU tensors
    gives it."""
    deg, jt, tt, pts, w, _ = case
    P_ = torch.as_tensor(pts)
    W = torch.as_tensor(w)
    leaf = TQ.query_leaf_plain(tt, P_)
    got = TQ.query_centre_vjp_plain(tt, P_, W, None, outside_value_max,
                                    leaf=leaf)
    np.testing.assert_array_equal(
        got.numpy(), TQ.query_centre_vjp_plain(tt, P_, W, None,
                                               outside_value_max).numpy())
    want = _jax_query(jt, pts, w, outside_value_max)
    assert got.shape == tt.centre.shape
    if deg == 0:            # a constant basis: no frame in the value
        assert not want.any() and not got.any()
        return
    assert np.abs(want).max() > 1.0
    _close(got, want)
    c = tt.centre.clone().requires_grad_(True)
    v = T.query(dataclasses.replace(tt, centre=c), P_, outside_value_max)
    if outside_value_max:
        v = torch.where(v == TQ.OUTSIDE_VALUE, 0.0, v)
    (W * v).sum().backward()
    np.testing.assert_array_equal(c.grad.numpy(), got.numpy())


def test_query_with_gradient_centre_vjp(case, few_torch_threads):  # noqa: F811
    """K1c's plain version for ``query_with_gradient`` (the values'
    cotangent and the unit gradients') from the forward's leaf, against
    jax.vjp of hpsdf_tpu's query_with_gradient with respect to the
    centres; the entry point's autograd gives it. A degree-0 tree has a
    zero gradient everywhere and its frame enters nothing."""
    deg, jt, tt, pts, wv, wn = case
    P_ = torch.as_tensor(pts)
    WV, WN = torch.as_tensor(wv), torch.as_tensor(wn)
    leaf = TQ.query_leaf_plain(tt, P_)
    got = TQ.query_centre_vjp_plain(tt, P_, WV, WN, leaf=leaf)
    np.testing.assert_array_equal(
        got.numpy(), TQ.query_centre_vjp_plain(tt, P_, WV, WN).numpy())
    want = _jax_query_with_gradient(jt, pts, wv, wn)
    if deg == 0:
        assert not want.any() and not got.any()
        return
    assert np.abs(want).max() > 1.0
    _close(got, want)
    c = tt.centre.clone().requires_grad_(True)
    v, n = T.query_with_gradient(dataclasses.replace(tt, centre=c), P_)
    v = torch.where(v == TQ.OUTSIDE_VALUE, 0.0, v)
    ((WV * v).sum() + (WN * n).sum()).backward()
    np.testing.assert_array_equal(c.grad.numpy(), got.numpy())


def _sloped(tt, pts, w, wn, outside_value_max):
    """The centre gradient with the clamp's slope wrongly applied (the
    fault K1c's teeth show, ``chip_smoke.centre_sloped``): minus each
    leaf's points' gradients, which take the slope, times the root's
    sizes."""
    if wn is None:
        d = TQ.query_points_vjp_plain(tt, pts, w, outside_value_max)
    else:
        d = TQ.query_with_gradient_vjp_plain(tt, pts, w, wn)[1]
    return chip_smoke.centre_sloped(tt, TQ.query_leaf_plain(tt, pts), d)


_FACES = [(a, e) for a in range(3) for e in (0, 1)] + [("edge", None)]


@pytest.mark.parametrize("where", _FACES, ids=lambda x: (
    "edge" if x[0] == "edge" else f"axis{x[0]}_{('lo', 'hi')[x[1]]}"))
def test_centre_face_rule(where, few_torch_threads):  # noqa: F811
    """test_face_rule's placements (tests/test_torch_point_grad.py), on a
    face of the root or an edge and then a twentieth of the root beyond
    it: the centre gradients equal jax's there, and take no clamp slope
    (the sloped result differs). Outside the root, with
    ``outside_value_max=False`` the points move their leaf's centre; under
    the sentinel query's gradient there is zero, and only
    query_with_gradient's unit gradient reaches the centre."""
    jt, tt = _tree(3, seed=3)
    lo, hi = (np.asarray(x, np.float64) for x in chip_smoke.SYNTH_ROOT)
    rng = np.random.default_rng(17)
    p = rng.uniform(lo, hi, (6, 3))
    axis, end = where
    on = [0, 2] if axis == "edge" else [axis]
    ends = [hi[0], lo[2]] if axis == "edge" else [(lo, hi)[end][axis]]
    out = p.copy()
    for a, e in zip(on, ends):
        p[:, a] = e
        out[:, a] = e + (0.05 if e == hi[a] else -0.05) * (hi[a] - lo[a])
    w, wn = rng.standard_normal(6), rng.standard_normal((6, 3))
    W, WN = torch.as_tensor(w), torch.as_tensor(wn)
    zero = np.zeros(6)
    for pts in (p, out):
        P_ = torch.as_tensor(pts)
        for ovm in (True, False):
            got = TQ.query_centre_vjp_plain(tt, P_, W, None, ovm)
            _close(got, _jax_query(jt, pts, w, ovm))
            if pts is out and ovm:
                assert not got.any()
            else:
                assert got.abs().max() > 1.0
                assert chip_smoke.rel_err(_sloped(tt, P_, W, None, ovm),
                                          got) > 0.1
        got = TQ.query_centre_vjp_plain(tt, P_, W, WN)
        _close(got, _jax_query_with_gradient(jt, pts, w, wn))
        assert chip_smoke.rel_err(_sloped(tt, P_, W, WN, True), got) > 0.1
        unit_only = TQ.query_centre_vjp_plain(tt, P_, torch.zeros(6), WN)
        values_only = TQ.query_centre_vjp_plain(tt, P_, W,
                                                torch.zeros((6, 3)))
        assert unit_only.abs().max() > 1.0
        assert bool(values_only.any()) == (pts is p)
        _close(unit_only, _jax_query_with_gradient(jt, pts, zero, wn))


def test_centre_is_minus_sizes_times_the_points_inside(case,
                                                       few_torch_threads):  # noqa: F811
    """Strictly inside the root the clamp's slope is 1, and a leaf's centre
    gradient is minus the sum of its points' gradients times the root's
    sizes, for both orders: K1c's dl and K1v's / K1h's are one."""
    deg, _, tt, pts, w, wn = case
    lo, hi = (np.asarray(x, np.float64) for x in chip_smoke.SYNTH_ROOT)
    unit = (pts - 0.5 * (lo + hi)) / (hi - lo)
    keep = np.all(np.abs(unit) < 0.5, axis=1)
    assert 0 < keep.sum() < pts.shape[0]
    P_ = torch.as_tensor(pts[keep])
    W, WN = torch.as_tensor(w[keep]), torch.as_tensor(wn[keep])
    for cot in ((W, None), (W, WN)):
        got = TQ.query_centre_vjp_plain(tt, P_, *cot)
        want = _sloped(tt, P_, *cot, True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-12 * max(float(want.abs().max()),
                                                    1.0))
        assert bool(got.any()) == (deg > 0)


@pytest.mark.parametrize("size", SPLITS)
@pytest.mark.parametrize("form", ["query", "query_inside_out",
                                  "query_with_gradient"])
def test_k1c_blocks_concatenate_to_the_vjp(size, form, few_torch_threads):  # noqa: F811
    """K1c's row range: on node blocks of the tree (``parallel.
    node_block``), each from the global leaves answering the points whose
    leaf it holds, the blocks' centre gradients concatenated are the whole
    tree's, and jax's, within 1e-12 of the largest entry."""
    jt, tt = _tree(3, seed=30)
    pts = _points(N_PTS, seed=31)
    rng = np.random.default_rng(32)
    P_ = torch.as_tensor(pts)
    W = torch.as_tensor(rng.standard_normal(pts.shape[0]))
    WN = torch.as_tensor(rng.standard_normal(pts.shape)) \
        if form == "query_with_gradient" else None
    ovm = form != "query_inside_out"
    leaf = TQ.query_leaf_plain(tt, P_)
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    got = torch.cat([TQ.query_centre_vjp_plain(b, P_, W, WN, ovm, leaf=leaf)
                     for b in blocks])
    assert max(b.hi - b.lo for b in blocks) == -(-got.shape[0] // size)
    want = TQ.query_centre_vjp_plain(tt, P_, W, WN, ovm)
    _close(got, want.numpy(), BLOCK_ATOL)
    _close(got, _jax_query(jt, pts, W.numpy(), ovm) if WN is None
           else _jax_query_with_gradient(jt, pts, W.numpy(), WN.numpy()),
           BLOCK_ATOL)


@pytest.mark.parametrize("wants", ["centre", "centre_points",
                                   "centre_coeffs"])
@pytest.mark.parametrize("entry", ["query", "query_with_gradient"])
def test_autograd_functions_launch_k1c(entry, wants, monkeypatch,
                                       few_torch_threads):  # noqa: F811
    """With the kernel wrappers replaced by plain stand-ins, _Query and
    _QueryWithGradient ask K1 for the leaf when the centres need a
    gradient, hand it to one K1c launch (the points' gradient in the same
    launch where they need one, K1v / K1h not launched), and give autograd
    of the plain versions' gradients."""
    _, tt = _tree(3, seed=40)
    pts = _points(64, seed=41)
    rng = np.random.default_rng(42)
    calls = {"k1": [], "vjp": []}

    def k1(tree, p, with_grad, outside_value_max=True, with_leaf=False):
        calls["k1"].append((with_grad, with_leaf))
        out = TQ.query_with_gradient_plain(tree, p) if with_grad \
            else (TQ.query_plain(tree, p, outside_value_max),)
        if with_leaf:
            calls["leaf"] = TQ.query_leaf_plain(tree, p)
            out += (calls["leaf"],)
        return out if len(out) > 1 else out[0]

    def k1_vjp(tree, p, leaf, w, wn=None, outside_value_max=True, *,
               points=True, centre=False):
        calls["vjp"].append((leaf, points, centre))
        d_c = TQ.query_centre_vjp_plain(tree, p, w, wn, outside_value_max,
                                        leaf=leaf)
        if wn is None:
            d_p = TQ.query_points_vjp_plain(tree, p, w, outside_value_max,
                                            leaf=leaf)
        else:
            d_p = TQ.query_with_gradient_vjp_plain(tree, p, w, wn,
                                                   leaf=leaf)[1]
        return (d_p, d_c) if points else d_c

    monkeypatch.setattr(TQ, "query_kernel", k1)
    monkeypatch.setattr(TQ, "query_vjp_kernel", k1_vjp)
    monkeypatch.setattr(TQ, "coeff_scatter_kernel",
                        lambda tree, w, pts, outside_value_max:
                        TQ.query_vjp_plain(tree, pts, w, outside_value_max))
    monkeypatch.setattr(TQ, "coeff_scatter_grad_kernel",
                        lambda tree, p, wv, wn:
                        TQ.query_with_gradient_vjp_plain(tree, p, wv, wn)[0])
    hess = entry == "query_with_gradient"
    cots = (torch.as_tensor(rng.standard_normal(pts.shape[0])),
            torch.as_tensor(rng.standard_normal(pts.shape)))

    def run(apply):
        C = tt.coeffs.detach().clone().requires_grad_(wants == "centre_coeffs")
        X = tt.centre.detach().clone().requires_grad_(True)
        Pt = torch.as_tensor(pts).requires_grad_(wants == "centre_points")
        out = apply(C, X, Pt) if hess else (apply(C, X, Pt),)
        out = (torch.where(out[0] == TQ.OUTSIDE_VALUE, 0.0, out[0]),) \
            + out[1:]
        loss = sum((c * o).sum() for c, o in zip(cots, out))
        return torch.autograd.grad(loss, [x for x in (C, X, Pt)
                                          if x.requires_grad])

    def tree_of(C, X):
        return dataclasses.replace(tt, coeffs=C, centre=X)

    got = run(lambda C, X, Pt: TQ._QueryWithGradient.apply(
        C, tree_of(C, X), Pt, X) if hess
        else TQ._Query.apply(C, tree_of(C, X), Pt, True, X))
    want = run(lambda C, X, Pt: TQ.query_with_gradient_plain(
        tree_of(C, X), Pt) if hess else TQ.query_plain(tree_of(C, X), Pt))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-12 * max(float(w.abs().max()),
                                                    1.0))
    points = wants == "centre_points"
    assert calls["k1"] == [(hess, True)]
    assert len(calls["vjp"]) == 1
    leaf, p_asked, c_asked = calls["vjp"][0]
    assert leaf is calls["leaf"] and c_asked and p_asked == points


@pytest.mark.parametrize("hess", [False, True], ids=["query",
                                                     "query_with_gradient"])
def test_k1c_teeth_and_bound(hess, few_torch_threads):  # noqa: F811
    """chip_smoke's wrong result for K1c, the clamp's slope applied
    (``centre_sloped`` from the points' gradient), fails the check the
    right one passes (``grad2_teeth``, with a moved entry); K1c's bound
    (``centre_bound``) counts K1v's / K1h's reads and the (N, 3) table
    written once, and K1v's / K1h's operations."""
    _, tt = _tree(3, seed=50)
    P_ = torch.as_tensor(_points(N_PTS, seed=51))
    rng = np.random.default_rng(52)
    W = torch.as_tensor(rng.standard_normal(P_.shape[0]))
    cots = (W, torch.as_tensor(rng.standard_normal(P_.shape))) if hess \
        else (W,)
    leaf = TQ.query_leaf_plain(tt, P_)
    want = TQ.query_centre_vjp_plain(tt, P_, *cots, leaf=leaf)
    d_pts = TQ.query_with_gradient_vjp_plain(tt, P_, *cots, leaf=leaf)[1] \
        if hess else TQ.query_points_vjp_plain(tt, P_, W, leaf=leaf)
    sloped = chip_smoke.centre_sloped(tt, leaf, d_pts)
    tol = chip_smoke.GRAD2_RTOL64
    assert chip_smoke.rel_err(want.clone(), want) <= tol
    assert chip_smoke.grad2_teeth(want.clone(), want, tol,
                                  sloped=sloped) == [True, True]
    bound, by, by_bytes, by_ops = chip_smoke.centre_bound(tt, P_, cots,
                                                          hess)
    B, N = P_.shape[0], tt.centre.shape[0]
    C = tt.coeffs.shape[1]
    n_bytes = N * (24 + 4 + 8 * C) + B * (24 + 8 * (1 + 3 * hess) + 4) \
        + 24 * N
    assert by_bytes == pytest.approx(n_bytes / chip_smoke.HBM_RATE * 1e3,
                                     rel=1e-12)
    ops = (chip_smoke.k1h_ops if hess else chip_smoke.k1v_ops)(3, 0)
    assert by_ops == pytest.approx(B * ops / chip_smoke.F64_PEAK * 1e3,
                                   rel=1e-12)
    assert bound == max(by_bytes, by_ops)
    assert by == ("bytes" if by_bytes >= by_ops else "operations")
