"""K1v and K1h from the forward's leaf, held on CPU tensors.

On the card the backward modes of K1 (``query_vjp_kernel``) start from the
leaf the forward wrote (``query_kernel(..., with_leaf=True)``) and run no
descent. Their plain versions are ``query_points_vjp_plain`` and
``query_with_gradient_vjp_plain`` given that leaf. Here, at basis degrees
0-12 on ``chip_smoke.synthetic_tree``, with a sixteenth of the points on
the root's faces and some outside it:

  * the leaf-given plain versions equal the re-descending ones bit for bit
    (the leaf is the descent's, from the same f64 decisions), and jax.vjp
    of hpsdf_tpu's ``query`` / ``query_with_gradient`` within 1e-10 of the
    reference's largest entry (sums reorder);
  * the forward's leaf (``query_leaf_plain``) is hpsdf_tpu's ``descend`` of
    the clamped points;
  * a wrong leaf (``chip_smoke.wrong_leaf``) changes both VJPs;
  * the autograd functions ask K1 for the leaf only when the points need a
    gradient, and hand that leaf to the backward.
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

import chip_smoke

from .test_torch_query import few_torch_threads, port_config  # noqa: F401

RTOL64 = 1e-10
N_PTS = 256
# the modules, which the packages' ``query`` functions shadow
JQ = importlib.import_module("hpsdf_tpu.query")
TQ = importlib.import_module("hpsdf_tpu_torch.query")
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


def _case(deg, n=N_PTS):
    """hpsdf_tpu's and the port's synthetic tree of degree ``deg``, and
    ``n`` points over the root grown by a tenth a side, a sixteenth of them
    on its faces."""
    lo, hi = chip_smoke.SYNTH_ROOT
    cfg = hp.Config(continuity=False, root_min=lo, root_max=hi)
    jt = JT.pack(*chip_smoke.synthetic_tree(deg, seed=deg), cfg)
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    pts = chip_smoke.root_points(lo, hi, n, seed=500 + deg, pad=0.1)
    return jt, tt, pts, np.random.default_rng(600 + deg)


def _close(got, want, rtol=RTOL64):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rtol * scale)


def _masked(v):
    return jnp.where(v == jnp.finfo(jnp.float64).max, 0.0, v)


@pytest.mark.parametrize("deg", range(13))
def test_leaf_given_query_vjp(deg, few_torch_threads):  # noqa: F811
    """K1v's plain version from the forward's leaf: bit for bit the
    re-descending one, and jax.grad of hpsdf_tpu's query (its sentinel a
    constant) within RTOL64, with and without outside_value_max."""
    jt, tt, pts, rng = _case(deg)
    P = torch.as_tensor(pts)
    w = rng.standard_normal(pts.shape[0])
    leaf = TQ.query_leaf_plain(tt, P)
    unit = (pts - 0.5 * np.add(*chip_smoke.SYNTH_ROOT)) \
        / np.subtract(chip_smoke.SYNTH_ROOT[1], chip_smoke.SYNTH_ROOT[0])
    assert (np.abs(unit) == 0.5).any(axis=1).sum() >= N_PTS // 16
    assert (np.abs(unit) > 0.5).any(axis=1).any()
    for ovm in (True, False):
        got = TQ.query_points_vjp_plain(tt, P, torch.as_tensor(w), ovm,
                                        leaf=leaf)
        again = TQ.query_points_vjp_plain(tt, P, torch.as_tensor(w), ovm)
        np.testing.assert_array_equal(got.numpy(), again.numpy())
        want = jax.grad(lambda Q: jnp.sum(jnp.asarray(w) * (
            _masked(hp.query(jt, Q)) if ovm
            else hp.query(jt, Q, outside_value_max=False))))(
                jnp.asarray(pts))
        _close(got, want)


@pytest.mark.parametrize("deg", range(13))
def test_leaf_given_query_with_gradient_vjp(deg, few_torch_threads):  # noqa: F811
    """K1h's plain version from the forward's leaf: bit for bit the
    re-descending one, to the points and to the coefficients, and jax.vjp
    of hpsdf_tpu's query_with_gradient to the points within RTOL64 (at
    degree 0 both are zero)."""
    jt, tt, pts, rng = _case(deg)
    P = torch.as_tensor(pts)
    wv = rng.standard_normal(pts.shape[0])
    wn = rng.standard_normal(pts.shape)
    cots = (torch.as_tensor(wv), torch.as_tensor(wn))
    got = TQ.query_with_gradient_vjp_plain(
        tt, P, *cots, leaf=TQ.query_leaf_plain(tt, P))
    again = TQ.query_with_gradient_vjp_plain(tt, P, *cots)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.numpy(), a.numpy())
    _, pull = jax.vjp(lambda Q: (lambda v, n: (_masked(v), n))(
        *hp.query_with_gradient(jt, Q)), jnp.asarray(pts))
    (want,) = pull((jnp.asarray(wv), jnp.asarray(wn)))
    _close(got[1], want)


@pytest.mark.parametrize("deg", [0, 1, 3, 5, 8, 12])
def test_forward_leaf_is_the_descent(deg, few_torch_threads):  # noqa: F811
    """The leaf K1 writes for the backward (its plain version
    query_leaf_plain) is hpsdf_tpu's descend of the points clamped into
    the root, faces and outside points included."""
    jt, tt, pts, _ = _case(deg)
    got = TQ.query_leaf_plain(tt, torch.as_tensor(pts))
    unit = JQ._to_unit(jt, jnp.asarray(pts))
    want = JQ.descend(jt, jnp.clip(unit, -0.5, 0.5))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((tt.child_idx[got.long()] < 0).all())


@pytest.mark.parametrize("deg", [1, 3, 5, 12])
def test_wrong_leaf_changes_the_vjps(deg, few_torch_threads):  # noqa: F811
    """The leaf is an input of K1v and K1h, not a hint: chip_smoke's wrong
    leaf (each point given another point's leaf) moves both VJPs by more
    than the tolerance the card's checks hold them to."""
    _, tt, pts, rng = _case(deg)
    P = torch.as_tensor(pts)
    w = torch.as_tensor(rng.standard_normal(pts.shape[0]))
    wn = torch.as_tensor(rng.standard_normal(pts.shape))
    leaf = TQ.query_leaf_plain(tt, P)
    bad = chip_smoke.wrong_leaf(leaf)
    assert bad.dtype == leaf.dtype and bool((bad != leaf).any())
    assert bool((tt.child_idx[bad.long()] < 0).all())
    for fn in (lambda lf: TQ.query_points_vjp_plain(tt, P, w, leaf=lf),
               lambda lf: TQ.query_with_gradient_vjp_plain(
                   tt, P, w, wn, leaf=lf)[1]):
        right, wrong = fn(leaf), fn(bad)
        assert chip_smoke.rel_err(wrong, right) > chip_smoke.GRAD2_RTOL64


@pytest.mark.parametrize("wants", ["points", "coeffs", "both"])
@pytest.mark.parametrize("entry", ["query", "query_with_gradient"])
def test_autograd_functions_hand_the_leaf_on(entry, wants, monkeypatch,
                                             few_torch_threads):  # noqa: F811
    """With the kernel wrappers replaced by plain stand-ins, _Query and
    _QueryWithGradient ask K1 for the leaf only when the points need a
    gradient, pass that very tensor to K1v / K1h, and give autograd of the
    plain versions' gradients; when only the coefficients need one, the
    forward is K1 without the leaf and no backward mode runs."""
    _, tt, pts, rng = _case(3, n=64)
    calls = {"k1": [], "vjp": []}

    def k1(tree, p, with_grad, outside_value_max=True, with_leaf=False):
        calls["k1"].append((with_grad, with_leaf))
        out = TQ.query_with_gradient_plain(tree, p) if with_grad \
            else (TQ.query_plain(tree, p, outside_value_max),)
        if with_leaf:
            calls["leaf"] = TQ.query_leaf_plain(tree, p)
            out += (calls["leaf"],)
        return out if len(out) > 1 else out[0]

    def k1_vjp(tree, p, leaf, w, wn=None, outside_value_max=True):
        calls["vjp"].append(leaf)
        if wn is None:
            return TQ.query_points_vjp_plain(tree, p, w, outside_value_max,
                                             leaf=leaf)
        return TQ.query_with_gradient_vjp_plain(tree, p, w, wn,
                                                leaf=leaf)[1]

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
        C = tt.coeffs.detach().clone().requires_grad_(wants != "points")
        P = torch.as_tensor(pts).requires_grad_(wants != "coeffs")
        out = apply(C, P) if hess else (apply(C, P),)
        loss = sum((c * o).sum() for c, o in zip(cots, out))
        inputs = [x for x in (C, P) if x.requires_grad]
        return torch.autograd.grad(loss, inputs)

    got = run(lambda C, P: TQ._QueryWithGradient.apply(C, tt, P, tt.centre)
              if hess else TQ._Query.apply(C, tt, P, True, tt.centre))
    want = run(lambda C, P: TQ.query_with_gradient_plain(
        dataclasses.replace(tt, coeffs=C), P) if hess
        else TQ.query_plain(dataclasses.replace(tt, coeffs=C), P))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    points = wants != "coeffs"
    assert calls["k1"] == [(hess, points)]
    if points:
        assert len(calls["vjp"]) == 1 and calls["vjp"][0] is calls["leaf"]
    else:
        assert calls["vjp"] == [] and "leaf" not in calls
