"""Kernel K13's plain versions (hpsdf_tpu_torch.inverse: what CPU tensors
take) against the formula fit_to_depth ran before them and against
hpsdf_tpu.inverse.

- The points: ``inverse_points_plain`` is bit for bit the points of
  hpsdf_tpu inverse.py ``chunk_field`` (its formula and order, in numpy
  f32: every operation rounded on its own, as torch's are).
- The cotangents: ``chunk_terms_plain`` writes the VJP by hand; on seeded
  values, gradients, masks and depths (with rays on relu's kink, where
  torch's derivative is 0, and padded rays) its (df, dg, dt), each times
  its normaliser (surf_n, surf_n, dn: the loss's units before the terms are
  averaged), equal ``torch.autograd.grad`` of the formula
  (``chip_smoke.formula_terms``) within 1e-6 relative, 1e-7 absolute (the
  two round in other orders), its loss within 1e-6 relative.
- The backward: ``chunk_terms_vjp_plain`` (what ``_ChunkTerms.backward``
  takes on CPU tensors, as K13's VJP launch takes it on the card) is
  ``chunk_terms_plain``'s cotangents times the loss's cotangent bit for
  bit, for go a number or a 0-d tensor.
- One step: ``fit_to_depth``'s coefficients after one step equal
  ``hpsdf_tpu``'s within 1e-5 of the largest coefficient change (Adam's
  first step moves each coefficient by about lr times the sign of its
  gradient, so this holds the gradients' signs and their ratio to Adam's
  eps), on tests/test_torch_inverse.py's trees and rays."""

import numpy as np
import pytest
import torch

from hpsdf_tpu import inverse as JI
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import _kernels
from hpsdf_tpu_torch import inverse as TI

import chip_smoke
from chip_smoke import K13_TERM_LAUNCHES
from .test_torch_inverse import _rays, trees  # noqa: F401
from .test_torch_query import few_torch_threads  # noqa: F401

COT_RTOL, COT_ATOL = 1e-6, 1e-7
LOSS_RTOL = 1e-6
STEP_RTOL = 1e-5
WEIGHTS = {"defaults": (1.0, 0.1, 0.1), "others": (0.7, 0.35, 2.0)}


def _rays_np(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tt = rng.uniform(0.0, 3.0, n).astype(np.float32)
    return (torch.as_tensor(x) for x in (o, d, tt))


def _reference_points(o, d, tt):
    """hpsdf_tpu inverse.py chunk_field's points in numpy f32: surface, in
    (want f <= -band/2) and out (want f >= +band/2), then the free-space
    points fraction-major, in its order (band_pts, then free_pts)."""
    o, d, tt = (np.asarray(x, np.float32) for x in (o, d, tt))
    band = np.float32(0.02)
    fracs = np.asarray([0.35, 0.6, 0.8, 0.93], np.float32)
    surf = o + tt[..., None] * d
    out_p = o + (tt - band)[..., None] * d
    in_p = o + (tt + band)[..., None] * d
    free = o[None] + (fracs[:, None, None] * tt[None, :, None]) * d[None]
    return torch.as_tensor(np.concatenate([surf, in_p, out_p,
                                           free.reshape(-1, 3)]))


@pytest.mark.parametrize("n", [1, 37, 400])
def test_points_bit_equal_to_the_formula(n):
    o, d, tt = _rays_np(n, seed=n)
    want = _reference_points(o, d, tt)
    assert (TI.BAND, TI.FRACS) == (0.02, (0.35, 0.6, 0.8, 0.93))
    got = TI.inverse_points_plain(o, d, tt)
    assert got.shape == (7 * n, 3) and got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(TI.inverse_points(o, d, tt), want)


def _chunk(n, seed, pad):
    """Seeded inputs of chunk_terms: values about the band, gradients of
    norm about 1 (some 0), depths, masks; some rays on relu's kink (f_in +
    half, half - f_out, half - f_free exactly 0) and the last ``pad`` rays
    padded as _padded_chunks pads them (target hit false, tt 0)."""
    rng = np.random.default_rng(seed)
    half = np.float32(TI.BAND) * np.float32(0.5)
    f = rng.uniform(-0.03, 0.03, 7 * n).astype(np.float32)
    f[n:n + 5] = -half
    f[2 * n + 5:2 * n + 10] = half
    f[3 * n + 10:3 * n + 15] = half
    g = (rng.normal(size=(3 * n, 3)) * 0.6).astype(np.float32)
    g[:4] = 0.0
    th = rng.uniform(size=n) < 0.7
    hit = rng.uniform(size=n) < 0.8
    t = rng.uniform(0.5, 2.5, n).astype(np.float32)
    tt = (t + rng.normal(size=n) * 0.05).astype(np.float32)
    th[n - pad:] = False
    tt[n - pad:] = 0.0
    dn = np.float32(max((hit & th).sum(), 1))
    surf_n = np.float32(max(th.sum(), 1))
    return [torch.as_tensor(x) for x in (f, g, th, hit, t, tt)] + [
        torch.tensor(dn), torch.tensor(surf_n)]


@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("n, seed", [(64, 0), (300, 1), (1000, 2)])
def test_cotangents_equal_autograd_of_the_formula(n, seed, weights):
    f, g, th, hit, t, tt, dn, surf_n = _chunk(n, seed, pad=n // 8)
    w = WEIGHTS[weights]
    loss, df, dg, dt = TI.chunk_terms_plain(f, g, th, hit, t, tt, dn, surf_n,
                                            *w)
    fr, gr, tr = (x.clone().requires_grad_(True) for x in (f, g, t))
    want = chip_smoke.formula_terms(fr, gr, th, hit, tr, tt, dn, surf_n, *w)
    wf, wg, wt = torch.autograd.grad(want, (fr, gr, tr))
    assert loss.dtype == df.dtype == dg.dtype == dt.dtype == torch.float32
    assert (df.shape, dg.shape, dt.shape) == ((7 * n,), (3 * n, 3), (n,))
    np.testing.assert_allclose(float(loss), float(want.detach()),
                               rtol=LOSS_RTOL)
    for got, ref, norm in ((df, wf, surf_n), (dg, wg, surf_n), (dt, wt, dn)):
        np.testing.assert_allclose((got * norm).numpy(),
                                   (ref * norm).numpy(), rtol=COT_RTOL,
                                   atol=COT_ATOL)
    # padded rays, rays off target and relu's kink: exactly zero
    off = ~th
    assert not bool(df.view(7, n)[:, off].any())
    assert not bool(dg.view(3, n, 3)[:, off].any())
    assert not bool(dt[~(hit & th)].any())
    assert not bool(df[n:n + 5].any()) and not bool(df[2 * n + 5:2 * n + 10]
                                                     .any())
    assert not bool(df[3 * n + 10:3 * n + 15].any())


def test_chunk_terms_function_scales_by_the_cotangent():
    n = 200
    f, g, th, hit, t, tt, dn, surf_n = _chunk(n, 3, pad=9)
    fr, gr, tr = (x.clone().requires_grad_(True) for x in (f, g, t))
    loss = TI._ChunkTerms.apply(fr, gr, tr, th, hit, tt, dn, surf_n,
                                WEIGHTS["defaults"])
    got = torch.autograd.grad(2.5 * loss, (fr, gr, tr))
    fr2, gr2, tr2 = (x.clone().requires_grad_(True) for x in (f, g, t))
    want = torch.autograd.grad(2.5 * chip_smoke.formula_terms(
        fr2, gr2, th, hit, tr2, tt, dn, surf_n, *WEIGHTS["defaults"]),
        (fr2, gr2, tr2))
    for a, b, norm in zip(got, want, (surf_n, surf_n, dn)):
        np.testing.assert_allclose((a * norm).numpy(), (b * norm).numpy(),
                                   rtol=COT_RTOL, atol=COT_ATOL)


@pytest.mark.parametrize("go", ["one", "0.37", "tensor"])
@pytest.mark.parametrize("weights", sorted(WEIGHTS))
@pytest.mark.parametrize("n, seed", [(1, 7), (64, 8), (1000, 9)])
def test_vjp_plain_is_the_cotangents_times_go(n, seed, weights, go):
    args = _chunk(n, seed, pad=n // 8) + list(WEIGHTS[weights])
    _, df, dg, dt = TI.chunk_terms_plain(*args)
    go = {"one": 1.0, "0.37": 0.37,
          "tensor": torch.tensor(np.float32(-2.718))}[go]
    got = TI.chunk_terms_vjp_plain(*args, go)
    go32 = torch.as_tensor(go, dtype=torch.float32)
    for a, b in zip(got, (df, dg, dt)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert torch.equal(a.view(torch.int32), (b * go32).view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(
        TI.chunk_terms_vjp(*args, go=go32), got))
    if go == 1.0:
        assert all(torch.equal(a, b) for a, b in zip(
            TI.chunk_terms_vjp(*args, go=1.0), (df, dg, dt)))


def test_chunk_terms_function_backward_is_the_vjp_plain():
    """_ChunkTerms on CPU tensors: the forward's loss is chunk_terms_plain's,
    the backward's gradients chunk_terms_vjp_plain's at the loss's
    cotangent, bit for bit; chunk_terms_loss is the plain loss."""
    n = 300
    f, g, th, hit, t, tt, dn, surf_n = _chunk(n, 11, pad=5)
    w = WEIGHTS["others"]
    fr, gr, tr = (x.clone().requires_grad_(True) for x in (f, g, t))
    loss = TI._ChunkTerms.apply(fr, gr, tr, th, hit, tt, dn, surf_n, w)
    plain = TI.chunk_terms_plain(f, g, th, hit, t, tt, dn, surf_n, *w)
    assert torch.equal(loss.detach(), plain[0])
    assert torch.equal(TI.chunk_terms_loss(f, g, th, hit, t, tt, dn, surf_n,
                                           *w), plain[0])
    got = torch.autograd.grad(loss * np.float32(0.37), (fr, gr, tr))
    want = TI.chunk_terms_vjp_plain(f, g, th, hit, t, tt, dn, surf_n, *w,
                                    torch.tensor(np.float32(0.37)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_route_launches_nothing_and_kernels_refuse_cpu():
    TI.inverse_points_kernel.launches = 0
    TI.inverse_loss_kernel.launches = 0
    TI.inverse_vjp_kernel.launches = 0
    o, d, tt = _rays_np(16, seed=5)
    TI.inverse_points(o, d, tt)
    args = _chunk(16, 4, pad=2)
    TI.chunk_terms(*args[:6], args[6], args[7], *WEIGHTS["defaults"])
    TI.chunk_terms_loss(*args, *WEIGHTS["defaults"])
    TI.chunk_terms_vjp(*args, *WEIGHTS["defaults"], go=torch.tensor(2.0))
    assert TI.inverse_points_kernel.launches == 0
    assert TI.inverse_loss_kernel.launches == 0
    assert TI.inverse_vjp_kernel.launches == 0
    with pytest.raises(ValueError, match="CUDA"):
        TI.inverse_points_kernel(o, d, tt)
    with pytest.raises(ValueError, match="CUDA"):
        TI.inverse_loss_kernel(*args, *WEIGHTS["defaults"])
    with pytest.raises(ValueError, match="CUDA"):
        TI.inverse_vjp_kernel(*args, *WEIGHTS["defaults"],
                              go=torch.tensor(1.0))


@pytest.mark.parametrize("param_space", ["folded", "raw"])
@pytest.mark.parametrize("side", [8, 20])
def test_one_step_coefficients_match_reference(trees, param_space, side):  # noqa: F811
    (ji, ti), (jo, _) = trees
    o, d = _rays(side)
    tt, th = (np.asarray(x) for x in JI.render_targets(jo, o, d, t_max=5.0))
    kw = dict(n_steps=1, lr=1e-3, t_max=5.0, param_space=param_space)
    c0 = np.asarray(ji.coeffs, np.float64)
    want = np.asarray(JI.fit_to_depth(ji, o, d, tt, th, **kw).tree.coeffs,
                      np.float64)
    TI.inverse_loss_kernel.launches = 0
    TI.inverse_vjp_kernel.launches = 0
    got = T.inverse.fit_to_depth(ti, o, d, tt, th, **kw).tree.coeffs
    assert TI.inverse_loss_kernel.launches == 0
    assert TI.inverse_vjp_kernel.launches == 0
    change = np.abs(want - c0).max()
    assert change > 0
    err = np.abs(got.numpy().astype(np.float64) - want).max()
    assert err <= STEP_RTOL * change, (err, change)


def test_k13_check_fails_every_mutation():
    """chip_smoke.k13_vjp_differ counts the VJP's entries whose bits differ
    from the replaced cotangents times go; each of k13_teeth's wrong VJPs
    differs, on the plain version's cotangents (a stand-in for both
    kernels' on the card). The replaced kernel stays a check: its entry
    point is bound only by the check library."""
    args = _chunk(500, 12, pad=20) + list(WEIGHTS["defaults"])
    _, *ref = TI.chunk_terms_plain(*args)
    go = torch.tensor(np.float32(1.7))
    got = TI.chunk_terms_vjp_plain(*args, go)
    assert chip_smoke.k13_vjp_differ(got, ref, go) == 0
    assert chip_smoke.k13_vjp_differ(ref, ref, go) > 0
    teeth = chip_smoke.k13_teeth(got, ref, go)
    assert len(teeth) == 3 and all(teeth.values())
    assert "hpsdf_inverse_terms_reference" in _kernels._CHECK_SIGNATURES
    assert "hpsdf_inverse_terms_reference" not in _kernels._SIGNATURES
    assert K13_TERM_LAUNCHES == 2
