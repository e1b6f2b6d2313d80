"""The inverse chunk's one read of values and raw gradients
(``accel.values_and_gradient_at``, hpsdf_tpu_torch on CPU tensors: the
plain versions that the fused mode of K2/K5 and K7's two forms are held to
on the card) against jax.grad on hpsdf_tpu, on the same numpy inputs, at
basis degrees 1, 3 and 5 on ``chip_smoke.synthetic_tree`` (points
straddling the root); the points ``inverse.chunk_loss`` reads with it; and
chip_smoke.py's helpers around K8: the nodes a descent visits
(``node_walk``), the bytes in K8's bound (``coeff_scatter_bytes``) and the
inverse step's chunks with their depth cotangents (``inverse_chunks``).

Tolerances, relative to the largest entry of the reference (sums
reorder): 1e-5 in f32, as tests/test_torch_grad.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import tree as JT
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import inverse as TI
from hpsdf_tpu_torch import tree as TT
from hpsdf_tpu_torch.query import descend

import chip_smoke

from .test_torch_query import few_torch_threads, port_config  # noqa: F401

DEGREES = (1, 3, 5)
N_PTS = 600
RTOL32 = 1e-5
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")
C0 = TA.COEFF_LANE


def _close(got, want, rtol=RTOL32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
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
    rng = np.random.default_rng(300 + deg)
    pts = rng.uniform(lo - pad, hi + pad, (N_PTS, 3)).astype(np.float32)
    return jp, tp, tt, pts, rng


@pytest.mark.parametrize("n_grad", [0, N_PTS // 3, N_PTS])
def test_values_and_gradient_at(trees, n_grad):
    """The values at every point and the raw gradients at the first
    n_grad, against hpsdf_tpu's values_at and jax.grad of it."""
    jp, tp, _, pts, _ = trees
    P = jnp.asarray(pts)
    v, g = TA.values_and_gradient_at(tp, torch.as_tensor(pts), n_grad)
    assert v.shape == (N_PTS,) and g.shape == (n_grad, 3)
    _close(v, JA.values_at(jp, P))
    want = jax.grad(lambda Q: jnp.sum(JA.values_at(jp, Q)))(P[:n_grad])
    _close(g, want)


def test_values_and_gradient_at_grad(trees):
    """Its VJP to the tables (K7's form 0 at every point plus form 1 at the
    first n_grad on the card), against jax.grad of the same sum of both
    reads, on the coefficient lanes; the meta lanes take none."""
    jp, tp, _, pts, rng = trees
    n = N_PTS // 2
    w = rng.standard_normal(N_PTS).astype(np.float32)
    u = rng.standard_normal((n, 3)).astype(np.float32)
    P = jnp.asarray(pts)

    def f(rows, grid):
        pk = dataclasses.replace(jp, rows=rows, grid=grid)
        g = jax.grad(lambda Q: jnp.sum(JA.values_at(pk, Q)))(P[:n])
        return (jnp.sum(jnp.asarray(w) * JA.values_at(pk, P))
                + jnp.sum(jnp.asarray(u) * g))

    want = jax.grad(f, argnums=(0, 1))(jp.rows, jp.grid)
    rows = tp.rows.clone().requires_grad_(True)
    grid = tp.grid.clone().requires_grad_(True)
    pk = dataclasses.replace(tp, rows=rows, grid=grid)
    v, g = TA.values_and_gradient_at(pk, torch.as_tensor(pts), n)
    ((torch.as_tensor(w) * v).sum() + (torch.as_tensor(u) * g).sum()) \
        .backward()
    _close(rows.grad[:, C0:], np.asarray(want[0])[:, C0:])
    _close(grid.grad[:, C0:], np.asarray(want[1])[:, C0:])
    assert not rows.grad[:, :C0].any() and not grid.grad[:, :C0].any()


def test_values_and_gradient_at_refuses(monkeypatch):
    """n_grad outside [0, B] raises; on a device other than the CPU a
    gradient with respect to the points goes through the autograd function
    (whose backward to the points is K5h), and the fused mode's wrapper
    launches on CUDA tensors or raises."""
    tree = TT.pack(*chip_smoke.synthetic_tree(2, seed=1),
                   T.Config(continuity=False,
                            root_min=chip_smoke.SYNTH_ROOT[0],
                            root_max=chip_smoke.SYNTH_ROOT[1]), device="cpu")
    pt = TA.pack_tree(tree, grid_depth=1)
    pts = torch.zeros((4, 3))
    for bad in (-1, 5):
        with pytest.raises(ValueError, match="n_grad"):
            TA.values_and_gradient_at(pt, pts, bad)
    meta = torch.zeros((4, 3), device="meta", requires_grad=True)
    taken = []
    monkeypatch.setattr(TA._ValuesAndGradient, "apply",
                        lambda *args: taken.append(args) or "taken")
    assert TA.values_and_gradient_at(pt, meta, 2) == "taken"
    assert len(taken) == 1 and taken[0][2] is meta and taken[0][4] == 2
    with pytest.raises(ValueError, match="CUDA"):
        TA.packed_eval_kernel(pt, pts, TA.VALUES_AND_GRAD, n_grad=2)


def _setup(side=12):
    tree = T.build_octree(T.Config(target_error=1e-3, max_depth=4,
                                   max_degree=2, continuity=False),
                          lambda p: torch.linalg.norm(p, dim=-1) - 0.3,
                          device="cpu")
    o, d = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=side,
                         height=side, device="cpu")
    target = T.build_octree(T.Config(target_error=1e-3, max_depth=4,
                                     max_degree=2, continuity=False),
                            lambda p: torch.linalg.norm(p, dim=-1) - 0.33,
                            device="cpu")
    t_star, hit = TI.render_targets(target, o, d, t_max=5.0)
    return dict(init=tree, o=o, d=d, t_star=t_star, hit_star=hit)


def test_terms_read_the_points_in_chip_smoke_order(monkeypatch):
    """chunk_loss reads every point of a chunk in one
    values_and_gradient_at call: chip_smoke.inverse_points' 7n points, in
    their order, with the gradients of the first 3n, chip_smoke.band_points'.
    """
    s = _setup()
    seen = []

    def fused(pk, pts, n_grad):
        seen.append((pts.detach().clone(), n_grad))
        return TA.values_and_gradient_at_plain(pk, pts, n_grad)

    monkeypatch.setattr(TA, "values_and_gradient_at", fused)
    one = torch.tensor(1.0)
    TI.chunk_loss(TA.pack_tree(s["init"]), s["o"], s["d"], s["t_star"],
                  s["hit_star"], s["t_star"], s["hit_star"], one, one, 1.0,
                  0.1, 0.1)
    rays = slice(0, s["o"].shape[0])
    (pts, n_grad), = seen
    np.testing.assert_array_equal(pts.numpy(),
                                  chip_smoke.inverse_points(s, rays).numpy())
    np.testing.assert_array_equal(pts[:n_grad].numpy(),
                                  chip_smoke.band_points(s, rays).numpy())
    assert n_grad == 3 * s["o"].shape[0]


def test_node_walk_ends_at_descend(trees):
    """chip_smoke.node_walk's rounds start at the root, each next node a
    child of the last or the leaf kept, and end at query.descend's leaf."""
    _, _, tt, pts, _ = trees
    from hpsdf_tpu_torch.query import _to_unit

    unit = _to_unit(tt, torch.as_tensor(pts, dtype=torch.float64)) \
        .clamp(-0.5, 0.5)
    walk = chip_smoke.node_walk(tt, unit)
    assert len(walk) == 1 + tt.depth_used and not walk[0].any()
    np.testing.assert_array_equal(walk[-1].numpy(),
                                  descend(tt, unit).long().numpy())
    child = tt.child_idx.long()
    for a, b in zip(walk, walk[1:]):
        leaf = child[a] < 0
        assert torch.equal(b[leaf], a[leaf])
        off = b[~leaf] - child[a[~leaf]]
        assert bool(((off >= 0) & (off < 8)).all())


@pytest.mark.parametrize("coeff_rows", [False, True])
def test_coeff_scatter_bytes_counts_the_walk(trees, coeff_rows):
    """chip_smoke.coeff_scatter_bytes, the bytes in K8's bound: what every
    point is read for its liveness, what each live one is read more, a
    32-byte sector of each node the live points' descents visit (counted
    here by walking each point on its own), each of their leaves' rows
    whole where the trace form reads them, and the output whole."""
    _, _, tt, pts, rng = trees
    from hpsdf_tpu_torch.query import _to_unit

    unit = _to_unit(tt, torch.as_tensor(pts, dtype=torch.float64)) \
        .clamp(-0.5, 0.5)
    live = torch.as_tensor(rng.random(N_PTS) < 0.4)
    child = tt.child_idx.numpy()
    centre = tt.centre.numpy()
    nodes, leaves = set(), set()
    for u in unit[live].numpy():
        cur = 0
        nodes.add(cur)
        for _ in range(tt.depth_used):
            if child[cur] < 0:
                break
            c = centre[cur]
            cur = int(child[cur] + (u[0] >= c[0]) + 2 * (u[1] >= c[1])
                      + 4 * (u[2] >= c[2]))
            nodes.add(cur)
        leaves.add(cur)
    C = tt.coeffs.shape[1]
    want = (N_PTS * 5 + int(live.sum()) * 28 + 32 * len(nodes)
            + (8 * C * len(leaves) if coeff_rows else 0)
            + tt.coeffs.numel() * 8)
    assert chip_smoke.coeff_scatter_bytes(tt, unit, live, 5, 28,
                                          coeff_rows) == want


def test_inverse_chunks_give_the_depth_cotangent():
    """chip_smoke.inverse_chunks: the step's padded chunks, marched as
    fit_to_depth marches them, each with the depth term's cotangent, which
    is autograd's of the depth term and zero wherever either trace
    missed."""
    s = _setup()
    chunk = 50
    chunks = chip_smoke.inverse_chunks(s, chunk)
    n = s["o"].shape[0]
    assert len(chunks) == -(-n // chunk)
    assert all(c["rays"][0].shape == (chunk, 3) for c in chunks)
    m = torch.cat([c["m"] for c in chunks])
    t = torch.cat([c["t"] for c in chunks]).requires_grad_(True)
    tt = torch.cat([c["tt"] for c in chunks])
    dn = torch.clamp(m.sum(), min=1.0)
    loss = np.float32(0.1) * torch.sum(m * (t - tt) ** 2) / dn
    (want,) = torch.autograd.grad(loss, t)
    dt = torch.cat([c["dt"] for c in chunks])
    np.testing.assert_allclose(dt.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-12)
    assert not dt[m == 0].any() and bool(m.any())
    hits = torch.cat([c["hit"] for c in chunks])[:n]
    assert torch.equal(hits & s["hit_star"], m[:n].bool())

