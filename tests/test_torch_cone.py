"""The cone prepass of hpsdf_tpu_torch.render (CPU tensors: the plain
version of kernel K4, ``cone_start_plain``, then the plain march) against
hpsdf_tpu.render and against the march without a cone, on the same numpy
rays.

The port's cone marches over the union of its tile's rays' intervals in
the root, where the reference's marches over the centre ray's own
(ADVICE.md, high: fine rays near the root's faces enter earlier or leave
later, and the reference drops hits there). So ``t0`` is held to the
reference's (1e-6) only on tiles where the two intervals coincide; on a
view of a sphere touching the root's faces (r = 0.499, 128^2, from two
oblique eyes where the reference's cone drops hits) the port's cone plus
march must give exactly the hits of the march without a cone, and t
within 5e-4 on them (tests/test_torch_render.py's bound).

``cone_start(..., with_stats=True)`` gives the reference's (t0, k,
n_coarse); its k is held to the reference's on views where every tile's
interval is its centre ray's (from inside the root, and parallel rays that
all enter through one face, head-on and oblique), and the plain version's
per-tile rounds to its own t0 under caps. The helpers chip_smoke.py prices
K4 with are checked here too.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import render as JR
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import render as TR

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf

T0_ATOL = 1e-6
T_ATOL = 5e-4
TILE = TR.CONE_TILE

_TREES = {
    "shallow": (hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                          max_degree=3), 0.3),
    "lod": (hp.Config(target_error=1e-9, continuity=False, max_depth=4,
                      max_degree=6), 0.3),
    "boundary": (hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                           max_degree=3), 0.499),
}
# eye, t_max: from far outside the root, whose border tiles see no root,
# and from inside it with a t_max that ends every ray inside (there the
# centre ray has its tile's interval)
_VIEWS = {"outside": ((0.0, 0.0, -4.0), 5.0),
          "inside": ((0.05, -0.03, -0.45), 0.6)}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (cfg, radius) in _TREES.items():
        jt = hp.build_octree(cfg, sphere_sdf(radius=radius))
        tt = carry(jt, cfg)
        out[name] = (jt, tt, JA.pack_tree(jt), TA.pack_tree(tt))
    return out


def _rays(eye, side):
    o, d = JR.camera_rays(eye, (0.0, 0.0, 0.0), width=side, height=side)
    return np.array(o, np.float32), np.array(d, np.float32)


def _same_interval_tiles(tp, o, d, t_max, side):
    """Tiles whose centre ray's interval in the root is the union of its
    rays' (or whose rays all miss): there the port's cone and the
    reference's march the same interval."""
    rc, half = TR._root_box(tp)
    tn, tf, hits = TR.intersect_aabb(torch.as_tensor(o), torch.as_tensor(d),
                                     rc - half, rc + half)
    ts = tn.clamp(min=0.0)
    te = tf.clamp(max=float(np.float32(t_max)))
    act = (hits & (ts <= te)).numpy().reshape(side // TILE, TILE,
                                              side // TILE, TILE)
    ts, te = (x.numpy().reshape(act.shape) for x in (ts, te))
    act, ts, te = (x.transpose(0, 2, 1, 3).reshape(-1, TILE * TILE)
                   for x in (act, ts, te))
    c = (TILE // 2) * TILE + TILE // 2
    lo = np.where(act, ts, np.inf).min(1)
    hi = np.where(act, te, -np.inf).max(1)
    same = np.where(act[:, c], (lo == ts[:, c]) & (hi == te[:, c]),
                    ~act.any(1))
    return same.reshape(side // TILE, 1, side // TILE, 1).repeat(
        TILE, 1).repeat(TILE, 3).reshape(-1)


@pytest.mark.parametrize("view", sorted(_VIEWS))
@pytest.mark.parametrize("name", ["shallow", "lod"])
def test_cone_start_matches_reference(trees, name, view):
    _, _, jp, tp = trees[name]
    eye, t_max = _VIEWS[view]
    side = 32
    o, d = _rays(eye, side)
    lo_j = JR._lo_of(jp)
    assert (lo_j is None) == (name == "shallow") == (tp.lo is None)
    want = np.asarray(JR.cone_start(jp, jnp.asarray(o), jnp.asarray(d),
                                    t_max, TR.HIT_EPS, (side, side, TILE),
                                    lo=lo_j))
    got = TR.cone_start_plain(tp, torch.as_tensor(o), torch.as_tensor(d),
                              t_max, TR.HIT_EPS, (side, side, TILE),
                              lo=tp.lo).numpy()
    same = _same_interval_tiles(tp, o, d, t_max, side)
    if view == "inside":
        assert same.all()
    assert same.any()
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=T0_ATOL)


def _ortho_rays(direction, side):
    """Parallel rays that all enter the root through its z = -0.5 face at
    t = 1.3, at points spread over [-0.4, 0.4]^2 of it: with a t_max short
    of every side exit, every tile's rays share the centre ray's interval,
    so the port's cone and the reference's march the same one."""
    u = np.asarray(direction, np.float64)
    u = u / np.linalg.norm(u)
    xs = ((np.arange(side) + 0.5) / side * 2.0 - 1.0) * 0.4
    px, py = np.meshgrid(xs, -xs, indexing="xy")
    p = np.stack([px, py, np.full_like(px, -0.5)], -1).reshape(-1, 3)
    d = np.broadcast_to(u, p.shape)
    return (p - 1.3 * u).astype(np.float32), d.astype(np.float32)


# views on which every tile's interval is its centre ray's: ray source and
# t_max (before every side exit of the oblique rays)
_SAME_VIEWS = {"inside": (lambda side: _rays(_VIEWS["inside"][0], side),
                          _VIEWS["inside"][1]),
               "head_on": (lambda side: _ortho_rays((0, 0, 1), side), 2.5),
               "oblique": (lambda side: _ortho_rays((0.15, 0.1, 1), side),
                           1.85)}


@pytest.mark.parametrize("view", sorted(_SAME_VIEWS))
@pytest.mark.parametrize("name", ["shallow", "lod"])
def test_cone_stats_match_reference(trees, name, view):
    """cone_start(..., with_stats=True) gives hpsdf_tpu's (t0, k,
    n_coarse): k the lockstep round count, n_coarse the tiles, on views
    where the two cones march the same intervals."""
    _, _, jp, tp = trees[name]
    rays, t_max = _SAME_VIEWS[view]
    side = 32
    o, d = rays(side)
    tiles = (side, side, TILE)
    assert _same_interval_tiles(tp, o, d, t_max, side).all()
    t0_j, k_j, n_j = JR.cone_start(jp, jnp.asarray(o), jnp.asarray(d), t_max,
                                   TR.HIT_EPS, tiles, lo=JR._lo_of(jp),
                                   with_stats=True)
    t0, k, n = TR.cone_start(tp, torch.as_tensor(o), torch.as_tensor(d),
                             t_max, TR.HIT_EPS, tiles, lo=tp.lo,
                             with_stats=True)
    assert (k, n) == (int(k_j), n_j) == (k, (side // TILE) ** 2)
    assert k > 1
    np.testing.assert_allclose(t0.numpy(), np.asarray(t0_j), rtol=0,
                               atol=T0_ATOL)


@pytest.mark.parametrize("view", ["inside", "head_on", "oblique",
                                  "ortho_oblique"])
@pytest.mark.parametrize("name", ["shallow", "lod"])
def test_cone_rounds_agree_with_t0(trees, name, view):
    """The plain cone's per-tile rounds: a tile that took r rounds has the
    same t0 at max_steps r as with no cap, a cap of m rounds gives each
    tile min(r, m), and the largest r is cone_start's k."""
    _, _, _, tp = trees[name]
    side = 32
    if view == "ortho_oblique":
        (o, d), t_max = _SAME_VIEWS["oblique"][0](side), 1.85
    elif view == "inside":
        (o, d), t_max = _rays(_VIEWS["inside"][0], side), _VIEWS["inside"][1]
    else:
        eye = {"head_on": (0.0, 0.0, -1.8), "oblique": (0.5, 0.4, -1.6)}[view]
        (o, d), t_max = _rays(eye, side), 5.0
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    tiles = (side, side, TILE)
    t0, rounds = TR.cone_start_plain(tp, o, d, t_max, TR.HIT_EPS, tiles,
                                     lo=tp.lo, with_stats=True)
    assert rounds.dtype == torch.int32 and rounds.shape == ((side // TILE)
                                                            ** 2,)
    per_ray = rounds.reshape(side // TILE, 1, side // TILE, 1).expand(
        side // TILE, TILE, side // TILE, TILE).reshape(-1)
    for r in sorted(set(rounds.tolist())):
        t0_r, rounds_r = TR.cone_start_plain(tp, o, d, t_max, TR.HIT_EPS,
                                             tiles, lo=tp.lo, max_steps=r,
                                             with_stats=True)
        assert torch.equal(rounds_r, torch.clamp(rounds, max=r))
        done = per_ray <= r
        assert torch.equal(t0_r[done], t0[done])
    _, k, n = TR.cone_start(tp, o, d, t_max, TR.HIT_EPS, tiles, lo=tp.lo,
                            with_stats=True)
    assert (k, n) == (int(rounds.max()), rounds.numel())
    assert k > 1


@pytest.mark.parametrize("eye", [(0.6, 0.0, -1.5), (0.7, 0.7, -1.2)])
def test_boundary_view_drops_no_hit(trees, eye):
    jt, tt, _, tp = trees["boundary"]
    side = 128
    o, d = _rays(eye, side)
    tiles = (side, side, TILE)
    # the reference's cone drops hits on this view
    jn = np.asarray(JR.trace(jt, o, d, t_max=5.0, sort_rays=False).hit)
    jc = np.asarray(JR.trace(jt, o, d, t_max=5.0, cone_tiles=tiles).hit)
    assert (jn & ~jc).any()
    plain = TR.trace(tt, o, d, t_max=5.0, packed=tp)
    cone = TR.trace(tt, o, d, t_max=5.0, packed=tp, cone_tiles=tiles)
    np.testing.assert_array_equal(cone.hit.numpy(), plain.hit.numpy())
    np.testing.assert_array_equal(plain.hit.numpy(), jn)
    h = plain.hit.numpy()
    np.testing.assert_allclose(cone.t.numpy()[h], plain.t.numpy()[h],
                               rtol=0, atol=T_ATOL)
    # escaped tiles report t_max + 1
    t0 = TR.cone_start(tp, torch.as_tensor(o), torch.as_tensor(d), 5.0,
                       TR.HIT_EPS, tiles)
    esc = t0 == np.float32(6.0)
    assert esc.any() and (cone.t[esc] == np.float32(6.0)).all()


def _count_cones(monkeypatch):
    calls = []
    real = TR.cone_start

    def counted(*args, **kw):
        calls.append(args[5])
        return real(*args, **kw)

    monkeypatch.setattr(TR, "cone_start", counted)
    return calls


@pytest.mark.parametrize("size", [(64, 48), (60, 44)])
def test_render_cone_tiles(trees, monkeypatch, size):
    """render runs the cone where 8 divides both sides, as hpsdf_tpu's, and
    gives its image and hits."""
    jt, tt, _, tp = trees["shallow"]
    w, h = size
    kw = dict(eye=(0.5, 0.4, -1.6), look_at=(0.0, 0.0, 0.0), width=w,
              height=h, t_max=5.0)
    calls = _count_cones(monkeypatch)
    it, dt, ht = (x.numpy() for x in T.render_image(tt, packed=tp, **kw))
    assert calls == ([(h, w, TILE)] if w % TILE == 0 and h % TILE == 0
                     else [])
    ij, dj, hj = (np.asarray(x) for x in hp.render_image(jt, **kw))
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_allclose(dt[ht], dj[hj], rtol=0, atol=T_ATOL)
    np.testing.assert_allclose(it[ht], ij[hj], rtol=0, atol=1e-3)
    assert not it[~ht].any() and np.isinf(dt[~ht]).all()


@pytest.mark.parametrize("sort_rays", [None, False])
def test_trace_schedule_rule(trees, monkeypatch, sort_rays):
    """No cone on a tree with LOD tables unless sort_rays is given
    (hpsdf_tpu render.py:574-575); its results do not change."""
    _, tt, _, tp = trees["lod"]
    o, d = _rays((0.0, 0.0, -1.8), 32)
    calls = _count_cones(monkeypatch)
    res = TR.trace(tt, o, d, t_max=5.0, packed=tp, sort_rays=sort_rays,
                   cone_tiles=(32, 32, TILE))
    assert len(calls) == (0 if sort_rays is None else 1)
    plain = TR.trace(tt, o, d, t_max=5.0, packed=tp)
    np.testing.assert_array_equal(res.hit.numpy(), plain.hit.numpy())
    h = plain.hit.numpy()
    np.testing.assert_allclose(res.t.numpy()[h], plain.t.numpy()[h], rtol=0,
                               atol=T_ATOL)


def test_cone_kernel_refuses_cpu(trees):
    _, _, _, tp = trees["shallow"]
    o, d = _rays((0.0, 0.0, -1.8), 16)
    with pytest.raises(ValueError, match="CUDA"):
        TR.cone_kernel(tp, torch.as_tensor(o), torch.as_tensor(d), 5.0,
                       TR.HIT_EPS, (16, 16, TILE))
    with pytest.raises(ValueError, match="divide"):
        TR.cone_start(tp, torch.as_tensor(o), torch.as_tensor(d), 5.0,
                      TR.HIT_EPS, (16, 16, 5))


def test_chip_smoke_tile_rays():
    """chip_smoke.tile_rays gives tile j's rays in the order _tiles_of
    lays them out."""
    import chip_smoke

    tiles = (16, 24, 8)
    idx = torch.arange(16 * 24, dtype=torch.float32)[:, None].expand(-1, 3)
    laid = TR._tiles_of(idx, tiles)[..., 0].long()
    for j in range(laid.shape[0]):
        assert torch.equal(chip_smoke.tile_rays(tiles, j), laid[j])


def test_chip_smoke_cone_read_bytes(trees):
    """chip_smoke.cone_read_bytes prices the rows the centre rays' samples
    reach: with every tile cut to one round, the rows of their starts, the
    earliest entry of each tile's rays, on the full rows and on the LOD
    tables."""
    import chip_smoke

    side = 32
    tiles = (side, side, TILE)
    o, d = (torch.as_tensor(x) for x in _rays((0.0, 0.0, -1.8), side))
    c = (TILE // 2) * TILE + TILE // 2
    for name in ("shallow", "lod"):
        tp = trees[name][3]
        _, rounds = TR.cone_start_plain(tp, o, d, 5.0, TR.HIT_EPS, tiles,
                                        lo=tp.lo, with_stats=True)
        one = rounds.clamp(max=1)
        rc, half = TR._root_box(tp)
        tn, tf, hits = TR.intersect_aabb(o, d, rc - half, rc + half)
        ts = tn.clamp(min=0.0)
        act = hits & (ts <= tf.clamp(max=5.0))
        lo = TR._tiles_of(torch.where(act, ts, np.inf)[:, None].expand(
            -1, 3), tiles)[..., 0].amin(dim=1)
        live = one > 0
        pts = (TR._tiles_of(o, tiles)[:, c] + lo[:, None]
               * TR._tiles_of(d, tiles)[:, c])[live]
        tables = tp if tp.lo is None else dataclasses.replace(
            tp, grid=tp.lo[0], rows=tp.lo[1])
        assert bool(live.any())
        assert chip_smoke.cone_read_bytes(tp, tp.lo, o, d, tiles, one,
                                          5.0) == \
            chip_smoke.packed_read_bytes(tables, pts, whole=True)
        assert chip_smoke.cone_read_bytes(tp, tp.lo, o, d, tiles, rounds,
                                          5.0) > \
            chip_smoke.packed_read_bytes(tables, pts, whole=True)


def test_chip_smoke_sass_round(monkeypatch):
    """chip_smoke.sass_round counts the instructions of the largest loop
    with a 16-byte global load in the listing of the instantiation asked
    for."""
    import chip_smoke

    def fn(name, body):
        return (f"\n\tFunction : _ZN12_GLOBAL__N_111cone_kernelI{name}EEvNS_"
                f"5SceneE\n" + "".join(
                    f"        /*{16 * i:04x}*/   {ins} ;  /* 0x0 */\n"
                    for i, ins in enumerate(body)))

    march = ["MOV R1, c[0x0][0x28]", "LDG.E.128.CONSTANT R4, desc[UR4][R2.64]",
             "FFMA R3, R4, R5, R6", "LDG.E.128.CONSTANT R8, desc[UR4][R2.64]",
             "@P0 BRA 0x30", "FMUL R3, R4, R5", "@!P1 BRA 0x10", "EXIT",
             "BRA 0x70"]
    other = ["MOV R1, c[0x0][0x28]", "FFMA R3, R4, R5, R6",
             "FFMA R3, R4, R5, R6", "FFMA R3, R4, R5, R6",
             "FFMA R3, R4, R5, R6", "@P0 BRA 0x10", "EXIT"]
    listing = (fn("Li3ELb0E", march) + fn("Li3ELb1E", other)
               + fn("Li5ELb0E", other))
    monkeypatch.setattr(chip_smoke, "sass_listing", lambda path: listing)
    assert chip_smoke.sass_round("lib", (3, 0)) == 6     # 0x10 .. 0x60
    assert chip_smoke.sass_round("lib", (3, 1)) is None
    assert chip_smoke.sass_round("lib", (2, 1)) is None
