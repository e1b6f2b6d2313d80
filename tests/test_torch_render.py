"""The port's sphere tracer (hpsdf_tpu_torch.render, CPU tensors: the plain
versions of kernels K3 and K5) against hpsdf_tpu.render on carried-across
trees and the same numpy rays.

Both marches run in f32 but round in different places (and XLA may
contract a*b+c), so a ray grazing the surface can end on the other side
of the hit test: hit masks are held equal on >= 99.5% of rays, the
reference's own bound (tests/test_reference_oracle.py:88-89), and t on
common hits to 5e-4 (tests/test_render.py:189,221).
"""

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

RADIUS = 0.3
HIT_AGREE = 0.995
T_ATOL = 5e-4

# a shallow 32-lane tree (no LOD phase) and, as tests/test_render.py:171-172,
# a depth-capped build that p-refines past degree 2 so the LOD phase runs
_TREES = {
    "shallow": hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                         max_degree=3),
    "lod": hp.Config(target_error=1e-9, continuity=False, max_depth=4,
                     max_degree=6),
}


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, cfg in _TREES.items():
        jt = hp.build_octree(cfg, sphere_sdf(radius=RADIUS))
        tt = carry(jt, cfg)
        out[name] = (jt, tt, JA.pack_tree(jt), TA.pack_tree(tt))
    return out


def _rays(width=48, height=48, eye=(0.0, 0.0, -1.8)):
    o, d = JR.camera_rays(eye, (0.0, 0.0, 0.0), width=width, height=height)
    return np.array(o, np.float32), np.array(d, np.float32)


def _agree(h_t, h_j, t_t, t_j):
    assert np.mean(h_t == h_j) >= HIT_AGREE, np.mean(h_t != h_j)
    both = h_t & h_j
    assert both.any()
    assert np.abs(t_t[both] - t_j[both]).max() <= T_ATOL


def test_intersect_aabb():
    rng = np.random.default_rng(0)
    o = rng.uniform(-2, 2, (4000, 3)).astype(np.float32)
    d = rng.standard_normal((4000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lo, hi = (-0.25, -0.5, -0.5), (0.75, 0.5, 1.0)
    want = JR.intersect_aabb(jnp.asarray(o), jnp.asarray(d), lo, hi)
    got = TR.intersect_aabb(torch.as_tensor(o), torch.as_tensor(d), lo, hi)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()


@pytest.mark.parametrize("size", [(48, 48), (60, 40)])
def test_camera_rays(size):
    w, h = size
    kw = dict(up=(0.0, 1.0, 0.0), fov_deg=40.0, width=w, height=h)
    for eye in ((0.0, 0.0, -1.8), (0.5, 0.4, -1.6)):
        jo, jd = JR.camera_rays(eye, (0.0, 0.0, 0.0), **kw)
        to, td = TR.camera_rays(eye, (0.0, 0.0, 0.0), device="cpu", **kw)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["omega_default", "omega_1", "lod",
                                  "step_cap"])
def test_march_block(trees, case):
    name = "lod" if case == "lod" else "shallow"
    _, _, jp, tp = trees[name]
    kw = dict(omega=1.0) if case == "omega_1" else {}
    if case == "step_cap":
        kw = dict(step_cap=0.02)
    o, d = _rays()
    j_lo = JR._lo_of(jp) if case == "lod" else None
    t_lo = tp.lo if case == "lod" else None
    assert (j_lo is None) == (t_lo is None)
    tj, hj, kj = JR._march_block(jp, jnp.asarray(o), jnp.asarray(d),
                                 jnp.float32(5.0), 1e-4, 200, lo=j_lo, **kw)
    tt, ht, kt = TR._march_block(tp, torch.as_tensor(o), torch.as_tensor(d),
                                 5.0, 1e-4, 200, lo=t_lo, **kw)
    _agree(ht.numpy(), np.asarray(hj), tt.numpy(), np.asarray(tj))
    if case == "lod":
        assert int(kt[0]) > 0 and int(kj[0]) > 0     # the LOD phase ran
    else:
        assert int(kt[0]) == 0
    # hits sit on the sphere
    p = o + tt.numpy()[:, None] * d
    r = np.linalg.norm(p, axis=1)[ht.numpy()]
    assert np.abs(r - RADIUS).max() < 5e-3


def test_trace(trees):
    jt, tt, _, tp = trees["shallow"]
    o, d = _rays(40, 40, eye=(0.3, 0.2, -1.7))
    rj = JR.trace(jt, o, d, t_max=5.0, sort_rays=False)
    rt = TR.trace(tt, o, d, t_max=5.0, packed=tp, sort_rays=True)
    _agree(rt.hit.numpy(), np.asarray(rj.hit), rt.t.numpy(),
           np.asarray(rj.t))
    # with the cone prepass (K4's plain version) before the march: the
    # hits of hpsdf_tpu's cone trace, and the depths of its march without a
    # cone (the cone moves only where the fine march starts)
    rjc = JR.trace(jt, o, d, t_max=5.0, cone_tiles=(40, 40, 8))
    rtc = TR.trace(tt, o, d, t_max=5.0, packed=tp, cone_tiles=(40, 40, 8))
    np.testing.assert_array_equal(rtc.hit.numpy(), np.asarray(rjc.hit))
    _agree(rtc.hit.numpy(), np.asarray(rj.hit), rtc.t.numpy(),
           np.asarray(rj.t))


@pytest.mark.parametrize("name", sorted(_TREES))
def test_normals(trees, name):
    _, _, jp, tp = trees[name]
    o, d = _rays()
    t, h, _ = JR._march_block(jp, jnp.asarray(o), jnp.asarray(d),
                              jnp.float32(5.0), 1e-4, 200)
    h = np.asarray(h)
    p = (o + np.asarray(t)[:, None] * d)[h].astype(np.float32)
    want = np.asarray(JR._normals_at(jp, jnp.asarray(p)))
    got = TR._normals_at(tp, torch.as_tensor(p)).numpy()
    dots = np.sum(got * want, axis=-1)
    assert dots.mean() >= 0.9999 and dots.min() >= 0.999
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_render_60(trees):
    # 60 is not a multiple of CONE_TILE: hpsdf_tpu renders without the cone
    jt, tt, _, _ = trees["lod"]
    kw = dict(eye=(0.5, 0.4, -1.6), look_at=(0.0, 0.0, 0.0), width=60,
              height=60, t_max=5.0)
    ij, dj, hj = (np.asarray(x) for x in hp.render_image(jt, **kw))
    it, dt, ht = (x.numpy() for x in T.render_image(tt, **kw))
    assert it.shape == (60, 60, 3) and dt.shape == ht.shape == (60, 60)
    _agree(ht, hj, dt, dj)
    both = ht & hj
    np.testing.assert_allclose(it[both], ij[both], rtol=0, atol=1e-3)
    assert not it[~ht].any() and np.isinf(dt[~ht]).all()
