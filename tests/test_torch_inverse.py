"""The port's inverse rendering (hpsdf_tpu_torch.inverse on CPU tensors:
the plain versions of every kernel on its path) against hpsdf_tpu.inverse,
mirroring tests/test_inverse.py:30-116 on the same trees (a sphere of
radius 0.30 fitted towards the depths of one of 0.33) and the same numpy
rays: repacking, the loss trajectory over 3 steps (rtol 1e-3; the two
agree to about 1e-6), its independence of the ray chunking (rtol 2e-4)
and the refused options."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import inverse as JI
from hpsdf_tpu.render import camera_rays
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf

LOSS_RTOL = 1e-3
CHUNK_RTOL = 2e-4


@pytest.fixture(scope="module")
def trees():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                    max_degree=3)
    out = []
    for radius in (0.30, 0.33):
        jt = hp.build_octree(cfg, sphere_sdf(radius=radius))
        out.append((jt, carry(jt, cfg)))
    return out


def _rays(side):
    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=side,
                       height=side)
    return np.array(o, np.float32), np.array(d, np.float32)


def test_repack_matches_pack_tree(trees):
    (ji, ti), (jo, to) = trees
    tp, ts = TA.pack_tree(ti), TA.pack_support(ti)
    re = TA.repack(tp, ts, ti.coeffs)
    np.testing.assert_allclose(re.rows.numpy(), tp.rows.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(re.grid.numpy(), tp.grid.numpy(), rtol=1e-6,
                               atol=1e-7)
    # new coefficients: the reference's repack, bit for bit
    want = JA.repack(JA.pack_tree(ji), JA.pack_support(ji), jo.coeffs)
    got = TA.repack(tp, ts, to.coeffs)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.grid.numpy(), np.asarray(want.grid))


def test_repack_folded_matches_repack(trees):
    (_, ti), (_, to) = trees
    tp, ts = TA.pack_tree(ti), TA.pack_support(ti)
    c32 = to.coeffs.to(torch.float32)
    a = TA.repack(tp, ts, c32)
    b = TA.repack_folded(tp, ts, c32 * ts.fold)
    np.testing.assert_array_equal(a.rows.numpy(), b.rows.numpy())
    np.testing.assert_array_equal(a.grid.numpy(), b.grid.numpy())


def test_render_targets(trees):
    _, (jo, to) = trees
    o, d = _rays(16)
    tj, hj = JI.render_targets(jo, o, d, t_max=5.0)
    tt, ht = T.inverse.render_targets(to, o, d, t_max=5.0)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_allclose(tt.numpy()[ht.numpy()],
                               np.asarray(tj)[np.asarray(hj)], rtol=0,
                               atol=5e-4)


def test_depth_loss():
    rng = np.random.default_rng(0)
    t, tt = rng.uniform(1, 2, (2, 50)).astype(np.float32)
    h, th = rng.uniform(0, 1, (2, 50)) < 0.6
    want = JI.depth_loss(jnp.asarray(t), jnp.asarray(h), jnp.asarray(tt),
                         jnp.asarray(th))
    got = T.inverse.depth_loss(*(torch.as_tensor(x) for x in (t, h, tt, th)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("param_space", ["folded", "raw"])
@pytest.mark.parametrize("side", [8, 20])
def test_fit_to_depth_losses(trees, param_space, side):
    (ji, ti), (jo, _) = trees
    o, d = _rays(side)
    tt, th = (np.asarray(x) for x in JI.render_targets(jo, o, d, t_max=5.0))
    kw = dict(n_steps=3, lr=1e-3, t_max=5.0, param_space=param_space)
    want = np.asarray(JI.fit_to_depth(ji, o, d, tt, th, **kw).losses)
    got = T.inverse.fit_to_depth(ti, o, d, tt, th, **kw)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.losses.numpy(), want, rtol=LOSS_RTOL)
    assert got.tree.coeffs.dtype == ti.coeffs.dtype
    assert not torch.equal(got.tree.coeffs, ti.coeffs)


def test_loss_chunk_invariant(trees):
    (_, ti), (_, to) = trees
    o, d = _rays(20)                           # 400 rays
    tt, th = T.inverse.render_targets(to, o, d, t_max=5.0)
    runs = [T.inverse.fit_to_depth(ti, o, d, tt, th, n_steps=3, lr=1e-3,
                                   t_max=5.0, ray_chunk=rc).losses.numpy()
            for rc in (400, 96)]               # 96 pads 400 to 480
    np.testing.assert_allclose(runs[0], runs[1], rtol=CHUNK_RTOL)


def test_refused_options(trees):
    (_, ti), (_, to) = trees
    o, d = _rays(8)
    tt, th = T.inverse.render_targets(to, o, d, t_max=5.0)
    with pytest.raises(ValueError, match="param_space"):
        T.inverse.fit_to_depth(ti, o, d, tt, th, n_steps=1,
                               param_space="bogus")
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.inverse.fit_to_depth(ti, o, d, tt, th, n_steps=1, mesh=object())
