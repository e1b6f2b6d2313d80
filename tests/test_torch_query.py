"""Queries of hpsdf_tpu_torch (the plain torch version of kernel K1, which
CPU tensors take) against hpsdf_tpu.query on the same trees: built by
hpsdf_tpu, carried across with from_numpy, f64 atol 1e-12, with the same
outside-root sentinel."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
import hpsdf_tpu_torch as T

from .util import sphere_sdf

ATOL = 1e-12
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")

_TREES = {
    "sphere": (hp.Config(target_error=1e-6, continuity=False, max_depth=5,
                         max_degree=5),
               dict(centre=(0.25, 0.0, 0.0), radius=0.2)),
    "custom_domain": (hp.Config(target_error=1e-6, continuity=False,
                                max_depth=5, max_degree=4,
                                root_min=(-0.25, -0.25, -0.25),
                                root_max=(5.0, 5.0, 5.0)),
                      dict(centre=(2.0, 2.0, 2.0), radius=1.0)),
    "nearness_weighted": (hp.Config(
        target_error=1e-7, continuity=False, max_depth=5, max_degree=5,
        nearness_weighting=hp.NearnessWeighting.POLYNOMIAL,
        nearness_strength=2.0), dict(centre=(0.1, -0.05, 0.0), radius=0.3)),
}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The port's tests use small tensors, and the suite runs them in
    several worker processes at once: two intra-op threads per process run
    them faster than one per core, which oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["nearness_weighting"] = T.NearnessWeighting(cfg.nearness_weighting.value)
    return T.Config(**kw)


@pytest.fixture(scope="module", params=sorted(_TREES))
def trees(request):
    cfg, sph = _TREES[request.param]
    jt = hp.build_octree(cfg, sphere_sdf(**sph))
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    return jt, tt


def _points(tree, n=2000, seed=0):
    """Uniform over the root AABB grown by 10% per side: some points lie
    outside the root."""
    lo, hi = tree.root_aabb
    pad = 0.1 * (hi - lo)
    return np.random.default_rng(seed).uniform(lo - pad, hi + pad, (n, 3))


def test_query(trees):
    jt, tt = trees
    pts = _points(jt)
    want = np.asarray(hp.query(jt, jnp.asarray(pts)))
    got = T.query(tt, torch.as_tensor(pts)).numpy()
    outside = want == np.finfo(np.float64).max
    assert outside.any() and not outside.all()
    np.testing.assert_array_equal(got[outside], want[outside])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_query_with_gradient(trees):
    jt, tt = trees
    pts = _points(jt, seed=1)
    v_j, g_j = hp.query_with_gradient(jt, jnp.asarray(pts))
    v_t, g_t = T.query_with_gradient(tt, torch.as_tensor(pts))
    outside = np.asarray(v_j) == np.finfo(np.float64).max
    np.testing.assert_array_equal(v_t.numpy()[outside],
                                  np.asarray(v_j)[outside])
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=ATOL)


def test_query_grid(trees):
    jt, tt = trees
    # 20 points per axis: no grid point but the ends lies on a cell face,
    # where an ulp of difference in linspace would pick another leaf
    want = np.asarray(hp.query_grid(jt, 20))
    got = T.query_grid(tt, 20).numpy()
    assert got.shape == (20, 20, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
