"""Builds of hpsdf_tpu_torch against hpsdf_tpu: analytic spheres, f64 fits,
the configs of tests/test_build_query.py.

The sphere centres are moved off the mirror planes of the cell grid. A
sphere centred on one gives mirror-image cells whose fit errors are equal
in exact arithmetic and differ only by summation order, so the
error-descending prefix of a round can take a different member of such a
tie in the two packages. Off the planes, topology must be equal and
coefficients agree to 1e-10; on them, the tree's size and its depth and
degree histograms must still be equal.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
import hpsdf_tpu_torch as T

from .test_torch_query import few_torch_threads  # noqa: F401

_CONFIGS = {
    # test_build_query.py sphere_tree
    "nearness_weighted": (hp.Config(
        target_error=1e-8, continuity=False,
        nearness_weighting=hp.NearnessWeighting.POLYNOMIAL,
        nearness_strength=2.0), (0.25, 0.0, 0.0), 0.2),
    # test_build_query.py test_custom_domain
    "custom_domain": (hp.Config(
        target_error=1e-7, continuity=False, root_min=(-0.25, -0.25, -0.25),
        root_max=(5.0, 5.0, 5.0)), (2.0, 2.0, 2.0), 1.0),
    # test_build_query.py CSG operand builds
    "default": (hp.Config(target_error=1e-7, continuity=False),
                (0.0, 0.0, 0.0), 0.25),
}
# off every mirror plane of the cell grid
_OFFSET = np.array([0.0131, -0.0217, 0.0093])


def port_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["nearness_weighting"] = T.NearnessWeighting(cfg.nearness_weighting.value)
    return T.Config(**kw)


def _builds(name, offset):
    cfg, centre, radius = _CONFIGS[name]
    c = np.asarray(centre) + offset * (cfg.root_sizes[0])
    cj = jnp.asarray(c)
    jt = hp.build_octree(
        cfg, lambda p: jnp.linalg.norm(p - cj, axis=-1) - radius)
    ct = torch.as_tensor(c)
    tt = T.build_octree(
        port_config(cfg),
        lambda p: torch.linalg.norm(p - ct, dim=-1) - radius, device="cpu")
    return jt, tt


@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_build_topology_and_coeffs(name):
    jt, tt = _builds(name, _OFFSET)
    assert (tt.n_nodes, tt.deg_used, tt.depth_used) == \
        (jt.n_nodes, jt.deg_used, jt.depth_used)
    for k in ("child_idx", "depth", "degree"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    np.testing.assert_allclose(tt.coeffs.numpy(), np.asarray(jt.coeffs),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["nearness_weighted", "custom_domain"])
def test_build_histograms_on_mirror_planes(name):
    jt, tt = _builds(name, 0.0 * _OFFSET)
    assert tt.n_nodes == jt.n_nodes
    n = jt.n_nodes
    for k in ("depth", "degree"):
        np.testing.assert_array_equal(
            np.bincount(getattr(tt, k).numpy()[:n] + 1),
            np.bincount(np.asarray(getattr(jt, k))[:n] + 1), err_msg=k)
