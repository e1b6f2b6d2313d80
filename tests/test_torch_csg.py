"""The port's as_sdf and CSG rebuilds (hpsdf_tpu_torch.api, CPU tensors)
against hpsdf_tpu: as_sdf on a carried-across tree equals the JAX callable
(the packed f32 path to 1e-6, the generic f64 query to 1e-12), and the
rebuilds hold to the CSG tolerance 0.05 of tests/test_build_query.py:82-137
against the analytic combination, as the JAX rebuilds do."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
import hpsdf_tpu_torch as T

from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf, uniform_pts

CSG_TOL = 0.05
# a looser target and degree cap than the JAX tests' keep the CPU fits to
# about a second; their max error (~0.011 on these shapes) stays well
# inside the CSG tolerance
_CFG = dict(target_error=1e-6, continuity=False, max_depth=5, max_degree=4)


def t_sphere(centre, radius):
    c = torch.as_tensor(centre, dtype=torch.float64)

    def F(p):
        return torch.linalg.norm(p - c.to(p.dtype), dim=-1) - radius

    return F


def t_box(centre, half):
    c = torch.as_tensor(centre, dtype=torch.float64)
    h = torch.as_tensor(half, dtype=torch.float64)

    def F(p):
        q = (p - c.to(p.dtype)).abs() - h.to(p.dtype)
        return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
                + torch.clamp(q.amax(dim=-1), max=0.0))

    return F


@pytest.mark.parametrize("fit_dtype,atol", [("compensated", 1e-6),
                                            ("float64", 1e-12)])
def test_as_sdf_matches_jax(fit_dtype, atol):
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=5,
                    max_degree=5, fit_dtype=fit_dtype)
    jt = hp.build_octree(cfg, sphere_sdf(centre=(0.1, -0.05, 0.0),
                                         radius=0.3))
    tt = carry(jt, cfg)
    pts = uniform_pts(20000, lo=-0.6, hi=0.6, seed=21)
    cap = hp.api.as_sdf(jt)
    want = np.asarray(cap.fn(cap.captures, jnp.asarray(pts)))
    got = T.as_sdf(tt)(torch.as_tensor(pts))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _analytic(pts):
    return {name: F(torch.as_tensor(pts)).numpy() for name, F in (
        ("s_left", t_sphere((-0.15, 0.0, 0.0), 0.2)),
        ("b_right", t_box((0.15, 0.0, 0.0), (0.15, 0.15, 0.15))),
        ("s", t_sphere((0.0, 0.0, 0.0), 0.25)),
        ("b", t_box((0.0, 0.0, 0.0), (0.2, 0.2, 0.2))))}


@pytest.mark.parametrize("op", ["union", "intersect", "subtract"])
def test_csg_rebuild(op):
    cfg = T.Config(**_CFG)
    pts = uniform_pts(50_000, seed=11)
    a = _analytic(pts)
    if op == "union":
        base = T.build_octree(cfg, t_sphere((-0.15, 0.0, 0.0), 0.2),
                              device="cpu")
        tree = T.union_sdf(base, t_box((0.15, 0.0, 0.0), (0.15,) * 3))
        want = np.minimum(a["s_left"], a["b_right"])
    else:
        base = T.build_octree(cfg, t_sphere((0.0, 0.0, 0.0), 0.25),
                              device="cpu")
        box = t_box((0.0, 0.0, 0.0), (0.2,) * 3)
        if op == "intersect":
            tree = T.intersect_sdf(base, box)
            want = np.maximum(a["s"], a["b"])
        else:
            tree = T.subtract_sdf(base, box)
            want = np.maximum(-a["s"], a["b"])
    got = T.query(tree, torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() < CSG_TOL
