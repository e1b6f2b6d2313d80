"""The differential oracle for the port: ``hpsdf_tpu_torch.build.build`` on
the CPU against ``hpsdf_tpu.oracle.greedy_build`` (a numpy re-execution of
the reference's greedy serial schedule, Source/HP/Octree.cpp:194-309),
on the cases of tests/test_reference_oracle.py with its tolerances: the
analytic sphere (queries and the rendered image, :49-110), the
reference's nearness-weighted configs (:141-180) and the custom domain
(:212-238). The port builds level-synchronously, as hpsdf_tpu does, so it
is held to the greedy tree exactly as hpsdf_tpu's build is: each within
the reference's 0.01 oracle of the true field, and mutually close.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import oracle
from hpsdf_tpu.render import _normals_at, camera_rays, trace
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import build as TB

from .test_reference_oracle import (CFG, OFFSET, RADIUS, WEIGHT_CASES,
                                    off_sphere_np, sphere_np)
from .test_torch_query import few_torch_threads, port_config  # noqa: F401


def _port_build(cfg, centre, radius):
    """The port's build on the CPU of the sphere (centre, radius)."""
    c = torch.as_tensor(centre, dtype=torch.float64)
    return TB.build(port_config(cfg),
                    lambda p: torch.linalg.norm(p - c, dim=-1) - radius,
                    device="cpu")


def _queries(greedy, ours, pts):
    qg = np.asarray(hp.query(greedy, jnp.asarray(pts)))
    qo = T.query(ours, torch.as_tensor(pts)).numpy()
    return qg, qo


def _rays(eye, look_at, side):
    o, d = camera_rays(eye, look_at, width=side, height=side)
    return np.asarray(o), np.asarray(d)


@pytest.fixture(scope="module")
def sphere_trees():
    cfg = hp.Config(**CFG)
    return oracle.greedy_build(cfg, sphere_np), _port_build(cfg, (0, 0, 0),
                                                            RADIUS)


def test_sphere_queries_match_greedy(sphere_trees):
    """test_reference_oracle.py:62-77: both within the 0.01 oracle, mutually
    within 0.02 and 2e-3 RMS."""
    greedy, ours = sphere_trees
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, (200_000, 3))
    qg, qo = _queries(greedy, ours, pts)
    t = sphere_np(pts)
    assert np.abs(qg - t).max() <= 0.01
    assert np.abs(qo - t).max() <= 0.01, np.abs(qo - t).max()
    diff = qo - qg
    assert np.abs(diff).max() <= 0.02
    assert np.sqrt(np.mean(diff ** 2)) <= 2e-3, np.sqrt(np.mean(diff ** 2))


def test_sphere_render_matches_greedy(sphere_trees):
    """test_reference_oracle.py:80-110: hit masks, depths and normals of
    the greedy tree's image (hpsdf_tpu) and the port tree's (the port's
    plain march and normals)."""
    greedy, ours = sphere_trees
    o, d = _rays((0.0, 0.0, -1.6), (0.0, 0.0, 0.0), 96)
    rg = trace(greedy, o, d, t_max=4.0)
    ro = T.trace(ours, o, d, t_max=4.0)
    hg, ho = np.asarray(rg.hit), ro.hit.numpy()
    assert np.mean(hg != ho) <= 0.005, np.mean(hg != ho)
    both = hg & ho
    assert both.sum() > 500
    tg, to = np.asarray(rg.t), ro.t.numpy()
    np.testing.assert_allclose(to[both], tg[both], atol=2e-3)
    ng = np.asarray(_normals_at(JA.pack_tree(greedy), jnp.asarray(
        (o + tg[:, None] * d)[both], jnp.float32)))
    no = TA.normals(TA.pack_tree(ours), torch.as_tensor(
        (o + to[:, None] * d)[both], dtype=torch.float32)).numpy()
    dots = np.sum(ng * no, axis=-1)
    assert np.mean(dots) >= 0.9995, np.mean(dots)
    assert np.min(dots) >= 0.98, np.min(dots)


@pytest.mark.parametrize("case", sorted(WEIGHT_CASES))
def test_weighted_configs_match_greedy(case):
    """test_reference_oracle.py:141-180: near the surface (|f| <= 0.1) both
    within 0.01, mutually within 0.02 and 2e-3 RMS; trace parity at 64^2
    within 1% of hit masks and 5e-3 in t."""
    cfg = hp.Config(**WEIGHT_CASES[case])
    greedy = oracle.greedy_build(cfg, off_sphere_np)
    ours = _port_build(cfg, OFFSET, 0.5)
    pts = np.random.default_rng(7).uniform(-0.5, 0.5, (200_000, 3))
    t = off_sphere_np(pts)
    band = np.abs(t) <= 0.1
    qg, qo = _queries(greedy, ours, pts)
    assert np.abs(qg - t)[band].max() <= 0.01
    assert np.abs(qo - t)[band].max() <= 0.01, np.abs(qo - t)[band].max()
    diff = (qo - qg)[band]
    assert np.abs(diff).max() <= 0.02
    assert np.sqrt(np.mean(diff ** 2)) <= 2e-3, np.sqrt(np.mean(diff ** 2))
    o, d = _rays((0.25, 0.0, -1.6), (0.25, 0.0, 0.0), 64)
    rg = trace(greedy, o, d, t_max=4.0)
    ro = T.trace(ours, o, d, t_max=4.0)
    hg, ho = np.asarray(rg.hit), ro.hit.numpy()
    assert np.mean(hg != ho) <= 0.01, np.mean(hg != ho)
    both = hg & ho
    assert both.sum() > 300
    np.testing.assert_allclose(ro.t.numpy()[both], np.asarray(rg.t)[both],
                               atol=5e-3)


def test_custom_domain_matches_greedy():
    """test_reference_oracle.py:212-238: root (-0.25..5)^3, sphere r = 0.75
    at (0.25, 0, 0); the domain map of both builds lands on trees within
    the 0.01 oracle and mutually within 0.02 and 2e-3 RMS."""
    cfg = hp.Config(**dict(CFG, target_error=1e-7,
                           root_min=(-0.25, -0.25, -0.25),
                           root_max=(5.0, 5.0, 5.0)))
    greedy = oracle.greedy_build(cfg, lambda p: off_sphere_np(p, r=0.75))
    ours = _port_build(cfg, OFFSET, 0.75)
    pts = np.random.default_rng(9).uniform(-0.25, 5.0, (200_000, 3))
    t = off_sphere_np(pts, r=0.75)
    qg, qo = _queries(greedy, ours, pts)
    assert np.abs(qg - t).max() <= 0.01
    assert np.abs(qo - t).max() <= 0.01, np.abs(qo - t).max()
    diff = qo - qg
    assert np.abs(diff).max() <= 0.02
    assert np.sqrt(np.mean(diff ** 2)) <= 2e-3, np.sqrt(np.mean(diff ** 2))
