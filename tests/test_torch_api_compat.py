"""The port's public signatures against the reference's: ``mesh_sdf``'s
positional order, ``build`` and ``build_octree`` with ``progress`` and
``continuity_fn`` (and the options not ported yet, which raise), the CSG
rebuilds forwarding their keywords, and the package's exports."""

import functools
import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu.mesh import sdf as JS
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import build as TB
from hpsdf_tpu_torch import continuity as TC
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch.mesh import gen

from .test_torch_query import few_torch_threads  # noqa: F401

_CFG = dict(target_error=1e-3, continuity=False, max_depth=4, max_degree=2)


def _sphere(p):
    return torch.linalg.norm(p, dim=-1) - 0.3


def test_mesh_sdf_positional_order():
    want = list(inspect.signature(JS.mesh_sdf).parameters)
    params = inspect.signature(TM.mesh_sdf).parameters
    assert list(params)[:len(want)] == want
    assert params["device"].kind is inspect.Parameter.KEYWORD_ONLY
    mesh = TM.build_mesh(*gen.icosphere(0.3, 1))
    F = TM.mesh_sdf(mesh, None, 0, "tiles", device="cpu")
    assert F.method == "tiles"
    # the BVH walk takes max_iters by position too: 1 visit leaves the
    # greedy seed's triangle, an upper bound of the exact distance
    pts = torch.tensor([[0.05, 0.02, 0.0], [0.4, 0.1, -0.2]])
    exact = TM.mesh_sdf(mesh, None, 0, "bvh", device="cpu")
    capped = TM.mesh_sdf(mesh, None, 1, "bvh", device="cpu")
    assert exact.method == capped.method == "bvh"
    assert bool((capped(pts).abs() >= exact(pts).abs() - 1e-7).all())
    np.testing.assert_allclose(
        exact(pts).numpy(), TM.signed_distance_brute(
            TM.build_bvh(mesh, device="cpu").tri_rows, pts).numpy(),
        rtol=0, atol=1e-6)


def test_build_progress():
    cfg = T.Config(**_CFG)
    lines = []
    tree = T.build_octree(cfg, _sphere, device="cpu", progress=lines.append)
    assert tree.n_nodes > 1
    want = []
    hp.build_octree(hp.Config(**_CFG),
                    lambda p: jnp.linalg.norm(p, axis=-1) - 0.3,
                    progress=want.append)
    # the same log lines, up to their numbers
    assert [w.split(":")[0] for w in want] == [g.split(":")[0] for g in lines]
    assert lines[0].startswith("coarse fit") and lines[-1].startswith(
        "packed")


@pytest.mark.parametrize("option", ["continuity_fn", "fit_mesh"])
def test_build_refuses_unported(option):
    """A ``fit_mesh`` (a sharded fit), and the ``mesh`` of the row-sharded
    solve that ``continuity_fn`` runs, must be torch.distributed
    DeviceMeshes: any other object raises TypeError."""
    if option == "continuity_fn":
        fn = functools.partial(TC.enforce_continuity, mesh=object())
        with pytest.raises(TypeError, match="DeviceMesh"):
            TB.build(T.Config(**{**_CFG, "continuity": True}), _sphere,
                     device="cpu", continuity_fn=fn)
        return
    with pytest.raises(TypeError, match="DeviceMesh"):
        TB.build(T.Config(**_CFG), _sphere, device="cpu",
                 **{option: object()})


@pytest.mark.parametrize("continuity", [False, True])
def test_build_applies_continuity_fn(continuity):
    """``build`` applies ``continuity_fn`` to the packed tree only when the
    config asks for continuity (hpsdf_tpu/build.py:1017-1019), and
    ``build_octree`` supplies ``enforce_continuity`` then."""
    cfg = T.Config(**{**_CFG, "continuity": continuity})
    seen, lines = [], []
    tree = TB.build(cfg, _sphere, device="cpu", progress=lines.append,
                    continuity_fn=lambda t: seen.append(t) or t)
    assert len(seen) == int(continuity)
    assert (lines[-1] == "continuity post-process done") == continuity
    smoothed = T.build_octree(cfg, _sphere, device="cpu")
    assert torch.equal(smoothed.coeffs, tree.coeffs) != continuity
    if continuity:
        assert torch.equal(smoothed.coeffs,
                           TC.enforce_continuity(tree).coeffs)


@pytest.mark.parametrize("op", ["union_sdf", "subtract_sdf", "intersect_sdf"])
def test_csg_forwards_keywords(op):
    tree = T.build_octree(T.Config(**_CFG), _sphere, device="cpu")
    lines = []
    out = getattr(T, op)(tree, lambda p: p[:, 0] - 0.1,
                         progress=lines.append)
    assert out.device == tree.device and lines
    with pytest.raises(TypeError, match="DeviceMesh"):
        getattr(T, op)(tree, lambda p: p[:, 0], fit_mesh=object())


def test_exports():
    assert set(hp.__all__) - {"df64"} <= set(T.__all__)
    assert isinstance(T.render, types.ModuleType)
    assert isinstance(T.inverse, types.ModuleType)
    assert T.render.render is T.render_image
    assert T.inverse.fit_to_depth.__module__ == "hpsdf_tpu_torch.inverse"
