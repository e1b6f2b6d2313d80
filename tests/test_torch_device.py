"""The port's entry points run on the CUDA device unless the caller passes
device="cpu": without a card the default raises the helper's RuntimeError
and never falls back to the CPU; with device="cpu" each entry point runs
its plain version there."""

import numpy as np
import pytest
import torch

import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import build as TB
from hpsdf_tpu_torch import render as TR
from hpsdf_tpu_torch import tree as TT
from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen, mesh_sdf

from .test_torch_query import few_torch_threads  # noqa: F401

_CFG = T.Config(target_error=1e-3, continuity=False, max_depth=4,
                max_degree=2)


def _sphere(p):
    return torch.linalg.norm(p, dim=-1) - 0.3


@pytest.fixture(scope="module")
def cpu_tree():
    return T.build_octree(_CFG, _sphere, device="cpu")


def _build(kw, tree, tmp):
    return TB.build(_CFG, _sphere, **kw).coeffs


def _build_octree(kw, tree, tmp):
    return T.build_octree(_CFG, _sphere, **kw).coeffs


def _from_numpy(kw, tree, tmp):
    return TT.from_numpy(TT.to_numpy(tree), tree.n_nodes, tree.deg_used,
                         tree.depth_used, tree.config, **kw).coeffs


def _pack(kw, tree, tmp):
    a = TT.to_numpy(tree)
    return TT.pack(a["child_idx"], a["centre"], a["depth"], a["degree"],
                   a["coeffs"], tree.n_nodes, tree.config, **kw).coeffs


def _load(kw, tree, tmp):
    path = str(tmp / "tree.npz")
    T.save(tree, path)
    return TT.load(path, **kw).coeffs


def _build_bvh(kw, tree, tmp):
    return build_bvh(build_mesh(*gen.icosphere(0.3, 1)), **kw).tri_rows


def _camera_rays(kw, tree, tmp):
    return TR.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=4,
                          height=4, **kw)[1]


def _mesh_sdf(kw, tree, tmp):
    F = mesh_sdf(build_mesh(*gen.icosphere(0.3, 1)), **kw)
    # F takes points on the device its rows went to
    pts = torch.as_tensor(np.random.default_rng(0).uniform(-0.5, 0.5,
                                                            (16, 3)),
                          device=kw.get("device", "cuda"))
    return F(pts)


ENTRY_POINTS = {
    "build.build": _build, "api.build_octree": _build_octree,
    "tree.from_numpy": _from_numpy, "tree.pack": _pack,
    "tree.load": _load, "mesh.bvh.build_bvh": _build_bvh,
    "render.camera_rays": _camera_rays, "mesh.sdf.mesh_sdf": _mesh_sdf,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_cuda(name, cpu_tree, tmp_path):
    call = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        assert call({}, cpu_tree, tmp_path).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device; pass "
                                               "device='cpu'"):
            call({}, cpu_tree, tmp_path)
    out = call({"device": "cpu"}, cpu_tree, tmp_path)
    assert out.device.type == "cpu" and bool(torch.isfinite(out).all())
