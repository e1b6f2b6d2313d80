"""Top-level user API: build, query and CSG (the counterpart of
``hpsdf_tpu/api.py``; reference Include/HP/Octree.h:50-86)."""

from __future__ import annotations

import torch

from . import accel
from . import build as _build
from . import query as _query
from .build import SDFFn
from .config import Config
from .tree import Octree


def build_octree(config: Config, F: SDFFn, **kw) -> Octree:
    """Approximate the batched SDF callable ``F`` (world pts (K,3) -> (K,),
    torch tensors on the build's device) with an hp-adaptive octree. The
    keywords go to ``build.build``: ``device`` (the CUDA device unless the
    caller passes another), ``progress``, ``continuity_fn``, ``fit_mesh``.

    Equivalent of Octree::Create (Source/HP/Octree.cpp:312-352), including
    the continuity post-process when config.continuity is set.
    """
    if config.continuity and "continuity_fn" not in kw:
        from . import continuity as _continuity

        kw["continuity_fn"] = _continuity.enforce_continuity
    return _build.build(config, F, **kw)


query = _query.query
query_with_gradient = _query.query_with_gradient
query_grid = _query.query_grid


def as_sdf(tree: Octree, packed_reads: bool | None = None) -> SDFFn:
    """A fitted octree as a batched SDF callable, usable as a build input:
    the composition behind the CSG rebuilds. Points outside the root take
    the clamped-boundary value.

    ``packed_reads`` picks the read path: the packed f32 layout (kernel K2
    on CUDA tensors; the default for float32 / compensated builds, whose
    CSG tolerance is 0.05 anyway) or the generic f64 ``query`` (kernel K1;
    the default for float64 builds)."""
    if packed_reads is None:
        packed_reads = tree.config.fit_dtype in ("float32", "compensated")
    if packed_reads:
        pt = accel.pack_tree(tree)

        def packed_fn(pts):
            return accel.values_at(pt, pts.to(torch.float32)).to(pts.dtype)

        return packed_fn

    def generic_fn(pts):
        return _query.query(tree, pts.to(torch.float64),
                            outside_value_max=False).to(pts.dtype)

    return generic_fn


def _csg(tree: Octree, F: SDFFn, combine, **kw) -> Octree:
    old = as_sdf(tree)
    kw.setdefault("device", tree.device)
    return build_octree(tree.config, lambda p: combine(old(p), F(p)), **kw)


def union_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating min(tree, F) (Octree::UnionSDF,
    Source/HP/Octree.cpp:355-374); ``kw`` go to ``build_octree``."""
    return _csg(tree, F, torch.minimum, **kw)


def subtract_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating max(-tree, F) (Octree::SubtractSDF,
    Source/HP/Octree.cpp:377-387); ``kw`` go to ``build_octree``."""
    return _csg(tree, F, lambda a, b: torch.maximum(-a, b), **kw)


def intersect_sdf(tree: Octree, F: SDFFn, **kw) -> Octree:
    """Rebuild approximating max(tree, F) (Octree::IntersectSDF,
    Source/HP/Octree.cpp:390-400); ``kw`` go to ``build_octree``."""
    return _csg(tree, F, torch.maximum, **kw)
