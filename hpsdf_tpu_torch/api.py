"""Top-level user API: build and query (the counterpart of
``hpsdf_tpu/api.py``:25-40; reference Include/HP/Octree.h:50-86)."""

from __future__ import annotations

from . import build as _build
from . import query as _query
from .build import SDFFn
from .config import Config
from .tree import Octree


def build_octree(config: Config, F: SDFFn, *, device="cpu") -> Octree:
    """Approximate the batched SDF callable ``F`` (world pts (K,3) -> (K,),
    torch tensors on ``device``) with an hp-adaptive octree on ``device``.

    Equivalent of Octree::Create (Source/HP/Octree.cpp:312-352). The
    continuity post-process is not ported yet (ROADMAP.md, queue 1): a
    config that asks for it raises.
    """
    if config.continuity:
        raise NotImplementedError(
            "continuity=True: the continuity solve is not ported to "
            "hpsdf_tpu_torch yet (ROADMAP.md, queue 1 'Continuity'); "
            "build with continuity=False")
    return _build.build(config, F, device=device)


query = _query.query
query_with_gradient = _query.query_with_gradient
query_grid = _query.query_grid
