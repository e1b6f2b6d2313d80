"""Flat SoA octree state as torch tensors.

The counterpart of ``hpsdf_tpu/tree.py``, with the same layout:

  child_idx[N] : first-child index, -1 for leaves
  centre[N,3]  : cell centre in the internal unit cube [-0.5, 0.5]^3
  depth[N]     : cell depth, cell size = 2**-depth
  degree[N]    : basis total degree, -1 for interior nodes
  coeffs[N,C]  : zero-padded coefficient rows, C = coeff_count(deg_used)

The tree lives on one device, in f64 there (the H100 has an f64 datapath).
``save``/``load`` write and read the npz schema of ``hpsdf_tpu.tree``
(``SERIAL_VERSION`` 1) byte for byte, so a tree saved by either package
loads in the other; ``from_numpy``/``to_numpy`` carry the arrays across in
memory.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from . import _device, consts
from .config import Config, NearnessWeighting


SERIAL_VERSION = 1
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")
_DTYPES = dict(child_idx=torch.int32, centre=torch.float64,
               depth=torch.int32, degree=torch.int32, coeffs=torch.float64)


@dataclasses.dataclass(frozen=True)
class Octree:
    child_idx: torch.Tensor    # i32[N]
    centre: torch.Tensor       # f64[N, 3] internal unit-cube coords
    depth: torch.Tensor        # i32[N]
    degree: torch.Tensor       # i32[N]
    coeffs: torch.Tensor       # f64[N, C]

    n_nodes: int
    deg_used: int
    depth_used: int
    config: Config

    @property
    def device(self) -> torch.device:
        return self.child_idx.device

    @property
    def root_aabb(self) -> tuple[np.ndarray, np.ndarray]:
        return (np.asarray(self.config.root_min, np.float64),
                np.asarray(self.config.root_max, np.float64))

    def num_leaves(self) -> int:
        return int((self.child_idx[: self.n_nodes] < 0).sum())

    def total_coeffs(self) -> int:
        """Sum of per-leaf true coefficient counts (the reference's
        serialized nCoeffs, Source/HP/Octree.cpp:428-435)."""
        deg = self.degree[: self.n_nodes].cpu().numpy()
        return int(sum(consts.coeff_count(int(d)) for d in deg[deg >= 0]))


def from_numpy(arrays: dict, n_nodes: int, deg_used: int, depth_used: int,
               config: Config, device=_device.DEFAULT) -> Octree:
    """Octree from numpy arrays keyed child_idx/centre/depth/degree/coeffs
    (e.g. ``np.asarray`` of an ``hpsdf_tpu`` tree's fields)."""
    device = _device.resolve(device)
    t = {k: torch.tensor(np.asarray(arrays[k]), dtype=_DTYPES[k],
                         device=device)                      # copies
         for k in _ARRAYS}
    return Octree(**t, n_nodes=int(n_nodes), deg_used=int(deg_used),
                  depth_used=int(depth_used), config=config)


def to_numpy(tree: Octree) -> dict:
    """The inverse of ``from_numpy``: the five arrays as host numpy."""
    return {k: getattr(tree, k).cpu().numpy() for k in _ARRAYS}


def pack(child_idx: np.ndarray, centre: np.ndarray, depth: np.ndarray,
         degree: np.ndarray, coeffs: np.ndarray, n_nodes: int,
         config: Config, pad_to: int = 8, *,
         device=_device.DEFAULT) -> Octree:
    """Pack host build arrays into an Octree on ``device``.

    Trims the coefficient width to the maximum degree actually used and pads
    the node dimension to a multiple of ``pad_to`` (dummy rows are leaves
    with zero coeffs), as ``hpsdf_tpu.tree.pack`` does.
    """
    device = _device.resolve(device)
    n = int(n_nodes)
    deg_used = int(max(0, degree[:n].max(initial=0)))
    depth_used = int(depth[:n].max(initial=0))
    width = consts.coeff_count(deg_used)

    n_pad = -(-n // pad_to) * pad_to
    ci = np.full(n_pad, consts.NO_CHILD, np.int32)
    ce = np.zeros((n_pad, 3), np.float64)
    dp = np.zeros(n_pad, np.int32)
    dg = np.full(n_pad, consts.NO_BASIS, np.int32)
    co = np.zeros((n_pad, width), np.float64)

    ci[:n] = child_idx[:n]
    ce[:n] = centre[:n]
    dp[:n] = depth[:n]
    dg[:n] = degree[:n]
    co[:n] = coeffs[:n, :width]
    return from_numpy(dict(child_idx=ci, centre=ce, depth=dp, degree=dg,
                           coeffs=co), n, deg_used, depth_used, config,
                      device)


def save(tree: Octree, path: str) -> None:
    """Write the versioned npz schema of ``hpsdf_tpu.tree.save``."""
    cfg = tree.config
    meta = dict(
        version=SERIAL_VERSION,
        n_nodes=tree.n_nodes, deg_used=tree.deg_used,
        depth_used=tree.depth_used,
        config=dict(
            target_error=cfg.target_error,
            nearness_weighting=cfg.nearness_weighting.value,
            nearness_strength=cfg.nearness_strength,
            continuity=cfg.continuity,
            continuity_strength=cfg.continuity_strength,
            root_min=list(cfg.root_min), root_max=list(cfg.root_max),
            max_degree=cfg.max_degree, max_depth=cfg.max_depth,
            node_capacity=cfg.node_capacity,
        ),
    )
    np.savez_compressed(
        path,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **to_numpy(tree))


def load(path: str, device=_device.DEFAULT) -> Octree:
    """Read a tree saved by either package onto ``device``."""
    device = _device.resolve(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta["version"] != SERIAL_VERSION:
            raise ValueError(f"unsupported octree schema v{meta['version']}")
        c = meta["config"]
        cfg = Config(
            target_error=c["target_error"],
            nearness_weighting=NearnessWeighting(c["nearness_weighting"]),
            nearness_strength=c["nearness_strength"],
            continuity=c["continuity"],
            continuity_strength=c["continuity_strength"],
            root_min=tuple(c["root_min"]), root_max=tuple(c["root_max"]),
            max_degree=c["max_degree"], max_depth=c["max_depth"],
            node_capacity=c["node_capacity"],
        )
        return from_numpy({k: z[k] for k in _ARRAYS}, meta["n_nodes"],
                          meta["deg_used"], meta["depth_used"], cfg, device)
