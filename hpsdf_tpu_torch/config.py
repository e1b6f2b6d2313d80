"""Build configuration.

A copy of ``hpsdf_tpu/config.py``: the equivalent of ``SDF::Config``
(reference: Include/HP/Config.h:12-43, Source/HP/Config.cpp:5-32).
Differences from the reference, by design:

  * ``thread_count`` is gone -- parallelism comes from batched device ops.
  * ``max_degree``/``max_depth`` are per-build knobs (the reference hard-codes
    BASIS_MAX_DEGREE=12 / TREE_MAX_DEPTH=10 at compile time).
  * ``node_capacity`` bounds the flat SoA node arrays (the reference grows a
    std::vector without bound).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from . import consts


class NearnessWeighting(enum.Enum):
    """Nearness-weighting modes for the per-node error (paper eqs (11)/(12);
    reference: Include/HP/Config.h:17-27)."""
    NONE = 0
    POLYNOMIAL = 1
    EXPONENTIAL = 2


@dataclasses.dataclass(frozen=True)
class Config:
    # Refinement stops when the summed node error drops below this
    # (reference: Config.h:36, default 1e-10 at Config.cpp:5-14).
    target_error: float = 1e-10

    nearness_weighting: NearnessWeighting = NearnessWeighting.NONE
    nearness_strength: float = 0.0

    continuity: bool = True
    continuity_strength: float = 8.0

    # Root AABB in world space: (min, max) corners.
    # Default unit cube centered at origin (reference: Config.cpp:12-13).
    root_min: tuple[float, float, float] = (-0.5, -0.5, -0.5)
    root_max: tuple[float, float, float] = (0.5, 0.5, 0.5)

    max_degree: int = consts.BASIS_MAX_DEGREE
    max_depth: int = consts.TREE_MAX_DEPTH

    # Static capacity of the SoA node arrays. Builds abort (with a clear
    # error) if refinement would exceed it.
    node_capacity: int = 200_000

    # Working dtype of the quadrature-projection fits. The reference fits in
    # f64 (Source/HP/Octree.cpp:1007-1093); "float64" reproduces that, on
    # whatever device the build runs. "compensated" is accepted for
    # compatibility with hpsdf_tpu, where it selects a double-float
    # (two-f32) projection for devices without an f64 datapath; the H100
    # has one, so here "compensated" means f64 and builds exactly what
    # "float64" builds. "float32" is the cheapest: a plain f32 projection,
    # fine whenever target_error >= ~1e-6.
    fit_dtype: str = "float64"

    enable_logging: bool = False

    def validate(self) -> None:
        """Mirror of Config::IsValid (reference: Source/HP/Config.cpp:17-32)."""
        if not (self.target_error > 0.0):
            raise ValueError("target_error must be > 0")
        if self.nearness_weighting != NearnessWeighting.NONE:
            if not (self.nearness_strength > 0.0):
                raise ValueError("nearness_strength must be > 0")
        if self.continuity and not (self.continuity_strength > 0.0):
            raise ValueError("continuity_strength must be > 0")
        rmin = np.asarray(self.root_min, dtype=np.float64)
        rmax = np.asarray(self.root_max, dtype=np.float64)
        if not np.all(rmax > rmin):
            raise ValueError("root AABB must have positive volume")
        if not (1 <= self.max_degree <= consts.BASIS_MAX_DEGREE):
            raise ValueError("max_degree out of range")
        if not (consts.COARSE_DEPTH <= self.max_depth <= consts.TREE_MAX_DEPTH):
            raise ValueError("max_depth out of range")
        if self.fit_dtype not in ("float32", "float64", "compensated"):
            raise ValueError(
                "fit_dtype must be 'float32', 'float64' or 'compensated'")

    # -- world <-> internal unit-cube transform -----------------------------
    # The build normalizes the domain so the tree always spans [-0.5, 0.5]^3
    # internally (reference: Source/HP/Octree.cpp:321-328).

    @property
    def root_centre(self) -> np.ndarray:
        return (np.asarray(self.root_min, np.float64)
                + np.asarray(self.root_max, np.float64)) * 0.5

    @property
    def root_sizes(self) -> np.ndarray:
        return (np.asarray(self.root_max, np.float64)
                - np.asarray(self.root_min, np.float64))
