"""Field visualization (the counterpart of ``hpsdf_tpu/viz.py``; reference
Octree::OutputFunctionSlice, Source/HP/Octree.cpp:1131-1206).

Sample a z-slice of the fitted field on a square grid with one batched
``query`` (kernel K1 on CUDA trees), min-max rescale the two signs
separately, and write green = outside / blue = inside as a 24-bit BMP.
``slice_to_rgb`` and ``write_bmp`` are copied (numpy).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from .query import query
from .tree import Octree


def function_slice(tree: Octree, z: float, resolution: int = 2048
                   ) -> np.ndarray:
    """Sample f on the z = ``z`` plane over the root AABB. Returns
    (resolution, resolution) f64 values (row 0 = max y, matching image
    orientation)."""
    lo, hi = tree.root_aabb
    f64, dev = torch.float64, tree.device
    xs = torch.linspace(float(lo[0]), float(hi[0]), resolution, dtype=f64,
                        device=dev)
    ys = torch.linspace(float(hi[1]), float(lo[1]), resolution, dtype=f64,
                        device=dev)
    gx, gy = torch.meshgrid(xs, ys, indexing="xy")
    pts = torch.stack([gx, gy, torch.full_like(gx, z)], dim=-1).reshape(-1, 3)
    v = query(tree, pts, outside_value_max=False)
    return v.cpu().numpy().reshape(resolution, resolution)


def slice_to_rgb(values: np.ndarray) -> np.ndarray:
    """Min-max rescaled two-tone coloring (reference: Octree.cpp:1163-1199):
    outside (f >= 0) in green, inside (f < 0) in blue, each channel scaled
    by its own extremum. Returns (H, W, 3) uint8."""
    v = np.asarray(values, np.float64)
    pos_max = max(float(v.max(initial=0.0)), 1e-300)
    neg_min = min(float(v.min(initial=0.0)), -1e-300)
    img = np.zeros(v.shape + (3,), np.uint8)
    outside = v >= 0
    img[..., 1] = np.where(outside, (v / pos_max * 255.0), 0).astype(np.uint8)
    img[..., 2] = np.where(~outside, (v / neg_min * 255.0), 0).astype(np.uint8)
    return img


def write_bmp(path: str, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a 24-bit uncompressed BMP."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    row = w * 3
    pad = (-row) % 4
    img_size = (row + pad) * h
    header = struct.pack(
        "<2sIHHIIiiHHIIiiII",
        b"BM", 54 + img_size, 0, 0, 54,        # file header
        40, w, h, 1, 24, 0, img_size,          # BITMAPINFOHEADER
        2835, 2835, 0, 0)
    bgr = rgb[::-1, :, ::-1]                   # bottom-up rows, BGR order
    if pad:
        bgr = np.concatenate(
            [bgr.reshape(h, row),
             np.zeros((h, pad), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(bgr).tobytes())


def output_function_slice(tree: Octree, path: str, z: float = 0.0,
                          resolution: int = 2048) -> None:
    """One-call equivalent of Octree::OutputFunctionSlice."""
    write_bmp(path, slice_to_rgb(function_slice(tree, z, resolution)))
