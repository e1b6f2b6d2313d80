"""Batched octree queries.

The counterpart of ``hpsdf_tpu/query.py``:

  * ``query``               <- Octree::Query (Source/HP/Octree.cpp:662-702)
  * ``query_with_gradient`` <- Octree::QueryWithGradient (:749-789), with
    exact analytic gradients.

For tensors on a CUDA device both go through kernel K1 (``csrc/query.cu``,
wrapper ``query_kernel``), which runs the descent, the Legendre evaluation
and the masking per point in one launch. For tensors on the CPU they run
the plain torch version (``descend`` + ``basis.eval_basis``), which is also
what the kernel is held against.

Gradients. On CPU tensors autograd differentiates the plain version. On
CUDA tensors ``query`` is differentiable with respect to ``tree.coeffs``:
its VJP is kernel K8 (``csrc/coeff_scatter.cu``, wrapper
``coeff_scatter_kernel``), which scatters each point's weighted basis
products into its leaf's coefficients, in f64; the same kernel serves the
sphere tracer's implicit VJP in f32 (``render.trace``). ``query`` with
respect to the points and ``query_with_gradient`` have no backward kernel
and raise on CUDA tensors when an input requires a gradient.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _kernels, basis, consts
from ._device import refuse_grad, wants_grad
from .tree import Octree

# Value returned for points outside the root AABB
# (reference returns std::numeric_limits<f64>::max(), Octree.cpp:668-671).
OUTSIDE_VALUE = float(np.finfo(np.float64).max)


def _to_unit(tree: Octree, pts: torch.Tensor) -> torch.Tensor:
    """World -> internal unit-cube coords (reference: Octree.cpp:665)."""
    centre = torch.as_tensor(tree.config.root_centre, dtype=pts.dtype,
                             device=pts.device)
    inv = torch.as_tensor(1.0 / tree.config.root_sizes, dtype=pts.dtype,
                          device=pts.device)
    return (pts - centre) * inv


def descend(tree: Octree, unit_pts: torch.Tensor) -> torch.Tensor:
    """Leaf index (B,) i32 containing each unit-cube point (B, 3): depth_used
    rounds of child = child_idx[cur] + (x>=cx) + 2(y>=cy) + 4(z>=cz), with
    leaves carried unchanged."""
    cur = torch.zeros(unit_pts.shape[:-1], dtype=torch.long,
                      device=unit_pts.device)
    child_idx = tree.child_idx.long()
    for _ in range(tree.depth_used):
        child0 = child_idx[cur]
        cc = tree.centre[cur]
        oct_ = ((unit_pts[..., 0] >= cc[..., 0]).long()
                + ((unit_pts[..., 1] >= cc[..., 1]).long() << 1)
                + ((unit_pts[..., 2] >= cc[..., 2]).long() << 2))
        cur = torch.where(child0 < 0, cur, child0 + oct_)
    return cur.int()


def _leaf_frame(tree: Octree, pts: torch.Tensor):
    """Inside-root mask, then each point's leaf: its coefficient row, the
    point in the leaf's [-1, 1]^3 frame, the leaf depth and 2**(depth+1)."""
    unit = _to_unit(tree, pts)
    inside = torch.all(unit.abs() <= 0.5, dim=-1)
    clamped = unit.clamp(-0.5, 0.5)
    leaf = descend(tree, clamped).long()
    depth = tree.depth[leaf]
    scale = torch.exp2((depth + 1).to(pts.dtype))
    local = (clamped - tree.centre[leaf]) * scale[..., None]
    return inside, tree.coeffs[leaf], local, depth, scale


def query_plain(tree: Octree, pts: torch.Tensor,
                outside_value_max: bool = True) -> torch.Tensor:
    """``query`` by the plain torch version of K1, whatever the device."""
    inside, coeffs, local, depth, _ = _leaf_frame(tree, pts)
    val = basis.eval_basis(coeffs, local, depth, tree.deg_used)
    return torch.where(inside, val, OUTSIDE_VALUE) if outside_value_max \
        else val


def query_with_gradient_plain(tree: Octree, pts: torch.Tensor):
    """``query_with_gradient`` by the plain torch version of K1, whatever
    the device."""
    inside, coeffs, local, depth, scale = _leaf_frame(tree, pts)
    val, g_local = basis.eval_basis_grad(coeffs, local, depth, tree.deg_used)
    # chain rule: local = (unit - centre) * 2**(depth+1); unit = (w - c)/sizes
    inv_sizes = torch.as_tensor(1.0 / tree.config.root_sizes,
                                dtype=pts.dtype, device=pts.device)
    g_world = g_local * scale[..., None] * inv_sizes
    norm = torch.linalg.norm(g_world, dim=-1, keepdim=True)
    unit_grad = g_world / torch.clamp(norm, min=1e-30)
    return torch.where(inside, val, OUTSIDE_VALUE), unit_grad


def query_kernel(tree: Octree, pts: torch.Tensor, with_grad: bool,
                 outside_value_max: bool = True):
    """Launch K1 on CUDA tensors: values (B,) f64, and with ``with_grad``
    also unit world gradients (B, 3) f64. Raises on anything else."""
    if pts.device.type != "cuda" or tree.device != pts.device:
        raise ValueError("query_kernel needs the tree and the points on one "
                         f"CUDA device (tree {tree.device}, pts {pts.device})")
    if pts.dtype != torch.float64 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be f64 (B, 3), got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    C = consts.coeff_count(tree.deg_used)
    for name, t, dt in (("child_idx", tree.child_idx, torch.int32),
                        ("centre", tree.centre, torch.float64),
                        ("depth", tree.depth, torch.int32),
                        ("coeffs", tree.coeffs, torch.float64)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"tree.{name} must be contiguous {dt}")
    if tree.coeffs.shape[1] != C or tree.centre.shape[1] != 3:
        raise ValueError("tree arrays do not match deg_used")
    if tree.centre.data_ptr() % 16:
        # the kernel reads each 24-byte centre as one 16- and one 8-byte load
        raise ValueError("tree.centre must be 16-byte aligned")
    pts = pts.contiguous()
    B = pts.shape[0]
    val = torch.empty(B, dtype=torch.float64, device=pts.device)
    grad = (torch.empty((B, 3), dtype=torch.float64, device=pts.device)
            if with_grad else None)
    if B == 0:
        return (val, grad) if with_grad else val
    lib = _kernels.load()
    rc = tree.config.root_centre
    inv = 1.0 / tree.config.root_sizes
    _kernels.check(lib, lib.hpsdf_query(
        tree.child_idx.data_ptr(), tree.centre.data_ptr(),
        tree.depth.data_ptr(), tree.coeffs.data_ptr(), tree.deg_used,
        tree.depth_used, pts.data_ptr(), B,
        float(rc[0]), float(rc[1]), float(rc[2]),
        float(inv[0]), float(inv[1]), float(inv[2]),
        int(outside_value_max), val.data_ptr(),
        grad.data_ptr() if with_grad else None,
        _kernels.stream_of(pts)), "query")
    query_kernel.launches += 1
    return (val, grad) if with_grad else val


query_kernel.launches = 0


def coeff_scatter_kernel(tree: Octree, cot: torch.Tensor, *, pts=None,
                         rays=None,
                         outside_value_max: bool = False) -> torch.Tensor:
    """Launch K8 on CUDA tensors: gradients (N, C) to ``tree.coeffs``.

    Query form (``pts`` (B, 3) f64, an f64 tree): the VJP of ``query``
    with cotangents ``cot`` (B,), nothing from points outside the root when
    ``outside_value_max`` (the sentinel is a constant). Trace form (``rays``
    = (origins, dirs, t, hit), f32 (B, 3), (B, 3), (B,), bool (B,); a tree
    with f32 ``centre`` and ``coeffs``): the trace's implicit VJP with
    ``cot`` = dt (B,) (``render.trace_vjp_plain``). A call is two
    operations on the card: the output's memset and the launch. Raises on
    anything else."""
    trace_form = rays is not None
    if (pts is None) != trace_form:
        raise ValueError("coeff_scatter_kernel takes pts or rays")
    dt = torch.float32 if trace_form else torch.float64
    ref = rays[0] if trace_form else pts
    if ref.device.type != "cuda" or tree.device != ref.device:
        raise ValueError("coeff_scatter_kernel needs the tree and the points "
                         f"on one CUDA device (tree {tree.device}, points "
                         f"{ref.device})")
    B = ref.shape[0]
    for name, t, want in (("child_idx", tree.child_idx, torch.int32),
                          ("centre", tree.centre, dt),
                          ("depth", tree.depth, torch.int32),
                          ("coeffs", tree.coeffs, dt)):
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"tree.{name} must be contiguous {want}")
    if tree.coeffs.shape[1] != consts.coeff_count(tree.deg_used):
        raise ValueError("tree arrays do not match deg_used")
    if cot.shape != (B,) or cot.dtype != dt or cot.device != ref.device:
        raise ValueError(f"cot must be {dt} ({B},) on {ref.device}")
    if trace_form:
        o, d, t, hit = rays
        if o.shape != (B, 3) or d.shape != (B, 3) or t.shape != (B,) \
                or hit.shape != (B,) or hit.dtype != torch.bool \
                or any(x.dtype != torch.float32 for x in (o, d, t)):
            raise ValueError("rays must be f32 origins and dirs (B, 3), f32 "
                             "t (B,) and bool hit (B,)")
        o, d, t, hit = (x.detach().contiguous() for x in (o, d, t, hit))
        ptrs = (None, o.data_ptr(), d.data_ptr(), t.data_ptr(),
                hit.data_ptr())
    else:
        if pts.dtype != torch.float64 or pts.shape != (B, 3):
            raise ValueError(f"pts must be f64 (B, 3), got {pts.dtype} "
                             f"{tuple(pts.shape)}")
        pts = pts.detach().contiguous()
        ptrs = (pts.data_ptr(), None, None, None, None)
    cot = cot.detach().contiguous()
    out = torch.zeros(tree.coeffs.shape, dtype=dt, device=ref.device)
    if B == 0:
        return out
    lib = _kernels.load()
    rc = tree.config.root_centre
    inv = 1.0 / tree.config.root_sizes
    if trace_form:     # the f32 constants of the reference's f32 path
        rc = np.asarray(rc, np.float32)
        inv = np.asarray(inv, np.float32)
    _kernels.check(lib, lib.hpsdf_coeff_scatter(
        tree.child_idx.data_ptr(), tree.centre.data_ptr(),
        tree.depth.data_ptr(), tree.coeffs.detach().data_ptr(),
        tree.deg_used, tree.depth_used, *ptrs, B, *map(float, rc),
        *map(float, inv), cot.data_ptr(), int(outside_value_max),
        dt.itemsize, out.data_ptr(),
        _kernels.stream_of(ref)), "coeff_scatter")
    coeff_scatter_kernel.launches += 1
    return out


coeff_scatter_kernel.launches = 0


def query_vjp_plain(tree: Octree, pts: torch.Tensor, w: torch.Tensor,
                    outside_value_max: bool = True) -> torch.Tensor:
    """K8's query form by autograd of ``query_plain``: the gradient (N, C)
    of sum(w * query) with respect to ``tree.coeffs``."""
    coeffs = tree.coeffs.detach().requires_grad_(True)
    with torch.enable_grad():
        v = query_plain(dataclasses.replace(tree, coeffs=coeffs),
                        pts.detach(), outside_value_max)
        (d,) = torch.autograd.grad(v, coeffs, w)
    return d


class _Query(torch.autograd.Function):
    """K1, with K8 (query form) as its VJP with respect to the
    coefficients."""

    @staticmethod
    def forward(ctx, coeffs, tree, pts, outside_value_max):
        ctx.save_for_backward(pts)
        ctx.tree, ctx.outside_value_max = tree, outside_value_max
        return query_kernel(tree, pts, False, outside_value_max)

    @staticmethod
    def backward(ctx, w):
        (pts,) = ctx.saved_tensors
        d = coeff_scatter_kernel(ctx.tree, w.contiguous(), pts=pts,
                                 outside_value_max=ctx.outside_value_max)
        return d, None, None, None


def query(tree: Octree, pts: torch.Tensor, outside_value_max: bool = True):
    """Approximated signed distance at world points ``pts`` (B, 3) -> (B,).

    Negative inside the surface. Points outside the root AABB return the f64
    max sentinel unless ``outside_value_max`` is False, in which case they
    return the clamped-boundary evaluation. Differentiable with respect to
    ``tree.coeffs`` (kernel K8 on CUDA tensors); on CUDA tensors not with
    respect to the points or the centres.
    """
    if pts.device.type == "cpu":
        return query_plain(tree, pts, outside_value_max)
    refuse_grad("query with respect to the points or centres", pts,
                 tree.centre)
    if wants_grad(tree.coeffs):
        return _Query.apply(tree.coeffs, tree, pts, outside_value_max)
    return query_kernel(tree, pts, False, outside_value_max)


def query_with_gradient(tree: Octree, pts: torch.Tensor):
    """Value and unit world-space gradient at ``pts`` (B, 3).
    Returns (val (B,), unit_grad (B, 3)). No gradient on CUDA tensors."""
    if pts.device.type == "cpu":
        return query_with_gradient_plain(tree, pts)
    refuse_grad("query_with_gradient", pts, tree.centre, tree.coeffs)
    return query_kernel(tree, pts, True)


def query_grid(tree: Octree, resolution: int, axis_min=None, axis_max=None):
    """Query a uniform resolution^3 grid over the root AABB (the reference's
    grid benchmark, Source/Tests/HPBenchmarks.cpp:118-166)."""
    lo, hi = tree.root_aabb
    if axis_min is not None:
        lo = axis_min
    if axis_max is not None:
        hi = axis_max
    axes = [torch.linspace(float(lo[a]), float(hi[a]), resolution,
                           dtype=torch.float64, device=tree.device)
            for a in range(3)]
    g = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
    return query(tree, g.reshape(-1, 3)).reshape(resolution, resolution,
                                                 resolution)
