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
CUDA tensors both are differentiable with respect to ``tree.coeffs``, the
points and ``tree.centre``, through backward kernels, in f64:

  * ``query`` to the coefficients: K8 (``csrc/coeff_scatter.cu``, wrapper
    ``coeff_scatter_kernel``), which scatters each point's weighted basis
    products into its leaf's coefficients; the same kernel serves the
    sphere tracer's implicit VJP in f32 (``render.trace``);
  * ``query`` to the points: K1v, and ``query_with_gradient`` to the
    points: K1h, the backward modes of K1 (``query_vjp_kernel``), which
    evaluate each point's leaf to one order higher (K1h: the Hessian) from
    the leaf the forward found: a forward whose points need a gradient
    writes it (``query_kernel(..., with_leaf=True)``, 4 bytes a point) and
    saves it for the backward, which runs no descent;
  * ``query_with_gradient`` to the coefficients: K8g
    (``coeff_scatter_grad_kernel``), K8 with the unit gradient's term;
  * both to ``tree.centre``: K1c, K1v's or K1h's launch in its centre mode
    (``query_vjp_kernel(..., centre=True)``), from the same leaf: each
    point's leaf frame cotangent times -2^(depth+1), summed into its leaf's
    row; one launch writes the points' gradient too where they need one.

Points are clamped into the root by ``clip_half``, whose derivative is
``jnp.clip``'s: 1 inside, 1/2 on a face of the root, 0 outside; the unit
gradient's floor splits a tie as ``jnp.maximum`` does (``unit_vector``).
The centres enter after the clamp, so their derivative takes no slope.

The node axis of ``parallel.py`` splits the node arrays over ranks; there
a query is ``descend_round`` depth_used times and ``leaf_eval`` once, each
summed over the ranks, and its VJP ``coeff_scatter_nodes``: the node-range
modes of K1 (``query_nodes_kernel``) and K8
(``coeff_scatter_nodes_kernel``: a sort of the live points by tile of
rows, ``node_buckets_kernel``, then a block a tile writing its rows once)
on CUDA tensors, their plain versions on CPU tensors; to the block's
centre rows K1c on the block (``query_centre_vjp``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _kernels, basis, consts
from ._device import wants_grad
from .tree import Octree

# Value returned for points outside the root AABB
# (reference returns std::numeric_limits<f64>::max(), Octree.cpp:668-671).
OUTSIDE_VALUE = float(np.finfo(np.float64).max)


def clip_half(x: torch.Tensor) -> torch.Tensor:
    """``x`` clamped into [-0.5, 0.5] as ``jnp.clip`` clamps it, a maximum
    then a minimum, so that its derivative is jnp.clip's: 1 inside, 1/2
    on a face (each splits a tie), 0 outside. ``torch.clamp`` passes 1 on
    the faces."""
    return torch.minimum(torch.maximum(x, x.new_tensor(-0.5)),
                         x.new_tensor(0.5))


def clip_slope(x: torch.Tensor) -> torch.Tensor:
    """``clip_half``'s derivative at ``x``, a constant: 1, 1/2 or 0."""
    a = x.detach().abs()
    return torch.where(a < 0.5, 1.0, torch.where(a == 0.5, 0.5, 0.0)).to(
        x.dtype)


def unit_vector(g: torch.Tensor, floor: float) -> torch.Tensor:
    """g / max(|g|, floor) along the last axis, the floor taken by
    ``torch.maximum``, whose derivative splits a tie as ``jnp.maximum``'s
    does (``torch.clamp`` gives it whole to the norm)."""
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    return g / torch.maximum(norm, norm.new_tensor(floor))


def _to_unit(tree: Octree, pts: torch.Tensor) -> torch.Tensor:
    """World -> internal unit-cube coords (reference: Octree.cpp:665)."""
    centre = torch.as_tensor(tree.config.root_centre, dtype=pts.dtype,
                             device=pts.device)
    inv = torch.as_tensor(1.0 / tree.config.root_sizes, dtype=pts.dtype,
                          device=pts.device)
    return (pts - centre) * inv


def _round(tree, row: torch.Tensor, cur: torch.Tensor,
           unit_pts: torch.Tensor) -> torch.Tensor:
    """One descent round from the nodes ``cur`` (long), row ``row`` of the
    tree's arrays: child_idx + (x>=cx) + 2(y>=cy) + 4(z>=cz), or ``cur``
    itself on a leaf."""
    child0 = tree.child_idx[row].long()
    cc = tree.centre[row]
    oct_ = ((unit_pts[..., 0] >= cc[..., 0]).long()
            + ((unit_pts[..., 1] >= cc[..., 1]).long() << 1)
            + ((unit_pts[..., 2] >= cc[..., 2]).long() << 2))
    return torch.where(child0 < 0, cur, child0 + oct_)


def descend(tree: Octree, unit_pts: torch.Tensor) -> torch.Tensor:
    """Leaf index (B,) i32 containing each unit-cube point (B, 3): depth_used
    rounds (``_round``), leaves carried unchanged."""
    cur = torch.zeros(unit_pts.shape[:-1], dtype=torch.long,
                      device=unit_pts.device)
    for _ in range(tree.depth_used):
        cur = _round(tree, cur, cur, unit_pts)
    return cur.int()


def _frame(tree, row: torch.Tensor, clamped: torch.Tensor):
    """The points in the [-1, 1]^3 frames of the leaves at row ``row`` of
    the tree's arrays: (local, depth, 2**(depth+1))."""
    depth = tree.depth[row]
    scale = torch.exp2((depth + 1).to(clamped.dtype))
    return (clamped - tree.centre[row]) * scale[..., None], depth, scale


def query_leaf_plain(tree: Octree, pts: torch.Tensor) -> torch.Tensor:
    """Each point's leaf (B,) i32, as K1 writes it with ``with_leaf``: the
    descent of the point clamped into the root by ``clip_half``."""
    return descend(tree, clip_half(_to_unit(tree, pts.detach())))


def _leaf_frame(tree: Octree, pts: torch.Tensor, leaf=None):
    """Inside-root mask, then each point's leaf (``leaf`` (B,), or its
    descent when None): its coefficient row, the point in the leaf's
    [-1, 1]^3 frame, the leaf depth and 2**(depth+1). The point is clamped
    into the root by ``clip_half``."""
    unit = _to_unit(tree, pts)
    inside = torch.all(unit.abs() <= 0.5, dim=-1)
    clamped = clip_half(unit)
    leaf = (descend(tree, clamped.detach()) if leaf is None else leaf).long()
    local, depth, scale = _frame(tree, leaf, clamped)
    return inside, tree.coeffs[leaf], local, depth, scale


def query_plain(tree: Octree, pts: torch.Tensor,
                outside_value_max: bool = True, leaf=None) -> torch.Tensor:
    """``query`` by the plain torch version of K1, whatever the device;
    from the leaves ``leaf`` (B,) where given, else by the descent."""
    inside, coeffs, local, depth, _ = _leaf_frame(tree, pts, leaf)
    val = basis.eval_basis(coeffs, local, depth, tree.deg_used)
    return torch.where(inside, val, OUTSIDE_VALUE) if outside_value_max \
        else val


def query_with_gradient_plain(tree: Octree, pts: torch.Tensor, leaf=None):
    """``query_with_gradient`` by the plain torch version of K1, whatever
    the device; from the leaves ``leaf`` (B,) where given."""
    inside, coeffs, local, depth, scale = _leaf_frame(tree, pts, leaf)
    val, g_local = basis.eval_basis_grad(coeffs, local, depth, tree.deg_used)
    # chain rule: local = (unit - centre) * 2**(depth+1); unit = (w - c)/sizes
    inv_sizes = torch.as_tensor(1.0 / tree.config.root_sizes,
                                dtype=pts.dtype, device=pts.device)
    g_world = g_local * scale[..., None] * inv_sizes
    return torch.where(inside, val, OUTSIDE_VALUE), unit_vector(g_world,
                                                                1e-30)


def _check_f64(tree: Octree, pts: torch.Tensor, who: str) -> None:
    """What K1 and its backward modes take: the tree and f64 points (B, 3)
    on one CUDA device, the tree's arrays contiguous, its centres 16-byte
    aligned."""
    if pts.device.type != "cuda" or tree.device != pts.device:
        raise ValueError(f"{who} needs the tree and the points on one "
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


def _cotangents(B: int, dev, *cots) -> list:
    """Cotangents as contiguous detached f64 tensors: (B,) for the values,
    (B, 3) for the unit gradients."""
    out = []
    for c, shape in zip(cots, ((B,), (B, 3))):
        if c.shape != shape or c.dtype != torch.float64 or c.device != dev:
            raise ValueError(f"cotangent must be f64 {shape} on {dev}, got "
                             f"{c.dtype} {tuple(c.shape)} on {c.device}")
        out.append(c.detach().contiguous())
    return out


def query_kernel(tree: Octree, pts: torch.Tensor, with_grad: bool,
                 outside_value_max: bool = True, with_leaf: bool = False):
    """Launch K1 on CUDA tensors: values (B,) f64, with ``with_grad`` also
    unit world gradients (B, 3) f64, and with ``with_leaf`` last each
    point's leaf (B,) i32 (``query_leaf_plain``), which the backward modes
    (``query_vjp_kernel``) start from. Raises on anything else."""
    _check_f64(tree, pts, "query_kernel")
    pts = pts.contiguous()
    B = pts.shape[0]
    val = torch.empty(B, dtype=torch.float64, device=pts.device)
    grad = (torch.empty((B, 3), dtype=torch.float64, device=pts.device)
            if with_grad else None)
    leaf = (torch.empty(B, dtype=torch.int32, device=pts.device)
            if with_leaf else None)
    out = (val,) + ((grad,) if with_grad else ()) \
        + ((leaf,) if with_leaf else ())
    out = out if len(out) > 1 else val
    if B == 0:
        return out
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
        leaf.data_ptr() if with_leaf else None,
        _kernels.stream_of(pts)), "query")
    query_kernel.launches += 1
    query_kernel.leaf_launches += int(with_leaf)
    return out


query_kernel.launches = 0
query_kernel.leaf_launches = 0


def query_vjp_kernel(tree: Octree, pts: torch.Tensor, leaf: torch.Tensor,
                     w: torch.Tensor, wn: torch.Tensor | None = None,
                     outside_value_max: bool = True, *, points: bool = True,
                     centre: bool = False):
    """Launch K1's backward modes on CUDA tensors: the gradient (B, 3) f64
    with respect to the points of sum(w * query) (K1v, ``wn`` None;
    nothing from points outside the root when ``outside_value_max``), or
    of sum(w * value) + sum(wn * unit_grad) of ``query_with_gradient``
    (K1h), from each point's leaf ``leaf`` (B,) i32 as K1 wrote it for
    these points (``query_kernel(..., with_leaf=True)``); a leaf from
    anywhere else gives another function's VJP. One launch a call.

    With ``centre``, K1c: the same launch also gives the gradient (hi - lo,
    3) f64 with respect to the centre rows [lo, hi) the tree holds (all N
    of an ``Octree``; a node block's own, ``parallel.ShardedTree``, from
    the points whose global leaf it holds), into a table zeroed first: two
    operations on the card, the memset and the launch. ``points`` False
    leaves the points' gradient out, as a node block must. Returns the
    points' gradient, the centres', or both as (d_pts, d_centre). Raises
    on anything else."""
    _check_f64(tree, pts, "query_vjp_kernel")
    pts = pts.detach().contiguous()
    B = pts.shape[0]
    if leaf.shape != (B,) or leaf.dtype != torch.int32 \
            or leaf.device != pts.device:
        raise ValueError(f"leaf must be i32 ({B},) on {pts.device}, got "
                         f"{leaf.dtype} {tuple(leaf.shape)} on "
                         f"{leaf.device}")
    # the node rows the arrays hold: all of an Octree's, a block's own
    lo, hi = getattr(tree, "lo", 0), getattr(tree, "hi", tree.centre.shape[0])
    if not (points or centre) or (points and (lo, hi) != (
            0, tree.centre.shape[0])):
        raise ValueError("query_vjp_kernel gives the points' gradient on a "
                         "whole tree, the centres' with centre=True")
    leaf = leaf.contiguous()
    hess = wn is not None
    cots = _cotangents(B, pts.device, w, *((wn,) if hess else ()))
    d_pts = (torch.empty((B, 3), dtype=torch.float64, device=pts.device)
             if points else None)
    d_centre = (torch.zeros((max(hi - lo, 0), 3), dtype=torch.float64,
                            device=pts.device) if centre else None)
    out = d_centre if not points else (d_pts, d_centre) if centre else d_pts
    if B == 0 or hi <= lo:
        return out
    lib = _kernels.load()
    rc = tree.config.root_centre
    inv = 1.0 / tree.config.root_sizes
    args = (pts.data_ptr(), leaf.data_ptr(), B, *map(float, rc),
            *map(float, inv), int(outside_value_max or hess),
            cots[0].data_ptr(), cots[1].data_ptr() if hess else None,
            d_pts.data_ptr() if points else None)
    arrays = (tree.centre.detach().data_ptr(), tree.depth.data_ptr(),
              tree.coeffs.detach().data_ptr(), tree.deg_used)
    if centre:
        _kernels.check(lib, lib.hpsdf_query_centre_vjp(
            *arrays, lo, hi, *args, d_centre.data_ptr(),
            _kernels.stream_of(pts)), "query_centre_vjp")
    else:
        _kernels.check(lib, lib.hpsdf_query_vjp(
            *arrays, *args, _kernels.stream_of(pts)), "query_vjp")
    query_vjp_kernel.launches += 1
    query_vjp_kernel.hess_launches += int(hess and not centre)
    query_vjp_kernel.centre_launches += int(centre)
    return out


# all launches; apart, K1h's and K1c's (either order, with or without the
# points)
query_vjp_kernel.launches = 0
query_vjp_kernel.hess_launches = 0
query_vjp_kernel.centre_launches = 0


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


def coeff_scatter_grad_kernel(tree: Octree, pts: torch.Tensor,
                              wv: torch.Tensor,
                              wn: torch.Tensor) -> torch.Tensor:
    """Launch K8g on CUDA tensors: the gradient (N, C) f64 with respect to
    ``tree.coeffs`` of sum(wv * value) + sum(wn * unit_grad) of
    ``query_with_gradient`` at ``pts`` (B, 3) f64. A call is two
    operations on the card: the output's memset and the launch. Raises on
    anything else."""
    _check_f64(tree, pts, "coeff_scatter_grad_kernel")
    pts = pts.detach().contiguous()
    B = pts.shape[0]
    wv, wn = _cotangents(B, pts.device, wv, wn)
    out = torch.zeros(tree.coeffs.shape, dtype=torch.float64,
                      device=pts.device)
    if B == 0:
        return out
    lib = _kernels.load()
    rc = tree.config.root_centre
    inv = 1.0 / tree.config.root_sizes
    _kernels.check(lib, lib.hpsdf_coeff_scatter_grad(
        tree.child_idx.data_ptr(), tree.centre.data_ptr(),
        tree.depth.data_ptr(), tree.coeffs.detach().data_ptr(),
        tree.deg_used, tree.depth_used, pts.data_ptr(), B,
        *map(float, rc), *map(float, inv), wv.data_ptr(), wn.data_ptr(),
        out.data_ptr(), _kernels.stream_of(pts)), "coeff_scatter_grad")
    coeff_scatter_grad_kernel.launches += 1
    return out


coeff_scatter_grad_kernel.launches = 0


def _grads(fn, inputs, cot) -> tuple:
    """The VJP of fn(*inputs) with cotangents ``cot``, by autograd, with
    respect to each input: zeros where the output does not depend on it
    (a degree-0 basis does not depend on the points)."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    with torch.enable_grad():
        out = fn(*xs)
        outs, cots = (out, cot) if isinstance(out, tuple) else ((out,),
                                                               (cot,))
        live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        d = torch.autograd.grad([o for o, _ in live], xs,
                                [c for _, c in live], allow_unused=True) \
            if live else [None] * len(xs)
    return tuple(torch.zeros_like(x) if g is None else g
                 for g, x in zip(d, xs))


def query_vjp_plain(tree: Octree, pts: torch.Tensor, w: torch.Tensor,
                    outside_value_max: bool = True) -> torch.Tensor:
    """K8's query form by autograd of ``query_plain``: the gradient (N, C)
    of sum(w * query) with respect to ``tree.coeffs``."""
    return _grads(lambda c: query_plain(dataclasses.replace(tree, coeffs=c),
                                        pts.detach(), outside_value_max),
                  (tree.coeffs,), w)[0]


def query_points_vjp_plain(tree: Octree, pts: torch.Tensor, w: torch.Tensor,
                           outside_value_max: bool = True,
                           leaf=None) -> torch.Tensor:
    """K1v by autograd of ``query_plain``: the gradient (B, 3) of
    sum(w * query) with respect to the points, from the leaves ``leaf``
    (B,) where given (K1v's inputs), else by the descent."""
    return _grads(lambda p: query_plain(tree, p, outside_value_max, leaf),
                  (pts,), w)[0]


def query_with_gradient_vjp_plain(tree: Octree, pts: torch.Tensor,
                                  wv: torch.Tensor, wn: torch.Tensor,
                                  leaf=None):
    """K8g and K1h by autograd of ``query_with_gradient_plain``: the
    gradients (N, C) and (B, 3) of sum(wv * value) + sum(wn * unit_grad)
    with respect to ``tree.coeffs`` and the points, from the leaves
    ``leaf`` (B,) where given (K1h's inputs), else by the descent."""
    return _grads(lambda c, p: query_with_gradient_plain(
        dataclasses.replace(tree, coeffs=c), p, leaf), (tree.coeffs, pts),
        (wv, wn))


def query_centre_vjp_plain(tree, pts: torch.Tensor, w: torch.Tensor,
                           wn: torch.Tensor | None = None,
                           outside_value_max: bool = True,
                           leaf=None) -> torch.Tensor:
    """K1c by autograd of ``query_plain`` (``wn`` None: sum(w * query),
    nothing from points outside the root when ``outside_value_max``) or of
    ``query_with_gradient_plain`` (sum(w * value) + sum(wn * unit_grad)):
    the gradient (hi - lo, 3) with respect to the centre rows [lo, hi) the
    tree holds, from the leaves ``leaf`` (B,) where given, else by the
    descent. A node block (``parallel.ShardedTree``) needs the global
    leaves; it answers the points whose leaf it holds, as K1c's row range
    does."""
    pts = pts.detach()
    if hasattr(tree, "lo"):
        if tree.hi <= tree.lo:
            return torch.zeros((0, 3), dtype=w.dtype, device=w.device)
        leaf, own = _block_rows(tree, leaf)
        w = torch.where(own, w, 0.0)
        wn = None if wn is None else torch.where(own[:, None], wn, 0.0)

    def f(c):
        t = dataclasses.replace(tree, centre=c)
        if wn is None:
            return query_plain(t, pts, outside_value_max, leaf)
        return query_with_gradient_plain(t, pts, leaf)

    return _grads(f, (tree.centre,), w if wn is None else (w, wn))[0]


def query_centre_vjp(tree, pts, leaf, w, wn=None, outside_value_max=True):
    """K1c's VJP to the centre rows the tree holds (a whole tree or a node
    block): the plain version on CPU tensors, the kernel on CUDA
    tensors."""
    if pts.device.type == "cpu":
        return query_centre_vjp_plain(tree, pts, w, wn, outside_value_max,
                                      leaf)
    return query_vjp_kernel(tree, pts, leaf, w, wn, outside_value_max,
                            points=False, centre=True)


# --------------------------------------------------------------------------
# The node-range modes of K1 and K8 (the node axis of parallel.py)
# --------------------------------------------------------------------------
#
# ``block`` is a rank's share of a node-sharded tree
# (``parallel.ShardedTree``): the rows [block.lo, block.hi) of the node
# arrays, row n being node lo + n, child indices global. A rank answers the
# points whose node lies in its range and gives 0 for every other point, so
# the sum over the node axis's ranks is the one-device answer, exactly.

def _block_rows(block, idx: torch.Tensor):
    """Each global node index's row in the block's arrays (row 0 where the
    block does not hold it), and whether it holds it."""
    idx = idx.long()
    own = (idx >= block.lo) & (idx < block.hi)
    return torch.where(own, idx - block.lo, 0), own


def descend_round_plain(block, unit: torch.Tensor,
                        cur: torch.Tensor) -> torch.Tensor:
    """K1's node-range descent round by plain torch: for each clamped
    unit-cube point (B, 3) whose node ``cur`` (B,) lies in the block, its
    next node (``descend``'s round: ``cur`` itself on a leaf); 0 elsewhere.
    Returns (B,) i32."""
    if block.hi <= block.lo:
        return torch.zeros_like(cur, dtype=torch.int32)
    row, own = _block_rows(block, cur)
    return torch.where(own, _round(block, row, cur.long(), unit), 0).int()


def leaf_eval_plain(block, unit: torch.Tensor,
                    leaf: torch.Tensor) -> torch.Tensor:
    """K1's node-range leaf evaluation by plain torch: the value (B,) f64 of
    each clamped unit-cube point whose leaf lies in the block, as
    ``query_plain`` evaluates it; 0 elsewhere."""
    if block.hi <= block.lo:
        return torch.zeros(unit.shape[:-1], dtype=unit.dtype,
                           device=unit.device)
    row, own = _block_rows(block, leaf)
    local, depth, _ = _frame(block, row, unit)
    val = basis.eval_basis(block.coeffs[row], local, depth, block.deg_used)
    return torch.where(own, val, 0.0)


def query_nodes_kernel(block, unit: torch.Tensor, idx: torch.Tensor,
                       leaf: bool = False) -> torch.Tensor:
    """Launch K1's node-range mode on CUDA tensors: with ``leaf`` False one
    descent round (``descend_round_plain``), (B,) i32; with ``leaf`` the
    leaf evaluation at the leaves ``idx`` (``leaf_eval_plain``), (B,) f64.
    ``unit``: the clamped unit-cube points (B, 3) f64; ``idx``: (B,) i32
    global node indices. Raises on anything else."""
    if unit.device.type != "cuda" or block.device != unit.device \
            or idx.device != unit.device:
        raise ValueError("query_nodes_kernel needs the block, the points and "
                         f"the indices on one CUDA device (block "
                         f"{block.device}, points {unit.device}, indices "
                         f"{idx.device})")
    B = unit.shape[0]
    if unit.dtype != torch.float64 or unit.shape != (B, 3) \
            or idx.dtype != torch.int32 or idx.shape != (B,):
        raise ValueError("unit must be f64 (B, 3) and idx i32 (B,), got "
                         f"{unit.dtype} {tuple(unit.shape)}, {idx.dtype} "
                         f"{tuple(idx.shape)}")
    for name, t, dt in (("child_idx", block.child_idx, torch.int32),
                        ("centre", block.centre, torch.float64),
                        ("depth", block.depth, torch.int32),
                        ("coeffs", block.coeffs, torch.float64)):
        if t.dtype != dt or not t.is_contiguous() \
                or t.shape[0] != block.hi - block.lo:
            raise ValueError(f"block.{name} must be contiguous {dt} with "
                             f"hi - lo = {block.hi - block.lo} rows")
    if block.coeffs.shape[1] != consts.coeff_count(block.deg_used):
        raise ValueError("block arrays do not match deg_used")
    if block.centre.data_ptr() % 16:
        raise ValueError("block.centre must be 16-byte aligned")
    unit, idx = unit.contiguous(), idx.contiguous()
    out = torch.empty(B, dtype=torch.float64 if leaf else torch.int32,
                      device=unit.device)
    if B == 0:
        return out
    lib = _kernels.load()
    if leaf:
        rc = lib.hpsdf_leaf_nodes(
            block.centre.data_ptr(), block.depth.data_ptr(),
            block.coeffs.detach().data_ptr(), block.deg_used, block.lo,
            block.hi, unit.data_ptr(), idx.data_ptr(), B, out.data_ptr(),
            _kernels.stream_of(unit))
    else:
        rc = lib.hpsdf_descend_nodes(
            block.child_idx.data_ptr(), block.centre.data_ptr(), block.lo,
            block.hi, unit.data_ptr(), idx.data_ptr(), B, out.data_ptr(),
            _kernels.stream_of(unit))
    _kernels.check(lib, rc, "query_nodes")
    query_nodes_kernel.launches += 1
    return out


query_nodes_kernel.launches = 0


def descend_round(block, unit, cur):
    """One node-range descent round: the plain version on CPU tensors, K1's
    node-range mode on CUDA tensors."""
    if unit.device.type == "cpu":
        return descend_round_plain(block, unit, cur)
    return query_nodes_kernel(block, unit, cur)


def leaf_eval(block, unit, leaf):
    """The node-range leaf evaluation: the plain version on CPU tensors,
    K1's node-range mode on CUDA tensors."""
    if unit.device.type == "cpu":
        return leaf_eval_plain(block, unit, leaf)
    return query_nodes_kernel(block, unit, leaf, leaf=True)


# K8's node-range mode cuts the rank's rows into tiles, a tile's T x C f64
# sums held in one block's shared memory: at most NODE_TILE_ELEMS sums and
# NODE_TILE_MAX_ROWS rows (csrc/coeff_scatter.cu's kTileElems and
# kTileMaxRows), and no fewer than NODE_MIN_TILES tiles where the rows allow
# (two blocks an SM of an H100). A sort launch first lists the live points
# of each segment of NODE_SORT_POINTS points (kSortThreads * kSortPer) in
# tile order.
NODE_TILE_ELEMS = 4096
NODE_TILE_MAX_ROWS = 512
NODE_MIN_TILES = 264
NODE_SORT_POINTS = 4096


def node_tile_rows(deg: int, rows: int | None = None) -> int:
    """Rows a tile of K8's node-range mode holds at degree ``deg``: the most
    whose T x C sums fit NODE_TILE_ELEMS, even (so that every tile starts
    on 16 bytes), at most NODE_TILE_MAX_ROWS; for a block of ``rows`` rows
    no more than gives NODE_MIN_TILES tiles, and at least 2."""
    T = min(NODE_TILE_ELEMS // consts.coeff_count(deg) // 2 * 2,
            NODE_TILE_MAX_ROWS)
    if rows is not None:
        T = min(T, max(2, rows // NODE_MIN_TILES // 2 * 2))
    return T


def _node_checks(block, pts, leaf, cot, who):
    if pts.device.type != "cuda" or block.device != pts.device \
            or leaf.device != pts.device or cot.device != pts.device:
        raise ValueError(f"{who} needs the block and its inputs on one CUDA "
                         "device")
    B = pts.shape[0]
    if pts.dtype != torch.float64 or pts.shape != (B, 3) \
            or leaf.dtype != torch.int32 or leaf.shape != (B,) \
            or cot.dtype != torch.float64 or cot.shape != (B,):
        raise ValueError("pts must be f64 (B, 3), leaf i32 (B,) and cot f64 "
                         "(B,)")
    return tuple(x.detach().contiguous() for x in (pts, leaf, cot))


def _node_buckets(block, pts, leaf, cot, outside_value_max, T):
    """``node_buckets_kernel`` in tiles of ``T`` rows."""
    pts, leaf, cot = _node_checks(block, pts, leaf, cot,
                                  "node_buckets_kernel")
    if block.hi <= block.lo:
        raise ValueError("node_buckets_kernel needs a block with rows")
    B = pts.shape[0]
    n_tiles = -(-(block.hi - block.lo) // T)
    G = -(-B // NODE_SORT_POINTS)
    offsets = torch.empty((G, n_tiles + 1), dtype=torch.int32,
                          device=pts.device)
    items = torch.empty((B, 2), dtype=torch.int32, device=pts.device)
    if B == 0:
        return offsets, items
    lib = _kernels.load()
    rc = block.config.root_centre
    inv = 1.0 / block.config.root_sizes
    _kernels.check(lib, lib.hpsdf_node_buckets(
        block.lo, block.hi, T, pts.data_ptr(), leaf.data_ptr(), B,
        *map(float, rc), *map(float, inv), cot.data_ptr(),
        int(outside_value_max), offsets.data_ptr(), items.data_ptr(),
        _kernels.stream_of(pts)), "node_buckets")
    node_buckets_kernel.launches += 1
    return offsets, items


def node_buckets_kernel(block, pts: torch.Tensor, leaf: torch.Tensor,
                        cot: torch.Tensor, outside_value_max: bool = False):
    """Launch the sort of K8's node-range mode on CUDA tensors: the live
    points (``node_buckets_plain``'s) of each segment of
    NODE_SORT_POINTS points listed in order of their tile of
    ``node_tile_rows`` rows of the block. Returns (offsets (G, n_tiles + 1)
    i32, items (B, 2) i32), G segments: segment g's points of tile t at
    places g NODE_SORT_POINTS + [offsets[g, t], offsets[g, t + 1]) of
    items, as (point index, row within the tile), in an order within the
    run that can change from call to call; the other places unwritten. One
    launch (none for no points). Raises on anything else, and on a block of
    no rows."""
    return _node_buckets(block, pts, leaf, cot, outside_value_max,
                         node_tile_rows(block.deg_used, block.hi - block.lo))


node_buckets_kernel.launches = 0


def _node_buckets_plain(block, pts, leaf, w, outside_value_max, T):
    """``node_buckets_plain`` in tiles of ``T`` rows."""
    B = pts.shape[0]
    rows = max(block.hi - block.lo, 0)
    n_tiles, G = -(-rows // T), -(-B // NODE_SORT_POINTS)
    n = leaf.long() - block.lo
    live = (n >= 0) & (n < rows) & (w != 0)
    if outside_value_max:
        live &= torch.all(_to_unit(block, pts).abs() <= 0.5, dim=-1)
    idx = torch.nonzero(live).flatten()
    tile, seg = n[idx] // T, idx // NODE_SORT_POINTS
    key = seg * n_tiles + tile
    order = torch.sort(key, stable=True).indices
    idx, tile, seg, key = idx[order], tile[order], seg[order], key[order]
    counts = torch.bincount(key, minlength=G * n_tiles)
    offsets = torch.zeros((G, n_tiles + 1), dtype=torch.long,
                          device=pts.device)
    offsets[:, 1:] = torch.cumsum(counts.reshape(G, n_tiles), 1)
    first = torch.cumsum(counts, 0) - counts       # each run's first in key
    at = seg * NODE_SORT_POINTS + offsets[seg, tile] \
        + torch.arange(idx.numel(), device=pts.device) - first[key]
    items = torch.zeros((B, 2), dtype=torch.int32, device=pts.device)
    items[at] = torch.stack([idx, n[idx] - tile * T], 1).int()
    return offsets.int(), items


def node_buckets_plain(block, pts: torch.Tensor, leaf: torch.Tensor,
                       w: torch.Tensor, outside_value_max: bool = False):
    """The sort of K8's node-range mode by plain torch, as
    ``node_buckets_kernel`` returns it, each run's points in index order
    and the unused places zero. A point is live where its leaf lies in the
    block, its cotangent is not zero and, with ``outside_value_max``, it
    lies inside the root."""
    rows = max(block.hi - block.lo, 0)
    return _node_buckets_plain(block, pts, leaf, w, outside_value_max,
                               node_tile_rows(block.deg_used, rows))


def _coeff_scatter_nodes(block, pts, leaf, cot, outside_value_max, T):
    """``coeff_scatter_nodes_kernel`` in tiles of ``T`` rows."""
    pts, leaf, cot = _node_checks(block, pts, leaf, cot,
                                  "coeff_scatter_nodes_kernel")
    rows = block.hi - block.lo
    C = consts.coeff_count(block.deg_used)
    if rows <= 0:
        return torch.empty((0, C), dtype=torch.float64, device=pts.device)
    for name, t, dt in (("centre", block.centre, torch.float64),
                        ("depth", block.depth, torch.int32)):
        if t.dtype != dt or not t.is_contiguous() or t.shape[0] != rows:
            raise ValueError(f"block.{name} must be contiguous {dt} with "
                             f"hi - lo = {rows} rows")
    offsets, items = _node_buckets(block, pts, leaf, cot, outside_value_max,
                                   T)
    out = torch.empty((rows, C), dtype=torch.float64, device=pts.device)
    lib = _kernels.load()
    rc = block.config.root_centre
    inv = 1.0 / block.config.root_sizes
    _kernels.check(lib, lib.hpsdf_coeff_scatter_nodes(
        block.centre.data_ptr(), block.depth.data_ptr(), block.deg_used,
        block.lo, block.hi, T, pts.data_ptr(), cot.data_ptr(), pts.shape[0],
        *map(float, rc), *map(float, inv), offsets.data_ptr(),
        items.data_ptr(), out.data_ptr(), _kernels.stream_of(pts)),
        "coeff_scatter_nodes")
    coeff_scatter_nodes_kernel.launches += 1
    return out


def coeff_scatter_nodes_kernel(block, pts: torch.Tensor, leaf: torch.Tensor,
                               cot: torch.Tensor,
                               outside_value_max: bool = False):
    """Launch K8's node-range mode on CUDA tensors: the gradient (hi - lo,
    C) f64 of sum(cot * query) with respect to the block's coefficient rows,
    from the points (B, 3) f64, their global leaves (B,) i32 (the forward's
    descent) and the cotangents (B,) f64; nothing from points outside the
    root when ``outside_value_max``. A call is two launches and no memset:
    the sort (``node_buckets_kernel``), then a block a tile of
    ``node_tile_rows`` rows forms its sums in shared memory and writes its
    rows once. Up to 2^31 - 1 points: the sort's offsets, (G, n_tiles + 1)
    i32 with G = ceil(B / NODE_SORT_POINTS), grow as the points times the
    tiles, and each tile reads its G runs. Raises on anything else."""
    return _coeff_scatter_nodes(block, pts, leaf, cot, outside_value_max,
                                node_tile_rows(block.deg_used,
                                               block.hi - block.lo))


coeff_scatter_nodes_kernel.launches = 0


def coeff_scatter_nodes_plain(block, pts: torch.Tensor, leaf: torch.Tensor,
                              w: torch.Tensor,
                              outside_value_max: bool = False):
    """K8's node-range mode by autograd of ``leaf_eval_plain``: the gradient
    (hi - lo, C) of sum(w * query) with respect to the block's coefficient
    rows, nothing from points outside the root when
    ``outside_value_max``."""
    C = consts.coeff_count(block.deg_used)
    if block.hi <= block.lo:
        return torch.zeros((0, C), dtype=w.dtype, device=w.device)
    unit = _to_unit(block, pts.detach())
    if outside_value_max:
        w = torch.where(torch.all(unit.abs() <= 0.5, dim=-1), w, 0.0)
    coeffs = block.coeffs.detach().requires_grad_(True)
    with torch.enable_grad():
        v = leaf_eval_plain(dataclasses.replace(block, coeffs=coeffs),
                            unit.clamp(-0.5, 0.5), leaf)
        (d,) = torch.autograd.grad(v, coeffs, w.detach())
    return d


def coeff_scatter_nodes(block, pts, leaf, w, outside_value_max=False):
    """K8's node-range mode: the plain version on CPU tensors, the kernel on
    CUDA tensors."""
    if pts.device.type == "cpu":
        return coeff_scatter_nodes_plain(block, pts, leaf, w,
                                         outside_value_max)
    return coeff_scatter_nodes_kernel(block, pts, leaf, w, outside_value_max)


def _forward(ctx, tree, pts, with_grad, outside_value_max=True):
    """K1 for an autograd function's forward (inputs: the coefficients,
    the tree, the points, ..., the centres last): with each point's leaf,
    saved beside the points for K1v / K1h / K1c, only where the points or
    the centres need a gradient."""
    ctx.tree = tree
    if not (ctx.needs_input_grad[2] or ctx.needs_input_grad[-1]):
        ctx.save_for_backward(pts)
        return query_kernel(tree, pts, with_grad, outside_value_max)
    *out, leaf = query_kernel(tree, pts, with_grad, outside_value_max,
                              with_leaf=True)
    ctx.save_for_backward(pts, leaf)
    return tuple(out) if with_grad else out[0]


def _leaf_vjps(ctx, pts, leaf, *cots, **kw):
    """The gradients to the points and the centres (the inputs after the
    tree and last) that ``ctx`` asks for, (d_pts, d_centre) with None for
    the others: K1v / K1h alone for the points, else one launch of K1c."""
    points, centre = ctx.needs_input_grad[2], ctx.needs_input_grad[-1]
    if centre:
        out = query_vjp_kernel(ctx.tree, pts, *leaf, *cots, **kw,
                               points=points, centre=True)
        return out if points else (None, out)
    if points:
        return query_vjp_kernel(ctx.tree, pts, *leaf, *cots, **kw), None
    return None, None


class _Query(torch.autograd.Function):
    """K1, with K8 (query form) as its VJP with respect to the
    coefficients, K1v (from K1's leaves) with respect to the points and K1c
    with respect to the centres."""

    @staticmethod
    def forward(ctx, coeffs, tree, pts, outside_value_max, centre):
        ctx.outside_value_max = outside_value_max
        return _forward(ctx, tree, pts, False, outside_value_max)

    @staticmethod
    def backward(ctx, w):
        pts, *leaf = ctx.saved_tensors
        w = w.contiguous()
        d_coeffs = None
        if ctx.needs_input_grad[0]:
            d_coeffs = coeff_scatter_kernel(
                ctx.tree, w, pts=pts, outside_value_max=ctx.outside_value_max)
        d_pts, d_centre = _leaf_vjps(
            ctx, pts, leaf, w, outside_value_max=ctx.outside_value_max)
        return d_coeffs, None, d_pts, None, d_centre


class _QueryWithGradient(torch.autograd.Function):
    """K1 with the gradient, with K8g as its VJP with respect to the
    coefficients, K1h (from K1's leaves) with respect to the points and
    K1c with respect to the centres."""

    @staticmethod
    def forward(ctx, coeffs, tree, pts, centre):
        return _forward(ctx, tree, pts, True)

    @staticmethod
    def backward(ctx, wv, wn):
        pts, *leaf = ctx.saved_tensors
        d_coeffs = None
        if ctx.needs_input_grad[0]:
            d_coeffs = coeff_scatter_grad_kernel(ctx.tree, pts, wv, wn)
        d_pts, d_centre = _leaf_vjps(ctx, pts, leaf, wv, wn)
        return d_coeffs, None, d_pts, d_centre


def query(tree: Octree, pts: torch.Tensor, outside_value_max: bool = True):
    """Approximated signed distance at world points ``pts`` (B, 3) -> (B,).

    Negative inside the surface. Points outside the root AABB return the f64
    max sentinel unless ``outside_value_max`` is False, in which case they
    return the clamped-boundary evaluation. Differentiable with respect to
    ``tree.coeffs`` (kernel K8 on CUDA tensors), the points (K1v) and
    ``tree.centre`` (K1c).
    """
    if pts.device.type == "cpu":
        return query_plain(tree, pts, outside_value_max)
    if wants_grad(tree.coeffs, pts, tree.centre):
        return _Query.apply(tree.coeffs, tree, pts, outside_value_max,
                            tree.centre)
    return query_kernel(tree, pts, False, outside_value_max)


def query_with_gradient(tree: Octree, pts: torch.Tensor):
    """Value and unit world-space gradient at ``pts`` (B, 3).
    Returns (val (B,), unit_grad (B, 3)). Differentiable with respect to
    ``tree.coeffs`` (K8g on CUDA tensors), the points (K1h) and
    ``tree.centre`` (K1c)."""
    if pts.device.type == "cpu":
        return query_with_gradient_plain(tree, pts)
    if wants_grad(tree.coeffs, pts, tree.centre):
        return _QueryWithGradient.apply(tree.coeffs, tree, pts, tree.centre)
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
