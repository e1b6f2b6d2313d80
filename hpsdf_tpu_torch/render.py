"""Batched sphere tracing and shading.

The counterpart of ``hpsdf_tpu/render.py`` (reference ``Octree::QueryRay``,
Source/HP/Octree.cpp:705-746, and ``Ray::IntersectAABB``,
Source/HP/Ray.cpp:17-65):

  * ``intersect_aabb`` -- the slab test, vectorized.
  * ``trace``          -- the march of ``_march_block``: the reference's step
    ``t += 0.95 v + 1e-4`` and hit test ``v < 1e-4``, inner steps per leaf
    relocation, Keinert over-relaxation with rollback (``OMEGA``), the step
    cap and, for wide high-degree rows, a far-field phase on 32-lane LOD
    rows. On CUDA tensors it is kernel K3 (``csrc/march.cu``, wrapper
    ``march_kernel``), one thread per ray; on CPU tensors the plain
    ``_march_block``, a masked lockstep loop over the batch. With
    ``cone_tiles`` the cone prepass (``cone_start``: kernel K4,
    ``csrc/cone.cu``, wrapper ``cone_kernel``, on CUDA tensors) first gives
    every ray of each pixel tile a certified start. ``t`` is differentiable
    with respect to ``tree.coeffs`` through the implicit-function VJP of the
    reference (``trace_vjp``: kernel K8's trace form on CUDA tensors).
  * ``render``         -- pinhole rays, the cone prepass where 8 divides both
    sides, the march, normals (kernel K5 via ``accel.normals``) and
    headlight shading.

Not carried over: the TPU schedule around the march (chunking, ray sort,
compaction, lockstep caps), since per-ray results do not depend on it. The
whole path runs in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import _device, _kernels, accel, basis
from ._device import refuse_grad, wants_grad
from .accel import PackedTree, pack_tree
from .query import (_to_unit, clip_half, clip_slope, coeff_scatter_kernel,
                    descend)
from .tree import Octree

# March constants (reference: Source/HP/Octree.cpp:725-743; hpsdf_tpu
# render.py:53-77 for the inner-step choices measured there).
MAX_STEPS = 200          # per-ray step cap
HIT_EPS = 1e-4           # |v| < eps  => surface
STEP_SCALE = 0.95        # 5% SDF-error safety
MIN_STEP = 1e-4          # minimum advance
INNER_STEPS = 1          # steps per relocation, shallow 32-lane trees
INNER_STEPS_DEEP = 3     # and deep or high-degree trees
INNER_STEPS_LO = 3       # in the far-field LOD phase
LEAF_TOL = 1.0 + 1e-5    # |local| bound counting as "still in this leaf"

# Over-relaxation factor (Keinert et al., "Enhanced Sphere Tracing"); 1.0
# disables it. LOD -> full hand-off threshold, in hit_eps units.
OMEGA = 1.3
LOD_HANDOFF = 8.0

# Cone prepass (hpsdf_tpu render.py:193-207): the pixel tile's edge, the
# round cap of the centre ray's march, and the contact threshold as a
# fraction of the cone's radius.
CONE_TILE = 8
CONE_CAP = 24
CONE_STOP_FRAC = 0.5

# Per-ray counts a march can report (``with_stats``), LOD phase and full
# phase apart: steps taken, relocations, and relocations that found the row
# the ray already held. The plain version tells rows apart by their leaf
# frame, the kernel by their address, so a shallow leaf's copies in the grid
# count as kept only in the plain version.
STATS = ("steps_lo", "steps_full", "relocations_lo", "relocations_full",
         "kept_lo", "kept_full")


class TraceResult(NamedTuple):
    t: torch.Tensor        # (B,) ray parameter at hit (or last march
                           # position; t_max + 1 where the cone escaped)
    hit: torch.Tensor      # (B,) bool
    steps: int             # outer relocation rounds, both phases


def intersect_aabb(origins: torch.Tensor, dirs: torch.Tensor,
                   aabb_min, aabb_max):
    """Batched slab-method ray/AABB intersection. Returns (t_near, t_far,
    hits); for rays starting inside the box t_near <= 0 <= t_far."""
    inv = 1.0 / dirs                       # inf on zero components is fine
    bmin = torch.as_tensor(aabb_min, dtype=origins.dtype,
                           device=origins.device)
    bmax = torch.as_tensor(aabb_max, dtype=origins.dtype,
                           device=origins.device)
    lo = (bmin - origins) * inv
    hi = (bmax - origins) * inv
    t_near = torch.amax(torch.minimum(lo, hi), dim=-1)
    t_far = torch.amin(torch.maximum(lo, hi), dim=-1)
    return t_near, t_far, t_far >= torch.clamp(t_near, min=0.0)


def _root_box(pt: PackedTree):
    """(rc, half) of the root as f32 numpy, rounded as hpsdf_tpu rounds
    them; the box is rc -/+ half in f32."""
    rc = np.asarray(pt.root_centre, np.float32)
    half = np.float32(0.5) * np.asarray(pt.root_sizes, np.float32)
    return rc, half


def _inner_steps_for(pt: PackedTree) -> int:
    """Steps per relocation in the full-row phase (hpsdf_tpu
    render.py:167-173)."""
    if pt.width <= accel.LO_W and pt.extra_rounds == 0:
        return INNER_STEPS
    return INNER_STEPS_DEEP


def _eval_lo(row, local):
    """Deg<=2 eval on a 32-lane LOD row: (v_lo, err) with v_lo - err <= f
    <= v_lo + err anywhere in the leaf."""
    return accel.eval_local(row, local, 2), row[..., accel.LO_ERR_LANE]


# --------------------------------------------------------------------------
# The march: plain torch version of K3
# --------------------------------------------------------------------------

def _march_block(pt: PackedTree, origins, dirs, t_max, hit_eps=HIT_EPS,
                 max_steps: int = MAX_STEPS, step_cap=None,
                 omega: float = OMEGA, lo=None, with_stats: bool = False,
                 t_start=None):
    """The two-phase march over a ray batch (B, 3) f32 as masked lockstep
    loops (hpsdf_tpu render._march_block without its resume state).
    Returns (t (B,), hit (B,), kk (2,) int): kk = [LOD-phase, full-phase]
    relocation rounds, kk[0] = 0 without ``lo``; ``with_stats`` appends the
    (B, 6) int32 per-ray counts of ``STATS``. ``t_start`` (B,): a start per
    ray (the cone prepass's); a ray starts at max(t_near, 0, t_start), and
    one whose start lies past its exit does not march."""
    dev = origins.device
    f32 = torch.float32
    relax_on = omega > 1.0 and step_cap is None
    inner_steps = _inner_steps_for(pt)
    rc, half = _root_box(pt)
    t_max = torch.tensor(t_max, dtype=f32, device=dev)
    t_near, t_far, hits_box = intersect_aabb(origins, dirs, rc - half,
                                             rc + half)
    t_end = torch.minimum(t_far, t_max)
    t = torch.clamp(t_near, min=0.0)
    if t_start is not None:
        t = torch.maximum(t, t_start)
    active = hits_box & (t <= t_end)
    hit = torch.zeros_like(active)
    uo = accel.to_unit(pt, origins)
    udir = dirs * accel._root_f32(pt, dirs)[1]
    omega32 = np.float32(omega)
    slack = np.float32(1.001)
    cap = None if step_cap is None else np.float32(step_cap)

    def unit_at(t):
        return torch.clamp(uo + t[..., None] * udir, -0.5, 0.5)

    def outer_loop(active, body):
        k = 0
        while k < max_steps and bool(active.any()):
            active = body(active)
            k += 1
        return active, k

    zeros = torch.zeros(t.shape, dtype=f32, device=dev)
    s = dict(t=t, nsteps=torch.zeros(t.shape, dtype=torch.int32, device=dev),
             relax=torch.full_like(active, relax_on), adv_p=zeros, v_p=zeros)

    def step(active, lane, v, over, stop):
        """One step of the lanes in their leaf that do not stop here (a hit
        or a hand-off): the (relaxed, rolled back or capped) advance, the
        relaxation update, and the escape test on the unrelaxed step.
        Returns the lanes still marching."""
        t = s["t"]
        stepping = lane & ~stop
        safe_adv = STEP_SCALE * v + MIN_STEP
        adv = safe_adv
        if relax_on:
            adv = torch.where(s["relax"], omega32 * adv, adv)
            # a relaxed step never carries a lane past the exit plane
            adv = torch.where(t + adv > t_end, safe_adv, adv)
            adv = torch.where(over, -s["adv_p"] + STEP_SCALE * s["v_p"]
                              + MIN_STEP, adv)
            s["relax"] = s["relax"] & ~over
        if cap is not None:
            adv = torch.clamp(adv, max=cap)
        escaped = stepping & ~over & (t + safe_adv > t_end)
        s["t"] = torch.where(stepping, t + adv, t)
        s["nsteps"] = s["nsteps"] + stepping.int()
        if relax_on:
            s["adv_p"] = torch.where(stepping, torch.where(over, 0.0, adv),
                                     s["adv_p"])
            s["v_p"] = torch.where(stepping, v, s["v_p"])
        return active & ~stop & ~escaped & (s["nsteps"] < max_steps)

    def leaf_frame(row):
        local = (unit_at(s["t"]) - row[..., 2:5]) * row[..., 1:2]
        return local, torch.all(local.abs() <= LEAF_TOL, dim=-1)

    stats = torch.zeros((t.shape[0], len(STATS)), dtype=torch.int32,
                        device=dev)
    held = [None]            # the leaf frame of each ray's last relocation

    def count_relocation(active, row, phase):
        """A relocation of the active rays, which found ``row``."""
        if not with_stats:
            return
        meta = row[..., :5]
        if held[0] is None:
            held[0] = torch.full_like(meta, torch.nan)
        stats[:, 2 + phase] += active.int()
        stats[:, 4 + phase] += (active & (meta == held[0]).all(-1)).int()
        held[0] = torch.where(active[..., None], meta, held[0])

    k_lo = 0
    if lo is not None:
        lo_grid, lo_rows = lo
        handoff = np.float32(LOD_HANDOFF) * np.float32(hit_eps)
        need_full = torch.zeros_like(active)

        def outer1(active):
            nonlocal need_full
            row = accel.locate_in(lo_grid, lo_rows, pt.grid_depth,
                                  pt.extra_rounds, unit_at(s["t"]))
            count_relocation(active, row, 0)
            for _ in range(INNER_STEPS_LO):
                local, in_leaf = leaf_frame(row)
                v_lo, err = _eval_lo(row, local)
                v = v_lo - err                  # lower bound on the field
                lane = active & in_leaf
                over = torch.zeros_like(lane)
                if relax_on:
                    # overlap radii must lower-bound |f|: relu(|v_lo| - err)
                    rad = torch.relu(v_lo.abs() - err)
                    over = (lane & s["relax"] & (s["adv_p"] > 0.0)
                            & (s["v_p"] + rad < s["adv_p"] * slack))
                hand = lane & ~over & (v < handoff)
                need_full = need_full | hand
                active = step(active, lane, v, over, hand)
            return active

        active, k_lo = outer_loop(active, outer1)
        # hand-offs and rays still marching at the round cap go on with
        # fresh relaxation state
        active = active | need_full
        s.update(relax=torch.full_like(active, relax_on), adv_p=zeros,
                 v_p=zeros)
        stats[:, 0] = s["nsteps"]
        held[0] = None

    def outer2(active):
        nonlocal hit
        row = accel.locate(pt, unit_at(s["t"]))
        count_relocation(active, row, 1)
        for _ in range(inner_steps):
            local, in_leaf = leaf_frame(row)
            v = accel.eval_local(row, local, pt.deg_used)
            lane = active & in_leaf
            over = torch.zeros_like(lane)
            if relax_on:
                # Keinert overlap test on the pending relaxed step
                over = (lane & s["relax"] & (s["adv_p"] > 0.0)
                        & (s["v_p"].abs() + v.abs() < s["adv_p"] * slack))
            now_hit = lane & ~over & (v < hit_eps)
            hit = hit | now_hit
            active = step(active, lane, v, over, now_hit)
        return active

    _, k_full = outer_loop(active, outer2)
    kk = torch.tensor([k_lo, k_full], dtype=torch.int32)
    if not with_stats:
        return s["t"], hit, kk
    stats[:, 1] = s["nsteps"] - stats[:, 0]
    return s["t"], hit, kk, stats


# --------------------------------------------------------------------------
# Kernel K3
# --------------------------------------------------------------------------

def _tile_width(width: int, n_rays: int) -> int:
    """The image width K3 tiles its warps by: ``width`` when the rays fill
    whole 8x4 pixel tiles of an image that wide, else 0 (index order)."""
    if width > 0 and width % 8 == 0 and n_rays % (4 * width) == 0:
        return int(width)
    return 0


def march_kernel(pt: PackedTree, origins, dirs, t_max, hit_eps=HIT_EPS,
                 max_steps: int = MAX_STEPS, step_cap=None,
                 omega: float = OMEGA, lo=None, with_stats: bool = False,
                 width: int = 0, t0=None):
    """Launch K3 on CUDA tensors: what ``_march_block`` computes, one thread
    per ray. Returns (t (B,) f32, hit (B,) bool, kk (2,) int32 on the
    device) and, ``with_stats``, the (B, 6) int32 per-ray counts of
    ``STATS``. ``origins`` is (B, 3) contiguous, or one origin expanded to
    (B, 3) (stride 0 over the rays), which the kernel reads in place.
    ``width`` says that the rays are the pixels of an image that wide in
    raster order: a warp then marches an 8x4 pixel tile and not a 32x1
    strip, where the image's size allows (``_tile_width``); no result
    depends on it. ``t0`` (B,) f32: a start per ray, as ``_march_block``'s
    ``t_start``. Raises on anything but CUDA tensors."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"march_kernel needs CUDA tensors, got {dev}")
    if dirs.dtype != torch.float32 or dirs.shape != origins.shape \
            or dirs.device != dev:
        raise ValueError(f"dirs must be f32 {tuple(origins.shape)} on {dev}, "
                         f"got {dirs.dtype} {tuple(dirs.shape)} on "
                         f"{dirs.device}")
    accel._check_packed(pt, origins)
    if lo is not None:
        for tab, like in zip(lo, (pt.grid, pt.rows)):
            if tab.dtype != torch.float32 or not tab.is_contiguous() \
                    or tab.shape != (like.shape[0], accel.LO_W) \
                    or tab.device != dev or tab.data_ptr() % 16:
                raise ValueError("LOD tables must be contiguous 16-byte "
                                 f"aligned f32 (N, {accel.LO_W}) beside the "
                                 f"packed ones, on {dev}")
    B = origins.shape[0]
    if t0 is not None:
        if t0.shape != (B,) or t0.dtype != torch.float32 or t0.device != dev:
            raise ValueError(f"t0 must be f32 ({B},) on {dev}")
        t0 = t0.contiguous()
    shared_origin = B > 1 and origins.stride() == (0, 1)
    if not shared_origin:
        origins = origins.contiguous()
    dirs = dirs.contiguous()
    t = torch.empty(B, dtype=torch.float32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    kk = torch.zeros(2, dtype=torch.int32, device=dev)
    stats = torch.empty((B, len(STATS)), dtype=torch.int32, device=dev) \
        if with_stats else None
    if B == 0:
        return (t, hit, kk, stats) if with_stats else (t, hit, kk)
    lib = _kernels.load()
    rc, half = _root_box(pt)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    box = np.concatenate([rc - half, rc + half, rc, inv]).astype(np.float32)
    relax_on = omega > 1.0 and step_cap is None
    _kernels.check(lib, lib.hpsdf_march(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        None if lo is None else lo[0].data_ptr(),
        None if lo is None else lo[1].data_ptr(),
        pt.grid_depth, pt.extra_rounds, _inner_steps_for(pt),
        origins.data_ptr(), 0 if shared_origin else 3, dirs.data_ptr(), B,
        box.ctypes.data, float(np.float32(t_max)),
        float(np.float32(hit_eps)), int(max_steps),
        float(np.float32(0.0 if step_cap is None else step_cap)),
        int(step_cap is not None), float(np.float32(omega)), int(relax_on),
        t.data_ptr(), hit.data_ptr(), kk.data_ptr(),
        None if stats is None else stats.data_ptr(),
        None if t0 is None else t0.data_ptr(), _tile_width(width, B),
        _kernels.stream_of(origins)), "march")
    march_kernel.launches += 1
    return (t, hit, kk, stats) if with_stats else (t, hit, kk)


march_kernel.launches = 0


# --------------------------------------------------------------------------
# Kernel K4: the cone prepass
# --------------------------------------------------------------------------

def _tiles_of(x: torch.Tensor, tiles) -> torch.Tensor:
    """(B, 3) rays of a row-major H x W grid as (tiles, T*T, 3), a tile's
    rays in row-major order."""
    H, W, T = tiles
    return x.reshape(H // T, T, W // T, T, 3).permute(0, 2, 1, 3, 4) \
        .reshape(-1, T * T, 3)


def _check_tiles(tiles, n_rays: int):
    H, W, T = (int(v) for v in tiles)
    if T <= 0 or H % T or W % T or H * W != n_rays:
        raise ValueError(f"cone_tiles {tiles}: T must divide H and W, and "
                         f"H * W must be the {n_rays} rays")
    return H, W, T


def cone_start_plain(pt: PackedTree, origins, dirs, t_max, hit_eps, tiles,
                     lo=None, max_steps: int = MAX_STEPS,
                     with_stats: bool = False):
    """Per-ray march starts (B,) f32 from the cone prepass over T x T pixel
    tiles of a row-major H x W ray grid, ``tiles`` = (H, W, T)
    (hpsdf_tpu render.cone_start), as masked lockstep loops over the tiles.
    ``with_stats``: also the rounds each tile's march took, (tiles,) int32
    in row-major tile order; their largest is the lockstep round count.

    Each tile's centre ray marches the margin f - (do + t dd), where do and
    dd bound the tile's origin and direction spread, so that no ray of the
    tile can come within hit_eps of the surface before the contact it
    returns. Unlike the reference, the march covers the union of the tile's
    rays' intervals in the root (from the earliest entry, escaping only past
    the latest exit), not the centre ray's own, which fine rays near the
    root's faces can leave (ADVICE.md). A tile that escapes gives its rays
    t_max + 1."""
    H, W, T = _check_tiles(tiles, origins.shape[0])
    f32 = torch.float32
    ot, dt_ = _tiles_of(origins, tiles), _tiles_of(dirs, tiles)
    c = (T // 2) * T + T // 2
    oc, dc = ot[:, c], dt_[:, c]
    do = torch.sqrt(torch.amax(torch.sum((ot - oc[:, None]) ** 2, dim=-1),
                               dim=1))
    dd = torch.sqrt(torch.amax(torch.sum((dt_ - dc[:, None]) ** 2, dim=-1),
                               dim=1))
    rc, half = _root_box(pt)
    t_near, t_far, hits = intersect_aabb(ot.reshape(-1, 3),
                                         dt_.reshape(-1, 3), rc - half,
                                         rc + half)
    ts = torch.clamp(t_near, min=0.0)
    te = torch.clamp(t_far, max=float(np.float32(t_max)))
    act = (hits & (ts <= te)).reshape(ot.shape[:2])
    inf = torch.tensor(float("inf"), dtype=f32, device=origins.device)
    t_lo = torch.where(act, ts.reshape(act.shape), inf).amin(dim=1)
    t_hi = torch.where(act, te.reshape(act.shape), -inf).amax(dim=1)

    escape = np.float32(t_max) + np.float32(1.0)
    active = t_lo <= t_hi
    t = torch.where(active, t_lo, escape)
    uo = accel.to_unit(pt, oc)
    udir = dc * accel._root_f32(pt, dc)[1]
    inv_lip = 1.0 / (1.0 + dd)
    eps = np.float32(hit_eps)
    taken = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    for _ in range(min(CONE_CAP, max_steps)):
        if not bool(active.any()):
            break
        taken += active
        unit = torch.clamp(uo + t[:, None] * udir, -0.5, 0.5)
        if lo is not None:
            row = accel.locate_in(lo[0], lo[1], pt.grid_depth,
                                  pt.extra_rounds, unit)
            v_lo, err = _eval_lo(row, accel._local(row, unit))
            v = v_lo - err
        else:
            row = accel.locate(pt, unit)
            v = accel.eval_local(row, accel._local(row, unit), pt.deg_used)
        radius = do + t * dd
        margin = v - radius
        contact = active & (margin < torch.clamp(
            np.float32(CONE_STOP_FRAC) * radius, min=eps))
        adv = (STEP_SCALE * margin) * inv_lip + MIN_STEP
        escaped = active & ~contact & (t + adv > t_hi)
        t = torch.where(active & ~contact, t + adv, t)
        t = torch.where(escaped, escape, t)
        active = active & ~contact & ~escaped
    t0 = t.reshape(H // T, 1, W // T, 1).expand(H // T, T, W // T, T) \
        .reshape(-1)
    return (t0, taken) if with_stats else t0


def cone_kernel(pt: PackedTree, origins, dirs, t_max, hit_eps, tiles,
                lo=None, max_steps: int = MAX_STEPS,
                with_stats: bool = False):
    """Launch K4 on CUDA tensors: what ``cone_start_plain`` computes
    (``with_stats`` too), a lane per tile. ``origins`` is (B, 3) contiguous
    or one origin expanded to (B, 3). Raises on anything but CUDA
    tensors."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"cone_kernel needs CUDA tensors, got {dev}")
    accel._check_packed(pt, origins)
    if dirs.dtype != torch.float32 or dirs.shape != origins.shape \
            or dirs.device != dev:
        raise ValueError(f"dirs must be f32 {tuple(origins.shape)} on {dev}")
    H, W, T = _check_tiles(tiles, origins.shape[0])
    shared_origin = origins.shape[0] > 1 and origins.stride() == (0, 1)
    if not shared_origin:
        origins = origins.contiguous()
    dirs = dirs.contiguous()
    t0 = torch.empty(origins.shape[0], dtype=torch.float32, device=dev)
    rounds = (torch.empty((H // T) * (W // T), dtype=torch.int32, device=dev)
              if with_stats else None)
    if t0.numel() == 0:
        return (t0, rounds) if with_stats else t0
    lib = _kernels.load()
    rc, half = _root_box(pt)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    box = np.concatenate([rc - half, rc + half, rc, inv]).astype(np.float32)
    _kernels.check(lib, lib.hpsdf_cone(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        None if lo is None else lo[0].data_ptr(),
        None if lo is None else lo[1].data_ptr(),
        pt.grid_depth, pt.extra_rounds, origins.data_ptr(),
        0 if shared_origin else 3, dirs.data_ptr(), H, W, T,
        box.ctypes.data, float(np.float32(t_max)), float(np.float32(hit_eps)),
        min(CONE_CAP, int(max_steps)), t0.data_ptr(),
        None if rounds is None else rounds.data_ptr(),
        _kernels.stream_of(dirs)), "cone")
    cone_kernel.launches += 1
    return (t0, rounds) if with_stats else t0


cone_kernel.launches = 0


def cone_start(pt: PackedTree, origins, dirs, t_max, hit_eps, tiles,
               lo=None, max_steps: int = MAX_STEPS,
               with_stats: bool = False):
    """Per-ray march starts from the cone prepass: K4 on CUDA tensors,
    ``cone_start_plain`` on CPU tensors. ``with_stats`` (as hpsdf_tpu's):
    (t0, k, n_coarse), k the lockstep round count (the most rounds a tile's
    march took) and n_coarse the number of tiles."""
    fn = cone_start_plain if origins.device.type == "cpu" else cone_kernel
    out = fn(pt, origins, dirs, t_max, hit_eps, tiles, lo, max_steps,
             with_stats=with_stats)
    if not with_stats:
        return out
    t0, rounds = out
    return t0, int(rounds.max()) if rounds.numel() else 0, rounds.numel()


def _march(pt: PackedTree, origins, dirs, t_max, hit_eps, max_steps,
           step_cap=None, width: int = 0, cone_tiles=None, sort_rays=None):
    """The march, after the cone prepass where ``cone_tiles`` asks for it.
    The reference's schedule rule holds: no cone on a tree with LOD tables
    unless ``sort_rays`` is given (hpsdf_tpu render.py:574-575)."""
    lo = pt.lo
    if cone_tiles is not None and lo is not None and sort_rays is None:
        cone_tiles = None
    t0 = None
    if cone_tiles is not None:
        t0 = cone_start(pt, origins, dirs, t_max, hit_eps, cone_tiles, lo,
                        max_steps)
    if origins.device.type == "cpu":
        return _march_block(pt, origins, dirs, t_max, hit_eps, max_steps,
                            step_cap, lo=lo, t_start=t0)
    return march_kernel(pt, origins, dirs, t_max, hit_eps, max_steps,
                        step_cap, lo=lo, width=width, t0=t0)


# --------------------------------------------------------------------------
# The trace's implicit VJP (kernel K8, trace form)
# --------------------------------------------------------------------------

def _tree_f32(tree: Octree) -> Octree:
    return dataclasses.replace(tree, centre=tree.centre.to(torch.float32),
                               coeffs=tree.coeffs.to(torch.float32))


def trace_vjp_plain(tree32: Octree, origins, dirs, t, hit, dt):
    """The gradient (N, C) f32 of sum(dt * t) with respect to
    ``tree32.coeffs`` (hpsdf_tpu render._trace_bwd), on the generic f32
    tree: at p = o + t d, dfdt = grad f(p) . d, each axis weighted by the
    clamp's derivative (``clip_slope``: 1 inside the root, 1/2 on a face,
    0 outside, as ``jax.jvp`` through ``jnp.clip`` gives it), safe = dfdt
    where |dfdt| > 1e-6 and 1e-6 elsewhere, w = -dt / safe on hit rays and
    0 elsewhere, and w times each basis product into the leaf's
    coefficients (the implicit function theorem at f = 0)."""
    p = origins + t[:, None] * dirs
    unit = _to_unit(tree32, p)
    slope = clip_slope(unit)
    unit = clip_half(unit)
    leaf = descend(tree32, unit).long()
    depth = tree32.depth[leaf]
    scale = torch.exp2((depth + 1).to(torch.float32))[:, None]
    local = (unit - tree32.centre[leaf]) * scale
    _, g = basis.eval_basis_grad(tree32.coeffs[leaf], local, depth,
                                 tree32.deg_used)
    inv = torch.as_tensor(1.0 / tree32.config.root_sizes,
                          dtype=torch.float32, device=p.device)
    dfdt = torch.sum(slope * g * scale * inv * dirs, dim=-1)
    safe = torch.where(dfdt.abs() > 1e-6, dfdt, 1e-6)
    w = torch.where(hit, -dt / safe, 0.0)
    idx, norms = basis._tables(tree32.deg_used, local)
    L = basis.legendre_all(local, tree32.deg_used)
    prod = (L[..., 0, idx[:, 0]] * L[..., 1, idx[:, 1]] * L[..., 2, idx[:, 2]]
            * norms[depth.long()])
    return torch.zeros_like(tree32.coeffs).index_add_(0, leaf,
                                                      w[:, None] * prod)


def trace_vjp(tree32: Octree, origins, dirs, t, hit, dt):
    """The trace's implicit VJP: K8's trace form on CUDA tensors,
    ``trace_vjp_plain`` on CPU tensors."""
    if origins.device.type == "cpu":
        return trace_vjp_plain(tree32, origins, dirs, t, hit, dt)
    return coeff_scatter_kernel(tree32, dt, rays=(origins, dirs, t,
                                                         hit))


class _TraceVJP(torch.autograd.Function):
    """The marched t, as a function of the f32 coefficients whose VJP is
    ``trace_vjp`` (the march itself runs before, without a graph)."""

    @staticmethod
    def forward(ctx, coeffs32, t, hit, origins, dirs, tree32):
        ctx.save_for_backward(t, hit, origins, dirs)
        ctx.tree32 = dataclasses.replace(tree32, coeffs=coeffs32.detach())
        return t.clone()

    @staticmethod
    def backward(ctx, dt):
        t, hit, origins, dirs = ctx.saved_tensors
        d = trace_vjp(ctx.tree32, origins, dirs, t, hit, dt.contiguous())
        return d, None, None, None, None, None


def implicit_t(tree32: Octree, coeffs32: torch.Tensor, t, hit, origins,
               dirs) -> torch.Tensor:
    """``t`` of a march done on a tree with f32 coefficients ``coeffs32``,
    made differentiable with respect to them by the reference's implicit
    VJP. ``tree32`` gives the f32 generic tree (child_idx, f32 centre,
    depth) the backward descends."""
    return _TraceVJP.apply(coeffs32, t, hit, origins, dirs, tree32)


def trace(tree: Octree, origins, dirs, t_max: float = 10.0,
          hit_eps: float = HIT_EPS, max_steps: int = MAX_STEPS,
          packed: PackedTree | None = None, step_cap: float | None = None,
          sort_rays: bool | None = None,
          cone_tiles: tuple | None = None) -> TraceResult:
    """Sphere-trace a ray batch (B, 3) world-space origins and unit
    directions, on the tree's device. Returns TraceResult(t, hit, steps).

    ``cone_tiles`` = (H, W, T): the rays are a row-major H x W grid, and the
    cone prepass over T x T tiles gives each ray its start (K4 then K3 on
    CUDA tensors); not on a tree with LOD tables unless ``sort_rays`` is
    given, as the reference. A ray whose tile's cone escaped reports
    t = t_max + 1; other rays that miss report where their march ended.
    ``sort_rays`` changes nothing else: per-ray results are the same under
    every schedule.

    ``t`` is differentiable with respect to ``tree.coeffs`` (the implicit
    VJP of the reference, hpsdf_tpu render.py:944-998), not with respect
    to the origins, directions or ``tree.centre``, which raise on every
    device, before any launch (the centres before the packing too), when
    they require a gradient: the reference returns zeros for them, a
    placeholder and not the derivative.
    """
    refuse_grad("trace with respect to tree.centre", tree.centre)
    if packed is None:
        packed = pack_tree(tree)
    dev = packed.device
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    refuse_grad("trace with respect to the origins or directions", o, d)
    t, hit, kk = _march(packed, o.detach(), d.detach(), t_max, hit_eps,
                        max_steps, step_cap, cone_tiles=cone_tiles,
                        sort_rays=sort_rays)
    if wants_grad(tree.coeffs):
        tree32 = _tree_f32(tree)
        t = implicit_t(tree32, tree32.coeffs, t, hit, o, d)
    return TraceResult(t, hit, int(kk.sum()))


# --------------------------------------------------------------------------
# Camera + shading
# --------------------------------------------------------------------------

def camera_rays(eye, look_at, up=(0.0, 1.0, 0.0), fov_deg: float = 40.0,
                width: int = 256, height: int = 256,
                device=_device.DEFAULT):
    """Pinhole camera ray grid in f32 on ``device``. Returns (origins
    (H*W, 3), dirs (H*W, 3))."""
    device = _device.resolve(device)
    f32 = torch.float32
    eye = torch.as_tensor(eye, dtype=f32, device=device)
    fwd = torch.as_tensor(look_at, dtype=f32, device=device) - eye
    fwd = fwd / torch.linalg.norm(fwd)
    right = torch.linalg.cross(fwd, torch.as_tensor(up, dtype=f32,
                                                    device=device))
    right = right / torch.linalg.norm(right)
    cam_up = torch.linalg.cross(right, fwd)
    tan = np.float32(math.tan(np.float32(np.deg2rad(np.float32(fov_deg)))
                              * np.float32(0.5)))
    xs = (torch.arange(width, dtype=f32, device=device) + 0.5) / width \
        * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=f32, device=device) + 0.5) \
        / height * 2.0
    aspect = width / height
    px, py = torch.meshgrid(xs * tan * aspect, ys * tan, indexing="xy")
    d = px[..., None] * right + py[..., None] * cam_up + fwd
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    origins = eye.expand(d.shape).reshape(-1, 3)
    return origins, d.reshape(-1, 3)


# unit surface normals at world points (K5 on CUDA tensors)
_normals_at = accel.normals


def render(tree: Octree, eye, look_at, up=(0.0, 1.0, 0.0),
           fov_deg: float = 40.0, width: int = 256, height: int = 256,
           t_max: float = 10.0, max_steps: int = MAX_STEPS,
           packed: PackedTree | None = None):
    """Render the octree SDF by sphere tracing with headlight shading, on
    the tree's device. Returns (image (H, W, 3) f32 in [0, 1], depth (H, W)
    with inf on misses, hit (H, W) bool). The cone prepass runs over
    CONE_TILE tiles where CONE_TILE divides both sides, as the reference's
    (hpsdf_tpu render.py:1116-1119)."""
    if packed is None:
        packed = pack_tree(tree)
    origins, dirs = camera_rays(eye, look_at, up, fov_deg, width, height,
                                device=packed.device)
    tiles = ((height, width, CONE_TILE)
             if height % CONE_TILE == 0 and width % CONE_TILE == 0 else None)
    t, hit, _ = _march(packed, origins, dirs, t_max, HIT_EPS, max_steps,
                       width=width, cone_tiles=tiles)
    p = origins + t[..., None] * dirs
    normals = _normals_at(packed, p)
    lam = torch.clamp(-torch.sum(normals * dirs, dim=-1), min=0.0)
    shade = torch.where(hit, 0.15 + 0.85 * lam, 0.0)
    img = torch.stack([shade, shade, shade], dim=-1)
    depth = torch.where(hit, t, torch.inf)
    return (img.reshape(height, width, 3), depth.reshape(height, width),
            hit.reshape(height, width))

