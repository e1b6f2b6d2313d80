"""Differentiable inverse rendering: optimise a tree's coefficients so that
its sphere-traced depths match target depth images.

The counterpart of ``hpsdf_tpu/inverse.py``: march the rays through the
tree, compare hit depths with the targets, and pull the loss back to the
coefficients through the trace's implicit-function VJP (``render.trace_vjp``:
kernel K8 on CUDA tensors), while field terms read the packed tables
re-derived from the current coefficients every step (``accel.repack`` /
``repack_folded``, whose grid gather carries gradients back through G's
backward) with ``accel.values_and_gradient_at``: the values (K2) and the
eikonal term's raw gradients (K5) in one launch a chunk, backward K7's two
forms. Adam is ``torch.optim.Adam`` with optax's defaults.

Memory stays chunk-sized: a step first marches every ray chunk without a
graph (the march's VJP needs only its ``t`` and ``hit``), which fixes the
depth term's normaliser, the hit count over all chunks; then each chunk's
terms are built and differentiated on their own into the gradients of the
step's tables, which one backward carries to the parameters.

With ``mesh`` (a ``torch.distributed`` DeviceMesh) each chunk's rays are
split over the mesh's batch axis (hpsdf_tpu inverse.py:138-152): the hit
count, the chunk losses and the tables' gradients are all-reduced before
the backward to the parameters, the anchor term is added once after it,
and Adam steps alike on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import accel, render as R
from .tree import Octree

# Fixed constants of the loss (hpsdf_tpu inverse.py:108-112, 182-183): the
# sign band around the target surface, the free-space sample fractions of
# the target depth, and the march's step cap (a half-optimised field is no
# metric SDF, and an uncapped march steps over its thin zero crossing).
BAND = 0.02
FRACS = (0.35, 0.6, 0.8, 0.93)
STEP_CAP = 0.02


class InverseResult(NamedTuple):
    tree: Octree            # the tree with the optimised coefficients
    losses: torch.Tensor    # (n_steps,) f32 loss trajectory


def depth_loss(t, hit, target_t, target_hit):
    """Masked L2 depth loss: rays count only where both the current and
    the target trace hit (a hit/miss disagreement has no gradient)."""
    m = (hit & target_hit).to(torch.float32)
    n = torch.clamp(torch.sum(m), min=1.0)
    return torch.sum(m * (t - target_t) ** 2) / n


def _padded_chunks(origins, dirs, target_t, target_hit, chunk):
    """The rays in ``chunk``-sized pieces; the padded tail repeats the last
    ray with target_hit False, so every masked term ignores it."""
    pad = (-origins.shape[0]) % chunk
    if pad:
        origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])
        target_t = torch.cat([target_t, target_t.new_zeros(pad)])
        target_hit = torch.cat([target_hit, target_hit.new_zeros(pad)])
    return list(zip(*(x.split(chunk) for x in (origins, dirs, target_t,
                                               target_hit))))


def fit_to_depth(tree: Octree, origins, dirs, target_t, target_hit,
                 n_steps: int = 100, lr: float = 3e-3, t_max: float = 10.0,
                 max_steps: int = R.MAX_STEPS,
                 surface_weight: float = 1.0,
                 depth_weight: float = 0.1,
                 anchor_weight: float = 1.0,
                 eikonal_weight: float = 0.1,
                 ray_chunk: int = 1 << 16,
                 param_space: str = "folded",
                 lr_warmup: int = 5,
                 mesh=None) -> InverseResult:
    """Gradient-descend the tree's coefficients so that its traced depths
    match ``target_t`` on ``target_hit`` rays (hpsdf_tpu
    inverse.fit_to_depth, whose docstring explains each term), on the
    tree's device.

    origins, dirs: (B, 3); target_t: (B,); target_hit: (B,) bool. The loss
    is the depth term (the marched depth's L2 through the implicit VJP,
    normalised by the hit & target_hit count over all rays) times
    ``depth_weight``, plus ``surface_weight`` times the field terms at the
    target points (f^2 at the surface, sign hinges a band before and behind
    it, free-space hinges along the ray), plus ``eikonal_weight`` times
    (|grad f| - 1)^2 at the band points, these normalised by the target hit
    count, plus ``anchor_weight`` times mean((p - p0)^2). Rays go in
    ``ray_chunk`` pieces; the loss does not depend on the chunking.

    ``param_space``: "folded" (Adam on the normaliser-premultiplied
    coefficients, the packed rows' lanes) or "raw" (on ``tree.coeffs``).
    The learning rate warms up linearly over ``lr_warmup`` updates,
    lr * min(1, (k + 1) / lr_warmup) at update k. ``mesh``: a
    ``torch.distributed`` DeviceMesh (``parallel.make_mesh``; every rank
    calls with the same arguments): each chunk's rays are split over its
    batch axis (the work repeated over a node axis, where the reference
    replicates), padded with rays whose target_hit is False, and every rank
    returns the same result; anything else but None raises TypeError.
    """
    shard = None
    if mesh is not None:
        from . import parallel
        shard = parallel.batch_shard(mesh)
    if param_space not in ("folded", "raw"):
        raise ValueError(f"param_space must be 'folded' or 'raw', "
                         f"got {param_space!r}")
    folded = param_space == "folded"
    dev, f32 = tree.device, torch.float32
    tree32 = R._tree_f32(dataclasses.replace(tree,
                                             coeffs=tree.coeffs.detach()))
    packed = accel.pack_tree(tree)
    support = accel.pack_support(tree)
    origins = torch.as_tensor(origins, dtype=f32, device=dev)
    dirs = torch.as_tensor(dirs, dtype=f32, device=dev)
    target_t = torch.as_tensor(target_t, dtype=f32, device=dev)
    target_hit = torch.as_tensor(target_hit, dtype=torch.bool, device=dev)
    chunks = _padded_chunks(origins, dirs, target_t, target_hit,
                            min(ray_chunk, origins.shape[0]))
    if shard is not None:       # this rank's share of each chunk
        per = -(-chunks[0][0].shape[0] // shard.size) * shard.size
        chunks = [tuple(parallel.share(x, shard)
                        for x in _padded_chunks(*c, per)[0]) for c in chunks]

    fold = support.fold                      # f32 (Np, cw), > 0
    inv_fold = 1.0 / fold
    coeffs0 = tree32.coeffs
    params0 = coeffs0 * fold if folded else coeffs0
    params = params0.clone().requires_grad_(True)
    opt = torch.optim.Adam([params], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = None
    if lr_warmup > 0:
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda k: min(1.0, (k + 1.0) / lr_warmup))
    terms = _Terms(surface_weight, eikonal_weight,
                   torch.clamp(target_hit.sum().to(f32), min=1.0), dev)

    losses = []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        if folded:
            c32 = params * inv_fold
            pk = accel.repack_folded(packed, support, params)
        else:
            c32 = params
            pk = accel.repack(packed, support, c32)
        # the march, outside any graph, on every chunk: the depth term's
        # normaliser is the hit count over all of them
        pk0 = dataclasses.replace(pk, rows=pk.rows.detach(),
                                  grid=pk.grid.detach())
        marched = [R._march(pk0, o, d, t_max, R.HIT_EPS, max_steps,
                            STEP_CAP)[:2] for o, d, _, _ in chunks]
        dn = sum(torch.sum(h & th) for (_, _, _, th), (_, h)
                 in zip(chunks, marched)).to(f32).reshape(1)
        if shard is not None:
            parallel.all_reduce(dn, shard)
        dn = torch.clamp(dn[0], min=1.0)
        # each chunk's terms into the gradients of this step's tables
        leaves = [x.detach().requires_grad_(True)
                  for x in (c32, pk.rows, pk.grid)]
        pk_l = dataclasses.replace(pk, rows=leaves[1], grid=leaves[2])
        total = torch.zeros((), dtype=f32, device=dev)
        for (o, d, tt, th), (t, hit) in zip(chunks, marched):
            t = R.implicit_t(tree32, leaves[0], t, hit, o, d)
            m = (hit & th).to(f32)
            loss = (terms(pk_l, o, d, tt, th)
                    + np.float32(depth_weight)
                    * torch.sum(m * (t - tt) ** 2) / dn)
            loss.backward()
            total = total + loss.detach()
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in leaves]
        if shard is not None:   # the sums over every rank's rays
            flat = parallel.all_reduce(torch.cat(
                [g.reshape(-1) for g in grads] + [total.reshape(1)]), shard)
            grads = [v.view_as(g) for v, g in zip(
                flat[:-1].split([g.numel() for g in grads]), grads)]
            total = flat[-1]
        torch.autograd.backward([c32, pk.rows, pk.grid], grads)
        anchor = np.float32(anchor_weight) * torch.mean((params - params0)
                                                        ** 2)
        anchor.backward()
        losses.append(total + anchor.detach())
        opt.step()
        if sched is not None:
            sched.step()

    params = params.detach()
    coeffs = params * inv_fold if folded else params
    out = dataclasses.replace(tree, coeffs=coeffs.to(tree.coeffs.dtype))
    return InverseResult(tree=out, losses=torch.stack(losses) if losses
                         else torch.zeros(0, dtype=f32, device=dev))


class _Terms:
    """A chunk's field and eikonal terms, normalised by the target hit
    count (hpsdf_tpu inverse.py chunk_field, without the depth term)."""

    def __init__(self, surface_weight, eikonal_weight, surf_n, dev):
        self.sw = np.float32(surface_weight)
        self.ew = np.float32(eikonal_weight)
        self.surf_n = surf_n
        self.fracs = torch.tensor(FRACS, dtype=torch.float32, device=dev)

    def __call__(self, pk, o, d, tt, th):
        band = np.float32(BAND)
        half = band * np.float32(0.5)
        surf_m = th.to(torch.float32)
        n = o.shape[0]
        surf = o + tt[:, None] * d
        out_p = o + (tt - band)[:, None] * d        # want f >= +band/2
        in_p = o + (tt + band)[:, None] * d         # want f <= -band/2
        free = o[None] + (self.fracs[:, None, None] * tt[None, :, None]) \
            * d[None]
        band_pts = torch.cat([surf, in_p, out_p])
        # one read of every point of the chunk, with the band points'
        # spatial gradients for the eikonal term
        f, g = accel.values_and_gradient_at(
            pk, torch.cat([band_pts, free.reshape(-1, 3)]), 3 * n)
        fsurf, f_in, f_out = f[:n], f[n:2 * n], f[2 * n:3 * n]
        f_free = f[3 * n:].reshape(len(FRACS), n)
        field = (fsurf ** 2 + torch.relu(f_in + half) ** 2
                 + torch.relu(half - f_out) ** 2)
        free_sum = torch.sum(surf_m[None] * torch.relu(half - f_free) ** 2)
        # eikonal: the eps inside the sqrt keeps a zero gradient's norm
        # differentiable
        gnorm = torch.sqrt(torch.sum(g * g, dim=-1) + 1e-12)
        eik = torch.sum(surf_m.repeat(3) * (gnorm - 1.0) ** 2)
        return (self.sw * (torch.sum(surf_m * field) + free_sum / len(FRACS))
                / self.surf_n + self.ew * eik / (3.0 * self.surf_n))


def render_targets(tree: Octree, origins, dirs, t_max: float = 10.0,
                   step_cap: float | None = None):
    """Trace a reference tree to produce (target_t, target_hit) for
    ``fit_to_depth``. Pass ``step_cap`` ~0.02 when tracing a partially
    optimised tree (its field is not a metric SDF)."""
    res = R.trace(tree, origins, dirs, t_max=t_max, step_cap=step_cap)
    return res.t, res.hit
