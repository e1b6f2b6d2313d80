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
forms. A chunk's target points and its loss terms with their VJP are
kernel K13 on CUDA tensors (csrc/inverse_terms.cu: ``inverse_points_kernel``,
then ``inverse_loss_kernel`` in the forward and ``inverse_vjp_kernel`` in the
backward, a launch each), their plain versions ``inverse_points_plain``,
``chunk_terms_plain`` and ``chunk_terms_vjp_plain`` on CPU tensors. Adam is
``torch.optim.Adam`` with optax's defaults.

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

from . import _kernels, accel, render as R
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
    surf_n = torch.clamp(target_hit.sum().to(f32), min=1.0)
    weights = (surface_weight, eikonal_weight, depth_weight)
    # K13's loss sum, reused by every chunk in stream order
    scratch = None if dev.type == "cpu" \
        else inverse_terms_scratch(chunks[0][0].shape[0], dev)

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
            loss = chunk_loss(pk_l, o, d, tt, th, t, hit, dn, surf_n,
                              *weights, scratch=scratch)
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


def chunk_loss(pk, o, d, tt, th, t, hit, dn, surf_n, surface_weight,
               eikonal_weight, depth_weight, scratch=None):
    """A chunk's loss (hpsdf_tpu inverse.py chunk_field with the depth term
    normalised by ``dn``): its 7n target points (``inverse_points``), one
    read of the values there and of the band points' gradients
    (``accel.values_and_gradient_at``), then the terms (``_ChunkTerms``:
    the loss, its VJP in the backward; ``scratch`` as ``inverse_loss_kernel``
    takes it). Differentiable with respect to ``pk``'s tables and ``t``."""
    n = o.shape[0]
    f, g = accel.values_and_gradient_at(pk, inverse_points(o, d, tt), 3 * n)
    return _ChunkTerms.apply(f, g, t, th, hit, tt, dn, surf_n,
                             (surface_weight, eikonal_weight, depth_weight),
                             scratch)


def _check_rays(*tensors):
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"inverse: tensors on {x.device} and {dev}")


def inverse_points_plain(o, d, tt):
    """The chunk's 7n points, (7n, 3) f32: the band points (surface o + tt
    d, in o + (tt + BAND) d, out o + (tt - BAND) d), then the free-space
    points at FRACS of tt, fraction-major."""
    _check_rays(o, d, tt)
    band = float(np.float32(BAND))
    fracs = torch.tensor(FRACS, dtype=torch.float32, device=o.device)
    surf = o + tt[:, None] * d
    in_p = o + (tt + band)[:, None] * d         # want f <= -band/2
    out_p = o + (tt - band)[:, None] * d        # want f >= +band/2
    free = o[None] + (fracs[:, None, None] * tt[None, :, None]) * d[None]
    return torch.cat([surf, in_p, out_p, free.reshape(-1, 3)])


def inverse_points_kernel(o, d, tt):
    """K13's first launch (csrc/inverse_terms.cu): ``inverse_points_plain``
    bit for bit, on CUDA tensors."""
    _check_rays(o, d, tt)
    if o.device.type != "cuda":
        raise ValueError(f"inverse_points_kernel: tensors on {o.device}, "
                         "not a CUDA device")
    o, d, tt = (x.to(torch.float32).contiguous() for x in (o, d, tt))
    n = o.shape[0]
    out = torch.empty((7 * n, 3), dtype=torch.float32, device=o.device)
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_inverse_points(
        o.data_ptr(), d.data_ptr(), tt.data_ptr(), n, out.data_ptr(),
        _kernels.stream_of(o)), "inverse_points")
    inverse_points_kernel.launches += 1
    return out


inverse_points_kernel.launches = 0


def inverse_points(o, d, tt):
    """The chunk's 7n points: kernel K13's first launch on CUDA tensors,
    the plain version on CPU tensors."""
    if o.device.type == "cpu":
        return inverse_points_plain(o, d, tt)
    return inverse_points_kernel(o, d, tt)


def chunk_terms_plain(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                      eikonal_weight, depth_weight):
    """A chunk's loss terms and their VJP by hand, whatever the device, in
    K13's order of operations: f (7n,) the values at ``inverse_points``,
    g (3n, 3) the band points' gradients, th / hit (n,) bool the target and
    marched hits, t / tt (n,) the marched and target depths, dn and surf_n
    the depth and field normalisers (f32 scalars on the device). Returns
    (loss, df (7n,), dg (3n, 3), dt (n,)): the field, free-space and
    eikonal terms over surf_n plus the depth term over dn (hpsdf_tpu
    inverse.py chunk_field), and their gradients with respect to f, g and
    t. relu's derivative is 0 at 0, as autograd's."""
    f32 = torch.float32
    n = t.shape[0]
    half = float(np.float32(BAND) * np.float32(0.5))
    s = th.to(f32)
    m = (hit & th).to(f32)
    cs = surf_n.new_tensor(np.float32(surface_weight)) / surf_n
    ce = surf_n.new_tensor(np.float32(eikonal_weight)) / (3.0 * surf_n)
    cd = dn.new_tensor(np.float32(depth_weight)) / dn
    fs, ff = f[:n], f[3 * n:].view(len(FRACS), n)
    r_in = torch.clamp(f[n:2 * n] + half, min=0.0)
    r_out = torch.clamp(half - f[2 * n:3 * n], min=0.0)
    r_ff = torch.clamp(half - ff, min=0.0)
    field = (fs * fs + r_in * r_in) + r_out * r_out
    free = r_ff[0] * r_ff[0]
    for k in range(1, len(FRACS)):
        free = free + r_ff[k] * r_ff[k]
    gg = g * g
    gn = torch.sqrt((gg[:, 0] + gg[:, 1]) + gg[:, 2] + 1e-12).view(3, n)
    e = gn - 1.0
    eik = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]
    dtt = t - tt
    loss = torch.sum(s * (cs * (field + 0.25 * free) + ce * eik)
                     + m * (cd * (dtt * dtt)))
    ws = s * cs
    w2, wh = 2.0 * ws, 0.5 * ws
    df = torch.cat([w2 * fs, w2 * r_in, -(w2 * r_out),
                    (-(wh * r_ff)).reshape(-1)])
    dg = ((2.0 * (s * ce)) * (e / gn)).reshape(-1, 1) * g
    dt = (2.0 * (m * cd)) * dtt
    return loss, df, dg, dt


def chunk_terms_vjp_plain(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                          eikonal_weight, depth_weight, go):
    """The VJP of a chunk's loss, whatever the device: chunk_terms_plain's
    (df, dg, dt), each times go (the loss's cotangent: a number or a 0-d
    tensor, taken as f32) as torch's df * go rounds it."""
    go = torch.as_tensor(go, dtype=torch.float32, device=f.device)
    return tuple(x * go for x in chunk_terms_plain(
        f, g, th, hit, t, tt, dn, surf_n, surface_weight, eikonal_weight,
        depth_weight)[1:])


def inverse_terms_scratch(n, device):
    """Zeroed scratch for ``inverse_loss_kernel`` on chunks of up to ``n``
    rays: a ticket and a partial sum a block, which every launch leaves
    zeroed. Launches in order on one stream may share it; launches in flight
    at once each need their own."""
    return torch.zeros(_kernels.load().hpsdf_inverse_terms_scratch(n),
                       dtype=torch.float32, device=device)


def _terms_args(f, g, th, hit, t, tt, dn, surf_n, what):
    """The terms launches' checks: the arrays on one CUDA device in the
    shapes and types the kernels take, f32 and contiguous."""
    _check_rays(f, g, th, hit, t, tt, dn, surf_n)
    if f.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {f.device}, not a CUDA device")
    n = t.shape[0]
    if f.shape != (7 * n,) or g.shape != (3 * n, 3) \
            or th.shape != (n,) or hit.shape != (n,) or tt.shape != (n,) \
            or th.dtype != torch.bool or hit.dtype != torch.bool:
        raise ValueError(f"{what}: f {tuple(f.shape)}, g {tuple(g.shape)}, "
                         f"th {th.dtype} {tuple(th.shape)}, hit {hit.dtype} "
                         f"{tuple(hit.shape)}, tt {tuple(tt.shape)} for {n} "
                         "rays")
    f, g, t, tt, dn, surf_n = (x.to(torch.float32).contiguous()
                               for x in (f, g, t, tt, dn, surf_n))
    return f, g, th.contiguous(), hit.contiguous(), t, tt, dn, surf_n


def _weights(surface_weight, eikonal_weight, depth_weight):
    return tuple(float(np.float32(w)) for w in (surface_weight,
                                                eikonal_weight, depth_weight))


def inverse_loss_kernel(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                        eikonal_weight, depth_weight, scratch=None):
    """K13's terms forward (csrc/inverse_terms.cu): the loss of
    ``chunk_terms_plain`` on CUDA tensors, summed in a fixed order in the
    same launch. dn and surf_n stay on the card: nothing is read back.
    ``scratch``: ``inverse_terms_scratch`` for at least these rays; None
    makes one (a zero-fill on the card beside the launch)."""
    f, g, th, hit, t, tt, dn, surf_n = _terms_args(
        f, g, th, hit, t, tt, dn, surf_n, "inverse_loss_kernel")
    n = t.shape[0]
    loss = torch.empty((), dtype=torch.float32, device=f.device)
    lib = _kernels.load()
    if scratch is None:
        scratch = inverse_terms_scratch(n, f.device)
    if scratch.dtype != torch.float32 or not scratch.is_contiguous() \
            or scratch.device != f.device \
            or scratch.numel() < lib.hpsdf_inverse_terms_scratch(n):
        raise ValueError(f"inverse_loss_kernel: scratch {scratch.dtype} "
                         f"{tuple(scratch.shape)} on {scratch.device} for "
                         f"{n} rays on {f.device}")
    _kernels.check(lib, lib.hpsdf_inverse_loss(
        f.data_ptr(), g.data_ptr(), th.data_ptr(), hit.data_ptr(),
        t.data_ptr(), tt.data_ptr(), n, surf_n.data_ptr(), dn.data_ptr(),
        *_weights(surface_weight, eikonal_weight, depth_weight),
        loss.data_ptr(), scratch.data_ptr(), _kernels.stream_of(f)),
        "inverse_loss")
    inverse_loss_kernel.launches += 1
    return loss


inverse_loss_kernel.launches = 0


def inverse_vjp_kernel(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                       eikonal_weight, depth_weight, go):
    """K13's terms backward (csrc/inverse_terms.cu): ``chunk_terms_vjp_plain``
    bit for bit on CUDA tensors, (df, dg, dt) in one launch. ``go``: the
    loss's cotangent, one value in a tensor on the card (read there as f32:
    no sync)."""
    f, g, th, hit, t, tt, dn, surf_n = _terms_args(
        f, g, th, hit, t, tt, dn, surf_n, "inverse_vjp_kernel")
    if go.numel() != 1 or go.device != f.device:
        raise ValueError(f"inverse_vjp_kernel: go {tuple(go.shape)} on "
                         f"{go.device}, not one value on {f.device}")
    go = go.to(torch.float32).contiguous()
    df, dg, dt = torch.empty_like(f), torch.empty_like(g), torch.empty_like(t)
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_inverse_vjp(
        f.data_ptr(), g.data_ptr(), th.data_ptr(), hit.data_ptr(),
        t.data_ptr(), tt.data_ptr(), t.shape[0], surf_n.data_ptr(),
        dn.data_ptr(), *_weights(surface_weight, eikonal_weight,
                                 depth_weight),
        go.data_ptr(), df.data_ptr(), dg.data_ptr(),
        dt.data_ptr(), _kernels.stream_of(f)), "inverse_vjp")
    inverse_vjp_kernel.launches += 1
    return df, dg, dt


inverse_vjp_kernel.launches = 0


def chunk_terms_loss(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                     eikonal_weight, depth_weight, scratch=None):
    """A chunk's loss: K13's terms forward on CUDA tensors (with
    ``scratch``, as there), ``chunk_terms_plain``'s on CPU tensors."""
    args = (f, g, th, hit, t, tt, dn, surf_n, surface_weight,
            eikonal_weight, depth_weight)
    if f.device.type == "cpu":
        return chunk_terms_plain(*args)[0]
    return inverse_loss_kernel(*args, scratch=scratch)


def chunk_terms_vjp(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                    eikonal_weight, depth_weight, go):
    """(df, dg, dt) of a chunk times ``go``: K13's terms backward on CUDA
    tensors, ``chunk_terms_vjp_plain`` on CPU tensors."""
    args = (f, g, th, hit, t, tt, dn, surf_n, surface_weight,
            eikonal_weight, depth_weight)
    if f.device.type == "cpu":
        return chunk_terms_vjp_plain(*args, go)
    return inverse_vjp_kernel(*args, go)


def chunk_terms(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                eikonal_weight, depth_weight, scratch=None):
    """(loss, df, dg, dt) of a chunk: K13's terms forward and backward
    (go = 1) on CUDA tensors (with ``scratch``, as there),
    ``chunk_terms_plain`` on CPU tensors."""
    args = (f, g, th, hit, t, tt, dn, surf_n, surface_weight,
            eikonal_weight, depth_weight)
    if f.device.type == "cpu":
        return chunk_terms_plain(*args)
    return (inverse_loss_kernel(*args, scratch=scratch),
            *inverse_vjp_kernel(*args, torch.ones((), device=f.device)))


class _ChunkTerms(torch.autograd.Function):
    """A chunk's loss from (f, g, t): the forward keeps its inputs and
    writes the loss alone, the backward writes its VJP times the loss's
    cotangent in one launch (``chunk_terms_loss``, ``chunk_terms_vjp``)."""

    @staticmethod
    def forward(ctx, f, g, t, th, hit, tt, dn, surf_n, weights,
                scratch=None):
        ctx.save_for_backward(f, g, t, th, hit, tt, dn, surf_n)
        ctx.weights = weights
        return chunk_terms_loss(f, g, th, hit, t, tt, dn, surf_n, *weights,
                                scratch=scratch)

    @staticmethod
    def backward(ctx, go):
        f, g, t, th, hit, tt, dn, surf_n = ctx.saved_tensors
        df, dg, dt = chunk_terms_vjp(f, g, th, hit, t, tt, dn, surf_n,
                                     *ctx.weights, go=go)
        return (df, dg, dt) + (None,) * 7


def render_targets(tree: Octree, origins, dirs, t_max: float = 10.0,
                   step_cap: float | None = None):
    """Trace a reference tree to produce (target_t, target_hit) for
    ``fit_to_depth``. Pass ``step_cap`` ~0.02 when tracing a partially
    optimised tree (its field is not a metric SDF)."""
    res = R.trace(tree, origins, dirs, t_max=t_max, step_cap=step_cap)
    return res.t, res.hit
