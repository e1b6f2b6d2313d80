"""Sharding on ``torch.distributed``: device meshes, sharded queries and
traces, and a sharded SGD step on the coefficient field.

The counterpart of ``hpsdf_tpu/parallel.py``, with its names. The JAX
package places arrays with ``NamedSharding`` and lets XLA insert the
collectives; here every rank is a process that holds the whole tree and
calls the same function with the same full inputs, and the collectives are
written out:

  * the **batch axis** ("batch"): points, rays and fit cells are
    independent, so each rank computes a contiguous share of the batch,
    padded by repeating its last row to a multiple of the axis's size
    (``_pad_batch``), through the same path as one device (K1, or K4 + K3
    through ``render.trace``), and the shares are all-gathered: every rank
    returns the full result, equal to the one-device call. Gradients and
    loss sums are all-reduced.
  * the **node axis** ("node"): splitting the node arrays over ranks is not
    ported (``ROADMAP.md``, queue 1 'Sharding'); ``make_mesh`` raises
    NotImplementedError for ``node_parallel > 1``. A node axis of size 1
    holds the whole tree, so ``shard_nodes=True`` there is the replicated
    layout, as in the JAX package.

Collectives run on NCCL for CUDA tensors and on gloo for the CPU, and on
gloo for several ranks on one card, which NCCL refuses. Gloo takes CUDA
tensors for every collective used here (``all_reduce`` and
``all_gather_into_tensor``), so nothing is staged through the host; a
gloo collective on CUDA tensors waits on the host until it is done.

Entry points run on the card unless the caller passes ``device="cpu"``
(``init_distributed``, ``make_mesh``); the sharded functions run on the
device of the tree they are given.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from . import _device
from .accel import pack_tree
from .query import query as _query_fn
from .render import TraceResult, trace as _trace
from .tree import Octree

BATCH_AXIS = "batch"
NODE_AXIS = "node"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     backend: str | None = None,
                     device=_device.DEFAULT) -> None:
    """Join the process group: ``torch.distributed.init_process_group`` at
    ``coordinator_address`` ("host:port", or ``$HPSDF_COORDINATOR``) as
    rank ``process_id`` of ``num_processes``. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU unless ``backend`` names one; on a
    CUDA device the rank takes the card ``process_id`` modulo the cards
    (or the index ``device`` names). Without a coordinator and a process
    count it sets up a one-rank group on a local store, so that
    ``make_mesh()`` works in one process. A no-op when a group exists."""
    dev = _device.resolve(device)
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "HPSDF_COORDINATOR")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        rank, world, kw = 0, 1, dict(store=dist.HashStore())
    elif coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed: a coordinator address, the "
                         "number of processes and this process's id go "
                         "together")
    else:
        rank, world = int(process_id), int(num_processes)
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        kw = dict(init_method=addr)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, rank=rank, world_size=world, **kw)


def make_mesh(devices=None, node_parallel: int = 1, *,
              device=_device.DEFAULT) -> DeviceMesh:
    """A (batch, node) ``DeviceMesh`` over ``devices``, the global ranks
    (all of them by default; a one-rank group is set up first where none
    exists), of shape (ranks / node_parallel, node_parallel). Raises
    ValueError where ``node_parallel`` does not divide the ranks, and
    NotImplementedError for ``node_parallel > 1``: the node axis is not
    ported (``ROADMAP.md``, queue 1 'Sharding')."""
    dev = _device.resolve(device)
    init_distributed(device=dev)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if n % node_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"node_parallel={node_parallel}")
    if node_parallel > 1:
        raise NotImplementedError(
            f"make_mesh(node_parallel={node_parallel}): the node axis is not "
            "ported to hpsdf_tpu_torch yet (ROADMAP.md, queue 1 'Sharding')")
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(
        n // node_parallel, node_parallel),
        mesh_dim_names=(BATCH_AXIS, NODE_AXIS))


class BatchShard(NamedTuple):
    """A rank's place on a mesh's batch axis: the axis's process group,
    this rank's index on it and its size."""
    group: object
    rank: int
    size: int


def batch_shard(mesh, shard_nodes: bool = False) -> BatchShard:
    """The batch axis of ``mesh`` (a 1-D mesh's only axis). Raises
    TypeError for anything but a ``DeviceMesh``, and NotImplementedError
    for ``shard_nodes`` on a node axis wider than one."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a torch.distributed DeviceMesh is needed "
                        f"(make_mesh), got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    dim = names.index(BATCH_AXIS) if BATCH_AXIS in names else 0
    if mesh.ndim > 1 and BATCH_AXIS not in names:
        raise ValueError(f"a mesh of {mesh.ndim} dimensions needs one named "
                         f"{BATCH_AXIS!r}, got {names}")
    if shard_nodes and NODE_AXIS in names \
            and mesh.size(names.index(NODE_AXIS)) > 1:
        raise NotImplementedError(
            "shard_nodes on a node axis wider than one: the node axis is not "
            "ported to hpsdf_tpu_torch yet (ROADMAP.md, queue 1 'Sharding')")
    return BatchShard(mesh.get_group(dim), mesh.get_local_rank(dim),
                      mesh.size(dim))


def all_gather(x: torch.Tensor, shard: BatchShard,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Every rank's ``x`` (each of the same shape) stacked along the first
    dimension, in rank order, into ``out`` where given. Booleans travel as
    bytes."""
    if x.dtype == torch.bool:
        return all_gather(x.to(torch.uint8), shard).bool()
    x = x.contiguous()
    if out is None:
        out = x.new_empty((shard.size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=shard.group)
    return out


def all_reduce(x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """The sum over the ranks of the contiguous ``x``, in place."""
    dist.all_reduce(x, group=shard.group)
    return x


def _pad_batch(x: torch.Tensor, m: int):
    """``x`` padded by repeating its last row to a multiple of ``m`` rows,
    and the original count."""
    b = x.shape[0]
    pad = (-b) % m
    if pad:
        x = torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])
    return x, b


def share(x: torch.Tensor, shard: BatchShard) -> torch.Tensor:
    """This rank's contiguous share of a batch padded to a multiple of the
    batch axis's size."""
    per = x.shape[0] // shard.size
    return x[shard.rank * per:(shard.rank + 1) * per]


def tree_sharding(mesh: DeviceMesh, tree: Octree, shard_nodes: bool = False):
    """Octree-shaped record of each array's placements on ``mesh``, one a
    mesh dimension: replicated everywhere by default; ``shard_nodes=True``
    splits the node dimension over the node axis (``Shard(0)`` there),
    which on a node axis of size 1 is the replicated layout."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names or (BATCH_AXIS,) * mesh.ndim
    placements = tuple(Shard(0) if shard_nodes and name == NODE_AXIS
                       else Replicate() for name in names)
    return dataclasses.replace(
        tree, child_idx=placements, centre=placements, depth=placements,
        degree=placements, coeffs=placements)


def shard_query(tree: Octree, pts, mesh: DeviceMesh,
                shard_nodes: bool = False) -> torch.Tensor:
    """``query`` with the points split over the mesh's batch axis: each rank
    queries its share of the padded batch (K1 on a card) and the shares are
    all-gathered. Every rank passes the same points and returns all the
    values, equal to ``query(tree, pts)``."""
    sh = batch_shard(mesh, shard_nodes)
    pts = torch.as_tensor(pts, dtype=tree.centre.dtype, device=tree.device)
    padded, b = _pad_batch(pts, sh.size)
    return all_gather(_query_fn(tree, share(padded, sh)), sh)[:b]


def shard_trace(tree: Octree, origins, dirs, mesh: DeviceMesh,
                t_max: float = 10.0, **kw) -> TraceResult:
    """Sphere-trace with the rays split over the mesh's batch axis (the
    tree and its packed tables whole on every rank): ``render.trace`` on
    each rank's share with ``packed=``, then ``t`` and ``hit`` all-gathered,
    equal to the one-device call; ``steps`` is summed over the ranks,
    padded rays included. With ``cone_tiles`` = (H, W, T) the rays are an
    image and the shares are whole rows of tiles (the last row of tiles
    repeated as padding), each traced as an image of its own through K4
    and K3."""
    sh = batch_shard(mesh)
    packed = kw.pop("packed", None) or pack_tree(tree)
    dev = packed.device
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev)
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    b = o.shape[0]
    tiles = kw.get("cone_tiles")
    if tiles is not None:
        from .render import _check_tiles
        H, W, T = _check_tiles(tiles, b)
        unit = T * W                          # a row of tiles
        rows = o.reshape(H // T, unit, 3), d.reshape(H // T, unit, 3)
        (o, _), (d, _) = (_pad_batch(x, sh.size) for x in rows)
        kw["cone_tiles"] = (o.shape[0] // sh.size * T, W, T)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    else:
        (o, _), (d, _) = _pad_batch(o, sh.size), _pad_batch(d, sh.size)
    res = _trace(tree, share(o, sh), share(d, sh), t_max=t_max,
                 packed=packed, **kw)
    steps = all_reduce(torch.tensor([res.steps], dtype=torch.int64,
                                    device=dev), sh)
    return TraceResult(all_gather(res.t, sh)[:b], all_gather(res.hit, sh)[:b],
                       int(steps[0]))


# --------------------------------------------------------------------------
# Sharded differentiable training step
# --------------------------------------------------------------------------
#
# The octree is the model and its coefficients the parameters: train_step
# is one SGD step on 0.5 * mean((query - target)^2) with respect to them,
# through query's VJP (kernel K8 on a card, in f64).

def loss_fn(coeffs, tree: Octree, pts, target):
    t = dataclasses.replace(tree, coeffs=coeffs)
    pred = _query_fn(t, pts, outside_value_max=False)
    return 0.5 * torch.mean((pred - target) ** 2)


def train_step(tree: Octree, pts, target, lr):
    """One SGD step on the coefficient field. Returns (tree', loss)."""
    coeffs = tree.coeffs.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(coeffs, tree, pts, target)
        (g,) = torch.autograd.grad(loss, coeffs)
    return dataclasses.replace(tree, coeffs=tree.coeffs - lr * g), \
        loss.detach()


def make_sharded_train_step(mesh: DeviceMesh, tree: Octree,
                            shard_nodes: bool = True):
    """``train_step`` with the points split over the mesh's batch axis:
    ``run(tree, pts, target, lr=1e-3)`` on every rank with the same full
    points and targets. Each rank takes the gradient of its share of
    0.5 * sum((q - t)^2) / B (padded points weigh nothing); the gradients
    and the loss are all-reduced, and every rank applies the same update.
    Returns (tree', loss). ``tree`` is the reference's argument, from which
    it lays out the node arrays; here every rank holds them whole."""
    sh = batch_shard(mesh, shard_nodes)

    def run(tr: Octree, pts, target, lr=1e-3):
        dt, dev = tr.coeffs.dtype, tr.device
        pts = torch.as_tensor(pts, dtype=dt, device=dev)
        target = torch.as_tensor(target, dtype=dt, device=dev)
        pts_p, b = _pad_batch(pts, sh.size)
        tgt_p, _ = _pad_batch(target, sh.size)
        w = (torch.arange(pts_p.shape[0], device=dev) < b).to(dt)
        mine = [share(x, sh) for x in (pts_p, tgt_p, w)]
        coeffs = tr.coeffs.detach().requires_grad_(True)
        with torch.enable_grad():
            q = _query_fn(dataclasses.replace(tr, coeffs=coeffs), mine[0],
                          outside_value_max=False)
            part = 0.5 * torch.sum(mine[2] * (q - mine[1]) ** 2) / b
            (g,) = torch.autograd.grad(part, coeffs)
        buf = all_reduce(torch.cat([g.reshape(-1), part.detach().reshape(1)]),
                         sh)
        return dataclasses.replace(
            tr, coeffs=tr.coeffs - lr * buf[:-1].view_as(g)), buf[-1]

    return run
