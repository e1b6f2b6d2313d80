"""Sharding on ``torch.distributed``: device meshes, sharded queries and
traces, and a sharded SGD step on the coefficient field.

The counterpart of ``hpsdf_tpu/parallel.py``, with its names. The JAX
package places arrays with ``NamedSharding`` and lets XLA insert the
collectives; here every rank is a process that calls the same function with
the same full inputs, and the collectives are written out:

  * the **batch axis** ("batch"): points, rays and fit cells are
    independent, so each rank computes a contiguous share of the batch,
    padded by repeating its last row to a multiple of the axis's size
    (``_pad_batch``), through the same path as one device (K1, or K4 + K3
    through ``render.trace``), and the shares are all-gathered: every rank
    returns the full result, equal to the one-device call. Gradients and
    loss sums are all-reduced.
  * the **node axis** ("node", ``node_parallel`` ranks): with
    ``shard_nodes`` a rank holds only a contiguous block of the node rows,
    ceil(N / node_parallel) of them (``ShardedTree``, ``node_shard``). A
    query is depth_used descent rounds and one leaf evaluation (the
    node-range modes of K1, ``query.descend_round`` / ``query.leaf_eval``),
    in each of which a rank answers the points whose node it holds and
    gives 0 for the others, followed by an all-reduce (sum) of the
    batch-share-sized answers over the node axis: depth_used + 1
    collectives a query, none carrying node rows, as XLA lowers the
    reference (``hpsdf_tpu/parallel.py:89-97``). The train step's VJP (K8's
    node-range mode) scatters into the rank's own rows from the forward's
    leaves. A node axis of size 1 holds the whole tree, so ``shard_nodes``
    there is the replicated layout, as in the JAX package.

``build(fit_mesh=)`` and ``enforce_continuity(mesh=)`` spread over every
rank of the mesh (``mesh_shard``), as the reference flattens its mesh;
``shard_trace`` and ``fit_to_depth(mesh=)`` split over the batch axis and
repeat the work over the node axis.

The sharded reads carry gradients to the tree, as the reference's do:
``shard_query`` to ``tree.coeffs`` and ``tree.centre``, ``shard_trace`` to
``tree.coeffs``. Every rank passes the same inputs and takes the same loss
of the gathered result, as every rank receives all of it; a backward is
then a collective that every rank runs, and each rank's gradient is the
one-device gradient of the tensor it passed. The gather hands each rank its
share of the cotangent (``_Gathered``), the rank's kernels take the VJP of
its share (K8 and K1c, K8's trace form; on the node axis K8's node-range
mode and K1c on the block), the tree's arrays sum it over the
batch axis (``_Replicated``), and a whole tree sliced into node blocks
gathers the blocks' gradients over the node axis (``_NodeSlice``). The
points and rays take no gradient (``_refuse_gathered_grad``): the
reference's sharded reads turn them into numpy arrays first.

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
from .config import Config
from .query import (OUTSIDE_VALUE, _to_unit, coeff_scatter_nodes,
                    descend_round, leaf_eval, query as _query_fn,
                    query_centre_vjp)
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
    exists), of shape (ranks / node_parallel, node_parallel): rank
    devices[b * node_parallel + k] at (b, k). Raises ValueError where
    ``node_parallel`` does not divide the ranks. Every rank of the world
    calls it alike."""
    dev = _device.resolve(device)
    init_distributed(device=dev)
    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    n = len(ranks)
    if n % node_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"node_parallel={node_parallel}")
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(
        n // node_parallel, node_parallel),
        mesh_dim_names=(BATCH_AXIS, NODE_AXIS))
    if node_parallel > 1 and n < dist.get_world_size():
        # the group of all its ranks (``mesh_shard``), made while every
        # rank of the world calls, as new_group needs
        mesh.hpsdf_flat_group = dist.new_group(sorted(ranks))
    return mesh


class BatchShard(NamedTuple):
    """A rank's place on a mesh's batch axis (or on all its ranks,
    ``mesh_shard``): the axis's process group, this rank's index on it and
    its size."""
    group: object
    rank: int
    size: int


class NodeShard(NamedTuple):
    """A rank's place on a mesh's node axis: the axis's process group, this
    rank's index on it and its size, and the node rows [lo, hi) it holds
    (``node_range``)."""
    group: object
    rank: int
    size: int
    lo: int
    hi: int


def _dim(mesh, name: str) -> int | None:
    """The mesh dimension named ``name``; a 1-D mesh's only one is the
    batch axis. Raises TypeError for anything but a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a torch.distributed DeviceMesh is needed "
                        f"(make_mesh), got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if name in names:
        return names.index(name)
    if mesh.ndim > 1 and name == BATCH_AXIS:
        raise ValueError(f"a mesh of {mesh.ndim} dimensions needs one named "
                         f"{BATCH_AXIS!r}, got {names}")
    return 0 if name == BATCH_AXIS else None


def _node_size(mesh) -> int:
    """The size of the mesh's node axis (1 where it has none)."""
    dim = _dim(mesh, NODE_AXIS)
    return 1 if dim is None else mesh.size(dim)


def batch_shard(mesh, shard_nodes: bool = False) -> BatchShard:
    """The batch axis of ``mesh`` (a 1-D mesh's only axis). On a (batch,
    node) mesh its group holds the ranks of this rank's node index, which
    hold the same node block: a gradient of those rows is all-reduced
    there. ``shard_nodes``, which the sharded entry points pass on, changes
    nothing: the batch axis is the same in either layout. Raises TypeError
    for anything but a ``DeviceMesh``."""
    dim = _dim(mesh, BATCH_AXIS)
    return BatchShard(mesh.get_group(dim), mesh.get_local_rank(dim),
                      mesh.size(dim))


def node_range(rows: int, size: int, rank: int) -> tuple[int, int]:
    """The node rows [lo, hi) rank ``rank`` of a node axis of ``size``
    holds of ``rows``: ceil(rows / size) a rank, the last blocks shorter
    (or empty)."""
    per = -(-rows // size)
    return min(rank * per, rows), min((rank + 1) * per, rows)


def node_shard(mesh, rows: int) -> NodeShard:
    """The node axis of ``mesh`` and this rank's rows of a tree of ``rows``
    node rows. Raises ValueError for a mesh without a node axis."""
    dim = _dim(mesh, NODE_AXIS)
    if dim is None:
        raise ValueError(f"the mesh has no {NODE_AXIS!r} axis")
    rank, size = mesh.get_local_rank(dim), mesh.size(dim)
    return NodeShard(mesh.get_group(dim), rank, size,
                     *node_range(rows, size, rank))


def mesh_shard(mesh) -> BatchShard:
    """Every rank of ``mesh`` as one axis, as the reference flattens its
    mesh for the sharded fit and CG (hpsdf_tpu build.py:353-356,
    continuity.py:537-538): the batch axis where it is the only axis wider
    than one, else all the mesh's ranks, in rank order."""
    sh = batch_shard(mesh)
    if sh.size == mesh.size():
        return sh
    ranks = sorted(mesh.mesh.flatten().tolist())
    group = (dist.group.WORLD if ranks == list(range(dist.get_world_size()))
             else getattr(mesh, "hpsdf_flat_group", None))
    if group is None:
        raise ValueError("a mesh over part of the ranks with a node axis "
                         "wider than one must come from make_mesh")
    return BatchShard(group, dist.get_rank(group), len(ranks))


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


@dataclasses.dataclass(frozen=True)
class ShardedTree:
    """A rank's block of a node-sharded tree (``shard_nodes`` on a node
    axis wider than one): the rows [lo, hi) of the five node arrays of a
    tree of ``n_rows`` rows (the ``Octree``'s arrays, padded), child
    indices global, with the whole tree's ``n_nodes``, ``deg_used``,
    ``depth_used`` and ``config``. ``_shard_tree`` makes it from an
    ``Octree``; ``gather_tree`` gives the ``Octree`` back."""
    child_idx: torch.Tensor    # i32[hi - lo]
    centre: torch.Tensor       # f64[hi - lo, 3]
    depth: torch.Tensor        # i32[hi - lo]
    degree: torch.Tensor       # i32[hi - lo]
    coeffs: torch.Tensor       # f64[hi - lo, C]
    lo: int
    hi: int
    n_rows: int
    n_nodes: int
    deg_used: int
    depth_used: int
    config: Config

    @property
    def device(self) -> torch.device:
        return self.child_idx.device

    @property
    def nbytes(self) -> int:
        """Bytes of the rank's node arrays."""
        return sum(getattr(self, k).nbytes for k in _ARRAYS)


_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")
# the arrays a sharded read differentiates
_GRAD_ARRAYS = ("coeffs", "centre")


def node_block(tree: Octree, size: int, rank: int) -> ShardedTree:
    """Rank ``rank``'s block of ``tree`` on a node axis of ``size``
    (``node_range``), its rows copied so that the whole tree can be
    freed."""
    rows = tree.child_idx.shape[0]
    lo, hi = node_range(rows, size, rank)
    return ShardedTree(**{k: getattr(tree, k)[lo:hi].clone()
                          for k in _ARRAYS},
                       lo=lo, hi=hi, n_rows=rows, n_nodes=tree.n_nodes,
                       deg_used=tree.deg_used, depth_used=tree.depth_used,
                       config=tree.config)


def _shard_tree(tree, mesh: DeviceMesh, shard_nodes: bool):
    """``tree`` (an ``Octree`` or a ``ShardedTree``) in the layout
    ``tree_sharding`` gives: this rank's ``ShardedTree`` for
    ``shard_nodes`` on a node axis wider than one, else the whole
    ``Octree`` (gathered where it was sharded)."""
    if shard_nodes and _node_size(mesh) > 1:
        if isinstance(tree, ShardedTree):
            nd = node_shard(mesh, tree.n_rows)
            if (tree.lo, tree.hi) != (nd.lo, nd.hi):
                raise ValueError(f"the block [{tree.lo}, {tree.hi}) is not "
                                 f"this rank's [{nd.lo}, {nd.hi})")
            return tree
        nd = node_shard(mesh, tree.child_idx.shape[0])
        return dataclasses.replace(node_block(tree, nd.size, nd.rank), **{
            k: _NodeSlice.apply(getattr(tree, k), nd) for k in _GRAD_ARRAYS
            if _device.wants_grad(getattr(tree, k))})
    return gather_tree(tree, mesh)


def _gather_rows(x: torch.Tensor, nd: NodeShard, rows: int) -> torch.Tensor:
    """The whole array of ``rows`` rows whose blocks the ranks of the node
    axis ``nd`` hold, each padded to ceil(rows / size) rows."""
    per = -(-rows // nd.size)
    block = x.new_zeros((per,) + tuple(x.shape[1:]))
    block[: x.shape[0]] = x
    return all_gather(block, nd)[:rows]


class _NodeGather(torch.autograd.Function):
    """``_gather_rows`` of a block that requires a gradient. Every rank
    holds the whole array's gradient (each has summed it over the batch
    axis), so the backward is the rank's own rows of it."""

    @staticmethod
    def forward(ctx, x, nd, rows):
        ctx.nd = nd
        return _gather_rows(x, nd, rows)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.nd.lo:ctx.nd.hi], None, None


class _NodeSlice(torch.autograd.Function):
    """The rows [lo, hi) of a whole tree's array that this rank holds on
    the node axis ``nd``, copied. Each rank's gradient covers its own rows,
    so the backward gathers the blocks over the node axis: the whole
    array's gradient on every rank."""

    @staticmethod
    def forward(ctx, x, nd):
        ctx.nd, ctx.rows = nd, x.shape[0]
        return x[nd.lo:nd.hi].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g, ctx.nd, ctx.rows), None


def gather_tree(tree, mesh: DeviceMesh) -> Octree:
    """The whole ``Octree`` of a ``ShardedTree``, on every rank: each array
    all-gathered over the node axis, padded to equal blocks (an ``Octree``
    is returned as it is); an array that requires a gradient gets its own
    rows of the whole one's. For tests and for saving."""
    if isinstance(tree, Octree):
        return tree
    nd = node_shard(mesh, tree.n_rows)
    whole = {}
    for k in _ARRAYS:
        x = getattr(tree, k)
        whole[k] = (_NodeGather.apply(x, nd, tree.n_rows)
                    if _device.wants_grad(x)
                    else _gather_rows(x, nd, tree.n_rows))
    return Octree(**whole, n_nodes=tree.n_nodes, deg_used=tree.deg_used,
                  depth_used=tree.depth_used, config=tree.config)


def _query_nodes(st: ShardedTree, pts: torch.Tensor, nd: NodeShard,
                 outside_value_max: bool):
    """``query`` of the points (B, 3), each rank of the node axis ``nd``
    holding ``st``'s rows: depth_used descent rounds and the leaf
    evaluation, each answered by the rank holding the point's node (0 from
    the others) and summed over the node axis, then the outside-root
    sentinel, which depends on the points alone. Returns (values (B,),
    leaves (B,) i32)."""
    unit = _to_unit(st, pts)
    clamped = unit.clamp(-0.5, 0.5)
    cur = torch.zeros(pts.shape[0], dtype=torch.int32, device=pts.device)
    for _ in range(st.depth_used):
        cur = all_reduce(descend_round(st, clamped, cur), nd)
    val = all_reduce(leaf_eval(st, clamped, cur), nd)
    if outside_value_max:
        val = torch.where(torch.all(unit.abs() <= 0.5, dim=-1), val,
                          OUTSIDE_VALUE)
    return val, cur


class _QueryNodes(torch.autograd.Function):
    """The node-sharded query (``_query_nodes``) with the rank's
    coefficient and centre rows as its inputs; its VJP scatters into those
    rows from the leaves the forward found: K8's node-range mode for the
    coefficients, K1c on the block for the centres. The descent rounds
    carry no derivative."""

    @staticmethod
    def forward(ctx, coeffs, centre, st, pts, nd, outside_value_max=False):
        val, leaf = _query_nodes(st, pts, nd, outside_value_max)
        ctx.save_for_backward(pts, leaf)
        ctx.st, ctx.outside_value_max = st, outside_value_max
        return val

    @staticmethod
    def backward(ctx, w):
        pts, leaf = ctx.saved_tensors
        w = w.contiguous()
        d_coeffs = d_centre = None
        if ctx.needs_input_grad[0]:
            d_coeffs = coeff_scatter_nodes(ctx.st, pts, leaf, w,
                                           ctx.outside_value_max)
        if ctx.needs_input_grad[1]:
            d_centre = query_centre_vjp(
                ctx.st, pts, leaf, w,
                outside_value_max=ctx.outside_value_max)
        return d_coeffs, d_centre, None, None, None, None


class _Gathered(torch.autograd.Function):
    """The batch axis's all-gather of the ranks' shares, cut to the batch's
    ``b`` rows. Every rank takes the same loss of the gathered result, so
    each holds the same cotangent: the backward is this rank's share of it,
    zero on the padded rows (a reduce-scatter would add the axis's equal
    cotangents)."""

    @staticmethod
    def forward(ctx, x, sh, b):
        ctx.sh, ctx.per, ctx.b = sh, x.shape[0], b
        return all_gather(x, sh)[:b]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((ctx.per * ctx.sh.size,) + tuple(g.shape[1:]))
        full[:ctx.b] = g
        return share(full, ctx.sh), None, None


class _Replicated(torch.autograd.Function):
    """The identity on an array every rank of the batch axis holds alike
    (the tree's coefficients or centres); each rank's gradient covers its
    share of the batch, so the backward sums it over the axis."""

    @staticmethod
    def forward(ctx, x, sh):
        ctx.sh = sh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format),
                          ctx.sh), None


def _replicated(tree, sh: BatchShard, keys=_GRAD_ARRAYS):
    """``tree`` with its arrays named in ``keys`` that require a gradient
    passed through ``_Replicated`` over the batch axis ``sh``."""
    return dataclasses.replace(tree, **{
        k: _Replicated.apply(getattr(tree, k), sh) for k in keys
        if _device.wants_grad(getattr(tree, k))})


def _gathered(x: torch.Tensor, sh: BatchShard, b: int) -> torch.Tensor:
    """The ranks' shares ``x`` all-gathered over the batch axis ``sh`` and
    cut to ``b`` rows, differentiable where ``x`` requires a gradient."""
    if x.requires_grad:
        return _Gathered.apply(x, sh, b)
    return all_gather(x, sh)[:b]


def _refuse_gathered_grad(what: str, *xs, to: str = "the points or rays",
                          why: str = "its all-gather hands back the tree's "
                                     "gradients only") -> None:
    """Raise where one of ``xs``, by default a sharded read's points or
    rays, requires a gradient: the reads carry gradients to the tree only,
    as the reference's, which turns the points into numpy arrays first."""
    if _device.wants_grad(*(x for x in xs if isinstance(x, torch.Tensor))):
        raise RuntimeError(f"parallel.{what} carries no gradient to {to}: "
                           f"{why}")


def shard_query(tree, pts, mesh: DeviceMesh,
                shard_nodes: bool = False) -> torch.Tensor:
    """``query`` with the points split over the mesh's batch axis: each rank
    queries its share of the padded batch (K1 on a card) and the shares are
    all-gathered. With ``shard_nodes`` on a node axis wider than one the
    tree (an ``Octree``, sliced here, or this rank's ``ShardedTree``) is
    split over the node axis and each share's query runs on the node
    blocks (``_query_nodes``). Every rank passes the same points and
    returns all the values, equal to ``query(tree, pts)``.

    Differentiable with respect to ``tree.coeffs`` and ``tree.centre``
    (those of the ``Octree`` or of this rank's block), where every rank
    takes the same loss of the values: each rank's kernels take its
    share's VJP (K8 and K1c; on the node axis K8's node-range mode and K1c
    on the block), summed over the batch axis and, for an ``Octree``
    sliced into blocks, gathered over the node axis. Points that require a
    gradient raise."""
    _refuse_gathered_grad("shard_query", pts)
    sh = batch_shard(mesh, shard_nodes)
    st = _shard_tree(tree, mesh, shard_nodes)
    pts = torch.as_tensor(pts, dtype=st.centre.dtype, device=st.device)
    padded, b = _pad_batch(pts, sh.size)
    mine = share(padded, sh)
    if isinstance(st, ShardedTree):
        nd = node_shard(mesh, st.n_rows)
        if _device.wants_grad(st.coeffs, st.centre):
            rt = _replicated(st, sh)
            val = _QueryNodes.apply(rt.coeffs, rt.centre, rt, mine, nd, True)
        else:
            val = _query_nodes(st, mine, nd, True)[0]
    else:
        val = _query_fn(_replicated(st, sh), mine)
    return _gathered(val, sh, b)


def shard_trace(tree, origins, dirs, mesh: DeviceMesh,
                t_max: float = 10.0, **kw) -> TraceResult:
    """Sphere-trace with the rays split over the mesh's batch axis (the
    tree, gathered where it is a ``ShardedTree``, and its packed tables
    whole on every rank): ``render.trace`` on each rank's share with
    ``packed=``, then ``t`` and ``hit`` all-gathered, equal to the
    one-device call; ``steps`` is summed over the batch axis, padded rays
    included. With ``cone_tiles`` = (H, W, T) the rays are an image and the
    shares are whole rows of tiles (the last row of tiles repeated as
    padding), each traced as an image of its own through K4 and K3.

    ``t`` is differentiable with respect to ``tree.coeffs``, packed tables
    given or not, as ``render.trace`` (the implicit VJP, K8's trace form,
    on each rank's share), where every rank takes the same loss of it: the
    gradient is summed over the batch axis. Rays or ``tree.centre`` that
    require a gradient raise, before any collective."""
    _refuse_gathered_grad("shard_trace", origins, dirs)
    _refuse_gathered_grad("shard_trace", getattr(tree, "centre", None),
                          to="tree.centre",
                          why="the trace's implicit VJP reaches the "
                              "coefficients only")
    sh = batch_shard(mesh)
    whole = _shard_tree(tree, mesh, False)
    tree = _replicated(whole, sh, ("coeffs",))
    packed = kw.pop("packed", None) or pack_tree(whole)
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
    return TraceResult(_gathered(res.t, sh, b), all_gather(res.hit, sh)[:b],
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


def make_sharded_train_step(mesh: DeviceMesh, tree, shard_nodes: bool = True):
    """``train_step`` with the points split over the mesh's batch axis and,
    with ``shard_nodes`` on a node axis wider than one, the node rows over
    the node axis: ``run(tree, pts, target, lr=1e-3)`` on every rank with
    the same full points and targets and a whole ``Octree`` or this rank's
    ``ShardedTree``. Each rank takes the gradient of its share of
    0.5 * sum((q - t)^2) / B (padded points weigh nothing) with respect to
    the coefficient rows it holds (all of them, or its block through the
    node-sharded query, whose VJP is K8's node-range mode); the gradients
    and the loss are all-reduced over the batch axis, whose ranks hold the
    same rows, and each rank updates its rows. Returns (tree', loss), tree'
    in the layout ``tree_sharding`` gives (a ``ShardedTree`` when node
    sharded), the loss replicated. ``tree`` is the reference's argument,
    from which it lays out the node arrays; here ``run`` lays out the tree
    it is given."""
    sh = batch_shard(mesh, shard_nodes)

    def run(tr, pts, target, lr=1e-3):
        tr = _shard_tree(tr, mesh, shard_nodes)
        dt, dev = tr.coeffs.dtype, tr.device
        pts = torch.as_tensor(pts, dtype=dt, device=dev)
        target = torch.as_tensor(target, dtype=dt, device=dev)
        pts_p, b = _pad_batch(pts, sh.size)
        tgt_p, _ = _pad_batch(target, sh.size)
        w = (torch.arange(pts_p.shape[0], device=dev) < b).to(dt)
        mine = [share(x, sh) for x in (pts_p, tgt_p, w)]
        coeffs = tr.coeffs.detach().requires_grad_(True)
        with torch.enable_grad():
            if isinstance(tr, ShardedTree):
                q = _QueryNodes.apply(coeffs, tr.centre, tr, mine[0],
                                      node_shard(mesh, tr.n_rows))
            else:
                q = _query_fn(dataclasses.replace(tr, coeffs=coeffs),
                              mine[0], outside_value_max=False)
            part = 0.5 * torch.sum(mine[2] * (q - mine[1]) ** 2) / b
            (g,) = torch.autograd.grad(part, coeffs)
        buf = all_reduce(torch.cat([g.reshape(-1), part.detach().reshape(1)]),
                         sh)
        return dataclasses.replace(
            tr, coeffs=tr.coeffs - lr * buf[:-1].view_as(g)), buf[-1]

    return run
