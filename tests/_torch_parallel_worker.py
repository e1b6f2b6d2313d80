"""One rank of the port's sharded paths on the CPU, for
tests/test_torch_parallel.py.

Run as:  python tests/_torch_parallel_worker.py <rank> <size> <port> <dir>

Joins a gloo group of ``size`` ranks at localhost:<port> through
``hpsdf_tpu_torch.parallel.init_distributed(device="cpu")``, reads the
inputs the test wrote to <dir>/inputs.npz (trees built by hpsdf_tpu, the
points, rays and noise), runs the sharded entry points of the port on them
and writes what it returned to <dir>/rank<rank>.npz.

At 2 and 3 ranks: every entry point on the batch axis, make_mesh(size)
(rank 0 also runs the fit without a mesh at the same chunk size), then on
make_mesh(node_parallel=size) the node-sharded query, with the collectives
it made counted by axis, and two node-sharded train steps; then the
sharded reads' gradients (``gradients``). At GRID_RANKS ranks:
__graft_entry__.dryrun_multichip's sequence on a (2, 2) mesh (``grid``),
and the gradients there. Imports neither jax nor hpsdf_tpu.
"""

import dataclasses
import os
import sys

import numpy as np
import torch

rank, size, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4])
torch.set_num_threads(1)

import hpsdf_tpu_torch as T                              # noqa: E402
from hpsdf_tpu_torch import build as TB                  # noqa: E402
from hpsdf_tpu_torch import continuity as TC             # noqa: E402
from hpsdf_tpu_torch import parallel                     # noqa: E402
from hpsdf_tpu_torch.query import OUTSIDE_VALUE          # noqa: E402
from chip_smoke import collectives                       # noqa: E402

# fit chunks of 64 cells: every fit batch spreads over the ranks
FIT_BLOCK_PTS = 64 * 27
GRID_RANKS = 4
ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")

inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
out = {}


def tree_of(pre, cfg):
    """The tree the test wrote under the keys ``pre``child_idx, ...."""
    return T.from_numpy({k: inp[f"{pre}{k}"] for k in ARRAYS},
                        int(inp[f"{pre}n_nodes"]), int(inp[f"{pre}deg_used"]),
                        int(inp[f"{pre}depth_used"]), cfg, device="cpu")


def query_grads(tree, pts, w, mesh, nodes, keys=("coeffs", "centre"),
                axes=None):
    """The gradients of sum(w * shard_query(...)), the sentinel masked, with
    respect to the arrays ``keys`` of ``tree`` (an Octree or this rank's
    ShardedTree), as numpy; with ``axes`` also the collectives the backward
    made, as (axis, elements) strings."""
    xs = {k: getattr(tree, k).detach().clone().requires_grad_(True)
          for k in keys}
    v = parallel.shard_query(dataclasses.replace(tree, **xs), pts, mesh,
                             shard_nodes=nodes)
    v = torch.where(v == OUTSIDE_VALUE, 0.0, v)
    loss = (torch.as_tensor(w) * v).sum()
    if axes is None:
        gs = torch.autograd.grad(loss, list(xs.values()))
        return {k: g.numpy() for k, g in zip(xs, gs)}
    with collectives(axes) as seen:
        gs = torch.autograd.grad(loss, list(xs.values()))
    return {**{k: g.numpy() for k, g in zip(xs, gs)},
            "collectives": np.array(seen, dtype=object).astype(str)}


def trace_grad(tree, o, d, wt, mesh, **kw):
    """The gradient of sum(wt * t) over the hit rays of shard_trace with
    respect to ``tree.coeffs``."""
    c = tree.coeffs.detach().clone().requires_grad_(True)
    res = parallel.shard_trace(dataclasses.replace(tree, coeffs=c), o, d,
                               mesh, t_max=5.0, **kw)
    loss = (torch.as_tensor(wt, dtype=torch.float32)
            * torch.where(res.hit, res.t, 0.0)).sum()
    return torch.autograd.grad(loss, c)[0].numpy()


def gradients(tree, mesh, nmesh, pre=""):
    """The sharded reads' gradients, under the keys ``pre``grad_...: on the
    batch axis of ``mesh`` and the node axis of ``nmesh`` (shard_nodes),
    shard_query's to the coefficients and centres of the whole tree, its
    centres' alone, and on the node axis also of this rank's block, with
    the node backward's collectives; shard_trace's to the coefficients,
    the packed tables built and given, and to this rank's block's (the
    tree gathered over the node axis); a share's cotangent through the
    batch axis's gather, padded rows included."""
    pts, w = inp["grad_pts"], inp["grad_w"]
    for axis, m, nodes in (("batch", mesh, False), ("node", nmesh, True)):
        axes = None
        if nodes:
            axes = {"batch": parallel.batch_shard(m).group,
                    "node": parallel.node_shard(m, 8).group}
        got = query_grads(tree, pts, w, m, nodes, axes=axes)
        for k, g in got.items():
            out[f"{pre}grad_{axis}_{k}"] = g
        out[f"{pre}grad_{axis}_centre_only"] = query_grads(
            tree, pts, w, m, nodes, ("centre",))["centre"]
    block = parallel._shard_tree(tree, nmesh, True)
    out[f"{pre}grad_block_rows"] = np.array([block.lo, block.hi])
    for k, g in query_grads(block, pts, w, nmesh, True).items():
        out[f"{pre}grad_block_{k}"] = g
    o, d, wt = inp["o"], inp["d"], inp["grad_wt"]
    out[f"{pre}grad_trace"] = trace_grad(tree, o, d, wt, mesh)
    out[f"{pre}grad_trace_packed"] = trace_grad(
        tree, o, d, wt, mesh, packed=T.pack_tree(tree))
    out[f"{pre}grad_trace_block"] = trace_grad(block, o, d, wt, nmesh)
    sh = parallel.batch_shard(mesh)
    padded, b = parallel._pad_batch(torch.zeros(pts.shape[0]), sh.size)
    x = parallel.share(padded, sh).requires_grad_(True)
    y = parallel._gathered(x, sh, b)
    y.backward(torch.arange(1.0, b + 1.0, dtype=torch.float32))
    out[f"{pre}grad_pad"] = np.concatenate([[b, sh.rank, sh.size],
                                            x.grad.numpy()])


def grid():
    """__graft_entry__.dryrun_multichip's sequence on make_mesh(node_parallel
    =2) over the 4 ranks, at its sizes, on the tree it builds (written by
    the test under dry_): the fit with fit_mesh, the default (node-sharded)
    train step, shard_query (replicated and node-sharded), shard_trace, the
    row-sharded CG and fit_to_depth."""
    mesh = parallel.make_mesh(node_parallel=2, device="cpu")
    out["grid_shape"] = np.array(mesh.mesh.shape)
    out["grid_sizes"] = np.array([parallel.batch_shard(mesh).size,
                                  parallel.node_shard(mesh, 8).size,
                                  parallel.mesh_shard(mesh).size])
    cfg = T.Config(target_error=1e-3, continuity=False, max_depth=4,
                   max_degree=3)

    def sphere(p):
        return torch.linalg.norm(p, dim=-1) - 0.3

    TB.BLOCK_PTS = FIT_BLOCK_PTS
    fits = []
    real_fit = TB._fit_impl

    def fit_impl(*args):
        fits.append(args[4].shape[0])
        return real_fit(*args)

    TB._fit_impl = fit_impl
    fitted = T.build_octree(cfg, sphere, fit_mesh=mesh, device="cpu")
    out["grid_fit_cells"] = np.array(sum(fits))
    fits.clear()
    one = T.build_octree(cfg, sphere, device="cpu")
    TB._fit_impl = real_fit
    out["grid_fit_one_cells"] = np.array(sum(fits))
    out["grid_fit_equal"] = np.array(
        torch.equal(fitted.child_idx, one.child_idx)
        and torch.equal(fitted.coeffs, one.coeffs))

    tree = tree_of("dry_", cfg)
    step = parallel.make_sharded_train_step(mesh, tree)
    pts = inp["dry_pts"]
    new, loss = step(tree, pts, np.linalg.norm(pts, axis=-1) - 0.3, lr=1e-4)
    out["grid_step_type"] = np.array(type(new).__name__)
    out["grid_step_rows"] = np.array(new.hi - new.lo)
    out["grid_loss"] = np.array(float(loss))
    out["grid_step_coeffs"] = parallel.gather_tree(new, mesh).coeffs.numpy()

    for nodes in (False, True):
        out[f"grid_query_{int(nodes)}"] = parallel.shard_query(
            tree, pts[:64], mesh, shard_nodes=nodes).numpy()
    res = parallel.shard_trace(tree, inp["dry_o"], inp["dry_d"], mesh,
                               t_max=5.0)
    out["grid_trace_t"], out["grid_trace_hit"] = (res.t.numpy(),
                                                  res.hit.numpy())

    tree_c = T.from_numpy({k: inp[f"dry_{k}"] for k in ARRAYS},
                          tree.n_nodes, tree.deg_used, tree.depth_used,
                          T.Config(target_error=1e-3, continuity=True,
                                   continuity_strength=8.0, max_depth=4,
                                   max_degree=3), device="cpu")
    blocks = []
    real_block = TC.row_block

    def row_block(op, n, k):
        blocks.append((n, k))
        return real_block(op, n, k)

    TC.row_block = row_block
    out["grid_cg_coeffs"] = TC.enforce_continuity(tree_c,
                                                  mesh=mesh).coeffs.numpy()
    TC.row_block = real_block
    out["grid_cg_block"] = np.array(blocks[0])

    gradients(tree, mesh, mesh, "grid_")

    o2, d2 = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=16,
                           height=16, device="cpu")
    tt, th = T.inverse.render_targets(tree, o2, d2, t_max=5.0)
    inv = [T.inverse.fit_to_depth(tree, o2, d2, tt, th, n_steps=2,
                                  **kw).losses.numpy()
           for kw in (dict(ray_chunk=64, mesh=mesh), dict(ray_chunk=256))]
    out["grid_inv_losses"], out["grid_inv_one"] = inv


parallel.init_distributed(f"localhost:{port}", size, rank, device="cpu")
if size == GRID_RANKS:
    grid()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    parallel.dist.destroy_process_group()
    print(f"RANK-OK {rank}", flush=True)
    sys.exit(0)

mesh = parallel.make_mesh(device="cpu")
out["mesh_shape"] = np.array(mesh.mesh.shape)
for npar in range(2, size + 2):
    try:
        m = parallel.make_mesh(node_parallel=npar, device="cpu")
        out[f"node_parallel_{npar}"] = np.array(m.mesh.shape)
    except ValueError as e:
        out[f"node_parallel_{npar}"] = np.array(type(e).__name__)

cfg = T.Config(**{k[4:]: v.item() for k, v in inp.items()
                  if k.startswith("cfg_")})
arrays = {k: inp[k] for k in ARRAYS}
tree = T.from_numpy(arrays, int(inp["n_nodes"]), int(inp["deg_used"]),
                    int(inp["depth_used"]), cfg, device="cpu")

# --- points and rays -------------------------------------------------------
out["query"] = parallel.shard_query(tree, inp["pts"], mesh).numpy()
res = parallel.shard_trace(tree, inp["o"], inp["d"], mesh, t_max=5.0)
out["trace_t"], out["trace_hit"] = res.t.numpy(), res.hit.numpy()
res = parallel.shard_trace(tree, inp["img_o"], inp["img_d"], mesh,
                           t_max=5.0, cone_tiles=tuple(inp["img_tiles"]))
out["cone_t"], out["cone_hit"] = res.t.numpy(), res.hit.numpy()

# --- the sharded SGD step --------------------------------------------------
step = parallel.make_sharded_train_step(mesh, tree)
noisy = T.from_numpy({**arrays, "coeffs": inp["noisy"]}, tree.n_nodes,
                     tree.deg_used, tree.depth_used, cfg, device="cpu")
t1, l1 = step(noisy, inp["train_pts"], inp["train_target"], lr=1e-4)
t2, l2 = step(t1, inp["train_pts"], inp["train_target"], lr=1e-4)
out["train_losses"] = np.array([float(l1), float(l2)])
out["train_coeffs"] = t1.coeffs.numpy()


# --- the frontier-sharded fit ----------------------------------------------
def sphere(p):
    return torch.linalg.norm(p - torch.as_tensor(inp["fit_centre"]),
                             dim=-1) - 0.3


TB.BLOCK_PTS = FIT_BLOCK_PTS
fit_cfg = T.Config(target_error=1e-6, continuity=False, max_depth=4,
                   max_degree=4)
fitted = T.build_octree(fit_cfg, sphere, fit_mesh=mesh, device="cpu")
out["fit_child_idx"] = fitted.child_idx.numpy()
out["fit_coeffs"] = fitted.coeffs.numpy()
if rank == 0:
    one = T.build_octree(fit_cfg, sphere, device="cpu")
    out["fit_one_child_idx"] = one.child_idx.numpy()
    out["fit_one_coeffs"] = one.coeffs.numpy()

# --- the row-sharded continuity CG -----------------------------------------
cg_cfg = T.Config(target_error=3e-7, continuity=False,
                  continuity_strength=8.0, max_depth=5, max_degree=3)
cg_tree = tree_of("cg_", cg_cfg)
cont = TC.enforce_continuity(cg_tree, mesh=mesh)
out["cg_coeffs"] = cont.coeffs.numpy()

# --- inverse rendering with the rays sharded --------------------------------
inv_cfg = T.Config(target_error=1e-6, continuity=False, max_depth=4,
                   max_degree=3)
ti, to = (tree_of(f"{name}_", inv_cfg) for name in ("inv_init",
                                                    "inv_target"))
tt, th = T.inverse.render_targets(to, inp["inv_o"], inp["inv_d"], t_max=5.0)
inv = T.inverse.fit_to_depth(ti, inp["inv_o"], inp["inv_d"], tt, th,
                             n_steps=2, lr=1e-3, t_max=5.0,
                             ray_chunk=int(inp["inv_chunk"]), mesh=mesh)
out["inv_losses"] = inv.losses.numpy()
out["inv_coeffs"] = inv.tree.coeffs.numpy()

# --- the node axis: the tree's rows split over every rank ----------------
nmesh = parallel.make_mesh(node_parallel=size, device="cpu")
sh = parallel.batch_shard(nmesh)
nd = parallel.node_shard(nmesh, tree.child_idx.shape[0])
with collectives({"batch": sh.group, "node": nd.group}) as seen:
    out["node_query"] = parallel.shard_query(tree, inp["pts"], nmesh,
                                             shard_nodes=True).numpy()
out["node_collectives"] = np.array(seen, dtype=object).astype(str)
block = parallel._shard_tree(tree, nmesh, True)
out["node_block"] = np.array([block.lo, block.hi, block.n_rows,
                              block.nbytes])
step = parallel.make_sharded_train_step(nmesh, tree)
t1, l1 = step(noisy, inp["train_pts"], inp["train_target"], lr=1e-4)
t2, l2 = step(t1, inp["train_pts"], inp["train_target"], lr=1e-4)
out["node_step_type"] = np.array(type(t2).__name__)
out["node_losses"] = np.array([float(l1), float(l2)])
out["node_coeffs"] = parallel.gather_tree(t1, nmesh).coeffs.numpy()

# --- the sharded reads' gradients ----------------------------------------
gradients(tree, mesh, nmesh)

np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
parallel.dist.destroy_process_group()
print(f"RANK-OK {rank}", flush=True)
