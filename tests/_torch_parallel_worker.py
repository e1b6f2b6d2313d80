"""One rank of the port's sharded paths on the CPU, for
tests/test_torch_parallel.py.

Run as:  python tests/_torch_parallel_worker.py <rank> <size> <port> <dir>

Joins a gloo group of ``size`` ranks at localhost:<port> through
``hpsdf_tpu_torch.parallel.init_distributed(device="cpu")``, reads the
inputs the test wrote to <dir>/inputs.npz (a tree built by hpsdf_tpu, the
points, rays and noise), runs every sharded entry point of the port on
them and writes what it returned to <dir>/rank<rank>.npz. Rank 0 also runs
the fit without a mesh at the same chunk size. Imports neither jax nor
hpsdf_tpu.
"""

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

# fit chunks of 64 cells: every fit batch spreads over the ranks
FIT_BLOCK_PTS = 64 * 27

inp = dict(np.load(os.path.join(out_dir, "inputs.npz")))
out = {}

parallel.init_distributed(f"localhost:{port}", size, rank, device="cpu")
mesh = parallel.make_mesh(device="cpu")
out["mesh_shape"] = np.array(mesh.mesh.shape)
for npar in range(2, size + 2):
    try:
        parallel.make_mesh(node_parallel=npar, device="cpu")
        out[f"node_parallel_{npar}"] = np.array("ok")
    except (ValueError, NotImplementedError) as e:
        out[f"node_parallel_{npar}"] = np.array(type(e).__name__)

cfg = T.Config(**{k[4:]: v.item() for k, v in inp.items()
                  if k.startswith("cfg_")})
arrays = {k: inp[k] for k in ("child_idx", "centre", "depth", "degree",
                              "coeffs")}
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
cg_tree = T.from_numpy({k: inp[f"cg_{k}"] for k in arrays},
                       int(inp["cg_n_nodes"]), int(inp["cg_deg_used"]),
                       int(inp["cg_depth_used"]), cg_cfg, device="cpu")
cont = TC.enforce_continuity(cg_tree, mesh=mesh)
out["cg_coeffs"] = cont.coeffs.numpy()

# --- inverse rendering with the rays sharded --------------------------------
inv_cfg = T.Config(target_error=1e-6, continuity=False, max_depth=4,
                   max_degree=3)
ti, to = (T.from_numpy({k: inp[f"{name}_{k}"] for k in arrays},
                       int(inp[f"{name}_n_nodes"]),
                       int(inp[f"{name}_deg_used"]),
                       int(inp[f"{name}_depth_used"]), inv_cfg, device="cpu")
          for name in ("inv_init", "inv_target"))
tt, th = T.inverse.render_targets(to, inp["inv_o"], inp["inv_d"], t_max=5.0)
inv = T.inverse.fit_to_depth(ti, inp["inv_o"], inp["inv_d"], tt, th,
                             n_steps=2, lr=1e-3, t_max=5.0,
                             ray_chunk=int(inp["inv_chunk"]), mesh=mesh)
out["inv_losses"] = inv.losses.numpy()
out["inv_coeffs"] = inv.tree.coeffs.numpy()

np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
parallel.dist.destroy_process_group()
print(f"RANK-OK {rank}", flush=True)
