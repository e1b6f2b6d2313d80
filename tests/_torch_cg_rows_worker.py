"""One rank of the port's row-sharded continuity CG on the CPU, for
tests/test_torch_cg_rows.py.

Run as:  python tests/_torch_cg_rows_worker.py <rank> <size> <port> <dir>

Joins a gloo group of ``size`` ranks at localhost:<port>, reads the tree the
test wrote to <dir>/tree.npz (built by hpsdf_tpu), runs
``enforce_continuity(mesh=make_mesh())`` on it, which on CPU tensors runs
the plain versions (``continuity._cg_rows_plain``), and writes the
coefficients and the solve's iteration count and residual to
<dir>/rank<rank>.npz. Imports neither jax nor hpsdf_tpu.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import hpsdf_tpu_torch as T                              # noqa: E402
from hpsdf_tpu_torch import continuity as TC             # noqa: E402
from hpsdf_tpu_torch import parallel                     # noqa: E402

ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


def main(rank, size, port, out_dir):
    inp = np.load(os.path.join(out_dir, "tree.npz"))
    parallel.init_distributed(f"localhost:{port}", size, rank, device="cpu")
    cfg = T.Config(**{k[4:]: v.item() for k, v in inp.items()
                      if k.startswith("cfg_")})
    tree = T.from_numpy({k: inp[k] for k in ARRAYS}, int(inp["n_nodes"]),
                        int(inp["deg_used"]), int(inp["depth_used"]), cfg,
                        device="cpu")
    solves = []
    solve = TC.cg_solve_rows

    def recorded(*args):
        solves.append(solve(*args))
        return solves[-1]

    TC.cg_solve_rows = recorded
    out = TC.enforce_continuity(tree, mesh=parallel.make_mesh(device="cpu"))
    TC.cg_solve_rows = solve
    _, iters, resid = solves[0]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             coeffs=out.coeffs.numpy(), iterations=iters, residual=resid)
    parallel.dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
