"""Times chip_smoke.py's backward phases in two checkouts on one card,
interleaved A, B, B, A, each run a process of its own: a difference between
two commits then shows beside the card's drift between runs of one.

    python3 chip_compare.py A_DIR B_DIR [--out FILE]

Each run, from its checkout, builds (or reuses) that checkout's kernels,
fits the slice tree (icosphere(0.3, 5) through mesh_sdf, SLICE_CONFIG),
sets up inverse rendering as chip_smoke.py does, and runs its [grad] phase
(K7, G's backward, K8) and its [k13] phase (K13's points, loss and VJP),
whose lines it prints with the run's label. The builds of both checkouts
run first, together. Needs one card; imports no JAX.
"""

import os
import subprocess
import sys
import time

CHILD = r"""
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import _kernels
from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen, mesh_sdf
_kernels.load(); _kernels.load_check()
if sys.argv[1] == "build":
    sys.exit(0)
dev = torch.device("cuda", 0)
smi = cs.nvidia_smi()
mesh = build_mesh(*gen.icosphere(0.3, 5))
cfg = T.Config(**cs.SLICE_CONFIG)
tree = T.build_octree(cfg, mesh_sdf(mesh, build_bvh(mesh, device=dev)),
                      device=dev)
s_inv, _ = cs.inverse_setup(cfg, dev, (cs.INV_SIZE,
                                       (cs.INV_SMALL, cs.INV_SMALL)))
cs.phase_grad(T.pack_tree(tree), tree, s_inv, smi)
cs.check_k13(s_inv, smi)
"""


def run(label, cwd, what, out):
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", CHILD, what], cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    text = "".join(f"[{label}] {line}\n" for line in
                   (p.stdout + p.stderr).splitlines())
    out.write(text + f"[{label}] {what} exit {p.returncode}, "
              f"{time.perf_counter() - t0:.1f} s\n")
    out.flush()
    if p.returncode != 0:
        sys.stdout.write(text[-4000:])
        raise SystemExit(f"{label} ({cwd}) {what} failed")


def main(argv):
    dirs = [os.path.abspath(d) for d in argv[:2]]
    out_path = argv[argv.index("--out") + 1] if "--out" in argv else None
    out = open(out_path, "w") if out_path else sys.stdout
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(run, k, d, "build", out)
                    for k, d in zip("AB", dirs)]:
            job.result()
    for k in "ABBA":
        run(k, dirs["AB".index(k)], "time", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
