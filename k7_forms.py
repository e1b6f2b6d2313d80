"""Time K7's development forms (``hpsdf_tpu_torch/csrc/dev/k7_forms.cu``)
beside the shipped kernel (``csrc/packed_grad.cu``) on the card: the
shipped cooperative kernel at 4, 6 (its setting) and 8 blocks a
multiprocessor, block-level grouping (two fills and one plain launch) and
the shipped phases in three plain launches, at one 1080p inverse chunk's
band points (forms 0 and 1), its 7n points (form 0) and 2^20 uniform
points in the inverse tree's root (forms 0 and 1). Each form is held to
autograd of the plain version and to the shipped kernel within
chip_smoke.GRAD_RTOL32, its operations on the card a call counted, and it
is timed in CUDA graphs in two rounds, the second in the reverse order.
Prints one line a shape and form, then all of it as one JSON line.

    python3 k7_forms.py        # one card
"""

import json
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from hpsdf_tpu_torch import _kernels

_P, _I64, _I32, _F32 = _kernels._P, _kernels._I64, _kernels._I32, \
    _kernels._F32
# the C signature of the development library's entry point
SIGNATURES = {"hpsdf_dev_k7": (_I32, _I32, _P, _P, _I32, _I32, _I32, _I32,
                               _I32, _P, _I64, *(_F32,) * 6, _P, _I32, _P,
                               _P, _P, _P)}
# (label, variant, blocks a multiprocessor); variant None: the wrapper
VARIANTS = (("shipped (cooperative, 6 blocks an SM)", None, 6),
            ("cooperative, 4 blocks an SM", 0, 4),
            ("cooperative, 8 blocks an SM", 0, 8),
            ("block-level grouping, 2 fills + 1 launch", 1, 0),
            ("three plain launches", 2, 0))


def main():
    if not torch.cuda.is_available():
        print("k7_forms: needs a CUDA device", file=sys.stderr)
        return 1
    from hpsdf_tpu_torch import Config
    from hpsdf_tpu_torch import accel as A

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    t0 = time.perf_counter()
    main_lib = _kernels.load()
    lib = _kernels._load("dev", SIGNATURES)
    print(f"[build] {time.perf_counter() - t0:.2f} s | {smi}", flush=True)

    cfg = Config(target_error=1e-7, max_depth=5, max_degree=6,
                 continuity=False)
    s = cs.inverse_setup(cfg, dev, [cs.INV_SIZE])[0]
    chunk = 1 << 16
    mid = s["o"].shape[0] // 2 // chunk * chunk
    rays = slice(mid, mid + chunk)
    pt = A.pack_tree(s["init"])
    rng = np.random.default_rng(11)
    c = np.asarray(pt.root_centre)
    half = 0.5 * np.asarray(pt.root_sizes)
    uni = torch.as_tensor(rng.uniform(c - 1.05 * half, c + 1.05 * half,
                                      (cs.N_QUERY, 3)).astype(np.float32),
                          device=dev)
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    print(f"[tree] degree {pt.deg_used}, width {pt.width}, grid depth "
          f"{pt.grid_depth}, extra rounds {pt.extra_rounds}, "
          f"{pt.rows.shape[0]} node rows", flush=True)

    def dev_call(variant, per_sm, pts, cot, form, scratch):
        fill = torch.zeros_like if variant == 1 else torch.empty_like
        d_rows, d_grid = fill(pt.rows), fill(pt.grid)
        rc_ = lib.hpsdf_dev_k7(
            variant, per_sm, pt.grid.data_ptr(), pt.rows.data_ptr(),
            pt.width, pt.deg_used, pt.grid_depth, pt.extra_rounds,
            pt.rows.shape[0], pts.data_ptr(), pts.shape[0], *map(float, rc),
            *map(float, inv), cot.data_ptr(), form, scratch.data_ptr(),
            d_grid.data_ptr(), d_rows.data_ptr(), _kernels.stream_of(pts))
        _kernels.check(main_lib, rc_, f"k7 development form {variant}")
        return d_rows, d_grid

    out = {"device": smi, "shapes": {}}
    for label, pts, forms in (
            ("inverse chunk band points", cs.band_points(s, rays), (0, 1)),
            ("inverse chunk 7n points", cs.inverse_points(s, rays), (0,)),
            ("2^20 uniform, inverse tree", uni, (0, 1))):
        n = pts.shape[0]
        for form in forms:
            cot = torch.as_tensor(rng.standard_normal(
                (n,) if form == 0 else (n, 3)), dtype=torch.float32,
                device=dev)
            size = main_lib.hpsdf_packed_grad_scratch(n, pt.grid_depth,
                                                      pt.rows.shape[0], form)
            scratch = {0: torch.empty(size, dtype=torch.uint8, device=dev),
                       1: torch.empty(16, dtype=torch.uint8, device=dev),
                       2: torch.zeros(size + 4, dtype=torch.uint8,
                                      device=dev)}
            plain = (A.values_at_vjp_plain, A.point_gradient_vjp_plain)[form]
            want = plain(pt, pts, cot)
            shipped = A.packed_grad_kernel(pt, pts, cot, form)
            fns, row = {}, {}
            for name, variant, per_sm in VARIANTS:
                if variant is None:
                    fn = (lambda: A.packed_grad_kernel(pt, pts, cot, form))
                else:
                    fn = (lambda v=variant, p=per_sm: dev_call(
                        v, p, pts, cot, form, scratch[v]))
                got = fn()
                err = max(cs.rel_err(g, w) for g, w in zip(got, want))
                err_s = max(cs.rel_err(g, w) for g, w in zip(got, shipped))
                cs.check(err <= cs.GRAD_RTOL32 and err_s <= cs.GRAD_RTOL32,
                         f"{name}, form {form}, {label}: {err:.3e} against "
                         f"plain, {err_s:.3e} against the shipped kernel")
                fns[name] = fn
                row[name] = {"rel_err": err, "rel_err_shipped": err_s,
                             "ops": cs.device_ops(fn), "ms": []}
            for order in (list(fns), list(fns)[::-1]):
                for name in order:
                    row[name]["ms"].append(cs.graph_ms(fns[name], 10))
            out["shapes"][f"form {form}, {label}"] = row
            print(f"[k7] form {form}, {label} ({n} points) | {smi} | "
                  + "; ".join(f"{k}: {v['ms'][0]:.4f} / {v['ms'][1]:.4f} ms"
                              f", {v['ops']} ops, err {v['rel_err']:.2e}"
                              for k, v in row.items()), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
