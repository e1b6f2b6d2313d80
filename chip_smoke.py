#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and drives its main path once at
full width: icosphere(0.3, 5) (20,480 triangles) -> half-edges and
pseudo-normals -> packed rows on the card -> mesh F (kernel P1) -> an
hp-adaptive f64 fit at the headline config of bench.py (target 1e-7,
depth 5, degree 6) -> query / query_with_gradient on 2^20 points (kernel
K1) -> save / load. Each kernel is also held against its plain torch
version on the card and timed beside it.

Phases, one line each: device, build, P1 vs plain, the slice, K1 vs plain,
times; then one JSON line with the kernels, the card's name and power limit
as nvidia-smi prints them, and the final JSON line
{"ok": true, "device": {...}}. Any failed check raises and the exit code is
non-zero. Without a CUDA device it exits 1 and prints no result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TRI_ATOL, TRI_RTOL = 1e-7, 1e-5     # P1 best_d2 against the plain scan
SIGNED_ATOL = 1e-6                  # signed distance from either index
K1_VAL_ATOL, K1_GRAD_ATOL = 1e-12, 1e-10
FIT_ATOL = 0.01                     # query vs |p| - 0.3 on the slice
P1_SIZES = (65536, 1, 7, 1_000_003)
N_QUERY = 1 << 20


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps, warmup=1):
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def phase_p1(rows, sizes, seed=0):
    """P1 against its plain version on the card. Returns max |d2 diff|."""
    from hpsdf_tpu_torch.mesh import (closest_tri_tiles,
                                      closest_tri_tiles_plain)
    from hpsdf_tpu_torch.mesh.sdf import _signed_from_best
    from hpsdf_tpu_torch.mesh.tiles_sdf import _closest_d2

    rng = np.random.default_rng(seed)
    worst = 0.0
    for n in sizes:
        pts = torch.as_tensor(
            rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            device=rows.device)
        d2_k, idx_k = closest_tri_tiles(rows, pts)
        d2_p, idx_p = closest_tri_tiles_plain(rows, pts)
        check(d2_k.shape == (n,) and idx_k.dtype == torch.int32,
              f"P1 output shape/dtype at n={n}")
        check(bool(torch.isfinite(d2_k).all()), f"P1 d2 finite at n={n}")
        err = (d2_k - d2_p).abs()
        check(bool((err <= TRI_ATOL + TRI_RTOL * d2_p.abs()).all()),
              f"P1 d2 vs plain at n={n}: max {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        # where the index differs, the kernel's triangle must reach the
        # plain best d2: the two are tied within tolerance, so the plain
        # scan's best and second best differ by no more than that
        diff = torch.nonzero(idx_k != idx_p).flatten()
        if diff.numel():
            p = pts[diff]
            t = rows[idx_k[diff].long(), :9].T
            d2_own = _closest_d2(p[:, 0], p[:, 1], p[:, 2], *t)
            gap = (d2_own - d2_p[diff]).abs()
            check(bool((gap <= TRI_ATOL + TRI_RTOL * d2_p[diff]).all()),
                  f"P1 index at n={n}: {diff.numel()} differ, worst d2 gap "
                  f"{float(gap.max()):.3e}")
        s_k = _signed_from_best(rows, idx_k, pts)
        s_p = _signed_from_best(rows, idx_p, pts)
        s_err = float((s_k - s_p).abs().max())
        check(s_err <= SIGNED_ATOL, f"P1 signed distance at n={n}: {s_err}")
        print(f"[p1] n={n}: max|d2 - plain| {float(err.max()):.3e}, "
              f"{diff.numel()} tied indices differ, max|signed - plain| "
              f"{s_err:.3e}", flush=True)
    return worst


def phase_slice(mesh, bvh, cfg, n_query, out_path, seed=1):
    """The main path once; returns (tree, launches)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch.mesh import closest_tri_tiles, mesh_sdf
    from hpsdf_tpu_torch.query import query_kernel

    dev = bvh.tri_rows.device
    F = mesh_sdf(mesh, bvh)                       # method "auto"
    check(F.method == "tiles", f"mesh_sdf auto picked {F.method}")
    samples = [0]

    def F_counted(pts):
        samples[0] += pts.shape[0]
        return F(pts)

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.4, 0.4, (n_query, 3)), device=dev)

    closest_tri_tiles.launches = 0
    query_kernel.launches = 0
    sync()
    t0 = time.perf_counter()
    tree = T.build_octree(cfg, F_counted, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals = T.query(tree, pts)
    sync()
    query_s = time.perf_counter() - t0
    vg, grads = T.query_with_gradient(tree, pts)
    sync()
    T.save(tree, out_path)
    back = T.load(out_path, device=dev)
    launches = {"closest_tri": closest_tri_tiles.launches,
                "query": query_kernel.launches}

    check(launches["closest_tri"] > 0, "P1 never launched on the main path")
    check(launches["query"] > 0, "K1 never launched on the main path")
    check(vals.shape == (n_query,) and bool(torch.isfinite(vals).all()),
          "query values finite")
    vg_err = float((vals - vg).abs().max())
    check(vg_err <= K1_VAL_ATOL, f"query vs query_with_gradient: {vg_err}")
    check(grads.shape == (n_query, 3) and bool(torch.isfinite(grads).all()),
          "gradients finite")
    r = torch.linalg.norm(pts, dim=-1)
    fit_err = float((vals - (r - 0.3)).abs().max())
    check(fit_err < FIT_ATOL, f"max|query - (|p| - 0.3)| = {fit_err}")
    away = r > 0.05
    dots = (grads[away] * (pts[away] / r[away, None])).sum(-1)
    dot_q01 = float(torch.quantile(dots[:100_000], 0.01))
    check(dot_q01 > 0.95, f"gradient vs radial, 1% quantile {dot_q01}")
    for k in ("child_idx", "centre", "depth", "degree", "coeffs"):
        check(bool(torch.equal(getattr(back, k), getattr(tree, k))),
              f"save/load {k} bit-exact")
    # the npz schema keeps no fit_dtype: a loaded tree reads the default
    check((back.n_nodes, back.deg_used, back.depth_used, back.config)
          == (tree.n_nodes, tree.deg_used, tree.depth_used,
              dataclasses.replace(tree.config, fit_dtype="float64")),
          "save/load metadata")
    print(f"[slice] nodes {tree.n_nodes}, leaves {tree.num_leaves()}, "
          f"deg_used {tree.deg_used}, depth_used {tree.depth_used}, "
          f"F samples {samples[0]}, build {build_s:.3f} s, query "
          f"{n_query / query_s / 1e6:.2f} Mq/s (first call), "
          f"max|query - (|p| - 0.3)| {fit_err:.3e}, gradient . radial 1% "
          f"quantile {dot_q01:.6f}, save/load bit-exact, launches "
          f"{launches}", flush=True)
    return tree, launches


def phase_k1(tree, n, seed=2):
    """K1 against its plain version; points include some outside the root.
    Returns (max value diff, max gradient diff)."""
    from hpsdf_tpu_torch.query import (OUTSIDE_VALUE, query_kernel,
                                       query_plain,
                                       query_with_gradient_plain)

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.6, 0.6, (n, 3)),
                          device=tree.device)
    v_k = query_kernel(tree, pts, False)
    v_p = query_plain(tree, pts)
    outside = v_p == OUTSIDE_VALUE
    check(bool(outside.any()) and not bool(outside.all()),
          "K1 test points straddle the root")
    check(bool(torch.equal(v_k == OUTSIDE_VALUE, outside)),
          "K1 sentinel positions")
    v_err = float((v_k - v_p).abs().max())
    check(v_err <= K1_VAL_ATOL, f"K1 value vs plain: {v_err}")
    c_k = query_kernel(tree, pts, False, outside_value_max=False)
    c_p = query_plain(tree, pts, outside_value_max=False)
    c_err = float((c_k - c_p).abs().max())
    check(c_err <= K1_VAL_ATOL, f"K1 clamped value vs plain: {c_err}")
    gv_k, g_k = query_kernel(tree, pts, True)
    gv_p, g_p = query_with_gradient_plain(tree, pts)
    gv_err = float((gv_k - gv_p).abs().max())
    g_err = float((g_k - g_p).abs().max())
    check(gv_err <= K1_VAL_ATOL, f"K1 grad-path value vs plain: {gv_err}")
    check(g_err <= K1_GRAD_ATOL, f"K1 unit gradient vs plain: {g_err}")
    print(f"[k1] n={n} ({int(outside.sum())} outside): max|value - plain| "
          f"{v_err:.3e}, clamped {c_err:.3e}, with gradient {gv_err:.3e}, "
          f"max|unit grad - plain| {g_err:.3e}", flush=True)
    return max(v_err, c_err, gv_err), g_err


def phase_times(rows, tree, n, seed=3):
    """Each kernel beside its plain version at the main path's shapes."""
    from hpsdf_tpu_torch.build import BLOCK_PTS
    from hpsdf_tpu_torch.mesh import (closest_tri_tiles,
                                      closest_tri_tiles_plain)
    from hpsdf_tpu_torch.query import (query_kernel, query_plain,
                                       query_with_gradient_plain)

    rng = np.random.default_rng(seed)
    fpts = torch.as_tensor(
        rng.uniform(-0.5, 0.5, (BLOCK_PTS, 3)).astype(np.float32),
        device=rows.device)
    qpts = torch.as_tensor(rng.uniform(-0.4, 0.4, (n, 3)),
                           device=tree.device)
    counts = (closest_tri_tiles.launches, query_kernel.launches)
    t = {
        "p1_plain": time_ms(lambda: closest_tri_tiles_plain(rows, fpts), 1,
                            warmup=0),
        "p1": time_ms(lambda: closest_tri_tiles(rows, fpts), 5),
        "k1_plain": time_ms(lambda: query_plain(tree, qpts), 5),
        "k1": time_ms(lambda: query_kernel(tree, qpts, False), 20),
        "k1g_plain": time_ms(lambda: query_with_gradient_plain(tree, qpts),
                             5),
        "k1g": time_ms(lambda: query_kernel(tree, qpts, True), 20),
    }
    # timing launches are not main-path launches
    closest_tri_tiles.launches, query_kernel.launches = counts
    return t


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from hpsdf_tpu_torch import Config, _kernels
    from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen

    # --- 1. device ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda", 0)
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    print(f"[build] {len(_kernels.sources())} sources -> "
          f"{os.path.relpath(_kernels.library_path())} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # --- 3. P1 against its plain version -----------------------------------
    v, f = gen.icosphere(0.3, 5)
    mesh = build_mesh(v, f)
    bvh = build_bvh(mesh, device=dev)
    print(f"[mesh] {mesh.n_faces} triangles, {bvh.n_leaves} packed rows",
          flush=True)
    p1_err = phase_p1(bvh.tri_rows, P1_SIZES)

    # --- 4. the slice ------------------------------------------------------
    cfg = Config(target_error=1e-7, max_depth=5, max_degree=6,
                 continuity=False, fit_dtype="compensated")
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    tree, launches = phase_slice(
        mesh, bvh, cfg, N_QUERY,
        os.path.join(_kernels.BUILD_DIR, "chip_smoke_tree.npz"))

    # --- 5. K1 against its plain version -----------------------------------
    k1_err, k1g_err = phase_k1(tree, N_QUERY)

    # --- 6. times ----------------------------------------------------------
    t = phase_times(bvh.tri_rows, tree, N_QUERY)
    print(f"[times] {smi} | P1 closest_tri at ({bvh.n_leaves} rows x "
          f"2^20 pts): kernel {t['p1']:.3f} ms, plain {t['p1_plain']:.3f} ms"
          f" | K1 query at 2^20 pts: kernel {t['k1']:.3f} ms, plain "
          f"{t['k1_plain']:.3f} ms | K1 query_with_gradient: kernel "
          f"{t['k1g']:.3f} ms, plain {t['k1g_plain']:.3f} ms", flush=True)

    kernels = [
        {"name": "closest_tri", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/closest_tri.cu",
         "replaces": "hpsdf_tpu/mesh/pallas_sdf.py:187",
         "launches": launches["closest_tri"], "max_abs_err": p1_err,
         "ms": t["p1"], "plain_ms": t["p1_plain"]},
        {"name": "query", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/query.cu",
         "replaces": "hpsdf_tpu/query.py:70",
         "launches": launches["query"], "max_abs_err": k1_err,
         "ms": t["k1"], "plain_ms": t["k1_plain"],
         "grad_max_abs_err": k1g_err, "grad_ms": t["k1g"],
         "grad_plain_ms": t["k1g_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
