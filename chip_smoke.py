#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hpsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and drives its main paths once
at full width, the flow of examples/end_to_end.py:

  * the slice: icosphere(0.3, 5) (20,480 triangles) -> half-edges and
    pseudo-normals -> packed rows on the card -> mesh F (kernel P1, the
    sign on the best triangle K14) -> an hp-adaptive f64 fit at the
    headline config of bench.py (target 1e-7, depth 5, degree 6) -> query /
    query_with_gradient on 2^20 points (kernel K1) -> save / load;
  * the render path on that tree: the CSG carve intersect_sdf(tree,
    -box(0.18)), whose F reads the tree through the packed layout (G for
    the grid, K2 for the values) -> render_image at 512^2 (the march K3,
    normals K5) -> output_function_slice at 512 (K1) -> save / load;
  * the continuity post-process ([continuity]), which Config's default
    asks for: build_octree with continuity=True at bench.py:352-360's fit +
    continuity config (sphere r = 0.301, target 1e-6, depth 5, degree 4)
    and at the 260,604-leaf row of bench.py:578-596 (sphere r = 0.3,
    target 3e-9, depth 7, degree 2), its CG through kernel K9 (the matvec
    on the face operator, with p.Ap) and a persistent launch of K9's and
    K9u's phases (the vector update with r.z and r.r and the new
    direction), CG_CHUNK iterations a launch (csrc/continuity.cu);
  * the mesh at the reference's scale ([mesh scale]): bumpy_sphere(0.3, 8)
    (1,310,720 triangles) -> .obj -> the native host build -> a fit
    through mesh_sdf's default, which takes the hybrid prune (kernel K10)
    above 65,536 rows, and signed_distance_hybrid; the BVH walk (kernel
    K11) through mesh_sdf(method="bvh") and signed_distance.

The build's seconds outside F are split (split_again, split_build,
fit_split: PhaseTimer phases around the port's own build._fit,
build.fit_points, build._fit_impl and build.pack, and F inside each fit)
into F, the projection (K6's second launch, csrc/fit.cu), point generation
(K6's first launch) and copies, packing and the host topology, in [slice]
and [render]'s carve, from a second build run after the first,
uninstrumented one whose seconds are printed as the build's. Every fit
split (the slice, the carve, both continuity configs, the mesh at scale)
is taken with K6 and then with its plain versions swapped in (k6_split:
K6's launches equal the fit's chunks, the trees' node counts and depth
and degree histograms equal). [k6] holds K6 to its plain versions and to
the kernels they replaced (csrc/check/fit_reference.cu): the points bit
for bit at the slice fit's largest chunk and at degrees 2..11, the
projection on that chunk's own F values and on seeded chunks at degrees
2..11 x kept widths x the three weightings in f64 and f32 (K6_RTOL; bit
for bit the replaced kernel's where a cell takes one block), shows that
three wrong rows fail the check, holds each cell's row bit for bit across
chunkings (k6_invariance, with a chunk-following split that must fail it),
and times both launches in CUDA graphs, warm and cold (F flushed from L2;
the points into fresh memory), beside the replaced kernels, the plain
versions, the three einsums and the bounds, at K6_TIME_DEGREES' full
chunks, the slice fit's largest degree-2 and degree-3 chunks and
K6_SMALL's chunks; [k6 ops] counts a chunk's operations on the card.
[cold] runs this script twice more as a child (--cold k6, --cold plain)
that splits a fresh process's first slice build by phase.
[mesh] times build_mesh and build_bvh. [continuity] splits the
post-process into face pairs, the face operator, the cross-depth blocks,
upload and CG (and checks that no same-depth entry was assembled), holds
the field to |p| - r, the jump energy c.Mc and the sampled face jumps to
the fit without continuity, K9 to the plain matvec on the reference's COO
and to its own plain version, K9u to its plain version (1e-13 of the
largest entry), the persistent launch with y in a buffer to it with y in
shared memory bit for bit, and the kernels' solve to the plain solve on
the COO (the same count and x within 1e-9, or a count one apart with both
recomputed residuals meeting the stopping rule) and to itself bit for bit,
and times K9, an iteration of the persistent launch and K9u once in CUDA
graphs beside their bounds, PR 10's CSR forms, the plain versions and
cuSPARSE's CSR matvec on the COO's CSR and on the merged one.

Each kernel is also held against its plain torch version on the card and
timed beside it, K2/K5 and K3 on the slice tree and on the
reference-default tree (bench.py:289-298: sphere r=0.5 at (0.25, 0, 0),
target 1e-10, exponential weighting 3, degree 12 / depth 10 caps), and
both trees are traced at 1024^2 rays. K3 and K5 are held against their
plain versions once more on the carved tree and the 512^2 rays that
render_image traced. K2 is also timed where the main path runs it, on the
carve's largest F batch (the points as_sdf's packed F reads), and K5 on
the render's hit points; K2/K5, K1 and K3 are held against their plain
versions at every basis degree 0..12 on synthetic depth-2 trees (rows of 16
to 464 lanes), K7 and K8 to theirs and K8 to the kernel it replaced, and
the fused mode to modes 0 and 2.

K3 is also held, bit for bit (t, hit, kk), against the kernel it replaced
(csrc/check/march_reference.cu, built here into a library of its own, on no
path of the package), wherever it is checked: a ray's march is a function
of that ray alone, so a redesign may change the schedule and how a row
reaches the registers, and no result. From K3's per-ray counts [k3] prints
what the rays did (steps, relocations that found the row already held, the
SIMT efficiency of 32x1 strips and 8x4 tiles), the bound on that work, and
the serial floor: the longest ray marched alone. K4, the cone prepass, is
held the same way to the kernel it replaced (csrc/check/cone_reference.cu),
t0 bit for bit, on both trees, the boundary view, the render's 512^2 rays
and every degree, and its per-tile rounds (cone_start's with_stats) to its
plain version's; [k4] times both beside K3 with and without K4's starts,
with no round (the reduction alone) and on the longest tile alone, bounds
K4 by the rounds its tiles took and the rows their centre rays reach, and
estimates the marches' instruction issue from the SASS of a round.

P1 is also held against its plain version on the main path's own points
(the largest F batch of the slice fit) and timed there with and without its
tile cull; wherever P1 is checked, its culled scan must equal its dense
scan bit for bit, on the fit's whole batch too. Every kernel's time stands
beside its bound on this card: the operations (P1, f32, on the pairs its
blocks scanned, with the dense pairs beside; K1, f64, beside its bytes) or
the bytes (each input read once, each output written once) over the H100's
published peak (K3: the larger of its bytes and the f32 operations of the
steps its rays took); G's also beside torch.index_select on in-range
indices, which the port never calls. K1, K2/K5 and K3 run for less than a
call through their wrappers costs the host, or not much more, so they are
timed in CUDA graphs; the others by CUDA events around repeated calls. The
build's ptxas report gives K1's, K2/K5's and K3's registers, stack and
spills; K1's and K3's degree-3 and degree-5 instantiations must have no
stack frame and no spills.

The backward kernels ([grad]) are held to autograd of their plain versions
at 2^20 points and at the inverse path's own shapes (one chunk's band
points, the 7n points of its read, its rays, the repack's grid); K7, G's
backward and K8 also to the kernels they replaced (csrc/check/, timed in
the same run), with the operations a call puts on the card; K8's trace
form at every chunk of a 1080p step with the step's own cotangent, timed
chunk by chunk and summed; and the fused mode of K2/K5 (values and raw
gradients in one launch) bit for bit against modes 0 and 2, timed beside
both. [inverse] runs bench.py's 1080p fit_to_depth, profiles a step with
and without the replaced backward kernels (and with the fused read split
again), and holds the kernels' 128^2 losses to the plain versions'.

K14, the sign on the best triangle (csrc/sign.cu), runs inside every mesh
F; [k14] holds it to its plain version (the distance within SIGNED_ATOL,
the sign wherever |d| exceeds it; the points whose sign or feature code
differ counted; two wrong results shown to fail that check) at the slice
fit's largest batch and, in [mesh scale], at 2^20 uniform points on the
1.31M mesh and at the 1.31M fit's largest batch on K10's indices; it
times K14 in CUDA graphs (also with no row read and with one row for
every point) beside its plain version, the sign as it was before K14
(G's gather and the torch cascade), its bound on the lanes it needs and
the 32-byte sectors it touches; both fit splits show the sign's
seconds with K14 and with the old sign swapped in, and G's launches
falling by the sign calls. K13, the inverse chunk's loss terms
(csrc/inverse_terms.cu: the 7n points; the loss forward; its VJP times
the loss's cotangent backward), is held at a 1080p chunk ([k13]): the
points bit for bit, the loss deterministic and within K13_LOSS_RTOL of
the plain version, the VJP at go 1 and at a seeded go bit for bit the
replaced kernel's cotangents (csrc/check/inverse_terms_reference.cu)
times go, three wrong VJPs shown to fail that check, the cotangents (each
times its normaliser) within K13_COT_RTOL / K13_COT_ATOL of autograd of
the formula fit_to_depth ran before it (formula_terms) and within
K13_PLAIN_RTOL of the plain version's; the loss, the VJP and the pair
timed in CUDA graphs beside their bounds, the pair in turns with the
replaced launch and its three scalings, with the operations a chunk puts
on the card (and a sign call, after it); [inverse] times a step with it
and with the formula swapped in, and counts a step's operations on the
card with it and with the replaced terms (two fewer a chunk).

[mesh scale] runs the mesh -> SDF path at the reference's scale
(bench.py:416-517): bumpy_sphere(0.3, 8), 1,310,720 triangles, written to
.obj, loaded, half-edged and built into a BVH through the native host
library (each stage's path is recorded and must be native), then kernel
K10, the hybrid prune (csrc/hybrid.cu), held to its plain version at
bench.py's 10,240 uniform points, at the escalation widths, at 2^16
points near the surface (inside many boxes: the tie-heavy case) and at
the fit's largest batch (d2 within P1's tolerance, the bound bit for bit,
a differing index only on a tie), signed_distance_hybrid(atol=0) held to
P1's exact signed distances with the share of points each escalation
took, a tree fitted through mesh_sdf's default (which picks K10 above
AUTO_TILES_MAX rows) at the slice's config, held to P1 at 2^16 points near
the surface and split by phase in a second build (MESH_PHASES: F, K10's
launches and the sign inside it, the projection, points and copies, the
host topology); kernel K11, the BVH walk (csrc/bvh_walk.cu), on
icosphere(0.3, 5) exact against P1 and at mesh_sdf's default cap against
its plain version (visit counts equal on K11_VISITS_SAME of the walks), on
heaps of depth 4, 5, 7 and 11 (K11_HEAPS) and at 1.31M at the cap against
its plain version, and everywhere against the kernel it replaced
(csrc/check/bvh_walk_reference.cu) bit for bit; K10 split by stage (its
source built alone with HPSDF_K10_STAGE 1 and 2: up to the cluster and the
subcluster selection), and at the fit's largest batch in CUDA graphs, the
smaller of two turns; its bound on its own work (the kernel's per-point
counts) and on the plain version's; K10 and P1 at 32k (also at the slice
fit's largest batch), 82k and 1.31M triangles (the crossover), and K11 and
the kernel it replaced in CUDA graphs beside its bound and plain version,
a line a shape (32k capped and exact, 1.31M capped, the longest walk
alone).

[sharding] drives the port's sharded paths (hpsdf_tpu_torch.parallel) at
one NCCL rank on the card, at the main path's sizes, with the counts set
to 0 before and read after: shard_query at 2^20 points and shard_trace at
1024^2 rays through K4 and K3 on the slice tree, bit for bit the
one-device calls; build_octree(fit_mesh=) through the slice's mesh F, bit
for bit the slice tree; enforce_continuity(mesh=), the row-sharded CG (K9
in its partial mode and K9u split in two launches, the collectives
between them), on both continuity trees within 1e-10 of [continuity]'s
solves and their counts within one; fit_to_depth(mesh=) for 3 steps at
1080p, losses within 1e-4 of the one-device run. It holds K9's partial
mode and K9u's two launches to their plain versions at the 260k row
(the partial mode at one rank also to K9 bit for bit) and times them in
CUDA graphs beside their bounds, an iteration of the sharded CG (in a
CUDA graph and as the solve enqueues it) and the sharded reads' host
cost over the unsharded ones. It holds the node axis's kernel modes in
one process with no collective, on bench.py:626-668's complete depth-7
octree (2,396,752 rows, degree 2) at 2^20 uniform points split into 1, 2
and 3 blocks (complete_tree, phase_node_modes): K1's node-range descent
rounds against their plain versions exactly, the summed leaves against
the plain descent, its leaf evaluation against its plain version and the
summed query against K1 within K1_VAL_ATOL (bit for bit or not, printed),
K8's node-range mode against its plain version and, concatenated, its
query form within GRAD_RTOL64; times them at one block in CUDA graphs
(each round, the leaf, K8's mode) beside K1's query and K8's query form,
their plain versions and bounds. Then two gloo ranks on the one card, in
processes of their own (NCCL refuses two ranks on one device), repeat
the checks at small sizes, with the partial modes on each rank's real
row block, and run the node axis on make_mesh(node_parallel=2), a (1, 2)
mesh: the node-sharded shard_query of the complete tree within
K1_VAL_ATOL of query, each rank's rows and bytes beside the replicated
bytes, its collectives (depth_used + 1 all-reduces of the points' size
over the node axis, one all-gather over the batch axis, none of node
rows), its host ms beside the batch axis's shard_query, and two
node-sharded train steps on the slice tree (the loss falls, within 1e-10
of the one-device step's, coefficients within 1e-12); their counts give
the node-range modes' launches.

Phases, one line each: device, build, ptxas, mesh, P1 vs plain, the slice,
P1 at the fit batch, K14 at the fit batch, K6 (checks, invariance, the
launch, a line a timed chunk, the other degrees), the cold builds (a
line each), K1 vs plain, times, G vs plain, the reference-default
fit, K2/K5 vs plain, K3 vs plain (three lines a tree: checks and rays,
times and bound, serial floor), K4, the render path, K2/K5 at the main
path's shapes, the degrees, the backward kernels, inverse rendering, the
continuity post-process (three lines a size: checks, the run and its
split, times), the mesh at scale (K10, K11), the sharded paths (one
rank's checks, the row modes and times at each continuity size, the
node-range modes, the reads' host cost, two ranks, the node axis), each
phase's seconds; then one JSON line with the kernels
(K2/K5's launches also split into values and normals), the fit splits,
the continuity runs and the sharded runs, the card's name and power limit
as nvidia-smi prints them, and the final JSON line
{"ok": true, "device": {...}}. Any failed check raises and the exit code is
non-zero. Without a CUDA device it exits 1 and prints no result.
"""

import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import socket
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TRI_ATOL, TRI_RTOL = 1e-7, 1e-5     # P1 best_d2 against the plain scan
SIGNED_ATOL = 1e-6                  # signed distance from either index
K1_VAL_ATOL, K1_GRAD_ATOL = 1e-12, 1e-10
FIT_ATOL = 0.01                     # query vs |p| - 0.3 on the slice
# the slice's fit: bench.py:69-74's headline config
SLICE_CONFIG = dict(target_error=1e-7, max_depth=5, max_degree=6,
                    continuity=False, fit_dtype="compensated")
P1_SIZES = (65536, 1, 7, 1_000_003)
N_FIT_CHECK = 65536                 # P1 vs plain on the fit's own points
# roofline of one H100 SXM (NVIDIA's data sheet, at 700 W): f32 and f64
# outside the tensor cores, and HBM3
F32_PEAK, F64_PEAK, HBM_RATE = 67e12, 34e12, 3.35e12
P1_OPS_PER_PAIR = 50                # f32 operations (csrc/closest_tri.cu)
N_QUERY = 1 << 20
G_TABLE = (4681, 32)                # experiments/gather_probe.py:54-56
N_GATHER = 1 << 20
K2_ATOL = 1e-5                      # values, on v / max(1, |v|)
NORMAL_DOT = 1.0 - 1e-5             # K5 normal . plain normal
HIT_AGREE = 0.995                   # K3 hit masks equal on this share
T_ATOL = 5e-4                       # K3 t on common hits
SPHERE_T_ATOL = 0.01                # hit radius vs the analytic sphere
CSG_TOL = 0.05                      # carved tree vs the analytic carve
RAYS_SIDE = 1024                    # bench.py:53
T_MAX = 5.0                         # bench.py:56
CARVE_HALF = 0.18                   # examples/end_to_end.py:65-72
K4_T0_ATOL, K4_T0_AGREE = 1e-4, 0.999   # K4's t0 vs plain, share of rays
# K4 + K3 against the plain march without a cone: no start may pass a hit
# of the plain march (the cone's guarantee), and K4 + K3 must give what the
# plain cone and the plain march from its starts give (K3's standard). A
# start still moves a ray's samples: a ray that grazes the surface can then
# be hit or missed, and on a field that is not quite metric (a carve's fit
# near its edges) a ray can stop on another crossing. Such rays may be this
# share of all: above the most a sound cone changed on each view (the 1024^2
# views: 6 of 1,048,576 rays; the carved tree's 512^2: 137 of 262,144), and
# below what a cone that certifies only its centre ray changes (PERF.md)
K4_CHANGED_SHARE, K4_CHANGED_SHARE_CARVE = 1e-4, 2e-3
K4_OPS_PER_RAY = 30                 # f32 operations a ray of K4's reduction
BOUNDARY_RADIUS = 0.499             # ADVICE.md's sphere touching the root
BOUNDARY_EYE = (0.6, 0.0, -1.5)     # a view where the reference drops hits
# the backward kernels against autograd of the plain versions: atomics add
# in another order than the plain sums, so errors are relative to the
# largest entry (a row sums up to thousands of f32 terms)
GRAD_RTOL32, GRAD_RTOL64 = 1e-4, 1e-10
# the operations a call of K7 and of G's backward may put on the card (the
# kernels they replaced: a launch and two zero-fills, a launch and one)
K7_LAUNCHES, G_BWD_LAUNCHES = 3, 2
# and of K8: the output's memset and the launch
K8_LAUNCHES = 2
# the largest condition number of a ray's dfdt at which the trace's VJP is
# held to its plain version on the synthetic trees (trace_well_posed): an
# f32 weight then differs by ~1e-5 at most between orders of summation
TRACE_COND_MAX = 100.0
INV_SIZE = (1920, 1080)             # bench.py:734-767: 1080p rays
INV_STEPS = 5
INV_SMALL = 128                     # the kernels-against-plain run's side
INV_LOSS_RTOL = 1e-3
K13_LOSS_RTOL = 1e-5                # K13's loss against its plain version
# its cotangents against autograd of the formula, each cotangent times its
# normaliser (surf_n for df and dg, dn for dt: the loss's units before the
# terms are averaged over the rays)
K13_COT_RTOL, K13_COT_ATOL = 1e-6, 1e-7
# and against its plain version, which rounds as it does: elementwise and
# relative to the tensor's largest entry
K13_PLAIN_RTOL = 1e-6
# the operations on the card a chunk's points and terms (forward and
# backward) may take, and a sign call: the launches themselves (the terms:
# the loss forward, the VJP backward, which scales by the loss's cotangent
# itself)
K13_POINT_LAUNCHES, K13_TERM_LAUNCHES, K14_LAUNCHES = 1, 2, 1
# the operations on the card of a 1080p inverse step with K13's terms as
# they were before their redesign (a launch forward, three torch scalings
# backward), as an H100 run of this script counted them (796 with the
# optimizer step's user-annotation span, which device_ops leaves out); the
# redesign cuts 2 a chunk, which [inverse] checks against the replaced
# terms in the same run
K13_REPLACED_STEP_OPS = 795
# K6 against its plain version: each coefficient within K6_RTOL of its
# cell's largest |c| (the einsums and the kernel sum in other orders); each
# err within 40 K6_RTOL sqrt(err) max|c| + 10 K6_RTOL err, which follows from
# the coefficients' tolerance over at most 78 top-degree terms (and covers
# the nearness factor's rounding); NaN where the plain version has NaN
K6_RTOL = {torch.float64: 1e-13, torch.float32: 1e-5}
# the nearness strengths of the seeded checks: 1.5 (not an integer) makes
# the polynomial weight NaN where fbar > sqrt 3, as in both packages
K6_STRENGTH = {"NONE": 0.0, "POLYNOMIAL": 1.5, "EXPONENTIAL": 3.0}
K6_TIME_DEGREES = (2, 3, 4, 5, 8, 11)
# csrc/fit.cu's kSplit and kCells: the blocks (a cluster) a cell's i-slabs
# are split over, and the cells a block takes, by degree
K6_SPLIT = {2: 1, 3: 1, 4: 2, 5: 4, 6: 4, 7: 8, 8: 8, 9: 8, 10: 8, 11: 8}
K6_CELLS = {2: 4, 3: 2, **{d: 1 for d in range(4, 12)}}
# the small chunks the reference default's fits take, (degree, cells)
K6_SMALL = ((3, 6), (5, 48), (4, 134), (2, 48))
K6_SHIFT = 3                        # cells before the shifted chunk's
# what [k6] reads between replays to flush L2 (50 MB) of a kernel's inputs
K6_FLUSH_BYTES = 96 << 20
# K6's instantiations in ptxas's report: every degree a fit takes, f64, f32
K6_PTXAS_KEYS = tuple(f"{d}/{t}" for d in range(2, 12)
                      for t in ("f64", "f32"))
# the operations on the card a fit chunk's points and projection may take
K6_LAUNCHES = 2
COLD_TIMEOUT_S = 180                # a cold-build child, start-up included


PHASE_SECONDS = {}


def phase(name, fn, *args):
    """fn(*args), its seconds kept under ``name`` for the [seconds] line."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 3)
    return out


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


def graph_ms(fn, reps):
    """Mean device time of fn() over reps calls captured in one CUDA graph
    and replayed between CUDA events: the kernels' own time, without the
    host's cost of a call through the wrapper (tens of microseconds, more
    than a kernel of a few)."""
    fn()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def check_cull(rows, table, pts, d2_k, idx_k, label):
    """P1's tile cull is exact: the dense scan (the same kernel, cull off)
    gives the culled result bit for bit."""
    from hpsdf_tpu_torch.mesh import tiles_sdf as ts

    d2_d, idx_d = ts._launch(rows, pts, table, cull=False)
    check(bool(torch.equal(d2_k, d2_d)) and bool(torch.equal(idx_k, idx_d)),
          f"P1 culled vs dense scan at {label}: {int((d2_k != d2_d).sum())} "
          f"d2 and {int((idx_k != idx_d).sum())} indices differ")


def check_p1(rows, table, pts, label):
    """P1 against its plain version on the same points: d2 within
    TRI_ATOL + TRI_RTOL d2, a differing index only where it reaches the
    plain best d2, signed distances within SIGNED_ATOL; and the culled scan
    equal to the dense one. Returns max |d2 diff|."""
    from hpsdf_tpu_torch.mesh import (closest_tri_tiles,
                                      closest_tri_tiles_plain)
    from hpsdf_tpu_torch.mesh.sdf import _signed_from_best
    from hpsdf_tpu_torch.mesh.tiles_sdf import _closest_d2

    n = pts.shape[0]
    d2_k, idx_k = closest_tri_tiles(rows, pts, table)
    check_cull(rows, table, pts, d2_k, idx_k, label)
    d2_p, idx_p = closest_tri_tiles_plain(rows, pts)
    check(d2_k.shape == (n,) and idx_k.dtype == torch.int32,
          f"P1 output shape/dtype at {label}")
    check(bool(torch.isfinite(d2_k).all()), f"P1 d2 finite at {label}")
    err = (d2_k - d2_p).abs()
    check(bool((err <= TRI_ATOL + TRI_RTOL * d2_p.abs()).all()),
          f"P1 d2 vs plain at {label}: max {float(err.max()):.3e}")
    # where the index differs, the kernel's triangle must reach the plain
    # best d2: the two are tied within tolerance, so the plain scan's best
    # and second best differ by no more than that
    diff = torch.nonzero(idx_k != idx_p).flatten()
    if diff.numel():
        p = pts[diff]
        t = rows[idx_k[diff].long(), :9].T
        d2_own = _closest_d2(p[:, 0], p[:, 1], p[:, 2], *t)
        gap = (d2_own - d2_p[diff]).abs()
        check(bool((gap <= TRI_ATOL + TRI_RTOL * d2_p[diff]).all()),
              f"P1 index at {label}: {diff.numel()} differ, worst d2 gap "
              f"{float(gap.max()):.3e}")
    s_k = _signed_from_best(rows, idx_k, pts)
    s_p = _signed_from_best(rows, idx_p, pts)
    s_err = float((s_k - s_p).abs().max())
    check(s_err <= SIGNED_ATOL, f"P1 signed distance at {label}: {s_err}")
    print(f"[p1] {label}: max|d2 - plain| {float(err.max()):.3e}, "
          f"{diff.numel()} tied indices differ, max|signed - plain| "
          f"{s_err:.3e}, culled = dense bit for bit", flush=True)
    return float(err.max())


def phase_p1(rows, table, sizes, seed=0):
    """P1 against its plain version on uniform points. Returns max |d2
    diff|."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for n in sizes:
        pts = torch.as_tensor(
            rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
            device=rows.device)
        worst = max(worst, check_p1(rows, table, pts, f"n={n}"))
    return worst


def p1_bounds(table, n_pts):
    """P1's bounds after a launch on n_pts points, at P1_OPS_PER_PAIR f32
    operations a pair over the f32 peak: (the pairs the launch's blocks
    scanned in their full pass, each block's live points times the rows of
    the tiles it visited, from the kernel's per-block counts; the dense
    pairs, every point against every real row), in ms, and the share of
    non-empty tiles the cull skipped."""
    from hpsdf_tpu_torch.mesh import closest_tri_tiles
    from hpsdf_tpu_torch.mesh.tiles_sdf import BLOCK_PTS

    visits = closest_tri_tiles.visits.double().cpu()
    live = torch.full((visits.shape[0],), float(BLOCK_PTS),
                      dtype=torch.float64)
    live[-1] = n_pts - BLOCK_PTS * (visits.shape[0] - 1)
    pairs = float((live * visits[:, 1]).sum())
    dense = n_pts * int(table.n_rows.sum())
    full = int((table.n_rows > 0).sum())
    skipped = 1.0 - float(visits[:, 0].sum()) / (visits.shape[0] * full)
    scale = P1_OPS_PER_PAIR / F32_PEAK * 1e3
    return pairs * scale, dense * scale, skipped


def bytes_ms(*tensors, extra=0):
    """The byte bound: each tensor read or written once, at the HBM rate."""
    n = extra + sum(t.numel() * t.element_size() for t in tensors)
    return n / HBM_RATE * 1e3


def phase_p1_fit(rows, table, fit_pts):
    """P1 at the main path's own points, the largest F batch of the slice
    fit: against its plain version on its first N_FIT_CHECK points, the
    culled scan against the dense one bit for bit on the whole batch, then
    timed on the whole batch with and without the tile cull; the cull's
    share of skipped tiles and the bound on the pairs it scanned from the
    kernel's per-block counts."""
    from hpsdf_tpu_torch.mesh import closest_tri_tiles
    from hpsdf_tpu_torch.mesh import tiles_sdf as ts

    pts = fit_pts.to(torch.float32)
    count = closest_tri_tiles.launches
    err = check_p1(rows, table, pts[:N_FIT_CHECK],
                   f"fit batch (first {N_FIT_CHECK} of {pts.shape[0]})")
    d2, idx = closest_tri_tiles(rows, pts, table)
    bound, dense, skipped = p1_bounds(table, pts.shape[0])
    check_cull(rows, table, pts, d2, idx,
               f"the whole fit batch ({pts.shape[0]} points)")
    t = {"fit_ms": time_ms(lambda: closest_tri_tiles(rows, pts, table), 5),
         "fit_dense_ms": time_ms(lambda: ts._launch(rows, pts, table,
                                                    cull=False), 3),
         "fit_bound_ms": bound, "fit_dense_bound_ms": dense,
         "fit_points": pts.shape[0], "fit_max_abs_err": err,
         "skipped_tile_share": skipped}
    closest_tri_tiles.launches = count       # not main-path launches
    return t


K14_OPS = 85            # f32 operations of K14's cascade a point (face)
K13_POINT_OPS = 47      # f32 operations of K13's first launch a ray
K13_LOSS_OPS = 64       # of its terms forward (the loss)
K13_VJP_OPS = 100       # and of its terms backward (the VJP times go)


def sign_before(tri_rows, best_idx, p):
    """The sign as the port took it before K14: the best rows by G, then
    mesh.sdf._signed in torch ops."""
    from hpsdf_tpu_torch.accel import row_gather
    from hpsdf_tpu_torch.mesh import sdf as TS

    return TS._signed(row_gather(tri_rows, best_idx), p)


def sign_bytes(idx, pts, feat):
    """K14's byte bound's bytes: each point, its index and its distance
    once; the vertex lanes (36 bytes) of each distinct row read and the
    pseudo-normal (12) of each distinct (row, feature) pair."""
    key = idx.long()
    rows = torch.unique(key).numel()
    pairs = torch.unique(key * 8 + feat.long()).numel()
    return pts.shape[0] * (12 + idx.element_size() + 4) + 36 * rows \
        + 12 * pairs


# the first lane of each feature's pseudo-normal in a packed row (codes
# 0..5; the face normal, code 6, lies in the vertices' sectors)
K14_PN_LANES = (12, 15, 18, 21, 24, 27)


def k14_wrong(got, want):
    """What breaks K14's check against its plain version ``want`` (both
    distances): (points whose distance is more than SIGNED_ATOL off, points
    whose sign differs where |want| > SIGNED_ATOL)."""
    flip = torch.signbit(got) != torch.signbit(want)
    return (int(((got - want).abs() > SIGNED_ATOL).sum()),
            int((flip & (want.abs() > SIGNED_ATOL)).sum()))


def k14_teeth(got, want):
    """Two wrong kernels' distances, made from K14's own, each of which the
    check against the plain version's ``want`` must fail: one distance
    2 SIGNED_ATOL off, one sign flipped where |d| > SIGNED_ATOL."""
    off, flip = got.clone(), got.clone()
    off[0] = got[0] + 2 * SIGNED_ATOL
    k = int(torch.nonzero(want.abs() > SIGNED_ATOL)[0])
    flip[k] = -got[k]
    return {name: k14_wrong(r, want) != (0, 0)
            for name, r in (("a distance 2 atol off", off),
                            ("a sign flipped", flip))}


def sign_sector_bytes(idx, pts, feat, n_rows):
    """K14's sector bound's bytes: each point, its index and its distance
    once; each 32-byte sector of a distinct in-range row that the kernel
    touches: those of the vertex lanes 0..11 and of each distinct (row,
    feature)'s pseudo-normal lanes."""
    ok = (idx.long() >= 0) & (idx.long() < n_rows)
    key, code = idx.long()[ok], feat.long()[ok]
    rows = torch.unique(key)
    lanes = torch.tensor(K14_PN_LANES + (9,), device=key.device)[code]
    pn = torch.cat([key * 4 + lanes // 8, key * 4 + (lanes + 2) // 8])
    base = torch.cat([rows * 4, rows * 4 + 1])
    sectors = torch.unique(torch.cat([base, pn])).numel()
    return pts.shape[0] * (12 + idx.element_size() + 4) + 32 * sectors


def check_k14(rows, idx, pts, label):
    """K14 against its plain version on the same best indices: the distance
    within SIGNED_ATOL at every point, the sign equal wherever |d| >
    SIGNED_ATOL (``k14_wrong``); the points whose sign or feature code (the
    plain cascade's, mesh/tri.py) differ are counted; two wrong results
    (``k14_teeth``) fail that check. Then K14 in a CUDA graph, with every
    index out of range and with one row for every point (the stream and
    launch alone; the cascade with its rows from L1), its plain version
    and the sign as it was before K14 (G's gather and the torch cascade)
    by events, and the bound on the lanes it needs beside the 32-byte
    sectors it touches; a call launches K14 once and G never (the
    counters). Launches made here are not the main path's."""
    from hpsdf_tpu_torch.accel import row_gather, row_gather_plain
    from hpsdf_tpu_torch.mesh import sdf as TS
    from hpsdf_tpu_torch.mesh import tri as TT

    counts = (TS.signed_from_best_kernel.launches, row_gather.launches)
    got, feat = TS.signed_from_best_kernel(rows, idx, pts, with_feature=True)
    g_rows = row_gather_plain(rows, idx)
    want = TS._signed(g_rows, pts)
    _, feat_p = TT.closest_point_triangle(pts, *TS._tri_parts(g_rows))
    err = float((got - want).abs().max())
    flip = torch.signbit(got) != torch.signbit(want)
    wrong, teeth = k14_wrong(got, want), k14_teeth(got, want)
    t = {"points": pts.shape[0], "max_abs_err": err,
         "sign_differ": int(flip.sum()),
         "sign_differ_beyond_atol": wrong[1],
         "feature_differ": int((feat.long() != feat_p.long()).sum()),
         "features": torch.bincount(feat.long(), minlength=7).tolist(),
         "distinct_rows": int(torch.unique(idx).numel()),
         "bit_for_bit": bool(torch.equal(got, want)), "teeth": teeth}
    check(wrong == (0, 0), f"K14 vs plain at {label}: max error "
          f"{err:.3e}, {wrong[0]} distances and {wrong[1]} signs off beyond "
          f"{SIGNED_ATOL}")
    check(all(teeth.values()), f"K14's check missed a mutation: {teeth}")
    # where the time goes: the same points with every index out of range
    # (no row read, the cascade on a zero triangle: the points' stream and
    # the launch) and with one row for every point (the cascade on every
    # point, its row from L1)
    none, first = torch.full_like(idx, -1), torch.zeros_like(idx)
    t.update(
        ms=graph_ms(lambda: TS.signed_from_best_kernel(rows, idx, pts), 20),
        no_rows_ms=graph_ms(
            lambda: TS.signed_from_best_kernel(rows, none, pts), 20),
        one_row_ms=graph_ms(
            lambda: TS.signed_from_best_kernel(rows, first, pts), 20),
        plain_ms=time_ms(lambda: TS.signed_from_best_plain(rows, idx, pts),
                         3),
        before_ms=time_ms(lambda: sign_before(rows, idx, pts), 3))
    k0, g0 = TS.signed_from_best_kernel.launches, row_gather.launches
    TS._signed_from_best(rows, idx, pts)
    t.update(kernel_launches_a_call=TS.signed_from_best_kernel.launches - k0,
             g_launches_a_call=row_gather.launches - g0)
    check((t["kernel_launches_a_call"], t["g_launches_a_call"]) == (1, 0),
          f"a sign call launched K14 {t['kernel_launches_a_call']} and G "
          f"{t['g_launches_a_call']} times")
    by_bytes = sign_bytes(idx, pts, feat) / HBM_RATE * 1e3
    by_ops = pts.shape[0] * K14_OPS / F32_PEAK * 1e3
    t.update(bytes_bound_ms=by_bytes, ops_bound_ms=by_ops,
             bound_ms=max(by_bytes, by_ops),
             bound_by="bytes" if by_bytes >= by_ops else "operations",
             sector_bound_ms=sign_sector_bytes(idx, pts, feat, rows.shape[0])
             / HBM_RATE * 1e3, library_ms=None)
    TS.signed_from_best_kernel.launches, row_gather.launches = counts
    print(f"[k14] {label}: {t['points']} points on {t['distinct_rows']} "
          f"distinct rows, max|K14 - plain| "
          f"{err:.3e} (bit for bit: {t['bit_for_bit']}), {t['sign_differ']} "
          f"signs differ ({t['sign_differ_beyond_atol']} beyond "
          f"{SIGNED_ATOL}), {t['feature_differ']} feature codes differ, "
          f"features {t['features']}; mutations caught {teeth} | K14 "
          f"{t['ms']:.4f} ms in a CUDA graph; with no row read "
          f"{t['no_rows_ms']:.4f} ms, with one row for every point "
          f"{t['one_row_ms']:.4f}; plain {t['plain_ms']:.3f} ms, before K14 "
          f"(G + torch) {t['before_ms']:.3f} ms; a call launches K14 once "
          f"and G never; bound {t['bound_ms']:.5f} ms ({t['bound_by']}; "
          f"lanes' bytes {by_bytes:.5f}, operations {by_ops:.5f}), "
          f"{t['bound_ms'] / t['ms']:.1%} of it; sector bound "
          f"{t['sector_bound_ms']:.5f} ms "
          f"({t['sector_bound_ms'] / t['ms']:.1%})", flush=True)
    return t


def phase_k14_fit(rows, table, fit_pts):
    """K14 at the main path's own points, the slice fit's largest F batch,
    on P1's best indices."""
    from hpsdf_tpu_torch.mesh import closest_tri_tiles

    count = closest_tri_tiles.launches
    pts = fit_pts.to(torch.float32)
    _, idx = closest_tri_tiles(rows, pts, table)
    closest_tri_tiles.launches = count       # not main-path launches
    return check_k14(rows, idx, pts, "the slice fit's largest batch")


def sign_split(build, phases, TS):
    """``build()`` split twice by ``phases`` (which time F and the sign):
    with K14, then with the sign as it was before K14 (``sign_before``
    swapped in for the kernel) in the same run; and the G launches of each.
    Every sign call of the second build launches G, so G's launches differ
    by the count of sign calls."""
    from unittest import mock
    from hpsdf_tpu_torch.accel import row_gather

    out = {}
    for key, swap in (("k14", None), ("before", sign_before)):
        with contextlib.ExitStack() as stack:
            if swap is not None:
                stack.enter_context(mock.patch.object(
                    TS, "signed_from_best_kernel", swap))
            g0 = row_gather.launches
            split, timer, _, _ = split_again(build, phases)
            for _, _, name in phases[len(FIT_PHASES):]:
                split[f"{name}_s"] = timer.times.get(name, 0.0)
                split[f"{name}_calls"] = timer.counts.get(name, 0)
            split["g_launches"] = row_gather.launches - g0
            row_gather.launches = g0
        out[key] = split
    check(out["before"]["g_launches"] - out["k14"]["g_launches"]
          == out["before"]["sign_calls"] > 0, f"G's launches with K14 "
          f"{out['k14']['g_launches']}, before it "
          f"{out['before']['g_launches']}, sign calls "
          f"{out['before']['sign_calls']}")
    return out


def project_rows_plain(nw, nw_strength, degree, prev_width, Fv, depths, cn,
                       prev_coeffs, out=None):
    """K6's projection by its plain version, as the kernel returns it: rows
    [coeffs | err], into ``out`` where given (a concatenation and a copy
    more than the plain version)."""
    from hpsdf_tpu_torch import build as TB

    coeffs, err = TB.fit_project_plain(nw, nw_strength, degree, prev_width,
                                       Fv, depths, cn, prev_coeffs)
    rows = torch.cat([coeffs, err[:, None]], dim=1)
    if out is None:
        return rows
    out.copy_(rows)
    return out


@contextlib.contextmanager
def k6_plain():
    """K6's plain versions swapped in for its two launches while the block
    runs (``build.fit_points_kernel``, ``build.fit_project_kernel``)."""
    from unittest import mock
    from hpsdf_tpu_torch import build as TB

    with mock.patch.object(TB, "fit_points_kernel", TB.fit_points_plain), \
            mock.patch.object(TB, "fit_project_kernel", project_rows_plain):
        yield


def tree_shape(tree):
    """A tree's node count and its histograms of depth and degree (-1, the
    interior nodes, first)."""
    n = tree.n_nodes
    return {"nodes": n,
            "depths": np.bincount(tree.depth[:n].cpu().numpy()).tolist(),
            "degrees": np.bincount(tree.degree[:n].cpu().numpy()
                                   + 1).tolist()}


def k6_split(build, phases):
    """``build()`` split by ``phases``: with K6, then twice with its plain
    versions swapped in (``k6_plain``; the first of these pays the first
    use of the einsums' kernels in the process, "plain_first"), in the same
    run. With K6 each fit
    chunk launches the points and the projection once (their launches equal
    the ``_fit_impl`` calls), with the plain versions neither; both trees
    have the same node count and depth and degree histograms (the sums'
    order may only swap the members of a mirror tie). Returns ({"k6": split,
    "plain_first": split, "plain": split, "same_tree": bool,
    "max_coeff_diff": float or None}, and the K6 run's timer, calls and
    tree)."""
    from hpsdf_tpu_torch import build as TB

    kernels = (TB.fit_points_kernel, TB.fit_project_kernel)
    out, runs = {}, {}
    for key in ("k6", "plain_first", "plain"):
        n0 = [k.launches for k in kernels]
        with (contextlib.nullcontext() if key == "k6" else k6_plain()):
            split, timer, calls, res = split_again(build, phases)
        split["k6_launches"] = [k.launches - n for k, n in zip(kernels, n0)]
        split["chunks"] = timer.counts.get("projection", 0)
        split["tree"] = tree_shape(res)
        out[key], runs[key] = split, (timer, calls, res)
    chunks = out["k6"]["chunks"]
    check(chunks > 0 and out["k6"]["k6_launches"] == [chunks, chunks]
          and out["plain"]["k6_launches"] == [0, 0]
          == out["plain_first"]["k6_launches"], f"K6's launches "
          f"{out['k6']['k6_launches']} over {chunks} fit chunks, "
          f"{out['plain']['k6_launches']} with the plain versions")
    check(out["k6"]["tree"] == out["plain"]["tree"], f"the tree with K6 "
          f"{out['k6']['tree']} and with the plain projection "
          f"{out['plain']['tree']}")
    a, b = runs["k6"][2], runs["plain"][2]
    same = bool(torch.equal(a.child_idx, b.child_idx)
                and torch.equal(a.degree, b.degree))
    out["same_tree"] = same
    out["max_coeff_diff"] = (float((a.coeffs - b.coeffs).abs().max())
                             if same else None)
    return out, *runs["k6"]


def k6_text(splits):
    """[slice], [render], [continuity] and [mesh scale]'s words on K6."""
    k, p = splits["k6"], splits["plain"]
    diff = ("the same topology, coefficients within "
            f"{splits['max_coeff_diff']:.3e}" if splits["same_tree"] else
            "a mirror tie taken the other way, same node count and "
            "histograms")
    return (f"K6 ({k['chunks']} fit chunks, launches {k['k6_launches']}): "
            f"projection {k['projection_s']:.4f} s, points "
            f"{k['points_s']:.4f} s, points and copies "
            f"{k['points_and_copies_s']:.4f} s of {k['instrumented_build_s']:.3f}"
            f" s; with the plain versions: projection "
            f"{p['projection_s']:.4f} s, points {p['points_s']:.4f} s, "
            f"points and copies {p['points_and_copies_s']:.4f} s of "
            f"{p['instrumented_build_s']:.3f} s (the first such build: "
            f"projection {splits['plain_first']['projection_s']:.4f} s of "
            f"{splits['plain_first']['instrumented_build_s']:.3f} s; {diff})")


def k6_check(rows, coeffs, err, label):
    """K6's rows [coeffs | err] against the plain version's (coeffs, err):
    raises unless each coefficient is within K6_RTOL of its cell's largest
    |c|, each err within 40 K6_RTOL sqrt(err) max|c| + 10 K6_RTOL err and
    NaN exactly where the plain err is. Returns (the largest coefficient
    error over its cell's largest |c|, the largest err error over its
    tolerance, the largest absolute difference)."""
    tol = K6_RTOL[coeffs.dtype]
    C = coeffs.shape[1]
    got_c, got_e = rows[:, :C], rows[:, C]
    big = coeffs.abs().amax(dim=1)
    dc = (got_c - coeffs).abs()
    c_rel = float((dc.amax(dim=1) / big.clamp_min(1e-300)).max())
    check(bool((dc <= tol * big[:, None]).all()), f"K6 vs plain at {label}:"
          f" a coefficient {c_rel:.3e} of its cell's largest off")
    nan = torch.isnan(err)
    check(torch.equal(nan, torch.isnan(got_e)), f"K6 vs plain at {label}: "
          f"NaN errors at {int(torch.isnan(got_e).sum())} cells, the plain "
          f"version's at {int(nan.sum())}")
    e, g = err[~nan], got_e[~nan]
    limit = 40 * tol * e.abs().sqrt() * big[~nan] + 10 * tol * e.abs()
    e_rel = float(((g - e).abs() / limit.clamp_min(1e-300)).max()) \
        if e.numel() else 0.0
    check(bool(((g - e).abs() <= limit).all()), f"K6 vs plain at {label}: "
          f"an err {e_rel:.3e} of its tolerance off")
    ab = float(torch.cat([dc.reshape(-1), (g - e).abs()]).max())
    return c_rel, e_rel, ab


def k6_caught(rows, coeffs, err, label):
    """Whether ``k6_check`` fails (a mutation must)."""
    try:
        k6_check(rows, coeffs, err, label)
    except RuntimeError:
        return True
    return False


def k6_seeded(degree, dt, seed, m=None):
    """A degree's seeded fit chunk on the card, of m cells (the main path's
    full chunk, max(1, 2^20 // Q^3), where not given): F values uniform in
    [-1, 1] about a cell offset in [-2.5, 2.5] (so fbar crosses sqrt 3),
    depths 0..10, and the kept coefficients (C(d-1) of them) the cell's own
    fit times factors in [0.5, 1.5]. Returns (Fv, depths, prev)."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch import consts
    from hpsdf_tpu_torch.config import NearnessWeighting as NW

    Q = 4 * degree + 1
    m = max(1, TB.BLOCK_PTS // Q ** 3) if m is None else m
    rng = np.random.default_rng(seed)
    Fv = torch.as_tensor(rng.uniform(-1.0, 1.0, (m, Q, Q, Q))
                         + rng.uniform(-2.5, 2.5, (m, 1, 1, 1)),
                         device="cuda").to(dt)
    d = torch.as_tensor(rng.integers(0, consts.TREE_MAX_DEPTH + 1, m),
                        dtype=torch.int32, device="cuda")
    pw = consts.coeff_count(degree - 1)
    cn = TB.fit_tables(degree, dt, Fv.device).cn
    own, _ = TB.fit_project_plain(NW.NONE, 0.0, degree, 0, Fv, d, cn, None)
    prev = own[:, :pw] * torch.as_tensor(rng.uniform(0.5, 1.5, (m, pw)),
                                         device="cuda").to(dt)
    return Fv, d, prev.contiguous()


def k6_bounds(degree, m, pw, es):
    """K6's bounds (ms) at m cells of a degree, es bytes a value: the
    points' (m Q^3 points written, the centres, depths and nodes read; an
    add a coordinate) and the projection's (F's values, the depths, the
    kept coefficients and the tables read once, the rows written; the FMAs
    of the three contractions, Q^3 (d+1) + Q^2 (d+1)(d+2)/2 + Q C a cell,
    two operations each)."""
    from hpsdf_tpu_torch import consts

    Q, C = 4 * degree + 1, consts.coeff_count(degree)
    peak = F64_PEAK if es == 8 else F32_PEAK
    pts_bytes = m * Q ** 3 * 3 * es + m * (3 * es + 4) + Q * es
    pts_ops = m * Q ** 3 * 3
    prj_bytes = (m * Q ** 3 * es + 4 * m + m * pw * es
                 + ((degree + 1) * Q + (consts.TREE_MAX_DEPTH + 1) * C) * es
                 + m * (C + 1) * es)
    fmas = m * (Q ** 3 * (degree + 1) + Q ** 2 * (degree + 1) * (degree + 2)
                // 2 + Q * C)
    out = {}
    for key, nbytes, ops in (("points", pts_bytes, pts_ops),
                             ("project", prj_bytes, 2 * fmas)):
        b, o = nbytes / HBM_RATE * 1e3, ops / peak * 1e3
        out[key] = {"bound_ms": max(b, o), "bytes_bound_ms": b,
                    "ops_bound_ms": o,
                    "bound_by": "bytes" if b >= o else "operations"}
    return out


def k6_centres(degree, seed, m=None):
    """Seeded centres in [-0.5, 0.5]^3 (f64) and depths 0..10 on the card
    for a chunk of m cells (the full chunk where not given)."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch import consts

    m = max(1, TB.BLOCK_PTS // (4 * degree + 1) ** 3) if m is None else m
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.uniform(-0.5, 0.5, (m, 3)), device="cuda"),
            torch.as_tensor(rng.integers(0, consts.TREE_MAX_DEPTH + 1, m),
                            dtype=torch.int32, device="cuda"))


def k6_ranges(degree, split):
    """The i-slabs [i0, i1) of each block of a cluster of ``split`` blocks,
    as csrc/fit.cu gives them: block s takes [s Q // S, (s + 1) Q // S)."""
    Q = 4 * degree + 1
    return [(s * Q // split, (s + 1) * Q // split) for s in range(split)]


def k6_model(Fv, depths, degree, split):
    """K6's projection in numpy f64 (no kept coefficients, no nearness
    weight) with the kernel's split: each cell's i-slabs split as a cluster
    of ``split`` blocks splits them (``k6_ranges``), each block's partial
    sums over its slabs in index order, the partials added in rank order;
    then coeffs = raw cn[depth] half^3 and err the sum of the top degree's
    squares. Fv (m, Q, Q, Q) and depths (m,) numpy or tensors. Returns
    (coeffs (m, C), err (m,)) numpy."""
    from hpsdf_tpu_torch import basis

    F = np.asarray(torch.as_tensor(Fv).cpu(), np.float64)
    d = np.asarray(torch.as_tensor(depths).cpu(), np.int64)
    A = basis.quadrature_matrix(degree)                       # (P, Q)
    idx = basis.basis_indices(degree)                         # (C, 3)
    G = np.einsum("mijk,rk->mijr", F, A)
    G = np.einsum("mijr,qj->miqr", G, A)                      # (m, Q, P, P)
    terms = A.T[None, :, idx[:, 0]] * G[:, :, idx[:, 1], idx[:, 2]]
    raw = None
    for i0, i1 in k6_ranges(degree, split):
        part = terms[:, i0]
        for i in range(i0 + 1, i1):
            part = part + terms[:, i]
        raw = part if raw is None else raw + part
    half = np.ldexp(1.0, -(d + 1))
    coeffs = raw * basis.coeff_norms(degree)[d] * (half ** 3)[:, None]
    err = np.sum(np.where(idx.sum(axis=1) == degree, coeffs ** 2, 0.0),
                 axis=1)
    return coeffs, err


def k6_rows_differ(a, b):
    """How many rows of a and b differ in any bit (NaN equal to a NaN of
    the same bits)."""
    a, b = torch.as_tensor(a).contiguous(), torch.as_tensor(b).contiguous()
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return int((a.view(it) != b.to(a.device).view(it)).any(dim=1).sum())


def fit_points_reference(c, d, degree):
    """K6's points as they were before the redesign
    (csrc/check/fit_reference.cu)."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch import build as TB

    Q = 4 * degree + 1
    out = torch.empty((c.shape[0] * Q ** 3, 3), dtype=c.dtype,
                      device=c.device)
    xj = TB.fit_tables(degree, c.dtype, c.device).xj
    rc = _kernels.load_check().hpsdf_fit_points_reference(
        c.data_ptr(), d.data_ptr(), xj.data_ptr(), Q, c.shape[0],
        int(c.dtype == torch.float64), out.data_ptr(), _kernels.stream_of(c))
    _kernels.check(_kernels.load(), rc, "fit_points_reference")
    return out


def fit_project_reference(nw, nw_strength, degree, pw, Fv, depths, cn,
                          prev, out=None):
    """K6's projection as it was before the redesign
    (csrc/check/fit_reference.cu): rows [coeffs |
    err], into ``out`` where given."""
    from hpsdf_tpu_torch import _kernels, consts
    from hpsdf_tpu_torch import build as TB

    M, C = Fv.shape[0], consts.coeff_count(degree)
    if out is None:
        out = torch.empty((M, C + 1), dtype=Fv.dtype, device=Fv.device)
    A = TB.fit_tables(degree, Fv.dtype, Fv.device).A
    rc = _kernels.load_check().hpsdf_fit_project_reference(
        Fv.data_ptr(), depths.data_ptr(), A.data_ptr(), cn.data_ptr(),
        prev.data_ptr() if pw else 0, pw, degree, nw.value,
        float(nw_strength), M, int(Fv.dtype == torch.float64),
        out.data_ptr(), _kernels.stream_of(Fv))
    _kernels.check(_kernels.load(), rc, "fit_project_reference")
    return out


def k6_shape(degree, dt):
    """K6's projection launch at a degree on this card, from the C side
    (``hpsdf_fit_project_shape``): blocks a cell (the cluster), cells a
    block, threads, dynamic shared memory in bytes, and the clusters (or
    blocks, where a cell takes one) the card holds at once."""
    import ctypes
    from hpsdf_tpu_torch import _kernels

    buf = (ctypes.c_int64 * 5)()
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_fit_project_shape(
        degree, int(dt == torch.float64), ctypes.addressof(buf)),
        "fit_project_shape")
    return dict(zip(("split", "cells", "threads", "smem_bytes", "active"),
                    map(int, buf)))


def graph_ms_fresh(fn, reps):
    """fn()'s mean device time when every call writes fresh memory: reps
    calls captured in one CUDA graph with all their results kept, so each
    call's writes evict earlier calls' dirty lines from L2 and reach device
    memory while it runs (``graph_ms`` replays one buffer, which L2
    holds)."""
    keep = [fn()]
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            keep.append(fn())
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    sync()
    del keep
    return start.elapsed_time(end) / reps


def graph_ms_flushed(fn, reps, flush):
    """fn()'s mean device time with L2 flushed before each call: reps
    (flush, fn) pairs in one CUDA graph less reps flushes alone
    (``graph_ms`` both)."""
    return (graph_ms(lambda: (flush(), fn()), reps)
            - graph_ms(flush, reps))


def k6_invariance(seed):
    """A cell's row does not depend on its chunk: at every degree 2..11,
    in f64 and f32, the same seeded cells (``k6_seeded``: kept
    coefficients, polynomial weight) fitted in one full chunk, in chunks of
    one cell and shifted by K6_SHIFT cells (other cells before them) give
    the same rows bit for bit. Its teeth, at every degree in f64: the same
    check fails a projection whose split follows the chunk, the full chunk
    summed with the kernel's split and the one-cell chunks with twice as
    many blocks a cell (``k6_model``, from the same per-slab terms).
    Returns {"cells": cells checked, "mutation_rows": {degree: rows that
    differ}}."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch import consts
    from hpsdf_tpu_torch.config import NearnessWeighting as NW

    cells, caught = 0, {}
    for degree in TB.FIT_DEGREES:
        C = consts.coeff_count(degree)
        for dt in (torch.float64, torch.float32):
            Fv, dv, prev = k6_seeded(degree, dt, seed + degree)
            m, pw = Fv.shape[0], prev.shape[1]
            cn = TB.fit_tables(degree, dt, Fv.device).cn
            args = (NW.POLYNOMIAL, K6_STRENGTH["POLYNOMIAL"], degree, pw)
            full = TB.fit_project_kernel(*args, Fv, dv, cn, prev)
            one = torch.empty((m, C + 1), dtype=dt, device=Fv.device)
            for i in range(m):
                TB.fit_project_kernel(*args, Fv[i:i + 1], dv[i:i + 1], cn,
                                      prev[i:i + 1], one[i:i + 1])
            k = min(K6_SHIFT, m)
            shifted = TB.fit_project_kernel(
                *args, torch.cat([Fv[-k:], Fv]), torch.cat([dv[-k:], dv]),
                cn, torch.cat([prev[-k:], prev]))[k:]
            for name, rows in (("one-cell chunks", one),
                               (f"shifted by {k}", shifted)):
                n = k6_rows_differ(full, rows)
                check(n == 0, f"K6's rows at degree {degree}, {dt}: {n} of "
                      f"{m} cells differ between one chunk and {name}")
            cells += m
            if dt == torch.float64:
                a = k6_model(Fv, dv, degree, K6_SPLIT[degree])
                b = k6_model(Fv, dv, degree, 2 * K6_SPLIT[degree])
                caught[degree] = k6_rows_differ(
                    np.concatenate([a[0], a[1][:, None]], axis=1),
                    np.concatenate([b[0], b[1][:, None]], axis=1))
    check(all(caught.values()), f"the chunk-invariance check passed a split "
          f"that follows the chunk: rows that differ {caught}")
    return {"cells": cells, "mutation_rows": caught}


def k6_time(fn_new, fn_ref, cold, reps=30):
    """A K6 launch and the one it replaced on the same inputs, in CUDA
    graphs: warm (back to back: the inputs, and the one output buffer,
    left in L2, as the main path leaves F) and cold (``cold(fn,
    reps)``)."""
    return {"ms": graph_ms(fn_new, reps), "cold_ms": cold(fn_new, reps),
            "reference_ms": graph_ms(fn_ref, reps),
            "reference_cold_ms": cold(fn_ref, reps)}


def k6_times(pts_args, prj_args, flush, plain=True):
    """K6's two launches at one chunk, beside the replaced kernels, the plain
    versions (``plain``), the three einsums (in a CUDA graph) and the
    bounds (``k6_bounds``), each share against the cold time: the
    projection with F flushed from L2 by ``flush`` before each call
    (``graph_ms_flushed``), the points writing fresh memory each call, so
    that their writes reach device memory (``graph_ms_fresh``). pts_args
    (centres, depths, degree) or None; prj_args ``_fit_impl``'s first
    eight."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch import consts

    nw, s, degree, pw, Fv, dv, cn, prev = prj_args
    m = Fv.shape[0]
    es = Fv.element_size()
    b = k6_bounds(degree, m, pw, es)
    out = {"cells": m, "degree": degree, "pw": pw,
           "dtype": str(Fv.dtype).split(".")[-1]}
    if pts_args is not None:
        c, d, _ = pts_args
        pb = k6_bounds(degree, c.shape[0], 0, c.element_size())["points"]
        out["points"] = {
            "cells": c.shape[0],
            **k6_time(lambda: TB.fit_points_kernel(c, d, degree),
                      lambda: fit_points_reference(c, d, degree),
                      lambda fn, reps: graph_ms_fresh(fn, reps + 10)),
            **pb, "library_ms": None}
        if plain:
            out["points"]["plain_ms"] = time_ms(
                lambda: TB.fit_points_plain(c, d, degree), 5)
    rows = torch.empty((m, consts.coeff_count(degree) + 1), dtype=Fv.dtype,
                       device="cuda")
    A = TB.fit_tables(degree, Fv.dtype, Fv.device).A

    def einsums():
        T_ = torch.einsum("mijk,pi->mpjk", Fv, A)
        T_ = torch.einsum("mpjk,qj->mpqk", T_, A)
        return torch.einsum("mpqk,rk->mpqr", T_, A)

    out["project"] = {
        "cells": m, **k6_time(lambda: TB.fit_project_kernel(*prj_args, rows),
                  lambda: fit_project_reference(*prj_args, rows),
                  lambda fn, reps: graph_ms_flushed(fn, reps, flush)),
        "library_ms": graph_ms(einsums, 10), **b["project"]}
    if plain:
        out["project"]["plain_ms"] = time_ms(
            lambda: TB.fit_project_plain(*prj_args), 5)
    for key in ("points", "project"):
        if key in out:
            j = out[key]
            j["share"] = j["bound_ms"] / j["cold_ms"]
            j["faster"] = (j["ms"] < j["reference_ms"]
                           and j["cold_ms"] < j["reference_cold_ms"])
    return out


def k6_line(label, t):
    """A [k6] line: one chunk's times (``k6_times``)."""
    j = t["project"]
    text = (f"[k6] {label}: {t['cells']} cells, degree {t['degree']}, pw "
            f"{t['pw']}, {t['dtype']}: projection {j['ms']:.4f} ms warm / "
            f"{j['cold_ms']:.4f} L2-flushed (the replaced kernel "
            f"{j['reference_ms']:.4f} / {j['reference_cold_ms']:.4f}), "
            f"the three einsums {j['library_ms']:.4f}"
            + (f", plain {j['plain_ms']:.3f}" if "plain_ms" in j else "")
            + f", bound {j['bound_ms']:.5f} ({j['bound_by']}; bytes "
            f"{j['bytes_bound_ms']:.5f}, operations {j['ops_bound_ms']:.5f})"
            f", {j['share']:.1%} of it flushed")
    if "points" in t:
        p = t["points"]
        text += (f" | points ({p['cells']} cells) {p['ms']:.4f} warm / "
                 f"{p['cold_ms']:.4f} into fresh memory (the replaced "
                 f"kernel's "
                 f"{p['reference_ms']:.4f} / "
                 f"{p['reference_cold_ms']:.4f})"
                 + (f", plain {p['plain_ms']:.3f}" if "plain_ms" in p
                    else "")
                 + f", bound {p['bound_ms']:.5f} ({p['bound_by']}), "
                 f"{p['share']:.1%} of it into fresh memory")
    return text


def phase_k6(calls, smi, seed=30):
    """K6 (csrc/fit.cu) against its plain versions and the kernels it replaced
    (csrc/check/fit_reference.cu). The launch's shape at every degree (its
    split and cells a block as K6_SPLIT and K6_CELLS say, clusters that
    fit on the card). The points bit for bit the plain version's and PR
    18's at the slice fit's largest chunk (the main path's own call, from
    the split's ``calls``) and at every degree 2..11 (seeded), f64 and f32;
    the projection on that chunk's F values (the main path's own rows) and
    on seeded chunks at degrees 2..11 x pw in {0, C(d-1)} x the three
    weightings, in f64 and f32 (``k6_check``), and bit for bit the replaced
    rows where a cell takes one block (degrees 2 and 3); the check's teeth
    (one coefficient x (1 + 1e-10), the nearness factor dropped, the fbar
    of the new c_0 in place of the kept prev[0]: each must fail it); the
    chunk invariance and its teeth (``k6_invariance``). Then both launches
    in CUDA graphs, warm and cold (``k6_times``), beside the replaced kernels,
    the plain versions, the three einsums and the bounds: at
    K6_TIME_DEGREES' full chunks, at the slice fit's largest degree-2 and
    degree-3 chunks and at K6_SMALL's seeded chunks; the projection and the
    einsums alone at the other degrees. Launches made here are not the
    main path's."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch import consts
    from hpsdf_tpu_torch.config import NearnessWeighting as NW

    counts = (TB.fit_points_kernel.launches, TB.fit_project_kernel.launches)
    t = {"errs": {}, "shapes": {}}

    # --- the launch's shape ----------------------------------------------
    for degree in TB.FIT_DEGREES:
        for dt in (torch.float64, torch.float32):
            sh = k6_shape(degree, dt)
            check(sh["split"] == K6_SPLIT[degree]
                  and sh["cells"] == K6_CELLS[degree] and sh["active"] > 0,
                  f"K6's projection at degree {degree}, {dt}: {sh}")
            t["shapes"][f"{degree}/{str(dt)[-7:]}"] = sh

    # --- the slice fit's largest chunk, as the main path ran it ----------
    (c, d, deg), _, pts = calls[("points", "largest")]
    check(torch.equal(pts, TB.fit_points_plain(c, d, deg))
          and torch.equal(TB.fit_points_kernel(c, d, deg), pts)
          and torch.equal(fit_points_reference(c, d, deg), pts),
          f"K6's points at the slice fit's largest chunk ({c.shape[0]} "
          f"cells, degree {deg}) differ from the plain version's or PR "
          f"18's")
    args, _, res = calls[("projection", "largest")]
    nw, s, deg_p, pw, Fv, dp, cn, prev = args[:8]
    coeffs, err = TB.fit_project_plain(nw, s, deg_p, pw, Fv, dp, cn, prev)
    rows = torch.cat([res[0], res[1][:, None]], dim=1)
    t["errs"]["slice"] = k6_check(rows, coeffs, err, "the slice fit's "
                                  "largest chunk")
    if K6_SPLIT[deg_p] == 1:
        n = k6_rows_differ(rows, fit_project_reference(*args[:8]))
        check(n == 0, f"K6's projection at the slice fit's largest chunk: "
              f"{n} rows differ from the replaced kernel's")
    t["slice_chunk"] = {"cells": Fv.shape[0], "degree": deg_p, "pw": pw,
                        "points_cells": c.shape[0], "points_degree": deg}

    # --- seeded chunks at every degree ------------------------------------
    f64_err, f32_err = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    teeth, same_as_pr18 = {}, 0
    for degree in TB.FIT_DEGREES:
        cc, dd = k6_centres(degree, seed + degree)
        for dt in (torch.float64, torch.float32):
            ct = cc.to(dt)
            pts = TB.fit_points_kernel(ct, dd, degree)
            check(torch.equal(pts, TB.fit_points_plain(ct, dd, degree))
                  and torch.equal(pts, fit_points_reference(ct, dd, degree)),
                  f"K6's points at degree {degree}, {dt}")
            Fv, dv, prev = k6_seeded(degree, dt, seed + 100 + degree)
            cn = TB.fit_tables(degree, dt, Fv.device).cn
            for pw in (0, prev.shape[1]):
                for name, s in K6_STRENGTH.items():
                    nw = NW[name]
                    p = prev if pw else None
                    a8 = (nw, s, degree, pw, Fv, dv, cn, p)
                    got = TB.fit_project_kernel(*a8)
                    want = TB.fit_project_plain(*a8)
                    e = k6_check(got, *want, f"degree {degree}, pw {pw}, "
                                 f"{name}, {dt}")
                    acc = f64_err if dt == torch.float64 else f32_err
                    for i in range(3):
                        acc[i] = max(acc[i], e[i])
                    if K6_SPLIT[degree] == 1:
                        n = k6_rows_differ(got, fit_project_reference(*a8))
                        check(n == 0, f"K6's projection at degree {degree},"
                              f" pw {pw}, {name}, {dt}: {n} rows differ "
                              f"from the replaced kernel's")
                        same_as_pr18 += 1
                    if (dt == torch.float64 and degree == 5 and pw
                            and name == "POLYNOMIAL"):
                        teeth = k6_teeth(got, want, degree, Fv, dv, cn, s)
    t["errs"].update(f64=f64_err, f32=f32_err)
    t["teeth"] = teeth
    check(all(teeth.values()), f"K6's check missed a mutation: {teeth}")
    t["invariance"] = k6_invariance(seed + 400)
    t["same_as_pr18_cases"] = same_as_pr18

    # --- times ---------------------------------------------------------
    big = torch.ones(K6_FLUSH_BYTES // 8, dtype=torch.float64, device="cuda")

    def flush():
        big.sum()

    t["full"], t["main"], t["small"], t["einsums_only"] = {}, {}, {}, {}
    for degree in K6_TIME_DEGREES:
        cc, dd = k6_centres(degree, seed + 200 + degree)
        Fv, dv, _ = k6_seeded(degree, torch.float64, seed + 300 + degree)
        cn = TB.fit_tables(degree, torch.float64, Fv.device).cn
        t["full"][degree] = k6_times(
            (cc, dd, degree), (NW.NONE, 0.0, degree, 0, Fv, dv, cn, None),
            flush)
    for degree in (2, 3):
        (c, d, _), _, _ = calls[("points", "largest", degree)]
        args, _, _ = calls[("projection", "largest", degree)]
        t["main"][degree] = k6_times((c, d, degree), tuple(args[:8]), flush,
                                     plain=False)
    for degree, m in K6_SMALL:
        cc, dd = k6_centres(degree, seed + 500 + degree, m)
        Fv, dv, _ = k6_seeded(degree, torch.float64, seed + 600 + degree, m)
        cn = TB.fit_tables(degree, torch.float64, Fv.device).cn
        t["small"][f"{m}@{degree}"] = k6_times(
            (cc, dd, degree), (NW.NONE, 0.0, degree, 0, Fv, dv, cn, None),
            flush, plain=False)
    for degree in TB.FIT_DEGREES:
        if degree in K6_TIME_DEGREES:
            continue
        Fv, dv, _ = k6_seeded(degree, torch.float64, seed + 700 + degree)
        cn = TB.fit_tables(degree, torch.float64, Fv.device).cn
        A = TB.fit_tables(degree, torch.float64, Fv.device).A
        rows = torch.empty((Fv.shape[0], consts.coeff_count(degree) + 1),
                           dtype=torch.float64, device="cuda")

        def einsums():
            T_ = torch.einsum("mijk,pi->mpjk", Fv, A)
            T_ = torch.einsum("mpjk,qj->mpqk", T_, A)
            return torch.einsum("mpqk,rk->mpqr", T_, A)

        t["einsums_only"][degree] = {
            "cells": Fv.shape[0],
            "ms": graph_ms(lambda: TB.fit_project_kernel(
                NW.NONE, 0.0, degree, 0, Fv, dv, cn, None, rows), 30),
            "library_ms": graph_ms(einsums, 10)}
    del big
    TB.fit_points_kernel.launches, TB.fit_project_kernel.launches = counts

    timed = [*t["full"].values(), *t["main"].values(), *t["small"].values()]
    t["faster_than_pr18"] = all(x[k]["faster"] for x in timed
                                for k in ("points", "project"))
    t["faster_than_einsums"] = all(
        x["project"]["ms"] < x["project"]["library_ms"]
        for x in t["full"].values()) and all(
        x["ms"] < x["library_ms"] for x in t["einsums_only"].values())
    sc, inv = t["slice_chunk"], t["invariance"]
    print(f"[k6] {smi} | points bit for bit the plain version's and the "
          f"replaced kernel's "
          f"at the slice fit's largest chunk ({sc['points_cells']} cells, "
          f"degree {sc['points_degree']}) and at degrees 2..11 (f64, f32); "
          f"projection at its largest chunk ({sc['cells']} cells, degree "
          f"{sc['degree']}, pw {sc['pw']}): coefficients within "
          f"{t['errs']['slice'][0]:.3e} of their cell's largest, err at "
          f"{t['errs']['slice'][1]:.3e} of its tolerance; seeded degrees "
          f"2..11 x pw x weightings: f64 {f64_err[0]:.3e} / "
          f"{f64_err[1]:.3e}, f32 {f32_err[0]:.3e} / {f32_err[1]:.3e}; "
          f"bit for bit the replaced kernel's rows where a cell takes one "
          f"block "
          f"({same_as_pr18} seeded cases and the slice's chunk); mutations "
          f"caught {teeth}", flush=True)
    print(f"[k6] chunk invariance: {inv['cells']} cells' rows bit for bit in "
          f"one chunk, in one-cell chunks and shifted by {K6_SHIFT} at "
          f"degrees 2..11, f64 and f32; a split that follows the chunk "
          f"(one-cell chunks on twice the blocks, k6_model) changes "
          f"{inv['mutation_rows']} rows by degree: caught", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print("[k6] launch: " + ", ".join(
        f"degree {k}: {v['split']} block(s) a cell, {v['cells']} cell(s) a "
        f"block, {v['smem_bytes']} B, {v['active']} at once"
        for k, v in t["shapes"].items() if k.endswith("float64"))
          + f" (f64; {sms} SMs)", flush=True)
    for degree, x in t["full"].items():
        print(k6_line(f"full chunk, degree {degree}", x), flush=True)
    for degree, x in t["main"].items():
        print(k6_line(f"the slice fit's largest degree-{degree} chunk", x),
              flush=True)
    for key, x in t["small"].items():
        print(k6_line(f"small chunk {key}", x), flush=True)
    print("[k6] projection / the three einsums at the other degrees (full "
          "chunks, warm): " + ", ".join(
              f"degree {k} ({v['cells']} cells) {v['ms']:.4f} / "
              f"{v['library_ms']:.4f} ms"
              for k, v in t["einsums_only"].items())
          + f" | faster than the replaced kernels at every timed chunk: "
          f"{t['faster_than_pr18']}; projection faster than the einsums at "
          f"every degree: {t['faster_than_einsums']}", flush=True)
    return t


def k6_teeth(rows, want, degree, Fv, depths, cn, s):
    """Three wrong kernels' rows, made from K6's own, each of which
    ``k6_check`` must fail: one coefficient (a cell's largest) x (1 +
    1e-10); the nearness factor dropped; and the polynomial weight taken
    from the new c_0 in place of the kept prev[0]."""
    from hpsdf_tpu_torch import build as TB
    from hpsdf_tpu_torch.config import NearnessWeighting as NW

    coeffs, err = want
    C = coeffs.shape[1]
    top = TB.fit_tables(degree, Fv.dtype, Fv.device).top
    unweighted = torch.sum(torch.where(top, coeffs ** 2, 0.0), dim=1)
    live = ~torch.isnan(err) & (err > 0)

    one = rows.clone()
    cell = int(torch.nonzero(live)[0])
    one[cell, int(coeffs[cell].abs().argmax())] *= 1.0 + 1e-10
    dropped = rows.clone()
    dropped[:, C] = unweighted
    new0, _ = TB.fit_project_plain(NW.NONE, 0.0, degree, 0, Fv, depths, cn,
                                   None)
    fbar = torch.abs(new0[:, 0] * torch.exp2(1.5 * depths.to(Fv.dtype)))
    k = torch.clamp((1.0 - fbar / math.sqrt(3.0)) ** s, 0.0, 1.0)
    new_c0 = rows.clone()
    new_c0[:, C] = unweighted * k
    return {name: k6_caught(r, coeffs, err, f"mutation: {name}")
            for name, r in (("coefficient x (1 + 1e-10)", one),
                            ("nearness factor dropped", dropped),
                            ("fbar from the new c_0", new_c0))}


def phase_k6_ops(calls):
    """The operations a fit chunk's points and projection put on the card
    (torch.profiler), at the slice fit's largest chunk: K6's must be at
    most K6_LAUNCHES; the plain versions' beside them. Taken after [grad]
    (an early trace leaves later ones empty)."""
    from hpsdf_tpu_torch import build as TB

    counts = (TB.fit_points_kernel.launches, TB.fit_project_kernel.launches)
    (c, d, deg), _, _ = calls[("points", "largest")]
    args, _, _ = calls[("projection", "largest")]
    out = torch.empty((args[4].shape[0], args[6].shape[1] + 1),
                      dtype=args[4].dtype, device=args[4].device)

    def chunk():
        TB.fit_points(c, d, deg)
        TB._fit_impl(*args[:8], out)

    ops = device_ops(chunk)
    with k6_plain():
        plain = device_ops(chunk)
    TB.fit_points_kernel.launches, TB.fit_project_kernel.launches = counts
    check(1 <= ops <= K6_LAUNCHES, f"a fit chunk's points and projection "
          f"put {ops} operations on the card (at most {K6_LAUNCHES})")
    print(f"[k6 ops] a fit chunk's points and projection: {ops} operations "
          f"on the card with K6, {plain} with the plain versions (the rows' "
          f"concatenation and copy included)", flush=True)
    return {"launches_a_chunk": ops, "plain_launches_a_chunk": plain}


def phase_k8n_ops(tree, dev):
    """The operations a call of K8's node-range mode puts on the card
    (torch.profiler) at the train step's shape (rank 0's half of the slice
    tree at NODE_STEP_POINTS points in [-0.4, 0.4]^3): at least one and at
    most K8N_LAUNCHES, the kernel it replaced, as its wrapper called it,
    beside them.
    Taken after [grad] (an early trace leaves later ones empty)."""
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.query import (_to_unit, coeff_scatter_nodes_kernel,
                                       descend, node_buckets_kernel)

    counts = (coeff_scatter_nodes_kernel.launches,
              node_buckets_kernel.launches)
    pts = torch.as_tensor(np.random.default_rng(43).uniform(
        -0.4, 0.4, (NODE_STEP_POINTS, 3)), device=dev)
    leaves = descend(tree, _to_unit(tree, pts).clamp(-0.5, 0.5))
    w = torch.ones(NODE_STEP_POINTS, dtype=torch.float64, device=dev)
    blk = P.node_block(tree, 2, 0)
    ops = device_ops(lambda: coeff_scatter_nodes_kernel(blk, pts, leaves, w))
    replaced = device_ops(lambda: coeff_scatter_nodes_reference(
        blk, pts, leaves, w))
    coeff_scatter_nodes_kernel.launches, node_buckets_kernel.launches = counts
    check(1 <= ops <= K8N_LAUNCHES, f"a call of K8's node-range mode put "
          f"{ops} operations on the card (at most {K8N_LAUNCHES})")
    print(f"[k8 nodes ops] a call of K8's node-range mode: {ops} operations "
          f"on the card, the kernel it replaced {replaced} (the output's "
          f"memset and a launch)", flush=True)
    return {"launches_a_call": ops, "replaced_launches_a_call": replaced}


def cold_child(mode):
    """A fresh process's first slice build and a second one, split by
    phase (``split_again``), with K6 (``mode`` "k6") or its plain versions
    (``mode`` "plain"); prints one JSON line. The kernel library is the
    parent's, loaded before the builds; the mesh and its rows are made
    first."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen, mesh_sdf

    _kernels.load()
    dev = torch.device("cuda", 0)
    v, f = gen.icosphere(0.3, 5)
    mesh = build_mesh(v, f)
    F = mesh_sdf(mesh, build_bvh(mesh, device=dev))
    sync()
    cfg = T.Config(**SLICE_CONFIG)
    with (k6_plain() if mode == "plain" else contextlib.nullcontext()):
        first = split_again(lambda: T.build_octree(cfg, F, device=dev),
                            SLICE_PHASES)[0]
        warm = split_again(lambda: T.build_octree(cfg, F, device=dev),
                           SLICE_PHASES)[0]
    print(json.dumps({"mode": mode, "first": first, "warm": warm}),
          flush=True)
    return 0


def phase_cold(first_s, warm_s, smi):
    """The first slice build of a fresh process split by phase, with K6 and
    with its plain versions (``cold_child`` in a child process each, one
    after the other), beside this process's first and warm builds."""
    out = {"in_process_first_s": first_s, "in_process_warm_s": warm_s}
    for mode in ("k6", "plain"):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--cold", mode],
            capture_output=True, text=True, timeout=COLD_TIMEOUT_S,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        check(res.returncode == 0, f"the cold child ({mode}) exited "
              f"{res.returncode}: {res.stderr[-2000:]}")
        out[mode] = json.loads(res.stdout.strip().splitlines()[-1])
        out[mode]["process_s"] = time.perf_counter() - t0
    for mode in ("k6", "plain"):
        c = out[mode]
        print(f"[cold] {smi} | {mode}: a fresh process's first slice build "
              f"{c['first']['instrumented_build_s']:.3f} s (split: "
              f"{split_text(c['first'])}), its second "
              f"{c['warm']['instrumented_build_s']:.3f} s (split: "
              f"{split_text(c['warm'])}); the child took "
              f"{c['process_s']:.1f} s | this process: first build "
              f"{first_s:.3f} s, warm {warm_s:.3f} s (instrumented)",
              flush=True)
    return out


def counters():
    """Every launch counter, by name: (kernel wrapper, attribute). K2/K5's
    wrapper counts all its launches and, apart, those of K5's normals, of
    its raw gradient and of the fused mode; G's backward's all its launches
    and, apart, those of its CSR form. K9 (``cg_matvec``), K9u
    (``cg_update``), the persistent CG launch (``_chunk_launch``) and the
    row-sharded CG's K9 partial mode and K9u's two launches
    (``cg_matvec_rows``, ``cg_update_rows``, ``cg_direction``) each count
    only their own kernel's launches; K1's node-range mode
    (``query_nodes``) counts its descent rounds and leaf evaluations; K8's
    node-range mode its tile launches (``coeff_scatter_nodes``) and, apart,
    its sort's (``node_buckets``); K1's backward modes all their launches
    (``query_vjp``) and, apart, K1h's (``query_vjp_hess``) and K1c's
    (``query_vjp_centre``, either order); K1 all its
    launches and, apart, those that write the leaf for them
    (``query_leaf``); K7 its form 2's apart (``packed_grad_form2``); K5
    its normals (``packed_eval_normals``, either mode) and, apart, those
    that save for K7's form 2 and K5h (``packed_eval_save``); K2's fused
    mode (``packed_eval_fused``, either) and, apart, those that save the
    keys for K5h (``packed_eval_keys``)."""
    from hpsdf_tpu_torch.accel import (packed_eval_kernel, packed_grad_kernel,
                                       packed_hvp_kernel, row_gather,
                                       row_scatter)
    from hpsdf_tpu_torch.build import fit_points_kernel, fit_project_kernel
    from hpsdf_tpu_torch.continuity import (_chunk_launch, cg_direction,
                                            cg_matvec, cg_matvec_rows,
                                            cg_update, cg_update_rows)
    from hpsdf_tpu_torch.inverse import (inverse_loss_kernel,
                                         inverse_points_kernel,
                                         inverse_vjp_kernel)
    from hpsdf_tpu_torch.mesh import (closest_bvh, closest_tri_tiles,
                                      hybrid_closest,
                                      signed_from_best_kernel)
    from hpsdf_tpu_torch.query import (coeff_scatter_grad_kernel,
                                       coeff_scatter_kernel,
                                       coeff_scatter_nodes_kernel,
                                       node_buckets_kernel, query_kernel,
                                       query_nodes_kernel, query_vjp_kernel)
    from hpsdf_tpu_torch.render import cone_kernel, march_kernel
    return {"closest_tri": (closest_tri_tiles, "launches"),
            "hybrid": (hybrid_closest, "launches"),
            "bvh_walk": (closest_bvh, "launches"),
            "query": (query_kernel, "launches"),
            "query_leaf": (query_kernel, "leaf_launches"),
            "row_gather": (row_gather, "launches"),
            "packed_eval": (packed_eval_kernel, "launches"),
            "packed_eval_normals": (packed_eval_kernel, "grad_launches"),
            "packed_eval_save": (packed_eval_kernel, "save_launches"),
            "packed_eval_raw": (packed_eval_kernel, "raw_launches"),
            "packed_eval_fused": (packed_eval_kernel, "fused_launches"),
            "packed_eval_keys": (packed_eval_kernel, "key_launches"),
            "march": (march_kernel, "launches"),
            "cone": (cone_kernel, "launches"),
            "row_scatter": (row_scatter, "launches"),
            "row_scatter_csr": (row_scatter, "csr_launches"),
            "packed_grad": (packed_grad_kernel, "launches"),
            "coeff_scatter": (coeff_scatter_kernel, "launches"),
            "query_nodes": (query_nodes_kernel, "launches"),
            "coeff_scatter_nodes": (coeff_scatter_nodes_kernel, "launches"),
            "node_buckets": (node_buckets_kernel, "launches"),
            "cg_matvec": (cg_matvec, "launches"),
            "cg_update": (cg_update, "launches"),
            "cg_chunk": (_chunk_launch, "launches"),
            "cg_matvec_rows": (cg_matvec_rows, "launches"),
            "cg_update_rows": (cg_update_rows, "launches"),
            "cg_direction": (cg_direction, "launches"),
            "signed_from_best": (signed_from_best_kernel, "launches"),
            "inverse_points": (inverse_points_kernel, "launches"),
            "inverse_loss": (inverse_loss_kernel, "launches"),
            "inverse_vjp": (inverse_vjp_kernel, "launches"),
            "fit_points": (fit_points_kernel, "launches"),
            "fit_project": (fit_project_kernel, "launches"),
            "query_vjp": (query_vjp_kernel, "launches"),
            "query_vjp_hess": (query_vjp_kernel, "hess_launches"),
            "query_vjp_centre": (query_vjp_kernel, "centre_launches"),
            "coeff_scatter_grad": (coeff_scatter_grad_kernel, "launches"),
            "packed_hvp": (packed_hvp_kernel, "launches"),
            "packed_grad_form2": (packed_grad_kernel, "form2_launches")}


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


# the port's own functions a build's time is split by (module, attribute,
# phase): the fit loop's, then the continuity post-process's
FIT_PHASES = (("build", "_fit", "fit"), ("build", "fit_points", "points"),
              ("build", "_fit_impl", "projection"), ("build", "pack", "pack"))
SLICE_PHASES = FIT_PHASES + (("mesh.sdf", "_signed_from_best", "sign"),)
CONTINUITY_PHASES = (
    ("continuity", "enforce_continuity", "continuity"),
    ("continuity", "leaf_face_pairs", "face pairs"),
    ("continuity", "face_operator", "operator"),
    ("continuity", "_numeric_entries", "numeric"),
    ("continuity", "_analytic_entries", "analytic"),
    ("continuity", "assemble_face_matrix", "assembly"),
    ("continuity", "_put", "upload"), ("continuity", "cg_solve", "solve"))


@contextlib.contextmanager
def split_build(phases=FIT_PHASES):
    """While the block runs, each function of ``phases`` is timed by a
    ``profiling.PhaseTimer`` phase (synchronised before it starts and when
    its result is ready), and so is F inside each fit call (``_fit``'s
    first argument). Yields (timer, calls): calls[phase] holds the last
    call's (args, kwargs, result), calls[(phase, "largest")] that of the
    call whose first tensor argument has the most rows, and for K6's two
    phases calls[(phase, "largest", degree)] that of each degree's."""
    from unittest import mock

    from hpsdf_tpu_torch import profiling
    timer = profiling.PhaseTimer()
    calls = {}

    def timed(name, fn, pre=None):
        def call(*args, **kw):
            if pre is not None:
                args = pre(args)
            sync()
            with timer.phase(name) as out:
                res = fn(*args, **kw)
                out.append(res)
            calls[name] = (args, kw, res)
            rows = next((a.shape[0] for a in args
                         if isinstance(a, torch.Tensor)), 0)
            if rows >= calls.get((name, "rows"), -1):
                calls[(name, "rows")] = rows
                calls[(name, "largest")] = (args, kw, res)
            if name in ("points", "projection"):       # by degree, args[2]
                key = (name, "largest", args[2])
                if rows >= calls.get((name, "rows", args[2]), -1):
                    calls[(name, "rows", args[2])] = rows
                    calls[key] = (args, kw, res)
            return res
        return call

    def time_F(args):
        return (timed("F", args[0]),) + tuple(args[1:])

    with contextlib.ExitStack() as stack:
        for mod, attr, name in phases:
            m = importlib.import_module(f"hpsdf_tpu_torch.{mod}")
            fn = timed(name, getattr(m, attr),
                       time_F if attr == "_fit" else None)
            stack.enter_context(mock.patch.object(m, attr, fn))
        yield timer, calls


def fit_split(timer, build_s):
    """A build's seconds by phase (``split_build``): F; the f64 projection;
    point generation and the host<->device copies (the fit calls less F
    and the projection); packing the tree onto the device; the
    continuity post-process where it ran; and the host topology, the rest."""
    t = timer.times
    fit, F, proj = t.get("fit", 0.0), t.get("F", 0.0), t.get("projection", 0.0)
    pack, cont = t.get("pack", 0.0), t.get("continuity", 0.0)
    return {"instrumented_build_s": build_s, "F_s": F, "projection_s": proj,
            "points_and_copies_s": fit - F - proj,
            "points_s": t.get("points", 0.0), "pack_s": pack,
            "continuity_s": cont,
            "host_topology_s": build_s - fit - pack - cont,
            "fit_calls": timer.counts.get("fit", 0)}


def split_again(build, phases=FIT_PHASES):
    """``build()`` once more under ``split_build``, after the run whose
    seconds a user sees: the split's synchronisations stay out of those.
    Returns (fit_split's dict, the timer, calls, build()'s result)."""
    sync()
    with split_build(phases) as (timer, calls):
        t0 = time.perf_counter()
        res = build()
        sync()
        build_s = time.perf_counter() - t0
    return fit_split(timer, build_s), timer, calls, res


def split_text(d):
    return ", ".join(f"{k[:-2].replace('_', ' ')} {v:.3f} s"
                     for k, v in d.items() if k.endswith("_s"))


def phase_slice(mesh, bvh, cfg, n_query, out_path, seed=1):
    """The main path once; returns (tree, launches, the largest F batch's
    points, a second build's split with K14 and with the sign as before
    it, ``sign_split``)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch.mesh import mesh_sdf
    from hpsdf_tpu_torch.mesh import sdf as TS

    dev = bvh.tri_rows.device
    F = mesh_sdf(mesh, bvh)                       # method "auto"
    check(F.method == "tiles", f"mesh_sdf auto picked {F.method}")
    samples, f_s = [0], [0.0]
    largest = [torch.empty((0, 3))]

    def F_counted(pts):
        samples[0] += pts.shape[0]
        if pts.shape[0] > largest[0].shape[0]:
            largest[0] = pts
        sync()
        t0 = time.perf_counter()
        out = F(pts)
        sync()
        f_s[0] += time.perf_counter() - t0
        return out

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.4, 0.4, (n_query, 3)), device=dev)

    reset_counts()
    sync()
    t0 = time.perf_counter()
    tree = T.build_octree(cfg, F_counted, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    vals = T.query(tree, pts)
    sync()
    query_s = time.perf_counter() - t0
    # the first call also loads K1's module; the second is the steady rate
    t0 = time.perf_counter()
    T.query(tree, pts)
    sync()
    warm_s = time.perf_counter() - t0
    vg, grads = T.query_with_gradient(tree, pts)
    sync()
    T.save(tree, out_path)
    back = T.load(out_path, device=dev)
    launches = read_counts()
    splits = sign_split(lambda: T.build_octree(cfg, F, device=dev),
                        SLICE_PHASES, TS)
    split = splits["k14"]
    splits["first_build_s"] = build_s
    splits["k6"], _, k6_calls, _ = k6_split(
        lambda: T.build_octree(cfg, F, device=dev), SLICE_PHASES)

    check(launches["closest_tri"] > 0, "P1 never launched on the main path")
    check(launches["fit_points"] > 0 and launches["fit_project"] > 0,
          f"K6 launched {launches['fit_points']} / "
          f"{launches['fit_project']} times on the main path")
    check(launches["query"] > 0, "K1 never launched on the main path")
    check(launches["signed_from_best"] > 0,
          "K14 never launched on the mesh path")
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
          f"F samples {samples[0]}, build {build_s:.3f} s (F {f_s[0]:.3f} "
          f"s of it, synchronised; split: {split_text(split)}, "
          f"{split['fit_calls']} fit calls, {split['sign_calls']} sign "
          f"calls; with the sign as before K14 (G + torch), "
          f"{split_text(splits['before'])}, G launches "
          f"{splits['before']['g_launches']} against "
          f"{split['g_launches']}; {k6_text(splits['k6'])}), query "
          f"{n_query / query_s / 1e6:.2f} Mq/s (first call), "
          f"{n_query / warm_s / 1e6:.2f} Mq/s (second), "
          f"max|query - (|p| - 0.3)| {fit_err:.3e}, gradient . radial 1% "
          f"quantile {dot_q01:.6f}, save/load bit-exact, launches "
          f"{launches}", flush=True)
    return tree, launches, largest[0], splits, k6_calls


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


def phase_times(rows, table, tree, n, seed=3):
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
        "p1": time_ms(lambda: closest_tri_tiles(rows, fpts, table), 5),
    }
    t["p1_bound"], t["p1_dense_bound"], t["p1_skipped"] = p1_bounds(
        table, fpts.shape[0])
    t.update({
        "k1_plain": time_ms(lambda: query_plain(tree, qpts), 5),
        "k1": graph_ms(lambda: query_kernel(tree, qpts, False), 20),
        "k1g_plain": time_ms(lambda: query_with_gradient_plain(tree, qpts),
                             5),
        "k1g": graph_ms(lambda: query_kernel(tree, qpts, True), 20),
    })
    # K1 reads the tree's arrays and the points once, writes the values
    # (and the gradients); its f64 operations over the f64 peak beside that
    arrays = [getattr(tree, k) for k in ("child_idx", "centre", "depth",
                                         "degree", "coeffs")]
    for key, grad, out in (("k1", False, 8), ("k1g", True, 32)):
        by_bytes = bytes_ms(*arrays, qpts, extra=out * n)
        by_ops = n * k1_ops(tree.deg_used, tree.depth_used, grad) \
            / F64_PEAK * 1e3
        t[f"{key}_bytes_bound"], t[f"{key}_ops_bound"] = by_bytes, by_ops
        t[f"{key}_bound"] = max(by_bytes, by_ops)
        t[f"{key}_bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
    # timing launches are not main-path launches
    closest_tri_tiles.launches, query_kernel.launches = counts
    return t


def k1_ops(deg, depth_used, grad):
    """f64 operations a point of K1 (csrc/query.cu), an FMA counted as two:
    C terms of one multiply and one FMA, the T = (deg+1)(deg+2)/2 pair
    products N_i(x) N_j(y), three Legendre recurrences and the folding of
    the axis norms, the frame, and three compares a descent round; with the
    gradient, eight more operations a term, two more pair products, the
    derivative recurrences and their folding, and the chain rule with the
    normalisation."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T = (deg + 1) * (deg + 2) // 2
    ops = 3 * C + T + 12 * max(deg - 1, 0) + 4 * (deg + 1) + 12 \
        + 3 * depth_used
    if grad:
        ops += 8 * C + 2 * T + 9 * max(deg - 1, 0) + 3 * (deg + 1) + 20
    return ops


def phase_g(tri_rows, seed=4):
    """G against its plain version, bit for bit, at the probe's table and at
    the mesh's triangle rows, with 2^20 indices of which some fall outside
    the table. Each shape is also timed on in-range indices beside
    torch.index_select on the same indices (the library yardstick, never
    called by the port). Returns ({shape: dict of times and the byte bound},
    max |kernel - plain|)."""
    from hpsdf_tpu_torch.accel import row_gather, row_gather_plain

    rng = np.random.default_rng(seed)
    dev = tri_rows.device
    probe = torch.as_tensor(rng.standard_normal(G_TABLE).astype(np.float32),
                            device=dev)
    out, err = {}, 0.0
    for tab in (probe, tri_rows):
        n = tab.shape[0]
        idx = torch.as_tensor(
            rng.integers(-64, n + 64, N_GATHER).astype(np.int32), device=dev)
        g_k = row_gather(tab, idx)
        g_p = row_gather_plain(tab, idx)
        oob = (idx < 0) | (idx >= n)
        shape = f"{n}x{tab.shape[1]}"
        check(bool(torch.equal(g_k, g_p)), f"G vs plain at {shape}")
        err = max(err, float((g_k - g_p).abs().max()))
        check(bool(oob.any()) and not bool(g_k[oob].any()),
              f"G zeros out of range at {shape}")
        inr = torch.as_tensor(rng.integers(0, n, N_GATHER).astype(np.int32),
                              device=dev)
        check(bool(torch.equal(row_gather(tab, inr),
                               torch.index_select(tab, 0, inr))),
              f"G vs index_select at {shape}")
        t = out[shape] = {
            "ms": time_ms(lambda: row_gather(tab, idx), 20),
            "plain_ms": time_ms(lambda: row_gather_plain(tab, idx), 20),
            "inrange_ms": time_ms(lambda: row_gather(tab, inr), 20),
            "library_ms": time_ms(lambda: torch.index_select(tab, 0, inr),
                                  20),
            "bound_ms": bytes_ms(tab, idx, extra=4 * N_GATHER * tab.shape[1])}
        print(f"[g] table {shape}, {N_GATHER} indices ({int(oob.sum())} out "
              f"of range): bit-exact, kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms | in range: kernel "
              f"{t['inrange_ms']:.4f} ms, torch.index_select "
              f"{t['library_ms']:.4f} ms | byte bound {t['bound_ms']:.4f} ms "
              f"({t['bound_ms'] / t['ms']:.1%} of it)", flush=True)
    return out, err


def phase_refdefault(dev):
    """The reference-default tree: the one on-card tree with 64-lane rows,
    a descent below the grid and the LOD march phase."""
    import hpsdf_tpu_torch as T

    centre = torch.tensor([0.25, 0.0, 0.0], dtype=torch.float64, device=dev)

    def sphere(p):
        return torch.linalg.norm(p - centre.to(p.dtype), dim=-1) - 0.5

    cfg = T.Config(target_error=1e-10, continuity=False,
                   nearness_weighting=T.NearnessWeighting.EXPONENTIAL,
                   nearness_strength=3.0, max_degree=12, max_depth=10,
                   node_capacity=600000, fit_dtype="compensated")
    sync()
    t0 = time.perf_counter()
    tree = T.build_octree(cfg, sphere, device=dev)
    sync()
    build_s = time.perf_counter() - t0
    pt = T.pack_tree(tree)
    print(f"[refdefault] nodes {tree.n_nodes}, deg_used {tree.deg_used}, "
          f"depth_used {tree.depth_used}, rows {pt.width} lanes, grid depth "
          f"{pt.grid_depth}, extra rounds {pt.extra_rounds}, build "
          f"{build_s:.3f} s", flush=True)
    return tree, pt, (centre.cpu().numpy(), 0.5)


def scaled_err(a, b):
    """max |a - b| / max(1, |b|): K2's error measure."""
    return float(((a - b) / torch.clamp(b.abs(), min=1.0)).abs().max())


def phase_k2(pt, name, sphere, seed=5):
    """K2 and K5 against their plain versions at 2^20 points straddling the
    root. Normals are compared away from the sphere's centre, where the
    field's gradient vanishes and a normal is not defined. Returns (max
    value error, min normal dot, times)."""
    from hpsdf_tpu_torch.accel import (F32_MAX, NORMALS, VALUES,
                                       normals_plain, packed_eval_kernel,
                                       query_packed_plain, values_at_plain)

    rng = np.random.default_rng(seed)
    c = np.asarray(pt.root_centre)
    half = 0.5 * np.asarray(pt.root_sizes)
    pts = torch.as_tensor(rng.uniform(c - 1.1 * half, c + 1.1 * half,
                                      (N_QUERY, 3)).astype(np.float32),
                          device=pt.device)
    v_k = packed_eval_kernel(pt, pts, VALUES, outside_max=True)
    v_p = query_packed_plain(pt, pts)
    outside = v_p == F32_MAX
    check(bool(outside.any()) and not bool(outside.all()),
          f"K2 points straddle the root ({name})")
    check(bool(torch.equal(v_k == F32_MAX, outside)),
          f"K2 sentinel positions ({name})")

    v_err = scaled_err(v_k[~outside], v_p[~outside])
    c_err = scaled_err(packed_eval_kernel(pt, pts, VALUES),
                       values_at_plain(pt, pts))
    check(max(v_err, c_err) <= K2_ATOL,
          f"K2 vs plain ({name}): {v_err:.3e}, clamped {c_err:.3e}")
    n_k = packed_eval_kernel(pt, pts, NORMALS)
    n_p = normals_plain(pt, pts)
    away = torch.linalg.norm(
        pts.double() - torch.as_tensor(sphere[0], device=pts.device),
        dim=-1) > 0.05
    dots = (n_k * n_p).sum(-1)[away]
    dot_min = float(dots.min())
    check(dot_min >= NORMAL_DOT, f"K5 normal dot ({name}): {dot_min}")
    check(bool(torch.isfinite(n_k).all()), f"K5 normals finite ({name})")
    t = {"k2": graph_ms(lambda: packed_eval_kernel(pt, pts, VALUES, True), 20),
         "k2_plain": time_ms(lambda: query_packed_plain(pt, pts), 5),
         "k5": graph_ms(lambda: packed_eval_kernel(pt, pts, NORMALS), 20),
         "k5_plain": time_ms(lambda: normals_plain(pt, pts), 5),
         # the packed rows, the grid and the points read once, the values
         # (normals) written once
         "k2_bound": bytes_ms(pt.rows, pt.grid, pts, extra=4 * N_QUERY),
         "k5_bound": bytes_ms(pt.rows, pt.grid, pts, extra=12 * N_QUERY)}
    print(f"[k2] {name}: {N_QUERY} pts ({int(outside.sum())} outside): "
          f"max|v - plain|/max(1,|v|) {v_err:.3e}, clamped {c_err:.3e}; "
          f"normals min dot {dot_min:.8f} over {int(away.sum())} pts | "
          f"K2 {t['k2']:.4f} ms, plain {t['k2_plain']:.4f} ms | K5 "
          f"{t['k5']:.4f} ms, plain {t['k5_plain']:.4f} ms", flush=True)
    return max(v_err, c_err), dot_min, t


def march_reference(pt, origins, dirs, t_max, hit_eps, max_steps,
                    step_cap=None, omega=None, lo=None):
    """K3 as it was before its redesign (csrc/check/march_reference.cu, a
    library of its own, on no path of the package), called as march_kernel
    is. Returns (t, hit, kk)."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.render import OMEGA, _inner_steps_for, _root_box

    omega = OMEGA if omega is None else omega
    dev = origins.device
    origins, dirs = origins.contiguous(), dirs.contiguous()
    B = origins.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=dev)
    hit = torch.empty(B, dtype=torch.bool, device=dev)
    kk = torch.zeros(2, dtype=torch.int32, device=dev)
    rc, half = _root_box(pt)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    box = [*(rc - half), *(rc + half), *rc, *inv]
    relax_on = omega > 1.0 and step_cap is None
    rc_ = _kernels.load_check().hpsdf_march_reference(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        None if lo is None else lo[0].data_ptr(),
        None if lo is None else lo[1].data_ptr(),
        pt.grid_depth, pt.extra_rounds, _inner_steps_for(pt),
        origins.data_ptr(), dirs.data_ptr(), B, *map(float, box),
        float(np.float32(t_max)), float(np.float32(hit_eps)), int(max_steps),
        float(np.float32(0.0 if step_cap is None else step_cap)),
        int(step_cap is not None), float(np.float32(omega)), int(relax_on),
        t.data_ptr(), hit.data_ptr(), kk.data_ptr(),
        _kernels.stream_of(origins))
    _kernels.check(_kernels.load(), rc_, "march_reference")
    return t, hit, kk


def check_k3_exact(args, kw, label, width=0):
    """K3 against the kernel it replaced, on the same inputs: t, hit and kk
    bit for bit. ``width``: the image's, as render gives it to K3 (0: index
    order). Returns K3's (t, hit, kk)."""
    from hpsdf_tpu_torch.render import march_kernel

    got = march_kernel(*args, **kw, width=width)
    want = march_reference(*args, **kw)
    sync()
    for g, w, what in zip(got, want, ("t", "hit", "kk")):
        check(bool(torch.equal(g, w)),
              f"K3 vs the kernel it replaced, {what} at {label}: "
              f"{int((g != w).sum())} of {g.numel()} differ")
    return got


def k3_ops(deg, lo=False):
    """f32 operations a step of K3 (csrc/march.cu), an FMA counted as two:
    the ray's point and its leaf frame with the in-leaf test (24), three
    Legendre recurrences (12 (deg - 1)), C terms of one multiply and one
    FMA over the T = (deg+1)(deg+2)/2 pair products L_i(x) L_j(y), and the
    step logic (18: the safe and relaxed advance, the overlap, hit and
    escape tests, the rollback); an LOD step is a degree-2 step with the
    error bound taken off (2 more)."""
    if lo:
        return k3_ops(2) + 2
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T = (deg + 1) * (deg + 2) // 2
    return 24 + 12 * max(deg - 1, 0) + 3 * C + T + 18


def simt_efficiency(work, width, tile):
    """Sum of the rays' work over 32 x the sum of each warp's largest, with
    a warp on a `tile` = (tw, th) block of pixels of an image `width` wide
    (tw th = 32; (32, 1) is index order)."""
    tw, th = tile
    w = work.reshape(-1, th, width // tw, tw).permute(0, 2, 1, 3)
    w = w.reshape(-1, 32).double()
    return float(w.sum() / (32.0 * w.max(dim=1).values.sum()))


STEP_EDGES = (0, 1, 5, 9, 17, 33, 65, 129)    # lower edges of steps_hist


def k3_stats(stats, width, deg):
    """What the rays of a march did, from K3's per-ray counts (render.STATS):
    steps, relocations that found the row the ray held, the SIMT efficiency
    of 32x1 strips and 8x4 tiles, and the f32 operations of these steps."""
    st = stats.long()
    steps = st[:, 0] + st[:, 1]
    relocs = st[:, 2] + st[:, 3]
    hist = [int(((steps >= lo) & (steps < hi)).sum())
            for lo, hi in zip(STEP_EDGES, STEP_EDGES[1:] + (1 << 30,))]
    out = {
        "steps": int(steps.sum()), "steps_lo": int(st[:, 0].sum()),
        "steps_full": int(st[:, 1].sum()),
        "steps_mean": float(steps.double().mean()),
        "steps_max": int(steps.max()),
        "steps_hist": hist,
        "relocations": int(relocs.sum()),
        "kept_share": float((st[:, 4] + st[:, 5]).sum()) / float(relocs.sum()),
        "longest_ray": int(torch.argmax(relocs)),
        "longest_rounds": int(relocs.max()),
        "ops": int(st[:, 0].sum()) * k3_ops(deg, lo=True)
        + int(st[:, 1].sum()) * k3_ops(deg),
    }
    for key, work in (("steps", steps), ("rounds", relocs)):
        out[f"simt_strips_by_{key}"] = simt_efficiency(work, width, (32, 1))
        out[f"simt_tiles_by_{key}"] = simt_efficiency(work, width, (8, 4))
    return out


def phase_k3(pt, name, sphere, lod_expected, smi):
    """K3 at 1024^2 rays from (0, 0, -1.8), T_MAX 5 (bench.py's protocol),
    and at every 4th of those rays with omega 1 and with a step cap:
    against the plain march (hits must also lie on the analytic sphere) and,
    bit for bit, against the kernel it replaced, with a warp on an 8x4 tile
    (as render gives it) and in index order. Then what the rays did, from
    the kernel's per-ray counts; the kernel and the one it replaced timed in
    turns in CUDA graphs; the bound on these rays' work; and the serial
    floor, the longest ray alone. Returns (max t error on common hits,
    times and counts, kk, hit fraction)."""
    from hpsdf_tpu_torch.render import (HIT_EPS, MAX_STEPS, _march_block,
                                        camera_rays, march_kernel)

    side = RAYS_SIDE
    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=side,
                       height=side, device=pt.device)
    lo = pt.lo
    check((lo is not None) == lod_expected, f"LOD tables ({name})")
    args = (pt, o, d, T_MAX, HIT_EPS, MAX_STEPS)
    t_k, h_k, kk_k = check_k3_exact(args, dict(lo=lo), f"{name}, 8x4 tiles",
                                    width=side)
    check_k3_exact(args, dict(lo=lo), f"{name}, index order")
    *_, stats = march_kernel(*args, lo=lo, with_stats=True, width=side)
    sync()
    t0 = time.perf_counter()
    t_p, h_p, kk_p, stats_p = _march_block(*args, lo=lo, with_stats=True)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    agree = float((h_k == h_p).float().mean())
    both = h_k & h_p
    check(agree >= HIT_AGREE, f"K3 hit agreement ({name}): {agree}")
    check(bool(both.any()), f"K3 hits ({name})")
    t_err = float((t_k[both] - t_p[both]).abs().max())
    check(t_err <= T_ATOL, f"K3 t on common hits ({name}): {t_err}")
    kk = [int(x) for x in kk_k.cpu()]
    check(kk == [int(x) for x in kk_p],
          f"K3 rounds kk ({name}): kernel {kk}, plain {kk_p.tolist()}")
    if lod_expected:
        check(kk[0] > 0, f"K3 LOD phase ran ({name}): kk {kk}")
    p = (o + t_k[:, None] * d)[h_k].double()
    c = torch.as_tensor(sphere[0], device=p.device)
    r_err = float((torch.linalg.norm(p - c, dim=-1) - sphere[1]).abs().max())
    check(r_err <= SPHERE_T_ATOL, f"K3 hits on the sphere ({name}): {r_err}")
    # the rays' counts: the kernel's against the plain march's (steps and
    # relocations; the two tell kept rows apart differently)
    st = k3_stats(stats, side, pt.deg_used)
    same = float((stats[:, :4] == stats_p[:, :4]).all(dim=1).float().mean())
    check(same >= HIT_AGREE, f"K3 per-ray counts vs plain ({name}): {same}")
    check([int(stats[:, 2].max()), int(stats[:, 3].max())] == kk,
          f"K3 per-ray relocations against kk ({name})")
    # the kernel's other branches, at 256^2: no over-relaxation, and a step
    # cap (which also turns relaxation off)
    o4, d4 = o.reshape(side, side, 3)[::4, ::4].reshape(-1, 3), \
        d.reshape(side, side, 3)[::4, ::4].reshape(-1, 3)
    for kw in (dict(omega=1.0), dict(step_cap=0.02)):
        a4 = (pt, o4, d4, T_MAX, HIT_EPS, MAX_STEPS)
        tv_k, hv_k, _ = check_k3_exact(a4, dict(lo=lo, **kw),
                                       f"{name} with {kw}", width=side // 4)
        tv_p, hv_p, _ = _march_block(*a4, lo=lo, **kw)
        bv = hv_k & hv_p
        check(float((hv_k == hv_p).float().mean()) >= HIT_AGREE
              and bool(bv.any())
              and float((tv_k[bv] - tv_p[bv]).abs().max()) <= T_ATOL,
              f"K3 vs plain with {kw} ({name})")
        t_err = max(t_err, float((tv_k[bv] - tv_p[bv]).abs().max()))
    # times, in turns in CUDA graphs: the kernel it replaced (on origins
    # copied beforehand), K3 as render calls it, K3 in index order
    oc = o.contiguous()
    forms = {"reference": lambda: march_reference(pt, oc, d, *args[3:],
                                                  lo=lo),
             "tiles": lambda: march_kernel(*args, lo=lo, width=side),
             "strips": lambda: march_kernel(*args, lo=lo)}
    ms = {k: [] for k in forms}
    for _ in range(2):
        for k, fn in forms.items():
            ms[k].append(graph_ms(fn, 10))
    ms = {k: min(v) for k, v in ms.items()}
    # the bound: the packed rows, the grid, the LOD tables, the origin and
    # the directions read once, t and hit written once; and these rays'
    # steps as f32 operations
    n = o.shape[0]
    by_bytes = bytes_ms(pt.rows, pt.grid, d, *(lo or ()), extra=12 + 5 * n)
    by_ops = st["ops"] / F32_PEAK * 1e3
    # the serial floor: the longest ray alone, beside a ray that misses the
    # root (a launch and the fill of kk)
    j = st["longest_ray"]
    away = torch.tensor([[0.0, 1.0, 0.0]], device=pt.device)
    one, miss = (min(graph_ms(lambda: march_kernel(
        pt, o[j:j + 1], dj, *args[3:], lo=lo), 10) for _ in range(2))
        for dj in (d[j:j + 1], away))
    frac = float(h_k.float().mean())
    out = {"k3": ms["tiles"], "k3_strips": ms["strips"],
           "k3_reference": ms["reference"], "k3_plain": plain_ms,
           "mrays": n / (ms["tiles"] * 1e-3) / 1e6,
           "k3_bound": max(by_bytes, by_ops),
           "k3_bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "k3_bytes_bound": by_bytes, "k3_ops_bound": by_ops,
           "k3_one_ray": one, "k3_miss": miss,
           "k3_serial_floor": one - miss, "stats": st}
    print(f"[k3] {name}: {side}^2 rays, hit fraction {frac:.4f}, hit "
          f"masks agree {agree:.6f}, max|t - plain| on common hits (with "
          f"the omega 1 and step-cap runs) "
          f"{t_err:.3e}, max|r_hit - R| {r_err:.3e}, kk kernel {kk} plain "
          f"{[int(x) for x in kk_p]}, per-ray counts equal the plain "
          f"march's on {same:.6f} of rays; t, hit and kk equal the kernel "
          f"it replaced bit for bit (tiles, index order, omega 1, step cap) "
          f"| steps {st['steps']} ({st['steps_lo']} LOD), mean "
          f"{st['steps_mean']:.3f}, max {st['steps_max']}, rays by steps "
          f"from {list(STEP_EDGES)}: {st['steps_hist']}; relocations "
          f"{st['relocations']}, {st['kept_share']:.4f} found the row held; "
          f"SIMT efficiency by steps, 32x1 strips "
          f"{st['simt_strips_by_steps']:.4f}, 8x4 tiles "
          f"{st['simt_tiles_by_steps']:.4f} (by rounds "
          f"{st['simt_strips_by_rounds']:.4f}, "
          f"{st['simt_tiles_by_rounds']:.4f})", flush=True)
    print(f"[k3] {name}: {smi} | in CUDA graphs (best of 2 turns): the "
          f"kernel it replaced {ms['reference']:.4f} ms, K3 "
          f"{ms['tiles']:.4f} ms ({out['mrays']:.2f} Mrays/s; a warp on an "
          f"8x4 tile), {ms['strips']:.4f} ms in index order; plain "
          f"{plain_ms:.1f} ms (one run) | bound {out['k3_bound']:.5f} ms "
          f"({out['k3_bound_by']}: {st['ops']} f32 operations, "
          f"{k3_ops(pt.deg_used)} a step and {k3_ops(2, lo=True)} an LOD "
          f"step; bytes {by_bytes:.5f} ms), "
          f"{out['k3_bound'] / ms['tiles']:.1%} of it", flush=True)
    print(f"[k3] {name}: serial floor, not the bound: the longest ray "
          f"({st['longest_rounds']} rounds) alone {one:.4f} ms, a ray that "
          f"misses the root {miss:.4f} ms, so "
          f"{(one - miss) / st['longest_rounds'] * 1e3:.3f} us a round and "
          f"{one - miss:.4f} ms, {(one - miss) / ms['tiles']:.1%} of K3's "
          f"time", flush=True)
    return t_err, out, kk, frac


def phase_render(tree, out_dir):
    """The render path of examples/end_to_end.py once, on the card: carve,
    render, slice, save/load. Then K3, K4 and K5 are held against their
    plain versions on the carved tree and the render's own rays (K4 also
    against the kernel it replaced, bit for bit, and timed beside it and
    K3 with and without its starts). Returns (launches, times, hit
    fraction, K3 max t error on common hits, K5 min normal dot, the
    carve's largest F batch as as_sdf's packed F reads it, the carved
    tree's packed tables, the render's hit points, the carved tree)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch.accel import (NORMALS, normals_plain,
                                       packed_eval_kernel)
    from hpsdf_tpu_torch.render import (CONE_TILE, HIT_EPS, MAX_STEPS,
                                        _march_block, cone_start_plain,
                                        march_kernel)
    from hpsdf_tpu_torch.viz import write_bmp

    def box(p):
        q = p.abs() - CARVE_HALF
        return (torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
                + torch.clamp(q.amax(dim=-1), max=0.0))

    def carve(p):
        return torch.maximum(torch.linalg.norm(p, dim=-1) - 0.3, -box(p))

    dev = tree.device
    view = dict(eye=(0.5, 0.4, -1.6), look_at=(0.0, 0.0, 0.0), width=512,
                height=512)
    largest = [torch.empty((0, 3))]

    def minus_box(p):
        # the carve's F sees the same points as as_sdf's packed F
        if p.shape[0] > largest[0].shape[0]:
            largest[0] = p
        return -box(p)

    reset_counts()
    sync()
    t0 = time.perf_counter()
    carved = T.intersect_sdf(tree, minus_box)
    sync()
    carve_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, depth, hit = T.render_image(carved, t_max=T_MAX, **view)
    sync()
    render_s = time.perf_counter() - t0
    write_bmp(os.path.join(out_dir, "chip_smoke_render.bmp"),
              (img.clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy())
    T.output_function_slice(carved, os.path.join(out_dir,
                                                 "chip_smoke_slice.bmp"),
                            z=0.0, resolution=512)
    path = os.path.join(out_dir, "chip_smoke_carved.npz")
    T.save(carved, path)
    back = T.load(path, device=dev)
    sync()
    launches = read_counts()
    k6s = k6_split(lambda: T.intersect_sdf(tree, minus_box), FIT_PHASES)[0]
    split = k6s["k6"]

    for k in ("row_gather", "packed_eval", "packed_eval_normals", "march",
              "query"):
        check(launches[k] > 0, f"{k} never launched on the render path")
    check(launches["packed_eval"] > launches["packed_eval_normals"],
          "K2 (values) never launched on the render path")
    for k in ("child_idx", "centre", "depth", "degree", "coeffs"):
        check(bool(torch.equal(getattr(back, k), getattr(carved, k))),
              f"carved save/load {k} bit-exact")
    check(img.shape == (512, 512, 3) and bool(torch.isfinite(img).all()),
          "render image finite")
    frac = float(hit.float().mean())
    check(0.02 < frac < 0.9, f"render hit fraction {frac}")
    pts = torch.as_tensor(np.random.default_rng(6).uniform(
        -0.45, 0.45, (N_QUERY, 3)), device=dev)
    csg_err = float((T.query(carved, pts) - carve(pts)).abs().max())
    check(csg_err < CSG_TOL, f"carved tree vs analytic carve: {csg_err}")
    o, dirs = T.camera_rays(view["eye"], view["look_at"],
                            width=view["width"], height=view["height"],
                            device=dev)
    h_r = hit.reshape(-1)
    ph = (o + depth.reshape(-1)[:, None] * dirs)[h_r]
    # the carve's edges are fit to the CSG tolerance, its faces far better
    surf = carve(ph.double()).abs()
    surf_err, surf_q99 = float(surf.max()), float(torch.quantile(surf, 0.99))
    check(surf_err < CSG_TOL and surf_q99 < SPHERE_T_ATOL,
          f"render hits on the analytic carve: max {surf_err}, 99% "
          f"{surf_q99}")

    # K3 and K5 on the tree and rays render_image gave them, against the
    # plain march and normals (these launches come after the counts)
    pt = T.pack_tree(carved)
    lo = pt.lo
    args = (pt, o, dirs, T_MAX, HIT_EPS, MAX_STEPS)
    t_k, h_k, kk_k = check_k3_exact(args, dict(lo=lo), "the render's rays",
                                    width=view["width"])
    check_k3_exact(args, dict(lo=lo), "the render's rays, index order")
    t_p, h_p, kk_p = _march_block(*args, lo=lo)
    # render runs the cone prepass (K4) once on a tree without LOD tables,
    # and K3 from its starts
    check(launches["cone"] == (0 if lo is not None else 1),
          f"K4 launches on the render path: {launches['cone']}")
    tiles = (view["height"], view["width"], CONE_TILE)
    t0 = None
    if lo is None:
        t0, rounds = check_k4_exact(pt, o, dirs, T_MAX, tiles, lo,
                                    "the render's rays")
        _, rounds_p = cone_start_plain(pt, o, dirs, T_MAX, HIT_EPS, tiles,
                                       with_stats=True)
        k = check_k4_rounds(rounds, rounds_p, "the render's rays")
    t_c, h_c, _ = march_kernel(*args, lo=lo, width=view["width"], t0=t0)
    check(bool(torch.equal(h_c, h_r))
          and bool(torch.equal(t_c[h_c], depth.reshape(-1)[h_r])),
          "render_image's hits and depth are K4's and K3's")
    cone, cone_ms = "no cone (LOD tables)", {}
    if t0 is not None:
        # the carve's fit is no metric field (it holds the CSG tolerance, and
        # its hits are held to the analytic carve above), and its flat faces
        # meet many rays at a glancing angle, where t within the hit band
        # spans far more than T_ATOL: the render path's own standard for K3
        # against the plain march bounds the rays a start changes
        cone = cone_text(cone_vs_plain(
            args, lo, tiles, t0, t_c, h_c, t_p, h_p, "the carved tree",
            K4_CHANGED_SHARE_CARVE))
        cone_ms = k4_times(pt, o, dirs, tiles, lo, t0, view["width"])
        cone += (f"; K4's t0 equal to the kernel it replaced bit for bit, "
                 f"per-tile rounds equal to plain (k {k}) | in CUDA graphs "
                 f"(best of 2 turns): K4 {cone_ms['k4']:.4f} ms, the kernel "
                 f"it replaced {cone_ms['reference']:.4f} ms, K3 from K4's "
                 f"starts {cone_ms['k3_t0']:.4f} ms, K3 alone "
                 f"{cone_ms['k3']:.4f} ms")
    agree = float((h_k == h_p).float().mean())
    both = h_k & h_p
    check(agree >= HIT_AGREE and bool(both.any()),
          f"K3 hit agreement on the carved tree: {agree}")
    t_err = float((t_k[both] - t_p[both]).abs().max())
    check(t_err <= T_ATOL, f"K3 t on common hits, carved tree: {t_err}")
    kk = [int(x) for x in kk_k.cpu()]
    check(kk == [int(x) for x in kk_p],
          f"K3 rounds kk, carved tree: kernel {kk}, plain {kk_p.tolist()}")
    p = o[both] + t_k[both, None] * dirs[both]
    n_k = packed_eval_kernel(pt, p, NORMALS)
    n_p = normals_plain(pt, p)
    dot_min = float((n_k * n_p).sum(-1).min())
    check(dot_min >= NORMAL_DOT, f"K5 normal dot on the carved tree: "
          f"{dot_min}")
    # the image is headlight shading of K5's normals at render's hits
    shade = 0.15 + 0.85 * torch.clamp(
        -(packed_eval_kernel(pt, ph, NORMALS) * dirs[h_r]).sum(-1), min=0.0)
    shade_err = float((img.reshape(-1, 3)[h_r] - shade[:, None]).abs().max())
    check(shade_err <= 1e-6, f"render shading vs K5 normals: {shade_err}")
    print(f"[render] carve {carved.n_nodes} nodes in {carve_s:.3f} s "
          f"(split: {split_text(split)}, {split['fit_calls']} fit calls; "
          f"{k6_text(k6s)}; deg_used {pt.deg_used}, rows {pt.width} lanes, grid depth "
          f"{pt.grid_depth}, extra rounds {pt.extra_rounds}, LOD "
          f"{'on' if lo is not None else 'off'}), render 512^2 in "
          f"{render_s:.3f} s (first call), hit fraction {frac:.4f}, "
          f"max|query - carve| {csg_err:.3e}, |carve(hit)| max "
          f"{surf_err:.3e} 99% {surf_q99:.3e}; K3 vs plain on these rays: "
          f"hit masks agree {agree:.6f}, max|t - plain| on common hits "
          f"{t_err:.3e}, kk kernel {kk} plain {kk_p.tolist()}, equal to the "
          f"kernel it replaced bit for bit; render's own march: {cone}; "
          f"K5 normals "
          f"min dot {dot_min:.8f} over {int(both.sum())} hits; images and "
          f"tree under {os.path.relpath(out_dir)}, save/load bit-exact, "
          f"launches {launches}", flush=True)
    return (launches, {"carve_s": carve_s, "render_s": render_s,
                       "cone": cone_ms, "split": split, "k6_split": k6s},
            frac,
            t_err, dot_min, largest[0].to(torch.float32), pt, ph, carved)


def phase_k2_main(pt_s, carve_pts, pt_c, ph):
    """K2 and K5 where the main path runs them: K2 on the carve's largest F
    batch with the slice tree's packed tables (the points come cell by
    cell, so a warp's lanes mostly read one row), K5 on the render's hit
    points with the carved tree's (pixel order). Each against its plain
    version, timed beside its byte bound. Returns (max value error, min
    normal dot, times)."""
    from hpsdf_tpu_torch.accel import (NORMALS, VALUES, normals_plain,
                                       packed_eval_kernel, values_at_plain)

    v_err = scaled_err(packed_eval_kernel(pt_s, carve_pts, VALUES),
                       values_at_plain(pt_s, carve_pts))
    check(v_err <= K2_ATOL, f"K2 vs plain at the carve batch: {v_err:.3e}")
    n_k = packed_eval_kernel(pt_c, ph, NORMALS)
    dot_min = float((n_k * normals_plain(pt_c, ph)).sum(-1).min())
    check(dot_min >= NORMAL_DOT, f"K5 normal dot at the render's hits: "
          f"{dot_min}")
    n_c, n_h = carve_pts.shape[0], ph.shape[0]
    t = {"carve_points": n_c,
         "carve_ms": graph_ms(lambda: packed_eval_kernel(pt_s, carve_pts,
                                                         VALUES), 20),
         "carve_plain_ms": time_ms(lambda: values_at_plain(pt_s, carve_pts),
                                   5),
         "carve_bound_ms": bytes_ms(pt_s.rows, pt_s.grid, carve_pts,
                                    extra=4 * n_c),
         "hits": n_h,
         "hits_normals_ms": graph_ms(lambda: packed_eval_kernel(pt_c, ph,
                                                                NORMALS), 20),
         "hits_normals_plain_ms": time_ms(lambda: normals_plain(pt_c, ph),
                                          5),
         "hits_normals_bound_ms": bytes_ms(pt_c.rows, pt_c.grid, ph,
                                           extra=12 * n_h)}
    print(f"[k2-main] K2 at the carve's largest F batch ({n_c} pts, slice "
          f"tree): max|v - plain|/max(1,|v|) {v_err:.3e}, kernel "
          f"{t['carve_ms']:.4f} ms, plain {t['carve_plain_ms']:.4f} ms, byte "
          f"bound {t['carve_bound_ms']:.4f} ms | K5 at the render's {n_h} "
          f"hits (carved tree): min dot {dot_min:.8f}, kernel "
          f"{t['hits_normals_ms']:.4f} ms, plain "
          f"{t['hits_normals_plain_ms']:.4f} ms, byte bound "
          f"{t['hits_normals_bound_ms']:.4f} ms", flush=True)
    return v_err, dot_min, t


def centre_ray_starts(t_p, h_p, tiles):
    """The starts of a broken cone, one that certifies only its tile's
    centre ray: that ray's own hit in the plain march (t_max + 1 where it
    missed), for every ray of the tile."""
    H, W, T = tiles
    c = (T // 2) * T + T // 2

    def centre(x):
        return x.reshape(H // T, T, W // T, T).permute(0, 2, 1, 3) \
            .reshape(-1, T * T)[:, c]

    escape = float(np.float32(T_MAX) + np.float32(1.0))
    s = torch.where(centre(h_p), centre(t_p), escape)
    return s.reshape(H // T, 1, W // T, 1).expand(H // T, T, W // T, T) \
        .reshape(-1).contiguous()


def march_change(t0, t, h, t_p, h_p):
    """What a march from starts t0 (t, h) changed against the plain march
    without a cone (t_p, h_p): starts past a plain hit, hits dropped and
    added, common hits stopped earlier or later by more than T_ATOL, and
    max |t - t_p| on the other common hits."""
    both = h & h_p
    dt = t - t_p
    far = both & (dt.abs() > T_ATOL)
    near = (dt.abs())[both & ~far]
    out = {"past": int((h_p & (t0 > t_p)).sum()),
           "dropped": int((h_p & ~h).sum()), "added": int((h & ~h_p).sum()),
           "earlier": int((far & (dt < 0)).sum()),
           "later": int((far & (dt > 0)).sum()),
           "t_err": float(near.max()) if near.numel() else 0.0}
    out["changed"] = (out["dropped"] + out["added"] + out["earlier"]
                      + out["later"])
    return out


def cone_vs_plain(args, lo, tiles, t0, t_c, h_c, t_p, h_p, label, share):
    """K4 + K3 (starts t0; t_c, h_c) against the plain march without a cone
    (t_p, h_p) on the rays of ``args`` = (pt, o, d, t_max, hit_eps,
    max_steps). Checks that no start passes a plain hit; that K4 + K3 give
    what the witness gives, the plain cone and the plain march from its
    starts (hit masks equal on HIT_AGREE of the rays, t within T_ATOL on
    common hits: K3's standard against its plain version), so that what
    the cone changes is the cone's doing and not the kernels'; and that the
    rays a start changed are at most ``share`` of all, while a broken cone
    (``centre_ray_starts``, K3 from its starts) changes more. Returns
    ``march_change`` of K4 + K3, with the witness's and the broken cone's
    and the rays both K4 + K3 and the witness changed."""
    from hpsdf_tpu_torch.render import (_march_block, cone_start_plain,
                                        march_kernel)

    pt, o, d, t_max, hit_eps, max_steps = args
    width = tiles[1]
    got = march_change(t0, t_c, h_c, t_p, h_p)
    t0_w = cone_start_plain(pt, o, d, t_max, hit_eps, tiles, lo=lo,
                            max_steps=max_steps)
    t_w, h_w, _ = _march_block(*args, lo=lo, t_start=t0_w)
    got["witness"] = march_change(t0_w, t_w, h_w, t_p, h_p)
    both = h_c & h_w
    w_agree = float((h_c == h_w).float().mean())
    w_err = float((t_c - t_w)[both].abs().max()) if bool(both.any()) else 0.0
    moved_k = (h_c != h_p) | (h_c & h_p & ((t_c - t_p).abs() > T_ATOL))
    moved_w = (h_w != h_p) | (h_w & h_p & ((t_w - t_p).abs() > T_ATOL))
    got["same_as_witness"] = int((moved_k & moved_w).sum())
    t0_b = centre_ray_starts(t_p, h_p, tiles)
    t_b, h_b, _ = march_kernel(*args, lo=lo, width=width, t0=t0_b)
    got["broken"] = march_change(t0_b, t_b, h_b, t_p, h_p)
    n = h_p.numel()
    check(got["past"] == 0 and got["witness"]["past"] == 0
          and w_agree >= HIT_AGREE and w_err <= T_ATOL
          and got["changed"] <= share * n
          and got["witness"]["changed"] <= share * n
          and got["broken"]["changed"] > share * n,
          f"K4 + K3 vs the plain march without a cone ({label}): {got}; "
          f"against the plain cone and march, hit masks agree {w_agree}, "
          f"max|t - witness| {w_err}; the limit {share * n} rays")
    return got


def cone_text(c):
    """[k4]'s words for cone_vs_plain's result."""
    w, b = c["witness"], c["broken"]
    return (f"K4 + K3 vs the plain march without a cone: no start past a "
            f"plain hit, {c['dropped']} hits dropped and {c['added']} added, "
            f"{c['earlier']} common hits stopped earlier and {c['later']} "
            f"later by more than {T_ATOL}, max|t - plain| on the others "
            f"{c['t_err']:.3e}; the plain cone and march (witness): "
            f"{w['dropped']} dropped, {w['added']} added, {w['earlier']} "
            f"earlier, {w['later']} later, {c['same_as_witness']} of these "
            f"rays the same as the kernels'; a cone certifying only its "
            f"centre ray: {b['past']} starts past a hit, {b['changed']} rays "
            f"changed ({b['dropped']} dropped, {b['added']} added, "
            f"{b['earlier']} earlier, {b['later']} later)")


def cone_reference(pt, origins, dirs, t_max, hit_eps, tiles, lo=None,
                   max_steps=None):
    """K4 as it was before its redesign (csrc/check/cone_reference.cu, a
    warp a tile, in a library of its own on no path of the package),
    called as cone_kernel is. Returns t0."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.render import CONE_CAP, MAX_STEPS, _root_box

    max_steps = MAX_STEPS if max_steps is None else max_steps
    H, W, T = tiles
    shared = origins.shape[0] > 1 and origins.stride() == (0, 1)
    if not shared:
        origins = origins.contiguous()
    dirs = dirs.contiguous()
    t0 = torch.empty(origins.shape[0], dtype=torch.float32,
                     device=origins.device)
    rc, half = _root_box(pt)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    box = np.concatenate([rc - half, rc + half, rc, inv]).astype(np.float32)
    rc_ = _kernels.load_check().hpsdf_cone_reference(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        None if lo is None else lo[0].data_ptr(),
        None if lo is None else lo[1].data_ptr(),
        pt.grid_depth, pt.extra_rounds, origins.data_ptr(),
        0 if shared else 3, dirs.data_ptr(), H, W, T, box.ctypes.data,
        float(np.float32(t_max)), float(np.float32(hit_eps)),
        min(CONE_CAP, int(max_steps)), t0.data_ptr(),
        _kernels.stream_of(dirs))
    _kernels.check(_kernels.load(), rc_, "cone_reference")
    return t0


def check_k4_exact(pt, o, d, t_max, tiles, lo, label):
    """K4 against the kernel it replaced, on the same inputs: t0 bit for
    bit. Returns K4's (t0, per-tile rounds)."""
    from hpsdf_tpu_torch.render import HIT_EPS, cone_kernel

    got, rounds = cone_kernel(pt, o, d, t_max, HIT_EPS, tiles, lo=lo,
                              with_stats=True)
    want = cone_reference(pt, o, d, t_max, HIT_EPS, tiles, lo=lo)
    sync()
    check(bool(torch.equal(got, want)),
          f"K4 vs the kernel it replaced ({label}): "
          f"{int((got != want).sum())} of {got.numel()} starts differ")
    return got, rounds


def check_k4_rounds(rounds, rounds_p, label):
    """K4's per-tile rounds (and so the lockstep round count k, their
    largest) against the plain version's."""
    k, k_p = int(rounds.max()), int(rounds_p.max())
    check(bool(torch.equal(rounds, rounds_p.to(rounds.dtype))) and k == k_p,
          f"K4 rounds vs plain ({label}): k {k} against {k_p}, "
          f"{int((rounds != rounds_p).sum())} of {rounds.numel()} tiles "
          f"differ")
    return k


def tile_rays(tiles, j):
    """The ray indices of tile j of a row-major H x W grid, row-major."""
    H, W, T = tiles
    ty, tx = divmod(j, W // T)
    r = torch.arange(T)
    return ((ty * T + r)[:, None] * W + tx * T + r[None, :]).reshape(-1)


def cone_read_bytes(pt, lo, o, d, tiles, rounds, t_max):
    """The table bytes K4's marches must move: the rows their centre rays'
    samples reach, as packed_read_bytes counts them (the row read whole, a
    sector of each row the walk passes), on the LOD tables where the march
    reads them. The samples come from the plain version capped at each
    round: the t a tile starts round m + 1 from."""
    from hpsdf_tpu_torch.render import HIT_EPS, _tiles_of, cone_start_plain

    H, W, T = tiles
    c = (T // 2) * T + T // 2
    oc, dc = _tiles_of(o, tiles)[:, c], _tiles_of(d, tiles)[:, c]
    pts = []
    for m in range(int(rounds.max())):
        t = cone_start_plain(pt, o, d, t_max, HIT_EPS, tiles, lo=lo,
                             max_steps=m).reshape(H // T, T, W // T, T)
        t = t[:, 0, :, 0].reshape(-1)
        live = rounds > m
        pts.append(oc[live] + t[live, None] * dc[live])
    if not pts:
        return 0
    tables = pt if lo is None else dataclasses.replace(pt, grid=lo[0],
                                                       rows=lo[1])
    return packed_read_bytes(tables, torch.cat(pts), whole=True)


def cone_ops(n_rays, total_rounds, deg, lo):
    """K4's f32 operations: K4_OPS_PER_RAY a ray for the tile's spread and
    intervals, and the rounds the tiles' marches took at k3_ops's
    arithmetic a step (an LOD step on the LOD tables)."""
    return n_rays * K4_OPS_PER_RAY + total_rounds * (
        k3_ops(2, lo=True) if lo is not None else k3_ops(deg))


@functools.lru_cache(maxsize=None)
def sass_listing(lib_path):
    """cuobjdump's SASS listing of a built library ('' where the toolkit
    has no cuobjdump)."""
    from hpsdf_tpu_torch import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return ""
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300).stdout


def sass_round(lib_path, template_args):
    """SASS instructions of one round of a cone_kernel instantiation: the
    largest loop (a backward branch) holding a 16-byte global load, which
    is the march's (the locate's and the row's loads), in cuobjdump's
    listing of the library. None where there is no listing."""
    best = None
    for block in re.split(r"\n\s*Function : ", sass_listing(lib_path))[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"cone_kernelI((?:L[a-z]\d+E|[a-z])+)E", name)
        if not m or [int(v) for v in re.findall(r"L[a-z](\d+)E",
                                                m.group(1))] \
                != list(template_args):
            continue
        code = [(int(a, 16), text) for a, text in
                re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        at = {a: i for i, (a, _) in enumerate(code)}
        for i, (a, text) in enumerate(code):
            b = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
            if not b or int(b.group(1), 16) >= a \
                    or int(b.group(1), 16) not in at:
                continue
            body = code[at[int(b.group(1), 16)]:i + 1]
            if any("LDG" in t and ".128" in t for _, t in body):
                best = max(best or 0, len(body))
    return best


def issue_estimate_ms(instr, rounds, tiles, lane):
    """Warp instructions of the marches over the card's issue rate (132 SMs
    x 4 schedulers x the SM clock nvidia-smi reads): ``instr`` a round,
    each tile a warp (``lane`` False: the kernel it replaced) or a lane of
    a warp of 32 consecutive tiles of its row (True), a warp as long as its
    longest tile."""
    if instr is None:
        return None, None
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]) * 1e6
    H, W, T = tiles
    r = rounds.long().reshape(H // T, W // T)
    if lane:
        pad = (-r.shape[1]) % 32
        r = torch.nn.functional.pad(r, (0, pad)).reshape(r.shape[0], -1, 32)
        r = r.amax(dim=-1)
    warp_instr = float(r.sum()) * instr
    return warp_instr / (132 * 4 * clock) * 1e3, clock


def k4_times(pt, o, d, tiles, lo, t0, width, extra=None):
    """K4, the kernel it replaced, K3 from K4's starts and K3 alone, in
    turns in CUDA graphs (best of 2 turns), with ``extra`` forms beside
    them."""
    from hpsdf_tpu_torch.render import (HIT_EPS, MAX_STEPS, cone_kernel,
                                        march_kernel)

    args = (pt, o, d, T_MAX, HIT_EPS, MAX_STEPS)
    forms = {"reference": lambda: cone_reference(pt, o, d, T_MAX, HIT_EPS,
                                                 tiles, lo=lo),
             "k4": lambda: cone_kernel(pt, o, d, T_MAX, HIT_EPS, tiles,
                                       lo=lo),
             **(extra or {}),
             "k3_t0": lambda: march_kernel(*args, lo=lo, width=width,
                                           t0=t0),
             "k3": lambda: march_kernel(*args, lo=lo, width=width)}
    ms = {k: [] for k in forms}
    for _ in range(2):
        for k, fn in forms.items():
            ms[k].append(graph_ms(fn, 10))
    return {k: min(v) for k, v in ms.items()}


def phase_k4(pt, name, smi):
    """K4 then K3 at 1024^2 rays from (0, 0, -1.8), T_MAX 5 (bench.py's
    protocol), on the tree's LOD rows where it has them: K4's starts
    against the kernel it replaced (bit for bit) and its plain version
    (K4_T0_ATOL on K4_T0_AGREE of the rays, the escaped tiles the same, the
    per-tile rounds equal), K4 + K3 against the plain march without a
    cone (``cone_vs_plain``, K4_CHANGED_SHARE); then, in turns in CUDA
    graphs, K4 and the kernel it replaced as they run and with no round
    (the reduction and the writes alone), K3 with and without K4's starts,
    and both kernels on the longest tile alone and on a tile that misses
    the root; the bound on the rounds the tiles took and the rows their
    centre rays reach; and the issue estimate of the marches. Returns
    times and errors."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.render import (CONE_TILE, HIT_EPS, MAX_STEPS,
                                        _march_block, camera_rays,
                                        cone_kernel, cone_start_plain,
                                        march_kernel)

    side = RAYS_SIDE
    o, d = camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=side,
                       height=side, device=pt.device)
    lo = pt.lo
    tiles = (side, side, CONE_TILE)
    args = (pt, o, d, T_MAX, HIT_EPS, MAX_STEPS)
    t0, rounds = check_k4_exact(pt, o, d, T_MAX, tiles, lo, name)
    sync()
    t1 = time.perf_counter()
    t0_p, rounds_p = cone_start_plain(pt, o, d, T_MAX, HIT_EPS, tiles,
                                      lo=lo, with_stats=True)
    sync()
    plain_ms = (time.perf_counter() - t1) * 1e3
    escape = float(np.float32(T_MAX) + np.float32(1.0))
    d_t0 = (t0 - t0_p).abs()
    t0_agree = float((d_t0 <= K4_T0_ATOL).float().mean())
    check(bool(torch.equal(t0 == escape, t0_p == escape))
          and t0_agree >= K4_T0_AGREE,
          f"K4 vs plain ({name}): {t0_agree} of rays within {K4_T0_ATOL}")
    k = check_k4_rounds(rounds, rounds_p, name)
    t_c, h_c, _ = march_kernel(*args, lo=lo, width=side, t0=t0)
    t_p, h_p, _ = _march_block(*args, lo=lo)
    change = cone_vs_plain(args, lo, tiles, t0, t_c, h_c, t_p, h_p, name,
                           K4_CHANGED_SHARE)
    ms = k4_times(pt, o, d, tiles, lo, t0, side, extra={
        "reference_cap0": lambda: cone_reference(
            pt, o, d, T_MAX, HIT_EPS, tiles, lo=lo, max_steps=0),
        "k4_cap0": lambda: cone_kernel(pt, o, d, T_MAX, HIT_EPS, tiles,
                                       lo=lo, max_steps=0)})
    # the longest tile alone, beside a tile whose rays miss the root (a
    # launch, the reduction and the writes)
    j = int(torch.argmax(rounds))
    ray = tile_rays(tiles, j).to(o.device)
    one = (CONE_TILE, CONE_TILE, CONE_TILE)
    oj, dj = o[ray].contiguous(), d[ray].contiguous()
    away = torch.tensor([0.0, 1.0, 0.0], device=o.device).expand_as(dj) \
        .contiguous()
    alone = {}
    for key, dd in (("longest", dj), ("miss", away)):
        for kern, fn in (("k4", cone_kernel), ("reference", cone_reference)):
            alone[f"{kern}_{key}"] = min(graph_ms(lambda: fn(
                pt, oj, dd, T_MAX, HIT_EPS, one, lo=lo), 10)
                for _ in range(2))
    n, n_tiles = o.shape[0], rounds.numel()
    total_rounds = int(rounds.sum())
    table = cone_read_bytes(pt, lo, o, d, tiles, rounds, T_MAX)
    by_bytes = bytes_ms(d, t0, extra=12 + table)
    by_ops = cone_ops(n, total_rounds, pt.deg_used, lo) / F32_PEAK * 1e3
    # the issue estimate: one round's SASS instructions times the rounds
    # each warp marches
    tmpl = (2, 1) if lo is not None else (pt.deg_used, 0)
    instr = sass_round(_kernels.library_path(), tmpl)
    instr_ref = sass_round(_kernels.library_path("check"),
                           (pt.deg_used,))
    est, clock = issue_estimate_ms(instr, rounds, tiles, lane=True)
    est_ref, _ = issue_estimate_ms(instr_ref, rounds, tiles, lane=False)
    esc = float((t0 == escape).float().mean())
    out = {"k4": ms["k4"], "k4_plain": plain_ms, "k3_t0": ms["k3_t0"],
           "k3": ms["k3"], "k4_reference": ms["reference"],
           "k4_cap0": ms["k4_cap0"], "k4_reference_cap0":
           ms["reference_cap0"], **alone,
           "k4_bound": max(by_bytes, by_ops),
           "k4_bound_by": "bytes" if by_bytes >= by_ops else "operations",
           "k4_bytes_bound": by_bytes, "k4_ops_bound": by_ops,
           "table_bytes": table, "k": k, "rounds": total_rounds,
           "rounds_hist": torch.bincount(rounds.long()).tolist(),
           "round_instr": instr, "round_instr_reference": instr_ref,
           "issue_ms": est, "issue_ms_reference": est_ref,
           "clock_max_hz": clock,
           "t0_max_abs_err": float(d_t0.max()), "t0_agree": t0_agree,
           "escaped_share": esc, "t_err": change["t_err"], "change": change,
           "cone_pays": ms["k4"] + ms["k3_t0"] < ms["k3"]}
    print(f"[k4] {name}: {side}^2 rays ({n_tiles} tiles, LOD "
          f"{'on' if lo is not None else 'off'}): t0 equal to the kernel it "
          f"replaced bit for bit; vs plain max {out['t0_max_abs_err']:.3e}, "
          f"{t0_agree:.6f} of rays within {K4_T0_ATOL}, per-tile rounds "
          f"equal (k {k}), escaped share {esc:.4f}; {cone_text(change)}",
          flush=True)
    print(f"[k4] {name}: {smi} | in CUDA graphs (best of 2 turns): K4 "
          f"{ms['k4']:.4f} ms, the kernel it replaced "
          f"{ms['reference']:.4f} ms; with no round (the reduction and the "
          f"writes) {ms['k4_cap0']:.4f} / {ms['reference_cap0']:.4f} ms; "
          f"plain {plain_ms:.1f} ms (one run) | K3 from K4's starts "
          f"{ms['k3_t0']:.4f} ms, K3 alone {ms['k3']:.4f} ms: the cone "
          f"{'pays' if out['cone_pays'] else 'does not pay'} "
          f"({ms['k4'] + ms['k3_t0']:.4f} against {ms['k3']:.4f} ms)",
          flush=True)
    print(f"[k4] {name}: bound {out['k4_bound']:.5f} ms "
          f"({out['k4_bound_by']}: bytes {by_bytes:.5f} ms with "
          f"{table} table bytes; operations {by_ops:.5f} ms on "
          f"{total_rounds} rounds, by rounds from 0: "
          f"{out['rounds_hist']}), {out['k4_bound'] / ms['k4']:.1%} of K4 "
          f"| the longest tile ({k} rounds) alone: K4 "
          f"{alone['k4_longest']:.4f} ms, the kernel it replaced "
          f"{alone['reference_longest']:.4f} ms; a tile that misses the "
          f"root {alone['k4_miss']:.4f} / {alone['reference_miss']:.4f} ms "
          f"| issue estimate: {instr} / {instr_ref} SASS instructions a "
          f"round (K4 / replaced), at {clock and clock / 1e6} MHz: "
          f"{est if est is None else f'{est:.4f}'} / "
          f"{est_ref if est_ref is None else f'{est_ref:.4f}'} ms",
          flush=True)
    return out


def phase_boundary(cfg, dev):
    """ADVICE.md's boundary view: a sphere of radius 0.499 touching the
    root's faces, fit with the slice's config, at 1024^2 rays from an
    oblique eye. K4 + K3 must drop no hit of the plain march without a
    cone, and the plain cone and march none either. Returns (hits,
    ``cone_vs_plain``'s result)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch.render import (CONE_TILE, HIT_EPS, MAX_STEPS,
                                        _march_block, camera_rays,
                                        march_kernel)

    tree = T.build_octree(cfg, lambda p: torch.linalg.norm(p, dim=-1)
                          - BOUNDARY_RADIUS, device=dev)
    pt = T.pack_tree(tree)
    side = RAYS_SIDE
    o, d = camera_rays(BOUNDARY_EYE, (0.0, 0.0, 0.0), width=side,
                       height=side, device=dev)
    args = (pt, o, d, T_MAX, HIT_EPS, MAX_STEPS)
    t0, _ = check_k4_exact(pt, o, d, T_MAX, (side, side, CONE_TILE), pt.lo,
                           "the boundary view")
    t_c, h_c, _ = march_kernel(*args, lo=pt.lo, width=side, t0=t0)
    t_p, h_p, _ = _march_block(*args, lo=pt.lo)
    change = cone_vs_plain(args, pt.lo, (side, side, CONE_TILE), t0, t_c,
                           h_c, t_p, h_p, "the boundary view",
                           K4_CHANGED_SHARE)
    check(change["dropped"] == 0 and change["witness"]["dropped"] == 0
          and bool(h_p.any()),
          f"K4 + K3 dropped {change['dropped']} hits on the boundary view")
    print(f"[k4] boundary view (sphere r = {BOUNDARY_RADIUS}, eye "
          f"{BOUNDARY_EYE}, {side}^2 rays, {tree.n_nodes} nodes): K4's t0 "
          f"equal to the kernel it replaced bit for bit; plain march "
          f"{int(h_p.sum())} hits; {cone_text(change)}", flush=True)
    return int(h_p.sum()), change


def inverse_setup(cfg, dev, sizes):
    """bench.py:734-767's protocol on the card: the target tree (sphere
    r = 0.3) and the initial one (r = 0.27), fit with the slice's config;
    for each (width, height) of ``sizes``, the rays from (0, 0, -1.8) at
    (0, 0, 0) and the target depths traced on the target tree, T_MAX 5."""
    import hpsdf_tpu_torch as T

    target, init = (T.build_octree(cfg, lambda p, r=r: torch.linalg.norm(
        p, dim=-1) - r, device=dev) for r in (0.3, 0.27))
    out = []
    for width, height in sizes:
        o, d = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=width,
                             height=height, device=dev)
        t_star, hit_star = T.inverse.render_targets(target, o, d,
                                                    t_max=T_MAX)
        out.append(dict(target=target, init=init, o=o.contiguous(), d=d,
                        t_star=t_star, hit_star=hit_star))
    return out


def depth_rmse(tree, s):
    """bench.py:758-762: the depth RMSE against the targets on the rays
    both traces hit (a capped trace: the optimised field is no metric
    SDF), and the share of rays both hit."""
    import hpsdf_tpu_torch as T

    res = T.trace(tree, s["o"], s["d"], t_max=T_MAX, step_cap=0.02)
    m = res.hit & s["hit_star"]
    dt = (res.t - s["t_star"])[m].double()
    return float(torch.sqrt(torch.mean(dt ** 2))), float(m.float().mean())


def band_points(s, rays):
    """The band points (surface, inside, outside) of the inverse rays
    ``rays`` (a slice), as fit_to_depth reads them."""
    from hpsdf_tpu_torch.inverse import BAND

    o, d, tt = s["o"][rays], s["d"][rays], s["t_star"][rays]
    return torch.cat([o + (tt + off)[:, None] * d
                      for off in (0.0, BAND, -BAND)])


def rel_err(a, b):
    """max |a - b| relative to max |b|; 0 where both are zero (a slice-tree
    point reads no row below the grid, so its d_rows is zero)."""
    scale = b.abs().max().clamp(min=torch.finfo(b.dtype).tiny)
    return float((a - b).abs().max() / scale)


# --------------------------------------------------------------------------
# [grad2]: the reads' derivatives as backward kernels (K1v, K1h, K8g, K5h,
# K7's form 2) and three paths through them
# --------------------------------------------------------------------------

PROJ_STEPS, FIT_STEPS, NMAP_STEPS = 5, 5, 3
# Adam's steps, paths (b) (on raw coefficients, whose field moves by the
# norms, ~10^3 times the step) and (c) (on folded ones). (b) starts from the
# r = 0.27 tree, 0.03 inside the samples; at 1e-7 its loss rose at the
# second step (PERF.md, PR 22)
FIT_LR, NMAP_LR = 3e-8, 1e-4
# the least fall of each path's loss over its steps, relative to the first
# step's, every step below the one before: (b) moves by the raw
# coefficients' few-0.1% (PERF.md), (c) by some 20%
FIT_MIN_DROP, NMAP_MIN_DROP = 1e-3, 0.1
NMAP_EIKONAL = 0.1                  # path (c)'s eikonal weight
# the kernels against their plain versions, of the largest entry: f64, f32
# first derivatives, f32 Hessian products (K5h), and path (c)'s gradient
GRAD2_RTOL64, GRAD2_RTOL32, GRAD2_RTOL_HVP = 1e-10, 1e-5, 1e-4
NMAP_RTOL = 1e-4
# the operations on the card a call may take
K1V_OPS = K1H_OPS = K5H_OPS = K7F2_OPS = 1
K8G_OPS = K1C_OPS = 2
# the six kernels' names in the kernels line, from the launch counts
GRAD2_KERNELS = {
    "query_vjp": lambda n: n["query_vjp"] - n["query_vjp_hess"]
    - n["query_vjp_centre"],
    "query_vjp_hess": lambda n: n["query_vjp_hess"],
    "query_centre_vjp": lambda n: n["query_vjp_centre"],
    "coeff_scatter_grad": lambda n: n["coeff_scatter_grad"],
    "packed_hvp": lambda n: n["packed_hvp"],
    "packed_grad_form2": lambda n: n["packed_grad_form2"]}


def oriented_samples(mesh, n, seed):
    """n points on random triangles of the mesh and their triangles' unit
    normals, f64 on the host."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, mesh.n_faces, n)
    w = rng.dirichlet(np.ones(3), n)
    tri = np.asarray(mesh.vertices, np.float64)[mesh.faces[t]]
    return (w[:, :, None] * tri).sum(axis=1), \
        np.asarray(mesh.face_normals, np.float64)[t]


def root_points(lo, hi, n, seed, pad=0.0):
    """n points drawn in the box [lo, hi] grown by ``pad`` of its size on
    each side (f64, host), a sixteenth of them with one coordinate moved
    onto a face of [lo, hi]."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    p = rng.uniform(lo - pad * (hi - lo), hi + pad * (hi - lo), (n, 3))
    k = np.arange(0, n, 16)
    axis, side = rng.integers(0, 3, k.size), rng.integers(0, 2, k.size)
    p[k, axis] = np.where(side == 1, hi[axis], lo[axis])
    return p


def projection_step(tree, p):
    """One step of the projection onto the surface, p <- p - f grad f /
    |grad f|^2, with f grad f from torch.autograd.grad of sum(query^2) / 2
    (the clamped evaluation outside the root; K1 and K1v on CUDA tensors).
    Returns (the new points, f)."""
    import hpsdf_tpu_torch as T

    p = p.detach().requires_grad_(True)
    f = T.query(tree, p, outside_value_max=False)
    (fg,) = torch.autograd.grad(0.5 * (f * f).sum(), p)
    f = f.detach()
    den = (fg * fg).sum(-1, keepdim=True)
    step = torch.where(den > 0, fg * (f * f)[:, None] / den, 0.0)
    return (p - step).detach(), f


def oriented_fit_loss(tree, coeffs, shift, pts, n_t, centre=None):
    """Path (b)'s loss on the tree with coefficients ``coeffs`` (and, for
    path (d), centres ``centre``), at the oriented samples moved by
    ``shift`` (3,): mean query^2 + mean (1 - n . n_t), n
    query_with_gradient's unit gradient. On CUDA tensors K1 with K8 and
    K1v, and K1 with the gradient with K8g and K1h; with the centres K1c in
    place of K1v and K1h, one launch a read for the points and the
    centres."""
    import hpsdf_tpu_torch as T

    tr = dataclasses.replace(tree, coeffs=coeffs, **(
        {} if centre is None else {"centre": centre}))
    p = pts + shift
    f = T.query(tr, p)
    _, n = T.query_with_gradient(tr, p)
    return (f * f).mean() + (1.0 - (n * n_t).sum(-1)).mean()


def normal_map_loss(packed, support, folded, shift, hits, n_t):
    """Path (c)'s loss on the tables repacked from the folded coefficients
    (inverse.fit_to_depth's parameters), at the hits moved by ``shift``
    (3,): mean (1 - n . n_t), n from accel.normals, plus the field there,
    mean f^2 + NMAP_EIKONAL mean (|grad f| - 1)^2 from
    values_and_gradient_at. On CUDA tensors K5 with K7's form 2 and K5h,
    the fused read with K7's forms 0 and 1 and K5h, and G with its
    backward."""
    from hpsdf_tpu_torch import accel as A

    pk = A.repack_folded(packed, support, folded)
    p = hits + shift
    n = A.normals(pk, p)
    v, g = A.values_and_gradient_at(pk, p, p.shape[0])
    gn = torch.sqrt((g * g).sum(-1) + 1e-12)
    return ((1.0 - (n * n_t).sum(-1)).mean() + (v * v).mean()
            + NMAP_EIKONAL * ((gn - 1.0) ** 2).mean())


def phase_grad(pt_s, tree_s, s, smi, seed=11):
    """The backward kernels against autograd of their plain versions on the
    card, at 2^20 points and at the main path's shapes (one inverse chunk's
    band points, the 7n points of its read and its rays on the initial
    tree, the repack's grid): K7 both forms, G's backward (its CSR form at
    the grid, its grouping form at 2^20 random indices and at the grid),
    K8's f64 query form and f32 trace form (the middle chunk with a random
    dt, then every chunk of a 1080p step with the step's dt, timed one by
    one and summed). K7, G's backward and K8 are also held to the kernels
    they replaced (csrc/check/), within the same tolerance, and the CSR
    form's two launches must agree bit for bit. Each timed in a CUDA graph
    beside its plain version, its bound, the kernel it replaced and, for
    G's backward, index_add_, with the operations a call puts on the card
    (at most K7_LAUNCHES / G_BWD_LAUNCHES / K8_LAUNCHES). Then K2 and K5's
    raw gradient in one launch (the fused mode) at the 7n points, bit-equal
    to modes 0 and 2, timed beside both. Returns {kernel: {shape: dict}},
    with "raw", "fixed_cost", "k8_step" and "fused" apart."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch import render as R
    from hpsdf_tpu_torch.query import coeff_scatter_kernel, query_vjp_plain

    rng = np.random.default_rng(seed)
    dev = pt_s.device
    chunk = 1 << 16
    # the inverse chunk across the image's middle rows: the first chunks
    # hold its top rows, whose rays all miss the sphere
    mid = s["o"].shape[0] // 2 // chunk * chunk
    rays = slice(mid, mid + chunk)
    pt_i = A.pack_tree(s["init"])
    band = band_points(s, rays)
    c = np.asarray(pt_s.root_centre)
    half = 0.5 * np.asarray(pt_s.root_sizes)
    uni = torch.as_tensor(rng.uniform(c - 1.05 * half, c + 1.05 * half,
                                      (N_QUERY, 3)).astype(np.float32),
                          device=dev)

    def rand(*shape, dt=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                               device=dev)

    def timed(kernel, plain, library=None):
        t = {"ms": graph_ms(kernel, 10), "plain_ms": time_ms(plain, 3)}
        t["library_ms"] = None if library is None else time_ms(library, 10)
        return t

    out = {"packed_grad": {}, "row_scatter": {}, "coeff_scatter": {}}
    # K5's raw gradient (values_at's VJP to the points, the eikonal term)
    raw_err = rel_err(A.packed_eval_kernel(pt_i, band, A.RAW_GRAD),
                      A.point_gradient_plain(pt_i, band))
    check(raw_err <= GRAD_RTOL32, f"K5's raw gradient vs plain at the "
          f"inverse chunk's band points: {raw_err:.3e}")
    out["raw"] = {
        "rel_err": raw_err, "points": band.shape[0],
        "ms": graph_ms(lambda: A.packed_eval_kernel(pt_i, band, A.RAW_GRAD),
                       20),
        "plain_ms": time_ms(lambda: A.point_gradient_plain(pt_i, band), 5),
        "bound_ms": bytes_ms(band, band,
                             extra=packed_read_bytes(pt_i, band, True))}
    print(f"[grad] K5's raw gradient at the inverse chunk's "
          f"{band.shape[0]} band points: max|kernel - plain| / max|plain| "
          f"{raw_err:.3e}, kernel {out['raw']['ms']:.4f} ms, plain "
          f"{out['raw']['plain_ms']:.3f} ms, byte bound "
          f"{out['raw']['bound_ms']:.5f} ms", flush=True)
    # K7: values_at's VJP (form 0) and the point gradient's (form 1), at
    # 2^20 points, at an inverse chunk's band points (both forms) and at
    # the 7n points of its values_at call (form 0)
    free = inverse_points(s, rays)
    crowd = {}
    for label, pt, pts, forms in (
            ("2^20 uniform, slice tree", pt_s, uni, (0, 1)),
            ("inverse chunk band points", pt_i, band, (0, 1)),
            ("inverse chunk 7n points", pt_i, free, (0,))):
        n = pts.shape[0]
        per_row = torch.bincount(rows_read(pt, pts))
        crowd[label] = (int((per_row > 0).sum()), int(per_row.max()))
        for form in forms:
            cot = rand(n) if form == 0 else rand(n, 3)
            plain = (A.values_at_vjp_plain, A.point_gradient_vjp_plain)[form]
            got = A.packed_grad_kernel(pt, pts, cot, form)
            want = plain(pt, pts, cot)
            ref = packed_grad_reference(pt, pts, cot, form)
            err = max(rel_err(g, w) for g, w in zip(got, want))
            ref_err = max(rel_err(g, r) for g, r in zip(got, ref))
            check(err <= GRAD_RTOL32, f"K7 form {form} vs autograd of the "
                  f"plain version at {label}: {err:.3e}")
            check(ref_err <= GRAD_RTOL32, f"K7 form {form} vs the kernel it "
                  f"replaced at {label}: {ref_err:.3e}")
            t = timed(lambda: A.packed_grad_kernel(pt, pts, cot, form),
                      lambda: plain(pt, pts, cot))
            C = (pt.deg_used + 1) * (pt.deg_used + 2) * (pt.deg_used + 3) \
                // 6
            # the points and cotangents read, both tables written, and the
            # meta lanes of the rows the points' walks visit
            by_bytes = bytes_ms(pts, cot, pt.rows, pt.grid,
                                extra=packed_read_bytes(pt, pts))
            by_ops = n * k7_ops(pt.deg_used, form) / F32_PEAK * 1e3
            t.update(rel_err=err, ref_rel_err=ref_err, max_abs_err=max(
                float((g - w).abs().max()) for g, w in zip(got, want)),
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                replaced_kernel_ms=graph_ms(
                    lambda: packed_grad_reference(pt, pts, cot, form), 10),
                launches_a_call=device_ops(
                    lambda: A.packed_grad_kernel(pt, pts, cot, form)),
                replaced_launches_a_call=device_ops(
                    lambda: packed_grad_reference(pt, pts, cot, form)),
                points=n, terms=C, rows_read=crowd[label][0],
                largest_row_points=crowd[label][1])
            check(1 <= t["launches_a_call"] <= K7_LAUNCHES,
                  f"K7 puts {t['launches_a_call']} operations on the card a "
                  f"call (at most {K7_LAUNCHES})")
            out["packed_grad"][f"form {form}, {label}"] = t
    # G's backward: 2^20 indices into the probe's table (the grouping
    # form), and the repack's grid into the initial tree's rows (the CSR
    # form, as repack_folded calls it, and the grouping form beside it)
    sup = A.pack_support(s["init"])
    n_rows = G_TABLE[0]
    probe = torch.as_tensor(
        rng.integers(-64, n_rows + 64, N_GATHER).astype(np.int32), device=dev)
    for label, idx, n_tab, width, csr in (
            ("2^20 indices into 4681 x 32", probe, n_rows, G_TABLE[1], None),
            ("the repack's grid", sup.grid_src, pt_i.rows.shape[0],
             pt_i.width, sup.grid_csr),
            ("the repack's grid, grouping form", sup.grid_src,
             pt_i.rows.shape[0], pt_i.width, None)):
        d_out = rand(idx.shape[0], width)
        got = A.row_scatter(d_out, idx, n_tab, csr)
        want = A.row_scatter_plain(d_out, idx, n_tab)
        ref = row_scatter_reference(d_out, idx, n_tab)
        err, ref_err = rel_err(got, want), rel_err(got, ref)
        check(err <= GRAD_RTOL32, f"G's backward vs index_add_ at {label}: "
              f"{err:.3e}")
        check(ref_err <= GRAD_RTOL32, f"G's backward vs the kernel it "
              f"replaced at {label}: {ref_err:.3e}")
        if csr is not None:             # one fixed order of adds a row
            again = A.row_scatter(d_out, idx, n_tab, csr)
            check(torch.equal(got, again), f"G's backward (CSR form) at "
                  f"{label}: two launches differ")
        ok = (idx >= 0) & (idx < n_tab)
        idx_in, d_in = idx[ok].long(), d_out[ok]
        t = timed(lambda: A.row_scatter(d_out, idx, n_tab, csr),
                  lambda: A.row_scatter_plain(d_out, idx, n_tab),
                  lambda: torch.zeros((n_tab, width), device=dev)
                  .index_add_(0, idx_in, d_in))
        # the rows of in-range indices read, the indices (or the CSR) read,
        # the table written
        t.update(rel_err=err, ref_rel_err=ref_err,
                 max_abs_err=float((got - want).abs().max()),
                 bound_ms=bytes_ms(d_in, *(csr or (idx,)), got),
                 bound_by="bytes",
                 replaced_kernel_ms=graph_ms(
                     lambda: row_scatter_reference(d_out, idx, n_tab), 10),
                 launches_a_call=device_ops(
                     lambda: A.row_scatter(d_out, idx, n_tab, csr)),
                 replaced_launches_a_call=device_ops(
                     lambda: row_scatter_reference(d_out, idx, n_tab)),
                 deterministic=csr is not None, rows=idx.shape[0])
        check(1 <= t["launches_a_call"] <= G_BWD_LAUNCHES,
              f"G's backward puts {t['launches_a_call']} operations on the "
              f"card a call (at most {G_BWD_LAUNCHES})")
        out["row_scatter"][label] = t
    # what a call costs with next to nothing to add (32 points or indices),
    # beside the kernel it replaced, both in CUDA graphs; and how the
    # points crowd
    p32, w32 = band[:32], band[:32, 0].contiguous()
    i32, d32 = probe[:32], rand(32, G_TABLE[1])
    out["fixed_cost"] = {
        "packed_grad": (
            graph_ms(lambda: A.packed_grad_kernel(pt_i, p32, w32, 0), 20),
            graph_ms(lambda: packed_grad_reference(pt_i, p32, w32, 0), 20)),
        "row_scatter": (
            graph_ms(lambda: A.row_scatter(d32, i32, n_rows), 20),
            graph_ms(lambda: row_scatter_reference(d32, i32, n_rows), 20))}
    print(f"[grad] at 32 points or indices, a launch's fixed cost | {smi} | "
          + ", ".join(f"{k} {a:.4f} ms in a CUDA graph, the kernel it "
                      f"replaced {b:.4f} ms" for k, (a, b) in
                      out["fixed_cost"].items())
          + " | rows the points read, the most points a row: " + ", ".join(
              f"{k} {r} / {m}" for k, (r, m) in crowd.items()), flush=True)
    # K8: the f64 query VJP, and the f32 trace VJP on marched rays; each
    # held to autograd of its plain version and to the kernel it replaced
    tree_i = s["init"]
    tree32 = R._tree_f32(tree_i)

    def k8_entry(tree, w, label, pts=None, rays=None, ops=True):
        """K8 at one shape: checked, timed beside the kernel it replaced
        and bounded by what its live points need; with ``ops``, the
        operations a call puts on the card counted."""
        kw = (dict(pts=pts, outside_value_max=True) if rays is None
              else dict(rays=rays))
        if rays is None:
            plain = (lambda: query_vjp_plain(tree, pts, w))
        else:
            plain = (lambda: R.trace_vjp_plain(tree, *rays, w))
        got, want = coeff_scatter_kernel(tree, w, **kw), plain()
        if rays is None or bool(off_faces(tree, rays).all()):
            ref_got, ref = got, coeff_scatter_reference(tree, w, **kw)
        else:     # the kernel it replaced keeps the clamp's slope 1 there
            wf = torch.where(off_faces(tree, rays), w, 0.0)
            ref_got = coeff_scatter_kernel(tree, wf, **kw)
            ref = coeff_scatter_reference(tree, wf, **kw)
        tol = GRAD_RTOL32 if rays is not None else GRAD_RTOL64
        err, ref_err = rel_err(got, want), rel_err(ref_got, ref)
        check(err <= tol, f"K8 vs autograd of the plain version at {label}: "
              f"{err:.3e}")
        check(ref_err <= tol, f"K8 vs the kernel it replaced at {label}: "
              f"{ref_err:.3e}")
        by_bytes, live = k8_bytes(tree, w, **kw)
        by_ms = bytes_ms(extra=by_bytes)
        by_ops = live * k1_ops(tree.deg_used, tree.depth_used,
                               rays is not None) \
            / (F32_PEAK if rays is not None else F64_PEAK) * 1e3
        t = timed(lambda: coeff_scatter_kernel(tree, w, **kw), plain)
        t.update(rel_err=err, ref_rel_err=ref_err,
                 max_abs_err=float((got - want).abs().max()),
                 bound_ms=max(by_ms, by_ops),
                 bound_by="bytes" if by_ms >= by_ops else "operations",
                 replaced_kernel_ms=graph_ms(
                     lambda: coeff_scatter_reference(tree, w, **kw), 10),
                 points=w.shape[0], live=live)
        if ops:
            t.update(launches_a_call=device_ops(
                lambda: coeff_scatter_kernel(tree, w, **kw)),
                replaced_launches_a_call=device_ops(
                    lambda: coeff_scatter_reference(tree, w, **kw)))
            check(t["launches_a_call"] <= K8_LAUNCHES, f"K8 puts "
                  f"{t['launches_a_call']} operations on the card a call "
                  f"(at most {K8_LAUNCHES})")
        return t

    for label, tree, pts in (("2^20 uniform, slice tree", tree_s,
                              uni.double()),
                             ("inverse chunk band points", tree_i,
                              band.double())):
        out["coeff_scatter"][f"f64 query, {label}"] = k8_entry(
            tree, rand(pts.shape[0], dt=torch.float64), label, pts=pts)
    # the inverse step's own rays: every chunk marched on the initial tree,
    # with the depth term's cotangent dt (zero where either trace missed);
    # the middle chunk also with a random dt on every ray
    chunks = inverse_chunks(s, chunk)
    o, d = s["o"][rays], s["d"][rays]
    t_c, h_c = chunks[mid // chunk]["t"], chunks[mid // chunk]["hit"]
    check(bool(h_c.any()), "hits in the middle inverse chunk")
    out["coeff_scatter"]["f32 trace, inverse chunk rays"] = k8_entry(
        tree32, rand(chunk), "an inverse chunk, random dt",
        rays=(o, d, t_c, h_c))
    step = []
    for k, c in enumerate(chunks):
        step.append(k8_entry(tree32, c["dt"], f"inverse chunk {k}, the "
                             f"step's dt", rays=c["rays"],
                             ops=k == mid // chunk))
        step[-1]["hits"] = int(c["hit"].sum())
    out["coeff_scatter"]["f32 trace, inverse chunk rays, the step's dt"] = \
        step[mid // chunk]
    out["k8_step"] = {
        key: sum(t[key] for t in step) for key in
        ("ms", "replaced_kernel_ms", "bound_ms", "plain_ms", "live", "hits")}
    out["k8_step"].update(
        chunks=len(step), live_by_chunk=[t["live"] for t in step],
        ms_by_chunk=[t["ms"] for t in step],
        replaced_ms_by_chunk=[t["replaced_kernel_ms"] for t in step],
        max_rel_err=max(t["rel_err"] for t in step),
        max_ref_rel_err=max(t["ref_rel_err"] for t in step))
    ks = out["k8_step"]
    print(f"[grad] K8 (f32 trace) over the {ks['chunks']} chunks of one "
          f"1080p step on the initial tree, the step's dt | {smi} | "
          f"{ks['live']} live rays of {ks['hits']} hits (by chunk "
          f"{ks['live_by_chunk']}) | kernel {ks['ms']:.4f} ms summed in "
          f"CUDA graphs, the kernel it replaced {ks['replaced_kernel_ms']:.4f}"
          f" ms, bound {ks['bound_ms']:.5f} ms | by chunk "
          f"{[round(x, 4) for x in ks['ms_by_chunk']]}, replaced "
          f"{[round(x, 4) for x in ks['replaced_ms_by_chunk']]} | "
          f"max|kernel - plain| / max|plain| {ks['max_rel_err']:.3e}, "
          f"against the kernel it replaced {ks['max_ref_rel_err']:.3e}",
          flush=True)
    # K2 and K5's raw gradient in one launch (the fused mode), at the 7n
    # points of an inverse chunk's read, on the initial and slice trees:
    # values bit-equal to K2's, gradients to K5's raw form
    n_band = band.shape[0]
    for label, pt in (("slice", pt_s), ("initial", pt_i)):
        v_f, g_f = A.packed_eval_kernel(pt, free, A.VALUES_AND_GRAD,
                                        n_grad=n_band)
        v_0 = A.packed_eval_kernel(pt, free, A.VALUES)
        g_2 = A.packed_eval_kernel(pt, band, A.RAW_GRAD)
        check(torch.equal(v_f, v_0) and torch.equal(g_f, g_2),
              f"the fused mode vs modes 0 and 2 at the 7n points, {label} "
              f"tree: {int((v_f != v_0).sum())} values and "
              f"{int((g_f != g_2).sum())} gradient entries differ")
    v_p, g_p = A.values_and_gradient_at_plain(pt_i, free, n_band)
    fused_err = max(scaled_err(v_f, v_p), rel_err(g_f, g_p))
    check(fused_err <= GRAD_RTOL32, f"the fused mode vs plain at the 7n "
          f"points: {fused_err:.3e}")
    out["fused"] = {
        "points": free.shape[0], "grad_points": n_band,
        "max_err": fused_err, "bit_equal_to_modes_0_and_2": True,
        "ms": graph_ms(lambda: A.packed_eval_kernel(
            pt_i, free, A.VALUES_AND_GRAD, n_grad=n_band), 20),
        "values_ms": graph_ms(lambda: A.packed_eval_kernel(
            pt_i, free, A.VALUES), 20),
        "raw_ms": graph_ms(lambda: A.packed_eval_kernel(
            pt_i, band, A.RAW_GRAD), 20),
        "plain_ms": time_ms(lambda: A.values_and_gradient_at_plain(
            pt_i, free, n_band), 5),
        "bound_ms": bytes_ms(free, v_f, g_f, extra=packed_read_bytes(
            pt_i, free, True))}
    f_ = out["fused"]
    print(f"[grad] K2 + K5's raw gradient fused at the inverse chunk's "
          f"{f_['points']} points (gradients at the first {n_band}): values "
          f"and gradients bit-equal to modes 0 and 2 on the initial and "
          f"slice trees, against plain {fused_err:.3e} | {smi} | fused "
          f"{f_['ms']:.4f} ms in a CUDA graph, K2 alone {f_['values_ms']:.4f}"
          f" ms, K5's raw gradient alone {f_['raw_ms']:.4f} ms, plain "
          f"{f_['plain_ms']:.3f} ms, byte bound {f_['bound_ms']:.5f} ms",
          flush=True)
    for kernel, shapes in out.items():
        for label, t in (shapes.items() if kernel not in (
                "raw", "fixed_cost", "k8_step", "fused") else ()):
            print(f"[grad] {kernel} at {label}: max|kernel - plain| / "
                  f"max|plain| {t['rel_err']:.3e}"
                  + ("" if "ref_rel_err" not in t else
                     f", against the kernel it replaced "
                     f"{t['ref_rel_err']:.3e}")
                  + (" (two launches bit-equal)" if t.get("deterministic")
                     else "")
                  + f" | {smi} | kernel {t['ms']:.4f} ms in a CUDA graph"
                  + ("" if "replaced_kernel_ms" not in t else
                     f", the kernel it replaced {t['replaced_kernel_ms']:.4f}"
                     f" ms")
                  + f", plain {t['plain_ms']:.3f} ms, bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}, "
                  f"{t['bound_ms'] / t['ms']:.1%} of it)"
                  + ("" if t["library_ms"] is None else
                     f", index_add_ {t['library_ms']:.4f} ms")
                  + ("" if "launches_a_call" not in t else
                     f" | operations on the card a call: "
                     f"{t['launches_a_call']}, the kernel it replaced "
                     f"{t['replaced_launches_a_call']}"),
                  flush=True)
    return out


def product_sum_ops(deg, sums, pairs):
    """Operations a point of ``sums`` Legendre product sums over a
    degree-``deg`` row, an FMA counted as two: a term of a sum is a pair
    product N_i(x) N_j(y) times the third axis's factor, then an FMA (3),
    and each of the ``pairs`` kinds of pair product is formed once a point
    for its T = (deg+1)(deg+2)/2 pairs (the sharing k1_ops credits K1's
    gradient with)."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T = (deg + 1) * (deg + 2) // 2
    return 3 * C * sums + T * pairs


def k1_frame_ops(deg, depth_used, order):
    """f64 operations a point of K1 outside its product sums (k1_ops'
    other terms): the descent's compares, the frame, the Legendre
    recurrences and their folding into the axis norms; to order 1 the
    derivative recurrences, their folding and the chain rule with the
    normalisation (20); to order 2 the second derivative recurrences,
    their folding and the unit gradient's VJP with the Hessian product
    (60)."""
    ops = 12 * max(deg - 1, 0) + 4 * (deg + 1) + 12 + 3 * depth_used
    if order >= 1:
        ops += 9 * max(deg - 1, 0) + 3 * (deg + 1) + 20
    if order >= 2:
        ops += 9 * max(deg - 1, 0) + 3 * (deg + 1) + 60
    return ops


def k1v_ops(deg, depth_used):
    """f64 operations a point of K1v: K1's descent (depth_used 0 from K1's
    leaf, which runs none) and frame to order 1, and the three gradient
    sums, whose pair products are N_x N_y, N'_x N_y and N_x N'_y. The
    value's sum is no part of the VJP."""
    return k1_frame_ops(deg, depth_used, 1) + product_sum_ops(deg, 3, 3)


def k1h_ops(deg, depth_used):
    """f64 operations a point of K1h: K1's descent (depth_used 0 from K1's
    leaf) and frame to order 2, the three gradient and six Hessian sums (xx, yy, zz, xy, xz, yz), whose
    pair products are N_x N_y, N'_x N_y, N_x N'_y, N''_x N_y, N_x N''_y and
    N'_x N'_y. The value's sum is no part of the VJP."""
    return k1_frame_ops(deg, depth_used, 2) + product_sum_ops(deg, 9, 6)


def k8g_ops(deg, depth_used):
    """f64 operations a live point of K8g: K1v's (the gradient g for the
    unit vector's VJP, no value sum) and its scatter, twelve a term (the
    value's product and three gradient products of three, each weighted and
    added)."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    return k1v_ops(deg, depth_used) + 12 * C


def k5h_ops(deg):
    """f32 operations a point of K5h: the frame (9), three Legendre
    recurrences and their first and second derivatives (30 (deg - 1)), the
    three gradient and six Hessian sums with K1h's six kinds of pair
    product, and the chain with the Hessian product (40)."""
    return 9 + 30 * max(deg - 1, 0) + product_sum_ops(deg, 9, 6) + 40


def k5h_saved_ops(deg, values, hess=True):
    """f32 operations a point of K5h from its forward's saved record: the
    frame (9), three Legendre recurrences and their first derivatives (20
    (deg - 1)) and, with the Hessian, their second (10 (deg - 1)); the
    k-run sums S_0, S_1 and, with the Hessian, S_2 of each (i, j) pair, an
    FMA (2) a term a sum; each kind of pair product once a pair (N_x N_y,
    N'_x N_y, N_x N'_y, and N''_x N_y, N_x N''_y, N'_x N'_y with the
    Hessian) and an FMA a pair for each entry summed (the Hessian's 6, the
    gradient's 3 in the values mode); the chain with the Hessian product
    (40) and, in the normals mode, the unit vector's VJP (20)."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    T = (deg + 1) * (deg + 2) // 2
    sums = (3 if values else 0) + (6 if hess else 0)
    return (9 + (30 if hess else 20) * max(deg - 1, 0)
            + 2 * (3 if hess else 2) * C + (6 if hess else 3) * T
            + 2 * sums * T + 40 + (0 if values else 20))


def k7f2_ops(deg):
    """f32 operations a point of K7's form 2: form 1's (k7_ops) and the
    record's three gradient sums, with K1v's three kinds of pair
    product."""
    return k7_ops(deg, 1) + product_sum_ops(deg, 3, 3)


def k7f2_saved_ops(deg):
    """f32 operations a point of K7's form 2 from K5's saved gradient:
    form 1's (k7_ops) and the unit vector's VJP (20); the record's
    gradient sums are K5's forward's."""
    return k7_ops(deg, 1) + 20


def k7f2_bytes(pt, pts, wn, saved):
    """The bytes K7's form 2 from K5's saved values must move: the points,
    cotangents and saved values read, a 32-byte sector (the meta lanes) of
    each row the points read, both tables written."""
    rows = torch.unique(saved[:, 0].contiguous().view(torch.int32)).numel()
    return sum(t.numel() * t.element_size() for t in (
        pts, wn, saved, pt.rows, pt.grid)) + 32 * rows


def grad2_teeth(got, want, tol, face=None, sloped=None, masked=None,
                keyed=None):
    """Whether each wrong result fails the check rel_err <= tol: the
    largest entry moved by 10 tol of the largest (of 1 where the result is
    zero), and, for a point VJP with ``face`` (B, 3) the entries on an
    axis at a face of the root, where some of those are not zero, those
    entries doubled (the clamp's derivative taken as 1 there, the fault
    the face rule repairs); for K1c, ``sloped``, the centre gradient with
    the clamp's slope wrongly applied (``centre_sloped``), for K7's form
    2, ``masked``, the tables' gradient with one axis masked
    (``form2_masked``), and for K5h, ``keyed``, its result from wrong row
    keys (``wrong_key``), each where it is not the result."""
    flat = got.clone().reshape(-1)
    k = int(want.reshape(-1).abs().argmax())
    flat[k] += 10 * tol * max(float(want.abs().max()), 1.0)
    caught = [rel_err(flat.reshape(got.shape), want) > tol]
    if face is not None and bool((face & (got != 0)).any()):
        caught.append(rel_err(torch.where(face, 2 * got, got), want) > tol)
    for wrong in (sloped, masked, keyed):
        if wrong is not None and not torch.equal(wrong, got):
            caught.append(rel_err(wrong, want) > tol)
    return caught


def form2_masked(pt, pts, saved, wn, axis=0):
    """K7's form 2's wrong result with one axis masked, as form 1 masks an
    axis on which a point was clamped: ``accel.normals_tables_vjp_plain``
    with the unit vector's VJP zeroed on ``axis``; (d_rows, d_grid)
    concatenated."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch.query import unit_vector

    G = saved[:, 1:].detach().requires_grad_(True)
    with torch.enable_grad():
        (gb,) = torch.autograd.grad(unit_vector(G, 1e-12), G, wn)
    gb = gb.clone()
    gb[:, axis] = 0.0
    return torch.cat(A._normal_gradient_vjp(pt, pts, gb))


def packed_grad_form2_reference(pt, pts, wn):
    """K7's form 2 as it was before its redesign (csrc/check/
    packed_grad_form2_reference.cu: one cooperative launch that locates
    each point's row and evaluates its gradient again), called as its
    wrapper called it: (d_rows, d_grid)."""
    from hpsdf_tpu_torch import _kernels

    pts, wn = pts.detach().contiguous(), wn.detach().contiguous()
    lib = _kernels.load_check()
    B, n_rows = pts.shape[0], pt.rows.shape[0]
    size = lib.hpsdf_packed_grad_form2_reference_scratch(B, pt.grid_depth,
                                                         n_rows)
    check(size > 0, "packed_grad_form2_reference: no scratch size")
    scratch = torch.empty(size, dtype=torch.uint8, device=pts.device)
    d_rows, d_grid = torch.empty_like(pt.rows), torch.empty_like(pt.grid)
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    sz = np.asarray(pt.root_sizes, np.float32)
    _kernels.check(_kernels.load(), lib.hpsdf_packed_grad_form2_reference(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        pt.grid_depth, pt.extra_rounds, n_rows, pts.data_ptr(), B,
        *map(float, rc), *map(float, inv), *map(float, sz), wn.data_ptr(),
        scratch.data_ptr(), size, d_grid.data_ptr(), d_rows.data_ptr(),
        _kernels.stream_of(pts)), "packed_grad_form2_reference")
    return d_rows, d_grid


def packed_hvp_reference(pt, pts, mode, w, cot3):
    """K5h as it was before its redesign (csrc/check/
    packed_hvp_reference.cu: each point's row located again from the root
    grid, the gradient and Hessian summed term by term), called as its
    wrapper called it: mode NORMALS_VJP with cotangents cot3 (B, 3), mode
    VALUES_GRAD_VJP with w (B,) and cot3 (n_grad, 3)."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch import accel as A

    pts, cot3 = pts.detach().contiguous(), cot3.detach().contiguous()
    w = None if w is None else w.detach().contiguous()
    out = torch.empty(pts.shape, dtype=torch.float32, device=pts.device)
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    sz = np.asarray(pt.root_sizes, np.float32)
    _kernels.check(_kernels.load(),
                   _kernels.load_check().hpsdf_packed_hvp_reference(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        pt.grid_depth, pt.extra_rounds, pts.data_ptr(), pts.shape[0],
        *map(float, rc), *map(float, inv), *map(float, sz), mode,
        None if w is None else w.data_ptr(), cot3.data_ptr(),
        cot3.shape[0] if mode == A.VALUES_GRAD_VJP else pts.shape[0],
        out.data_ptr(), _kernels.stream_of(pts)), "packed_hvp_reference")
    return out


def k5h_bytes(pt, pts, saved, *cots):
    """The bytes K5h's function must move: the points and cotangents read,
    a 4-byte row key a point (the least a locate reads), each row the keys
    name read whole, the gradient (12 B a point) written. The saved record
    (the normals' (B, 4) record or the keys (B,)) counts for its keys
    alone: what this design reads beyond them is ``k5h_saved_extra``."""
    keys = saved[:, 0].contiguous().view(torch.int32) if saved.dim() == 2 \
        else saved
    rows = torch.unique(keys).numel()
    return sum(t.numel() * t.element_size() for t in (pts, *cots)) \
        + (4 + 12) * pts.shape[0] + 4 * pt.width * rows


def k5h_saved_extra(saved):
    """The bytes K5h reads from its forward's record beyond the function's
    4-byte key a point: the normals' saved G (12 B a point), none of the
    values' keys."""
    return saved.numel() * saved.element_size() - 4 * saved.shape[0]


def hvp_blocks(deg, mode):
    """Blocks of K5h an SM holds at degree ``deg`` in ``mode``
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes
    from hpsdf_tpu_torch import _kernels

    n = ctypes.c_int(0)
    _kernels.check(_kernels.load(), _kernels.load().hpsdf_packed_hvp_blocks(
        deg, mode, ctypes.byref(n)), "packed_hvp_blocks")
    return n.value


def centre_sloped(tree, leaf, d_pts):
    """K1c's wrong result with the clamp's slope applied (a point on a
    face of the root taking 1/2, one outside 0, as the points' gradient
    does): minus each leaf's points' gradients ``d_pts`` (K1v's or K1h's)
    times the root's sizes, summed into the leaf's row."""
    sizes = torch.as_tensor(tree.config.root_sizes, dtype=torch.float64,
                            device=d_pts.device)
    return -torch.zeros_like(tree.centre).index_add_(0, leaf.long(),
                                                     d_pts * sizes)


def sparse_cotangents(w, wn, seed):
    """The cotangents with a third of wv and a third of wn's rows zero (a
    ninth of the points both), as K8g's liveness sees them."""
    g = torch.Generator(device=w.device).manual_seed(seed)
    w = torch.where(torch.rand(w.shape, generator=g, device=w.device) < 1 / 3,
                    0.0, w)
    zero = torch.rand(wn.shape[0], generator=g, device=w.device) < 1 / 3
    return w, torch.where(zero[:, None], 0.0, wn)


def query_vjp_reference(tree, pts, w, wn=None, outside_value_max=True):
    """K1v (``wn`` None) and K1h as they were before their redesign
    (csrc/check/query_vjp_reference.cu: one launch that descends from the
    root again), called as their wrapper called them."""
    from hpsdf_tpu_torch import _kernels

    pts, w = pts.detach().contiguous(), w.detach().contiguous()
    hess = wn is not None
    wn = wn.detach().contiguous() if hess else None
    out = torch.empty(pts.shape, dtype=torch.float64, device=pts.device)
    rc = tree.config.root_centre
    inv = 1.0 / tree.config.root_sizes
    _kernels.check(_kernels.load(),
                   _kernels.load_check().hpsdf_query_vjp_reference(
        tree.child_idx.data_ptr(), tree.centre.data_ptr(),
        tree.depth.data_ptr(), tree.coeffs.detach().data_ptr(),
        tree.deg_used, tree.depth_used, pts.data_ptr(), pts.shape[0],
        *map(float, rc), *map(float, inv), int(outside_value_max or hess),
        w.data_ptr(), wn.data_ptr() if hess else None, out.data_ptr(),
        _kernels.stream_of(pts)), "query_vjp_reference")
    return out


def vjp_blocks(deg, hess, reference=False):
    """Blocks of 128 threads an SM holds of K1v (``hess`` False) or K1h at
    degree ``deg``: the shipped kernel's, or with ``reference`` the
    re-descending kernel's it replaced (cudaOccupancyMaxActive-
    BlocksPerMultiprocessor, with the launch's carveout)."""
    import ctypes
    from hpsdf_tpu_torch import _kernels

    lib = _kernels.load_check() if reference else _kernels.load()
    fn = lib.hpsdf_query_vjp_reference_blocks if reference \
        else lib.hpsdf_query_vjp_blocks
    n = ctypes.c_int(0)
    _kernels.check(_kernels.load(), fn(deg, int(hess), ctypes.byref(n)),
                   "query_vjp_blocks")
    return n.value


def wrong_key(keys):
    """A wrong row key for K5h's teeth: each point given the key of the
    point half the points away, a row of the tables but, where the points
    come in key or raster order too, seldom its own."""
    return torch.roll(keys, max(keys.numel() // 2, 1))


# K5h's warps: one whose lanes' keys (a lane past the end taking key 0)
# form more than this many runs stages its rows (csrc/packed_eval.cu
# kHvpStageMin)
HVP_STAGE_MIN = 8


def hvp_staged_warps(keys):
    """(the warps of K5h's launch over the row keys ``keys`` (B,) that
    stage their rows in shared memory, the warps): the kernel's branch,
    decided by the data."""
    k = torch.cat([keys, keys.new_zeros(-keys.numel() % 32)]).view(-1, 32)
    runs = 1 + (k[:, 1:] != k[:, :-1]).sum(1)
    return int((runs > HVP_STAGE_MIN).sum()), k.shape[0]


def wrong_leaf(leaf):
    """A wrong leaf for K1v's and K1h's teeth: each point given the leaf
    of the point before it, a leaf of the tree but not its own."""
    return torch.roll(leaf, 1)


TRACE_FACE_RAYS = 1 << 14          # rays of the face check, an eighth a kind
# the face kinds: each face (axis, end), then an edge (x at hi, z at lo)
TRACE_FACE_KINDS = [((a,), (e,)) for a in range(3) for e in (0, 1)] \
    + [((0, 2), (1, 0))]


def face_rays(tree, n, seed):
    """n rays (origins, dirs, t, hit) f32 on the card, and the face kind of
    each (-1: none), whose hits o + t d are dyadic and exact in f32: an
    eighth inside the root, an eighth on each of TRACE_FACE_KINDS (each
    face of the root, then an edge), t = 1.5 and dirs toward the root's
    centre rounded to sixteenths, so that dfdt is far from 0 on a field
    that grows away from the centre; one ray in 64 missed."""
    rng = np.random.default_rng(seed)
    lo, hi = (np.asarray(x, np.float64) for x in tree.root_aabb)
    u = (np.floor(rng.uniform(0.0, 1.0, (n, 3)) * 1022) + 1) / 1024
    kind = np.arange(n) % (len(TRACE_FACE_KINDS) + 1) - 1
    for k, (axes, ends) in enumerate(TRACE_FACE_KINDS):
        for a, e in zip(axes, ends):
            u[kind == k, a] = e
    p = lo + u * (hi - lo)
    q = u - 0.5
    d = -np.round(q / np.linalg.norm(q, axis=1, keepdims=True) * 16) / 16
    t = np.full(n, 1.5)
    o = p - t[:, None] * d
    hit = np.arange(n) % 64 != 63
    dev = tree.device
    rays = tuple(torch.as_tensor(x, device=dev) for x in (
        o.astype(np.float32), d.astype(np.float32), t.astype(np.float32),
        hit))
    return rays, torch.as_tensor(kind, device=dev)


def trace_face_check(tree, smi, seed):
    """K8's trace form (f32) on rays whose hits lie exactly on a face of
    the root or an edge (face_rays): against trace_vjp_plain, on all the
    rays, within GRAD_RTOL32; against K8 as it was before its redesign
    (coeff_scatter_reference, which keeps the clamp's slope 1 on a face),
    equal within GRAD_RTOL32 on the rays that hit no face and more than
    10 GRAD_RTOL32 apart on the rays of each face kind. Returns the
    errors."""
    from hpsdf_tpu_torch import render as R
    from hpsdf_tpu_torch.query import coeff_scatter_kernel

    tree32 = R._tree_f32(tree)
    rays, kind = face_rays(tree, TRACE_FACE_RAYS, seed)
    o, d, t, hit = rays
    unit = (o + t[:, None] * d - torch.as_tensor(
        tree.config.root_centre, dtype=torch.float32, device=o.device)) \
        * torch.as_tensor(1.0 / tree.config.root_sizes, dtype=torch.float32,
                          device=o.device)
    check(bool((unit.abs() <= 0.5).all()), "face rays: a hit off the root")
    for k, (axes, _) in enumerate(TRACE_FACE_KINDS):
        check(bool((unit[kind == k][:, list(axes)].abs() == 0.5).all()),
              f"face rays: kind {k}'s hits off its face")
    check(bool((unit[kind < 0].abs() < 0.5).all()), "face rays: an inside "
          "hit on a face")
    dt = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        TRACE_FACE_RAYS), dtype=torch.float32, device=o.device)

    def sub(mask):
        return tuple(x[mask] for x in rays), dt[mask]

    got = coeff_scatter_kernel(tree32, dt, rays=rays)
    out = {"plain": rel_err(got, R.trace_vjp_plain(tree32, *rays, dt))}
    check(out["plain"] <= GRAD_RTOL32, f"K8's trace form vs "
          f"trace_vjp_plain on face rays: {out['plain']:.3e}")
    r, w = sub(kind < 0)
    k8 = coeff_scatter_kernel(tree32, w, rays=r)
    out["inside_plain"] = rel_err(k8, R.trace_vjp_plain(tree32, *r, w))
    out["inside_replaced"] = rel_err(k8, coeff_scatter_reference(
        tree32, w, rays=r))
    check(max(out["inside_plain"], out["inside_replaced"]) <= GRAD_RTOL32,
          f"K8's trace form on rays that hit no face vs plain and the "
          f"kernel it replaced: {out['inside_plain']:.3e}, "
          f"{out['inside_replaced']:.3e}")
    out["faces_plain"], out["faces_replaced"] = [], []
    for k in range(len(TRACE_FACE_KINDS)):
        r, w = sub(kind == k)
        k8 = coeff_scatter_kernel(tree32, w, rays=r)
        out["faces_plain"].append(rel_err(k8, R.trace_vjp_plain(tree32, *r,
                                                                w)))
        out["faces_replaced"].append(rel_err(k8, coeff_scatter_reference(
            tree32, w, rays=r)))
    check(max(out["faces_plain"]) <= GRAD_RTOL32
          and min(out["faces_replaced"]) > 10 * GRAD_RTOL32,
          f"K8's trace form on face rays: vs plain {out['faces_plain']}, "
          f"vs the kernel it replaced {out['faces_replaced']}")
    print(f"[grad2] K8's trace form on {TRACE_FACE_RAYS} rays, an eighth "
          f"hitting inside the root, an eighth each face and an edge | "
          f"{smi} | max|kernel - plain| / max|plain| {out['plain']:.3e}; "
          f"the rays that hit no face: vs plain {out['inside_plain']:.3e}, "
          f"vs the kernel it replaced {out['inside_replaced']:.3e}; each "
          f"face and the edge: vs plain "
          f"{[f'{x:.2e}' for x in out['faces_plain']]}, vs the kernel it "
          f"replaced (slope 1 on the face) "
          f"{[f'{x:.2e}' for x in out['faces_replaced']]}", flush=True)
    return out


def grad2_checks(tree, pt, p64, seed, with_teeth=False):
    """The six backward kernels against their plain versions on CUDA
    tensors at the points p64 (B, 3) (f32 for the packed ones), seeded
    cotangents; K1v, K1h and K1c from K1's leaf, which must be the
    descent's (``query_leaf_plain``) with and without the gradient, K1's
    values unchanged by writing it, and K1v and K1h bit for bit the
    kernels they replaced (``query_vjp_reference``). K1c in both orders
    (``query`` both ways of ``outside_value_max``, and
    ``query_with_gradient``), and in one launch with the points' gradient,
    which must be K1v's or K1h's bit for bit. Returns {kernel: (max|kernel
    - plain| / max|plain|, max|kernel - plain|, teeth or None)}; raises
    where one is above its tolerance or, with ``with_teeth``, a wrong
    result passes: for K1v and K1h also a wrong leaf (``wrong_leaf``),
    against the plain version and against the replaced kernel, where the
    VJP is not zero (degree 0's is); for K1c the clamp's slope wrongly
    applied (``centre_sloped``); for K7's form 2 one axis masked
    (``form2_masked``); for K5h wrong row keys (``wrong_key``). K1c is
    also held, on node blocks of 2 and 3 (``parallel.node_block``),
    concatenated, to the plain version (``_blocks``); K7's form 2 takes
    K5's saved key and gradient (NORMALS_SAVE: normals bit for bit
    NORMALS's, keys the plain walk's) and is held to the kernel it replaced
    (``packed_grad_form2_reference``) too. K5h is held by
    ``hvp_checks``."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.query import (_to_unit, coeff_scatter_grad_kernel,
                                       query_centre_vjp_plain, query_kernel,
                                       query_leaf_plain,
                                       query_points_vjp_plain,
                                       query_vjp_kernel,
                                       query_with_gradient_vjp_plain)

    rng = np.random.default_rng(seed)
    dev, B = p64.device, p64.shape[0]

    def rand(*shape, dt=torch.float64):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dt,
                               device=dev)

    p32 = p64.to(torch.float32)
    face64 = _to_unit(tree, p64).abs() == 0.5
    w, wn = rand(B), rand(B, 3)
    w32, wn32 = w.float(), wn.float()
    n_g = B // 2
    v, leaf = query_kernel(tree, p64, False, with_leaf=True)
    vg, g, leaf_g = query_kernel(tree, p64, True, with_leaf=True)
    want_leaf = query_leaf_plain(tree, p64)
    check(torch.equal(leaf, want_leaf) and torch.equal(leaf_g, want_leaf),
          f"K1's leaf vs the descent ({B} points, degree {tree.deg_used})")
    check(torch.equal(v, query_kernel(tree, p64, False))
          and all(map(torch.equal, (vg, g), query_kernel(tree, p64, True))),
          "K1's values or gradients move when it writes the leaf")
    cd, pd = query_with_gradient_vjp_plain(tree, p64, w, wn, leaf=leaf)
    ws, wns = sparse_cotangents(w, wn, seed)
    nr, ng, _ = A.normals_vjp_plain(pt, p32, wn32)
    k1 = {"query_vjp": (query_vjp_kernel(tree, p64, leaf, w),
                        query_points_vjp_plain(tree, p64, w, leaf=leaf),
                        lambda lf: query_vjp_kernel(tree, p64, lf, w),
                        lambda: query_vjp_reference(tree, p64, w)),
          "query_vjp_inside_out": (
              query_vjp_kernel(tree, p64, leaf, w, outside_value_max=False),
              query_points_vjp_plain(tree, p64, w, False, leaf=leaf),
              lambda lf: query_vjp_kernel(tree, p64, lf, w,
                                          outside_value_max=False),
              lambda: query_vjp_reference(tree, p64, w,
                                          outside_value_max=False)),
          "query_vjp_hess": (query_vjp_kernel(tree, p64, leaf, w, wn), pd,
                             lambda lf: query_vjp_kernel(tree, p64, lf, w,
                                                         wn),
                             lambda: query_vjp_reference(tree, p64, w,
                                                         wn))}
    bad = wrong_leaf(leaf)
    for name, (got, want, with_leaf, replaced) in k1.items():
        check(torch.equal(got, replaced()), f"{name} from K1's leaf vs the "
              f"kernel it replaced ({B} points, degree {tree.deg_used}): "
              f"not bit for bit")
    # K1c, each form beside the points' kernel of its order and on node
    # blocks of 2 and 3
    k1c = {}
    for name, cot, ovm, pts_name in (
            ("query_centre_vjp", (w,), True, "query_vjp"),
            ("query_centre_vjp_inside_out", (w,), False,
             "query_vjp_inside_out"),
            ("query_centre_vjp_hess", (w, wn), True, "query_vjp_hess")):
        d_pts, d_c = query_vjp_kernel(tree, p64, leaf, *cot,
                                      outside_value_max=ovm, centre=True)
        check(torch.equal(d_pts, k1[pts_name][0]), f"{name}: the points' "
              f"gradient of K1c's launch vs {pts_name} ({B} points, degree "
              f"{tree.deg_used}): not bit for bit")
        k1c[name] = (query_vjp_kernel(tree, p64, leaf, *cot,
                                      outside_value_max=ovm, points=False,
                                      centre=True),
                     query_centre_vjp_plain(tree, p64, *cot,
                                            outside_value_max=ovm,
                                            leaf=leaf),
                     centre_sloped(tree, leaf, d_pts))
        k1c[name + "_both"] = (d_c, k1c[name][1], k1c[name][2])
        k1c[name + "_blocks"] = (torch.cat([query_vjp_kernel(
            blk, p64, leaf, *cot, outside_value_max=ovm, points=False,
            centre=True) for size in (2, 3) for blk in (
                P.node_block(tree, size, k) for k in range(size))]),
            torch.cat([k1c[name][1]] * 2), torch.cat([k1c[name][2]] * 2))
    # K7's form 2 from what K5's normals forward saved: the normals
    # unchanged by saving, the keys the plain walk's, and the tables'
    # gradient against the kernel it replaced within f32 summation order
    n_save, saved = A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)
    _, saved_plain = A.normals_save_plain(pt, p32)
    check(torch.equal(n_save, A.packed_eval_kernel(pt, p32, A.NORMALS)),
          "K5's normals move when it saves the key and gradient")
    check(torch.equal(saved[:, 0].contiguous().view(torch.int32),
                      saved_plain[:, 0].contiguous().view(torch.int32)),
          f"K5's saved keys vs locate_key_plain ({B} points, degree "
          f"{tree.deg_used})")
    form2 = torch.cat(A.packed_grad_kernel(pt, p32, wn32, 2, saved))
    err = rel_err(form2, torch.cat(packed_grad_form2_reference(pt, p32,
                                                               wn32)))
    check(err <= GRAD2_RTOL32, f"K7's form 2 vs the kernel it replaced ({B} "
          f"points, degree {tree.deg_used}): {err:.3e}")
    cases = {
        **{name: (got, want, GRAD2_RTOL64, face64)
           for name, (got, want, _, _) in k1.items()},
        **{name: (got, want, GRAD2_RTOL64, None, sloped)
           for name, (got, want, sloped) in k1c.items()},
        "coeff_scatter_grad": (coeff_scatter_grad_kernel(tree, p64, w, wn),
                               cd, GRAD2_RTOL64, None),
        "coeff_scatter_grad_sparse": (
            coeff_scatter_grad_kernel(tree, p64, ws, wns),
            query_with_gradient_vjp_plain(tree, p64, ws, wns)[0],
            GRAD2_RTOL64, None),
        "packed_grad_form2": (form2, torch.cat((nr, ng)), GRAD2_RTOL32,
                              None, None, form2_masked(pt, p32, saved,
                                                       wn32)),
    }
    out = {}
    for name, (got, want, tol, face, *sloped) in cases.items():
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        err = rel_err(got, want)
        check(err <= tol, f"{name} vs its plain version ({B} points, "
              f"degree {tree.deg_used}): {err:.3e} > {tol:g}")
        teeth = None
        if with_teeth:
            teeth = grad2_teeth(got, want, tol, face, *sloped)
            if name in k1 and bool(want.any()):
                wrong = k1[name][2](bad)
                teeth += [rel_err(wrong, want) > tol,
                          not torch.equal(wrong, k1[name][3]())]
            check(all(teeth), f"{name}: a wrong result passes the check "
                  f"{teeth}")
        out[name] = (err, float((got - want).abs().max()), teeth)
    return {**out, **hvp_checks(pt, p32, w32, wn32, n_g,
                                f"{B} points, degree {tree.deg_used}",
                                with_teeth)}


def hvp_checks(pt, p32, w32, wn32, n_g, where, with_teeth=False):
    """K5h (both modes) from what its forwards saved, at the points p32
    (B, 3) f32 on the packed tables pt, with the cotangents w32 (B,) and
    wn32 (B, 3), the values mode's Hessian for the first n_g points: the
    fused read bit for bit VALUES_AND_GRAD's, its keys and NORMALS_SAVE's
    the plain walk's (``locate_key_plain``); both modes held to their plain
    versions from the plain forwards' records (``normals_points_vjp_plain``,
    ``values_and_gradient_points_vjp_plain``) and, within the same
    tolerance, to the kernel they replaced (``packed_hvp_reference``;
    ``_replaced`` in the result, no teeth). Returns {name: (max|kernel -
    plain| / max|plain|, max|kernel - plain|, teeth or None)}; raises where
    one is above GRAD2_RTOL_HVP or, with ``with_teeth``, a wrong result
    passes (``grad2_teeth``: a moved entry, the face rule undone where the
    points reach a face, a wrong key, ``wrong_key``). ``where`` names the
    points in the messages."""
    from hpsdf_tpu_torch import accel as A

    face32 = A.to_unit(pt, p32).abs() == 0.5
    _, saved = A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)
    _, saved_plain = A.normals_save_plain(pt, p32)
    keys_plain = saved_plain[:, 0].contiguous().view(torch.int32)
    check(torch.equal(saved[:, 0].contiguous().view(torch.int32),
                      keys_plain), f"K5's saved keys vs locate_key_plain "
          f"({where})")
    *fused, keys = A.packed_eval_kernel(pt, p32, A.VALUES_AND_GRAD_SAVE,
                                        n_grad=n_g)
    check(all(map(torch.equal, fused, A.packed_eval_kernel(
        pt, p32, A.VALUES_AND_GRAD, n_grad=n_g))), "K2's fused read moves "
          f"when it saves the keys ({where})")
    check(torch.equal(keys, keys_plain), f"the fused read's saved keys vs "
          f"locate_key_plain ({where})")
    bad_keys = wrong_key(keys)
    bad_saved = saved.clone()
    bad_saved[:, 0] = bad_keys.view(torch.float32)
    hvp = {"packed_hvp": (
        lambda sv: A.packed_hvp_kernel(pt, p32, A.NORMALS_VJP, cot3=wn32,
                                       saved=sv), saved, bad_saved,
        A.normals_points_vjp_plain(pt, p32, saved_plain, wn32),
        packed_hvp_reference(pt, p32, A.NORMALS_VJP, None, wn32)),
        "packed_hvp_values": (
        lambda sv: A.packed_hvp_kernel(pt, p32, A.VALUES_GRAD_VJP, w32,
                                       wn32[:n_g], sv), keys, bad_keys,
        A.values_and_gradient_points_vjp_plain(pt, p32, keys_plain, w32,
                                               wn32[:n_g]),
        packed_hvp_reference(pt, p32, A.VALUES_GRAD_VJP, w32, wn32[:n_g]))}
    out, replaced = {}, {}
    for name, (k5h, sv, bad, want, ref) in hvp.items():
        got = k5h(sv)
        check(bool(torch.isfinite(got).all()), f"{name}: not finite")
        err = rel_err(got, want)
        check(err <= GRAD2_RTOL_HVP, f"{name} vs its plain version "
              f"({where}): {err:.3e} > {GRAD2_RTOL_HVP:g}")
        teeth = None
        if with_teeth:
            teeth = grad2_teeth(got, want, GRAD2_RTOL_HVP, face32,
                                keyed=k5h(bad))
            check(all(teeth), f"{name}: a wrong result passes the check "
                  f"{teeth} ({where})")
        out[name] = (err, float((got - want).abs().max()), teeth)
        err = rel_err(got, ref)
        check(err <= GRAD2_RTOL_HVP, f"{name} vs the kernel it replaced "
              f"({where}): {err:.3e}")
        replaced[name + "_replaced"] = (err, float((got - ref).abs().max()),
                                        None)
    return {**out, **replaced}


# K1v and K1h from K1's leaf against the kernels they replaced: the
# smallest of the four shapes they are timed at, and the graph's calls
N_SMALL = 1 << 16
PAIR_REPS = 10
# rounds of four readings of path (c)'s profiled step with each K5h: the
# two differ by a few microseconds in some 400, near the readings' spread
STEP_ROUNDS = 2


@contextlib.contextmanager
def replaced_pair():
    """``query`` and ``query_with_gradient`` with the pair of kernels the
    leaf replaced in place of the shipped one: K1 without the leaf, then
    the re-descending K1v / K1h (``query_vjp_reference``)."""
    import unittest.mock

    Q = importlib.import_module("hpsdf_tpu_torch.query")

    def forward(ctx, tree, pts, with_grad, outside_value_max=True):
        ctx.tree = tree
        ctx.save_for_backward(pts, None)
        return Q.query_kernel(tree, pts, with_grad, outside_value_max)

    def backward(tree, pts, leaf, w, wn=None, outside_value_max=True):
        return query_vjp_reference(tree, pts, w, wn, outside_value_max)

    with unittest.mock.patch.object(Q, "_forward", forward), \
            unittest.mock.patch.object(Q, "query_vjp_kernel", backward):
        yield


def leaf_split(tree, p64):
    """What K1's descent costs at the points p64 (B, 3): K1's values from
    given leaves (its node-range leaf launch over every row, lo = 0, hi =
    N) against K1 with its descent, in turns, both in CUDA graphs; the
    values from the leaves bit for bit K1's inside the root."""
    import types

    from hpsdf_tpu_torch.query import (OUTSIDE_VALUE, _to_unit, clip_half,
                                       query_kernel, query_nodes_kernel)

    v, leaf = query_kernel(tree, p64, False, with_leaf=True)
    unit = clip_half(_to_unit(tree, p64)).contiguous()
    block = types.SimpleNamespace(
        lo=0, hi=tree.child_idx.shape[0], device=tree.device,
        deg_used=tree.deg_used, **{k: getattr(tree, k) for k in (
            "child_idx", "centre", "depth", "coeffs")})
    count = query_nodes_kernel.launches
    given = query_nodes_kernel(block, unit, leaf, leaf=True)
    inside = v != OUTSIDE_VALUE
    check(torch.equal(given[inside], v[inside]), "K1's values from given "
          "leaves vs K1's")
    t = turns({"k1_ms": lambda: query_kernel(tree, p64, False),
               "k1_given_leaf_ms": lambda: query_nodes_kernel(
                   block, unit, leaf, leaf=True)}, PAIR_REPS)
    query_nodes_kernel.launches = count
    return {**t, "descent_ms": t["k1_ms"] - t["k1_given_leaf_ms"]}


def leaf_shape(tree, p, seed):
    """K1v and K1h from K1's leaf against the kernels they replaced at the
    points p (B, 3) f64 on ``tree``, in turns in CUDA graphs: K1 with and
    without the leaf (values, and values with gradients); each backward
    beside the replaced kernel, its plain version (from the leaf) and its
    bound (the tree's centres, depths and rows, the points, the
    cotangents and the leaves read once, 24 B a point written; K1v's or
    K1h's operations without a descent); and each pair, K1 with the leaf
    then the backward, beside K1 then the replaced kernel."""
    from hpsdf_tpu_torch.query import (query_kernel, query_points_vjp_plain,
                                       query_vjp_kernel,
                                       query_with_gradient_vjp_plain)

    rng = np.random.default_rng(seed)
    B, dev = p.shape[0], p.device
    w = torch.as_tensor(rng.standard_normal(B), device=dev)
    wn = torch.as_tensor(rng.standard_normal((B, 3)), device=dev)
    _, leaf = query_kernel(tree, p, False, with_leaf=True)
    row = {"points": B, "degree": tree.deg_used}
    for key, grad in (("k1", False), ("k1g", True)):
        row.update(turns({
            f"{key}_ms": lambda: query_kernel(tree, p, grad),
            f"{key}_leaf_ms": lambda: query_kernel(tree, p, grad,
                                                   with_leaf=True)},
            PAIR_REPS))
    for key, hess in (("k1v", False), ("k1h", True)):
        cot = (w, wn) if hess else (w,)

        def plain():
            if hess:
                return query_with_gradient_vjp_plain(tree, p, w, wn,
                                                     leaf=leaf)[1]
            return query_points_vjp_plain(tree, p, w, leaf=leaf)

        def pair_old():
            query_kernel(tree, p, hess)
            return query_vjp_reference(tree, p, *cot)

        def pair_new():
            lf = query_kernel(tree, p, hess, with_leaf=True)[-1]
            return query_vjp_kernel(tree, p, lf, *cot)

        t = turns({"replaced_ms": lambda: query_vjp_reference(tree, p, *cot),
                   "ms": lambda: query_vjp_kernel(tree, p, leaf, *cot),
                   "replaced_pair_ms": pair_old, "pair_ms": pair_new},
                  PAIR_REPS)
        by_bytes = bytes_ms(tree.centre, tree.depth, tree.coeffs, p, *cot,
                            leaf, extra=24 * B)
        by_ops = B * (k1h_ops if hess else k1v_ops)(tree.deg_used, 0) \
            / F64_PEAK * 1e3
        row[key] = {**t, "plain_ms": time_ms(plain, 1),
                    "bound_ms": max(by_bytes, by_ops),
                    "bound_by": "bytes" if by_bytes >= by_ops
                    else "operations",
                    "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops}
    return row


def centre_bound(tree, p, cots, hess):
    """K1c's bound at the points p (B, 3) on ``tree``: K1v's or K1h's
    (the tree's centres, depths and rows, the points, the cotangents and
    the leaves read once, ``k1v_ops`` / ``k1h_ops`` without a descent),
    the (N, 3) table written in place of the points' 24 B a point.
    Returns (bound ms, "bytes" or "operations", bytes ms, operations
    ms)."""
    B = p.shape[0]
    leaf_bytes = 4 * B
    by_bytes = bytes_ms(tree.centre, tree.depth, tree.coeffs, p, *cots,
                        extra=leaf_bytes + 24 * tree.centre.shape[0])
    by_ops = B * (k1h_ops if hess else k1v_ops)(tree.deg_used, 0) \
        / F64_PEAK * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations", by_bytes,
            by_ops)


def centre_shape(tree, p, seed):
    """K1c at the points p (B, 3) f64 on ``tree``, in turns in CUDA graphs
    with K1v / K1h of the same order, from one K1 leaf: each order alone
    (its memset and launch), with the points' gradient in the same launch,
    beside its plain version (``query_centre_vjp_plain`` from the leaf)
    and its bound (``centre_bound``); how crowded the leaves are (points a
    leaf, most and mean over the leaves reached)."""
    from hpsdf_tpu_torch.query import (query_centre_vjp_plain, query_kernel,
                                       query_vjp_kernel)

    rng = np.random.default_rng(seed)
    B, dev = p.shape[0], p.device
    w = torch.as_tensor(rng.standard_normal(B), device=dev)
    wn = torch.as_tensor(rng.standard_normal((B, 3)), device=dev)
    _, leaf = query_kernel(tree, p, False, with_leaf=True)
    per = torch.bincount(leaf.long())
    row = {"points": B, "degree": tree.deg_used,
           "most_points_a_leaf": int(per.max()),
           "mean_points_a_leaf": float(B / int((per > 0).sum()))}
    for key, cot in (("k1c", (w,)), ("k1c_hess", (w, wn))):
        t = turns({
            "points_ms": lambda: query_vjp_kernel(tree, p, leaf, *cot),
            "ms": lambda: query_vjp_kernel(tree, p, leaf, *cot,
                                           points=False, centre=True),
            "both_ms": lambda: query_vjp_kernel(tree, p, leaf, *cot,
                                                centre=True)}, PAIR_REPS)
        bound, by, by_bytes, by_ops = centre_bound(tree, p, cot, len(cot) > 1)
        row[key] = {**t, "plain_ms": time_ms(
            lambda: query_centre_vjp_plain(tree, p, *cot, leaf=leaf), 1),
            "bound_ms": bound, "bound_by": by, "bytes_bound_ms": by_bytes,
            "ops_bound_ms": by_ops}
    return row


def path_steps(tree_s, tree_i, p_a, pts_b, n_t):
    """The device time (torch.profiler) of one step of path (a) (a
    projection step of the points p_a on the slice tree) and of path (b)
    (the oriented-point fit's loss and backward at the samples pts_b on
    tree_i), with the shipped pair and with the one it replaced
    (``replaced_pair``), in turns: {path: (the replaced pair's mean, the
    shipped pair's mean, the four
    readings, the step's K1 and K1v / K1h kernels (name, ms, calls))}."""
    def step_b():
        C = tree_i.coeffs.detach().clone().requires_grad_(True)
        shift = torch.zeros(3, dtype=torch.float64, device=pts_b.device,
                            requires_grad=True)
        oriented_fit_loss(tree_i, C, shift, pts_b, n_t).backward()

    out = {}
    for name, step in (("(a)", lambda: projection_step(tree_s, p_a)),
                       ("(b)", step_b)):
        r, kept = [], {}
        for label in ("replaced", "leaf", "leaf", "replaced"):
            with (replaced_pair() if label == "replaced"
                  else contextlib.nullcontext()):
                step()
                ms, _, k = device_busy_ms(step, keep=("query_kernel",
                                                      "query_vjp"))
            check(ms is not None, f"path {name}'s step: no device time in "
                  "the trace")
            r.append(ms)
            kept[label] = k
        out[name] = ((r[0] + r[3]) / 2, (r[1] + r[2]) / 2, r, kept)
    return out


def hits_times(carved, hits, seed):
    """K7's form 2 at path (c)'s own points, the render's hits on the
    carved tree's packed tables, in a CUDA graph, beside its bound (as at
    2^20 points); K5h's are ``hvp_shape``'s."""
    from hpsdf_tpu_torch import accel as A

    pk = A.pack_tree(carved)
    p32 = hits.to(torch.float32).contiguous()
    B = p32.shape[0]
    rng = np.random.default_rng(seed)
    wn32 = torch.as_tensor(rng.standard_normal((B, 3)), dtype=torch.float32,
                           device=p32.device)
    _, saved = A.packed_eval_kernel(pk, p32, A.NORMALS_SAVE)
    out = {}
    for name, fn, by_bytes, by_ops in (
            ("packed_grad_form2", lambda: A.packed_grad_kernel(
                pk, p32, wn32, 2, saved),
             k7f2_bytes(pk, p32, wn32, saved) / HBM_RATE * 1e3,
             B * k7f2_saved_ops(pk.deg_used) / F32_PEAK * 1e3),):
        ms = graph_ms(fn, 10)
        out[name] = {"ms": ms, "bound_ms": max(by_bytes, by_ops),
                     "bound_by": "bytes" if by_bytes >= by_ops
                     else "operations", "points": B}
    return out


def form2_shape(pt, p32, seed):
    """K7's form 2 at the points p32 (B, 3) f32 on the packed tables pt,
    in turns in CUDA graphs with the kernel it replaced
    (``packed_grad_form2_reference``): alone (from K5's saved values), and
    the pair K5's normals forward and form 2 (NORMALS_SAVE, then form 2)
    against the pair it replaced (NORMALS, then the replaced kernel), with
    K5's forward alone both ways; beside its bound (``k7f2_bytes``,
    ``k7f2_saved_ops``) and the replaced kernel's (``k7f2_ops``)."""
    from hpsdf_tpu_torch import accel as A

    B = p32.shape[0]
    wn = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (B, 3)), dtype=torch.float32, device=p32.device)
    _, saved = A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)

    def pair():
        sv = A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)[1]
        return A.packed_grad_kernel(pt, p32, wn, 2, sv)

    def replaced_pair():
        A.packed_eval_kernel(pt, p32, A.NORMALS)
        return packed_grad_form2_reference(pt, p32, wn)

    t = turns({"ms": lambda: A.packed_grad_kernel(pt, p32, wn, 2, saved),
               "replaced_ms": lambda: packed_grad_form2_reference(pt, p32,
                                                                  wn),
               "pair_ms": pair, "replaced_pair_ms": replaced_pair,
               "k5_save_ms": lambda: A.packed_eval_kernel(pt, p32,
                                                          A.NORMALS_SAVE),
               "k5_ms": lambda: A.packed_eval_kernel(pt, p32, A.NORMALS)},
              PAIR_REPS)
    by_bytes = k7f2_bytes(pt, p32, wn, saved) / HBM_RATE * 1e3
    by_ops = B * k7f2_saved_ops(pt.deg_used) / F32_PEAK * 1e3
    rep_bytes = bytes_ms(p32, wn, pt.rows, pt.grid,
                         extra=packed_read_bytes(pt, p32, True))
    rep_ops = B * k7f2_ops(pt.deg_used) / F32_PEAK * 1e3
    return {**t, "points": B, "bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops,
            "replaced_bound_ms": max(rep_bytes, rep_ops),
            "keys": (1 << 3 * pt.grid_depth) + pt.rows.shape[0],
            "rows_read": torch.unique(saved[:, 0].contiguous().view(
                torch.int32)).numel()}


def hvp_shape(pt, p32, seed):
    """K5h (both modes) at the points p32 (B, 3) f32 on the packed tables
    pt, in turns in CUDA graphs with the kernel it replaced
    (``packed_hvp_reference``): alone (from what the saving forwards
    wrote), and each pair, the saving forward and K5h (NORMALS_SAVE or
    VALUES_AND_GRAD_SAVE, then K5h) against the pair it replaced (NORMALS
    or VALUES_AND_GRAD, then the replaced kernel), with each forward alone
    both ways; beside its bound (``k5h_bytes``, ``k5h_saved_ops``), the
    bound with the saved record's other bytes (``k5h_saved_extra``) and the
    replaced kernel's (the points, cotangents and rows a locate reads,
    ``k5h_ops``). Below 2^20 points each graph holds ten times PAIR_REPS
    calls, so that a reading of these few-microsecond calls spans a few
    tenths of a millisecond. Returns {"normals": {...}, "values": {...},
    "points", "degree", "rows_read", "staged_warps": (the warps that stage
    their rows, the warps; ``hvp_staged_warps``), "reps", "faster": whether
    K5h beats the replaced kernel in both modes, "pairs_no_slower": whether
    its pair with the saving forward is no slower than the replaced pair in
    both}."""
    from hpsdf_tpu_torch import accel as A

    B, deg = p32.shape[0], pt.deg_used
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal(B), dtype=torch.float32,
                        device=p32.device)
    wn = torch.as_tensor(rng.standard_normal((B, 3)), dtype=torch.float32,
                         device=p32.device)
    _, saved = A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)
    keys = A.packed_eval_kernel(pt, p32, A.VALUES_AND_GRAD_SAVE,
                                n_grad=B)[2]
    modes = {
        "normals": (
            lambda sv: A.packed_hvp_kernel(pt, p32, A.NORMALS_VJP, cot3=wn,
                                           saved=sv),
            lambda: packed_hvp_reference(pt, p32, A.NORMALS_VJP, None, wn),
            lambda: A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)[1],
            lambda: A.packed_eval_kernel(pt, p32, A.NORMALS), saved,
            k5h_bytes(pt, p32, saved, wn), bytes_ms(p32, wn),
            k5h_saved_ops(deg, False)),
        "values": (
            lambda sv: A.packed_hvp_kernel(pt, p32, A.VALUES_GRAD_VJP, w, wn,
                                           sv),
            lambda: packed_hvp_reference(pt, p32, A.VALUES_GRAD_VJP, w, wn),
            lambda: A.packed_eval_kernel(pt, p32, A.VALUES_AND_GRAD_SAVE,
                                         n_grad=B)[2],
            lambda: A.packed_eval_kernel(pt, p32, A.VALUES_AND_GRAD,
                                         n_grad=B), keys,
            k5h_bytes(pt, p32, keys, w, wn), bytes_ms(p32, w, wn),
            k5h_saved_ops(deg, True))}
    calls = {}
    for m, (k5h, ref, fwd_save, fwd, sv, *_) in modes.items():
        calls.update({
            f"{m}_ms": lambda k5h=k5h, sv=sv: k5h(sv),
            f"{m}_replaced_ms": ref,
            f"{m}_pair_ms": lambda k5h=k5h, fwd_save=fwd_save: k5h(
                fwd_save()),
            f"{m}_replaced_pair_ms": lambda ref=ref, fwd=fwd: (fwd(), ref()),
            f"{m}_forward_save_ms": fwd_save, f"{m}_forward_ms": fwd})
    reps = PAIR_REPS * (1 if B >= N_QUERY else 10)
    t = turns(calls, reps)
    read = packed_read_bytes(pt, p32, True)
    out = {"points": B, "degree": deg, "reps": reps,
           "rows_read": torch.unique(keys).numel(),
           "staged_warps": hvp_staged_warps(keys)}
    for m, (*_, sv, k5h_b, cot_b, ops) in modes.items():
        by_bytes, by_ops = k5h_b / HBM_RATE * 1e3, B * ops / F32_PEAK * 1e3
        rep_bytes = cot_b + (12 * B + read) / HBM_RATE * 1e3
        rep_ops = B * k5h_ops(deg) / F32_PEAK * 1e3
        extra = k5h_saved_extra(sv)
        out[m] = {**{k[len(m) + 1:]: v for k, v in t.items()
                     if k.startswith(m + "_")},
                  "bound_ms": max(by_bytes, by_ops),
                  "bound_by": "bytes" if by_bytes >= by_ops
                  else "operations",
                  "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops,
                  "saved_extra_bytes": extra,
                  "with_saved_bound_ms": max(
                      (k5h_b + extra) / HBM_RATE * 1e3, by_ops),
                  "replaced_bound_ms": max(rep_bytes, rep_ops)}
    out["faster"] = all(out[m]["ms"] < out[m]["replaced_ms"] for m in modes)
    out["pairs_no_slower"] = all(
        out[m]["pair_ms"] <= out[m]["replaced_pair_ms"] for m in modes)
    return out


@contextlib.contextmanager
def replaced_normals():
    """``normals`` with the pair K7's form 2 replaced: K5's normals
    forward saving only for K5h, where the points need a gradient, then
    the replaced form 2 (``packed_grad_form2_reference``); K5h as
    shipped."""
    import unittest.mock

    from hpsdf_tpu_torch import accel as A

    def forward(ctx, rows, grid, pts, pt):
        ctx.pt = pt
        if not ctx.needs_input_grad[2]:
            ctx.save_for_backward(pts)
            return A.packed_eval_kernel(pt, pts, A.NORMALS)
        n, saved = A.packed_eval_kernel(pt, pts, A.NORMALS_SAVE)
        ctx.save_for_backward(pts, saved)
        return n

    def backward(ctx, wn):
        pts, *saved = ctx.saved_tensors
        wn = wn.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = packed_grad_form2_reference(ctx.pt, pts, wn)
        if ctx.needs_input_grad[2]:
            d_pts = A.packed_hvp_kernel(ctx.pt, pts, A.NORMALS_VJP, cot3=wn,
                                        saved=saved[0])
        return d_rows, d_grid, d_pts, None

    with unittest.mock.patch.object(A._Normals, "forward",
                                    staticmethod(forward)), \
            unittest.mock.patch.object(A._Normals, "backward",
                                       staticmethod(backward)):
        yield


@contextlib.contextmanager
def replaced_hvp():
    """``normals`` and ``values_and_gradient_at`` with the kernel K5h's
    redesign replaced: their forwards saving nothing for K5h (K5's normals
    saving only where the tables need a gradient, for K7's form 2; the
    fused read no keys), then the K5h it replaced
    (``packed_hvp_reference``), which locates each row again; K7 as
    shipped."""
    import unittest.mock

    from hpsdf_tpu_torch import accel as A

    def n_forward(ctx, rows, grid, pts, pt):
        ctx.pt = pt
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            ctx.save_for_backward(pts)
            return A.packed_eval_kernel(pt, pts, A.NORMALS)
        n, saved = A.packed_eval_kernel(pt, pts, A.NORMALS_SAVE)
        ctx.save_for_backward(pts, saved)
        return n

    def n_backward(ctx, wn):
        pts, *saved = ctx.saved_tensors
        wn = wn.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = A.packed_grad_kernel(ctx.pt, pts, wn, 2, *saved)
        if ctx.needs_input_grad[2]:
            d_pts = packed_hvp_reference(ctx.pt, pts, A.NORMALS_VJP, None, wn)
        return d_rows, d_grid, d_pts, None

    def v_forward(ctx, rows, grid, pts, pt, n_grad):
        ctx.save_for_backward(pts)
        ctx.pt, ctx.n_grad = pt, n_grad
        return A.packed_eval_kernel(pt, pts, A.VALUES_AND_GRAD, n_grad=n_grad)

    def v_backward(ctx, w, u):
        (pts,) = ctx.saved_tensors
        pt, w, u = ctx.pt, w.contiguous(), u.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = A.packed_grad_kernel(pt, pts, w, 0)
            if ctx.n_grad:
                g_rows, g_grid = A.packed_grad_kernel(pt, pts[:ctx.n_grad],
                                                      u, 1)
                d_rows, d_grid = d_rows + g_rows, d_grid + g_grid
        if ctx.needs_input_grad[2]:
            d_pts = packed_hvp_reference(pt, pts, A.VALUES_GRAD_VJP, w, u)
        return d_rows, d_grid, d_pts, None, None

    patch = unittest.mock.patch.object
    with patch(A._Normals, "forward", staticmethod(n_forward)), \
            patch(A._Normals, "backward", staticmethod(n_backward)), \
            patch(A._ValuesAndGradient, "forward", staticmethod(v_forward)), \
            patch(A._ValuesAndGradient, "backward", staticmethod(v_backward)):
        yield


def redesign_steps(steps):
    """The device time (torch.profiler) of one step of each path in
    ``steps`` ({path: (step, the context that swaps the replaced kernel
    in, the kernel names kept[, rounds])}), with the shipped kernel and
    with the one it replaced, in turns (replaced, shipped, shipped,
    replaced; ``rounds`` times over, 1 if not given): {path: (the replaced
    kernel's mean, the shipped one's, the readings, the kernels kept
    (name, ms, calls) in the last round)}."""
    out = {}
    for name, (step, swap, keep, *rounds) in steps.items():
        r, kept = [], {}
        for label in ("replaced", "shipped", "shipped", "replaced") * (
                rounds[0] if rounds else 1):
            with (swap() if label == "replaced"
                  else contextlib.nullcontext()):
                step()
                ms, _, k = device_busy_ms(step, keep=keep)
            check(ms is not None, f"path {name}'s step: no device time in "
                  "the trace")
            r.append(ms)
            kept[label] = k
        out[name] = (float(np.mean(r[0::4] + r[3::4])),
                     float(np.mean(r[1::4] + r[2::4])), r, kept)
    return out


def phase_grad2(tree_s, tree_i, mesh, carved, hits, smi, ptxas, pt_r,
                seed=12):
    """The reads' derivatives on the card: K1v and K1h (query.cu's
    backward modes, from K1's leaf), K8g (coeff_scatter.cu), K5h
    (packed_eval.cu, both modes) and K7's form 2 (packed_grad.cu) against
    their plain versions at 2^20 points on the slice tree (a sixteenth on
    the root's faces, some outside) and at every degree 0..12 on
    synthetic_tree, with two wrong results each shown to fail
    (grad2_teeth; K1v and K1h also a wrong leaf), K1v and K1h bit for bit
    the kernels they replaced; K5h also on its other branch, where a
    warp reads its rows itself (hvp_checks at path (c)'s hits and at
    degrees 3 and 5 with the points in key order, each branch's warps
    counted, hvp_staged_warps); each timed in a CUDA graph beside its plain
    version and its bound, with the operations a call puts on the card
    (K1 with the leaf too); K8g also with a third of each cotangent zero,
    and K8's trace form on rays that hit the root's faces
    (trace_face_check). K1v and K1h against the kernels they replaced:
    the split (leaf_split), four shapes (leaf_shape), a profiled step of
    paths (a) and (b) with each pair (path_steps), blocks an SM and
    registers (vjp_blocks, ``ptxas``); K7's form 2 at path (c)'s hits
    (hits_times); K5h from its forwards' saved values in turns with the
    kernel it replaced at 2^20 uniform points, path (c)'s hits, 2^16 and
    2^20 points in the reference-default tree ``pt_r``'s root (degree 5),
    alone and as the pair with its forward (hvp_shape), blocks an SM and
    registers, and a profiled step of path (c) with each K7 form 2 and
    each K5h (redesign_steps). Then the three paths, the launch counts set to
    0 just before and read just after: (a) PROJ_STEPS projection steps of
    2^20 points in the root (projection_step), (b) FIT_STEPS Adam steps of
    the oriented-point fit of the inverse setup's initial tree (the r =
    0.27 sphere, the slice's config) on its coefficients and the samples'
    shift (oriented_fit_loss, 2^20 samples of the icosphere(0.3, 5)
    mesh's triangles), (c) NMAP_STEPS Adam steps of the normal map on the
    carved
    tree's folded coefficients and the hits' shift (normal_map_loss at the
    render's hits); (b)'s and (c)'s first gradients held to the plain
    versions. Returns (launches, {...})."""
    import unittest.mock

    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch.query import (coeff_scatter_grad_kernel,
                                       query_centre_vjp_plain,
                                       query_kernel, query_points_vjp_plain,
                                       query_plain, query_vjp_kernel,
                                       query_with_gradient_plain,
                                       query_with_gradient_vjp_plain)

    dev = tree_s.device
    pt_s = T.pack_tree(tree_s)
    lo, hi = (np.asarray(x, np.float64) for x in tree_s.root_aabb)
    p64 = torch.as_tensor(root_points(lo, hi, N_QUERY, seed, pad=0.05),
                          device=dev)
    out = {"checks": {}, "degrees": {}}
    out["checks"]["2^20 slice"] = grad2_checks(tree_s, pt_s, p64, seed,
                                               with_teeth=True)
    # every degree, one descent below a depth-1 grid (as [degrees])
    cfg = T.Config(continuity=False, root_min=SYNTH_ROOT[0],
                   root_max=SYNTH_ROOT[1])
    from hpsdf_tpu_torch import tree as TT

    def saved_keys(pt, p32):
        return A.packed_eval_kernel(pt, p32, A.NORMALS_SAVE)[1][:, 0] \
            .contiguous().view(torch.int32)

    direct = {"(c) hits": (T.pack_tree(carved),
                           hits.to(torch.float32).contiguous())}
    for deg in range(13):
        tree = TT.pack(*synthetic_tree(deg, seed + deg), cfg, device=dev)
        pts = torch.as_tensor(root_points(SYNTH_ROOT[0], SYNTH_ROOT[1],
                                          N_SYNTH, seed + deg, pad=0.1),
                              device=dev)
        pk = T.pack_tree(tree, grid_depth=1)
        out["degrees"][deg] = grad2_checks(tree, pk, pts, seed + deg,
                                           with_teeth=True)
        if deg in (3, 5):
            p32 = pts.to(torch.float32)
            order = torch.argsort(saved_keys(pk, p32), stable=True)
            direct[f"degree {deg} in key order"] = (pk, p32[order])
    # K5h point by point where its warps read their rows themselves (at
    # most HVP_STAGE_MIN runs of keys a warp): path (c)'s hits, in raster
    # order, and degrees 3 and 5 with the points in key order; most warps
    # at the 2^20 points above stage them
    staged = {"2^20 slice": hvp_staged_warps(saved_keys(
        pt_s, p64.to(torch.float32)))}
    check(staged["2^20 slice"][0] > 0, "no warp of K5h stages its rows at "
          "2^20 slice points: the staged branch unchecked")
    out["direct"] = {}
    rng = np.random.default_rng(seed + 70)
    for name, (pk, p32) in direct.items():
        B = p32.shape[0]
        w32, wn32 = (torch.as_tensor(rng.standard_normal(shape),
                                     dtype=torch.float32, device=dev)
                     for shape in ((B,), (B, 3)))
        out["direct"][name] = hvp_checks(pk, p32, w32, wn32, B // 2, name,
                                         with_teeth=True)
        staged[name] = hvp_staged_warps(saved_keys(pk, p32))
        check(staged[name][0] < staged[name][1], f"every warp of K5h stages "
              f"its rows at {name}: the direct branch unchecked")
    every = [out["checks"]["2^20 slice"], *out["degrees"].values(),
             *out["direct"].values()]
    errs = {k: max(c[k][0] for c in every if k in c)
            for k in out["checks"]["2^20 slice"]}
    abs_errs = {k: max(c[k][1] for c in every if k in c)
                for k in out["checks"]["2^20 slice"]}
    out["staged_warps"] = staged
    print(f"[grad2] K5h point by point on each branch, warps staging their "
          f"rows of the launch's warps: " + ", ".join(
              f"{k} {v[0]} of {v[1]}" for k, v in staged.items())
          + " | where its warps read their rows themselves, max|kernel - "
          "plain| / max|plain| (and against the kernel it replaced): "
          + ", ".join(f"{k}: normals {c['packed_hvp'][0]:.3e} "
                      f"({c['packed_hvp_replaced'][0]:.3e}), values "
                      f"{c['packed_hvp_values'][0]:.3e} "
                      f"({c['packed_hvp_values_replaced'][0]:.3e})"
                      for k, c in out["direct"].items())
          + " | a moved entry, the face rule undone and a wrong key caught "
          "at each", flush=True)
    print(f"[grad2] the six backward kernels against their plain versions "
          f"at 2^20 points on the slice tree (a sixteenth on the root's "
          f"faces, some outside) and at degrees 0-12, max|kernel - plain| / "
          f"max|plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in
                                       errs.items())
          + " (K8g also with a third of each cotangent zero, _sparse; K1c "
          "alone and, _both, in one launch with the points' gradient, bit "
          "for bit K1v's / K1h's) | two wrong results caught at every shape "
          "(a moved entry; the face rule undone, where the points reach a "
          "face; for K1c the clamp's slope applied)",
          flush=True)
    out["trace_faces"] = trace_face_check(tree_s, smi, seed + 50)

    # times at 2^20 points on the slice tree, with the bounds and the
    # operations a call
    rng = np.random.default_rng(seed + 100)
    B = p64.shape[0]
    w = torch.as_tensor(rng.standard_normal(B), device=dev)
    wn = torch.as_tensor(rng.standard_normal((B, 3)), device=dev)
    p32, w32, wn32 = p64.float(), w.float(), wn.float()
    # K1v and K1h read the leaf and no node's children or degree
    arrays = [tree_s.centre, tree_s.depth, tree_s.coeffs]
    _, leaf = query_kernel(tree_s, p64, False, with_leaf=True)
    deg, dep = tree_s.deg_used, tree_s.depth_used
    from hpsdf_tpu_torch.query import _to_unit
    unit = _to_unit(tree_s, p64)
    live = torch.ones(B, dtype=torch.bool, device=dev)
    k8g_bytes = coeff_scatter_bytes(tree_s, unit.clamp(-0.5, 0.5), live,
                                    56, 0, True)
    _, saved_s = A.packed_eval_kernel(pt_s, p32, A.NORMALS_SAVE)
    keys_s = A.packed_eval_kernel(pt_s, p32, A.VALUES_AND_GRAD_SAVE,
                                  n_grad=B)[2]
    shapes = {
        "query_vjp": (
            lambda: query_vjp_kernel(tree_s, p64, leaf, w),
            lambda: query_points_vjp_plain(tree_s, p64, w, leaf=leaf),
            bytes_ms(*arrays, p64, w, leaf, extra=24 * B),
            B * k1v_ops(deg, 0) / F64_PEAK * 1e3, K1V_OPS),
        "query_vjp_hess": (
            lambda: query_vjp_kernel(tree_s, p64, leaf, w, wn),
            lambda: query_with_gradient_vjp_plain(tree_s, p64, w, wn,
                                                  leaf=leaf),
            bytes_ms(*arrays, p64, w, wn, leaf, extra=24 * B),
            B * k1h_ops(deg, 0) / F64_PEAK * 1e3, K1H_OPS),
        **{name: (
            lambda cot=cot: query_vjp_kernel(tree_s, p64, leaf, *cot,
                                             points=False, centre=True),
            lambda cot=cot: query_centre_vjp_plain(tree_s, p64, *cot,
                                                   leaf=leaf),
            *centre_bound(tree_s, p64, cot, len(cot) > 1)[2:], K1C_OPS)
           for name, cot in (("query_centre_vjp", (w,)),
                             ("query_centre_vjp_hess", (w, wn)))},
        "coeff_scatter_grad": (
            lambda: coeff_scatter_grad_kernel(tree_s, p64, w, wn),
            lambda: query_with_gradient_vjp_plain(tree_s, p64, w, wn),
            bytes_ms(extra=k8g_bytes),
            B * k8g_ops(deg, dep) / F64_PEAK * 1e3,
            K8G_OPS),
        "packed_hvp": (
            lambda: A.packed_hvp_kernel(pt_s, p32, A.NORMALS_VJP,
                                        cot3=wn32, saved=saved_s),
            lambda: A.normals_points_vjp_plain(pt_s, p32, saved_s, wn32),
            k5h_bytes(pt_s, p32, saved_s, wn32) / HBM_RATE * 1e3,
            B * k5h_saved_ops(deg, False) / F32_PEAK * 1e3, K5H_OPS,
            lambda: packed_hvp_reference(pt_s, p32, A.NORMALS_VJP, None,
                                         wn32)),
        "packed_hvp_values": (
            lambda: A.packed_hvp_kernel(pt_s, p32, A.VALUES_GRAD_VJP, w32,
                                        wn32, keys_s),
            lambda: A.values_and_gradient_points_vjp_plain(pt_s, p32, keys_s,
                                                           w32, wn32),
            k5h_bytes(pt_s, p32, keys_s, w32, wn32) / HBM_RATE * 1e3,
            B * k5h_saved_ops(deg, True) / F32_PEAK * 1e3, K5H_OPS,
            lambda: packed_hvp_reference(pt_s, p32, A.VALUES_GRAD_VJP, w32,
                                         wn32)),
        "packed_grad_form2": (
            lambda: A.packed_grad_kernel(pt_s, p32, wn32, 2, saved_s),
            lambda: A.normals_tables_vjp_plain(pt_s, p32, saved_s, wn32),
            k7f2_bytes(pt_s, p32, wn32, saved_s) / HBM_RATE * 1e3,
            B * k7f2_saved_ops(deg) / F32_PEAK * 1e3, K7F2_OPS,
            lambda: packed_grad_form2_reference(pt_s, p32, wn32)),
    }
    times = {}
    for name, (kernel, plain, by_bytes, by_ops, limit,
               *replaced) in shapes.items():
        t = {**turns({"ms": kernel, **({"replaced_kernel_ms": replaced[0]}
                                       if replaced else {})}, 10),
             "plain_ms": time_ms(plain, 2),
             "bound_ms": max(by_bytes, by_ops),
             "bound_by": "bytes" if by_bytes >= by_ops else "operations",
             "bytes_bound_ms": by_bytes, "ops_bound_ms": by_ops,
             "library_ms": None, "points": B,
             "launches_a_call": device_ops(kernel)}
        check(1 <= t["launches_a_call"] <= limit, f"{name} puts "
              f"{t['launches_a_call']} operations on the card a call (at "
              f"most {limit})")
        times[name] = t
        print(f"[grad2] {name} at 2^20 points on the slice tree | {smi} | "
              f"kernel {t['ms']:.4f} ms in a CUDA graph"
              + ("" if not replaced else f" (the kernel it replaced, in "
                 f"turns, {t['replaced_kernel_ms']:.4f})") + f", plain "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}; bytes {by_bytes:.5f}, operations "
              f"{by_ops:.5f}; {t['bound_ms'] / t['ms']:.1%} of it) | "
              f"operations on the card a call: {t['launches_a_call']}",
              flush=True)
    leaf_ops = device_ops(lambda: query_kernel(tree_s, p64, True,
                                               with_leaf=True))
    check(leaf_ops == 1, f"K1 with the leaf puts {leaf_ops} operations on "
          "the card a call (1)")

    # K1v and K1h from K1's leaf against the kernels they replaced
    pts, n_t = (torch.as_tensor(x, device=dev) for x in
                oriented_samples(mesh, N_QUERY, seed + 2))
    p_a = torch.as_tensor(root_points(lo, hi, N_QUERY, seed + 1), device=dev)
    leafd = {"split": leaf_split(tree_s, p64), "leaf_ops": leaf_ops}
    sp = leafd["split"]
    print(f"[grad2] the split at 2^20 points on the slice tree | {smi} | K1 "
          f"(values) with its descent {sp['k1_ms']:.4f} ms, from given "
          f"leaves (its node-range leaf launch over every row) "
          f"{sp['k1_given_leaf_ms']:.4f} ms: the descent "
          f"{sp['descent_ms']:.4f} ms", flush=True)
    leafd["shapes"] = {}
    for k, (name, (tree, p)) in enumerate({
            "2^20 uniform": (tree_s, p64),
            "(a) after a step": (tree_s, projection_step(tree_s, p_a)[0]),
            "(b) samples": (tree_i, pts),
            "2^16 uniform": (tree_s, torch.as_tensor(root_points(
                lo, hi, N_SMALL, seed + 3, pad=0.05), device=dev))}.items()):
        row = leafd["shapes"][name] = leaf_shape(tree, p, seed + 200 + k)
        print(f"[grad2] K1v / K1h from K1's leaf at {name} ({row['points']} "
              f"points, degree {row['degree']}) | {smi} | K1 "
              f"{row['k1_ms']:.4f} / with the leaf {row['k1_leaf_ms']:.4f} "
              f"ms, with the gradient {row['k1g_ms']:.4f} / "
              f"{row['k1g_leaf_ms']:.4f} | " + " | ".join(
                  f"{key} {r['ms']:.4f} ms (replaced {r['replaced_ms']:.4f}), "
                  f"plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.5f} "
                  f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%}), pair "
                  f"{r['pair_ms']:.4f} (replaced {r['replaced_pair_ms']:.4f})"
                  for key, r in ((k_, row[k_]) for k_ in ("k1v", "k1h"))),
              flush=True)
    centred = {}
    for k, (name, (tree, p)) in enumerate({
            "2^20 uniform": (tree_s, p64),
            "(b) samples": (tree_i, pts),
            "2^16 uniform": (tree_s, p64[:N_SMALL])}.items()):
        row = centred[name] = centre_shape(tree, p, seed + 400 + k)
        print(f"[grad2] K1c at {name} ({row['points']} points, degree "
              f"{row['degree']}; most points a leaf "
              f"{row['most_points_a_leaf']}, mean "
              f"{row['mean_points_a_leaf']:.1f}) | {smi} | " + " | ".join(
                  f"{key} {r['ms']:.4f} ms (K1v / K1h of its order "
                  f"{r['points_ms']:.4f}, one launch for both "
                  f"{r['both_ms']:.4f}), plain {r['plain_ms']:.3f}, bound "
                  f"{r['bound_ms']:.5f} ({r['bound_by']}; "
                  f"{r['bound_ms'] / r['ms']:.1%})"
                  for key, r in ((k_, row[k_]) for k_ in ("k1c",
                                                          "k1c_hess"))),
              flush=True)
    centred["crowding"] = {key: centred["(b) samples"][key]["ms"]
                           / centred["2^20 uniform"][key]["ms"]
                           for key in ("k1c", "k1c_hess")}
    # K7's form 2 against the kernel it replaced, alone and as the pair
    # with K5's normals forward
    formed = {}
    pk_c = T.pack_tree(carved)
    for k, (name, (pt_, p_)) in enumerate({
            "2^20 uniform": (pt_s, p32),
            "(c) hits": (pk_c, hits.to(torch.float32).contiguous()),
            "2^16 uniform": (pt_s, p32[:N_SMALL])}.items()):
        r = formed[name] = form2_shape(pt_, p_, seed + 500 + k)
        print(f"[grad2] K7's form 2 at {name} ({r['points']} points, "
              f"{r['keys']} keys, {r['rows_read']} rows read) | {smi} | "
              f"{r['ms']:.4f} ms (the kernel it replaced, in turns, "
              f"{r['replaced_ms']:.4f}), bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.1%}; the "
              f"replaced kernel's {r['replaced_bound_ms']:.5f}) | pair with "
              f"K5's normals forward {r['pair_ms']:.4f} (replaced pair "
              f"{r['replaced_pair_ms']:.4f}); K5 saving "
              f"{r['k5_save_ms']:.4f}, not saving {r['k5_ms']:.4f}",
              flush=True)
    leafd["steps"] = path_steps(tree_s, tree_i, p_a, pts, n_t)
    leafd["blocks"] = {f"{d}/{'hess' if h else 'vjp'}": {
        "blocks": vjp_blocks(d, h), "replaced_blocks": vjp_blocks(d, h, True),
        "registers": ptxas.get("query_vjp_kernel", {}).get(
            f"{d}/{'hess' if h else 'vjp'}", [None])[0],
        "replaced_registers": ptxas.get("query_vjp_reference_kernel", {}).get(
            f"{d}/{'hess' if h else 'vjp'}", [None])[0]}
        for d in (3, 5) for h in (False, True)}
    print(f"[grad2] device time of a profiled step (ms; the replaced pair, the "
          f"leaf's pair) | {smi} | " + ", ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f} (readings {v[2]})"
              for k, v in leafd["steps"].items())
          + " | blocks of 128 threads an SM and registers, K1v / K1h from "
          "the leaf against the replaced kernels': " + ", ".join(
              f"{k} {v['blocks']} ({v['replaced_blocks']}), {v['registers']} "
              f"({v['replaced_registers']})" for k, v in leafd["blocks"].items()),
          flush=True)
    # K5h from its forwards' saved values against the kernel it replaced,
    # alone and as the pair with its forward
    lo_r = np.asarray(pt_r.root_centre) - 0.5 * np.asarray(pt_r.root_sizes)
    hi_r = np.asarray(pt_r.root_centre) + 0.5 * np.asarray(pt_r.root_sizes)
    hvpd = {}
    for k, (name, (pt_, p_)) in enumerate({
            "2^20 uniform": (pt_s, p32),
            "(c) hits": (pk_c, hits.to(torch.float32).contiguous()),
            "2^16 uniform": (pt_s, p32[:N_SMALL]),
            "refdefault 2^20": (pt_r, torch.as_tensor(root_points(
                lo_r, hi_r, N_QUERY, seed + 7, pad=0.05), dtype=torch.float32,
                device=dev))}.items()):
        r = hvpd[name] = hvp_shape(pt_, p_, seed + 600 + k)
        print(f"[grad2] K5h at {name} ({r['points']} points, degree "
              f"{r['degree']}, {r['rows_read']} rows read, "
              f"{r['staged_warps'][0]} of {r['staged_warps'][1]} warps "
              f"staging their rows) | {smi} | "
              + " | ".join(
                  f"{m} {x['ms']:.4f} ms (the kernel it replaced, in turns, "
                  f"{x['replaced_ms']:.4f}), bound {x['bound_ms']:.5f} "
                  f"({x['bound_by']}; {x['bound_ms'] / x['ms']:.1%}; with "
                  f"the saved record's other {x['saved_extra_bytes']} B "
                  f"{x['with_saved_bound_ms']:.5f}; the "
                  f"replaced kernel's {x['replaced_bound_ms']:.5f}, "
                  f"{x['replaced_bound_ms'] / x['replaced_ms']:.1%}), pair "
                  f"with its forward {x['pair_ms']:.4f} (replaced pair "
                  f"{x['replaced_pair_ms']:.4f}); forward saving "
                  f"{x['forward_save_ms']:.4f}, not saving "
                  f"{x['forward_ms']:.4f}"
                  for m, x in ((m, r[m]) for m in ("normals", "values")))
              + f" | K5h faster in both modes: {r['faster']}, the pairs no "
              f"slower: {r['pairs_no_slower']}", flush=True)
    hvpd["blocks"] = {f"{d}/{m}": {
        "blocks": hvp_blocks(d, i),
        "registers": ptxas.get("packed_hvp_kernel", {}).get(
            f"{d}/{m}", [None])[0],
        "replaced_registers": ptxas.get(
            "packed_hvp_reference_kernel", {}).get(f"{d}/{m}", [None])[0]}
        for d in (3, 5) for i, m in enumerate(("normals", "values"))}
    print(f"[grad2] K5h blocks of 128 threads an SM and registers (the "
          f"replaced kernel's registers) | {smi} | " + ", ".join(
              f"{k} {v['blocks']}, {v['registers']} "
              f"({v['replaced_registers']})"
              for k, v in hvpd["blocks"].items()), flush=True)
    leafd["hits"] = hits_times(carved, hits, seed + 300)
    print(f"[grad2] at path (c)'s {hits.shape[0]} hits | {smi} | " + ", ".join(
        f"{k} {v['ms']:.4f} ms, bound {v['bound_ms']:.5f} ({v['bound_by']}; "
        f"{v['bound_ms'] / v['ms']:.1%})" for k, v in leafd["hits"].items()),
        flush=True)
    # a profiled step of path (c) with each K7 form 2
    pk_s, sup_s = A.pack_tree(carved), A.pack_support(carved)
    h32 = hits.to(torch.float32).contiguous()
    nh32 = h32 / torch.linalg.norm(h32, dim=-1, keepdim=True)

    def step_c():
        F = (carved.coeffs * sup_s.fold).to(torch.float32) \
            .requires_grad_(True)
        shift = torch.zeros(3, device=dev, requires_grad=True)
        normal_map_loss(pk_s, sup_s, F, shift, h32, nh32).backward()

    redesigned = redesign_steps({
        "(c)": (step_c, replaced_normals, ("normals_grad", "form2_reference",
                                           "packed_eval")),
        "(c) K5h": (step_c, replaced_hvp, ("packed_hvp", "packed_eval"),
                    STEP_ROUNDS)})
    print(f"[grad2] device time of a profiled step (ms; with the replaced "
          f"kernel, with the shipped one; (c) K7's form 2, (c) K5h K5h and "
          f"its forwards' saving) | {smi} | " + ", ".join(
              f"{k} {v[0]:.3f} / {v[1]:.3f} (readings {v[2]})"
              for k, v in redesigned.items()), flush=True)

    # --- the paths: the counts from here to the end of (c) ------------
    reset_counts()
    sync()
    # (a) projection onto the surface
    t0 = time.perf_counter()
    p = torch.as_tensor(root_points(lo, hi, N_QUERY, seed + 1), device=dev)
    f0 = None
    for _ in range(PROJ_STEPS):
        p, f = projection_step(tree_s, p)
        f0 = f if f0 is None else f0
    f_end = T.query(tree_s, p, outside_value_max=False)
    check(bool(torch.isfinite(p).all()), "projection: points not finite")
    proj = {"mean_abs_f_before": float(f0.abs().mean()),
            "mean_abs_f_after": float(f_end.abs().mean()),
            "steps": PROJ_STEPS, "points": N_QUERY}
    sync()
    proj["s"] = time.perf_counter() - t0
    check(proj["mean_abs_f_after"] < proj["mean_abs_f_before"],
          f"projection: mean |f| {proj['mean_abs_f_before']:.4e} -> "
          f"{proj['mean_abs_f_after']:.4e}")
    print(f"[grad2] (a) projection of 2^20 points of the slice tree's root "
          f"(a sixteenth on its faces), {PROJ_STEPS} steps: mean |f| "
          f"{proj['mean_abs_f_before']:.6e} -> {proj['mean_abs_f_after']:.6e}"
          f", {proj['s']:.3f} s", flush=True)

    # (b) oriented-point fit: the initial tree's coefficients and the
    # samples' shift (pts, n_t above)
    params = [tree_i.coeffs.detach().clone().requires_grad_(True),
              torch.zeros(3, dtype=torch.float64, device=dev,
                          requires_grad=True)]
    opt = torch.optim.Adam(params, lr=FIT_LR)
    fit = {"loss": [], "steps": FIT_STEPS, "samples": N_QUERY}
    t0 = time.perf_counter()
    for k in range(FIT_STEPS):
        opt.zero_grad()
        loss = oriented_fit_loss(tree_i, *params, pts, n_t)
        loss.backward()
        fit["loss"].append(float(loss.detach()))
        if k == 0:
            grads = [x.grad.clone() for x in params]
        opt.step()
    sync()
    fit["s"] = time.perf_counter() - t0
    print(f"[grad2] (b) oriented-point fit, {FIT_STEPS} Adam steps on the "
          f"r = 0.27 tree's coefficients and the samples' shift, 2^20 "
          f"samples of icosphere(0.3, 5)'s triangles: loss {fit['loss']}, "
          f"{fit['s']:.3f} s", flush=True)

    # (c) normal map on the carved tree's folded coefficients and the
    # hits' shift
    packed, support = A.pack_tree(carved), A.pack_support(carved)
    hits = hits.to(torch.float32).contiguous()
    n_h = hits / torch.linalg.norm(hits, dim=-1, keepdim=True)
    nparams = [(carved.coeffs * support.fold).to(torch.float32)
               .requires_grad_(True),
               torch.zeros(3, device=dev, requires_grad=True)]
    opt = torch.optim.Adam(nparams, lr=NMAP_LR)
    nmap = {"loss": [], "steps": NMAP_STEPS, "hits": hits.shape[0]}
    t0 = time.perf_counter()
    for k in range(NMAP_STEPS):
        opt.zero_grad()
        loss = normal_map_loss(packed, support, *nparams, hits, n_h)
        loss.backward()
        nmap["loss"].append(float(loss.detach()))
        if k == 0:
            ngrads = [x.grad.clone() for x in nparams]
        opt.step()
    sync()
    nmap["s"] = time.perf_counter() - t0

    # (d) the oriented-point fit of (b) on the centres as well
    dparams = [tree_i.coeffs.detach().clone().requires_grad_(True),
               torch.zeros(3, dtype=torch.float64, device=dev,
                           requires_grad=True),
               tree_i.centre.detach().clone().requires_grad_(True)]
    opt = torch.optim.Adam(dparams, lr=FIT_LR)
    cfit = {"loss": [], "steps": FIT_STEPS, "samples": N_QUERY}
    t0 = time.perf_counter()
    for k in range(FIT_STEPS):
        opt.zero_grad()
        loss = oriented_fit_loss(tree_i, *dparams[:2], pts, n_t,
                                 centre=dparams[2])
        loss.backward()
        cfit["loss"].append(float(loss.detach()))
        if k == 0:
            dgrads = [x.grad.clone() for x in dparams]
        opt.step()
    sync()
    cfit["s"] = time.perf_counter() - t0
    launches = read_counts()
    print(f"[grad2] (c) normal map, {NMAP_STEPS} Adam steps on the carved "
          f"tree's folded coefficients and the shift of the render's "
          f"{hits.shape[0]} hits: loss {nmap['loss']}, {nmap['s']:.3f} s",
          flush=True)
    for k, count in GRAD2_KERNELS.items():
        check(count(launches) > 0, f"{k} never launched on [grad2]'s paths")
    check(launches["query_leaf"] == launches["query_vjp"], f"K1 wrote "
          f"{launches['query_leaf']} leaves for {launches['query_vjp']} "
          "launches of K1v / K1h on [grad2]'s paths")
    check(launches["packed_eval_save"] == launches["packed_grad_form2"],
          f"K5 saved {launches['packed_eval_save']} times for "
          f"{launches['packed_grad_form2']} launches of K7's form 2 on "
          "[grad2]'s paths")
    check(launches["packed_eval_save"] + launches["packed_eval_keys"]
          == launches["packed_hvp"], f"K5 saved {launches['packed_eval_save']}"
          f" records and the fused read {launches['packed_eval_keys']} keys "
          f"for {launches['packed_hvp']} launches of K5h on [grad2]'s paths")
    print(f"[grad2] (d) the oriented-point fit on the centres too, "
          f"{FIT_STEPS} Adam steps on the r = 0.27 tree's coefficients, "
          f"centres and the samples' shift: loss {cfit['loss']}, "
          f"{cfit['s']:.3f} s", flush=True)
    for k, loss, least in (("(b)", fit["loss"], FIT_MIN_DROP),
                           ("(c)", nmap["loss"], NMAP_MIN_DROP),
                           ("(d)", cfit["loss"], FIT_MIN_DROP)):
        check(all(math.isfinite(x) for x in loss)
              and all(b < a for a, b in zip(loss, loss[1:]))
              and loss[-1] <= (1.0 - least) * loss[0],
              f"{k}'s loss does not fall at every step by {least:g} of the "
              f"first in all: {loss}")

    # (b)'s, (d)'s and (c)'s first gradients against the plain versions
    with unittest.mock.patch.object(T, "query", query_plain), \
            unittest.mock.patch.object(T, "query_with_gradient",
                                       query_with_gradient_plain):
        ps = [tree_i.coeffs.detach().clone().requires_grad_(True),
              torch.zeros(3, dtype=torch.float64, device=dev,
                          requires_grad=True)]
        want = torch.autograd.grad(oriented_fit_loss(tree_i, *ps, pts, n_t),
                                   ps)
        ps = [x.detach().clone().requires_grad_(True) for x in (
            tree_i.coeffs, torch.zeros(3, dtype=torch.float64, device=dev),
            tree_i.centre)]
        dwant = torch.autograd.grad(oriented_fit_loss(
            tree_i, *ps[:2], pts, n_t, centre=ps[2]), ps)
    fit["grad_rel_err"] = [rel_err(g, w_) for g, w_ in zip(grads, want)]
    check(max(fit["grad_rel_err"]) <= GRAD2_RTOL64, f"(b)'s gradient vs "
          f"the plain versions: {fit['grad_rel_err']}")
    cfit["grad_rel_err"] = [rel_err(g, w_) for g, w_ in zip(dgrads, dwant)]
    check(max(cfit["grad_rel_err"]) <= GRAD2_RTOL64 and bool(
        dgrads[2].abs().max() > 0), f"(d)'s gradient vs the plain versions "
          f"(coefficients, shift, centres): {cfit['grad_rel_err']}")
    with unittest.mock.patch.object(A, "normals", A.normals_plain), \
            unittest.mock.patch.object(A, "values_and_gradient_at",
                                       A.values_and_gradient_at_plain), \
            unittest.mock.patch.object(
                A, "row_gather",
                lambda t, i, csr=None: A.row_gather_plain(t, i)):
        ps = [(carved.coeffs * support.fold).to(torch.float32)
              .requires_grad_(True),
              torch.zeros(3, device=dev, requires_grad=True)]
        want = torch.autograd.grad(normal_map_loss(packed, support, *ps,
                                                   hits, n_h), ps)
    nmap["grad_rel_err"] = [rel_err(g, w_) for g, w_ in zip(ngrads, want)]
    check(max(nmap["grad_rel_err"]) <= NMAP_RTOL, f"(c)'s gradient vs the "
          f"plain versions: {nmap['grad_rel_err']}")
    print(f"[grad2] the first step's gradients against the plain versions, "
          f"max|kernels - plain| / max|plain| (coefficients, shift): (b) "
          f"{fit['grad_rel_err']}, (c) {nmap['grad_rel_err']}, (d) "
          f"(coefficients, shift, centres) {cfit['grad_rel_err']} | launches "
          f"on the paths: " + ", ".join(f"{k} {count(launches)}" for k, count
                                         in GRAD2_KERNELS.items()),
          flush=True)
    return launches, {"errs": errs, "abs_errs": abs_errs, "times": times,
                      "projection": proj, "oriented_fit": fit,
                      "normal_map": nmap, "centre_fit": cfit,
                      "leaf": leafd, "centre": centred, "form2": formed,
                      "hvp": hvpd, "redesign_steps": redesigned,
                      "hvp_branches": {"staged_warps": out["staged_warps"],
                                       "direct_checks": out["direct"]},
                      "teeth": {k: v[2] for k, v in
                                out["checks"]["2^20 slice"].items()}}


def row_walk(pt, pts):
    """The rows each point's packed read visits (locate_in's walk), one
    tensor a round: its grid cell, then 8^grid_depth + the node row of each
    descent (a point on a leaf keeps its row). The last is the row it
    reads."""
    from hpsdf_tpu_torch import accel as A

    unit = A.to_unit(pt, pts).clamp(-0.5, 0.5)
    g = 1 << pt.grid_depth
    cell = ((unit + 0.5) * g).to(torch.int32).clamp(0, g - 1).long()
    keys = [(cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]]
    row = pt.grid[keys[0]]
    for _ in range(pt.extra_rounds):
        child = A._row_child(row).long()
        cc = row[:, 2:5]
        oct_ = ((unit[:, 0] >= cc[:, 0]).long()
                + ((unit[:, 1] >= cc[:, 1]).long() << 1)
                + ((unit[:, 2] >= cc[:, 2]).long() << 2))
        leaf = child < 0
        keys.append(torch.where(leaf, keys[-1], g ** 3 + child + oct_))
        row = torch.where(leaf[:, None], row,
                          pt.rows[torch.where(leaf, 0, child + oct_)])
    return keys


def rows_read(pt, pts):
    """The row each point's packed read takes: its grid cell, or
    8^grid_depth + the node row of its last descent."""
    return row_walk(pt, pts)[-1]


def packed_read_bytes(pt, pts, whole=False):
    """The table bytes a packed read of pts must move: one 32-byte sector
    (the meta lanes 0-4) of each row its walk visits, or, ``whole``, the
    whole row it reads (its coefficients too) and a sector of each row it
    only passes through."""
    walk = row_walk(pt, pts)
    visited = torch.unique(torch.cat(walk)).numel()
    if not whole:
        return 32 * visited
    read = torch.unique(walk[-1]).numel()
    return 32 * (visited - read) + 4 * pt.width * read


def node_walk(tree, unit):
    """The nodes each unit-cube point's descent on the generic tree visits
    (query.descend), one tensor a round: the root, then the node after each
    round (a point on a leaf keeps it). The last is its leaf."""
    from hpsdf_tpu_torch.query import _round

    cur = torch.zeros(unit.shape[0], dtype=torch.long, device=unit.device)
    walk = [cur]
    for _ in range(tree.depth_used):
        cur = _round(tree, cur, cur, unit)
        walk.append(cur)
    return walk


def coeff_scatter_bytes(tree, unit, live, read_all, read_live, coeff_rows):
    """The bytes a K8 call must move: ``read_all`` bytes of every point to
    tell whether it is live (hit and dt; cot, and the point under the
    sentinel), ``read_live`` more of each live one (its ray or point), a
    32-byte sector of each node row the live points' descents visit, each
    of their leaves' coefficient rows read whole where ``coeff_rows`` (the
    trace form's dfdt), and the (N, C) output written whole."""
    walk = node_walk(tree, unit[live])
    visited = torch.unique(torch.cat(walk)).numel()
    leaves = torch.unique(walk[-1]).numel() if coeff_rows else 0
    c = tree.coeffs
    return (unit.shape[0] * read_all + int(live.sum()) * read_live
            + 32 * visited + leaves * c.shape[1] * c.element_size()
            + c.numel() * c.element_size())


def k8_bytes(tree, w, pts=None, rays=None, outside_value_max=False):
    """(coeff_scatter_bytes, the live points) of one K8 call: the query
    form on f64 ``pts`` with cotangents ``w``, or the trace form on ``rays``
    = (origins, dirs, t, hit) with dt ``w``."""
    from hpsdf_tpu_torch.query import _to_unit

    if rays is None:
        unit = _to_unit(tree, pts)
        live = w != 0
        if outside_value_max:
            live &= torch.all(unit.abs() <= 0.5, dim=-1)
        sentinel = 24 if outside_value_max else 0
        nbytes = coeff_scatter_bytes(tree, unit.clamp(-0.5, 0.5), live,
                                     w.element_size() + sentinel,
                                     24 - sentinel, False)
    else:
        o, d, t, hit = rays
        unit = _to_unit(tree, o + t[:, None] * d).clamp(-0.5, 0.5)
        live = hit & (w != 0)
        nbytes = coeff_scatter_bytes(tree, unit, live, 1 + 4, 12 + 12 + 4,
                                     True)
    return nbytes, int(live.sum())


def k8_call(fn, tree, cot, *, pts=None, rays=None, outside_value_max=False,
            out=None):
    """One launch of a K8 entry point ``fn`` that takes hpsdf_coeff_scatter's
    arguments (the reference's, or a development form's), made as
    query.coeff_scatter_kernel makes them, adding into ``out`` or, as the
    wrapper does, into a zeroed (N, C)."""
    from hpsdf_tpu_torch import _kernels

    trace_form = rays is not None
    dt = torch.float32 if trace_form else torch.float64
    keep = [x.detach().contiguous() for x in (rays if trace_form
                                              else (pts,))]
    cot = cot.detach().contiguous()
    if out is None:
        out = torch.zeros(tree.coeffs.shape, dtype=dt, device=cot.device)
    rc = np.asarray(tree.config.root_centre, np.float64)
    inv = 1.0 / np.asarray(tree.config.root_sizes, np.float64)
    if trace_form:
        rc, inv = rc.astype(np.float32), inv.astype(np.float32)
        ptrs = (None, *(x.data_ptr() for x in keep))
    else:
        ptrs = (keep[0].data_ptr(), None, None, None, None)
    _kernels.check(_kernels.load(), fn(
        tree.child_idx.data_ptr(), tree.centre.data_ptr(),
        tree.depth.data_ptr(), tree.coeffs.detach().data_ptr(),
        tree.deg_used, tree.depth_used, *ptrs, cot.shape[0],
        *map(float, rc), *map(float, inv), cot.data_ptr(),
        int(outside_value_max), dt.itemsize, out.data_ptr(),
        _kernels.stream_of(cot)), "coeff_scatter")
    return out


def coeff_scatter_reference(tree, cot, **kw):
    """K8 as it was before its redesign
    (csrc/check/coeff_scatter_reference.cu), called as its wrapper called
    it: the output zeroed, then one launch."""
    from hpsdf_tpu_torch import _kernels

    return k8_call(_kernels.load_check().hpsdf_coeff_scatter_reference,
                   tree, cot, **kw)


def _dfdt_terms(tree, p, dirs):
    """The terms of dfdt = grad f(p) . d in f64 on the f64 tree, (B, 3C):
    a coefficient times a basis product's derivative along the ray, times
    the clamp's slope on its axis (jnp.clip's: 1 inside the root, 1/2 on a
    face, 0 outside)."""
    from hpsdf_tpu_torch import basis
    from hpsdf_tpu_torch.query import _leaf_frame, _to_unit, clip_slope

    slope = clip_slope(_to_unit(tree, p))
    _, coeffs, local, depth, scale = _leaf_frame(tree, p)
    idx, norms = basis._tables(tree.deg_used, coeffs)
    L, dL = basis.legendre_all_with_derivative(local, tree.deg_used)
    Ls = [L[..., a, idx[:, a]] for a in range(3)]
    dLs = [dL[..., a, idx[:, a]] for a in range(3)]
    cn = coeffs * norms[depth.long()]
    inv = 1.0 / np.asarray(tree.config.root_sizes, np.float64)
    return torch.cat([
        cn * dLs[a] * Ls[(a + 1) % 3] * Ls[(a + 2) % 3]
        * (slope[:, a] * scale * inv[a] * dirs[:, a].double())[:, None]
        for a in range(3)], dim=-1)


def off_faces(tree, rays, ulps=8):
    """The rays (origins, dirs, t, hit) whose hit p = o + t d lies, in f32,
    more than ``ulps`` ulps of 0.5 from every face of the root: there K8's
    trace form and the kernel it replaced
    (csrc/check/coeff_scatter_reference.cu, which keeps the clamp's slope 1
    on a face) take the same dfdt; on a face K8 takes jnp.clip's 1/2."""
    o, d, t, _ = rays
    rc = torch.as_tensor(tree.config.root_centre, dtype=torch.float32,
                         device=o.device)
    inv = torch.as_tensor(1.0 / tree.config.root_sizes, dtype=torch.float32,
                          device=o.device)
    unit = ((o + t[:, None] * d) - rc) * inv
    eps = ulps * float(np.finfo(np.float32).eps) * 0.5
    return torch.all((unit.abs() - 0.5).abs() > eps, dim=-1)


def trace_well_posed(tree, origins, dirs, t):
    """The rays whose trace VJP weight w = -dt / dfdt any two faithful f32
    computations agree on, in f64 on the f64 tree: dfdt's condition number
    (the sum of its terms' magnitudes over |dfdt|) at most TRACE_COND_MAX;
    dfdt the same within 1e-5 whether p = o + t d is rounded once (as a
    fused multiply-add gives it) or twice (a product, then a sum); and
    |dfdt| away from the 1e-6 floor of the weight's divisor. On a random
    polynomial a ray can fail each: dfdt cancels, or it changes fast across
    the ulp by which the two points differ."""
    p2 = (origins + t[:, None] * dirs).double()
    p1 = (origins.double() + t.double()[:, None] * dirs.double()) \
        .to(torch.float32).double()
    terms = _dfdt_terms(tree, p2, dirs)
    dfdt, mag = terms.sum(-1), terms.abs().sum(-1)
    dfdt1 = _dfdt_terms(tree, p1, dirs).sum(-1)
    scale = dfdt.abs().clamp(min=torch.finfo(torch.float64).tiny)
    return ((mag <= TRACE_COND_MAX * dfdt.abs())
            & ((dfdt1 - dfdt).abs() <= 1e-5 * scale)
            & ~((dfdt.abs() > 0.5e-6) & (dfdt.abs() < 2e-6)))


def inverse_chunks(s, chunk, depth_weight=0.1):
    """The inverse step's ray chunks (inverse._padded_chunks), marched on
    the initial tree as fit_to_depth's first step marches them, each with
    its rays (origins, dirs, t, hit), its targets (tt, th), the depth
    term's normaliser dn and its cotangent dt =
    depth_weight * 2 m (t - target t) / dn, m = hit & target hit, dn the
    count of m over all chunks: zero where either trace missed."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch import render as R
    from hpsdf_tpu_torch.inverse import STEP_CAP, _padded_chunks

    pk = A.pack_tree(s["init"])
    out = []
    for o, d, tt, th in _padded_chunks(s["o"], s["d"], s["t_star"],
                                       s["hit_star"], chunk):
        t, hit, _ = R._march(pk, o, d, T_MAX, R.HIT_EPS, R.MAX_STEPS,
                             STEP_CAP)
        out.append(dict(rays=(o, d, t, hit), t=t, hit=hit, tt=tt, th=th,
                        m=(hit & th).to(torch.float32)))
    dn = torch.clamp(sum(c["m"].sum() for c in out), min=1.0)
    for c in out:
        c["dn"] = dn
        c["dt"] = (np.float32(depth_weight) * 2.0 * c["m"]
                   * (c["t"] - c["tt"]) / dn).contiguous()
    return out


def inverse_points(s, rays):
    """The 7n points of an inverse chunk's one read, for the rays ``rays``
    (a slice) of the inverse set-up ``s``."""
    from hpsdf_tpu_torch.inverse import inverse_points_plain

    return inverse_points_plain(s["o"][rays], s["d"][rays],
                                s["t_star"][rays])


def formula_terms(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                  eikonal_weight, depth_weight):
    """An inverse chunk's loss from the values f (7n,) at its points
    (inverse.inverse_points_plain), the band points' gradients g (3n, 3) and the depths, in the torch ops
    fit_to_depth ran before K13 (hpsdf_tpu inverse.py chunk_field, the
    depth term over dn): autograd of it is the yardstick of K13's
    cotangents and of chunk_terms_plain."""
    from hpsdf_tpu_torch.inverse import BAND, FRACS

    half = np.float32(BAND) * np.float32(0.5)
    sw, ew = np.float32(surface_weight), np.float32(eikonal_weight)
    surf_m = th.to(torch.float32)
    n = t.shape[0]
    fsurf, f_in, f_out = f[:n], f[n:2 * n], f[2 * n:3 * n]
    f_free = f[3 * n:].reshape(len(FRACS), n)
    field = (fsurf ** 2 + torch.relu(f_in + half) ** 2
             + torch.relu(half - f_out) ** 2)
    free_sum = torch.sum(surf_m[None] * torch.relu(half - f_free) ** 2)
    gnorm = torch.sqrt(torch.sum(g * g, dim=-1) + 1e-12)
    eik = torch.sum(surf_m.repeat(3) * (gnorm - 1.0) ** 2)
    terms = (sw * (torch.sum(surf_m * field) + free_sum / len(FRACS))
             / surf_n + ew * eik / (3.0 * surf_n))
    m = (hit & th).to(torch.float32)
    return terms + np.float32(depth_weight) * torch.sum(m * (t - tt) ** 2) / dn


def formula_chunk_loss(pk, o, d, tt, th, t, hit, dn, surf_n, surface_weight,
                       eikonal_weight, depth_weight, scratch=None):
    """inverse.chunk_loss as it ran before K13: the points in torch ops
    (inverse.inverse_points_plain), the fused read, formula_terms
    differentiated by autograd (``scratch``, K13's, unused)."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch.inverse import inverse_points_plain

    f, g = A.values_and_gradient_at(pk, inverse_points_plain(o, d, tt),
                                    3 * o.shape[0])
    return formula_terms(f, g, th, hit, t, tt, dn, surf_n, surface_weight,
                         eikonal_weight, depth_weight)


def packed_grad_reference(pt, pts, cot, form):
    """K7 as it was before its redesign (csrc/check/packed_grad_reference.cu,
    a library of its own, on no path of the package), called as its wrapper
    called it: both tables zeroed, then one launch. Returns (d_rows,
    d_grid)."""
    from hpsdf_tpu_torch import _kernels

    pts, cot = pts.contiguous(), cot.contiguous()
    d_rows, d_grid = torch.zeros_like(pt.rows), torch.zeros_like(pt.grid)
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    rc_ = _kernels.load_check().hpsdf_packed_grad_reference(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        pt.grid_depth, pt.extra_rounds, pts.data_ptr(), pts.shape[0],
        *map(float, rc), *map(float, inv), cot.data_ptr(), int(form),
        d_grid.data_ptr(), d_rows.data_ptr(), _kernels.stream_of(pts))
    _kernels.check(_kernels.load(), rc_, "packed_grad_reference")
    return d_rows, d_grid


class RawGradientAlone(torch.autograd.Function):
    """K5's raw gradient in a launch of its own (packed_eval_kernel's
    RAW_GRAD mode), with K7's form 1 as its VJP to the tables: the inverse
    chunk's second read as it was before the fused mode."""

    @staticmethod
    def forward(ctx, rows, grid, pts, pt):
        from hpsdf_tpu_torch import accel as A

        ctx.save_for_backward(pts)
        ctx.pt = pt
        return A.packed_eval_kernel(pt, pts, A.RAW_GRAD)

    @staticmethod
    def backward(ctx, u):
        from hpsdf_tpu_torch import accel as A

        (pts,) = ctx.saved_tensors
        d_rows, d_grid = A.packed_grad_kernel(ctx.pt, pts, u.contiguous(), 1)
        return d_rows, d_grid, None, None


def split_read(pt, pts, n_grad):
    """accel.values_and_gradient_at as two launches, K2 (values_at) and
    K5's raw gradient alone: the read the fused mode replaced."""
    from hpsdf_tpu_torch import accel as A

    sub = pts[:n_grad]
    return (A.values_at(pt, pts),
            RawGradientAlone.apply(pt.rows, pt.grid, sub, pt))


def row_scatter_reference(d_out, idx, n):
    """G's backward as it was before its redesign
    (csrc/check/row_scatter_reference.cu), called as its wrapper called
    it: the table zeroed, then one launch."""
    from hpsdf_tpu_torch import _kernels

    idx = idx.to(torch.int32).contiguous()
    out = torch.zeros((n, d_out.shape[1]), dtype=torch.float32,
                      device=d_out.device)
    if idx.shape[0] == 0:
        return out
    rc_ = _kernels.load_check().hpsdf_row_scatter_reference(
        d_out.data_ptr(), d_out.shape[1], idx.data_ptr(), idx.shape[0], n,
        out.data_ptr(), _kernels.stream_of(d_out))
    _kernels.check(_kernels.load(), rc_, "row_scatter_reference")
    return out


# the traces device_ops discarded, each (the call's name, the host's
# runtime calls that put work on the card in that trace), printed at the end
EMPTY_TRACES = []
RUNTIME_LAUNCHES = ("Launch", "Memset", "Memcpy")


def device_ops(fn, tries=4, most=12):
    """The operations (kernels, memsets, copies) one call of fn() puts on
    the card, counted by torch.profiler: the trace's device activities,
    its user-annotation spans (a record_function's range drawn on the
    device's timeline, no operation) left out. The call is traced until two
    traces that hold an operation agree, up to ``tries`` such traces, and
    the check fails if no two agree. A trace with no record on the device
    at all (the profiler can lose a trace's records whole, [k6 ops]) is
    discarded and taken again, up to ``most`` traces in all, and listed in
    EMPTY_TRACES with the host's runtime calls that put work on the card in
    it; 0 if no trace holds one."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    fn()
    sync()
    counts = []
    for _ in range(most):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = prof.events()
        on_card = [e for e in events if e.device_type == cuda]
        if not on_card:
            EMPTY_TRACES.append((getattr(fn, "__qualname__", "?"), sum(
                1 for e in events if e.device_type != cuda
                and e.name.startswith("cu")
                and any(x in e.name for x in RUNTIME_LAUNCHES))))
            continue
        n = sum(1 for e in on_card
                if not getattr(e, "is_user_annotation", False))
        if n and n in counts:
            return n
        counts.append(n)
        if len(counts) == tries:
            break
    check(not any(counts), f"no two traces of a call agree on its "
          f"operations on the card: {counts}")
    return 0


def k7_ops(deg, form):
    """f32 operations a point of K7 (csrc/packed_grad.cu), an FMA counted
    as two: the frame (9), three Legendre recurrences (12 (deg - 1)) and,
    form 1, their derivatives (6 (deg - 1)) and the chain factors (6);
    a term: form 0, three multiplies; form 1, three products of three and
    the weighted sum (15)."""
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    if form == 0:
        return 9 + 12 * max(deg - 1, 0) + 3 * C
    return 15 + 18 * max(deg - 1, 0) + 15 * C


def device_busy_ms(fn, keep=(), tries=4):
    """fn() under torch.profiler: the device time of its kernels in ms, the
    eight longest by name (ms, launches), and those whose names hold one of
    ``keep``. A trace with no device time (the profiler can lose a trace's
    records whole, as ``device_ops`` finds) is listed in EMPTY_TRACES and
    taken again, up to ``tries`` traces; None where none holds any."""
    from torch.profiler import ProfilerActivity, profile

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ev = [e for e in prof.key_averages() if dev_us(e) > 0]
        if ev:
            break
        EMPTY_TRACES.append((getattr(fn, "__qualname__", "?"), "busy"))
    else:
        return None, [], []

    def entry(e):
        return e.key[:60], round(dev_us(e) / 1e3, 3), e.count

    top = sorted(ev, key=lambda e: -dev_us(e))[:8]
    return (round(sum(dev_us(e) for e in ev) / 1e3, 3),
            [entry(e) for e in top],
            [entry(e) for e in ev if any(k in e.key for k in keep)])


def k13_reference(args, scratch=None):
    """K13's terms as they were before their redesign (csrc/check/
    inverse_terms_reference.cu: one launch writing the loss and the
    cotangents), called as their wrapper called them, into outputs
    allocated once and ``scratch`` (zeroed, a word a ray at least: the
    ticket and a partial a block; None makes one): counted by no launch
    counter. Returns the call, which returns (loss, df, dg, dt)."""
    from hpsdf_tpu_torch import _kernels

    f, g, th, hit, t, tt, dn, surf_n, *weights = args
    n = t.shape[0]
    out = (torch.empty((), dtype=torch.float32, device=f.device),
           torch.empty_like(f), torch.empty_like(g), torch.empty_like(t))
    if scratch is None:
        scratch = torch.zeros(1 + n, dtype=torch.float32, device=f.device)

    def run():
        rc = _kernels.load_check().hpsdf_inverse_terms_reference(
            f.data_ptr(), g.data_ptr(), th.data_ptr(), hit.data_ptr(),
            t.data_ptr(), tt.data_ptr(), n, surf_n.data_ptr(),
            dn.data_ptr(), *(float(np.float32(w)) for w in weights),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            out[3].data_ptr(), scratch.data_ptr(), _kernels.stream_of(f))
        check(rc == 0, f"K13 reference launch: CUDA error {rc}")
        return out
    return run


def k13_vjp_differ(got, ref, go):
    """The entries of (df, dg, dt) whose bits differ from the replaced
    kernel's cotangents ``ref`` times go (torch's df * go on the card)."""
    return sum(int((a.view(torch.int32) != (b * go).view(torch.int32)).sum())
               for a, b in zip(got, ref))


def k13_teeth(got, ref, go):
    """Three wrong VJPs, made from K13's own at ``go`` (not 1), each of
    which the bit-for-bit check must fail: one dg entry an ulp off, dt not
    scaled by go (the go = 1 cotangent), one nonzero df entry's sign
    flipped."""
    df, dg, dt = got
    ulp, flip = dg.clone(), df.clone()
    ulp.view(-1)[0] = torch.nextafter(dg.view(-1)[0],
                                      dg.new_tensor(math.inf))
    k = int(torch.nonzero(df)[0])
    flip[k] = -df[k]
    return {name: k13_vjp_differ(r, ref, go) > 0
            for name, r in (("a dg entry an ulp off", (df, ulp, dt)),
                            ("dt not times go", (df, dg, ref[2])),
                            ("a df sign flipped", (flip, dg, dt)))}


def k13_terms_check(args, scratch, go, label):
    """K13's terms on ``args`` (chunk_terms_plain's): the loss forward twice
    (bit for bit: deterministic) and within K13_LOSS_RTOL of the plain
    version's; the VJP at go = 1 and at ``go`` bit for bit the replaced
    kernel's cotangents times go (k13_vjp_differ), and three wrong VJPs
    caught (k13_teeth); the cotangents, each times its normaliser, within
    K13_COT_RTOL / K13_COT_ATOL of autograd of formula_terms and within
    K13_PLAIN_RTOL of the plain version's. Returns ((loss, df, dg, dt), the
    plain loss, the loss's relative error, the cotangents' errors, the
    mutations caught, the replaced kernel's loss's relative error)."""
    from hpsdf_tpu_torch import inverse as I

    f, g, th, hit, t, tt, dn, surf_n, *weights = args
    loss = I.inverse_loss_kernel(*args, scratch=scratch)
    again = I.inverse_loss_kernel(*args, scratch=scratch)
    one = torch.ones((), device=f.device)
    df, dg, dt = I.inverse_vjp_kernel(*args, go=one)
    out = (loss, df, dg, dt)
    ref = [x.clone() for x in k13_reference(args)()]
    plain = I.chunk_terms_plain(*args)
    leaves = [x.detach().clone().requires_grad_(True) for x in (f, g, t)]
    want = torch.autograd.grad(formula_terms(
        leaves[0], leaves[1], th, hit, leaves[2], tt, dn, surf_n, *weights),
        leaves)
    loss_f, loss_p = float(loss), float(plain[0])
    loss_rel = abs(loss_f - loss_p) / abs(loss_p)
    ref_rel = abs(float(ref[0]) - loss_p) / abs(loss_p)
    check(loss_rel <= K13_LOSS_RTOL, f"K13 loss at {label} {loss_f} vs "
          f"plain {loss_p}: {loss_rel:.3e}")
    check(torch.equal(loss.view(torch.int32), again.view(torch.int32)),
          f"K13's loss launch is not deterministic at {label}")
    differ = {"go 1": k13_vjp_differ((df, dg, dt), ref[1:], one),
              f"go {float(go)!r}": k13_vjp_differ(
                  I.inverse_vjp_kernel(*args, go=go), ref[1:], go)}
    check(not any(differ.values()), f"K13's VJP vs the replaced kernel's "
          f"cotangents times go at {label}: entries differing {differ}")
    teeth = k13_teeth(I.inverse_vjp_kernel(*args, go=go), ref[1:], go)
    check(all(teeth.values()), f"K13's check missed a mutation: {teeth}")
    cot = {}
    for name, got, r, pl, norm in zip(("df", "dg", "dt"), out[1:], want,
                                      plain[1:], (surf_n, surf_n, dn)):
        cot[name] = {"max_abs_err": float((got - r).abs().max()),
                     "max_abs": float(r.abs().max()),
                     "max_abs_err_plain": float((got - pl).abs().max()),
                     "bit_for_bit_plain": bool(torch.equal(got, pl))}
        check(torch.allclose(got * norm, r * norm, rtol=K13_COT_RTOL,
                             atol=K13_COT_ATOL),
              f"K13 {name} at {label} vs autograd of the formula: "
              f"{cot[name]}")
        check(torch.allclose(got, pl, rtol=K13_PLAIN_RTOL,
                             atol=K13_PLAIN_RTOL * float(pl.abs().max())),
              f"K13 {name} at {label} vs its plain version: {cot[name]}")
    return out, loss_p, loss_rel, cot, teeth, ref_rel


def check_k13(s, smi, weights=(1.0, 0.1, 0.1)):
    """K13 at one 1080p chunk (the middle one, 2^16 rays, marched on the
    initial tree as the first step marches it): the points bit for bit
    their plain version; the terms by k13_terms_check at the chunk's
    values, at a seeded go, and on seeded values and gradients at the
    chunk's masks. Timed in CUDA graphs: the points, the loss and the VJP
    alone, and the pair (the loss, then the VJP at go, the launches a
    chunk's forward and backward make) in turns with the replaced form
    (its launch and the three torch scalings by go that its backward made:
    replaced, pair, pair, replaced; each the smaller of its two), beside
    their plain versions and bounds; a chunk launches each kernel once (the
    counters), and the operations a chunk's points and terms put on the
    card, forward and backward, by torch.profiler (at most
    K13_POINT_LAUNCHES and K13_TERM_LAUNCHES) beside the torch ops'.
    Launches made here are not the main path's."""
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch import inverse as I

    chunks = inverse_chunks(s, 1 << 16)
    c = chunks[len(chunks) // 2]
    o, d, t, hit = c["rays"]
    tt, th, dn = c["tt"], c["th"], c["dn"]
    surf_n = torch.clamp(s["hit_star"].sum().to(torch.float32), min=1.0)
    n = o.shape[0]
    counts = (I.inverse_points_kernel.launches, I.inverse_loss_kernel.launches,
              I.inverse_vjp_kernel.launches)
    pts = I.inverse_points_kernel(o, d, tt)
    pts_p = I.inverse_points_plain(o, d, tt)
    check(torch.equal(pts, pts_p), f"K13 points vs plain: "
          f"{int((pts != pts_p).sum())} coordinates differ")
    pk = A.pack_tree(s["init"])
    f, g = A.values_and_gradient_at(pk, pts, 3 * n)
    args = (f, g, th, hit, t, tt, dn, surf_n, *weights)
    scratch = I.inverse_terms_scratch(n, f.device)
    rng = np.random.default_rng(0)
    go = torch.tensor(np.float32(rng.uniform(0.25, 4.0)), device=f.device)
    (loss, df, dg, dt), loss_p, loss_rel, cot, teeth, ref_rel = \
        k13_terms_check(args, scratch, go, "a 1080p chunk")
    # the same rays with seeded values about the band and gradients about
    # unit norm, where every term is live (the chunk's free-space points
    # mostly lie outside the band, and its |g| near 1)
    seeded = tuple(torch.as_tensor(x, device=f.device) for x in (
        rng.uniform(-0.03, 0.03, 7 * n).astype(np.float32),
        (rng.normal(size=(3 * n, 3)) * 0.6).astype(np.float32)))
    _, _, rel_s, cot_s, teeth_s, ref_rel_s = k13_terms_check(
        seeded + args[2:], scratch, go, "seeded values")
    leaves = [x.detach().clone().requires_grad_(True) for x in (f, g, t)]
    one = torch.ones((), device=f.device)

    def terms_grad(fn):
        return lambda: torch.autograd.grad(
            fn(leaves[0], leaves[1], th, hit, leaves[2], tt, dn, surf_n,
               *weights), leaves, one)

    def k13_terms(f_, g_, th_, hit_, t_, *rest):
        return I._ChunkTerms.apply(f_, g_, t_, th_, hit_, rest[0], rest[1],
                                   rest[2], tuple(rest[3:]), scratch)

    ref = k13_reference(args)

    def replaced():
        _, rdf, rdg, rdt = ref()
        return rdf * go, rdg * go, rdt * go

    def pair():
        return (I.inverse_loss_kernel(*args, scratch=scratch),
                I.inverse_vjp_kernel(*args, go=go))
    turns = {"replaced_pair_ms": [], "pair_ms": []}
    for key, fn in (("replaced_pair_ms", replaced), ("pair_ms", pair),
                    ("pair_ms", pair), ("replaced_pair_ms", replaced)):
        turns[key].append(graph_ms(fn, 20))
    t_ = {"rays": n, "loss_rel_err": loss_rel,
          "loss_abs_err": abs(float(loss) - loss_p), "cotangents": cot,
          "replaced_loss_rel_err": ref_rel, "teeth": teeth,
          "seeded_loss_rel_err": rel_s, "seeded_cotangents": cot_s,
          "seeded_replaced_loss_rel_err": ref_rel_s,
          "seeded_teeth": teeth_s, "go": float(go),
          "vjp_bit_for_bit_replaced_times_go": True,
          "points_bit_for_bit": True,
          **{k: min(v) for k, v in turns.items()},
          "points_ms": graph_ms(lambda: I.inverse_points_kernel(o, d, tt),
                                20),
          "points_plain_ms": time_ms(
              lambda: I.inverse_points_plain(o, d, tt), 5),
          "loss_ms": graph_ms(lambda: I.inverse_loss_kernel(
              *args, scratch=scratch), 20),
          "loss_plain_ms": time_ms(lambda: I.chunk_terms_plain(*args), 5),
          "vjp_ms": graph_ms(lambda: I.inverse_vjp_kernel(*args, go=go),
                             20),
          "vjp_plain_ms": time_ms(
              lambda: I.chunk_terms_vjp_plain(*args, go), 5),
          "replaced_ms": graph_ms(ref, 20),
          "points_ops": device_ops(lambda: I.inverse_points(o, d, tt)),
          "terms_ops": device_ops(terms_grad(k13_terms)),
          "formula_points_ops": device_ops(
              lambda: I.inverse_points_plain(o, d, tt)),
          "formula_terms_ops": device_ops(terms_grad(formula_terms))}
    k0 = (I.inverse_points_kernel.launches, I.inverse_loss_kernel.launches,
          I.inverse_vjp_kernel.launches)
    terms_grad(k13_terms)()
    I.inverse_points(o, d, tt)
    check((I.inverse_points_kernel.launches - k0[0],
           I.inverse_loss_kernel.launches - k0[1],
           I.inverse_vjp_kernel.launches - k0[2]) == (1, 1, 1),
          "a chunk's points, loss and VJP did not launch K13 once each")
    inputs = bytes_ms(f, g, th, hit, t, tt, dn, surf_n)
    for key, bts, ops in (
            ("points", bytes_ms(o, d, tt, pts), n * K13_POINT_OPS),
            ("loss", inputs + bytes_ms(loss), n * K13_LOSS_OPS),
            ("vjp", inputs + bytes_ms(go, df, dg, dt), n * K13_VJP_OPS),
            ("pair", 2 * inputs + bytes_ms(loss, go, df, dg, dt),
             n * (K13_LOSS_OPS + K13_VJP_OPS))):
        by_ops = ops / F32_PEAK * 1e3
        t_[f"{key}_bytes_bound_ms"], t_[f"{key}_ops_bound_ms"] = bts, by_ops
        t_[f"{key}_bound_ms"] = max(bts, by_ops)
        t_[f"{key}_bound_by"] = "bytes" if bts >= by_ops else "operations"
    check(1 <= t_["points_ops"] <= K13_POINT_LAUNCHES
          and 1 <= t_["terms_ops"] <= K13_TERM_LAUNCHES,
          f"K13 puts {t_['points_ops']} + {t_['terms_ops']} operations on "
          f"the card a chunk (at most {K13_POINT_LAUNCHES} + "
          f"{K13_TERM_LAUNCHES}: the points' launch; the loss's launch and "
          "the VJP's)")
    (I.inverse_points_kernel.launches, I.inverse_loss_kernel.launches,
     I.inverse_vjp_kernel.launches) = counts
    print(f"[k13] a 1080p chunk ({n} rays, {int(th.sum())} target hits): "
          f"points bit for bit plain; loss {float(loss):.8g} vs plain "
          f"{loss_p:.8g} ({loss_rel:.3e}; the replaced kernel's "
          f"{ref_rel:.3e}), deterministic; the VJP at go 1 and at go "
          f"{float(go)!r} bit for bit the replaced kernel's cotangents "
          f"times go, mutations caught {teeth}; cotangents vs autograd of "
          f"the formula and the plain version {cot}; on seeded values, loss "
          f"{rel_s:.3e} (replaced {ref_rel_s:.3e}), {cot_s}, mutations "
          f"caught {teeth_s} | {smi} | points "
          f"{t_['points_ms']:.4f} ms in a CUDA graph (plain "
          f"{t_['points_plain_ms']:.3f}), bound {t_['points_bound_ms']:.5f} "
          f"ms ({t_['points_bound_by']}), "
          f"{t_['points_bound_ms'] / t_['points_ms']:.1%} of it | terms: the"
          f" pair (loss, then VJP at go) {t_['pair_ms']:.4f} ms (turns "
          f"{turns['pair_ms']}), the replaced launch and three scalings "
          f"{t_['replaced_pair_ms']:.4f} ({turns['replaced_pair_ms']}), "
          f"the replaced launch alone {t_['replaced_ms']:.4f}; pair bound "
          f"{t_['pair_bound_ms']:.5f} ms ({t_['pair_bound_by']}), "
          f"{t_['pair_bound_ms'] / t_['pair_ms']:.1%} of it; the loss alone"
          f" {t_['loss_ms']:.4f} ms (plain {t_['loss_plain_ms']:.3f}), "
          f"bound {t_['loss_bound_ms']:.5f}, "
          f"{t_['loss_bound_ms'] / t_['loss_ms']:.1%}; the VJP alone "
          f"{t_['vjp_ms']:.4f} ms (plain {t_['vjp_plain_ms']:.3f}), bound "
          f"{t_['vjp_bound_ms']:.5f}, "
          f"{t_['vjp_bound_ms'] / t_['vjp_ms']:.1%} | operations on the "
          f"card a chunk: points {t_['points_ops']}, terms forward and "
          f"backward {t_['terms_ops']}; the torch ops' "
          f"{t_['formula_points_ops']} + {t_['formula_terms_ops']}",
          flush=True)
    return t_


def phase_k14_ops(rows, table, fit_pts, t):
    """The operations a sign call puts on the card, by torch.profiler
    (after [grad]: traces taken before the phases that replay CUDA graphs
    have left later ones empty), at the slice fit's largest batch on P1's
    best indices: K14's at most K14_LAUNCHES, beside the sign as it was
    before K14. Adds them to [k14]'s numbers ``t``. Launches made here are
    not the main path's."""
    from hpsdf_tpu_torch.accel import row_gather
    from hpsdf_tpu_torch.mesh import closest_tri_tiles
    from hpsdf_tpu_torch.mesh import sdf as TS

    counts = (closest_tri_tiles.launches, TS.signed_from_best_kernel.launches,
              row_gather.launches)
    pts = fit_pts.to(torch.float32)
    _, idx = closest_tri_tiles(rows, pts, table)
    t.update(launches_a_call=device_ops(
        lambda: TS._signed_from_best(rows, idx, pts)),
        before_launches_a_call=device_ops(lambda: sign_before(rows, idx,
                                                              pts)))
    (closest_tri_tiles.launches, TS.signed_from_best_kernel.launches,
     row_gather.launches) = counts
    check(1 <= t["launches_a_call"] <= K14_LAUNCHES, f"K14 puts "
          f"{t['launches_a_call']} operations on the card a call (at most "
          f"{K14_LAUNCHES})")
    print(f"[k14] operations on the card a sign call at the slice fit's "
          f"largest batch: {t['launches_a_call']}, the sign as before K14 "
          f"{t['before_launches_a_call']}", flush=True)


def replaced_chunk_terms(scratch):
    """inverse._ChunkTerms as it was before K13's terms were redesigned:
    the replaced kernel (``k13_reference`` with ``scratch``) writes the
    loss and the cotangents in the forward, the backward scales them by
    the loss's cotangent in three torch launches."""

    class ReplacedChunkTerms(torch.autograd.Function):
        @staticmethod
        def forward(ctx, f, g, t, th, hit, tt, dn, surf_n, weights,
                    _scratch=None):
            loss, df, dg, dt = k13_reference(
                (f, g, th, hit, t, tt, dn, surf_n, *weights), scratch)()
            ctx.save_for_backward(df, dg, dt)
            return loss

        @staticmethod
        def backward(ctx, go):
            df, dg, dt = ctx.saved_tensors
            return (df * go, dg * go, dt * go) + (None,) * 7
    return ReplacedChunkTerms


def step_ops(fit):
    """The operations one more step puts on the card: a two-step run's
    less a one-step run's (set-up and the last copies cancel)."""
    return device_ops(lambda: fit(2)) - device_ops(lambda: fit(1))


def phase_inverse(s, s_small, smi):
    """fit_to_depth at bench.py's 1080p protocol for INV_STEPS steps on the
    card: the depth RMSE and hit overlap before and after, the warm
    seconds a step (after a one-step run), the losses finite and every
    kernel of the path launched; then the INV_SMALL^2 protocol with the
    kernels against the same run with the plain versions on CUDA tensors
    (the wrappers swapped for their plain versions, so that no kernel
    launches): losses within INV_LOSS_RTOL a step. One step runs under
    torch.profiler, and once more with K7, G's backward and K8 swapped for
    the kernels they replaced and the fused read split into K2 and K5's raw
    gradient again, to set their device time in a step beside the earlier
    forms'; and the warm seconds, device busy ms and operations a step
    (``step_ops``) with K13 and with the chunk's loss as it ran before K13
    (``formula_chunk_loss`` swapped in); and a step's operations with K13's
    terms as they were before their redesign (``replaced_chunk_terms``),
    two more a chunk. Returns (launches, the numbers)."""
    from unittest import mock
    from hpsdf_tpu_torch import accel as A
    from hpsdf_tpu_torch import inverse as I
    from hpsdf_tpu_torch import render as R
    from hpsdf_tpu_torch.inverse import fit_to_depth

    def fit(st, n):
        return fit_to_depth(st["init"], st["o"], st["d"], st["t_star"],
                            st["hit_star"], n_steps=n, t_max=T_MAX)

    rmse0, hit0 = depth_rmse(s["init"], s)
    fit(s, 1)                                   # warm: allocator, streams
    reset_counts()
    sync()
    t1 = time.perf_counter()
    res = fit(s, INV_STEPS)
    losses = res.losses.cpu()
    sync()
    step_s = (time.perf_counter() - t1) / INV_STEPS
    launches = read_counts()
    check(bool(torch.isfinite(losses).all()), f"1080p losses {losses}")
    for k in ("march", "packed_eval", "packed_eval_fused", "packed_grad",
              "row_gather", "row_scatter", "row_scatter_csr",
              "coeff_scatter", "inverse_points", "inverse_loss",
              "inverse_vjp"):
        check(launches[k] > 0, f"{k} never launched by fit_to_depth")
    check(launches["packed_eval_raw"] == 0, f"fit_to_depth launched K5's "
          f"raw gradient on its own {launches['packed_eval_raw']} times")
    rmse1, hit1 = depth_rmse(res.tree, s)
    # one profiled step, then one with K7, G's backward and K8 replaced by
    # the kernels they replaced, called as their wrappers called them, and
    # the values and raw gradients read in two launches again
    mine = ("packed_grad", "row_scatter", "coeff_scatter", "packed_eval",
            "Memset")
    busy_ms, top, mine_ms = device_busy_ms(lambda: fit(s, 1), mine)
    ops_step = step_ops(lambda n: fit(s, n))
    # the same step with the chunk's loss as fit_to_depth ran it before K13
    # (formula_chunk_loss: the torch ops, differentiated by autograd)
    with mock.patch.object(I, "chunk_loss", formula_chunk_loss):
        fit(s, 1)
        sync()
        t1 = time.perf_counter()
        fit(s, INV_STEPS).losses.cpu()
        sync()
        formula_step_s = (time.perf_counter() - t1) / INV_STEPS
        formula_busy, formula_top, _ = device_busy_ms(lambda: fit(s, 1), ())
        formula_ops_step = step_ops(lambda n: fit(s, n))
    # the same step with K13's terms as they were before their redesign
    # (ReplacedChunkTerms: the replaced kernel forward, three torch
    # scalings backward): the redesign saves 2 operations a chunk
    chunks_a_step = -(-s["o"].shape[0] // (1 << 16))
    with mock.patch.object(I, "_ChunkTerms", replaced_chunk_terms(
            torch.zeros(1 + (1 << 16), device=s["o"].device))):
        replaced_ops_step = step_ops(lambda n: fit(s, n))
    check(replaced_ops_step - ops_step == 2 * chunks_a_step,
          f"operations on the card a step: {ops_step}, with K13's terms as "
          f"before their redesign {replaced_ops_step}; the redesign saves "
          f"2 a chunk, {2 * chunks_a_step} a step")
    with mock.patch.object(A, "packed_grad_kernel", packed_grad_reference), \
            mock.patch.object(A, "row_scatter",
                              lambda d_out, idx, n, csr=None:
                              row_scatter_reference(d_out, idx, n)), \
            mock.patch.object(R, "coeff_scatter_kernel",
                              lambda tree, cot, rays:
                              coeff_scatter_reference(tree, cot, rays=rays)), \
            mock.patch.object(A, "values_and_gradient_at", split_read):
        busy_ref, _, replaced = device_busy_ms(lambda: fit(s, 1), mine)

    def plain_march(pt, o, d, t_max, hit_eps, max_steps, step_cap=None,
                    **kw):
        return R._march_block(pt, o, d, t_max, hit_eps, max_steps, step_cap,
                              lo=pt.lo)

    small = fit(s_small, INV_STEPS).losses.cpu()
    reset_counts()
    with mock.patch.object(A, "values_and_gradient_at",
                           A.values_and_gradient_at_plain), \
            mock.patch.object(A, "row_gather",
                              lambda table, idx, csr=None:
                              A.row_gather_plain(table, idx)), \
            mock.patch.object(R, "_march", plain_march), \
            mock.patch.object(R, "trace_vjp", R.trace_vjp_plain), \
            mock.patch.object(I, "inverse_points_kernel",
                              I.inverse_points_plain), \
            mock.patch.object(I, "inverse_loss_kernel",
                              lambda *args, scratch=None:
                              I.chunk_terms_plain(*args)[0]), \
            mock.patch.object(I, "inverse_vjp_kernel",
                              I.chunk_terms_vjp_plain):
        plain = fit(s_small, INV_STEPS).losses.cpu()
    plain_launches = sum(read_counts().values())
    check(plain_launches == 0, f"the plain run launched {plain_launches} "
          "kernels")
    rel = float(((small - plain) / plain).abs().max())
    check(rel <= INV_LOSS_RTOL, f"{INV_SMALL}^2 losses, kernels {small} vs "
          f"plain {plain}: {rel:.3e}")
    out = {"rays": s["o"].shape[0], "steps": INV_STEPS, "step_s": step_s,
           "losses": losses.tolist(), "rmse_before": rmse0,
           "rmse_after": rmse1, "hit_overlap_before": hit0,
           "hit_overlap_after": hit1, "small_losses": small.tolist(),
           "small_plain_losses": plain.tolist(), "small_rel_err": rel,
           "profiled_step_device_ms": busy_ms, "profiled_step_top": top,
           "profiled_step_backward": mine_ms,
           "replaced_profiled_step_device_ms": busy_ref,
           "replaced_profiled_step_backward": replaced,
           "device_ops_a_step": ops_step,
           "formula_step_s": formula_step_s,
           "formula_profiled_step_device_ms": formula_busy,
           "formula_profiled_step_top": formula_top,
           "formula_device_ops_a_step": formula_ops_step,
           "replaced_terms_device_ops_a_step": replaced_ops_step,
           "replaced_terms_recorded_device_ops_a_step":
           K13_REPLACED_STEP_OPS}
    print(f"[inverse] {INV_SIZE[0]}x{INV_SIZE[1]} rays, sphere r = 0.27 "
          f"towards 0.3 ({s['init'].n_nodes} nodes): {INV_STEPS} steps, "
          f"losses {[f'{v:.6g}' for v in out['losses']]} | {smi} | warm "
          f"{step_s:.4f} s a step; a one-step run under torch.profiler: "
          f"device busy {busy_ms} ms, by kernel {top}; K7, G's backward, "
          f"K8, K2/K5 and zero-fills {mine_ms}; with the kernels they "
          f"replaced (K2 and K5's raw gradient in two launches): device busy"
          f" {busy_ref} ms, {replaced}; operations on the card a step "
          f"{ops_step} (with K13's terms as before their redesign "
          f"{K13_REPLACED_STEP_OPS} recorded, {replaced_ops_step} in this "
          f"run) | with "
          f"the chunk's loss as before K13 (torch ops and "
          f"autograd): warm {formula_step_s:.4f} s a step, device busy "
          f"{formula_busy} ms, by kernel {formula_top}, operations on the "
          f"card a step {formula_ops_step} | depth RMSE "
          f"{rmse0:.6f} -> {rmse1:.6f}, "
          f"hit overlap {hit0:.6f} -> {hit1:.6f} | launches {launches} | "
          f"{INV_SMALL}^2: losses with the kernels "
          f"{[f'{v:.6g}' for v in out['small_losses']]}, plain versions on "
          f"CUDA tensors {[f'{v:.6g}' for v in out['small_plain_losses']]}, "
          f"max relative difference {rel:.3e}", flush=True)
    return launches, out


SYNTH_ROOT = ((-0.25, -0.25, -0.25), (1.75, 1.75, 1.75))
N_SYNTH = 4096
SYNTH_T_MAX = 8.0                   # rays from 2.75 in front of the root
SYNTH_T_ATOL = 0.05                 # K3 t on common hits, synthetic fields


def synthetic_tree(degree, seed):
    """A depth-2 octree over SYNTH_ROOT as the arrays of ``tree.pack``: the
    root, its eight children, and the eight children of each odd-numbered
    child, in the build's node order; every leaf of basis degree
    ``degree``, with seeded normal coefficients scaled by 2^-p at total
    degree p and divided by coeff_norms, so that the folded coefficients
    (the packed lanes) are N(0, 4^-p). Returns (child_idx, centre, depth,
    degree, coeffs, n_nodes)."""
    from hpsdf_tpu_torch import basis, consts

    child, centre, depth = [1], [(0.0, 0.0, 0.0)], [0]
    for parent, d in ((0, 0), *((k, 1) for k in range(2, 9, 2))):
        if parent:
            child[parent] = len(child)
        q = 2.0 ** -(d + 2)
        for o in range(8):
            centre.append(tuple(centre[parent][a] + (q if o >> a & 1 else -q)
                                for a in range(3)))
            child.append(-1)
            depth.append(d + 1)
    child = np.asarray(child, np.int32)
    depth = np.asarray(depth, np.int32)
    leaf = child < 0
    C = consts.coeff_count(degree)
    p = basis.basis_indices(degree).sum(axis=1)
    coeffs = np.random.default_rng(seed).standard_normal((len(child), C))
    coeffs *= 0.5 ** p / basis.coeff_norms(degree)[depth]
    coeffs[~leaf] = 0.0
    return (child, np.asarray(centre, np.float64), depth,
            np.where(leaf, degree, -1).astype(np.int32), coeffs, len(child))


def phase_degrees(dev, seed=7):
    """K2, K5, K1 (values and gradient) and K7 (both forms, relative to the
    largest entry) against their plain versions at every basis degree
    0..12, on synthetic_tree with one descent below a depth-1 grid (rows of
    16 to 464 lanes: K2/K5 read the rows above 64 lanes a term at a time,
    K1 stages those above 32 coefficients), at N_SYNTH points straddling
    the root; and K3 on N_SYNTH rays through each tree (its LOD phase from
    degree 4, its wide rows from degree 6), against the plain march and,
    bit for bit, against the kernel it replaced; K8's query form at the
    points and its trace form on K3's rays against autograd of the plain
    versions (the trace on its well-posed rays, trace_well_posed) and
    the kernel it replaced (the trace off the root's faces, off_faces), and
    the fused mode against modes 0 and 2 bit
    for bit; K8's node-range mode on two blocks, in tiles of its own rows
    and of two, against its plain version. Returns (max K2 error, min K5
    dot, max K1 value error, max K1 gradient error, max K3 t error on
    common hits, max K7 error, max K8 error)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import tree as TT
    from hpsdf_tpu_torch.accel import (F32_MAX, NORMALS, RAW_GRAD, VALUES,
                                       VALUES_AND_GRAD,
                                       normals_plain, packed_eval_kernel,
                                       packed_grad_kernel,
                                       point_gradient_vjp_plain,
                                       query_packed_plain, values_at_plain,
                                       values_at_vjp_plain)
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.query import (OUTSIDE_VALUE, _coeff_scatter_nodes,
                                       _to_unit, coeff_scatter_kernel,
                                       coeff_scatter_nodes_plain, descend,
                                       node_tile_rows, query_kernel,
                                       query_plain,
                                       query_vjp_plain,
                                       query_with_gradient_plain)
    from hpsdf_tpu_torch.render import (CONE_TILE, HIT_EPS, MAX_STEPS,
                                        _march_block, _tree_f32, camera_rays,
                                        cone_start_plain, trace_vjp_plain)

    side = int(N_SYNTH ** 0.5)
    mid = tuple(0.5 * (a + b) for a, b in zip(*SYNTH_ROOT))
    o, d = camera_rays((mid[0], mid[1], SYNTH_ROOT[0][2] - 2.75), mid,
                       width=side, height=side, device=dev)
    tiles = (side, side, CONE_TILE)
    k3_err, k3_hits = 0.0, 0
    k4_tiles = k4_rounds_differ = k4_k = 0
    k4_t0_err = 0.0
    cfg = T.Config(continuity=False, root_min=SYNTH_ROOT[0],
                   root_max=SYNTH_ROOT[1])
    lo, hi = np.asarray(SYNTH_ROOT[0]), np.asarray(SYNTH_ROOT[1])
    pad = 0.1 * (hi - lo)
    rng = np.random.default_rng(seed)
    rng7 = np.random.default_rng(seed + 100)         # K7's cotangents
    k2_err = k1_err = k1g_err = k7_err = k8_err = k8n_err = 0.0
    k8_well = 1.0
    k5_dot = 1.0
    for deg in range(13):
        tree = TT.pack(*synthetic_tree(deg, seed + deg), cfg, device=dev)
        pt = T.pack_tree(tree, grid_depth=1)
        check(pt.extra_rounds == 1, f"one descent below the grid at {deg}")
        p64 = torch.as_tensor(rng.uniform(lo - pad, hi + pad, (N_SYNTH, 3)),
                              device=dev)
        p32 = p64.to(torch.float32)
        v_k = packed_eval_kernel(pt, p32, VALUES, outside_max=True)
        v_p = query_packed_plain(pt, p32)
        out = v_p == F32_MAX
        check(bool(out.any()) and not bool(out.all())
              and bool(torch.equal(v_k == F32_MAX, out)),
              f"K2 sentinel positions at degree {deg}")
        e = max(scaled_err(v_k[~out], v_p[~out]),
                scaled_err(packed_eval_kernel(pt, p32, VALUES),
                           values_at_plain(pt, p32)))
        check(e <= K2_ATOL, f"K2 vs plain at degree {deg}: {e:.3e}")
        k2_err = max(k2_err, e)
        n_k, n_p = packed_eval_kernel(pt, p32, NORMALS), normals_plain(pt, p32)
        if deg == 0:     # a constant: no gradient, zero normals both ways
            check(not bool(n_k.any()) and not bool(n_p.any()),
                  "K5 normals of a constant")
        else:
            dot = float((n_k * n_p).sum(-1).min())
            check(dot >= NORMAL_DOT, f"K5 normal dot at degree {deg}: {dot}")
            k5_dot = min(k5_dot, dot)
        q_k, q_p = query_kernel(tree, p64, False), query_plain(tree, p64)
        check(bool(torch.equal(q_k == OUTSIDE_VALUE, q_p == OUTSIDE_VALUE)),
              f"K1 sentinel positions at degree {deg}")
        gv_k, g_k = query_kernel(tree, p64, True)
        gv_p, g_p = query_with_gradient_plain(tree, p64)
        e = max(float((q_k - q_p).abs().max()),
                float((query_kernel(tree, p64, False, False)
                       - query_plain(tree, p64, False)).abs().max()),
                float((gv_k - gv_p).abs().max()))
        eg = float((g_k - g_p).abs().max())
        check(e <= K1_VAL_ATOL and eg <= K1_GRAD_ATOL,
              f"K1 vs plain at degree {deg}: values {e:.3e}, unit gradients "
              f"{eg:.3e}")
        k1_err, k1g_err = max(k1_err, e), max(k1g_err, eg)
        for form, plain in ((0, values_at_vjp_plain),
                            (1, point_gradient_vjp_plain)):
            cot = torch.as_tensor(rng7.standard_normal(
                (N_SYNTH,) if form == 0 else (N_SYNTH, 3)).astype(
                    np.float32), device=dev)
            e = max(rel_err(g, w) for g, w in zip(
                packed_grad_kernel(pt, p32, cot, form), plain(pt, p32, cot)))
            check(e <= GRAD_RTOL32, f"K7 form {form} vs autograd of the "
                  f"plain version at degree {deg}: {e:.3e}")
            k7_err = max(k7_err, e)
        lo_t = pt.lo
        check((lo_t is not None) == (deg > 3), f"LOD tables at degree {deg}")
        args = (pt, o, d, SYNTH_T_MAX, HIT_EPS, MAX_STEPS)
        t_k, h_k, kk_k = check_k3_exact(args, dict(lo=lo_t),
                                        f"degree {deg}", width=side)
        check_k3_exact(args, dict(lo=lo_t), f"degree {deg}, index order")
        t_p, h_p, kk_p = _march_block(*args, lo=lo_t)
        both = h_k & h_p
        agree = float((h_k == h_p).float().mean())
        # a random polynomial is no distance field: where a ray crosses its
        # zero at a shallow slope, the 1e-4 hit test spreads t widely, so t
        # is held to T_ATOL on all but 0.5% of common hits and to
        # SYNTH_T_ATOL on all
        te = (t_k[both] - t_p[both]).abs()
        e = float(te.max()) if bool(both.any()) else 0.0
        near = float((te <= T_ATOL).float().mean()) if bool(both.any()) \
            else 1.0
        check(agree >= HIT_AGREE and near >= HIT_AGREE and e <= SYNTH_T_ATOL
              and kk_k.tolist() == kk_p.tolist(),
              f"K3 vs plain at degree {deg}: hit masks agree {agree}, t "
              f"within {T_ATOL} on {near}, max {e:.3e}, kk {kk_k.tolist()} "
              f"plain {kk_p.tolist()}")
        k3_err, k3_hits = max(k3_err, e), k3_hits + int(both.sum())
        # K4 on the rays' tiles, on the full rows and on the LOD rows where
        # the tree has them: t0 against the kernel it replaced bit for bit,
        # and the rounds and t0 against the plain version
        for lo_k in (None,) if lo_t is None else (None, lo_t):
            label = f"degree {deg}{'' if lo_k is None else ', LOD rows'}"
            t0_k, r_k = check_k4_exact(pt, o, d, SYNTH_T_MAX, tiles, lo_k,
                                       label)
            t0_p, r_p = cone_start_plain(pt, o, d, SYNTH_T_MAX, HIT_EPS,
                                         tiles, lo=lo_k, with_stats=True)
            k4_tiles += r_k.numel()
            k4_rounds_differ += int((r_k != r_p).sum())
            k4_t0_err = max(k4_t0_err, float((t0_k - t0_p).abs().max()))
            k4_k = max(k4_k, int(r_k.max()))
        # K8, both forms (the trace form on K3's rays), against autograd of
        # the plain versions and the kernel it replaced; the fused mode
        # against modes 0 and 2
        w64 = torch.as_tensor(rng7.standard_normal(N_SYNTH), device=dev)
        kw = dict(pts=p64, outside_value_max=True)
        got = coeff_scatter_kernel(tree, w64, **kw)
        e = max(rel_err(got, query_vjp_plain(tree, p64, w64)),
                rel_err(got, coeff_scatter_reference(tree, w64, **kw)))
        check(e <= GRAD_RTOL64, f"K8 (f64 query) vs autograd of the plain "
              f"version and the kernel it replaced at degree {deg}: {e:.3e}")
        # K8's node-range mode on two blocks, in tiles of node_tile_rows and
        # of two rows, against its plain version
        lv = descend(tree, _to_unit(tree, p64).clamp(-0.5, 0.5))
        for b in (P.node_block(tree, 2, r) for r in range(2)):
            want = coeff_scatter_nodes_plain(b, p64, lv, w64, True)
            for T_ in (node_tile_rows(deg, b.hi - b.lo), 2):
                en = rel_err(_coeff_scatter_nodes(b, p64, lv, w64, True, T_),
                             want)
                check(en <= GRAD_RTOL64, f"K8's node-range mode vs plain at "
                      f"degree {deg}, tiles of {T_} rows: {en:.3e}")
                k8n_err = max(k8n_err, en)
        # the trace form against the kernel it replaced on every ray, and
        # against the plain version on the well-posed rays
        # (trace_well_posed; the others take dt = 0 there): on the rest two
        # faithful f32 computations part, and the plain version differs
        # from both kernels alike
        tree32 = _tree_f32(tree)
        rays = (o, d, t_k, h_k)
        dt = torch.as_tensor(rng7.standard_normal(o.shape[0]).astype(
            np.float32), device=dev)
        well = trace_well_posed(tree, *rays[:3])
        dt_w = torch.where(well, dt, 0.0)
        # the kernel it replaced keeps the clamp's slope 1 on a face
        dt_f = torch.where(off_faces(tree, rays), dt, 0.0)
        check(bool((well & h_k).any()), f"well-posed hits at degree "
              f"{deg}")
        e32 = max(rel_err(coeff_scatter_kernel(tree32, dt_f, rays=rays),
                          coeff_scatter_reference(tree32, dt_f, rays=rays)),
                  rel_err(coeff_scatter_kernel(tree32, dt_w, rays=rays),
                          trace_vjp_plain(tree32, *rays, dt_w)))
        check(e32 <= GRAD_RTOL32, f"K8 (f32 trace) vs the kernel it replaced"
              f" and autograd of the plain version at degree {deg}: "
              f"{e32:.3e}")
        k8_err = max(k8_err, e, e32)
        k8_well = min(k8_well, float((well & h_k).sum() / h_k.sum()))
        v_f, g_f = packed_eval_kernel(pt, p32, VALUES_AND_GRAD,
                                      n_grad=N_SYNTH // 2)
        check(torch.equal(v_f, packed_eval_kernel(pt, p32, VALUES))
              and torch.equal(g_f, packed_eval_kernel(
                  pt, p32[:N_SYNTH // 2], RAW_GRAD)),
              f"the fused mode vs modes 0 and 2 at degree {deg}")
    check(k3_hits > 0, "K3 hits on the synthetic trees")
    check(k4_k > 0 and k4_rounds_differ == 0 and k4_t0_err <= K4_T0_ATOL,
          f"K4 vs plain on the synthetic trees: rounds differ on "
          f"{k4_rounds_differ} of {k4_tiles} tiles, max|t0 - plain| "
          f"{k4_t0_err:.3e}, k up to {k4_k}")
    print(f"[degrees] 0..12, {N_SYNTH} pts each on a depth-2 tree (rows "
          f"{T.pack_tree(tree).width} lanes at 12): K2 max|v - plain|/"
          f"max(1,|v|) {k2_err:.3e}, K5 min dot {k5_dot:.8f}, K1 max|value "
          f"- plain| {k1_err:.3e}, max|unit grad - plain| {k1g_err:.3e}; K7 "
          f"both forms max|kernel - plain| / max|plain| {k7_err:.3e}; K3 "
          f"on {side}^2 rays through each: max|t - plain| on {k3_hits} "
          f"common hits {k3_err:.3e}, t, hit and kk equal the kernel it "
          f"replaced bit for bit; K8 both forms (the trace on K3's rays) "
          f"max|kernel - plain or replaced| / max|plain or replaced| "
          f"{k8_err:.3e} (the trace against plain on its well-posed hits, "
          f"at least {k8_well:.3f} of them), its node-range mode on two "
          f"blocks against plain {k8n_err:.3e}; the fused mode bit-equal to "
          f"modes 0 and 2; K4 on the rays' {CONE_TILE}x{CONE_TILE} tiles "
          f"(full rows, and LOD rows from degree 4): t0 equal to the kernel "
          f"it replaced bit for bit; against plain, max|t0 - plain| "
          f"{k4_t0_err:.3e}, rounds differ on {k4_rounds_differ} of "
          f"{k4_tiles} tiles, k up to {k4_k}",
          flush=True)
    return k2_err, k5_dot, k1_err, k1g_err, k3_err, k7_err, max(k8_err,
                                                                 k8n_err)


# --- [continuity] ----------------------------------------------------------
# fit + continuity, bench.py:352-360 (the reference's HPBenchmarks.cpp:51-75):
# warmed on a sphere of 0.3, timed on 0.301
CONT_FIT = dict(target_error=1e-6, continuity=True, continuity_strength=8.0,
                max_depth=5, max_degree=4)
CONT_FIT_RADII = (0.3, 0.301)
# the 260k-leaf continuity row, bench.py:578-596 (run_contscale)
CONT_ROW = dict(target_error=3e-9, continuity=True, continuity_strength=8.0,
                max_depth=7, max_degree=2, node_capacity=1_000_000)
CONT_ROW_RADIUS = 0.3
CONT_RTOL = 1e-13        # K9's y, K9u's vectors and dots against plain's
CONT_X_RTOL = 1e-9       # the kernels' solve against the plain solve
# the same on random coefficients, where CG amplifies rounding
# (tests/test_torch_continuity.py's NOISE_RTOL)
CONT_NOISE_X_RTOL = 1e-6
ITER_CHUNK = 32          # iterations a timed persistent launch runs
N_JUMP = 20000           # points on each plane of the face-jump check


def face_jumps(tree, planes=(0.0625, -0.125), seed=2):
    """|f(plane - eps) - f(plane + eps)| across planes x = c, at N_JUMP
    points each (tests/test_continuity.py:95-112; faces of depth-4 cells,
    off the sphere's plane of symmetry x = 0, where every jump is 0)."""
    import hpsdf_tpu_torch as T
    yz = torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.49, 0.49, (N_JUMP, 2)), device=tree.device)
    out = []
    for c in planes:
        L = torch.cat([torch.full((N_JUMP, 1), c - 1e-9, dtype=yz.dtype,
                                  device=yz.device), yz], 1)
        R = L.clone()
        R[:, 0] = c + 1e-9
        out.append((T.query(tree, L) - T.query(tree, R)).abs())
    return out


def cg_bytes(A):
    """K9's byte bound in PR 10's CSR form: each entry's value and column and
    the row offsets read once, p read once and y written once. K9u's: five
    vectors read (Ap, 1/diag, x, r, p), three written (x, r, p)."""
    n = A.n
    k9 = bytes_ms(A.vals, A.cols, A.rowptr, extra=2 * 8 * n)
    return k9, 8 * 8 * n / HBM_RATE * 1e3


def cg_ops(A):
    """K9's operation bound in its CSR form: an f64 FMA an entry, and two a
    row (s p_i + the row's sum, and p.y)."""
    return (2 * A.vals.shape[0] + 4 * A.n) / F64_PEAK * 1e3


def update_ops(n):
    """K9u's operation bound: six f64 FMAs a row (x, r, z, r.z, r.r, p)."""
    return 2 * 6 * n / F64_PEAK * 1e3


# K9u's two launches in the row-sharded CG over a rank's n rows, each input
# read once and each output written once: the first reads Ap, 1/diag, x, r
# and p and writes x, r and z (f64 vectors), five f64 FMAs a row (x, r, z,
# r.z, r.r); the second reads z and p and writes p, one FMA a row. A dead
# launch (the flag down) reads its flag and the two scalars it loads with
# it, and the first writes its copy of the flag.
ROWS_VECTORS = {"k9u": 8, "direction": 3}
ROWS_FMAS = {"k9u": 5, "direction": 1}
ROWS_DEAD_BYTES = {"k9u": 4 + 16 + 4, "direction": 4 + 16}


def rows_bytes(kind, n, live=True):
    """Bytes one of K9u's row launches ("k9u", "direction") moves."""
    return 8 * ROWS_VECTORS[kind] * n if live else ROWS_DEAD_BYTES[kind]


def rows_bound(kind, n, live=True):
    """(bytes, operations) bounds in ms of one of K9u's row launches."""
    return (rows_bytes(kind, n, live) / HBM_RATE * 1e3,
            2 * ROWS_FMAS[kind] * n / F64_PEAK * 1e3 if live else 0.0)


def face_bytes(op):
    """K9's byte bound on the face operator: its arrays (the leaves' rows,
    the face slots, the cross-depth CSR) read once, p read once and y
    written once. An iteration of the persistent launch: the operator, p,
    x, r and 1/diag read once, x, r and p written once."""
    arrays = (op.leaves, op.slots, op.xrowptr, op.xcols, op.xvals)
    return (bytes_ms(*arrays, extra=2 * 8 * op.n),
            bytes_ms(*arrays, extra=7 * 8 * op.n))


def _mode_terms():
    """terms[D, D2]: the neighbour's terms a leaf of degree D needs across a
    face to one of degree D2, sum over its tangential modes t1 + t2 = t <=
    min(D, D2) ((t + 1) of them) of the D2 - t + 1 neighbour members."""
    d = np.arange(13)
    return np.array([[sum((t + 1) * (b - t + 1) for t in range(min(a, b) + 1))
                      for b in d] for a in d], np.int64)


def face_ops(op):
    """K9's operation bound on the face operator in f64 FMAs (two operations
    each): for each same-depth face of a leaf of C rows, C for its own
    face values, the neighbour's terms on its modes (``_mode_terms``) and C
    for y; an FMA a cross-depth entry; two a row (s p_r and p.y). An
    iteration adds six a row (x, r, z, r.z, r.r, p). Returns (K9, the
    iteration) in ms at the f64 peak."""
    leaves, slots = op.leaves.long().cpu(), op.slots.long().cpu()
    deg = (leaves[:, 2] & 255).numpy()
    C = (deg + 1) * (deg + 2) * (deg + 3) // 6
    has = (slots[:, :, 0] >= 0).numpy()
    nbr = np.where(has, _mode_terms()[deg[:, None],
                                      slots[:, :, 1].clamp(min=0).numpy()], 0)
    fmas = int((has * 2 * C[:, None]).sum() + nbr.sum()) \
        + op.xvals.shape[0] + 2 * op.n
    return (2 * fmas / F64_PEAK * 1e3,
            2 * (fmas + 6 * op.n) / F64_PEAK * 1e3)


def cg_times(op, A, R, C, V, s, minv, reps):
    """In CUDA graphs: K9 on the face operator, PR 10's K9 on the CSR, K9u
    once, an iteration of the persistent launch (a chunk of ITER_CHUNK
    iterations, from a state set up by K9u's first form), an iteration of
    two launches (K9 on the face operator, then K9u) and PR 10's two-launch
    iteration (K9 on the CSR, then K9u); by CUDA events the plain
    versions and cuSPARSE's CSR matvec (torch.mv; never on the port's path)
    on the 62M-entry CSR and on the CSR with duplicates merged; random
    vectors, the flag held up (threshold -1)."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch import continuity as TC
    dev, n = minv.device, op.n
    g = torch.Generator(device=dev).manual_seed(9)
    p, x, r = (torch.randn(n, generator=g, dtype=torch.float64, device=dev)
               for _ in range(3))
    y = torch.empty_like(p)
    st9 = TC._State.new(dev, -1.0, 2 ** 31 - 1)
    k9 = graph_ms(lambda: TC._matvec_launch(op, s, p, y, st9), reps)
    k9_csr = graph_ms(lambda: TC._matvec_launch(A, s, p, y, st9), reps)
    lib_err, library = [], []
    with warnings.catch_warnings():          # torch's sparse CSR is beta
        warnings.simplefilter("ignore")
        merged = torch.sparse_coo_tensor(torch.stack([R, C]), V, (n, n)) \
            .coalesce().to_sparse_csr()
        for sp in (torch.sparse_csr_tensor(A.rowptr, A.cols, A.vals, (n, n)),
                   merged):
            lib_y = torch.mv(sp, p)
            library.append(time_ms(lambda: torch.mv(sp, p), reps))
            lib_err.append(float((lib_y - (y - s * p)).abs().max()
                                 / (y - s * p).abs().max()))
    nnz_merged = merged.values().shape[0]
    del merged

    st9u = TC._State.new(dev, -1.0, 2 ** 31 - 1, alpha=1e-3, rz=1.0)
    xu, ru, pu = x.clone(), r.clone(), p.clone()
    k9u = graph_ms(lambda: TC._update_launch(False, y, minv, xu, ru, pu,
                                             st9u), reps)

    lib = _kernels.load()
    plan = TC._chunk_plan(op)
    states = []
    for _ in range(3):
        st = TC._State.new(dev, -1.0, 2 ** 31 - 1)
        xi, ri, pi, yi = x.clone(), r.clone(), torch.empty_like(x), \
            torch.empty_like(x)
        TC._update_launch(True, yi, minv, xi, ri, pi, st)
        states.append((st, xi, ri, pi, yi))

    def chunk():
        st, xi, ri, pi, yi = states[0]
        TC._chunk_launch(op, plan, s, minv, xi, ri, pi, yi, st, ITER_CHUNK)

    def two_launch():
        st, xi, ri, pi, yi = states[1]
        TC._matvec_launch(op, s, pi, yi, st)
        TC._update_launch(False, yi, minv, xi, ri, pi, st)

    def two_launch_csr():
        st, xi, ri, pi, yi = states[2]
        _kernels.check(lib, lib.hpsdf_cg_iterations(
            A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(), n,
            float(s), minv.data_ptr(), xi.data_ptr(),
            ri.data_ptr(), pi.data_ptr(), yi.data_ptr(),
            st.partials.data_ptr(), st.sc.data_ptr(), st.st.data_ptr(), 2,
            _kernels.stream_of(xi)), "cg_iterations")

    it = graph_ms(chunk, max(1, reps // ITER_CHUNK)) / ITER_CHUNK
    it_two = graph_ms(two_launch, reps)
    it_csr = graph_ms(two_launch_csr, max(1, reps // 2)) / 2
    for st, *_ in states:
        check(int(st.st[TC._ST["active"]]) == 1 and bool(
            torch.isfinite(st.sc).all()), f"the timed iterations stayed "
              f"live: {st.st.tolist()} {st.sc.tolist()}")
    few = max(3, reps // 10)
    plain = time_ms(lambda: TC.face_matvec_plain(op, s, p), few)
    plain_coo = time_ms(lambda: TC.cg_matvec_plain(R, C, V, s, p), few)
    plain_u = time_ms(lambda: TC.cg_update_plain(1e-3, 1.0, p, y, minv, x,
                                                 r), few)
    return {"k9_ms": k9, "k9_csr_ms": k9_csr, "k9u_ms": k9u,
            "iteration_ms": it, "iteration_two_launch_ms": it_two,
            "iteration_csr_ms": it_csr,
            "k9_plain_ms": plain, "k9_plain_coo_ms": plain_coo,
            "k9u_plain_ms": plain_u, "iteration_plain_ms": plain + plain_u,
            "k9_library_ms": library[1], "k9_library_62m_ms": library[0],
            "library_rel_err": max(lib_err), "nnz_merged": nnz_merged,
            "chunk_blocks": plan.blocks, "chunk_group_doubles": plan.cap}


def rel_errs(pre, names, got, want):
    """max|got - want| / max|want| of each pair, and the absolute errors."""
    errs, abs_errs = {}, {}
    for name, a, w in zip(names, got, want):
        abs_errs[f"{pre} {name}"] = float((a - w).abs().max())
        errs[f"{pre} {name}"] = abs_errs[f"{pre} {name}"] / float(
            w.abs().max())
    return errs, abs_errs


def check_chunk(op, s, minv, x, r):
    """The persistent launch (``_chunk_launch``) for one iteration from the
    state K9u's first form sets up on (x, r), against the same iteration by
    the plain versions (``face_matvec_plain``, ``cg_update_plain``): x, r,
    the new direction, p.y, r.z and r.r. Returns their relative and
    absolute errors."""
    from hpsdf_tpu_torch import continuity as TC
    state = TC._State.new(x.device, -1.0, 2 ** 31 - 1)
    xs, rs, ps, ys = x.clone(), r.clone(), torch.empty_like(x), \
        torch.empty_like(x)
    TC._update_launch(True, ys, minv, xs, rs, ps, state)
    TC._chunk_launch(op, TC._chunk_plan(op), s, minv, xs, rs, ps, ys, state,
                     1)
    z = minv * r
    rz = torch.dot(r, z)
    Ap, pap = TC.face_matvec_plain(op, s, z)
    want = TC.cg_update_plain(rz / pap, rz, z, Ap, minv, x, r)
    sc = state.sc
    return rel_errs("chunk", ("x", "r", "p'", "p.y", "r.z", "r.r"),
                    (xs, rs, ps, sc[TC._SC["pap"]], sc[TC._SC["rz"]],
                     sc[TC._SC["rr"]]),
                    (*want[:3], pap, *want[3:]))


def check_cg(op, A, R, C, V, s, diag, b, x0, n, tol, max_iter, main, label,
             smi):
    """K9 against the COO's plain matvec and its own plain version on the
    same random p, PR 10's CSR form against the COO's, K9u against its
    plain version; the persistent launch with y in a buffer against it with
    y in shared memory, bit for bit; then the kernels' solve against the
    plain solve on the COO, and against the main path's own solve
    (``main``: (x, iterations, residual)) bit for bit. Returns the largest
    errors and the plain solve's count."""
    from hpsdf_tpu_torch import continuity as TC
    dev = b.device
    g = torch.Generator(device=dev).manual_seed(7)
    p, x, r = (torch.randn(n, generator=g, dtype=torch.float64, device=dev)
               for _ in range(3))
    minv = 1.0 / diag
    got = TC.cg_matvec(op, s, p)
    want = TC.cg_matvec_plain(R, C, V, s, p)
    errs, abs_errs = {}, {}
    for pre, names, gs, ws in (
            ("k9", ("y (COO)", "p.y (COO)"), got, want),
            ("k9", ("y (plain)", "p.y (plain)"), got,
             TC.face_matvec_plain(op, s, p)),
            ("csr k9", ("y", "p.y"), TC.cg_matvec(A, s, p), want),
            ("k9u", ("x", "r", "p'", "r.z", "r.r"),
             TC.cg_update(0.3, 2.0, p, want[0], minv, x, r),
             TC.cg_update_plain(0.3, 2.0, p, want[0], minv, x, r))):
        e, a = rel_errs(pre, names, gs, ws)
        errs.update(e)
        abs_errs.update(a)
    e, a = check_chunk(op, s, minv, x, r)
    errs.update(e)
    abs_errs.update(a)
    for k, e in errs.items():
        check(e <= CONT_RTOL, f"{label}: {k} against plain, relative {e}")

    plan = TC._chunk_plan(op)
    runs = []
    for cap in (plan.cap, 0):
        state = TC._State.new(dev, -1.0, 2 ** 31 - 1)
        xs, rs, ps, ys = x.clone(), r.clone(), torch.empty_like(x), \
            torch.empty_like(x)
        TC._update_launch(True, ys, minv, xs, rs, ps, state)
        TC._chunk_launch(op, plan._replace(cap=cap), s, minv, xs, rs, ps,
                         ys, state, TC.CG_CHUNK)
        runs.append((xs, rs, ps, state.sc))
    check(plan.cap > 0 and all(torch.equal(u, w) for u, w in zip(*runs)),
          f"{label}: the persistent launch with y in a buffer against y in "
          f"shared memory ({plan.cap} doubles a group)")

    x_k, k_k, res_k = TC._cg_kernels(op, s, diag, b, x0, tol, max_iter)
    check(bool(torch.equal(x_k, main[0])) and (k_k, res_k) == main[1:],
          f"{label}: the kernels' solve repeats bit for bit ({k_k} / "
          f"{main[1]} iterations, residual {res_k} / {main[2]})")
    x_p, k_p, res_p = TC._cg_solve_plain(R, C, V, s, diag, b, x0, n, tol,
                                         max_iter)
    x_err = float((x_k - x_p).abs().max() / x_p.abs().max())
    if k_p == k_k:
        check(x_err <= CONT_X_RTOL, f"{label}: kernels' solve against "
              f"plain's, relative {x_err}")
        tie = ""
    else:
        check(abs(k_p - k_k) == 1, f"{label}: iterations {k_k} (kernels) "
              f"against {k_p} (plain)")
        # a tie at the threshold: index_add_ adds in no fixed order
        bb = float(torch.dot(b, b))
        rr = []
        for xs in (x_k, x_p):
            y, _ = TC.cg_matvec_plain(R, C, V, s, xs)
            rr.append(float(torch.dot(b - y, b - y)))
            check(rr[-1] <= tol * tol * bb, f"{label}: recomputed residual "
                  f"{rr[-1] ** 0.5} against {tol} * |b| = {tol * bb ** 0.5}")
        tie = (f" (counts differ by one at the threshold: recomputed "
               f"residuals {rr[0] ** 0.5:.6e} / {rr[1] ** 0.5:.6e}, tol |b| "
               f"{tol * bb ** 0.5:.6e})")
    print(f"[continuity] {label}: {smi} | K9 on the face operator, PR 10's "
          f"CSR form, K9u and an iteration of the persistent launch against "
          f"the COO and plain (relative): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; the persistent launch ({plan.blocks} blocks) with y in a "
          f"buffer = y in {plan.cap} doubles of shared memory a group, bit "
          f"for bit over {TC.CG_CHUNK} iterations; solve: "
          f"kernels {k_k} iterations, residual {res_k:.6e}, bit for bit on a "
          f"second run; plain on the COO {k_p} iterations, residual "
          f"{res_p:.6e}, max|x - plain| / max|x| {x_err:.3e}{tie}",
          flush=True)
    errs["x"] = x_err
    return errs, abs_errs, k_p


def phase_continuity(label, cfg_kw, radius, warm_radius, smi):
    """build_octree(config with continuity=True) on a sphere at the origin,
    through K9 and the persistent launch on the face operator, its seconds
    split by phase (no same-depth entry assembled: ``_analytic_entries``
    must not run); then the field against |p| - radius, the face jumps
    against the fit without continuity, the kernels and the solve against
    the plain versions on the COO ``assemble_face_matrix`` builds (outside
    the timed builds), and their times beside their bounds, PR 10's forms
    and cuSPARSE."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import continuity as TC
    dev = torch.device("cuda", 0)
    cfg = T.Config(**cfg_kw)

    def sphere(r):
        return lambda p: torch.linalg.norm(p, dim=-1) - r

    if warm_radius is not None:
        T.build_octree(cfg, sphere(warm_radius), device=dev)
    reset_counts()
    TC._cg_kernels.host_syncs = 0
    sync()
    t0 = time.perf_counter()
    tree = T.build_octree(cfg, sphere(radius), device=dev)
    sync()
    build_s = time.perf_counter() - t0
    launches = read_counts()
    syncs = TC._cg_kernels.host_syncs
    for name, kernel in (("cg_matvec", "K9"), ("cg_update", "K9u"),
                         ("cg_chunk", "the persistent launch")):
        check(launches[name] > 0, f"{label}: {kernel} never launched on the "
              f"main path ({launches[name]})")
    k6s, timer, calls, again = k6_split(
        lambda: T.build_octree(cfg, sphere(radius), device=dev),
        FIT_PHASES + CONTINUITY_PHASES)
    split = k6s["k6"]
    check(torch.equal(again.coeffs, tree.coeffs), f"{label}: the "
          f"instrumented build's coefficients differ from the first's")
    t = timer.times
    check(timer.counts.get("analytic", 0) == 0 and "assembly" not in t,
          f"{label}: same-depth entries were assembled on the path "
          f"({timer.counts})")
    split.update({"face_pairs_s": t["face pairs"],
                  "operator_s": t["operator"] - t.get("numeric", 0.0),
                  "numeric_s": t.get("numeric", 0.0),
                  "upload_s": t["upload"], "cg_s": t["solve"]})
    split["continuity_other_s"] = (t["continuity"] - t["face pairs"]
                                   - t["operator"] - t["upload"]
                                   - t["solve"])
    fitted = calls["continuity"][0][0]
    (op, s, diag, b, x0), kw, main = calls["solve"]
    n, nnz, iters = op.n, op.nnz, main[1]
    check(main[1] < kw["max_iter"], f"{label}: the solve stopped at "
          f"max_iter ({main[1]} iterations, residual {main[2]})")
    R, C, V = _coo(fitted, dev)
    check(R.shape[0] == nnz, f"{label}: the operator stands for {nnz} "
          f"entries, the COO holds {R.shape[0]}")
    A = TC.csr(R, C, V, n)

    pts = torch.as_tensor(np.random.default_rng(8).uniform(
        -0.5, 0.5, (N_QUERY, 3)), device=dev)
    vals = T.query(tree, pts)
    check(bool(torch.isfinite(vals).all()), f"{label}: field finite")
    field_err = float((vals - (torch.linalg.norm(pts, dim=-1) - radius))
                      .abs().max())
    check(field_err < FIT_ATOL, f"{label}: max|f - (|p| - {radius})| "
          f"{field_err}")
    # the jump energy c.Mc, which the solve trades against |c - c0|^2, and
    # the sampled jumps on two planes must fall
    energy = [float(TC.cg_matvec_plain(R, C, V, 0.0, c)[1])
              for c in (x0, main[0])]
    check(energy[1] < energy[0], f"{label}: jump energy {energy}")
    jumps = [(float(a.mean()), float(a.max()), float(b_.mean()),
              float(b_.max())) for a, b_ in zip(face_jumps(fitted),
                                                face_jumps(tree))]
    for mb, xb, ma, xa in jumps:
        check(ma < mb and xa < xb, f"{label}: face jumps before (mean {mb}, "
              f"max {xb}) and after (mean {ma}, max {xa})")

    errs, abs_errs, k_plain = check_cg(op, A, R, C, V, s, diag, b, x0, n,
                                       kw["tol"], kw["max_iter"], main,
                                       label, smi)
    reps = 200 if nnz < 5_000_000 else 20
    times = cg_times(op, A, R, C, V, s, 1.0 / diag, reps)
    check(times["library_rel_err"] <= CONT_RTOL, f"{label}: cuSPARSE's "
          f"product against K9's, relative {times['library_rel_err']}")
    k9_bytes, it_bytes = face_bytes(op)
    k9_ops, it_ops = face_ops(op)
    csr_bytes, k9u_bytes = cg_bytes(A)
    csr_ops, k9u_ops = cg_ops(A), update_ops(n)
    out = {"leaves": tree.num_leaves(), "nodes": tree.n_nodes, "n": n,
           "nnz": nnz, "iterations": iters, "plain_iterations": k_plain,
           "residual": main[2], "host_syncs": syncs,
           "launches": {k: launches[k]
                        for k in ("cg_matvec", "cg_update", "cg_chunk")},
           "build_s": build_s, "split": split, "k6_split": k6s,
           "field_err": field_err,
           "jump_energy": energy, "jumps": jumps, "errs": errs,
           "abs_errs": abs_errs, **times,
           "k9_bound_ms": max(k9_bytes, k9_ops), "k9_ops_bound_ms": k9_ops,
           "k9_bound_by": "bytes" if k9_bytes >= k9_ops else "operations",
           "k9_csr_bound_ms": max(csr_bytes, csr_ops),
           "k9u_bound_ms": max(k9u_bytes, k9u_ops), "k9u_ops_bound_ms": k9u_ops,
           "k9u_bound_by": "bytes" if k9u_bytes >= k9u_ops else "operations",
           "chunk_bound_ms": max(it_bytes, it_ops),
           "chunk_ops_bound_ms": it_ops,
           "chunk_bound_by": "bytes" if it_bytes >= it_ops else "operations",
           # what the persistent launch saves over the same kernels as two
           # launches an iteration, over the solve's iterations
           "chunk_saves_ms": (times["iteration_two_launch_ms"]
                              - times["iteration_ms"]) * iters,
           "cg_ms_per_iteration": split["cg_s"] / max(iters, 1) * 1e3}
    print(f"[continuity] {label}: {smi} | {out['nodes']} nodes, "
          f"{out['leaves']} "
          f"leaves, n {n}, nnz {nnz} (merged {times['nnz_merged']}), "
          f"{iters} iterations, residual "
          f"{main[2]:.6e}, host syncs {syncs}, launches {out['launches']}; "
          f"build_octree {build_s:.3f} s (split: {split_text(split)}; "
          f"analytic assembly 0 calls; {k6_text(k6s)}); "
          f"max|f - (|p| - {radius})| {field_err:.3e}; jump energy c.Mc "
          f"{energy[0]:.6e} -> {energy[1]:.6e}; face jumps (mean, "
          f"max) x = 0.0625: {jumps[0][0]:.3e}, {jumps[0][1]:.3e} -> "
          f"{jumps[0][2]:.3e}, {jumps[0][3]:.3e}; x = -0.125: "
          f"{jumps[1][0]:.3e}, {jumps[1][1]:.3e} -> {jumps[1][2]:.3e}, "
          f"{jumps[1][3]:.3e}", flush=True)
    print(f"[continuity] {label}: {smi} | in CUDA graphs: K9 "
          f"{times['k9_ms']:.4f} ms (bound {out['k9_bound_ms']:.5f} ms, "
          f"{out['k9_bound_by']}; {out['k9_bound_ms'] / times['k9_ms']:.1%}"
          f"; f64 operations {k9_ops:.5f}), PR 10's CSR K9 "
          f"{times['k9_csr_ms']:.4f} ms (bound "
          f"{out['k9_csr_bound_ms']:.5f}); an iteration of the persistent "
          f"launch ({times['chunk_blocks']} blocks, y in "
          f"{times['chunk_group_doubles']} doubles of shared memory a group) "
          f"{times['iteration_ms']:.4f} ms (bound "
          f"{out['chunk_bound_ms']:.5f} ms, {out['chunk_bound_by']}; "
          f"{out['chunk_bound_ms'] / times['iteration_ms']:.1%}), K9 + K9u "
          f"as two launches {times['iteration_two_launch_ms']:.4f} ms (the "
          f"persistent launch saves {out['chunk_saves_ms']:.4f} ms over the "
          f"solve's {iters} iterations), PR "
          f"10's two-launch iteration {times['iteration_csr_ms']:.4f} ms; "
          f"K9u "
          f"once {times['k9u_ms']:.4f} ms (bound {out['k9u_bound_ms']:.5f} "
          f"ms, {out['k9u_bound_by']}; "
          f"{out['k9u_bound_ms'] / times['k9u_ms']:.1%}) | the solve's CG "
          f"{out['cg_ms_per_iteration']:.4f} ms an iteration, host "
          f"included | plain: K9 {times['k9_plain_ms']:.4f}, on the COO "
          f"{times['k9_plain_coo_ms']:.4f}, K9u "
          f"{times['k9u_plain_ms']:.4f} ms | cuSPARSE CSR matvec (torch.mv) "
          f"{times['k9_library_62m_ms']:.4f} ms on the {nnz}-entry CSR, "
          f"{times['k9_library_ms']:.4f} ms merged", flush=True)
    return launches, out, dict(fitted=fitted, tree=tree, main=main)


def _coo(tree, dev):
    """The COO of M as ``hpsdf_tpu`` builds it (``assemble_face_matrix``),
    on the card: the reference the face operator is held to."""
    from hpsdf_tpu_torch import continuity as TC
    _, R, C, V = TC.assemble_face_matrix(tree)
    return tuple(torch.as_tensor(a, device=dev) for a in (R, C, V))


def mixed_degree_tree(seed=3):
    """synthetic_tree(12, seed)'s arrays for ``tree.pack`` with seeded leaf
    degrees 0-5 and one leaf at degree 12: same-depth faces between unequal
    degrees, cross-depth faces, and a 455-row block, wider than a warp."""
    arrays = list(synthetic_tree(12, seed))
    child, degree = arrays[0], arrays[3].copy()
    leaves = np.flatnonzero(child < 0)
    degree[leaves] = np.random.default_rng(0).integers(0, 6, leaves.size)
    degree[leaves[5]] = 12
    arrays[3] = degree
    return arrays


def phase_continuity_degrees(smi, s=8.0):
    """K9 and the persistent launch where a lane loops over its leaf's rows
    (``mixed_degree_tree``): K9 against the COO's plain matvec and its own
    plain version, the persistent launch with y in a buffer against y in
    shared memory bit for bit, and the kernels' solve against the plain
    solve on the COO (random coefficients: CONT_NOISE_X_RTOL, a count one
    apart allowed) and bit for bit on a second run. Returns the errors."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import continuity as TC
    from hpsdf_tpu_torch import tree as TT
    dev = torch.device("cuda", 0)
    tree = TT.pack(*mixed_degree_tree(), T.Config(
        root_min=SYNTH_ROOT[0], root_max=SYNTH_ROOT[1]), device=dev)
    st = TC._LeafView(tree)
    op, diag = TC.face_operator(st, *TC.leaf_face_pairs(st.child_idx, st.n),
                                s)
    check(op.widest == 455 and op.xvals.shape[0] > 0, f"the mixed-degree "
          f"tree: widest block {op.widest}, {op.xvals.shape[0]} cross-depth "
          f"entries")
    op = op.to(dev)
    R, C, V = _coo(tree, dev)
    n = op.n
    g = torch.Generator(device=dev).manual_seed(5)
    p = torch.randn(n, generator=g, dtype=torch.float64, device=dev)
    got = TC.cg_matvec(op, s, p)
    errs, abs_errs = {}, {}
    for names, want in ((("y (COO)", "p.y (COO)"),
                         TC.cg_matvec_plain(R, C, V, s, p)),
                        (("y (plain)", "p.y (plain)"),
                         TC.face_matvec_plain(op, s, p))):
        e, a = rel_errs("k9", names, got, want)
        errs.update(e)
        abs_errs.update(a)
    dt = torch.as_tensor(diag, device=dev)
    minv = 1.0 / dt
    e, a = check_chunk(op, s, minv, p, torch.randn(
        n, generator=g, dtype=torch.float64, device=dev))
    errs.update(e)
    abs_errs.update(a)
    for k, e in errs.items():
        check(e <= CONT_RTOL, f"mixed degrees: {k}, relative {e}")
    plan = TC._chunk_plan(op)
    runs = []
    for cap in (plan.cap, 0):
        state = TC._State.new(dev, -1.0, 2 ** 31 - 1)
        xs, rs, ps, ys = p.clone(), p.clone(), torch.empty_like(p), \
            torch.empty_like(p)
        TC._update_launch(True, ys, minv, xs, rs, ps, state)
        TC._chunk_launch(op, plan._replace(cap=cap), s, minv, xs, rs, ps, ys,
                         state, TC.CG_CHUNK)
        runs.append((xs, rs, ps, state.sc))
    check(plan.cap > 0 and all(torch.equal(u, w) for u, w in zip(*runs)),
          f"mixed degrees: the persistent launch with y in a buffer against "
          f"y in shared memory ({plan.cap} doubles a group)")
    b = s * p
    x1, k1, res1 = TC.cg_solve(op, s, dt, b, p, 1e-6, 2 * n)
    x2, k2, res2 = TC.cg_solve(op, s, dt, b, p, 1e-6, 2 * n)
    check(torch.equal(x1, x2) and (k1, res1) == (k2, res2),
          "mixed degrees: the kernels' solve repeats bit for bit")
    xp, kp, resp = TC._cg_solve_plain(R, C, V, s, dt, b, p, n, 1e-6, 2 * n)
    errs["x"] = float((x1 - xp).abs().max() / xp.abs().max())
    check(abs(k1 - kp) <= 1 and errs["x"] <= CONT_NOISE_X_RTOL,
          f"mixed degrees: solve {k1} iterations against plain {kp}, "
          f"relative {errs['x']}")
    print(f"[continuity] mixed degrees: {smi} | {op.leaves.shape[0]} leaves "
          f"of degree 0-5 and 12, n {n}, nnz {op.nnz}, {plan.blocks} blocks "
          f"of {plan.cap} doubles a group | "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" | the persistent launch in a buffer = in shared memory; solve "
          f"{k1} iterations, residual {res1:.6e}, bit for bit on a second "
          f"run; plain on the COO {kp} iterations", flush=True)
    return errs, abs_errs


# --- the mesh at the reference's scale: K10 (hybrid prune), K11 (BVH walk)
MESH_SCALE_SUB = 8                  # bumpy_sphere(0.3, 8): 1,310,720 tris
MESH_MID_SUB = 6                    # bumpy_sphere(0.3, 6): 81,920 tris
N_MESH_PTS = 10240                  # bench.py:458-459
N_NEAR = 1 << 16                    # the fit's check points near the surface
NEAR_OFFSET = 0.01
BOX_OPS = 20                        # f32 operations of a point-box distance
NATIVE_STAGES = ("load_obj", "half_edge_twins", "mesh_geom", "kd_order",
                 "pack_tri_rows", "bvh_node_rows")
K11_VISITS_SAME = 0.999             # walks with the plain visit counts
# K11's small heaps: (name, icosphere(0.3, s)'s s, or None for the cube)
K11_HEAPS = (("cube", None), ("icosphere(0.3, 0)", 0),
             ("icosphere(0.3, 1)", 1), ("icosphere(0.3, 3)", 3))


@contextlib.contextmanager
def native_paths():
    """While the block runs, records which native entry points of
    hpsdf_tpu_torch.native returned a result (the stage took the native
    path) or None (it fell back to numpy). Yields {stage: [path, ...]}."""
    from unittest import mock

    from hpsdf_tpu_torch import native
    took = {}

    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            took.setdefault(name, []).append(
                "numpy" if out is None else "native")
            return out
        return call

    with contextlib.ExitStack() as stack:
        for name in NATIVE_STAGES:
            stack.enter_context(mock.patch.object(
                native, name, wrap(name, getattr(native, name))))
        yield took


def cube_mesh(half):
    """The 12-triangle axis-aligned cube of half-side ``half`` about the
    origin, outward-oriented (as tests/util.cube_mesh): its BVH is a heap of
    depth 4. Returns (vertices f64 (8, 3), faces i32 (12, 3))."""
    v = half * np.asarray([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                           for z in (-1, 1)], np.float64)
    quads = ((0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3))
    f = [t for a, b, c, d in quads for t in ((a, b, c), (a, c, d))]
    return v, np.asarray(f, np.int32)


def surface_points(mesh, n, offset, seed):
    """n points at distance up to ``offset`` from random points of random
    triangles of the mesh (f32, host)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, mesh.n_faces, n)
    w = rng.dirichlet(np.ones(3), n)
    tri = mesh.vertices[mesh.faces[t]]                     # (n, 3, 3)
    on = (w[:, :, None] * tri).sum(axis=1)
    out = on + rng.uniform(-offset, offset, (n, 1)) * mesh.face_normals[t]
    return out.astype(np.float32)


def hybrid_bounds(lo, pts, blocks, sub, k1, stats=None):
    """K10's bound at these points. Operations: with ``stats`` (the
    kernel's own counts a point, ``sdf._hybrid_launch(with_stats=True)``)
    the f32 operations of the box distances it took (the NCH chunk boxes,
    the clusters of the chunks it visited, the subclusters) and of the
    cascades over the rows it scanned; without, those of every box distance
    and row the plain version takes (NC + 8 k1, the kept blocks' rows).
    Bytes: the points in, (d2, index, bound) out, the cluster boxes once
    and the candidate rows' vertices once (the distinct rows the plain
    version kept, blocks of SUB rows). Returns (bound ms, 'operations' or
    'bytes', ops ms, bytes ms)."""
    B, nc = pts.shape[0], lo.shape[0]
    if stats is None:
        ops = B * ((nc + 8 * min(k1, nc)) * BOX_OPS
                   + blocks.shape[1] * sub * P1_OPS_PER_PAIR)
    else:
        nch = min(nc // 32, 256) if nc >= 64 else 1
        work = stats.double().sum(dim=0).tolist()
        ops = (B * nch + work[1] + work[2]) * BOX_OPS \
            + work[3] * P1_OPS_PER_PAIR
    rows = torch.unique(blocks).numel() * sub
    nbytes = B * 12 + B * 12 + nc * 24 + rows * 36
    ops_ms, bytes_ms_ = ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (max(ops_ms, bytes_ms_),
            "operations" if ops_ms >= bytes_ms_ else "bytes", ops_ms,
            bytes_ms_)


def bvh_bounds(bvh, pts, visits, seen):
    """K11's bound at these points from the plain version's walks: the f32
    operations of two box distances a node row read and a cascade a
    triangle row read, against the bytes of the points in, (d2, index) out
    and each row any walk read, once (48 bytes of a node row, 36 of a
    triangle's vertices)."""
    T2 = bvh.n_leaves
    nodes, leaves = visits.double().sum(dim=0).tolist()
    ops = nodes * 2 * BOX_OPS + leaves * P1_OPS_PER_PAIR
    nbytes = pts.shape[0] * 20 + int(seen[:T2].sum()) * 48 \
        + int(seen[T2:].sum()) * 36
    ops_ms, bytes_ms_ = ops / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (max(ops_ms, bytes_ms_),
            "operations" if ops_ms >= bytes_ms_ else "bytes", ops_ms,
            bytes_ms_)


def build_hybrid_forms(src, stages, tag):
    """K10's source ``src`` compiled alone with nvcc, once for each
    HPSDF_K10_STAGE in ``stages`` (1: stop after the cluster selection, 2:
    after the subcluster selection, 3: the kernel; a source without the
    macro builds the kernel whatever the stage), all nvcc processes started
    together, into ctypes libraries beside the kernel library, which no
    path of the package loads. Returns {stage: library}."""
    import ctypes

    from hpsdf_tpu_torch import _kernels
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    jobs = {}
    for stage in stages:
        out = os.path.join(_kernels.BUILD_DIR,
                           f"k10_{tag}_stage{stage}.so")
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
               f"-DHPSDF_K10_STAGE={stage}", "-o", out, src]
        jobs[stage] = (out, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for stage, (out, cmd, proc) in jobs.items():
        so, se = proc.communicate()
        check(proc.returncode == 0,
              f"nvcc of a K10 form: {' '.join(cmd)}\n{so}\n{se}")
        lib = ctypes.CDLL(out)
        lib.hpsdf_hybrid.argtypes = _kernels._SIGNATURES["hpsdf_hybrid"]
        lib.hpsdf_hybrid.restype = ctypes.c_int
        libs[stage] = lib
    return libs


def hybrid_form(lib, bvh, pts, k1=None, k2=None):
    """A call of a K10 form's library (build_hybrid_forms) on these points,
    with the wrapper's layout and shape on the BVH's vertex rows, into
    outputs allocated once: for timing, counted by no launch counter.
    Returns the call, which returns (best_d2, best_idx, bound)."""
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.mesh import sdf as TS
    lo, hi = TS.cluster_aabbs(bvh)
    nc, first, sub, two, k1, k2 = TS._layout(
        lo, bvh.node_rows, bvh.tri_rows, k1 or TS.HYBRID_K1,
        k2 or TS.HYBRID_K2)
    shape = TS._hybrid_shape(nc, k1, k2, two)
    rows = bvh.vertex_rows
    B = pts.shape[0]
    out = (torch.empty(B, dtype=torch.float32, device=pts.device),
           torch.empty(B, dtype=torch.int32, device=pts.device),
           torch.empty(B, dtype=torch.float32, device=pts.device))

    def run():
        rc = lib.hpsdf_hybrid(
            lo.data_ptr(), hi.data_ptr(), bvh.node_rows.data_ptr(),
            rows.data_ptr(), rows.stride(0), nc, first, sub,
            k1, k2, int(two), *shape, pts.data_ptr(), B, out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), None,
            _kernels.stream_of(pts))
        check(rc == 0, f"K10 form launch: CUDA error {rc}")
        return out
    return run


def check_hybrid(bvh, pts, label, k1=None, k2=None, rows=None):
    """K10 against its plain version: d2 within TRI_ATOL + TRI_RTOL d2, the
    bound bit for bit (both round the box distances alike and select
    exactly), a differing index only where its triangle reaches the plain
    best d2. ``rows``: the triangle rows both read, the BVH's vertex rows
    (what the main path passes) by default. Returns (max |d2 diff|, the
    plain version's kept blocks and their rows each)."""
    from hpsdf_tpu_torch.mesh import sdf as TS
    k1 = k1 or TS.HYBRID_K1
    k2 = k2 or TS.HYBRID_K2
    rows = bvh.vertex_rows if rows is None else rows
    lo, hi = TS.cluster_aabbs(bvh)
    d2_k, idx_k, bd_k = TS.hybrid_closest(lo, hi, bvh.node_rows, rows, pts,
                                          k1, k2)
    d2_p, idx_p, bd_p, blocks, sub = TS.hybrid_closest_plain(
        lo, hi, bvh.node_rows, rows, pts, k1, k2, with_blocks=True)
    check(bool(torch.isfinite(d2_k).all()), f"K10 d2 finite at {label}")
    err = (d2_k - d2_p).abs()
    check(bool((err <= TRI_ATOL + TRI_RTOL * d2_p).all()),
          f"K10 d2 vs plain at {label}: max {float(err.max()):.3e}")
    check(bool(torch.equal(bd_k, bd_p)),
          f"K10 bound vs plain at {label}: {int((bd_k != bd_p).sum())} "
          "differ")
    diff = torch.nonzero(idx_k != idx_p).flatten()
    gap = (TS._tri_d2(bvh.tri_rows[idx_k[diff].long()], pts[diff])
           - d2_p[diff]).abs()
    check(bool((gap <= TRI_ATOL + TRI_RTOL * d2_p[diff]).all()),
          f"K10 index at {label}: {diff.numel()} differ, worst d2 gap "
          f"{float(gap.max()) if diff.numel() else 0.0:.3e}")
    print(f"[mesh scale] K10 {label} (k1 {k1}, k2 {k2}): max|d2 - plain| "
          f"{float(err.max()):.3e}, bound bit for bit, {diff.numel()} tied "
          f"indices differ", flush=True)
    return float(err.max()), blocks, sub


def check_bvh_capped(bvh, pts, max_iters, exact_d2, label):
    """K11 against its plain version at a cap: where the plain walk ended
    8 iterations or more before the cap, the same d2 within
    TRI_ATOL + TRI_RTOL d2 (a decision flips only where two distances are
    within an ulp, and a flip can move where the cap cuts); everywhere
    both are upper bounds of the exact d2. Returns (max |d2 diff| where
    compared, share of walks with the plain version's visit counts, the
    plain version's visits and rows read)."""
    from hpsdf_tpu_torch.mesh import sdf as TS
    d2_k, idx_k, vis_k = TS._bvh_launch(bvh, pts, max_iters, with_stats=True)
    d2_p, idx_p, vis_p, seen = TS.closest_bvh_plain(bvh, pts, max_iters,
                                                    with_stats=True)
    iters = vis_p[:, 0] - bvh.depth + vis_p[:, 1] - 1
    done = iters <= max_iters - 8
    err = (d2_k - d2_p).abs()[done]
    tol = TRI_ATOL + TRI_RTOL * d2_p[done]
    check(bool((err <= tol).all()),
          f"K11 d2 vs plain at {label}: max {float(err.max()):.3e}")
    for name, d2 in (("kernel", d2_k), ("plain", d2_p)):
        check(bool((d2 >= exact_d2 - (TRI_ATOL + TRI_RTOL * exact_d2))
                   .all()), f"K11 {name} below the exact d2 at {label}")
    same = float((vis_k == vis_p).all(dim=1).double().mean())
    print(f"[mesh scale] K11 {label} (max_iters {max_iters}): max|d2 - "
          f"plain| {float(err.max()):.3e} on the {int(done.sum())} walks "
          f"that ended before the cap, {int((~done).sum())} capped, both "
          f"upper bounds of the exact d2; visit counts equal on {same:.4%}",
          flush=True)
    return float(err.max()), same, vis_p, seen


def bvh_reference(bvh, pts, max_iters, with_stats=False):
    """K11 as it was before its redesign (csrc/check/bvh_walk_reference.cu,
    a library of its own, on no path of the package), a thread a point on
    the BVH's packed rows, called as sdf._bvh_launch calls K11. Returns
    (best_d2, best_idx) and, with ``with_stats``, the visits i32[B, 2]."""
    from hpsdf_tpu_torch import _kernels
    B, dev = pts.shape[0], pts.device
    d2 = torch.empty(B, dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    vis = torch.empty((B, 2), dtype=torch.int32, device=dev) \
        if with_stats else None
    rows = bvh.tri_rows
    rc = _kernels.load_check().hpsdf_bvh_walk_reference(
        bvh.node_rows.data_ptr(), rows.data_ptr(), rows.stride(0),
        bvh.n_leaves, bvh.depth, pts.data_ptr(), B,
        int(4 * bvh.n_leaves if max_iters is None else max_iters),
        d2.data_ptr(), idx.data_ptr(), None if vis is None else vis.data_ptr(),
        _kernels.stream_of(pts))
    _kernels.check(_kernels.load(), rc, "bvh_walk_reference")
    return (d2, idx, vis) if with_stats else (d2, idx)


def check_k11_exact(bvh, pts, max_iters, label):
    """K11 against the kernel it replaced (bvh_reference) on the same
    points: best_d2, best_idx and visits bit for bit (both walk the plain
    version's sequence on the same distances, tri.cuh's, compiled alike).
    Returns K11's visits."""
    from hpsdf_tpu_torch.mesh import sdf as TS
    got = TS._bvh_launch(bvh, pts, max_iters, with_stats=True)
    want = bvh_reference(bvh, pts, max_iters, with_stats=True)
    diff = {name: int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
            for name, a, b in zip(("d2", "index", "visits"), got, want)}
    check(not any(diff.values()),
          f"K11 vs the kernel it replaced at {label}: walks differing {diff}")
    return got[2]


def check_k11_heaps(pts):
    """K11 on heaps of depth 4, 5, 7 and 11 (K11_HEAPS: shallower than a
    window, one window, and depths that are no multiple of it), exact and
    at mesh_sdf's cap of 48 x depth visits, against its plain version
    (check_bvh_capped, the exact d2 from the plain walk uncapped) and the
    kernel it replaced (bit for bit). Returns (max |d2 - plain|, the
    smallest share of walks with the plain version's visit counts)."""
    from hpsdf_tpu_torch.mesh import build_bvh, build_mesh, gen
    from hpsdf_tpu_torch.mesh import sdf as TS
    errs, sames = [], []
    for name, sub in K11_HEAPS:
        b = build_bvh(build_mesh(*(cube_mesh(0.2) if sub is None
                                   else gen.icosphere(0.3, sub))),
                      device=pts.device)
        exact_d2, _ = TS.closest_bvh_plain(b, pts)
        for kind, cap in (("capped", 48 * b.depth),
                          ("exact", 4 * b.n_leaves)):
            label = f"{name} (depth {b.depth}), {kind}"
            err, same, _, _ = check_bvh_capped(b, pts, cap, exact_d2, label)
            check_k11_exact(b, pts, cap, label)
            errs.append(err)
            sames.append(same)
    return max(errs), min(sames)


def turns(calls, reps):
    """Each call's device time in CUDA graphs (graph_ms), in turns: the
    calls in order, then in reverse. Returns {name: the smaller ms}."""
    times = {k: [] for k in calls}
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k].append(graph_ms(calls[k], reps))
    return {k: min(v) for k, v in times.items()}


def run_ms(fn):
    """fn() once and its device time by CUDA events: (its result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    sync()
    return out, start.elapsed_time(end)


def k11_times(bvh_ico, bvh, pts, smi, walks):
    """K11 and the kernel it replaced (bvh_reference) timed in CUDA graphs,
    in turns, beside the bound on the rows the plain walks read
    (bvh_bounds) and the plain version's time, at four shapes: the 10,240
    points on icosphere(0.3, 5) at mesh_sdf's cap and exact, on the 1.31M
    mesh at its cap, and the longest walk at 32k (the point with the most
    visits at the cap, and exact) launched by itself. ``walks``: {case:
    (bvh, cap, the plain version's visits and rows read, its ms)} for the
    two capped batches; the exact batch's plain run and the longest walks'
    are made here. Prints a line a case. Returns {case: its numbers}."""
    from hpsdf_tpu_torch.mesh import sdf as TS
    out = {}
    cases = {k: (b, c, pts, vis, seen, plain)
             for k, (b, c, vis, seen, plain) in walks.items()}
    cap = walks["32k capped"][1]
    (_, _, vis_x, seen_x), plain_x = run_ms(
        lambda: TS.closest_bvh_plain(bvh_ico, pts, None, with_stats=True))
    cases["32k exact"] = (bvh_ico, None, pts, vis_x, seen_x, plain_x)
    for kind, c, vis in (("capped", cap, walks["32k capped"][2]),
                         ("exact", None, vis_x)):
        i = int(vis.sum(dim=1).argmax())
        one = pts[i:i + 1].contiguous()
        _, _, vis1, seen1 = TS.closest_bvh_plain(bvh_ico, one, c,
                                                 with_stats=True)
        cases[f"32k longest walk alone, {kind}"] = (bvh_ico, c, one, vis1,
                                                    seen1, None)
    for name, (b, c, p, vis, seen, plain) in cases.items():
        ms = turns({"K11": lambda: TS.closest_bvh(b, p, c),
                    "replaced": lambda: bvh_reference(b, p, c)},
                   5 if p.shape[0] == 1 or c is not None else 2)
        bound = bvh_bounds(b, p, vis, seen)
        out[name] = {
            "points": p.shape[0], "max_iters": c, "ms": ms["K11"],
            "replaced_kernel_ms": ms["replaced"], "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1],
            "ops_bound_ms": bound[2], "bytes_bound_ms": bound[3],
            "mean_rows_read": vis.double().mean(dim=0).tolist()}
        print(f"[mesh scale] {smi} | K11 {name} ({p.shape[0]} points, "
              f"{b.n_leaves} rows, max_iters {c or 'exact'}): "
              f"{ms['K11']:.4f} ms, the kernel it replaced "
              f"{ms['replaced']:.4f} ms; bound {bound[0]:.5f} ms "
              f"({bound[1]}; operations {bound[2]:.5f}, bytes "
              f"{bound[3]:.5f}), {bound[0] / ms['K11']:.2%} of it"
              + ("" if plain is None else f"; plain {plain:.3f} ms")
              + f"; mean rows a walk read {out[name]['mean_rows_read']}",
              flush=True)
    return out


# K10 time split (build_hybrid_forms): the forms stopped after each stage
HYBRID_STAGES = {1: "cluster prune", 2: "subcluster prune"}
MESH_PHASES = FIT_PHASES + (("mesh.sdf", "_hybrid_launch", "K10"),
                            ("mesh.sdf", "_signed_from_best", "sign"))


def time_hybrid(bvh, pts, forms, reps=5):
    """K10 at these points in CUDA graphs, in two turns: the kernel through
    its wrapper on the rows the main path passes (the BVH's vertex rows)
    and the forms stopped after each stage. Returns {name: the smaller ms
    of the turns}."""
    from hpsdf_tpu_torch.mesh import sdf as TS
    lo, hi = TS.cluster_aabbs(bvh)
    calls = {"kernel": lambda: TS.hybrid_closest(
        lo, hi, bvh.node_rows, bvh.vertex_rows, pts)}
    calls.update({HYBRID_STAGES[s]: hybrid_form(lib, bvh, pts)
                  for s, lib in forms.items()})
    times = {k: [] for k in calls}
    for _ in range(2):
        for k, fn in calls.items():
            times[k].append(graph_ms(fn, reps))
    return {k: min(v) for k, v in times.items()}


def phase_mesh_scale(cfg, bvh_ico, smi, slice_pts, seed=21):
    """The mesh -> SDF path at the reference's scale (bench.py:416-517):
    bumpy_sphere(0.3, 8) written to .obj, loaded and built through the
    native host paths, then K10 against its plain version (at the uniform
    points, at the escalation widths, at N_NEAR points near the surface,
    where many boxes lie at distance 0, at the fit's largest batch, and
    at k1 = k2 = 512 and 2,048, whose lists outgrow 8 warps' shared
    memory) and, through signed_distance_hybrid(atol=0) at the default
    widths and at 128 (escalating to 512), P1's exact distances; K11
    on icosphere(0.3, 5) (bench.py's bvh_signed_distance_10k) exact against
    P1 and at mesh_sdf's default cap against its plain version, on the
    small heaps (check_k11_heaps) and at 1.31M at its cap, everywhere bit
    for bit against the kernel it replaced, and timed (k11_times); a tree
    fitted through mesh_sdf's default (K10) held to P1 near the surface and
    split by phase in a second build (F, K10 inside it, the sign, the
    projection, the host topology); K10 split by stage and at the fit's
    largest batch in CUDA graphs; K10 and
    P1 at 32k (at the uniform points and the slice fit's largest batch,
    ``slice_pts``), 82k and 1.31M triangles. The main path's launches are
    read over two runs: the fit with signed_distance_hybrid, and the walk
    through mesh_sdf(method="bvh") and signed_distance. Returns (launches,
    the kernels' entries)."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import _kernels, native
    from hpsdf_tpu_torch.mesh import (build_bvh, build_mesh, gen, load_obj,
                                      mesh_sdf, signed_distance,
                                      signed_distance_hybrid)
    from hpsdf_tpu_torch.mesh import sdf as TS
    from hpsdf_tpu_torch.mesh.tiles_sdf import closest_tri_tiles, tile_table

    dev = bvh_ico.tri_rows.device
    src = os.path.join(os.path.dirname(_kernels.__file__), "csrc",
                       "hybrid.cu")
    with ThreadPoolExecutor(1) as pool:       # the forms build meanwhile
        forms_job = pool.submit(build_hybrid_forms, src, HYBRID_STAGES,
                                "split")
        check(native.available(), "the native host library builds and loads")
        host = {}
        t0 = time.perf_counter()
        v, f = gen.bumpy_sphere(0.3, MESH_SCALE_SUB)
        host["generate_s"] = time.perf_counter() - t0
        path = os.path.join(_kernels.BUILD_DIR, "chip_smoke_1p3m.obj")
        t0 = time.perf_counter()
        gen.save_obj(path, v, f)
        host["save_obj_s"] = time.perf_counter() - t0
        with native_paths() as took:
            t0 = time.perf_counter()
            v2, f2, _ = load_obj(path)
            host["load_obj_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh = build_mesh(v2, f2)
            host["build_mesh_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            bvh = build_bvh(mesh, device=dev)
            sync()
            host["build_bvh_s"] = time.perf_counter() - t0
        os.remove(path)
        forms = forms_job.result()
    paths = {k: ",".join(sorted(set(took.get(k, ["not called"]))))
             for k in NATIVE_STAGES}
    check(all(p == "native" for p in paths.values()),
          f"a host stage left the native path: {paths}")
    check(np.array_equal(f2, f) and float(np.abs(v2 - v).max()) < 1e-6,
          "load_obj round trip")
    T2 = bvh.n_leaves
    lo, hi = TS.cluster_aabbs(bvh)
    print(f"[mesh scale] {mesh.n_faces} triangles, {T2} rows, NC "
          f"{lo.shape[0]}: tri_rows {bvh.tri_rows.numel() * 4 / 1e6:.1f} MB "
          f"and node_rows {bvh.node_rows.numel() * 4 / 1e6:.1f} MB on the "
          f"card; host {split_text(host)}; paths {paths}", flush=True)

    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(-0.5, 0.5, (N_MESH_PTS, 3))
                          .astype(np.float32), device=dev)
    near = torch.as_tensor(surface_points(mesh, N_NEAR, NEAR_OFFSET, seed),
                           device=dev)
    table = tile_table(bvh.tri_rows)
    verts = bvh.vertex_rows
    k10_err, blocks, sub = check_hybrid(bvh, pts, "1.31M")
    errs = [check_hybrid(bvh, pts, "1.31M, packed rows",
                         rows=bvh.tri_rows)[0]]
    errs += [check_hybrid(bvh, p, label, k1, k2)[0] for p, label, k1, k2 in (
        (pts[:2048], "1.31M, escalation widths", 4 * TS.HYBRID_K1,
         4 * TS.HYBRID_K2),
        (near, f"1.31M, {N_NEAR} points near the surface", None, None),
        (near[:2048], "1.31M, near the surface, escalation widths",
         4 * TS.HYBRID_K1, 4 * TS.HYBRID_K2),
        (pts[:1024], "1.31M, wide lists", 512, 512),
        (near[:1024], "1.31M, near the surface, wide lists", 512, 512),
        (pts[:256], "1.31M, the wide lists' escalation", 2048, 2048),
        (near[:256], "1.31M, near the surface, the wide lists' escalation",
         2048, 2048))]
    near_err = errs[2]
    k10_err = max(k10_err, *errs)
    d2_p1, idx_p1 = closest_tri_tiles(bvh.tri_rows, pts, table)
    exact = TS._signed_from_best(bvh.tri_rows, idx_p1, pts)

    # --- main path, K10: the fit through mesh_sdf's default, then the
    # certified distances ---
    F = mesh_sdf(mesh, bvh)
    check(F.method == "hybrid", f"mesh_sdf auto picked {F.method} at {T2}")
    samples = [0]
    largest = [torch.empty((0, 3))]

    def F_counted(p):
        samples[0] += p.shape[0]
        if p.shape[0] > largest[0].shape[0]:
            largest[0] = p
        return F(p)

    reset_counts()
    sync()
    t0 = time.perf_counter()
    tree = T.build_octree(cfg, F_counted, device=dev)
    sync()
    fit_s = time.perf_counter() - t0
    fit_launches = read_counts()["hybrid"]
    q = T.query(tree, near.double())
    sd, (n_bad, n_worse) = signed_distance_hybrid(bvh, pts, atol=0.0,
                                                  with_stats=True)
    sync()
    launches = read_counts()
    check(launches["hybrid"] > 0, "K10 never launched on the main path")
    check(launches["signed_from_best"] > 0,
          "K14 never launched on the mesh path")
    sd_err = float((sd - exact).abs().max())
    check(sd_err <= SIGNED_ATOL,
          f"signed_distance_hybrid(atol=0) vs P1: {sd_err:.3e}")
    fixed = TS.hybrid_sdf_fn(bvh)(pts)
    fixed_err = float((fixed - exact).abs().max())
    sd_w, (n_bad_w, n_worse_w) = signed_distance_hybrid(
        bvh, pts, 128, 128, atol=0.0, with_stats=True)
    sd_w_err = float((sd_w - exact).abs().max())
    check(sd_w_err <= SIGNED_ATOL, "signed_distance_hybrid(k1 = k2 = 128, "
          f"atol=0) vs P1: {sd_w_err:.3e}")
    _, idx_near = closest_tri_tiles(bvh.tri_rows, near, table)
    exact_near = TS._signed_from_best(bvh.tri_rows, idx_near, near)
    fit_err = float((q - exact_near.double()).abs().max())
    check(bool(torch.isfinite(q).all()) and fit_err < FIT_ATOL,
          f"max|query - P1 signed distance| near the surface {fit_err}")
    splits = sign_split(lambda: T.build_octree(cfg, F, device=dev),
                        MESH_PHASES, TS)
    split = splits["k14"]
    k6s = k6_split(lambda: T.build_octree(cfg, F, device=dev),
                   MESH_PHASES)[0]
    fit = {"fit_s": fit_s, "F_samples": samples[0], "nodes": tree.n_nodes,
           "leaves": tree.num_leaves(), "deg_used": tree.deg_used,
           "depth_used": tree.depth_used, "hybrid_launches": fit_launches,
           "near_max_abs_err": fit_err, "split": split,
           "split_sign_before": splits["before"], "k6_split": k6s}
    print(f"[mesh scale] fit through mesh_sdf (K10): {fit_s:.3f} s, F "
          f"samples {samples[0]}, nodes {tree.n_nodes}, leaves "
          f"{tree.num_leaves()}, deg_used {tree.deg_used}, depth_used "
          f"{tree.depth_used}, K10 launches {fit_launches} (and "
          f"{launches['hybrid'] - fit_launches} in signed_distance_hybrid); "
          f"a second build split: {split_text(split)}, "
          f"{split['K10_calls']} K10 calls, {split['sign_calls']} sign calls"
          f"; with the sign as before K14 (G + torch): "
          f"{split_text(splits['before'])}, G launches "
          f"{splits['before']['g_launches']} against {split['g_launches']}; "
          f"{k6_text(k6s)}; max|query - P1| at {N_NEAR} "
          f"points within {NEAR_OFFSET} of the surface {fit_err:.3e} | "
          f"signed_distance_hybrid(atol=0) at {N_MESH_PTS} uniform points: "
          f"{n_bad / N_MESH_PTS:.4%} escalated to 4x widths, "
          f"{n_worse / N_MESH_PTS:.4%} to P1, max|. - P1| {sd_err:.3e}; "
          f"at k1 = k2 = 128 {n_bad_w} escalated to 512, {n_worse_w} to P1, "
          f"max|. - P1| {sd_w_err:.3e}; "
          f"fixed-K hybrid max|. - P1| {fixed_err:.3e}", flush=True)

    # --- K14 at 2^20 uniform points on K10's best indices ---
    uni = torch.as_tensor(np.random.default_rng(seed + 1).uniform(
        -0.5, 0.5, (1 << 20, 3)).astype(np.float32), device=dev)
    count = TS.hybrid_closest.launches
    _, idx_uni, _ = TS.hybrid_closest(lo, hi, bvh.node_rows, verts, uni)
    TS.hybrid_closest.launches = count
    k14 = check_k14(bvh.tri_rows, idx_uni, uni,
                    f"2^20 uniform points, {T2} rows")

    # --- main path, K11: the walk through mesh_sdf(method="bvh") and
    # signed_distance on icosphere(0.3, 5) ---
    mesh_ico = build_mesh(*gen.icosphere(0.3, 5))
    table_ico = tile_table(bvh_ico.tri_rows)
    d2_ico, idx_ico = closest_tri_tiles(bvh_ico.tri_rows, pts, table_ico)
    exact_ico = TS._signed_from_best(bvh_ico.tri_rows, idx_ico, pts)
    cap = 48 * bvh_ico.depth
    reset_counts()
    F_bvh = mesh_sdf(mesh_ico, bvh_ico, method="bvh")
    s_cap = F_bvh(pts)
    s_exact = signed_distance(bvh_ico, pts)
    sync()
    launches_w = read_counts()
    check(launches_w["bvh_walk"] > 0, "K11 never launched on the main path")
    walk_err = float((s_exact - exact_ico).abs().max())
    check(walk_err <= SIGNED_ATOL,
          f"K11 exact signed distance vs P1: {walk_err:.3e}")
    d2_x, _ = TS.closest_bvh(bvh_ico, pts, None)
    k11_err = float((d2_x - d2_ico).abs().max())
    check(bool((d2_x - d2_ico).abs().le(TRI_ATOL + TRI_RTOL * d2_ico).all()),
          f"K11 exact d2 vs P1: {k11_err:.3e}")
    cap_err, same, vis_p, seen = check_bvh_capped(
        bvh_ico, pts, cap, d2_ico, "icosphere(0.3, 5)")
    check(same >= K11_VISITS_SAME, f"K11 visit counts equal the plain "
          f"version's on {same:.4%} of walks at the cap")
    check(bool((s_cap.abs() >= exact_ico.abs() - SIGNED_ATOL).all()),
          "K11 capped distances are upper bounds")
    for c in (cap, None):
        check_k11_exact(bvh_ico, pts, c, f"icosphere(0.3, 5), max_iters {c}")
    print(f"[mesh scale] K11 exact: max|signed - P1| {walk_err:.3e}, "
          f"max|d2 - P1| {k11_err:.3e}; capped at {cap}: "
          f"max|signed - P1| {float((s_cap - exact_ico).abs().max()):.3e}; "
          f"launches {launches_w['bvh_walk']}; best_d2, best_idx and visits "
          "bit for bit those of the kernel it replaced, capped and exact",
          flush=True)
    heaps_err, heaps_same = check_k11_heaps(pts)
    cap_m = 48 * bvh.depth
    m_err, m_same, vis_m, seen_m = check_bvh_capped(
        bvh, pts, cap_m, d2_p1, "1.31M")
    iters_m = check_k11_exact(bvh, pts, cap_m, f"1.31M, max_iters {cap_m}"
                              ).sum(dim=1) - bvh.depth - 1
    print(f"[mesh scale] K11 on the 1.31M mesh at its cap of {cap_m}: "
          f"{int((iters_m >= cap_m).sum())} of {N_MESH_PTS} walks reach it; "
          "bit for bit the kernel it replaced", flush=True)

    # --- K10 at the fit's largest batch: checked, timed, bound ---
    fit_pts = largest[0].to(torch.float32).contiguous()
    fb_err, fb_blocks, _ = check_hybrid(
        bvh, fit_pts, f"1.31M, the fit's largest batch ({fit_pts.shape[0]} "
        "points)")
    k10_err = max(k10_err, fb_err)
    fb_times = time_hybrid(bvh, fit_pts, {}, reps=2)
    fb_stats = TS._hybrid_launch(lo, hi, bvh.node_rows, verts, fit_pts,
                                 with_stats=True)[3]
    fb_bound = hybrid_bounds(lo, fit_pts, fb_blocks, sub, TS.HYBRID_K1,
                             fb_stats)
    fb_full = hybrid_bounds(lo, fit_pts, fb_blocks, sub, TS.HYBRID_K1)
    fb_work = fb_stats.double().mean(dim=0).tolist()
    del fb_blocks, fb_stats

    # --- K14 at the fit's largest batch, on K10's best indices ---
    count = TS.hybrid_closest.launches
    _, idx_fb, _ = TS.hybrid_closest(lo, hi, bvh.node_rows, verts, fit_pts)
    TS.hybrid_closest.launches = count
    k14_fb = check_k14(bvh.tri_rows, idx_fb, fit_pts,
                       f"the 1.31M fit's largest batch ({fit_pts.shape[0]} "
                       "points)")
    del idx_fb

    # --- times: K10 split by stage; K10 and P1
    # at 32k, 82k and 1.31M; K11 capped and exact; plain versions once ---
    split_ms = time_hybrid(bvh, pts, forms)
    mid = build_mesh(*gen.bumpy_sphere(0.3, MESH_MID_SUB))
    bvh_mid = build_bvh(mid, device=dev)
    check_hybrid(bvh_mid, pts, "82k")
    check_hybrid(bvh_ico, pts, "32k (icosphere(0.3, 5))")
    sp = slice_pts.to(torch.float32).contiguous()
    check_hybrid(bvh_ico, sp[:N_FIT_CHECK], "32k, the slice fit's batch "
                 f"(first {N_FIT_CHECK} of {sp.shape[0]})")
    cross = {}
    for name, b, p, reps in (
            ("32k", bvh_ico, pts, 5),
            ("32k, slice fit batch", bvh_ico, sp, 2),
            ("82k", bvh_mid, pts, 5), ("1.31M", bvh, pts, 5)):
        lo_, hi_ = TS.cluster_aabbs(b)
        tab = tile_table(b.tri_rows)
        vb = b.vertex_rows
        cross[name] = {
            "rows": b.n_leaves, "clusters": lo_.shape[0],
            "points": p.shape[0],
            "k10_ms": graph_ms(lambda: TS.hybrid_closest(
                lo_, hi_, b.node_rows, vb, p), reps),
            "p1_ms": graph_ms(lambda: closest_tri_tiles(b.tri_rows, p, tab),
                              2)}
    k10_plain = time_ms(lambda: TS.hybrid_closest_plain(
        lo, hi, bvh.node_rows, verts, pts), 1)
    stats = TS._hybrid_launch(lo, hi, bvh.node_rows, verts, pts,
                              with_stats=True)[3]
    work = stats.double().mean(dim=0).tolist()
    k10_bound = hybrid_bounds(lo, pts, blocks, sub, TS.HYBRID_K1, stats)
    k10_full = hybrid_bounds(lo, pts, blocks, sub, TS.HYBRID_K1)
    k11_plain = time_ms(lambda: TS.closest_bvh_plain(bvh_ico, pts, cap), 1,
                        warmup=0)
    m_plain = time_ms(lambda: TS.closest_bvh_plain(bvh, pts, cap_m), 1,
                      warmup=0)
    k11 = k11_times(bvh_ico, bvh, pts, smi, {
        "32k capped": (bvh_ico, cap, vis_p, seen, k11_plain),
        "1.31M capped": (bvh, cap_m, vis_m, seen_m, m_plain)})
    k10_ms = split_ms["kernel"]
    print(f"[mesh scale] {smi} | K10 at {N_MESH_PTS} points, 1.31M: "
          f"{k10_ms:.4f} ms, bound on its own work {k10_bound[0]:.5f} ms "
          f"({k10_bound[1]}; operations {k10_bound[2]:.5f}, bytes "
          f"{k10_bound[3]:.5f}), {k10_bound[0] / k10_ms:.1%} of it (a "
          f"point's chunks, clusters, subclusters, rows {work}); bound on "
          f"the plain version's work {k10_full[0]:.4f} ms "
          f"({k10_full[0] / k10_ms:.1%}); plain {k10_plain:.3f} ms; "
          f"split: " + ", ".join(f"{HYBRID_STAGES[s]} "
                                 f"{split_ms[HYBRID_STAGES[s]]:.4f}"
                                 for s in HYBRID_STAGES)
          + f", whole {k10_ms:.4f} ms; at the fit's largest batch"
          f" ({fit_pts.shape[0]} points) {fb_times['kernel']:.4f} ms, bound "
          f"on its work {fb_bound[0]:.4f} ms ({fb_bound[1]}), "
          f"{fb_bound[0] / fb_times['kernel']:.1%} of it (a point's work "
          f"{fb_work}), on the plain version's {fb_full[0]:.4f} ms"
          + " | crossover (CUDA graphs): " + ", ".join(
              f"{k} ({v['points']} points) K10 {v['k10_ms']:.4f} / P1 "
              f"{v['p1_ms']:.4f} ms" for k, v in cross.items()), flush=True)
    total = {k: launches[k] + launches_w[k] for k in launches}
    entries = {
        "hybrid": {
            "launches": total["hybrid"], "max_abs_err": k10_err,
            "ms": k10_ms, "plain_ms": k10_plain, "bound_ms": k10_bound[0],
            "bound_by": k10_bound[1], "library_ms": None,
            "ops_bound_ms": k10_bound[2], "bytes_bound_ms": k10_bound[3],
            "full_bound_ms": k10_full[0], "work_mean": work,
            "points": N_MESH_PTS,
            "split_ms": {HYBRID_STAGES[s]: split_ms[HYBRID_STAGES[s]]
                         for s in HYBRID_STAGES},
            "fit_batch": {"points": fit_pts.shape[0],
                          "ms": fb_times["kernel"],
                          "bound_ms": fb_bound[0], "bound_by": fb_bound[1],
                          "ops_bound_ms": fb_bound[2],
                          "bytes_bound_ms": fb_bound[3],
                          "full_bound_ms": fb_full[0], "work_mean": fb_work},
            "near_max_abs_err": near_err,
            "crossover": cross, "fit": fit, "host": host,
            "native_paths": paths,
            "escalated_share": n_bad / N_MESH_PTS,
            "to_p1_share": n_worse / N_MESH_PTS,
            "signed_atol0_max_abs_err": sd_err,
            "signed_k128_max_abs_err": sd_w_err,
            "k128_escalated": n_bad_w, "k128_to_p1": n_worse_w,
            "fixed_k_max_abs_err": fixed_err},
        "bvh_walk": {
            "launches": total["bvh_walk"],
            "max_abs_err": max(k11_err, cap_err, m_err, heaps_err),
            **{k: k11["32k capped"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "ops_bound_ms",
                "bytes_bound_ms", "replaced_kernel_ms", "mean_rows_read",
                "max_iters")},
            "library_ms": None, "exact_ms": k11["32k exact"]["ms"],
            "shapes": k11, "visits_equal_share": same,
            "mesh_1p31m": {"max_abs_err": m_err, "visits_equal_share": m_same,
                           "capped_walks": int((iters_m >= cap_m).sum())},
            "heaps": {"max_abs_err": heaps_err,
                      "min_visits_equal_share": heaps_same},
            "signed_exact_max_abs_err": walk_err},
        "k14": k14, "k14_fit_batch": k14_fb}
    return total, entries


# --------------------------------------------------------------------------
# [sharding]: the port's sharded paths on torch.distributed
# --------------------------------------------------------------------------

SHARD_CG_RTOL, SHARD_CG_ATOL = 1e-10, 1e-12   # tests/test_parallel.py:117-130
SHARD_INV_RTOL = 1e-4       # K7, K8 and G's backward add with atomics
SHARD_INV_STEPS = 3
SHARD_TILE = 8              # K4's tiles, as render_image takes them
# the two gloo ranks on one card: points, rays a side, inverse rays a side
SHARD_SMALL = dict(points=1 << 16, side=256, inverse=128)
SHARD_REPS = 20             # iterations a timed run of the sharded CG takes
SHARD_RANKS_S = 300         # the two gloo ranks' limit, start-up included


def cg_close(got, want):
    """The largest |got - want| - (atol + rtol |want|) at
    SHARD_CG_RTOL / SHARD_CG_ATOL (within where <= 0), and the largest
    |got - want|."""
    d = (got - want).abs()
    return (float((d - SHARD_CG_ATOL - SHARD_CG_RTOL * want.abs()).max()),
            float(d.max()))


@contextlib.contextmanager
def record_calls(module, attr):
    """While the block runs, every call of module.attr appends its result to
    the list the block gets."""
    from unittest import mock
    fn, seen = getattr(module, attr), []

    def call(*args, **kw):
        seen.append(fn(*args, **kw))
        return seen[-1]

    with mock.patch.object(module, attr, call):
        yield seen


def wall_ms(fn, reps):
    """Host milliseconds a call of fn(), synchronised: what a caller waits."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps * 1e3


def check_row_modes(blk, s, minv, label, seed=13):
    """K9's partial mode and K9u's two launches on a rank's block
    (``continuity.RowBlock``) against their plain versions on the card, on
    random vectors (p gathered, x and r the rank's rows; K9u fed the plain
    matvec's y and p.y): CONT_RTOL of the largest entry. Returns (errs,
    abs_errs, the gathered p)."""
    from hpsdf_tpu_torch import continuity as TC
    dev = minv.device
    g = torch.Generator(device=dev).manual_seed(seed)
    p_all = torch.randn(blk.op.n, generator=g, dtype=torch.float64,
                        device=dev)
    x, r = (torch.randn(blk.rows, generator=g, dtype=torch.float64,
                        device=dev) for _ in range(2))
    p, minv = p_all[blk.row0: blk.row0 + blk.rows], minv[:blk.rows]
    want = TC.face_matvec_rows_plain(blk, s, p_all)
    rz = torch.dot(r, minv * r)
    upd = TC.cg_update_rows_plain(False, rz, want[1], p, want[0], minv, x, r)
    errs, abs_errs = {}, {}
    for pre, names, got, w in (
            ("k9 rows", ("y", "p.y"), TC.cg_matvec_rows(blk, s, p_all),
             want),
            ("k9u rows", ("x", "r", "z", "r.z", "r.r"),
             TC.cg_update_rows(False, rz, want[1], p, want[0], minv, x, r),
             upd),
            ("direction", ("p'",),
             (TC.cg_direction(False, rz, upd[3], upd[2], p),),
             (TC.cg_direction_plain(False, rz, upd[3], upd[2], p),))):
        e, a = rel_errs(pre, names, got, w)
        errs.update(e)
        abs_errs.update(a)
    for k, e in errs.items():
        check(e <= CONT_RTOL, f"{label}: {k} against plain, relative {e}")
    return errs, abs_errs, p_all


def update_rows_reference(init, n, Ap, minv, x, r, p, z, state):
    """K9u's first launch in the row-sharded CG as it was before its
    redesign (csrc/check/cg_rows_reference.cu), with
    ``continuity._update_rows_launch``'s arguments; not counted."""
    from hpsdf_tpu_torch import _kernels
    _kernels.check(_kernels.load(), _kernels.load_check()
                   .hpsdf_cg_update_rows_reference(
                       int(init), n, Ap.data_ptr(), minv.data_ptr(),
                       x.data_ptr(), r.data_ptr(), p.data_ptr(), z.data_ptr(),
                       state.partials.data_ptr(), state.sc.data_ptr(),
                       state.st.data_ptr(), _kernels.stream_of(minv)),
                   "cg_update_rows_reference")


def direction_reference(init, n, z, p, state):
    """K9u's second launch as it was before its redesign, with
    ``continuity._direction_launch``'s arguments; not counted."""
    from hpsdf_tpu_torch import _kernels
    _kernels.check(_kernels.load(), _kernels.load_check()
                   .hpsdf_cg_direction_reference(
                       int(init), n, z.data_ptr(), p.data_ptr(),
                       state.sc.data_ptr(), state.st.data_ptr(),
                       _kernels.stream_of(z)), "cg_direction_reference")


def rows_pairs():
    """K9u's two launches: the replaced pair and the shipped one, by name."""
    from hpsdf_tpu_torch import continuity as TC
    return {"replaced": (update_rows_reference, direction_reference),
            "shipped": (TC._update_rows_launch, TC._direction_launch)}


@contextlib.contextmanager
def replaced_rows():
    """While the block runs, the row-sharded CG launches the replaced pair."""
    from unittest import mock
    from hpsdf_tpu_torch import continuity as TC
    with mock.patch.object(TC, "_update_rows_launch",
                           update_rows_reference), \
            mock.patch.object(TC, "_direction_launch", direction_reference):
        yield


# the state slots the replaced kernels know, and the dots among them,
# which add in another order and are held to CONT_RTOL
ROWS_OLD_SC, ROWS_OLD_ST = 8, 4
ROWS_DOTS = ("rz_part", "rr_part")


def rows_snapshot(vec, state):
    """The vectors and the state, copied."""
    return {**{k: v.clone() for k, v in vec.items()},
            "sc": state.sc.clone(), "st": state.st.clone()}


def rows_differences(got, want):
    """What differs between two snapshots from one state (the replaced
    launch in ``want``): the vectors bit for bit, the dots within CONT_RTOL,
    every other scalar, k and the flag of the slots the replaced kernels
    know exactly. Returns the names that differ."""
    from hpsdf_tpu_torch import continuity as TC
    bad = [k for k in want if k not in ("sc", "st")
           and not torch.equal(got[k], want[k])]
    for name, i in TC._SC.items():
        if i >= ROWS_OLD_SC:
            continue
        a, b = float(got["sc"][i]), float(want["sc"][i])
        if name in ROWS_DOTS:
            if not abs(a - b) <= CONT_RTOL * abs(b):
                bad.append(name)
        elif a != b and not (a != a and b != b):
            bad.append(name)
    bad += [name for name, i in TC._ST.items() if i < ROWS_OLD_ST
            and int(got["st"][i]) != int(want["st"][i])]
    return bad


def rows_planted(snap):
    """Faults planted in a snapshot, each with the name a check must
    report: each vector with two entries moved, and a scalar written to
    another scalar's slot (alpha into beta's, r.r into r.z's, the flag into
    k's)."""
    from hpsdf_tpu_torch import continuity as TC
    out = []
    for k, v in snap.items():
        if k in ("sc", "st"):
            continue
        i = int(torch.argmax((v != v[0]).to(torch.int8)))
        if i == 0:
            continue
        w = v.clone()
        w[0], w[i] = v[i], v[0]
        out.append((k, {**snap, k: w}))
    for key, names, src, dst in (("sc", TC._SC, "alpha", "beta"),
                                 ("sc", TC._SC, "rr_part", "rz_part"),
                                 ("st", TC._ST, "active", "k")):
        w = snap[key].clone()
        if w[names[src]] == w[names[dst]]:
            continue
        w[names[dst]] = w[names[src]]
        out.append((dst, {**snap, key: w}))
    return out


def rows_pair_checks(vec, state, n, label):
    """K9u's two shipped launches against the replaced ones from the same
    live state (``vec``: Ap, minv, x, r, p, z): x, r, z and p bit for bit,
    the dots within CONT_RTOL, the scalars, k and the flag equal after each
    launch,
    the shipped first launch's copies of rz and the flag; both forms (INIT
    and an iteration); a dead launch of each (the flag down) changes no
    vector and no scalar but the copy of the flag. Every comparison must
    report the faults ``rows_planted`` plants. Returns the number of
    comparisons and of faults caught."""
    from hpsdf_tpu_torch import continuity as TC
    pairs = rows_pairs()
    checked = caught = 0

    def compare(got, want, what):
        nonlocal checked, caught
        bad = rows_differences(got, want)
        check(not bad, f"{label}: {what} against the replaced kernel: "
              f"{bad} differ")
        checked += 1
        for name, planted in rows_planted(got):
            check(name in rows_differences(planted, want),
                  f"{label}: {what}: a planted fault in {name} not caught")
            caught += 1

    for init in (True, False):
        first = {}
        for key, (update, _) in pairs.items():
            v = {k: t.clone() for k, t in vec.items()}
            st = TC._State(state.sc.clone(), state.st.clone(),
                           torch.empty_like(state.partials))
            update(init, n, v["Ap"], v["minv"], v["x"], v["r"], v["p"],
                   v["z"], st)
            first[key] = rows_snapshot(v, st)
        sync()
        form = "INIT" if init else "an iteration"
        got = first["shipped"]
        compare(got, first["replaced"], f"K9u's first launch ({form})")
        check(float(got["sc"][TC._SC["rz_old"]])
              == float(state.sc[TC._SC["rz"]])
              and int(got["st"][TC._ST["live"]]) == 1,
              f"{label}: K9u's first launch ({form}) copies rz and the flag")
        # the second launches from one state, the shipped first launch's,
        # so that both divide the same dots
        two = {}
        for key, (_, direction) in pairs.items():
            v = {k: got[k].clone() for k in vec}
            st = TC._State(got["sc"].clone(), got["st"].clone(),
                           torch.empty_like(state.partials))
            direction(init, n, v["z"], v["p"], st)
            two[key] = rows_snapshot(v, st)
        sync()
        compare(two["shipped"], two["replaced"],
                f"K9u's second launch ({form})")
    # dead launches: the flag down
    v = {k: t.clone() for k, t in vec.items()}
    st = TC._State(state.sc.clone(), state.st.clone(),
                   torch.empty_like(state.partials))
    st.st[TC._ST["active"]] = 0
    before = rows_snapshot(v, st)
    TC._update_rows_launch(False, n, v["Ap"], v["minv"], v["x"], v["r"],
                           v["p"], v["z"], st)
    TC._direction_launch(False, n, v["z"], v["p"], st)
    sync()
    after = rows_snapshot(v, st)
    check(int(after["st"][TC._ST["live"]]) == 0, f"{label}: a dead first "
          f"launch copies the flag")
    after["st"][TC._ST["live"]] = before["st"][TC._ST["live"]]
    compare(after, before, "a dead launch of each")
    return checked, caught


def row_block_of(tree, s, size, rank):
    """A fitted tree's face operator (host), its Jacobi diagonal on the
    card, and rank ``rank``'s block of ``size`` on the card."""
    from hpsdf_tpu_torch import continuity as TC
    st = TC._LeafView(tree)
    op, diag = TC.face_operator(st, *TC.leaf_face_pairs(st.child_idx, st.n),
                                s)
    blk = TC.row_block(op, size, rank)
    minv = torch.as_tensor(1.0 / diag[blk.lo: blk.lo + blk.rows],
                           device=tree.device)
    return op, blk.to(tree.device), minv


# the node axis: bench.py:626-668's complete octree (depth 7, 2,396,752
# rows, degree 2, coefficients N(0, 0.01) from the seed) at bench.py:684's
# 2^20 uniform points
NODE_DEPTH = 7
NODE_SEED = 0
NODE_SPLITS = (1, 2, 3)             # blocks summed on one rank
NODE_STEP_POINTS = 1 << 16          # the node-sharded train steps' points
# points past two windows of the sort's segments (csrc/coeff_scatter.cu's
# kSegWindow of kSortPoints points each)
NODE_MANY_POINTS = 3 << 22
NODE_STEP_LR = 1e-4
NODE_STEP_ATOL = 1e-12              # tests/test_parallel.py:62-84
# the operations a call of K8's node-range mode may put on the card (the
# kernel it replaced: the output's memset and a launch; now the sort and
# the tiles)
K8N_LAUNCHES = 3


def complete_tree(depth, seed, device):
    """bench.py:626-668's complete octree as the port's Octree: every level
    full to ``depth``, in level order (level l starts at (8^l - 1) / 7 and
    node s_l + j has its children at s_(l+1) + 8 j), the rows padded to a
    multiple of 8, leaves of degree 2 with N(0, 0.01) coefficients from
    ``seed``."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import consts

    n_total = (8 ** (depth + 1) - 1) // 7
    N = -(-n_total // 8) * 8
    child = np.full(N, -1, np.int32)
    dep = np.zeros(N, np.int32)
    degree = np.full(N, -1, np.int32)
    centre = np.zeros((N, 3), np.float64)
    start = 0
    for lvl in range(depth + 1):
        cnt = 8 ** lvl
        nxt = start + cnt
        if lvl < depth:
            child[start: nxt] = nxt + 8 * np.arange(cnt)
        else:
            degree[start: nxt] = 2
        dep[start: nxt] = lvl
        # the centre from the node's octal path (bit 0 x, 1 y, 2 z)
        jj = np.arange(cnt, dtype=np.int64)
        c = np.zeros((cnt, 3))
        for lev in range(lvl, 0, -1):
            digit = jj % 8
            q = 2.0 ** -(lev + 1)
            for a in range(3):
                c[:, a] += q * (((digit >> a) & 1) * 2 - 1)
            jj //= 8
        centre[start: nxt] = c
        start = nxt
    coeffs = np.zeros((N, consts.coeff_count(2)))
    leaf = degree >= 0
    coeffs[leaf] = np.random.default_rng(seed).normal(
        0, 0.01, (int(leaf.sum()), coeffs.shape[1]))
    cfg = T.Config(target_error=1e-4, continuity=False, max_depth=depth,
                   max_degree=2)
    return T.from_numpy(dict(child_idx=child, centre=centre, depth=dep,
                             degree=degree, coeffs=coeffs), N, 2, depth, cfg,
                        device=device)


def node_points(n, seed, device):
    """bench.py:684's points: n uniform in the root, f64."""
    return torch.as_tensor(np.random.default_rng(seed).uniform(
        -0.5, 0.5, (n, 3)), device=device)


def bucket_records(sort):
    """A node-range sort's listed points (``node_buckets_kernel``'s or
    ``node_buckets_plain``'s (offsets, items)) in one order: each place's
    run (segment-major: segment g, tile t is run g n_tiles + t) and its
    item (point index, row within the tile), sorted by run and index; None
    where the runs are not all of size zero or more and within their
    segments."""
    from hpsdf_tpu_torch.query import NODE_SORT_POINTS

    offsets, items = sort
    o = offsets.long().T                            # (n_tiles + 1, G)
    n_tiles, G = o.shape[0] - 1, o.shape[1]
    runs = (o[1:] - o[:-1]).T.flatten()            # segment-major
    if bool((runs < 0).any()) or bool((o[0] != 0).any()) \
            or bool((o[-1] > NODE_SORT_POINTS).any()):
        return None
    first = (torch.arange(G, device=o.device)[:, None] * NODE_SORT_POINTS
             + o[:-1].T).flatten()
    run = torch.repeat_interleave(torch.arange(
        runs.numel(), device=o.device), runs)
    pos = first[run] + torch.arange(run.numel(), device=o.device) \
        - (torch.cumsum(runs, 0) - runs)[run]
    it = items[pos].long()
    order = torch.sort(run * (items.shape[0] + 1) + it[:, 0]).indices
    return run[order], it[order]


def buckets_match(kernel, plain):
    """The kernel's node-range sort against ``node_buckets_plain``'s: the
    same offsets, and each run the same points, each with the same row
    within its tile, in any order within the run."""
    if not torch.equal(kernel[0].cpu(), plain[0].cpu()):
        return False
    got, want = bucket_records(kernel), bucket_records(plain)
    return got is not None and all(torch.equal(a.cpu(), b.cpu())
                                   for a, b in zip(got, want))


def k8n_teeth(got, want, block, pts, leaf, w, tile_rows):
    """K8's node-range check against two wrong results made from the
    kernel's own: the sums of the tile that holds the largest entry dropped,
    and the largest term of the point with the largest |w| among those the
    block holds counted twice. Returns whether each was caught (its error
    beyond GRAD_RTOL64)."""
    from hpsdf_tpu_torch.query import coeff_scatter_nodes_plain

    dropped = got.clone()
    row = int(want.abs().amax(1).argmax())
    t0 = row // tile_rows * tile_rows
    dropped[t0: t0 + tile_rows] = 0.0
    n = leaf.long() - block.lo
    held = (n >= 0) & (n < block.hi - block.lo)
    p = int(torch.where(held, w.abs(), -1.0).argmax())
    one = coeff_scatter_nodes_plain(block, pts[p: p + 1], leaf[p: p + 1],
                                    w[p: p + 1])
    r, m = divmod(int(one.abs().argmax()), one.shape[1])
    doubled = got.clone()
    doubled[r, m] += one[r, m]
    return [rel_err(x, want) > GRAD_RTOL64 for x in (dropped, doubled)]


def coeff_scatter_nodes_reference(block, pts, leaf, w,
                                  outside_value_max=False):
    """K8's node-range mode as it was before its redesign
    (csrc/check/coeff_scatter_nodes_reference.cu), called as its wrapper
    called it: the (hi - lo, C) output zeroed, then one launch."""
    from hpsdf_tpu_torch import _kernels, consts

    out = torch.zeros((block.hi - block.lo, consts.coeff_count(
        block.deg_used)), dtype=torch.float64, device=pts.device)
    if pts.shape[0] == 0 or block.hi <= block.lo:
        return out
    rc = block.config.root_centre
    inv = 1.0 / block.config.root_sizes
    rc_ = _kernels.load_check().hpsdf_coeff_scatter_nodes_reference(
        block.centre.data_ptr(), block.depth.data_ptr(), block.deg_used,
        block.lo, block.hi, pts.data_ptr(), leaf.data_ptr(), pts.shape[0],
        *map(float, rc), *map(float, inv), w.data_ptr(),
        int(outside_value_max), out.data_ptr(), _kernels.stream_of(pts))
    _kernels.check(_kernels.load(), rc_, "coeff_scatter_nodes_reference")
    return out


def k8n_shape(block, pts, leaf, w, label):
    """K8's node-range mode at one block: the kernel and the one it replaced
    (``coeff_scatter_nodes_reference``) in CUDA graphs in turns, the sort
    alone, the plain versions by events, and the bound on
    the bytes these points need (a point whose leaf lies in another block
    its leaf, 4 B; one the block holds its cotangent too and, where that is
    not zero, its coordinates: 12 or 36 B; the block's distinct leaves'
    depth and centre, 28 B; its rows written) or the live points' f64
    operations, the larger."""
    from hpsdf_tpu_torch import consts
    from hpsdf_tpu_torch.query import (NODE_SORT_POINTS,
                                       coeff_scatter_nodes_kernel,
                                       coeff_scatter_nodes_plain,
                                       node_buckets_kernel,
                                       node_buckets_plain, node_tile_rows)

    rows = block.hi - block.lo
    n = leaf.long() - block.lo
    held = (n >= 0) & (n < rows)
    live = held & (w != 0)
    T = node_tile_rows(block.deg_used, rows)
    t = turns({"ms": lambda: coeff_scatter_nodes_kernel(block, pts, leaf, w),
               "replaced_ms": lambda: coeff_scatter_nodes_reference(
                   block, pts, leaf, w)}, 10)
    t["buckets_ms"] = graph_ms(lambda: node_buckets_kernel(
        block, pts, leaf, w), 10)
    t["plain_ms"] = time_ms(lambda: coeff_scatter_nodes_plain(
        block, pts, leaf, w), 3)
    t["buckets_plain_ms"] = time_ms(lambda: node_buckets_plain(
        block, pts, leaf, w), 3)
    # the sort's bytes: each point's leaf and cotangent read, each live
    # point's (index, row) written, an offset a tile and segment
    b_bytes = pts.shape[0] * 12 + int(live.sum()) * 8 + 4 * (
        -(-rows // T) + 1) * -(-pts.shape[0] // NODE_SORT_POINTS)
    t["buckets_bound_ms"] = bytes_ms(extra=b_bytes)
    leaves = torch.unique(leaf[held]).numel()
    nbytes = pts.shape[0] * 4 + int(held.sum()) * 8 + int(live.sum()) * 24 \
        + leaves * 28 + rows * 8 * consts.coeff_count(block.deg_used)
    ops = int(live.sum()) * k1_ops(block.deg_used, 0, False) / F64_PEAK * 1e3
    t.update(label=label, tile_rows=T, points=pts.shape[0],
             live=int(live.sum()), rows=rows, leaves=leaves, bytes=nbytes,
             bytes_bound_ms=bytes_ms(extra=nbytes), ops_bound_ms=ops,
             bound_ms=max(bytes_ms(extra=nbytes), ops),
             bound_by="bytes" if bytes_ms(extra=nbytes) >= ops
             else "operations")
    t["share"] = t["bound_ms"] / t["ms"]
    t["replaced_share"] = t["bound_ms"] / t["replaced_ms"]
    return t


def phase_node_modes(dev, smi, slice_tree, seed=NODE_SEED):
    """K1's and K8's node-range modes in one process, no collective, on the
    complete depth-NODE_DEPTH tree at 2^20 points: the tree split into 1, 2
    and 3 blocks (NODE_SPLITS), each block's descent rounds and leaf
    evaluation against their plain versions (the rounds exactly, the values
    within K1_VAL_ATOL) and summed, the leaves equal to the plain descent's,
    the values within K1_VAL_ATOL of K1's query (whether bit for bit is
    recorded); K8's mode on each block against its plain version and PR
    16's kernel (``coeff_scatter_nodes_reference``) and, the blocks
    concatenated, K8's query form within GRAD_RTOL64; its sort against
    ``node_buckets_plain`` run by run (``buckets_match``), and two wrong
    results caught (``k8n_teeth``). At 2 blocks also with the sentinel on
    points straddling the root, and in tiles of two rows; at the train
    step's shape with and without the sentinel, its two wrong results
    caught. The tile rows
    the wrapper gives each degree and its points a sort block equal the
    kernel's (``node_tile_rows``, ``hpsdf_node_tile_rows``,
    ``NODE_SORT_POINTS``). Then at one block, in CUDA graphs,
    each descent round, the leaf evaluation and K8's mode, beside K1's
    query and K8's query form on the same tree and points, the plain
    versions (by events) and the bounds; K8's mode beside the kernel it
    replaced at
    five shapes (``k8n_shape``): one block, rank 0's of 2 and of 3 blocks,
    and the train step's (rank 0's half of ``slice_tree`` at
    NODE_STEP_POINTS points in [-0.4, 0.4]^3), and at one block and
    NODE_MANY_POINTS points, there held to the kernel it replaced. Prints
    two lines; returns the numbers. Its launches are not main-path
    launches."""
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.query import (
        OUTSIDE_VALUE, _coeff_scatter_nodes, _node_buckets,
        _node_buckets_plain, _to_unit, coeff_scatter_kernel,
        coeff_scatter_nodes_kernel, coeff_scatter_nodes_plain, descend,
        descend_round_plain, leaf_eval_plain, node_buckets_kernel,
        node_buckets_plain, node_tile_rows, query_kernel,
        query_nodes_kernel)

    counts = read_counts()
    tree = complete_tree(NODE_DEPTH, seed, dev)
    pts = node_points(N_QUERY, seed, dev)
    unit = _to_unit(tree, pts)
    inside = torch.all(unit.abs() <= 0.5, dim=-1)
    clamped = unit.clamp(-0.5, 0.5)
    leaves = descend(tree, clamped)
    k1 = query_kernel(tree, pts, False)
    w = torch.randn(N_QUERY, generator=torch.Generator(device=dev)
                    .manual_seed(seed), dtype=torch.float64, device=dev)
    k8 = coeff_scatter_kernel(tree, w, pts=pts)
    from hpsdf_tpu_torch import _kernels
    from hpsdf_tpu_torch.query import NODE_SORT_POINTS
    lib = _kernels.load()
    rows_c = [lib.hpsdf_node_tile_rows(d) for d in range(13)]
    check(rows_c == [node_tile_rows(d) for d in range(13)]
          and lib.hpsdf_node_sort_points() == NODE_SORT_POINTS, f"K8's "
          f"node-range shapes: the kernel's tile rows by degree {rows_c} and "
          f"{lib.hpsdf_node_sort_points()} points a sort block, the "
          f"wrapper's {[node_tile_rows(d) for d in range(13)]} and "
          f"{NODE_SORT_POINTS}")
    errs = {"round": 0.0, "leaf": 0.0, "k1": 0.0, "k8": 0.0, "k8 query": 0.0,
            "k8 abs": 0.0, "k8 replaced": 0.0}
    bit_for_bit, teeth, buckets = {}, [], 0
    for k in NODE_SPLITS:
        blocks = [P.node_block(tree, k, r) for r in range(k)]
        cur = torch.zeros(N_QUERY, dtype=torch.int32, device=dev)
        for _ in range(tree.depth_used):
            outs = [query_nodes_kernel(b, clamped, cur) for b in blocks]
            for b, o in zip(blocks, outs):
                check(torch.equal(o, descend_round_plain(b, clamped, cur)),
                      f"K1's node-range round against plain, {k} blocks")
            cur = torch.stack(outs).sum(0, dtype=torch.int32)
        check(torch.equal(cur, leaves), f"the node-range descent's leaves "
              f"against the plain descent, {k} blocks")
        vals = [query_nodes_kernel(b, clamped, cur, leaf=True)
                for b in blocks]
        for b, v in zip(blocks, vals):
            e = float((v - leaf_eval_plain(b, clamped, cur)).abs().max())
            errs["leaf"] = max(errs["leaf"], e)
            check(e <= K1_VAL_ATOL, f"K1's node-range leaf evaluation "
                  f"against plain, {k} blocks: {e}")
        v = torch.where(inside, torch.stack(vals).sum(0), OUTSIDE_VALUE)
        e = float((v - k1).abs().max())
        errs["k1"] = max(errs["k1"], e)
        bit_for_bit[k] = bool(torch.equal(v, k1))
        check(e <= K1_VAL_ATOL, f"the node-range query against K1, {k} "
              f"blocks: {e}")
        grads = [coeff_scatter_nodes_kernel(b, pts, cur, w) for b in blocks]
        for r, (b, g) in enumerate(zip(blocks, grads)):
            want = coeff_scatter_nodes_plain(b, pts, cur, w)
            e = rel_err(g, want)
            errs["k8"] = max(errs["k8"], e)
            check(e <= GRAD_RTOL64, f"K8's node-range mode against plain, "
                  f"{k} blocks: {e}")
            e = rel_err(g, coeff_scatter_nodes_reference(b, pts, cur, w))
            errs["k8 replaced"] = max(errs["k8 replaced"], e)
            check(e <= GRAD_RTOL64, f"K8's node-range mode against the "
                  f"kernel it replaced, {k} blocks: {e}")
            check(buckets_match(node_buckets_kernel(b, pts, cur, w),
                                node_buckets_plain(b, pts, cur, w)),
                  f"K8's node-range sort against plain, {k} blocks, "
                  f"block {r}")
            buckets += 1
            caught = k8n_teeth(g, want, b, pts, cur, w, node_tile_rows(
                b.deg_used, b.hi - b.lo))
            teeth.append(caught)
            check(all(caught), f"K8's node-range check against a tile "
                  f"dropped and a term doubled, {k} blocks: {caught}")
        g = torch.cat(grads)
        errs["k8 query"] = max(errs["k8 query"], rel_err(g, k8))
        errs["k8 abs"] = max(errs["k8 abs"], float((g - k8).abs().max()))
        check(errs["k8 query"] <= GRAD_RTOL64, f"K8's node-range mode "
              f"against its query form, {k} blocks: {errs['k8 query']}")
        del blocks, vals, grads, g

    # at 2 blocks: the sentinel on points straddling the root, and tiles
    # of two rows (a tile's count past a sort block's shared window)
    wide = pts * 1.25
    wide_leaves = descend(tree, _to_unit(tree, wide).clamp(-0.5, 0.5))
    variants = 0
    for b in (P.node_block(tree, 2, r) for r in range(2)):
        for p_, lv, ovm, T_ in ((wide, wide_leaves, True,
                                 node_tile_rows(b.deg_used, b.hi - b.lo)),
                                (pts, leaves, False, 2)):
            want = coeff_scatter_nodes_plain(b, p_, lv, w, ovm)
            e = rel_err(_coeff_scatter_nodes(b, p_, lv, w, ovm, T_),
                        want)
            errs["k8"] = max(errs["k8"], e)
            check(e <= GRAD_RTOL64, f"K8's node-range mode against plain, "
                  f"2 blocks, sentinel {ovm}, tiles of {T_} rows: {e}")
            check(buckets_match(
                _node_buckets(b, p_, lv, w, ovm, T_),
                _node_buckets_plain(b, p_, lv, w, ovm, T_)),
                f"K8's node-range sort against plain, 2 blocks, sentinel "
                f"{ovm}, tiles of {T_} rows")
            variants += 1
    del wide, wide_leaves

    # times at one block: the whole tree in the node-range modes
    blk = P.node_block(tree, 1, 0)
    curs = [torch.zeros(N_QUERY, dtype=torch.int32, device=dev)]
    for _ in range(tree.depth_used):
        curs.append(query_nodes_kernel(blk, clamped, curs[-1]))
    rounds = [graph_ms(lambda c=c: query_nodes_kernel(blk, clamped, c), 20)
              for c in curs[:-1]]
    leaf_ms = graph_ms(lambda: query_nodes_kernel(blk, clamped, leaves,
                                                  leaf=True), 20)
    t = {"rounds_ms": rounds, "leaf_ms": leaf_ms,
         "ms": sum(rounds) + leaf_ms,
         "k1_ms": graph_ms(lambda: query_kernel(tree, pts, False), 20),
         "k8_query_ms": graph_ms(lambda: coeff_scatter_kernel(
             tree, w, pts=pts), 10)}

    def plain_query():
        c = curs[0]
        for _ in range(tree.depth_used):
            c = descend_round_plain(blk, clamped, c)
        return leaf_eval_plain(blk, clamped, c)

    t["plain_ms"] = time_ms(plain_query, 3)
    # K8's mode at five shapes
    shapes = {"one block": k8n_shape(blk, pts, leaves, w, "one block")}
    for k in (2, 3):
        shapes[f"rank 0 of {k}"] = k8n_shape(P.node_block(tree, k, 0), pts,
                                             leaves, w, f"rank 0 of {k}")
    spts = torch.as_tensor(np.random.default_rng(43).uniform(
        -0.4, 0.4, (NODE_STEP_POINTS, 3)), device=dev)
    sleaves = descend(slice_tree, _to_unit(slice_tree, spts).clamp(-0.5, 0.5))
    sw = torch.randn(NODE_STEP_POINTS, generator=torch.Generator(
        device=dev).manual_seed(seed + 1), dtype=torch.float64, device=dev)
    sblk = P.node_block(slice_tree, 2, 0)
    # there with and without the sentinel on points straddling the root,
    # and the wrong results
    swide = spts * 1.6
    swide_leaves = descend(slice_tree,
                           _to_unit(slice_tree, swide).clamp(-0.5, 0.5))
    for p_, lv, ovm in ((spts, sleaves, False), (swide, swide_leaves, True)):
        want = coeff_scatter_nodes_plain(sblk, p_, lv, sw, ovm)
        got = coeff_scatter_nodes_kernel(sblk, p_, lv, sw, ovm)
        e = rel_err(got, want)
        errs["k8"] = max(errs["k8"], e)
        check(e <= GRAD_RTOL64, f"K8's node-range mode against plain at the "
              f"train step's shape, sentinel {ovm}: {e}")
        caught = k8n_teeth(got, want, sblk, p_, lv, sw, node_tile_rows(
            sblk.deg_used, sblk.hi - sblk.lo))
        teeth.append(caught)
        check(all(caught), f"K8's node-range check against a tile dropped "
              f"and a term doubled at the train step's shape: {caught}")
    shapes["train step"] = k8n_shape(sblk, spts, sleaves, sw, "train step")
    # one block at NODE_MANY_POINTS points: the sort's runs read in two
    # windows of segments a tile, held to the kernel it replaced
    del sw, spts, sleaves
    mpts = node_points(NODE_MANY_POINTS, seed + 2, dev)
    mleaves = descend(tree, _to_unit(tree, mpts).clamp(-0.5, 0.5))
    mw = torch.randn(NODE_MANY_POINTS, generator=torch.Generator(
        device=dev).manual_seed(seed + 2), dtype=torch.float64, device=dev)
    e = rel_err(coeff_scatter_nodes_kernel(blk, mpts, mleaves, mw),
                coeff_scatter_nodes_reference(blk, mpts, mleaves, mw))
    errs["k8 replaced"] = max(errs["k8 replaced"], e)
    check(e <= GRAD_RTOL64, f"K8's node-range mode against the kernel it "
          f"replaced at one block and {NODE_MANY_POINTS} points: {e}")
    shapes["many points"] = k8n_shape(blk, mpts, mleaves, mw, "many points")
    del mpts, mleaves, mw
    one = shapes["one block"]
    step = shapes["train step"]
    # the aim at the train step's shape: no slower than the kernel it
    # replaced, by at most 5% or 1 us (recorded, not a check)
    step["no_slower"] = step["ms"] <= step["replaced_ms"] + max(
        0.05 * step["replaced_ms"], 0.001)
    # bounds: each input read once, each output written once, of what these
    # points need: the points (24 B), the indices in and out (4 + 4 B), the
    # rows of the distinct nodes a round reads (child_idx and centre, 28 B);
    # the leaf evaluation's points, leaves and values (24 + 4 + 8 B) and its
    # distinct leaves' rows (depth, centre, coefficients), with K1's f64
    # operations less the descent; K8's as k8n_shape
    C = tree.coeffs.shape[1]
    n_leaves = torch.unique(leaves).numel()
    round_bytes = [N_QUERY * 32 + 28 * torch.unique(c).numel()
                   for c in curs[:-1]]
    leaf_bytes = N_QUERY * 36 + n_leaves * (4 + 24 + 8 * C)
    leaf_ops = N_QUERY * k1_ops(tree.deg_used, 0, False) / F64_PEAK * 1e3
    rounds_bound = sum(bytes_ms(extra=b) for b in round_bytes)
    leaf_bound = max(bytes_ms(extra=leaf_bytes), leaf_ops)
    t.update(rounds_bound_ms=rounds_bound, leaf_bound_ms=leaf_bound,
             bound_ms=rounds_bound + leaf_bound,
             bound_by="bytes" if bytes_ms(extra=leaf_bytes) >= leaf_ops
             else "operations",
             k8_ms=one["ms"], k8_plain_ms=one["plain_ms"],
             k8_bound_ms=one["bound_ms"], k8_bound_by=one["bound_by"],
             k8_replaced_ms=one["replaced_ms"], k8_shapes=shapes,
             k8_teeth=teeth,
             k8_buckets_checked=buckets, k8_variants_checked=variants,
             k8_tile_rows={k: v["tile_rows"] for k, v in shapes.items()},
             errs=errs, bit_for_bit=bit_for_bit, rows=tree.n_nodes,
             leaves=n_leaves, node_bytes=sum(
                 getattr(tree, k).nbytes for k in P._ARRAYS))
    for name, (fn, attr) in counters().items():   # not main-path launches
        setattr(fn, attr, counts[name])
    print(f"[sharding] node-range modes, one rank, no collective: {smi} | "
          f"the complete depth-{NODE_DEPTH} tree ({tree.n_nodes} rows, "
          f"{t['node_bytes']} B) at {N_QUERY} points, split into "
          f"{NODE_SPLITS} blocks: rounds equal plain's, leaves equal the "
          f"plain descent's; leaf evaluation against plain {errs['leaf']:.2e}"
          f", the summed query against K1 {errs['k1']:.2e} (bit for bit: "
          f"{bit_for_bit}); K8's mode against plain {errs['k8']:.2e}, the "
          f"kernel it replaced {errs['k8 replaced']:.2e}, concatenated "
          f"against its "
          f"query form {errs['k8 query']:.2e} (relative); its sort "
          f"equal to plain's run by run on {buckets} blocks and "
          f"{variants} variants (sentinel, tiles of 2 rows); a tile dropped "
          f"and a "
          f"term doubled caught {teeth} | in CUDA graphs at one block: "
          f"rounds {[round(r, 4) for r in rounds]} ms (bound "
          f"{rounds_bound:.4f}), leaf {leaf_ms:.4f} ms (bound "
          f"{leaf_bound:.4f}), a query's launches {t['ms']:.4f} ms (bound "
          f"{t['bound_ms']:.4f}) against K1's {t['k1_ms']:.4f}; K8's query "
          f"form {t['k8_query_ms']:.4f} | plain: query {t['plain_ms']:.3f} "
          f"ms", flush=True)
    print(f"[sharding] K8's node-range mode beside the kernel it replaced, "
          f"CUDA graphs in turns: {smi} | "
          + " | ".join(
              f"{k} ({v['rows']} rows in tiles of "
              f"{t['k8_tile_rows'][k]}, {v['points']} points, {v['live']} "
              f"live): {v['ms']:.4f} ms (sort alone "
              f"{v['buckets_ms']:.4f}), replaced {v['replaced_ms']:.4f}; "
              f"bound "
              f"{v['bound_ms']:.4f} ({v['bound_by']}), {v['share']:.1%} "
              f"(replaced {v['replaced_share']:.1%}); plain "
              f"{v['plain_ms']:.3f}"
              for k, v in shapes.items())
          + f" | the train step no slower than the kernel it replaced (by "
          f"at most 5% or 1 us): {step['no_slower']}", flush=True)
    return t


@contextlib.contextmanager
def collectives(axes):
    """Every all_reduce and all-gather of hpsdf_tpu_torch.parallel made
    while the block runs, as (axis, elements), the axis the name under which
    ``axes`` holds the group it ran on ("other" for any other group)."""
    from hpsdf_tpu_torch import parallel as P

    seen, real = [], {k: getattr(P.dist, k)
                      for k in ("all_reduce", "all_gather_into_tensor")}

    def counted(name):
        def call(*args, group=None, **kw):
            x = args[1] if name == "all_gather_into_tensor" else args[0]
            seen.append((next((a for a, g in axes.items() if g is group),
                              "other"), x.numel()))
            return real[name](*args, group=group, **kw)
        return call

    for name in real:
        setattr(P.dist, name, counted(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(P.dist, name, fn)


def shard_grads(tree, pts, rays, mesh, nmesh=None, seed=0):
    """The sharded reads' gradients on CUDA tensors, every rank taking the
    same loss of the gathered result (seeded weights, the sentinel
    masked): shard_query's to the coefficients and centres, and to the
    centres alone, on the batch axis of ``mesh``; with ``nmesh`` the same
    on its node axis (the whole tree sliced into blocks, and this rank's
    block, which gets its rows), else K1c on NODE_SPLITS node blocks in
    one process, concatenated; shard_trace's to the coefficients on the
    batch axis (``rays`` = (origins, dirs, trace keywords)). Each is held
    to the one-device gradient (``query`` and ``trace`` on the same
    inputs) within GRAD2_RTOL64 (the f32 trace GRAD2_RTOL32), not zero,
    and each backward makes exactly one all-reduce over the batch axis a
    replicated array and one all-gather over the node axis an array sliced
    from the whole tree. Returns {case: {"rel_err", "bit_for_bit",
    "collectives"}}."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.query import (OUTSIDE_VALUE, query_kernel,
                                       query_vjp_kernel)

    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.standard_normal(pts.shape[0]), device=pts.device)
    o, d, kw = rays
    wt = torch.as_tensor(rng.standard_normal(o.shape[0]),
                         dtype=torch.float32, device=o.device)

    def q_loss(v):
        return (w * torch.where(v == OUTSIDE_VALUE, 0.0, v)).sum()

    def t_loss(res):
        return (wt * torch.where(res.hit, res.t, 0.0)).sum()

    def grads(fn, tr, keys, axes=None):
        xs = {k: getattr(tr, k).detach().clone().requires_grad_(True)
              for k in keys}
        loss = fn(dataclasses.replace(tr, **xs))
        with collectives(axes or {}) as seen:
            g = torch.autograd.grad(loss, list(xs.values()))
        return dict(zip(keys, g)), seen

    out = {}

    def record(name, got, want, tol, seen=None, calls=None):
        errs = {k: rel_err(got[k], want[k]) for k in got}
        check(max(errs.values()) <= tol
              and all(bool(g.abs().max() > 0) for g in got.values()),
              f"{name}: the sharded gradients vs one device's {errs}")
        if calls is not None:
            check(sorted(seen) == sorted(calls), f"{name}: the backward's "
                  f"collectives {seen}, not {calls}")
        out[name] = {"rel_err": errs, "bit_for_bit": all(
            torch.equal(got[k], want[k]) for k in got), "collectives": seen}

    both = ("coeffs", "centre")
    one, _ = grads(lambda t: q_loss(T.query(t, pts)), tree, both)
    sh = P.batch_shard(mesh)
    for keys in (both, ("centre",)):
        got, seen = grads(lambda t: q_loss(P.shard_query(t, pts, mesh)),
                          tree, keys, {"batch": sh.group})
        record(f"batch {'+'.join(keys)}", got, one, GRAD2_RTOL64, seen,
               [("batch", getattr(tree, k).numel()) for k in keys])
    if nmesh is not None:
        nsh = P.batch_shard(nmesh)
        nd = P.node_shard(nmesh, tree.child_idx.shape[0])
        axes = {"batch": nsh.group, "node": nd.group}
        per = -(-tree.child_idx.shape[0] // nd.size)
        width = {k: getattr(tree, k).shape[1] for k in both}
        for keys in (both, ("centre",)):
            got, seen = grads(lambda t: q_loss(P.shard_query(
                t, pts, nmesh, shard_nodes=True)), tree, keys, axes)
            record(f"node {'+'.join(keys)}", got, one, GRAD2_RTOL64, seen,
                   [("batch", (nd.hi - nd.lo) * width[k]) for k in keys]
                   + [("node", per * width[k]) for k in keys])
        block = P._shard_tree(tree, nmesh, True)
        got, seen = grads(lambda t: q_loss(P.shard_query(
            t, pts, nmesh, shard_nodes=True)), block, both, axes)
        record("node block", got, {k: one[k][nd.lo:nd.hi] for k in both},
               GRAD2_RTOL64, seen,
               [("batch", (nd.hi - nd.lo) * width[k]) for k in both])
    else:
        _, leaf = query_kernel(tree, pts, False, with_leaf=True)
        whole = query_vjp_kernel(tree, pts, leaf, w, points=False,
                                 centre=True)
        for n in NODE_SPLITS[1:]:
            cat = torch.cat([query_vjp_kernel(
                P.node_block(tree, n, k), pts, leaf, w, points=False,
                centre=True) for k in range(n)])
            record(f"K1c on {n} blocks", {"centre": cat},
                   {"centre": whole}, GRAD2_RTOL64)
    one_t, _ = grads(lambda t: t_loss(T.trace(t, o, d, **kw)), tree,
                     ("coeffs",))
    for packed in (False, True):
        extra = {"packed": T.pack_tree(tree)} if packed else {}
        got, seen = grads(lambda t: t_loss(P.shard_trace(
            t, o, d, mesh, **kw, **extra)), tree, ("coeffs",),
            {"batch": sh.group})
        record("trace" + (" packed" if packed else ""), got, one_t,
               GRAD2_RTOL32, seen, [("batch", tree.coeffs.numel())])
    return out


def grads_text(g):
    """shard_grads' result, a case a clause."""
    return "; ".join(f"{k} " + ", ".join(f"{a} {e:.2e}" for a, e in
                                          v["rel_err"].items())
                     + (" (bit for bit)" if v["bit_for_bit"] else "")
                     + ("" if v["collectives"] is None
                        else f", collectives {v['collectives']}")
                     for k, v in g.items())


def sharding_rank(rank, size, port, cfg, tree_path, out_path):
    """One of ``size`` gloo ranks on the one card (NCCL refuses two ranks on
    one device), at SHARD_SMALL's sizes: shard_query and shard_trace (K4 +
    K3) on the slice tree bit for bit against query and trace;
    build(fit_mesh=) at fit + continuity's config bit for bit against the
    one-device build; enforce_continuity(mesh=) within SHARD_CG_RTOL /
    SHARD_CG_ATOL of the one-device solve and its count within one; K9's
    partial mode and K9u's two launches against their plain versions on the
    rank's real block; fit_to_depth(mesh=) at SHARD_SMALL's inverse side,
    losses within SHARD_INV_RTOL; then on make_mesh(node_parallel=size),
    the node-sharded shard_query of the complete depth-NODE_DEPTH tree at
    2^20 points within K1_VAL_ATOL of query, its collectives
    (depth_used + 1 over the node axis, each of the points' size, and the
    batch axis's all-gather) and each rank's rows, and two node-sharded
    train steps on the slice tree (the loss falling, the first within
    1e-10 of the one-device step's, the coefficients within
    NODE_STEP_ATOL), with the counts read after them; the host ms of a
    node-sharded query beside the batch axis's. Rank 0 writes what it saw
    to out_path."""
    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import continuity as TC
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.inverse import fit_to_depth

    dev = torch.device("cuda", 0)
    P.init_distributed(f"localhost:{port}", size, rank, backend="gloo",
                       device=dev)
    dmesh = P.make_mesh(device=dev)
    tree = T.load(tree_path, device=dev)
    reset_counts()
    pts = torch.as_tensor(np.random.default_rng(41).uniform(
        -0.4, 0.4, (SHARD_SMALL["points"], 3)), device=dev)
    check(torch.equal(P.shard_query(tree, pts, dmesh), T.query(tree, pts)),
          f"{size} gloo ranks: shard_query against query")
    side = SHARD_SMALL["side"]
    o, d = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=side,
                         height=side, device=dev)
    kw = dict(t_max=T_MAX, cone_tiles=(side, side, SHARD_TILE))
    a, b = P.shard_trace(tree, o, d, dmesh, **kw), T.trace(tree, o, d, **kw)
    check(torch.equal(a.t, b.t) and torch.equal(a.hit, b.hit),
          f"{size} gloo ranks: shard_trace against trace")

    fit_cfg = T.Config(**{**CONT_FIT, "continuity": False})

    def sphere(p):
        return torch.linalg.norm(p, dim=-1) - CONT_FIT_RADII[1]

    fit_sh = T.build_octree(fit_cfg, sphere, fit_mesh=dmesh, device=dev)
    fit_one = T.build_octree(fit_cfg, sphere, device=dev)
    check(torch.equal(fit_sh.child_idx, fit_one.child_idx)
          and torch.equal(fit_sh.coeffs, fit_one.coeffs),
          f"{size} gloo ranks: build(fit_mesh=) against one device")
    with record_calls(TC, "cg_solve_rows") as rows, \
            record_calls(TC, "cg_solve") as one:
        cont_sh = TC.enforce_continuity(fit_one, mesh=dmesh)
        cont_one = TC.enforce_continuity(fit_one)
    excess, cg_err = cg_close(cont_sh.coeffs, cont_one.coeffs)
    iters = (rows[0][1], one[0][1])
    check(excess <= 0 and abs(iters[0] - iters[1]) <= 1,
          f"{size} gloo ranks: row-sharded CG against one device: "
          f"max|diff| {cg_err}, iterations {iters}")
    _, blk, minv = row_block_of(fit_one, CONT_FIT["continuity_strength"],
                                size, rank)
    errs, abs_errs, _ = check_row_modes(blk, CONT_FIT["continuity_strength"],
                                        minv, f"{size} gloo ranks, rank "
                                        f"{rank}")

    (si,) = inverse_setup(cfg, dev, [(SHARD_SMALL["inverse"],) * 2])
    args = (si["init"], si["o"], si["d"], si["t_star"], si["hit_star"])
    l_sh = fit_to_depth(*args, n_steps=SHARD_INV_STEPS, t_max=T_MAX,
                        mesh=dmesh).losses.cpu()
    l_one = fit_to_depth(*args, n_steps=SHARD_INV_STEPS,
                         t_max=T_MAX).losses.cpu()
    inv_rel = float(((l_sh - l_one) / l_one).abs().max())
    check(inv_rel <= SHARD_INV_RTOL, f"{size} gloo ranks: fit_to_depth "
          f"losses {l_sh.tolist()} against {l_one.tolist()}")
    # the node axis, on a (1, size) mesh: the complete tree's rows split
    nmesh = P.make_mesh(node_parallel=size, device=dev)
    big = complete_tree(NODE_DEPTH, NODE_SEED, dev)
    bpts = node_points(N_QUERY, NODE_SEED, dev)
    q_one = T.query(big, bpts)
    block = P._shard_tree(big, nmesh, True)
    nd = P.node_shard(nmesh, block.n_rows)
    with collectives({"node": nd.group,
                      "batch": P.batch_shard(nmesh).group}) as seen:
        q_node = P.shard_query(block, bpts, nmesh, shard_nodes=True)
    node_err = float((q_node - q_one).abs().max())
    check(node_err <= K1_VAL_ATOL, f"{size} gloo ranks: the node-sharded "
          f"shard_query against query: {node_err}")
    want = [("node", N_QUERY)] * (big.depth_used + 1) + [("batch", N_QUERY)]
    check(seen == want, f"{size} gloo ranks: the node-sharded query's "
          f"collectives {seen}, not {want}")
    whole_bytes = sum(getattr(big, k).nbytes for k in P._ARRAYS)
    check(block.hi - block.lo <= -(-block.n_rows // size), f"{size} gloo "
          f"ranks: rank {rank} holds {block.hi - block.lo} rows")
    g = torch.Generator().manual_seed(NODE_SEED)
    noisy = dataclasses.replace(tree, coeffs=tree.coeffs + 1e-3 * torch.randn(
        tree.coeffs.shape, generator=g, dtype=torch.float64).to(dev))
    tpts = torch.as_tensor(np.random.default_rng(43).uniform(
        -0.4, 0.4, (NODE_STEP_POINTS, 3)), device=dev)
    target = torch.linalg.norm(tpts, dim=-1) - 0.3
    step = P.make_sharded_train_step(nmesh, noisy)
    t1, l1 = step(noisy, tpts, target, lr=NODE_STEP_LR)
    t2, l2 = step(t1, tpts, target, lr=NODE_STEP_LR)
    t_one, l_step = P.train_step(noisy, tpts, target, NODE_STEP_LR)
    step_err = float((P.gather_tree(t1, nmesh).coeffs
                      - t_one.coeffs).abs().max())
    losses = [float(l1), float(l2), float(l_step)]
    check(isinstance(t2, P.ShardedTree) and losses[1] < losses[0]
          and abs(losses[0] - losses[2]) <= 1e-10 * abs(losses[2])
          and step_err <= NODE_STEP_ATOL, f"{size} gloo ranks: node-sharded "
          f"train steps: losses {losses} (the last one device's), "
          f"max|coeffs - one device's| {step_err}")
    launches = read_counts()
    gpts = torch.as_tensor(root_points(*tree.root_aabb, SHARD_SMALL[
        "points"], 44, pad=0.05), device=dev)
    grads = shard_grads(tree, gpts, (o, d, kw), dmesh, nmesh, seed=45)
    for k in ("cg_matvec_rows", "cg_update_rows", "cg_direction",
              "query_nodes", "coeff_scatter_nodes", "node_buckets"):
        check(launches[k] > 0, f"{size} gloo ranks: {k} never launched")
    # host ms a call, outside the count: the node-sharded query beside the
    # batch axis's on the whole tree
    node_ms = wall_ms(lambda: P.shard_query(block, bpts, nmesh,
                                            shard_nodes=True), 5)
    batch_ms = wall_ms(lambda: P.shard_query(big, bpts, dmesh), 5)
    if rank == 0:
        with open(out_path, "w") as fh:
            json.dump({"ranks": size, "backend": P.dist.get_backend(),
                       "block_rows": blk.rows, "block_leaves":
                       int(blk.op.leaves.shape[0]), "cg_max_abs_diff": cg_err,
                       "cg_iterations": iters, "inverse_losses":
                       l_sh.tolist(), "inverse_one_device": l_one.tolist(),
                       "inverse_rel_err": inv_rel, "errs": errs,
                       "abs_errs": abs_errs, "launches": launches,
                       "grads": grads,
                       "node": {
                           "rows": block.hi - block.lo,
                           "tree_rows": block.n_rows,
                           "bytes": block.nbytes,
                           "replicated_bytes": whole_bytes,
                           "max_abs_err": node_err,
                           "bit_for_bit": bool(torch.equal(q_node, q_one)),
                           "collectives": seen,
                           "shard_query_ms": node_ms,
                           "batch_shard_query_ms": batch_ms,
                           "step_losses": losses,
                           "step_max_abs_diff": step_err}}, fh)
    P.dist.destroy_process_group()


def row_mode_times(fitted, shard, label, persistent_ms, smi):
    """At one rank on a fitted tree's face operator: K9's partial mode and
    K9u's two launches against their plain versions (``check_row_modes``),
    the partial mode against K9 bit for bit, K9u's two launches against
    the ones they replaced from a live state (``rows_pair_checks``); their
    times in CUDA graphs beside their bounds and the plain versions'; an
    iteration of the sharded CG (all-gather, K9, all-reduce, K9u,
    all-reduce, K9u) in a CUDA graph, NCCL's collectives captured, and by
    events as the solve enqueues it, beside ``persistent_ms``,
    [continuity]'s iteration of the persistent launch on the same tree;
    K9u's launches (live and dead) and the iteration timed with each pair
    in turns (replaced, shipped, shipped, replaced), and the direction's
    library call. Prints two lines; returns the numbers."""
    from hpsdf_tpu_torch import continuity as TC
    from hpsdf_tpu_torch import parallel as P

    dev = fitted.device
    s = float(fitted.config.continuity_strength)
    op, blk, minv = row_block_of(fitted, s, 1, 0)
    errs, abs_errs, p_all = check_row_modes(blk, s, minv, label)
    full = TC.cg_matvec(op.to(dev), s, p_all)
    part = TC.cg_matvec_rows(blk, s, p_all)
    check(torch.equal(part[0], full[0]) and torch.equal(part[1], full[1]),
          f"{label}: K9's partial mode at one rank against K9, bit for bit")
    n = blk.rows
    reps = SHARD_REPS if n > 1_000_000 else 10 * SHARD_REPS
    g = torch.Generator(device=dev).manual_seed(17)
    x0, b = (torch.randn(n, generator=g, dtype=torch.float64, device=dev)
             for _ in range(2))
    st9 = TC._State.new(dev, -1.0, 2 ** 31 - 1)
    y = torch.zeros(n, dtype=torch.float64, device=dev)
    k9_ms = graph_ms(lambda: TC._matvec_rows_launch(blk, s, p_all, y, st9),
                     reps)
    # a live CG state, as the solve's first launches leave it
    state = TC._State.new(dev, -1.0, 2 ** 31 - 1)
    gathered = torch.empty(blk.op.n, dtype=torch.float64, device=dev)
    P.all_gather(x0, shard, gathered)
    TC._matvec_rows_launch(blk, s, gathered, y, state)
    x, r = x0.clone(), b - y
    p, z = torch.zeros_like(b), torch.zeros_like(b)
    TC._update_rows_launch(True, n, y, minv, x, r, p, z, state)
    pap = state.sc[TC._SC["pap"]: TC._SC["pap"] + 1]
    parts = state.sc[TC._SC["rz_part"]: TC._SC["rr_part"] + 1]
    P.all_reduce(parts, shard)
    TC._direction_launch(True, n, z, p, state)

    pairs = rows_pairs()

    def iteration(pair):
        update, direction = pairs[pair]

        def run():
            P.all_gather(p, shard, gathered)
            TC._matvec_rows_launch(blk, s, gathered, y, state)
            P.all_reduce(pap, shard)
            update(False, n, y, minv, x, r, p, z, state)
            P.all_reduce(parts, shard)
            direction(False, n, z, p, state)
        return run

    # the shipped pair against the replaced one from the live state, after
    # a matvec
    P.all_gather(p, shard, gathered)
    TC._matvec_rows_launch(blk, s, gathered, y, state)
    P.all_reduce(pap, shard)
    pair_checks = rows_pair_checks(dict(Ap=y, minv=minv, x=x, r=r, p=p, z=z),
                                   state, n, label)
    # at the 260k row the second launch's 42 MB would stay in the 50 MB L2
    # from one launch to the next: it turns over four copies, as the
    # solve's other vectors pass through L2 between two of its launches
    copies = [(z.clone(), p.clone()) for _ in range(4)]
    xu, ru = x.clone(), r.clone()
    turns = {}
    for pair in ("replaced", "shipped", "shipped", "replaced"):
        update, direction = pairs[pair]
        st_u = TC._State.new(dev, -1.0, 2 ** 31 - 1, rz=1.0)
        st_u.sc[TC._SC["pap"]] = 1e3
        st_u.sc[TC._SC["rz_part"]] = 1.0
        st_d = TC._State.new(dev, -1.0, 2 ** 31 - 1)
        st_d.st[TC._ST["active"]] = st_d.st[TC._ST["live"]] = 0
        turn = iter(range(1 << 30))
        got = {"k9u": graph_ms(lambda: update(
                   False, n, y, minv, xu, ru, copies[0][1], copies[0][0],
                   st_u), reps),
               "direction": graph_ms(lambda: direction(
                   False, n, *copies[next(turn) % 4], st_u), reps),
               "k9u_dead": graph_ms(lambda: update(
                   False, n, y, minv, xu, ru, p, z, st_d), reps),
               "direction_dead": graph_ms(lambda: direction(
                   False, n, z, p, st_d), reps),
               "iteration_graph": graph_ms(iteration(pair), reps),
               "iteration": time_ms(iteration(pair), reps)}
        for k, v in got.items():
            turns.setdefault(pair, {}).setdefault(k, []).append(v)
    check(int(state.st[TC._ST["active"]]) == 1
          and bool(torch.isfinite(state.sc).all()),
          f"{label}: the timed iterations stayed live: {state.st.tolist()}")
    mean = {pair: {k: sum(v) / len(v) for k, v in t.items()}
            for pair, t in turns.items()}
    k9u_ms, dir_ms = mean["shipped"]["k9u"], mean["shipped"]["direction"]
    it_ms = mean["shipped"]["iteration"]
    it_graph_ms = mean["shipped"]["iteration_graph"]
    # the direction's yardstick: one torch call of z + beta p, beta a host
    # float (no division, count or flag)
    lib_turn = iter(range(1 << 30))
    library_ms = graph_ms(lambda: torch.add(*copies[next(lib_turn) % 4],
                                            alpha=0.5), reps)
    few = 3
    plain = {"k9": time_ms(lambda: TC.face_matvec_rows_plain(blk, s, p_all),
                           few),
             "k9u": time_ms(lambda: TC.cg_update_rows_plain(
                 False, 1.0, 1e3, p, y, minv, x, r), few),
             "direction": time_ms(lambda: TC.cg_direction_plain(
                 False, 1.0, 1.0, z, p), few)}
    arrays = (blk.op.leaves, blk.op.slots, blk.op.xrowptr, blk.op.xcols,
              blk.op.xvals)
    bounds = {"k9": (bytes_ms(*arrays, extra=8 * (blk.op.n + n)),
                     face_ops(blk.op)[0]),
              "k9u": rows_bound("k9u", n),
              "direction": rows_bound("direction", n)}
    out = {"rows": n, "errs": errs, "abs_errs": abs_errs,
           "k9_ms": k9_ms, "k9u_ms": k9u_ms, "direction_ms": dir_ms,
           "iteration_ms": it_ms, "iteration_graph_ms": it_graph_ms,
           "persistent_iteration_ms": persistent_ms,
           **{f"{k}_plain_ms": v for k, v in plain.items()},
           **{f"{k}_bound_ms": max(v) for k, v in bounds.items()},
           **{f"{k}_bound_by": "bytes" if v[0] >= v[1] else "operations"
              for k, v in bounds.items()},
           **{f"{k}_replaced_ms": mean["replaced"][k] for k in (
               "k9u", "direction", "iteration", "iteration_graph")},
           **{f"{k}_{x}dead_ms": mean[pair][f"{k}_dead"]
              for k in ("k9u", "direction")
              for pair, x in (("shipped", ""), ("replaced", "replaced_"))},
           **{f"{k}_dead_bound_ms": rows_bound(k, n, live=False)[0]
              for k in ("k9u", "direction")},
           "direction_library_ms": library_ms, "turns": turns,
           "pair_checks": pair_checks[0], "pair_faults_caught":
           pair_checks[1]}
    print(f"[sharding] {label}, one rank: {smi} | K9u's two launches "
          f"against the replaced pair (csrc/check/cg_rows_reference.cu) from "
          f"one live state: {pair_checks[0]} comparisons equal (vectors bit "
          f"for bit, "
          f"dots within {CONT_RTOL:g}), {pair_checks[1]} planted faults "
          f"caught | in turns (replaced, shipped, shipped, replaced), CUDA "
          f"graphs, ms: " + "; ".join(
              f"{k} {mean['shipped'][k]:.5f} against "
              f"{mean['replaced'][k]:.5f}"
              for k in ("k9u", "direction", "k9u_dead", "direction_dead",
                        "iteration_graph", "iteration"))
          + f" (the last as enqueued) | direction's library call "
          f"torch.add(z, p, alpha=beta) {library_ms:.5f} ms", flush=True)
    print(f"[sharding] {label}, one rank: {smi} | n {n} | against plain "
          f"(relative): " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; K9's partial mode = K9 bit for bit | in CUDA graphs: K9 "
          f"partial {k9_ms:.4f} ms (bound {out['k9_bound_ms']:.5f}, "
          f"{out['k9_bound_by']}), K9u's first launch {k9u_ms:.4f} ms "
          f"(bound {out['k9u_bound_ms']:.5f}), its second {dir_ms:.4f} ms "
          f"(bound {out['direction_bound_ms']:.5f}); a sharded iteration "
          f"(all-gather, K9, all-reduce, K9u, all-reduce, K9u) "
          f"{it_graph_ms:.4f} ms in a CUDA graph, {it_ms:.4f} ms as the "
          f"solve enqueues it, against the persistent launch's "
          f"{persistent_ms:.4f} ms unsharded | plain: K9 {plain['k9']:.4f}, "
          f"K9u {plain['k9u']:.4f}, direction {plain['direction']:.4f} ms",
          flush=True)
    return out


def phase_sharding(tree, mesh, bvh, cfg, s_inv, solved, persistent_ms,
                   tree_path, smi):
    """The sharded paths at one NCCL rank on the card, at the main path's
    sizes, with the counts set to 0 just before and read just after:
    shard_query at 2^20 points and shard_trace at 1024^2 rays (K4 + K3) on
    the slice tree, bit for bit against query and trace; the slice's fit
    through the mesh F with fit_mesh, bit for bit against the slice tree and
    a one-device build timed beside it; enforce_continuity(mesh=) on both
    continuity trees (fit + continuity, the 260k-leaf row) within
    SHARD_CG_RTOL / SHARD_CG_ATOL of [continuity]'s solves, counts within
    one, and outside the count each solve again (bit for bit) and with the
    K9u launches it replaced (``replaced_rows``: the same count, within the
    same tolerance); fit_to_depth(mesh=) for SHARD_INV_STEPS steps at
    1080p, losses within SHARD_INV_RTOL. No launch of the unsharded CG's
    kernels. Then,
    outside the count, on both trees (``row_mode_times``), K9's partial mode
    (bit for bit K9 at one rank) and K9u's two launches against their plain
    versions, their times in CUDA graphs beside their bounds, a sharded CG
    iteration's (in a CUDA graph, NCCL's collectives captured, and by
    events as the solve
    enqueues it, beside ``persistent_ms``, [continuity]'s iterations of
    the persistent launch on the two trees) and shard_query's and
    shard_trace's overhead; then the
    same at two gloo ranks on the card in processes of their own
    (``sharding_rank``). Returns (launches, the numbers)."""
    import torch.multiprocessing as tmp

    import hpsdf_tpu_torch as T
    from hpsdf_tpu_torch import continuity as TC
    from hpsdf_tpu_torch import parallel as P
    from hpsdf_tpu_torch.inverse import fit_to_depth
    from hpsdf_tpu_torch.mesh import mesh_sdf

    dev = torch.device("cuda", 0)
    P.init_distributed(device=dev)
    check(P.dist.get_backend() == "nccl" and P.dist.get_world_size() == 1,
          f"one NCCL rank ({P.dist.get_backend()}, "
          f"{P.dist.get_world_size()})")
    dmesh = P.make_mesh(device=dev)
    shard = P.batch_shard(dmesh)
    F = mesh_sdf(mesh, bvh)
    pts = torch.as_tensor(np.random.default_rng(31).uniform(
        -0.4, 0.4, (N_QUERY, 3)), device=dev)
    o, d = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=RAYS_SIDE,
                         height=RAYS_SIDE, device=dev)
    kw = dict(t_max=T_MAX, cone_tiles=(RAYS_SIDE, RAYS_SIDE, SHARD_TILE))
    inv_args = (s_inv["init"], s_inv["o"], s_inv["d"], s_inv["t_star"],
                s_inv["hit_star"])
    # the one-device results, outside the counted run
    q_one, tr_one = T.query(tree, pts), T.trace(tree, o, d, **kw)
    sync()
    t0 = time.perf_counter()
    fit_one = T.build_octree(cfg, F, device=dev)
    sync()
    fit_one_s = time.perf_counter() - t0
    inv_one = fit_to_depth(*inv_args, n_steps=SHARD_INV_STEPS,
                           t_max=T_MAX).losses.cpu()

    reset_counts()
    TC._cg_rows_kernels.host_syncs = 0
    sync()
    t0 = time.perf_counter()
    q = P.shard_query(tree, pts, dmesh)
    tr = P.shard_trace(tree, o, d, dmesh, **kw)
    sync()
    reads_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fit = T.build_octree(cfg, F, fit_mesh=dmesh, device=dev)
    sync()
    fit_s = time.perf_counter() - t0
    cg = {}
    with record_calls(TC, "cg_solve_rows") as solves:
        for label, sv in (("fit_continuity", solved[0]),
                          ("row_260k", solved[1])):
            sync()
            t0 = time.perf_counter()
            out = TC.enforce_continuity(sv["fitted"], mesh=dmesh)
            sync()
            cg[label] = dict(seconds=time.perf_counter() - t0, out=out,
                             iterations=solves[-1][1],
                             residual=solves[-1][2])
    sync()
    t0 = time.perf_counter()
    inv = fit_to_depth(*inv_args, n_steps=SHARD_INV_STEPS, t_max=T_MAX,
                       mesh=dmesh).losses.cpu()
    inv_s = time.perf_counter() - t0
    launches = read_counts()
    host_syncs = TC._cg_rows_kernels.host_syncs
    # outside the count: each solve again, and once with the replaced pair
    # of K9u launches (csrc/check/cg_rows_reference.cu)
    for label, sv in (("fit_continuity", solved[0]), ("row_260k", solved[1])):
        c = cg[label]
        with record_calls(TC, "cg_solve_rows") as again:
            twice = TC.enforce_continuity(sv["fitted"], mesh=dmesh)
            with replaced_rows():
                replaced = TC.enforce_continuity(sv["fitted"], mesh=dmesh)
        c["bit_for_bit_twice"] = bool(torch.equal(twice.coeffs,
                                                  c["out"].coeffs))
        c["replaced_iterations"] = again[1][1]
        c["replaced_excess"], c["replaced_max_abs_diff"] = cg_close(
            replaced.coeffs, sv["tree"].coeffs)
        c["replaced_max_abs_diff_shipped"] = float(
            (replaced.coeffs - c["out"].coeffs).abs().max())
        check(c["bit_for_bit_twice"] and again[0][1] == c["iterations"],
              f"{label}: two row-sharded solves, bit for bit")
        check(c["replaced_iterations"] == c["iterations"]
              and c["replaced_excess"] <= 0, f"{label}: the row-sharded "
              f"solve with the replaced K9u launches: "
              f"{c['replaced_iterations']} "
              f"iterations against {c['iterations']}, max|diff| "
              f"{c['replaced_max_abs_diff']} from one device's")

    gpts = torch.as_tensor(root_points(*tree.root_aabb, N_QUERY, 46,
                                       pad=0.05), device=dev)
    grads = shard_grads(tree, gpts, (o, d, kw), dmesh, seed=47)
    check(torch.equal(q, q_one), "shard_query against query")
    check(torch.equal(tr.t, tr_one.t) and torch.equal(tr.hit, tr_one.hit),
          "shard_trace against trace (K4 + K3)")
    for ref, name in ((tree, "the slice tree"), (fit_one, "a build")):
        check(torch.equal(fit.child_idx, ref.child_idx)
              and torch.equal(fit.coeffs, ref.coeffs),
              f"build(fit_mesh=) against {name}, bit for bit")
    for label, sv in (("fit_continuity", solved[0]), ("row_260k", solved[1])):
        c = cg[label]
        c["excess"], c["max_abs_diff"] = cg_close(c.pop("out").coeffs,
                                                  sv["tree"].coeffs)
        c["one_device_iterations"] = sv["main"][1]
        check(c["excess"] <= 0, f"{label}: row-sharded CG against the "
              f"solve, max|diff| {c['max_abs_diff']}")
        check(abs(c["iterations"] - sv["main"][1]) <= 1, f"{label}: "
              f"iterations {c['iterations']} against {sv['main'][1]}")
    inv_rel = float(((inv - inv_one) / inv_one).abs().max())
    check(bool(torch.isfinite(inv).all()) and inv_rel <= SHARD_INV_RTOL,
          f"1080p fit_to_depth losses {inv.tolist()} against "
          f"{inv_one.tolist()}")
    for k in ("query", "march", "cone", "closest_tri", "cg_matvec_rows",
              "cg_update_rows", "cg_direction", "coeff_scatter",
              "packed_grad", "packed_eval_fused"):
        check(launches[k] > 0, f"{k} never launched on the sharded paths")
    for k in ("cg_matvec", "cg_update", "cg_chunk"):
        check(launches[k] == 0, f"the sharded CG launched {k} "
              f"{launches[k]} times")

    print(f"[sharding] one NCCL rank: {smi} | shard_query at {N_QUERY} "
          f"points and shard_trace at {RAYS_SIDE}^2 rays (K4 + K3) bit for "
          f"bit the one-device calls, {reads_s:.3f} s; build(fit_mesh=) of "
          f"the slice bit for bit the slice tree, {fit_s:.3f} s against "
          f"{fit_one_s:.3f} s on one device; row-sharded CG: "
          + "; ".join(f"{k} {v['iterations']} iterations (one device "
                      f"{v['one_device_iterations']}, the replaced K9u pair "
                      f"{v['replaced_iterations']}), max|diff| "
                      f"{v['max_abs_diff']:.3e} (the replaced pair's "
                      f"{v['replaced_max_abs_diff']:.3e}; from the shipped "
                      f"pair's {v['replaced_max_abs_diff_shipped']:.3e}), "
                      f"again bit for bit, {v['seconds']:.3f} s"
                      for k, v in cg.items())
          + f", host syncs {host_syncs}; fit_to_depth 1080p "
          f"{SHARD_INV_STEPS} steps {inv_s:.3f} s, losses "
          f"{[f'{v:.6g}' for v in inv.tolist()]}, max relative "
          f"difference {inv_rel:.3e} | launches {launches}", flush=True)
    print(f"[sharding] one NCCL rank: {smi} | the sharded reads' gradients "
          f"at {N_QUERY} slice points and {RAYS_SIDE}^2 rays (K4 + K3) "
          f"against one device's, max|diff| / max|one device|: "
          f"{grads_text(grads)}", flush=True)

    # K9's partial mode and K9u's two launches at one rank, both sizes
    modes = {label: row_mode_times(sv["fitted"], shard, label, ms, smi)
             for (label, sv), ms in zip((("fit_continuity", solved[0]),
                                         ("row_260k", solved[1])),
                                        persistent_ms)}
    nodes = phase_node_modes(dev, smi, tree)
    overhead = {"shard_query_ms": wall_ms(
        lambda: P.shard_query(tree, pts, dmesh), 5),
        "query_ms": wall_ms(lambda: T.query(tree, pts), 5),
        "shard_trace_ms": wall_ms(
            lambda: P.shard_trace(tree, o, d, dmesh, **kw), 5),
        "trace_ms": wall_ms(lambda: T.trace(tree, o, d, **kw), 5)}

    # two gloo ranks on the one card, in processes of their own
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out_path = os.path.join(os.path.dirname(tree_path),
                            "chip_smoke_sharding.json")
    if os.path.exists(out_path):
        os.remove(out_path)
    t0 = time.perf_counter()
    ranks = tmp.start_processes(sharding_rank, args=(2, port, cfg, tree_path,
                                                     out_path), nprocs=2,
                                join=False, start_method="spawn")
    # join raises where a rank failed, and stops the other
    while not ranks.join(timeout=5):
        if time.perf_counter() - t0 > SHARD_RANKS_S:
            for proc in ranks.processes:
                proc.kill()
            raise RuntimeError(f"the gloo ranks ran past {SHARD_RANKS_S} s")
    two_s = time.perf_counter() - t0
    with open(out_path) as fh:
        two = json.load(fh)
    P.dist.destroy_process_group()

    out = {"fit_s": fit_s, "fit_one_device_s": fit_one_s,
           "reads_s": reads_s, "inverse_s": inv_s,
           "inverse_losses": inv.tolist(),
           "inverse_one_device": inv_one.tolist(), "inverse_rel_err": inv_rel,
           "cg": cg, "host_syncs": host_syncs, "modes": modes,
           "grads": grads,
           "node_modes": nodes, "two_ranks": two, "two_ranks_s": two_s,
           **overhead}
    print(f"[sharding] {smi} | host ms a call: shard_query "
          f"{overhead['shard_query_ms']:.3f} against query "
          f"{overhead['query_ms']:.3f}, shard_trace "
          f"{overhead['shard_trace_ms']:.3f} against trace "
          f"{overhead['trace_ms']:.3f}", flush=True)
    print(f"[sharding] two gloo ranks on the card: {smi} | "
          f"{two_s:.2f} s with start-up; shard_query at "
          f"{SHARD_SMALL['points']} points, shard_trace at "
          f"{SHARD_SMALL['side']}^2 and build(fit_mesh=) at fit + continuity "
          f"bit for bit; row-sharded CG (rank 0: {two['block_leaves']} "
          f"leaves, {two['block_rows']} rows) iterations "
          f"{two['cg_iterations']}, max|diff| {two['cg_max_abs_diff']:.3e}; "
          f"partial modes against plain: "
          + ", ".join(f"{k} {v:.2e}" for k, v in two["errs"].items())
          + f"; fit_to_depth {SHARD_SMALL['inverse']}^2 max relative "
          f"difference {two['inverse_rel_err']:.3e} | rank 0's launches "
          f"{two['launches']}", flush=True)
    nd = two["node"]
    print(f"[sharding] the node axis, two gloo ranks on the card, mesh "
          f"(1, 2): {smi} | the complete depth-{NODE_DEPTH} tree at "
          f"{N_QUERY} points: shard_query(shard_nodes=True) against query "
          f"max|diff| {nd['max_abs_err']:.3e} (bit for bit: "
          f"{nd['bit_for_bit']}); rank 0 holds {nd['rows']} of "
          f"{nd['tree_rows']} rows, {nd['bytes']} B against "
          f"{nd['replicated_bytes']} B replicated; collectives a query "
          f"{nd['collectives']}; host ms a call {nd['shard_query_ms']:.3f} "
          f"against the batch axis's {nd['batch_shard_query_ms']:.3f} | "
          f"two node-sharded train steps on the slice tree: losses "
          f"{nd['step_losses'][:2]} (one device {nd['step_losses'][2]}), "
          f"max|coeffs - one device's| {nd['step_max_abs_diff']:.3e}",
          flush=True)
    print(f"[sharding] the sharded reads' gradients on two gloo ranks on "
          f"the card, batch axis (2, 1), node axis (1, 2): {smi} | "
          f"{SHARD_SMALL['points']} slice points, {SHARD_SMALL['side']}^2 "
          f"rays, rank 0 against one device: {grads_text(two['grads'])}",
          flush=True)
    return launches, out


PTXAS_KERNELS = ("query_kernel", "packed_eval_kernel", "march_kernel",
                 "cone_kernel", "packed_grad_kernel", "coeff_scatter_kernel",
                 "row_scatter_kernel", "row_scatter_csr_kernel",
                 "cg_matvec_kernel", "cg_update_kernel", "face_matvec_kernel",
                 "cg_chunk_kernel", "cg_update_rows_kernel",
                 "cg_direction_kernel", "hybrid_kernel", "bvh_walk_kernel",
                 "descend_nodes_kernel", "leaf_nodes_kernel",
                 "coeff_scatter_nodes_kernel", "node_sort_kernel",
                 "signed_from_best_kernel",
                 "inverse_points_kernel", "inverse_loss_kernel",
                 "inverse_vjp_kernel",
                 "fit_points_kernel", "fit_project_kernel",
                 "coeff_scatter_grad_kernel", "packed_hvp_kernel",
                 "query_vjp_kernel", "normals_grad_kernel")
# the check library's kernels the ptxas check reads (csrc/check/)
CHECK_PTXAS_KERNELS = ("inverse_terms_reference_kernel",
                       "query_vjp_reference_kernel",
                       "packed_grad_form2_reference_kernel",
                       "packed_hvp_reference_kernel",
                       "cg_update_rows_reference_kernel",
                       "cg_direction_reference_kernel")


def _ptxas_key(kernel, args):
    """The report's key for one instantiation, from its template arguments
    (ints, bools and the value type, in order)."""
    if not args:        # row_scatter(_csr), bvh_walk, descend_nodes, K13,
        return "-"      # K14, node_sort
    if kernel == "hybrid_kernel":
        return "two levels" if args[0] else "one level"
    if kernel in ("cg_update_kernel", "cg_update_rows_kernel",
                  "cg_direction_kernel", "cg_update_rows_reference_kernel",
                  "cg_direction_reference_kernel"):
        return "init" if args[0] else "iteration"
    if kernel == "cg_chunk_kernel":
        return "shared" if args[0] else "buffer"
    if kernel == "coeff_scatter_kernel":
        return f"{args[1]}/{'f32 trace' if args[2] else 'f64 query'}"
    if kernel == "query_kernel":
        return f"{args[0]}/{('values', 'grad')[args[1]]}" \
            + ("/leaf" if args[2:3] == [1] else "")
    if kernel in ("query_vjp_kernel", "query_vjp_reference_kernel"):
        return f"{args[0]}/{'hess' if args[1] == 2 else 'vjp'}" \
            + ("/centre" if args[2:3] == [1] else "")
    if kernel in ("packed_hvp_kernel", "packed_hvp_reference_kernel"):
        return f"{args[0]}/{('normals', 'values')[args[1]]}"
    if kernel == "packed_eval_kernel":
        return f"{args[0]}/" \
            + ('values', 'normals', 'raw', 'fused', 'save',
               'keys')[args[1]]
    if kernel in ("packed_grad_kernel", "packed_grad_form2_reference_kernel"):
        return f"{args[0]}/form{args[1]}"
    if kernel == "cone_kernel":
        return f"{args[0]}/{'lo' if args[1] else 'full'}"
    if kernel in ("fit_points_kernel", "fit_project_kernel"):
        return f"{args[0]}/{'f64' if args[1] == 'd' else 'f32'}"
    return str(args[0])   # march, leaf_nodes, coeff_scatter_nodes: degree


def ptxas_check():
    """Registers, stack and spills of every kernel's instantiations, as
    ptxas reported them when the library was built. K1 (values, and with
    the gradient) with and without the leaf it writes for K1v and K1h, K3,
    K4, K5's raw gradient (alone and fused with K2) and its normals mode
    that saves for K7's form 2 and K5h, K2's fused mode that saves the
    keys for K5h, K7 (its three forms), K8, K8g, K1v and K1h
    (from the leaf), K1c (but its ORDER 2 at degree 5, whose spills are
    read and printed) and K5h (both modes, from the saved values) at
    degrees 3 and 5 (the main paths'), both forms of G's backward, K9 (on
    the face
    operator and in its CSR form), K9u, both forms of the persistent
    launch, both forms
    of each of the row-sharded CG's two K9u launches (and, in the check
    library, both forms of each as they were before their redesign), both
    of K10 and K11,
    K1's node-range descent round and, at degrees 3 and 5, its leaf
    evaluation, K8's node-range mode at degrees 0..6 and its sort,
    K14, the three launches of K13,
    and both of K6's launches at every degree 2..11 in f64 and f32 must
    have no stack frame and no spills; so must the check library's K13
    terms as they were before their redesign, the reference the redesigned
    kernels are held and timed against; the check library's K1v, K1h, K7's
    form 2 and K5h as they were are read, for their registers. Returns
    {kernel: {key: [registers, stack, spill stores, spill loads]}}."""
    from hpsdf_tpu_torch import _kernels

    found = {}
    within = r"(?:(?!Compiling entry).)*?"      # inside one entry's report
    for text, kernels in ((_kernels.ptxas_report(), PTXAS_KERNELS),
                          (_kernels.ptxas_report("check"),
                           CHECK_PTXAS_KERNELS)):
        for m in re.finditer(
                r"Compiling entry function '(\S+)'" + within
                + r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                r"(\d+) bytes spill loads" + within
                + r"Used (\d+) registers", text, flags=re.S):
            k = re.search(r"(" + "|".join(kernels)
                          + r")(?:I((?:L[a-z]\d+E|[a-z])+)E)?", m.group(1))
            if not k:
                continue
            args = [int(v) if v else t for v, t in
                    re.findall(r"L[a-z](\d+)E|([a-z])", k.group(2) or "")]
            found.setdefault(k.group(1), {})[_ptxas_key(k.group(1), args)] \
                = [int(m.group(5)), int(m.group(2)), int(m.group(3)),
                   int(m.group(4))]
    for name, kernel, keys in (
            ("K1", "query_kernel", ("3/values", "3/grad", "5/values",
                                    "5/grad", "3/values/leaf",
                                    "3/grad/leaf", "5/values/leaf",
                                    "5/grad/leaf")),
            ("K1v", "query_vjp_kernel", ("3/vjp", "5/vjp")),
            ("K1c", "query_vjp_kernel", ("3/vjp/centre", "3/hess/centre",
                                         "5/vjp/centre")),
            ("K3", "march_kernel", ("3", "5")),
            ("K4", "cone_kernel", ("3/full", "5/full", "2/lo")),
            ("K5 raw", "packed_eval_kernel", ("3/raw", "5/raw", "3/fused",
                                               "5/fused")),
            ("K7", "packed_grad_kernel", ("3/form0", "3/form1", "5/form0",
                                          "5/form1")),
            ("K7 form 2", "normals_grad_kernel", ("3", "5")),
            ("K5 normals saving", "packed_eval_kernel", ("3/save",
                                                          "5/save")),
            ("K2 fused keys saving", "packed_eval_kernel", ("3/keys",
                                                            "5/keys")),
            ("K1h", "query_vjp_kernel", ("3/hess", "5/hess")),
            ("K8g", "coeff_scatter_grad_kernel", ("3", "5")),
            ("K5h", "packed_hvp_kernel", ("3/normals", "3/values",
                                          "5/normals", "5/values")),
            ("K8", "coeff_scatter_kernel", ("3/f64 query", "3/f32 trace",
                                            "5/f64 query", "5/f32 trace")),
            ("G backward", "row_scatter_kernel", ("-",)),
            ("G backward CSR", "row_scatter_csr_kernel", ("-",)),
            ("K9", "face_matvec_kernel", ("-",)),
            ("K9 CSR", "cg_matvec_kernel", ("-",)),
            ("K9u", "cg_update_kernel", ("init", "iteration")),
            ("K9 + K9u persistent", "cg_chunk_kernel", ("shared", "buffer")),
            ("K9u rows", "cg_update_rows_kernel", ("init", "iteration")),
            ("K9u direction", "cg_direction_kernel", ("init", "iteration")),
            ("K10", "hybrid_kernel", ("one level", "two levels")),
            ("K11", "bvh_walk_kernel", ("-",)),
            ("K1 node round", "descend_nodes_kernel", ("-",)),
            ("K1 node leaf", "leaf_nodes_kernel", ("3", "5")),
            ("K8 nodes", "coeff_scatter_nodes_kernel",
             tuple(str(d) for d in range(7))),
            ("K8 node sort", "node_sort_kernel", ("-",)),
            ("K14", "signed_from_best_kernel", ("-",)),
            ("K13 points", "inverse_points_kernel", ("-",)),
            ("K13 loss", "inverse_loss_kernel", ("-",)),
            ("K13 vjp", "inverse_vjp_kernel", ("-",)),
            ("K6 points", "fit_points_kernel", K6_PTXAS_KEYS),
            ("K6 proj", "fit_project_kernel", K6_PTXAS_KEYS),
            ("K13 terms reference", "inverse_terms_reference_kernel",
             ("-",)),
            ("K9u rows reference", "cg_update_rows_reference_kernel",
             ("init", "iteration")),
            ("K9u direction reference", "cg_direction_reference_kernel",
             ("init", "iteration"))):
        got = found.get(kernel, {})
        for key in keys:
            check(key in got, f"ptxas report for {name} {key}")
            check(got[key][1:] == [0, 0, 0], f"{name} {key}: stack "
                  f"{got[key][1]} B, spills {got[key][2:]}")
    # K1c with the unit gradient at degree 5 spills a little at 255
    # registers (query.cu's kVjpBlocks): read, printed with the rest; so is
    # the kernel K7's form 2 replaced
    check("5/hess/centre" in found.get("query_vjp_kernel", {}),
          "ptxas report for K1c 5/hess/centre")
    for kernel in ("packed_grad_form2_reference_kernel",
                   "packed_hvp_reference_kernel"):
        check(bool(found.get(kernel)), f"ptxas report for {kernel}")
    print(f"[ptxas] registers / stack / spill stores / spill loads (bytes): "
          + " | ".join(f"{k} {found.get(k, {})}"
                       for k in PTXAS_KERNELS + CHECK_PTXAS_KERNELS),
          flush=True)
    return found


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
    with ThreadPoolExecutor(2) as pool:       # both libraries together
        for job in [pool.submit(_kernels.load),
                    pool.submit(_kernels.load_check)]:
            job.result()
    print(f"[build] {len(_kernels.sources())} sources -> "
          f"{os.path.relpath(_kernels.library_path())}, the reference "
          f"kernels of the K3, K4, K7 (forms 0-2), G's backward, K8, K11, "
          f"K6, K13, K1v, K1h, K5h and K9u row-launch checks -> "
          f"{os.path.relpath(_kernels.library_path('check'))}, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    PHASE_SECONDS["build"] = round(time.perf_counter() - t0, 3)
    ptxas = ptxas_check()

    # --- 3. P1 against its plain version -----------------------------------
    v, f = gen.icosphere(0.3, 5)
    t0 = time.perf_counter()
    mesh = build_mesh(v, f)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bvh = build_bvh(mesh, device=dev)
    sync()
    bvh_s = time.perf_counter() - t0
    print(f"[mesh] {mesh.n_faces} triangles, {bvh.n_leaves} packed rows; "
          f"build_mesh {mesh_s:.3f} s, build_bvh {bvh_s:.3f} s (host, then "
          f"the rows onto the card, synchronised)", flush=True)
    from hpsdf_tpu_torch.mesh.tiles_sdf import tile_table
    table = tile_table(bvh.tri_rows)
    p1_err = phase("p1", phase_p1, bvh.tri_rows, table, P1_SIZES)

    # --- 4. the slice ------------------------------------------------------
    cfg = Config(**SLICE_CONFIG)
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    tree, launches, fit_pts, split_s, k6_calls = phase(
        "slice", phase_slice, mesh, bvh, cfg, N_QUERY,
        os.path.join(_kernels.BUILD_DIR, "chip_smoke_tree.npz"))
    tf = phase("p1 fit batch", phase_p1_fit, bvh.tri_rows, table, fit_pts)
    p1_err = max(p1_err, tf["fit_max_abs_err"])
    tk14 = phase("k14 fit batch", phase_k14_fit, bvh.tri_rows, table,
                 fit_pts)
    tk6 = phase("k6", phase_k6, k6_calls, smi)
    tcold = phase("cold", phase_cold, split_s["first_build_s"],
                  split_s["k14"]["instrumented_build_s"], smi)

    # --- 5. K1 against its plain version -----------------------------------
    k1_err, k1g_err = phase("k1", phase_k1, tree, N_QUERY)

    # --- 6. times ----------------------------------------------------------
    t = phase("times", phase_times, bvh.tri_rows, table, tree, N_QUERY)
    print(f"[times] {smi} | P1 closest_tri at ({bvh.n_leaves} rows x "
          f"2^20 uniform pts): kernel {t['p1']:.3f} ms, plain "
          f"{t['p1_plain']:.3f} ms, bound on the scanned pairs "
          f"{t['p1_bound']:.3f} ms ({t['p1_bound'] / t['p1']:.1%} of it; "
          f"tiles skipped {t['p1_skipped']:.4f}), dense bound "
          f"{t['p1_dense_bound']:.3f} ms "
          f"({t['p1_dense_bound'] / t['p1']:.1%}) | P1 at the fit batch "
          f"({tf['fit_points']} pts): kernel {tf['fit_ms']:.3f} ms, bound on "
          f"the scanned pairs {tf['fit_bound_ms']:.3f} ms "
          f"({tf['fit_bound_ms'] / tf['fit_ms']:.1%} of it; tiles skipped "
          f"{tf['skipped_tile_share']:.4f}); without the cull "
          f"{tf['fit_dense_ms']:.3f} ms, dense bound "
          f"{tf['fit_dense_bound_ms']:.3f} ms "
          f"({tf['fit_dense_bound_ms'] / tf['fit_dense_ms']:.1%} of it) | "
          f"K1 query "
          f"at 2^20 pts: kernel {t['k1']:.4f} ms, plain {t['k1_plain']:.3f} "
          f"ms, bound {t['k1_bound']:.4f} ms ({t['k1_bound_by']}; bytes "
          f"{t['k1_bytes_bound']:.4f}, f64 operations "
          f"{t['k1_ops_bound']:.4f}) | K1 query_with_gradient: "
          f"kernel {t['k1g']:.4f} ms, plain {t['k1g_plain']:.3f} ms, bound "
          f"{t['k1g_bound']:.4f} ms ({t['k1g_bound_by']}; bytes "
          f"{t['k1g_bytes_bound']:.4f}, f64 operations "
          f"{t['k1g_ops_bound']:.4f})", flush=True)

    # --- 7. G against its plain version ------------------------------------
    tg, g_err = phase("g", phase_g, bvh.tri_rows)

    # --- 8. K2/K5 and K3 on the slice and reference-default trees ----------
    from hpsdf_tpu_torch import pack_tree
    pt_s = pack_tree(tree)
    print(f"[packed] slice tree: rows {pt_s.width} lanes, grid depth "
          f"{pt_s.grid_depth}, extra rounds {pt_s.extra_rounds}", flush=True)
    _, pt_r, sphere_r = phase("refdefault", phase_refdefault, dev)
    sphere_s = (np.zeros(3), 0.3)
    k2_err, k5_dot, tk2 = phase("k2 slice", phase_k2, pt_s, "slice",
                                sphere_s)
    k2r_err, k5r_dot, tk2r = phase("k2 refdefault", phase_k2, pt_r,
                                   "refdefault", sphere_r)
    k3_err, tk3, _, _ = phase(
        "k3 slice", phase_k3, pt_s, "slice", sphere_s, False, smi)
    k3r_err, tk3r, kkr, _ = phase(
        "k3 refdefault", phase_k3, pt_r, "refdefault", sphere_r, True, smi)

    # --- 8b. K4 then K3 on both trees, and the boundary view --------------
    tk4 = phase("k4 slice", phase_k4, pt_s, "slice", smi)
    tk4r = phase("k4 refdefault", phase_k4, pt_r, "refdefault", smi)
    bnd_hits, bnd_change = phase("k4 boundary", phase_boundary, cfg, dev)

    # --- 9. the render path ------------------------------------------------
    launches_r, tr, frac, k3c_err, k5c_dot, carve_pts, pt_c, ph, carved = \
        phase("render", phase_render, tree, _kernels.BUILD_DIR)
    k2m_err, k5m_dot, tk2m = phase("k2-main", phase_k2_main, pt_s,
                                   carve_pts, pt_c, ph)

    # --- 10. K2/K5 and K1 at every degree ----------------------------------
    k2d_err, k5d_dot, k1d_err, k1gd_err, k3d_err, k7d_err, k8d_err = phase(
        "degrees", phase_degrees, dev)

    # --- 11. the backward kernels, then inverse rendering ------------------
    s_inv, s_small = phase("inverse setup", inverse_setup, cfg, dev,
                           (INV_SIZE, (INV_SMALL, INV_SMALL)))
    tgrad = phase("grad", phase_grad, pt_s, tree, s_inv, smi)
    launches_g2, tg2 = phase("grad2", phase_grad2, tree, s_inv["init"], mesh,
                             carved, ph, smi, ptxas, pt_r)
    tk13 = phase("k13", check_k13, s_inv, smi)
    phase("k14 ops", phase_k14_ops, bvh.tri_rows, table, fit_pts, tk14)
    tk6.update(phase("k6 ops", phase_k6_ops, k6_calls))
    tk8n = phase("k8 nodes ops", phase_k8n_ops, tree, dev)
    launches_i, ti = phase("inverse", phase_inverse, s_inv, s_small, smi)

    # --- 12. the continuity post-process at both sizes ---------------------
    launches_ca, tca, solved_a = phase(
        "continuity fit", phase_continuity, "fit + continuity", CONT_FIT,
        CONT_FIT_RADII[1], CONT_FIT_RADII[0], smi)
    launches_cb, tcb, solved_b = phase(
        "continuity 260k", phase_continuity, "260k-leaf row", CONT_ROW,
        CONT_ROW_RADIUS, None, smi)
    tcd = dict(zip(("errs", "abs_errs"), phase(
        "continuity degrees", phase_continuity_degrees, smi)))

    # --- 13. the mesh at the reference's scale: K10 and K11 ----------------
    launches_m, tm = phase("mesh scale", phase_mesh_scale, cfg, bvh, smi,
                           fit_pts)

    # --- 14. the sharded paths: one NCCL rank, then two gloo ranks --------
    launches_s, tsh = phase(
        "sharding", phase_sharding, tree, mesh, bvh, cfg, s_inv,
        (solved_a, solved_b), (tca["iteration_ms"], tcb["iteration_ms"]),
        os.path.join(_kernels.BUILD_DIR, "chip_smoke_tree.npz"), smi)

    total = {k: launches[k] + launches_r[k] + launches_i[k]
             + launches_ca[k] + launches_cb[k] + launches_m[k]
             + launches_s[k] + launches_g2[k] for k in launches}
    g_probe = tg[f"{G_TABLE[0]}x{G_TABLE[1]}"]
    g_rows = tg[f"{bvh.tri_rows.shape[0]}x{bvh.tri_rows.shape[1]}"]
    kernels = [
        {"name": "closest_tri", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/closest_tri.cu",
         "replaces": "hpsdf_tpu/mesh/pallas_sdf.py:187",
         "launches": total["closest_tri"], "max_abs_err": p1_err,
         "ms": t["p1"], "plain_ms": t["p1_plain"],
         "bound_ms": t["p1_bound"], "bound_by": "operations",
         "library_ms": None, "dense_bound_ms": t["p1_dense_bound"],
         "skipped_tile_share_uniform": t["p1_skipped"], **tf},
        *({"name": name, "route": "cuda",
           "source": f"hpsdf_tpu_torch/csrc/{name}.cu", "replaces": replaces,
           **tm[name], "launches": total[name],
           "ptxas": ptxas.get(f"{name}_kernel", {})}
          for name, replaces in (("hybrid", "hpsdf_tpu/mesh/sdf.py:292"),
                                 ("bvh_walk", "hpsdf_tpu/mesh/sdf.py:73"))),
        {"name": "query", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/query.cu",
         "replaces": "hpsdf_tpu/query.py:70",
         "launches": total["query"], "max_abs_err": max(k1_err, k1d_err),
         "ms": t["k1"], "plain_ms": t["k1_plain"],
         "bound_ms": t["k1_bound"], "bound_by": t["k1_bound_by"],
         "library_ms": None, "bytes_bound_ms": t["k1_bytes_bound"],
         "ops_bound_ms": t["k1_ops_bound"],
         "grad_max_abs_err": max(k1g_err, k1gd_err), "grad_ms": t["k1g"],
         "grad_plain_ms": t["k1g_plain"], "grad_bound_ms": t["k1g_bound"],
         "grad_bound_by": t["k1g_bound_by"],
         "grad_bytes_bound_ms": t["k1g_bytes_bound"],
         "grad_ops_bound_ms": t["k1g_ops_bound"],
         "leaf_launches": total["query_leaf"],
         "ptxas": ptxas.get("query_kernel", {})},
        {"name": "row_gather", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/row_gather.cu",
         "replaces": "experiments/gather_probe.py:84,109,138",
         "launches": total["row_gather"], "max_abs_err": g_err,
         "ms": g_probe["ms"], "plain_ms": g_probe["plain_ms"],
         "bound_ms": g_probe["bound_ms"], "bound_by": "bytes",
         "library_ms": g_probe["library_ms"],
         "inrange_ms": g_probe["inrange_ms"],
         "tri_rows_ms": g_rows["ms"], "tri_rows_plain_ms": g_rows["plain_ms"],
         "tri_rows_bound_ms": g_rows["bound_ms"],
         "tri_rows_library_ms": g_rows["library_ms"],
         "tri_rows_inrange_ms": g_rows["inrange_ms"]},
        {"name": "packed_eval", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/packed_eval.cu",
         "replaces": "hpsdf_tpu/accel.py:329",
         "launches": total["packed_eval"],
         "values_launches": total["packed_eval"]
         - total["packed_eval_normals"] - total["packed_eval_raw"]
         - total["packed_eval_fused"],
         "normals_launches": total["packed_eval_normals"],
         "raw_gradient_launches": total["packed_eval_raw"],
         "fused_launches": total["packed_eval_fused"],
         "raw_gradient": tgrad["raw"], "fused": tgrad["fused"],
         "max_abs_err": max(k2_err, k2r_err, k2m_err, k2d_err),
         "ms": tk2["k2"], "plain_ms": tk2["k2_plain"],
         "bound_ms": tk2["k2_bound"], "bound_by": "bytes", "library_ms": None,
         "normals_min_dot": min(k5_dot, k5r_dot, k5c_dot, k5m_dot, k5d_dot),
         "normals_ms": tk2["k5"], "normals_plain_ms": tk2["k5_plain"],
         "normals_bound_ms": tk2["k5_bound"],
         "refdefault_ms": tk2r["k2"], "refdefault_plain_ms": tk2r["k2_plain"],
         "refdefault_bound_ms": tk2r["k2_bound"],
         "refdefault_normals_ms": tk2r["k5"],
         "refdefault_normals_plain_ms": tk2r["k5_plain"],
         "refdefault_normals_bound_ms": tk2r["k5_bound"], **tk2m,
         "ptxas": ptxas.get("packed_eval_kernel", {})},
        {"name": "march", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/march.cu",
         "replaces": "hpsdf_tpu/render.py:649",
         "launches": total["march"],
         "max_abs_err": max(k3_err, k3r_err, k3c_err, k3d_err),
         "ms": tk3["k3"], "plain_ms": tk3["k3_plain"],
         "bound_ms": tk3["k3_bound"], "bound_by": tk3["k3_bound_by"],
         "library_ms": None, "mrays_s": tk3["mrays"],
         **{f"{pre}{k}": v for pre, t3 in (("", tk3), ("refdefault_", tk3r))
            for k, v in (("bytes_bound_ms", t3["k3_bytes_bound"]),
                         ("ops_bound_ms", t3["k3_ops_bound"]),
                         ("index_order_ms", t3["k3_strips"]),
                         ("replaced_kernel_ms", t3["k3_reference"]),
                         ("one_ray_ms", t3["k3_one_ray"]),
                         ("miss_ray_ms", t3["k3_miss"]),
                         ("serial_floor_ms", t3["k3_serial_floor"]),
                         ("rays", t3["stats"]))},
         "refdefault_ms": tk3r["k3"],
         "refdefault_plain_ms": tk3r["k3_plain"],
         "refdefault_bound_ms": tk3r["k3_bound"],
         "refdefault_bound_by": tk3r["k3_bound_by"],
         "refdefault_mrays_s": tk3r["mrays"], "refdefault_kk": kkr,
         "with_t0_ms": tk4["k3_t0"], "refdefault_with_t0_ms": tk4r["k3_t0"],
         "ptxas": ptxas.get("march_kernel", {})},
        {"name": "cone", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/cone.cu",
         "replaces": "hpsdf_tpu/render.py:260",
         "launches": total["cone"],
         "max_abs_err": max(tk4["t0_max_abs_err"], tk4r["t0_max_abs_err"]),
         "ms": tk4["k4"], "plain_ms": tk4["k4_plain"],
         "bound_ms": tk4["k4_bound"], "bound_by": tk4["k4_bound_by"],
         "library_ms": None,
         **{f"{pre}{k}": t4[k] for pre, t4 in (("", tk4),
                                               ("refdefault_", tk4r))
            for k in ("k3_t0", "k3", "t0_agree", "escaped_share", "t_err",
                      "cone_pays", "k4_reference", "k4_cap0",
                      "k4_reference_cap0", "k4_longest", "reference_longest",
                      "k4_miss", "reference_miss", "k4_bytes_bound",
                      "k4_ops_bound", "table_bytes", "k", "rounds",
                      "rounds_hist", "round_instr", "round_instr_reference",
                      "issue_ms", "issue_ms_reference", "clock_max_hz")},
         "refdefault_ms": tk4r["k4"], "refdefault_plain_ms": tk4r["k4_plain"],
         "refdefault_bound_ms": tk4r["k4_bound"],
         "refdefault_bound_by": tk4r["k4_bound_by"],
         "render_512": tr["cone"],
         "boundary_view": {"hits": bnd_hits, **bnd_change},
         "ptxas": ptxas.get("cone_kernel", {})},
        *({"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": total[name],
           "max_abs_err": max(t["max_abs_err"] for t in tgrad[name].values()),
           **{k: tgrad[name][main][k] for k in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "replaced_kernel_ms")},
           "main_shape": main, "shapes": tgrad[name],
           **({"degrees_rel_err": k7d_err} if name == "packed_grad" else {}),
           **({"degrees_rel_err": k8d_err, "step": tgrad["k8_step"]}
              if name == "coeff_scatter" else {}),
           **({} if name not in tgrad["fixed_cost"] else dict(zip(
               ("fixed_cost_ms", "replaced_fixed_cost_ms"),
               tgrad["fixed_cost"][name]))),
           "ptxas": {k: v for k, v in ptxas.items()
                     if k.startswith(f"{name}_")}}
          for name, source, replaces, main in (
              ("packed_grad", "hpsdf_tpu_torch/csrc/packed_grad.cu",
               "hpsdf_tpu/inverse.py:234",
               "form 0, inverse chunk 7n points"),
              ("row_scatter", "hpsdf_tpu_torch/csrc/row_gather.cu",
               "experiments/gather_probe.py:109", "the repack's grid"),
              ("coeff_scatter", "hpsdf_tpu_torch/csrc/coeff_scatter.cu",
               "hpsdf_tpu/render.py:983",
               "f32 trace, inverse chunk rays"))),
        *({"name": name, "route": "cuda",
           "source": "hpsdf_tpu_torch/csrc/continuity.cu",
           "replaces": replaces, "launches": total[name],
           "max_abs_err": max(v for c in (tca, tcb, tcd)
                              for k, v in c["abs_errs"].items()
                              if k.split(" ")[0] == pre),
           "max_rel_err": max(v for c in (tca, tcb, tcd)
                              for k, v in c["errs"].items()
                              if k.split(" ")[0] == pre),
           "ms": tcb[ms], "plain_ms": tcb[plain],
           "bound_ms": tcb[f"{pre}_bound_ms"],
           "bound_by": tcb[f"{pre}_bound_by"],
           "library_ms": tcb["k9_library_ms"] if pre == "k9" else None,
           "fit_continuity": {"ms": tca[ms], "plain_ms": tca[plain],
                              "bound_ms": tca[f"{pre}_bound_ms"],
                              **{k: tca[k] for k in extra}},
           **{k: tcb[k] for k in extra},
           "ptxas": {k: ptxas.get(k, {}) for k in kernels_of}}
          for name, pre, replaces, ms, plain, extra, kernels_of in (
              ("cg_matvec", "k9", "hpsdf_tpu/continuity.py:401-405,422",
               "k9_ms", "k9_plain_ms",
               ("k9_csr_ms", "k9_csr_bound_ms", "k9_library_62m_ms",
                "k9_plain_coo_ms", "nnz_merged"),
               ("face_matvec_kernel", "cg_matvec_kernel")),
              ("cg_update", "k9u", "hpsdf_tpu/continuity.py:423-428",
               "k9u_ms", "k9u_plain_ms", (), ("cg_update_kernel",)),
              ("cg_chunk", "chunk", "hpsdf_tpu/continuity.py:415-430",
               "iteration_ms", "iteration_plain_ms",
               ("iteration_csr_ms", "iteration_two_launch_ms",
                "chunk_saves_ms", "chunk_blocks", "chunk_group_doubles"),
               ("cg_chunk_kernel",)))),
        *({"name": name, "route": "cuda",
           "source": "hpsdf_tpu_torch/csrc/continuity.cu",
           "replaces": replaces, "launches": launches_s[name],
           "max_abs_err": max(v for e in (
               *(m["abs_errs"] for m in tsh["modes"].values()),
               tsh["two_ranks"]["abs_errs"])
               for k, v in e.items() if k.startswith(pre)),
           "max_rel_err": max(v for e in (
               *(m["errs"] for m in tsh["modes"].values()),
               tsh["two_ranks"]["errs"])
               for k, v in e.items() if k.startswith(pre)),
           **{k: tsh["modes"]["row_260k"][f"{key}_{k}"]
              for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
           "fit_continuity": {k: tsh["modes"]["fit_continuity"][f"{key}_{k}"]
                              for k in ("ms", "plain_ms", "bound_ms")},
           # K9's yardstick in [continuity]: torch.mv on the 260k row's
           # merged CSR, the same product at one rank; the direction's,
           # torch.add(z, p, alpha=beta) (no division, count or flag)
           "library_ms": {"k9": tcb["k9_library_ms"],
                          "direction": tsh["modes"]["row_260k"][
                              "direction_library_ms"]}.get(key),
           **({} if key == "k9" else {
               "fit_continuity_library_ms": tsh["modes"]["fit_continuity"][
                   "direction_library_ms"] if key == "direction" else None,
               **{f"{k}{at}": tsh["modes"][label][f"{key}_{k}"]
                  for k in ("replaced_ms", "dead_ms", "replaced_dead_ms",
                            "dead_bound_ms")
                  for label, at in (("row_260k", ""),
                                    ("fit_continuity", "_fit_continuity"))},
               "reference": {
                   "source": "hpsdf_tpu_torch/csrc/check/"
                             "cg_rows_reference.cu",
                   "entry": f"hpsdf_{kernel[:-7]}_reference",
                   "ms": tsh["modes"]["row_260k"][f"{key}_replaced_ms"],
                   "ptxas": ptxas.get(f"{kernel[:-7]}_reference_kernel",
                                      {})},
               "pair_checks": {label: [m["pair_checks"],
                                       m["pair_faults_caught"]]
                               for label, m in tsh["modes"].items()}}),
           "two_rank_launches": tsh["two_ranks"]["launches"][name],
           "ptxas": ptxas.get(kernel, {})}
          for name, key, pre, replaces, kernel in (
              ("cg_matvec_rows", "k9", "k9 rows",
               "hpsdf_tpu/continuity.py:568-571,591", "face_matvec_kernel"),
              ("cg_update_rows", "k9u", "k9u rows",
               "hpsdf_tpu/continuity.py:585-586,592-595",
               "cg_update_rows_kernel"),
              ("cg_direction", "direction", "direction",
               "hpsdf_tpu/continuity.py:596", "cg_direction_kernel"))),
        # the node-range modes: launches from the two gloo ranks' node-axis
        # run (rank 0), the node axis's main path; times at one block
        {"name": "query_nodes", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/query.cu",
         "replaces": "hpsdf_tpu/query.py:37-66",
         "launches": tsh["two_ranks"]["launches"]["query_nodes"],
         "max_abs_err": max(tsh["node_modes"]["errs"]["leaf"],
                            tsh["node_modes"]["errs"]["k1"],
                            tsh["two_ranks"]["node"]["max_abs_err"]),
         **{k: tsh["node_modes"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by", "rounds_ms",
                      "leaf_ms", "rounds_bound_ms", "leaf_bound_ms", "k1_ms",
                      "bit_for_bit")},
         "library_ms": None,
         "ptxas": {k: ptxas.get(k, {}) for k in ("descend_nodes_kernel",
                                                  "leaf_nodes_kernel")}},
        {"name": "signed_from_best", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/sign.cu",
         "replaces": "hpsdf_tpu/mesh/sdf.py:61",
         "launches": total["signed_from_best"],
         "max_abs_err": max(tk14["max_abs_err"], tm["k14"]["max_abs_err"],
                            tm["k14_fit_batch"]["max_abs_err"]),
         **{k: tk14[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "bytes_bound_ms",
                                 "ops_bound_ms", "before_ms", "points",
                                 "sign_differ", "feature_differ",
                                 "launches_a_call",
                                 "before_launches_a_call",
                                 "sector_bound_ms", "teeth",
                                 "no_rows_ms", "one_row_ms")},
         "mesh_1p31m_uniform": tm["k14"],
         "mesh_1p31m_fit_batch": tm["k14_fit_batch"],
         "ptxas": ptxas.get("signed_from_best_kernel", {})},
        *({"name": f"inverse_{key}", "route": "cuda",
           "source": "hpsdf_tpu_torch/csrc/inverse_terms.cu",
           "replaces": "hpsdf_tpu/inverse.py:188",
           "launches": total[f"inverse_{key}"],
           "max_abs_err": err, "ms": tk13[f"{key}_ms"],
           "plain_ms": tk13[f"{key}_plain_ms"],
           **{k: tk13[f"{key}_{k}"] for k in (
               "bound_ms", "bound_by", "bytes_bound_ms", "ops_bound_ms")},
           "library_ms": None, "rays": tk13["rays"], **extra,
           "ptxas": ptxas.get(f"inverse_{key}_kernel", {})}
          for key, err, extra in (
              ("points", 0.0, {"bit_for_bit": True,
                               "launches_a_chunk": tk13["points_ops"],
                               "formula_launches_a_chunk":
                               tk13["formula_points_ops"]}),
              ("loss", tk13["loss_abs_err"],
               {"loss_rel_err": tk13["loss_rel_err"],
                             "seeded_loss_rel_err":
                             tk13["seeded_loss_rel_err"],
                             "replaced_loss_rel_err":
                             tk13["replaced_loss_rel_err"]}),
              ("vjp", max(v["max_abs_err"]
                          for v in tk13["cotangents"].values()),
               {"cotangents": tk13["cotangents"],
                "bit_for_bit_replaced_times_go": True, "go": tk13["go"],
                "teeth": tk13["teeth"], "seeded_teeth": tk13["seeded_teeth"],
                "replaced_kernel_ms": tk13["replaced_ms"],
                "reference": {"source": "hpsdf_tpu_torch/csrc/check/"
                                        "inverse_terms_reference.cu",
                              "entry": "hpsdf_inverse_terms_reference",
                              "ms": tk13["replaced_ms"]},
                **{f"pair_{k}": tk13[f"pair_{k}"] for k in (
                    "bound_ms", "bound_by", "bytes_bound_ms",
                    "ops_bound_ms")},
                "pair_ms": tk13["pair_ms"],
                "replaced_pair_ms": tk13["replaced_pair_ms"],
                "terms_launches_a_chunk": tk13["terms_ops"],
                "formula_terms_launches_a_chunk":
                tk13["formula_terms_ops"]}))),
        {"name": "coeff_scatter_nodes", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/coeff_scatter.cu",
         "replaces": "hpsdf_tpu/query.py:70-88",
         "launches": tsh["two_ranks"]["launches"]["coeff_scatter_nodes"],
         "max_abs_err": tsh["node_modes"]["errs"]["k8 abs"],
         "max_rel_err": max(tsh["node_modes"]["errs"]["k8"],
                            tsh["node_modes"]["errs"]["k8 query"]),
         **{k: tsh["node_modes"][f"k8_{k}"]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "query_form_ms": tsh["node_modes"]["k8_query_ms"],
         "replaced_kernel_ms": tsh["node_modes"]["k8_replaced_ms"],
         "reference": {"source": "hpsdf_tpu_torch/csrc/check/"
                                 "coeff_scatter_nodes_reference.cu",
                       "entry": "hpsdf_coeff_scatter_nodes_reference",
                       "ms": tsh["node_modes"]["k8_replaced_ms"]},
         "tile_rows": tsh["node_modes"]["k8_tile_rows"],
         **tk8n, "shapes": tsh["node_modes"]["k8_shapes"],
         "teeth": tsh["node_modes"]["k8_teeth"],
         "ptxas": ptxas.get("coeff_scatter_nodes_kernel", {})},
        # its sort, the node-range mode's first launch; timed at one
        # block of the complete tree, the other shapes under
        # coeff_scatter_nodes' "shapes"
        {"name": "node_buckets", "route": "cuda",
         "source": "hpsdf_tpu_torch/csrc/coeff_scatter.cu",
         "replaces": "hpsdf_tpu/query.py:70-88",
         "launches": tsh["two_ranks"]["launches"]["node_buckets"],
         "max_abs_err": 0.0, "per_tile_sets_equal_plain": True,
         "blocks_checked": tsh["node_modes"]["k8_buckets_checked"],
         "variants_checked": tsh["node_modes"]["k8_variants_checked"],
         **{k: tsh["node_modes"]["k8_shapes"]["one block"][f"buckets_{k}"]
            for k in ("ms", "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library_ms": None,
         "ptxas": ptxas.get("node_sort_kernel", {})},
        # K6 at degree 2's full chunk (1,438 cells, as the slice's
        # largest), warm; cold, the replaced kernel (csrc/check/
        # fit_reference.cu) and the other chunks under "chunks"
        *({"name": f"fit_{key}", "route": "cuda",
           "source": "hpsdf_tpu_torch/csrc/fit.cu", "replaces": replaces,
           "launches": total[f"fit_{key}"], "max_abs_err": err,
           **{k: tk6["full"][2][key][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "bytes_bound_ms", "ops_bound_ms", "cells", "cold_ms",
               "share")},
           "replaced_kernel_ms": tk6["full"][2][key]["reference_ms"],
           "reference": {
               "source": "hpsdf_tpu_torch/csrc/check/fit_reference.cu",
               "entry": f"hpsdf_fit_{key}_reference",
               "ms": tk6["full"][2][key]["reference_ms"],
               "cold_ms": tk6["full"][2][key]["reference_cold_ms"]},
           "chunks": {f"{group} {k}": {kk: v for kk, v in x[key].items()}
                      for group in ("full", "main", "small")
                      for k, x in tk6[group].items()},
           **extra, "faster_than_pr18": tk6["faster_than_pr18"],
           "launches_a_chunk": tk6["launches_a_chunk"],
           "plain_launches_a_chunk": tk6["plain_launches_a_chunk"],
           "ptxas": ptxas.get(f"fit_{key}_kernel", {})}
          for key, replaces, err, extra in (
              ("points", "hpsdf_tpu/build.py:515", 0.0,
               {"bit_for_bit": True}),
              ("project", "hpsdf_tpu/build.py:100",
               max(tk6["errs"]["slice"][2], tk6["errs"]["f64"][2],
                   tk6["errs"]["f32"][2]),
               {"errs": tk6["errs"], "teeth": tk6["teeth"],
                "slice_chunk": tk6["slice_chunk"],
                "invariance": tk6["invariance"], "shapes": tk6["shapes"],
                "einsums_only": tk6["einsums_only"],
                "faster_than_einsums": tk6["faster_than_einsums"]}))),
        # the reads' backward kernels; launches from [grad2]'s paths
        *({"name": name, "route": "cuda",
           "source": f"hpsdf_tpu_torch/csrc/{source}", "replaces": replaces,
           "launches": GRAD2_KERNELS[name](launches_g2),
           "max_abs_err": max(tg2["abs_errs"][k] for k in keys),
           "max_rel_err": max(tg2["errs"][k] for k in keys),
           **{k: tg2["times"][name][k] for k in (
               "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
               "bytes_bound_ms", "ops_bound_ms", "launches_a_call",
               "points")},
           **({"values_mode": tg2["times"]["packed_hvp_values"]}
              if name == "packed_hvp" else {}),
           **({"at_path_c_hits": tg2["leaf"]["hits"][name]}
              if name == "packed_grad_form2" else {}),
           **({"at_path_c_hits": tg2["hvp"]["(c) hits"]["normals"],
               "values_mode_at_path_c_hits":
               tg2["hvp"]["(c) hits"]["values"],
               "shapes": tg2["hvp"],
               "branches": tg2["hvp_branches"],
               "path_c_step": tg2["redesign_steps"]["(c) K5h"][:3],
               "from_saved": True,
               "key_launches": launches_g2["packed_eval_keys"],
               "reference": {
                   "source": "hpsdf_tpu_torch/csrc/check/"
                             "packed_hvp_reference.cu",
                   "entry": "hpsdf_packed_hvp_reference"}}
              if name == "packed_hvp" else {}),
           **({"from_leaf": True, "bit_for_bit_replaced": True,
               "leaf_launches": launches_g2["query_leaf"],
               "reference": {
                   "source": "hpsdf_tpu_torch/csrc/check/"
                             "query_vjp_reference.cu",
                   "entry": "hpsdf_query_vjp_reference"},
               "shapes": {k: {**row[key], **{
                   f"forward_{x}": row[f"{fw}_{x}"] for x in (
                       "ms", "leaf_ms")}} for k, row in
                   tg2["leaf"]["shapes"].items()},
               "split": tg2["leaf"]["split"],
               "blocks": {k: v for k, v in tg2["leaf"]["blocks"].items()
                          if k.endswith(sub)}}
              if key is not None else {}),
           **({"replaced_kernel_ms": tg2["times"][name]["replaced_kernel_ms"]}
              if name in ("packed_hvp", "packed_grad_form2") else {}),
           **({"hess": tg2["times"]["query_centre_vjp_hess"],
               "shapes": tg2["centre"],
               "path_d": tg2["centre_fit"]}
              if name == "query_centre_vjp" else {}),
           **({"shapes": tg2["form2"],
               "path_c_step": tg2["redesign_steps"]["(c)"][:3],
               "reference": {
                   "source": "hpsdf_tpu_torch/csrc/check/"
                             "packed_grad_form2_reference.cu",
                   "entry": "hpsdf_packed_grad_form2_reference"}}
              if name == "packed_grad_form2" else {}),
           "teeth": {k: tg2["teeth"][k] for k in keys},
           "ptxas": {k: v for k, v in ptxas.get(kernel, {}).items()
                     if k.endswith(sub)}}
          for name, source, replaces, keys, kernel, key, fw, sub in (
              ("query_vjp", "query.cu", "hpsdf_tpu/query.py:69-85",
               ("query_vjp", "query_vjp_inside_out"), "query_vjp_kernel",
               "k1v", "k1", "/vjp"),
              ("query_vjp_hess", "query.cu", "hpsdf_tpu/query.py:88-108",
               ("query_vjp_hess",), "query_vjp_kernel", "k1h", "k1g",
               "/hess"),
              ("query_centre_vjp", "query.cu", "hpsdf_tpu/query.py:61-66",
               tuple(f"query_centre_vjp{form}{part}" for form in (
                   "", "_inside_out", "_hess") for part in (
                       "", "_both", "_blocks")), "query_vjp_kernel",
               None, None, "/centre"),
              ("coeff_scatter_grad", "coeff_scatter.cu",
               "hpsdf_tpu/query.py:88-108",
               ("coeff_scatter_grad", "coeff_scatter_grad_sparse"),
               "coeff_scatter_grad_kernel", None, None, ""),
              ("packed_hvp", "packed_eval.cu",
               "hpsdf_tpu/render.py:1092-1110,hpsdf_tpu/inverse.py:234",
               ("packed_hvp", "packed_hvp_values"), "packed_hvp_kernel",
               None, None, ""),
              ("packed_grad_form2", "packed_grad.cu",
               "hpsdf_tpu/render.py:1092-1110", ("packed_grad_form2",),
               "normals_grad_kernel", None, None, ""))),
    ]
    print(f"[e2e] {smi} | carve {tr['carve_s']:.3f} s, render 512^2 "
          f"{tr['render_s']:.3f} s, hit fraction {frac:.4f} | 1024^2 march: "
          f"slice {tk3['mrays']:.2f} Mrays/s, refdefault "
          f"{tk3r['mrays']:.2f} Mrays/s | inverse 1080p "
          f"{ti['step_s']:.4f} s a step (the chunk's loss as before K13: "
          f"{ti['formula_step_s']:.4f} s), depth RMSE {ti['rmse_before']:.6f} "
          f"-> {ti['rmse_after']:.6f} | launches {total}", flush=True)
    print(f"[seconds] {PHASE_SECONDS}", flush=True)
    print(f"[profiler] traces with no record on the device, discarded by "
          f"device_ops (the call, the host's runtime calls that put work on "
          f"the card in it) and device_busy_ms (the call, \"busy\"): "
          f"{EMPTY_TRACES}", flush=True)
    cont = {label: {k: v for k, v in c.items()
                    if k not in ("errs", "abs_errs")}
            for label, c in (("fit_continuity", tca), ("row_260k", tcb))}
    print(json.dumps({"kernels": kernels, "inverse": ti,
                      "grad2": {k: tg2[k] for k in ("projection",
                                                    "oriented_fit",
                                                    "normal_map",
                                                    "centre_fit")},
                      "fit_split": {"slice": split_s, "carve": tr["split"],
                                    "carve_k6": tr["k6_split"],
                                    "mesh_scale_k6":
                                    tm["hybrid"]["fit"]["k6_split"],
                                    "cold": tcold},
                      "continuity": cont, "sharding": tsh}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold"]:
        sys.exit(cold_child(sys.argv[2]))
    sys.exit(main())
