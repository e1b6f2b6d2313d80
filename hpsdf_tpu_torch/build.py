"""Level-synchronous hp-adaptive octree construction.

The counterpart of ``hpsdf_tpu/build.py`` (``build``, :780-1021), kept
decision for decision: the uniform coarse stage to depth 4 at degree 2, the
error-descending prefix of refinable leaves each round, p- and
h-candidate fits, the eq-(8)/(9) choice between them and the apply steps.
The topology lives on the host in numpy while it grows; every F evaluation
and fit runs batched on the build's device.

A fit batch is one plain synchronous call: for each chunk of cells kernel
K6 (csrc/fit.cu) generates the quadrature points on the device
(``fit_points_kernel``), F is evaluated on them, and K6's second launch
runs the separable Gauss-Legendre projection with its error and nearness
weight (``fit_project_kernel``: a few whole cells a block at degrees 2-3, a
cell's slabs split over a cluster of 2-8 blocks above, fixed by the
degree), one row [coeffs | err] a cell; on CPU
tensors the plain versions (``fit_points_plain``, ``fit_project_plain``:
three torch einsums) run instead. Chunks bound the points one F call sees
(``BLOCK_PTS``) for memory only. A fit call copies its centres, depths and
kept coefficients to the device once and its rows back once; K6's tables
go to a device once (``fit_tables``).

A sharded fit (``fit_mesh``, a ``torch.distributed`` DeviceMesh) gives
chunk j of every fit batch to rank j mod the mesh's ranks (all of them, as
the reference flattens its mesh) and all-gathers the results: every F
call and projection sees the shapes of the one-device build, so the tree is
the same bit for bit, and the host topology stays the same on every
rank.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import _device, _kernels, basis, consts
from .config import Config, NearnessWeighting
from .tree import Octree, pack

# F signature: world points (K, 3) -> (K,), torch tensors on the build device.
SDFFn = Callable[[torch.Tensor], torch.Tensor]

# Quadrature points per F call and projection chunk: 2**20 points keep the
# largest projection intermediates (degree 5, (cells, 6, 21, 21) f64 and
# friends) and F's own scratch within a few hundred MB.
BLOCK_PTS = 1 << 20


# K6's template instantiations (csrc/fit.cu): every degree a fit takes,
# COARSE_DEGREE up to BASIS_MAX_DEGREE - 1 (p-refinement stops below it)
FIT_DEGREES = range(consts.COARSE_DEGREE, consts.BASIS_MAX_DEGREE)


class FitTables(NamedTuple):
    """K6's tables for one (degree, dtype, device): the Gauss-Legendre nodes
    ``xj`` (Q,), ``quadrature_matrix`` ``A`` (degree+1, Q), ``coeff_norms``
    ``cn`` (TREE_MAX_DEPTH+1, C), the basis triples ``ix`` (C, 3) and the
    top-degree mask ``top`` (C,)."""
    xj: torch.Tensor
    A: torch.Tensor
    cn: torch.Tensor
    ix: torch.Tensor
    top: torch.Tensor


@functools.lru_cache(maxsize=None)
def fit_tables(degree: int, dt: torch.dtype, device: torch.device):
    """``FitTables`` on ``device``, copied there once and kept."""
    idx = basis.basis_indices(degree)
    tables = (basis.leggauss(basis.fit_rule_size(degree))[0],
              basis.quadrature_matrix(degree), basis.coeff_norms(degree))
    xj, A, cn = (torch.as_tensor(np.ascontiguousarray(t), dtype=dt,
                                 device=device) for t in tables)
    return FitTables(
        xj=xj, A=A, cn=cn,
        ix=torch.as_tensor(idx, dtype=torch.long, device=device),
        top=torch.as_tensor(idx.sum(axis=1) == degree, device=device))


def fit_points_plain(centres, depths, degree: int):
    """K6's points, plain (hpsdf_tpu build.py:515-521): each cell's
    (4d+1)^3 tensor-product Gauss-Legendre points ``c + half * x``, half =
    2^-(depth+1), cell-major, then i, j, k (x, y, z) row-major. centres
    (m, 3) of the working dtype, depths (m,) int -> (m Q^3, 3)."""
    Q = basis.fit_rule_size(degree)
    dt = centres.dtype
    xj = fit_tables(degree, dt, centres.device).xj
    m = centres.shape[0]
    half = torch.exp2(-(depths.to(dt) + 1.0))
    gax = centres[:, :, None] + half[:, None, None] * xj          # (m, 3, Q)
    px = gax[:, 0, :, None, None].expand(m, Q, Q, Q)
    py = gax[:, 1, None, :, None].expand(m, Q, Q, Q)
    pz = gax[:, 2, None, None, :].expand(m, Q, Q, Q)
    return torch.stack([px, py, pz], dim=-1).reshape(-1, 3)


def fit_project_plain(nw: NearnessWeighting, nw_strength: float,
                      degree: int, prev_width: int, Fv, depths, cn,
                      prev_coeffs):
    """K6's projection, plain: fit degree-``degree`` bases to a batch of
    cells (hpsdf_tpu build._fit_impl, reference Octree.cpp:1007-1093).

    Fv (M, Q, Q, Q) F at each cell's Gauss-Legendre grid; depths (M,) int;
    cn the (TREE_MAX_DEPTH+1, C) ``coeff_norms`` table in Fv's dtype, each
    cell's row taken by its depth; prev_coeffs (M, prev_width) coefficients
    kept verbatim (p-refinement). Returns (coeffs (M, C), err (M,)), err by
    paper eq (6) with the optional nearness weighting of eqs (11)/(12).
    """
    dt = Fv.dtype
    tab = fit_tables(degree, dt, Fv.device)
    half = torch.exp2(-(depths.to(dt) + 1.0))                     # (M,)
    A = tab.A                                                     # (P+1, Q)
    T = torch.einsum("mijk,pi->mpjk", Fv, A)
    T = torch.einsum("mpjk,qj->mpqk", T, A)
    T = torch.einsum("mpqk,rk->mpqr", T, A)

    ix = tab.ix                                                   # (C, 3)
    raw = T[:, ix[:, 0], ix[:, 1], ix[:, 2]]                      # (M, C)
    coeffs = raw * cn[depths.long()] * (half ** 3)[:, None]

    if prev_width:
        coeffs = torch.cat([prev_coeffs, coeffs[:, prev_width:]], dim=1)

    err = torch.sum(torch.where(tab.top[None, :], coeffs ** 2, 0.0), dim=1)

    if nw != NearnessWeighting.NONE:
        # exact cell mean: only the constant basis has nonzero mean
        fbar = torch.abs(coeffs[:, 0] * torch.exp2(1.5 * depths.to(dt)))
        d = math.sqrt(3.0)
        if nw == NearnessWeighting.POLYNOMIAL:
            k = torch.clamp((1.0 - fbar / d) ** nw_strength, 0.0, 1.0)
        else:
            k = torch.exp(-nw_strength * fbar / d)
        err = err * k
    return coeffs, err


def _check_fit(what: str, degree: int, x, depths):
    """What K6's launches take: CUDA tensors of f32 or f64, int32 depths on
    the same device, a degree in ``FIT_DEGREES``."""
    if degree not in FIT_DEGREES:
        raise ValueError(f"{what}: degree {degree} outside "
                         f"{FIT_DEGREES.start}..{FIT_DEGREES.stop - 1}")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: tensors on {x.device}, not a CUDA device")
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: dtype {x.dtype}, not float32 or float64")
    if depths.dtype != torch.int32 or depths.device != x.device \
            or depths.shape != (x.shape[0],):
        raise ValueError(f"{what}: depths must be int32 ({x.shape[0]},) on "
                         f"{x.device}, got {depths.dtype} "
                         f"{tuple(depths.shape)} on {depths.device}")


def fit_points_kernel(centres, depths, degree: int):
    """K6's points (csrc/fit.cu): ``fit_points_plain`` bit for bit, one
    launch (16-byte stores from each cell's 3Q coordinates), on CUDA
    tensors; raises on anything else."""
    _check_fit("fit_points_kernel", degree, centres, depths)
    if centres.dim() != 2 or centres.shape[1] != 3:
        raise ValueError(f"fit_points_kernel: centres of shape "
                         f"{tuple(centres.shape)}, not (m, 3)")
    Q = basis.fit_rule_size(degree)
    c = centres.contiguous()
    out = torch.empty((c.shape[0] * Q ** 3, 3), dtype=c.dtype,
                      device=c.device)
    xj = fit_tables(degree, c.dtype, c.device).xj
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_fit_points(
        c.data_ptr(), depths.contiguous().data_ptr(), xj.data_ptr(), Q,
        c.shape[0], int(c.dtype == torch.float64), out.data_ptr(),
        _kernels.stream_of(c)), "fit_points")
    fit_points_kernel.launches += 1
    return out


fit_points_kernel.launches = 0


def fit_project_kernel(nw: NearnessWeighting, nw_strength: float,
                       degree: int, prev_width: int, Fv, depths, cn,
                       prev_coeffs, out=None):
    """K6's projection (csrc/fit.cu): ``fit_project_plain``'s coefficients
    and error as rows [coeffs (C) | err] (M, C+1) in Fv's dtype, into
    ``out`` where given, one launch, on CUDA tensors; raises on anything
    else. How a cell's sums are split over blocks depends on the degree
    alone, so a cell's row does not depend on the chunk that holds it."""
    _check_fit("fit_project_kernel", degree, Fv, depths)
    M, Q, C = Fv.shape[0], basis.fit_rule_size(degree), \
        consts.coeff_count(degree)
    dt, dev = Fv.dtype, Fv.device
    if Fv.shape != (M, Q, Q, Q):
        raise ValueError(f"fit_project_kernel: F values of shape "
                         f"{tuple(Fv.shape)}, not ({M}, {Q}, {Q}, {Q})")
    if cn.shape != (consts.TREE_MAX_DEPTH + 1, C) or cn.dtype != dt \
            or cn.device != dev or not cn.is_contiguous():
        raise ValueError(f"fit_project_kernel: cn must be the contiguous "
                         f"({consts.TREE_MAX_DEPTH + 1}, {C}) {dt} table on "
                         f"{dev}")
    if not 0 <= prev_width <= C or (prev_width and (
            prev_coeffs.shape != (M, prev_width) or prev_coeffs.dtype != dt
            or prev_coeffs.device != dev)):
        raise ValueError(f"fit_project_kernel: prev_coeffs must be "
                         f"({M}, {prev_width}) {dt} on {dev}")
    if out is None:
        out = torch.empty((M, C + 1), dtype=dt, device=dev)
    elif out.shape != (M, C + 1) or out.dtype != dt or out.device != dev \
            or not out.is_contiguous():
        raise ValueError(f"fit_project_kernel: out must be contiguous "
                         f"({M}, {C + 1}) {dt} on {dev}")
    Fv = Fv.contiguous()
    prev = prev_coeffs.contiguous() if prev_width else None
    A = fit_tables(degree, dt, dev).A
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_fit_project(
        Fv.data_ptr(), depths.contiguous().data_ptr(), A.data_ptr(),
        cn.data_ptr(), 0 if prev is None else prev.data_ptr(), prev_width,
        degree, nw.value, float(nw_strength), M,
        int(dt == torch.float64), out.data_ptr(), _kernels.stream_of(Fv)),
        "fit_project")
    fit_project_kernel.launches += 1
    return out


fit_project_kernel.launches = 0


def fit_points(centres, depths, degree: int):
    """A chunk's quadrature points: kernel K6 on CUDA tensors, the plain
    version on CPU tensors."""
    if centres.device.type == "cpu":
        return fit_points_plain(centres, depths, degree)
    return fit_points_kernel(centres, depths, degree)


def _fit_impl(nw: NearnessWeighting, nw_strength: float, degree: int,
              prev_width: int, Fv, depths, cn, prev_coeffs, out=None):
    """Fit degree-``degree`` bases to a batch of cells (hpsdf_tpu
    build._fit_impl): kernel K6's projection on CUDA tensors, the plain
    version on CPU tensors (arguments as ``fit_project_plain``'s). Returns
    (coeffs (M, C), err (M,)), views of the rows [coeffs | err] written
    into ``out`` (M, C+1) where given."""
    if Fv.device.type != "cpu":
        out = fit_project_kernel(nw, nw_strength, degree, prev_width, Fv,
                                 depths, cn, prev_coeffs, out)
        return out[:, :-1], out[:, -1]
    coeffs, err = fit_project_plain(nw, nw_strength, degree, prev_width, Fv,
                                    depths, cn, prev_coeffs)
    if out is None:
        return coeffs, err
    out[:, :-1] = coeffs
    out[:, -1] = err
    return out[:, :-1], out[:, -1]


def _fit(F_int: SDFFn, cfg: Config, dt: torch.dtype, device, shard,
         degree: int, centres: np.ndarray, depths: np.ndarray,
         prev: np.ndarray | None = None):
    """Point generation + F + projection for a batch of cells, chunked by
    ``BLOCK_PTS`` (hpsdf_tpu build._FitCache._fused). ``F_int`` takes
    internal unit-cube points. The centres, depths and ``prev`` go to the
    device once (chunks are views), each chunk's rows [coeffs | err] into
    one buffer, which comes back to the host once. ``shard``
    (``parallel.BatchShard`` or None): this rank fits chunks rank, rank +
    size, ... and the chunks are all-gathered (``_gather_chunks``). Returns
    (coeffs (M, C) f64, err (M,) f64) as host numpy."""
    Q = basis.fit_rule_size(degree)
    C = consts.coeff_count(degree)
    M = centres.shape[0]
    pw = 0 if prev is None else prev.shape[1]
    cc = max(1, BLOCK_PTS // Q ** 3)
    chunks = range(0, M, cc)
    mine = chunks if shard is None else chunks[shard.rank::shard.size]
    c_all = torch.as_tensor(centres, dtype=dt, device=device)
    d_all = torch.as_tensor(depths, dtype=torch.int32, device=device)
    p_all = torch.as_tensor(prev, dtype=dt, device=device) if pw else None
    cn = fit_tables(degree, dt, d_all.device).cn
    n_rows = M if shard is None else _chunk_layout(M, cc, shard.size)[2]
    rows = torch.empty((n_rows, C + 1), dtype=dt, device=device)
    at = 0
    for s in mine:
        c, d = c_all[s: s + cc], d_all[s: s + cc]
        m = c.shape[0]
        Fv = F_int(fit_points(c, d, degree)).to(dt).reshape(m, Q, Q, Q)
        _fit_impl(cfg.nearness_weighting, cfg.nearness_strength, degree, pw,
                  Fv, d, cn, p_all[s: s + cc] if pw else None,
                  rows[at: at + m])
        at += m
    host = (rows.cpu().numpy() if shard is None
            else _gather_chunks(rows, M, cc, shard))
    host = host.astype(np.float64, copy=False)
    return host[:, :C], host[:, C]


def _chunk_layout(M: int, cc: int, size: int):
    """Chunk j of cc cells (the last fewer) goes to rank j mod size: each
    chunk's size, its first row among its rank's rows, and the most rows a
    rank holds."""
    sizes = np.minimum(cc, M - np.arange(0, M, cc))
    first = np.zeros(sizes.size, np.int64)
    for k in range(size):
        mine = sizes[k::size]
        first[k::size] = np.cumsum(mine) - mine
    most = max(int(sizes[k::size].sum()) for k in range(size))
    return sizes, first, most


def _gather_chunks(rows, M: int, cc: int, shard):
    """Every rank's rows [coeffs | err] (its chunks in order, padded to the
    most rows a rank holds) all-gathered; returns all M cells' rows in
    order as host numpy."""
    from . import parallel

    sizes, first, most = _chunk_layout(M, cc, shard.size)
    out = parallel.all_gather(rows, shard).cpu().numpy()
    first += np.arange(sizes.size) % shard.size * most
    idx = np.concatenate([np.arange(f, f + n) for f, n in zip(first, sizes)])
    return out[idx]


class _State:
    """Growable host SoA mirror of the tree during construction."""

    def __init__(self, cfg: Config, cap: int = 8192):
        # the coarse stage alone needs sum(8^d, d=0..COARSE_DEPTH) nodes
        min_cap = (8 ** (consts.COARSE_DEPTH + 1) - 1) // 7
        if cfg.node_capacity < min_cap:
            raise ValueError(
                f"node_capacity={cfg.node_capacity} below the coarse-stage "
                f"minimum of {min_cap}")
        cap = min(cap, cfg.node_capacity)
        self.cfg = cfg
        self.cw = consts.coeff_count(cfg.max_degree)
        self.child_idx = np.full(cap, consts.NO_CHILD, np.int32)
        self.centre = np.zeros((cap, 3), np.float64)
        self.depth = np.zeros(cap, np.int32)
        self.degree = np.full(cap, consts.NO_BASIS, np.int32)
        self.coeffs = np.zeros((cap, self.cw), np.float64)
        self.err = np.zeros(cap, np.float64)
        self.n = 0

    def _grow(self, need: int):
        cap = self.child_idx.shape[0]
        if self.n + need <= cap:
            return
        if self.n + need > self.cfg.node_capacity:
            raise RuntimeError(
                f"octree exceeded node_capacity={self.cfg.node_capacity}; "
                "raise Config.node_capacity or loosen target_error")
        new_cap = cap
        while new_cap < self.n + need:
            new_cap *= 2
        new_cap = min(new_cap, self.cfg.node_capacity)
        for name in ("child_idx", "centre", "depth", "degree", "coeffs",
                     "err"):
            old = getattr(self, name)
            new = np.zeros((new_cap,) + old.shape[1:], old.dtype)
            new[:cap] = old
            if name == "child_idx":
                new[cap:] = consts.NO_CHILD
            if name == "degree":
                new[cap:] = consts.NO_BASIS
            setattr(self, name, new)

    def add_root(self):
        self._grow(1)
        self.centre[0] = 0.0
        self.depth[0] = 0
        self.n = 1

    def subdivide(self, parents: np.ndarray) -> np.ndarray:
        """Block-allocate 8 children per parent (Octree.cpp:1115-1128).
        Returns the (K, 8) child index array."""
        K = parents.shape[0]
        self._grow(8 * K)
        base = self.n + 8 * np.arange(K, dtype=np.int64)
        self.child_idx[parents] = base.astype(np.int32)
        kids = base[:, None] + np.arange(8)[None, :]
        self.centre[kids.reshape(-1)] = _child_centres(
            self.centre[parents], self.depth[parents])
        self.depth[kids.reshape(-1)] = np.repeat(self.depth[parents] + 1, 8)
        self.degree[kids.reshape(-1)] = consts.NO_BASIS
        self.n += 8 * K
        return kids


def _child_centres(centre: np.ndarray, depth: np.ndarray) -> np.ndarray:
    """(K*8, 3) centres of the 8 children of each cell: +/- a quarter cell
    per axis, octant bits x = bit0, y = bit1, z = bit2 (CornerAABB,
    Octree.cpp:1096-1112)."""
    q = np.exp2(-(depth.astype(np.float64) + 2.0))
    octs = np.arange(8)
    sgn = np.stack([(octs & 1), (octs >> 1) & 1, (octs >> 2) & 1],
                   axis=-1) * 2.0 - 1.0                           # (8, 3)
    return (centre[:, None, :] + q[:, None, None] * sgn[None]).reshape(-1, 3)


def build(config: Config, F: SDFFn, *, continuity_fn=None,
          progress: Callable[[str], None] | None = None, fit_mesh=None,
          device=_device.DEFAULT) -> Octree:
    """Approximate ``F`` with an hp-adaptive Legendre octree on ``device``
    (Octree::Create, Source/HP/Octree.cpp:312-352). ``F`` maps world points
    (K, 3) on ``device`` to (K,) values there.

    ``progress`` receives every log line, whether or not
    ``config.enable_logging`` prints it (hpsdf_tpu build.py:859-863).
    ``continuity_fn`` (``continuity.enforce_continuity`` from
    ``api.build_octree``) post-processes the packed tree when
    ``config.continuity`` is set. ``fit_mesh`` (a ``torch.distributed``
    DeviceMesh, ``parallel.make_mesh``; every rank calls ``build`` alike)
    shards each fit batch's chunks over all its ranks
    (``parallel.mesh_shard``); the tree is the
    one-device build's bit for bit (hpsdf_tpu build.py:789-793). Anything
    else but None raises TypeError."""
    shard = None
    if fit_mesh is not None:
        from .parallel import mesh_shard
        shard = mesh_shard(fit_mesh)
    device = _device.resolve(device)
    config.validate()
    t0 = time.monotonic()

    # Domain normalization: the internal tree spans the unit cube
    # (Octree.cpp:321-328), in the fit's working dtype.
    dt = torch.float32 if config.fit_dtype == "float32" else torch.float64
    root_centre = torch.as_tensor(config.root_centre, dtype=dt, device=device)
    root_sizes = torch.as_tensor(config.root_sizes, dtype=dt, device=device)

    def F_int(pts):
        # one fused multiply-add per coordinate, rounded as XLA rounds the
        # reference's pts * root_sizes + root_centre
        return F(torch.addcmul(root_centre, pts, root_sizes))

    st = _State(config)
    fit = functools.partial(_fit, F_int, config, dt, device, shard)

    def log(msg):
        if config.enable_logging:
            print(f"[hpsdf build +{time.monotonic() - t0:7.2f}s] {msg}")
        if progress is not None:
            progress(msg)

    # -- root + uniform coarse refinement (Octree.cpp:112-191, 792-801) ----
    st.add_root()
    frontier = np.array([0], dtype=np.int64)
    for _ in range(consts.COARSE_DEPTH):
        frontier = st.subdivide(frontier).reshape(-1)

    # -- round 0: degree-2 fit on every coarse leaf (Octree.cpp:836-843) ---
    coeffs, errs = fit(consts.COARSE_DEGREE, st.centre[frontier],
                       st.depth[frontier])
    cc = consts.coeff_count(consts.COARSE_DEGREE)
    st.coeffs[frontier, :cc] = coeffs
    st.degree[frontier] = consts.COARSE_DEGREE
    st.err[frontier] = errs
    total_err = float(errs.sum())
    log(f"coarse fit: {frontier.size} leaves, total_err={total_err:.3e}")

    max_deg, max_dep = config.max_degree, config.max_depth
    rounds = 0
    while total_err > config.target_error:
        leaves = np.flatnonzero((st.child_idx[: st.n] < 0)
                                & (st.degree[: st.n] >= 0)).astype(np.int64)
        p_ok = st.degree[leaves] < max_deg - 1
        h_ok = st.depth[leaves] < max_dep
        cand = leaves[p_ok | h_ok]
        if cand.size == 0:
            log(f"stopping: no refinable leaves (total_err={total_err:.3e})")
            break
        # the smallest error-descending prefix whose removal could bring the
        # total below target (batched analogue of the reference's greedy
        # max-error-first queue, Octree.cpp:216-240)
        errs_c = st.err[cand]
        order = np.argsort(-errs_c)
        csum = np.cumsum(errs_c[order])
        need = total_err - 0.5 * config.target_error
        k = min(int(np.searchsorted(csum, need)) + 1, cand.size)
        sel = cand[order[:k]]
        if sel.size == 0:
            break

        # Group the round's leaves by degree and fit every group's candidates
        # before applying any: a leaf p-refined in this round must not join
        # the next degree's group of the same round.
        jobs = []
        for d in np.unique(st.degree[sel]):
            grp = sel[st.degree[sel] == d]
            d = int(d)
            gp_ok = d < max_deg - 1
            gh_ok_mask = st.depth[grp] < max_dep

            # --- p-candidates: incremental fit at degree d+1 --------------
            p_err = np.full(grp.size, np.inf)
            p_coeffs = None
            if gp_ok:
                pw = consts.coeff_count(d)
                p_coeffs, p_err = fit(d + 1, st.centre[grp], st.depth[grp],
                                      prev=st.coeffs[grp, :pw])

            # --- h-candidates: 8 same-degree fits over the children -------
            h_err8 = h_coeffs = None
            if gh_ok_mask.any():
                hg = grp[gh_ok_mask]
                h_coeffs, h_err_flat = fit(
                    d, _child_centres(st.centre[hg], st.depth[hg]),
                    np.repeat(st.depth[hg] + 1, 8))
                h_err8 = h_err_flat.reshape(-1, 8)
            jobs.append((d, grp, gp_ok, gh_ok_mask, p_coeffs, p_err,
                         h_coeffs, h_err8))

        for (d, grp, gp_ok, gh_ok_mask, p_coeffs, p_err, h_coeffs,
             h_err8) in jobs:
            # --- decide h vs p (Octree.cpp:594-601, eqs (8)/(9)) ----------
            old_err = st.err[grp]
            cd, cd1 = consts.coeff_count(d), consts.coeff_count(d + 1)
            p_imp = np.full(grp.size, -np.inf)
            if gp_ok:
                p_imp = (old_err - 8.0 * p_err) / (cd1 - cd)
            h_imp = np.full(grp.size, -np.inf)
            if h_err8 is not None:
                max_child = h_err8.max(axis=1)
                h_imp[gh_ok_mask] = ((old_err[gh_ok_mask] - 8.0 * max_child)
                                     / (7.0 * cd))
            refine_p = gp_ok & (~gh_ok_mask | (p_imp > h_imp))
            refine_h = gh_ok_mask & ~refine_p

            # --- apply P (Octree.cpp:253-260) -----------------------------
            pg = grp[refine_p]
            if pg.size:
                pc = p_coeffs[refine_p]
                st.coeffs[pg, : pc.shape[1]] = pc
                st.degree[pg] = d + 1
                total_err += float(p_err[refine_p].sum()
                                   - old_err[refine_p].sum())
                st.err[pg] = p_err[refine_p]

            # --- apply H (Octree.cpp:262-279) -----------------------------
            hsel = grp[refine_h]
            if hsel.size:
                kids = st.subdivide(hsel)
                st.degree[hsel] = consts.NO_BASIS
                # scatter the candidate fits into the new children
                hpos = np.flatnonzero(refine_h[gh_ok_mask])
                rows = (hpos[:, None] * 8 + np.arange(8)[None]).reshape(-1)
                kc = h_coeffs[rows]
                flat_kids = kids.reshape(-1)
                st.coeffs[flat_kids, : kc.shape[1]] = kc
                st.degree[flat_kids] = d
                kerr = h_err8[hpos]
                st.err[flat_kids] = kerr.reshape(-1)
                total_err += float(kerr.sum() - old_err[refine_h].sum())

        rounds += 1
        log(f"round {rounds}: {sel.size} refined, nodes={st.n}, "
            f"total_err={total_err:.3e}")

    tree = pack(st.child_idx, st.centre, st.depth, st.degree, st.coeffs,
                st.n, config, device=device)
    log(f"packed: {st.n} nodes, {tree.num_leaves()} leaves, "
        f"deg_used={tree.deg_used}, depth_used={tree.depth_used}")

    if config.continuity and continuity_fn is not None:
        tree = continuity_fn(tree)
        log("continuity post-process done")

    return tree
