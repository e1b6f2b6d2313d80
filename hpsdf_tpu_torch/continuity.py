"""Global continuity post-process.

The counterpart of ``hpsdf_tpu/continuity.py``: solves (M + sI) c = s c0,
where M is the Gram matrix of inter-cell value jumps across shared leaf
faces -- the reference's PerformContinuityPostProcess
(Source/HP/Octree.cpp:1663-1762).

  * Host, numpy, copied from ``hpsdf_tpu.continuity``: the face pairs
    (``leaf_face_pairs``) and the cross-depth blocks (``_numeric_entries``).
    The same-depth blocks are never assembled on the solve's path: each of
    their entries is sign * n_i * n_j over a tangential-match pattern, so
    ``face_operator`` lists each leaf's same-depth neighbours instead, with
    the cross-depth entries merged into a small CSR and the Jacobi diagonal.
    ``assemble_face_matrix`` still builds the reference's COO, entry for
    entry: the tests and ``chip_smoke.py`` hold the operator to it.
  * The Jacobi-preconditioned CG in f64 on the tree's device, with the
    reference's recurrences and stopping rule (``cg_solve``). On a CUDA
    device (``csrc/continuity.cu``) a K9 launch (``cg_matvec``: y = M p +
    s p and p.y, the entries formed from the norm table) and a K9u launch
    (``cg_update``) start it, then each chunk of ``CG_CHUNK`` iterations is
    one persistent cooperative launch running both as phases between grid
    barriers (``_chunk_launch``); the iteration's scalars and the stopping
    test stay on the card, and the host reads them once a chunk. On the CPU
    the plain torch versions (``face_matvec_plain``, ``cg_update_plain``)
    run.

  * The row-sharded CG (``mesh=``, hpsdf_tpu continuity.py:523-618): each
    rank owns a contiguous block of leaves balanced by rows (``row_block``),
    the vector padded to equal blocks; an iteration all-gathers p, runs K9
    in its partial mode on the rank's leaves (``cg_matvec_rows``),
    all-reduces p.Ap, runs K9u's first launch (``cg_update_rows``: x, r, z
    and the rank's r.z and r.r), all-reduces those and runs its second
    (``cg_direction``: the new direction, beta, the count and the flag). The
    scalars stay on the card, the collectives go on the kernels' stream,
    and the host reads the flag once a chunk (``_cg_rows_kernels``). On the
    CPU the plain versions run (``_cg_rows_plain``).

The H100 has an f64 datapath, so the TPU's mixed-precision CG
(``_cg_solve_mixed``, its segmented restarts, ``COO_CHUNK``) is not
ported: ``cg="mixed"`` and ``cg="auto"`` mean f64.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, basis, consts
from .tree import Octree


# --------------------------------------------------------------------------
# Face-pair enumeration
# --------------------------------------------------------------------------

def leaf_face_pairs(child_idx: np.ndarray, n_nodes: int):
    """All (leaf_a, leaf_b, dim) sharing a positive-area face, with a on the
    minus side of axis ``dim``. Iterative, batched equivalent of
    NodeProc/FaceProc (Octree.cpp:1549-1612)."""
    ci = child_idx[:n_nodes]
    internal = np.flatnonzero(ci >= 0)

    seeds_a, seeds_b, seeds_d = [], [], []
    for d in range(3):
        bit = 1 << d
        # the 4 sibling pairs sharing an internal face per axis
        # (reference table SharedFaceLookup, Include/HP/Utility.h:166-196)
        for o in (o for o in range(8) if not (o & bit)):
            seeds_a.append(ci[internal] + o)
            seeds_b.append(ci[internal] + o + bit)
            seeds_d.append(np.full(internal.size, d, np.int32))
    if not seeds_a:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int32),)
    a = np.concatenate(seeds_a).astype(np.int64)
    b = np.concatenate(seeds_b).astype(np.int64)
    dd = np.concatenate(seeds_d)

    out = []
    while a.size:
        leaf_pair = (child_idx[a] < 0) & (child_idx[b] < 0)
        if leaf_pair.any():
            out.append((a[leaf_pair], b[leaf_pair], dd[leaf_pair]))
        live = ~leaf_pair
        a, b, dd = a[live], b[live], dd[live]
        if not a.size:
            break
        # expand each live pair into the 4 child sub-pairs facing the
        # shared plane (FaceProc recursion, Octree.cpp:1582-1588)
        na, nb, nd = [], [], []
        for d in range(3):
            m = dd == d
            if not m.any():
                continue
            bit = 1 << d
            aa, bb = a[m], b[m]
            a_has = child_idx[aa] >= 0
            b_has = child_idx[bb] >= 0
            for o in (o for o in range(8) if not (o & bit)):
                na.append(np.where(a_has, child_idx[aa] + o + bit, aa))
                nb.append(np.where(b_has, child_idx[bb] + o, bb))
                nd.append(np.full(aa.size, d, np.int32))
        a = np.concatenate(na).astype(np.int64)
        b = np.concatenate(nb).astype(np.int64)
        dd = np.concatenate(nd)

    if not out:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.int32),)
    A = np.concatenate([o[0] for o in out])
    B = np.concatenate([o[1] for o in out])
    D = np.concatenate([o[2] for o in out])
    # each pair is reached exactly once (unique lowest-common-ancestor seed),
    # but dedup defensively as the reference's procMap does (:1597-1604)
    _, keep = np.unique(A * (3 * n_nodes) + B * 3 + D, return_index=True)
    return A[keep], B[keep], D[keep]


# --------------------------------------------------------------------------
# COO assembly
# --------------------------------------------------------------------------

def _cc_vec(deg):
    d = np.maximum(deg, 0).astype(np.int64)
    return (d + 1) * (d + 2) * (d + 3) // 6


class _LeafView:
    """Host view of a tree with per-leaf flat coefficient offsets (the
    reference's post-ReallocCoeffs coeffsStart, Octree.cpp:535-544)."""

    def __init__(self, tree: Octree):
        self.child_idx = tree.child_idx.cpu().numpy()
        self.centre = tree.centre.cpu().numpy()
        self.depth = tree.depth.cpu().numpy()
        self.degree = tree.degree.cpu().numpy()
        self.n = tree.n_nodes
        widths = np.where(self.degree >= 0, _cc_vec(self.degree), 0)
        widths[self.n:] = 0
        starts = np.zeros(len(widths) + 1, np.int64)
        np.cumsum(widths, out=starts[1:])
        self.coeff_start = starts[:-1]
        self.widths = widths
        self.n_coeffs = int(starts[-1])


@functools.lru_cache(maxsize=None)
def _tangential_match(deg_a: int, deg_b: int, dim: int):
    """(i, j) index pairs whose tangential exponents match -- the nonzero
    pattern of the analytic same-depth blocks (Octree.cpp:1478-1484)."""
    ia = basis.basis_indices(deg_a)
    ib = basis.basis_indices(deg_b)
    t1, t2 = (dim + 1) % 3, (dim + 2) % 3
    eq = ((ia[:, None, t1] == ib[None, :, t1])
          & (ia[:, None, t2] == ib[None, :, t2]))
    i, j = np.nonzero(eq)
    return i.astype(np.int64), j.astype(np.int64)


def _groups(st, a, b, d):
    """Iterate (deg_a, deg_b, dim) -> boolean mask over the pair list."""
    key = (st.degree[a] * 1000 + st.degree[b]) * 10 + d
    for k in np.unique(key):
        m = key == k
        da = int(st.degree[a[m]][0])
        db = int(st.degree[b[m]][0])
        yield da, db, int(d[m][0]), m


# Peak dense elements materialized per emitted block during assembly. At
# degree 12 one cross-depth block is 455^2 = 207k elements, so this budget
# (~64 MB of f64 per intermediate) caps chunks at ~40 pairs: assembly
# memory stays bounded no matter how many face pairs the tree has.
_BLOCK_ELEMS = 1 << 23


def _prune_append(rows, cols, vals, r, c, v):
    """Append COO entries with the reference's EPSILON_F32 pruning applied
    immediately (Octree.cpp:1336-1340), keeping host memory proportional to
    surviving entries rather than dense blocks. ``r``/``c`` may be any
    shape broadcastable to ``v`` (broadcast happens against v's original
    shape, BEFORE raveling)."""
    if r.size != v.size:
        r = np.broadcast_to(r, v.shape)
    if c.size != v.size:
        c = np.broadcast_to(c, v.shape)
    v = v.ravel()
    keep = np.abs(v) > consts.EPSILON_F32
    rows.append(r.ravel()[keep])
    cols.append(c.ravel()[keep])
    vals.append(v[keep])


def _analytic_entries(st, a, b, d, rows, cols, vals):
    """Same-depth blocks (Octree.cpp:1459-1546). With L_p(1)=1 and
    L_p(-1)=(-1)^p: AA[i,j] = n_i n_j, AB[i,j] = -(-1)^{j_d} n_i n_j
    (emitted symmetrically), BB[i,j] = (-1)^{i_d+j_d} n_i n_j, where
    n_p = NormalisedLengths[p_d][depth] and (i,j) range over tangentially
    matching index pairs. Pair chunks bound peak memory (_BLOCK_ELEMS)."""
    nt = basis.norm_table()
    for da, db, dim, m in _groups(st, a, b, d):
        pa_all, pb_all = a[m], b[m]
        ia = basis.basis_indices(da)
        ib = basis.basis_indices(db)
        kmax = max(_tangential_match(da, da, dim)[0].size,
                   _tangential_match(da, db, dim)[0].size,
                   _tangential_match(db, db, dim)[0].size, 1)
        step = max(1, _BLOCK_ELEMS // kmax)
        for s0 in range(0, pa_all.size, step):
            pa = pa_all[s0:s0 + step]
            pb = pb_all[s0:s0 + step]
            dep = st.depth[pa]                    # == depth[pb] here

            def emit(bi_idx, bj_idx, pd_i, pd_j, starts_i, starts_j, sign):
                Ni = nt[pd_i[None, :], dep[:, None]]  # (P, K)
                Nj = nt[pd_j[None, :], dep[:, None]]
                v = sign[None, :] * Ni * Nj           # (P, K)
                r = starts_i[:, None] + bi_idx[None, :]
                c = starts_j[:, None] + bj_idx[None, :]
                _prune_append(rows, cols, vals, r, c, v)

            sA, sB = st.coeff_start[pa], st.coeff_start[pb]
            # AA
            i, j = _tangential_match(da, da, dim)
            emit(i, j, ia[i, dim], ia[j, dim], sA, sA,
                 np.ones(i.size))
            # AB and BA (symmetric)
            i, j = _tangential_match(da, db, dim)
            sgn = -np.where(ib[j, dim] % 2 == 0, 1.0, -1.0)
            emit(i, j, ia[i, dim], ib[j, dim], sA, sB, sgn)
            emit(j, i, ib[j, dim], ia[i, dim], sB, sA, sgn)
            # BB
            i, j = _tangential_match(db, db, dim)
            sgn = np.where((ib[i, dim] + ib[j, dim]) % 2 == 0, 1.0, -1.0)
            emit(i, j, ib[i, dim], ib[j, dim], sB, sB, sgn)


def _numeric_entries(st, a, b, d, rows, cols, vals):
    """Cross-depth blocks via separable 1-D quadrature.

    The reference's 2-D face quadrature (Octree.cpp:1250-1456) factorizes:
    every block entry is (normal factor) * I_t1[p,q] * I_t2[p,q] with
    I[p,q] = sum_x w_x L_p(x_A) L_q(x_B), where the shallower node's sample
    is x*2^-dd + t (the shared sub-face mapped into its frame) and the
    deeper node's sample is x itself.
    """
    nt = basis.norm_table()
    for da, db, dim, m in _groups(st, a, b, d):
        pa_all, pb_all = a[m], b[m]
        Ci = consts.coeff_count(da)
        Cj = consts.coeff_count(db)
        step = max(1, _BLOCK_ELEMS // (Ci * Cj))
        for s0 in range(0, pa_all.size, step):
            _numeric_group(st, nt, pa_all[s0:s0 + step],
                           pb_all[s0:s0 + step], dim, da, db,
                           rows, cols, vals)


def _numeric_group(st, nt, pa, pb, dim, da, db, rows, cols, vals):
    """One bounded chunk of cross-depth pairs sharing (deg_a, deg_b, dim)."""
    if pa.size:
        P = pa.size
        dep_a, dep_b = st.depth[pa], st.depth[pb]
        max_deg = max(da, db)
        x, w = basis.leggauss(basis.face_rule_size(max_deg))
        Q = x.size
        t1, t2 = (dim + 1) % 3, (dim + 2) % 3

        dd_ = np.abs(dep_a - dep_b)
        inv_dist = np.exp2(-dd_.astype(np.float64))
        half_a = np.exp2(-(dep_a.astype(np.float64) + 1.0))
        half_b = np.exp2(-(dep_b.astype(np.float64) + 1.0))
        b_deeper = dep_b > dep_a

        # transformed per-axis samples for each side's local frame
        # (invDist/invTranslation, Octree.cpp:1275-1290)
        xA, xB = {}, {}
        for t in (t1, t2):
            ca, cb = st.centre[pa][:, t], st.centre[pb][:, t]
            off = np.where(b_deeper, (cb - ca) / half_a, (ca - cb) / half_b)
            warp = x[None, :] * inv_dist[:, None] + off[:, None]   # (P, Q)
            raw = np.broadcast_to(x[None, :], (P, Q))
            xA[t] = np.where(b_deeper[:, None], warp, raw)
            xB[t] = np.where(b_deeper[:, None], raw, warp)

        def integ(xs_i, xs_j):
            Li = basis.legendre_all_np(xs_i, max_deg)          # (D+1, P, Q)
            Lj = basis.legendre_all_np(xs_j, max_deg)
            return np.einsum("pnq,rnq,q->npr", Li, Lj, w)      # (P, D+1, D+1)

        I_AA = {t: integ(xA[t], xA[t]) for t in (t1, t2)}
        I_AB = {t: integ(xA[t], xB[t]) for t in (t1, t2)}
        I_BB = {t: integ(xB[t], xB[t]) for t in (t1, t2)}

        area = np.where(b_deeper, half_b, half_a) ** 2          # (P,)

        ia = basis.basis_indices(da)
        ib = basis.basis_indices(db)
        NA = (nt[ia[:, 0][None, :], dep_a[:, None]]
              * nt[ia[:, 1][None, :], dep_a[:, None]]
              * nt[ia[:, 2][None, :], dep_a[:, None]])          # (P, CA)
        NB = (nt[ib[:, 0][None, :], dep_b[:, None]]
              * nt[ib[:, 1][None, :], dep_b[:, None]]
              * nt[ib[:, 2][None, :], dep_b[:, None]])          # (P, CB)
        sA, sB = st.coeff_start[pa], st.coeff_start[pb]

        def emit(bi, bj, I1, I2, fd, starts_i, starts_j, Ni, Nj,
                 transpose=False):
            Bv = (I1[:, bi[:, t1][:, None], bj[:, t1][None, :]]
                  * I2[:, bi[:, t2][:, None], bj[:, t2][None, :]]
                  * fd[None, :, :] * area[:, None, None]
                  * Ni[:, :, None] * Nj[:, None, :])            # (P, Ci, Cj)
            ii = np.arange(bi.shape[0])
            jj = np.arange(bj.shape[0])
            r = starts_i[:, None, None] + ii[None, :, None]
            c = starts_j[:, None, None] + jj[None, None, :]
            r = np.broadcast_to(r, Bv.shape)
            c = np.broadcast_to(c, Bv.shape)
            if transpose:
                r, c = c, r
            _prune_append(rows, cols, vals, r, c, Bv)

        sgn_i_b = np.where(ib[:, dim] % 2 == 0, 1.0, -1.0)
        # AA: L_i(1) L_j(1) = 1
        emit(ia, ia, I_AA[t1], I_AA[t2],
             np.ones((ia.shape[0], ia.shape[0])), sA, sA, NA, NA)
        # AB: -L_i(1) L_j(-1) = -(-1)^{j_d}, emitted with its transpose
        fd_ab = -np.ones((ia.shape[0], 1)) * sgn_i_b[None, :]
        emit(ia, ib, I_AB[t1], I_AB[t2], fd_ab, sA, sB, NA, NB)
        emit(ia, ib, I_AB[t1], I_AB[t2], fd_ab, sA, sB, NA, NB,
             transpose=True)
        # BB: L_i(-1) L_j(-1) = (-1)^{i_d+j_d}
        fd_bb = sgn_i_b[:, None] * sgn_i_b[None, :]
        emit(ib, ib, I_BB[t1], I_BB[t2], fd_bb, sB, sB, NB, NB)


def assemble_face_matrix(tree: Octree):
    """COO (rows, cols, vals) of the face-jump Gram matrix M, as host numpy,
    plus the leaf view used for coefficient packing."""
    st = _LeafView(tree)
    a, b, d = leaf_face_pairs(st.child_idx, st.n)
    rows: list = []
    cols: list = []
    vals: list = []
    if a.size:
        same = st.depth[a] == st.depth[b]
        if same.any():
            _analytic_entries(st, a[same], b[same], d[same], rows, cols, vals)
        if (~same).any():
            _numeric_entries(st, a[~same], b[~same], d[~same],
                             rows, cols, vals)
    if rows:
        # every chunk was already EPSILON_F32-pruned on emission
        R = np.concatenate(rows)
        C = np.concatenate(cols)
        V = np.concatenate(vals)
    else:
        R = np.zeros(0, np.int64)
        C = np.zeros(0, np.int64)
        V = np.zeros(0, np.float64)
    return st, R, C, V


# --------------------------------------------------------------------------
# The face operator: M without its same-depth entries
# --------------------------------------------------------------------------

class FaceOperator(NamedTuple):
    """M + sI as K9 reads it, without a same-depth matrix entry.

    Every same-depth entry is sign * n_i * n_j over a tangential-match
    pattern, n_p = ``basis.norm_table()[p, depth]`` (``_analytic_entries``),
    so a leaf needs only its same-depth neighbours:

      * ``leaves`` (L, 4) i32, a row per leaf in node order: its row block
        [start, end), ``degree | depth << 8``, and the offset of its rows
        in the cross-depth CSR (-1 where it has none);
      * ``slots`` (L, 6, 2) i32: for face 2d + side of a leaf (side 0: the
        neighbour lies on its + side along d, the leaf is the pair's A;
        side 1: on its - side), the same-depth neighbour's row start and
        degree, or -1;
      * the cross-depth blocks (``_numeric_entries``, EPSILON_F32-pruned)
        with duplicate (row, col) entries summed, as a CSR over the rows of
        the leaves that have any: ``xrowptr``, ``xcols`` (i32), ``xvals``
        (f64).

    ``n`` rows; ``nnz`` the entries of the COO it stands for, as
    ``assemble_face_matrix`` counts them; ``widest`` the widest row block;
    ``host_starts`` the leaves' row starts and n, host numpy, from which
    the persistent launch sizes its groups' shared memory."""
    leaves: object
    slots: object
    xrowptr: object
    xcols: object
    xvals: object
    n: int
    nnz: int
    widest: int
    host_starts: np.ndarray

    @property
    def group(self) -> int:
        """The lanes K9 gives a leaf, a lane a row: the widest block's rows,
        at most a warp's 32 (a lane then loops over the rows)."""
        return min(32, self.widest)

    def to(self, device) -> "FaceOperator":
        """The operator's arrays on ``device`` (``_put``)."""
        return self._replace(**dict(zip(self._fields[:5],
                                        _put(device, *self[:5]))))


def face_operator(st: _LeafView, a, b, d, s: float):
    """The face operator of the pairs (a, b, d) (``leaf_face_pairs``), host
    numpy, and the Jacobi diagonal of M + sI: s, plus n_{i_d}^2 for every
    same-depth face of row i's leaf (AA and BB both give it), plus the
    cross-depth diagonal entries. Only the cross-depth pairs are assembled
    (``_numeric_entries``); no same-depth entry is."""
    n = st.n_coeffs
    if n >= 2 ** 31:
        raise ValueError(f"face_operator: {n} rows exceed 32-bit indices")
    leaf_ids = np.flatnonzero(st.degree[: st.n] >= 0)
    L = leaf_ids.size
    pos = np.full(st.child_idx.shape[0], -1, np.int64)
    pos[leaf_ids] = np.arange(L)
    start = st.coeff_start[leaf_ids]
    width = st.widths[leaf_ids]
    deg = st.degree[leaf_ids].astype(np.int64)
    dep = st.depth[leaf_ids].astype(np.int64)

    same = st.depth[a] == st.depth[b]
    sa, sb, sd = a[same], b[same], d[same]
    slots = np.full((L, 6, 2), -1, np.int32)
    for own, nbr, side in ((sa, sb, 0), (sb, sa, 1)):
        li, sl = pos[own], 2 * sd.astype(np.int64) + side
        slots[li, sl, 0] = st.coeff_start[nbr]
        slots[li, sl, 1] = st.degree[nbr]
    if int((slots[:, :, 0] >= 0).sum()) != 2 * sa.size:
        raise AssertionError("face_operator: two same-depth neighbours "
                             "across one face")
    # the COO's same-depth entries: the AA, AB, BA and BB patterns' sizes
    groups = np.bincount((st.degree[sa].astype(np.int64) * 13
                          + st.degree[sb]) * 3 + sd, minlength=13 * 13 * 3)
    nnz = sum(int(groups[k]) * sum(
        _tangential_match(i, j, k % 3)[0].size * w
        for i, j, w in ((k // 39, k // 39, 1), (k // 39, k // 3 % 13, 2),
                        (k // 3 % 13, k // 3 % 13, 1)))
        for k in np.flatnonzero(groups))

    rows: list = []
    cols: list = []
    vals: list = []
    if (~same).any():
        _numeric_entries(st, a[~same], b[~same], d[~same], rows, cols, vals)
    R = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    C = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    V = np.concatenate(vals) if vals else np.zeros(0, np.float64)
    nnz += R.size
    # sorted by (row, col), duplicates summed in COO order
    order = np.argsort(R * n + C, kind="stable")
    key = (R * n + C)[order]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]]) if key.size \
        else np.zeros(0, np.int64)
    xvals = np.add.reduceat(V[order], first) if key.size else V
    mr, mc = key[first] // n, key[first] % n
    if xvals.size >= 2 ** 31:
        raise ValueError(f"face_operator: {xvals.size} cross-depth entries "
                         "exceed 32-bit indices")
    # a CSR over the rows of the leaves with cross-depth entries
    leaf_of = np.searchsorted(start, mr, side="right") - 1
    xleaf = np.unique(leaf_of)
    xoff = np.full(L, -1, np.int64)
    xoff[xleaf] = np.cumsum(width[xleaf]) - width[xleaf]
    xrows = int(width[xleaf].sum())
    xrowptr = np.zeros(xrows + 1, np.int64)
    np.cumsum(np.bincount(xoff[leaf_of] + mr - start[leaf_of],
                          minlength=xrows), out=xrowptr[1:])

    # s, then n_k^2 face by face in slot order: for each degree and depth, a
    # table of the 64 sets of faces a leaf may have
    diag = np.empty(n, np.float64)
    nt = basis.norm_table()
    faces = ((slots[:, :, 0] >= 0) << np.arange(6)).sum(1)
    kind = deg * 64 + dep
    for key in np.unique(kind):
        li = np.flatnonzero(kind == key)
        e = basis.basis_indices(int(key // 64))
        table = np.full((64, e.shape[0]), s, np.float64)
        for slot in range(6):
            nk = nt[e[:, slot // 2], key % 64]
            table += (np.arange(64)[:, None] >> slot & 1) * (nk * nk)
        if li.size == L and width[0] * L == n:     # one kind: rows in order
            diag[:] = table[faces].ravel()
        else:
            diag[start[li][:, None] + np.arange(e.shape[0])] = \
                table[faces[li]]
    on = mr == mc
    diag[mr[on]] += xvals[on]

    leaves = np.stack([start, start + width, deg | dep << 8, xoff],
                      1).astype(np.int32)
    return FaceOperator(
        leaves, slots, xrowptr.astype(np.int32), mc.astype(np.int32), xvals,
        n=n, nnz=nnz, widest=int(max(1, width.max(initial=1))),
        host_starts=np.append(start, n)), diag


def face_matvec_plain(op: FaceOperator, s: float, p: torch.Tensor):
    """K9's function on the face operator, whatever the device: y = M p +
    s p and p.y. For each face 2d + side and pair of degrees, the jump
    across the face is J = v_own - v_nbr on every tangential mode (t1, t2),
    v = sum over the normal exponent k of L_k(face) n_k p_k (gathers and an
    ``index_add_`` over the modes), and row k of the leaf takes L_k(face)
    n_k J (``index_add_``); the cross-depth CSR adds its entries. J^T J is
    the AA, AB, BA and BB blocks of ``_analytic_entries``."""
    dev = p.device
    leaves = op.leaves.long()
    start, meta = leaves[:, 0], leaves[:, 2]
    deg, dep = meta & 255, meta >> 8
    slots = op.slots.long()
    nt = torch.as_tensor(basis.norm_table(), device=dev)
    y = s * p
    for D in torch.unique(deg).tolist():
        own = torch.nonzero(deg == D).flatten()
        for slot in range(6):
            dim, low = slot // 2, slot % 2 == 0
            nb = slots[own, slot]
            for D2 in torch.unique(nb[nb[:, 0] >= 0, 1]).tolist():
                m = own[(nb[:, 0] >= 0) & (nb[:, 1] == D2)]
                rows, w, mode = _face_side(start[m], dep[m], D, dim, low, nt)
                rows2, w2, mode2 = _face_side(slots[m, slot, 0], dep[m], D2,
                                              dim, not low, nt)
                v = torch.zeros(m.shape[0], 13 * 13, dtype=p.dtype,
                                device=dev)
                v.index_add_(1, mode, w * p[rows])
                v.index_add_(1, mode2, -(w2 * p[rows2]))
                y.index_add_(0, rows.flatten(), (w * v[:, mode]).flatten())
    if op.xvals.shape[0]:
        xl = torch.nonzero(leaves[:, 3] >= 0).flatten()
        width = leaves[xl, 1] - leaves[xl, 0]
        xrow_of = (torch.repeat_interleave(leaves[xl, 0] - leaves[xl, 3],
                                           width)
                   + torch.arange(int(width.sum()), device=dev))
        r = torch.repeat_interleave(xrow_of, op.xrowptr.long().diff())
        y.index_add_(0, r, op.xvals * p[op.xcols.long()])
    return y, torch.dot(p, y)


def _face_side(start, dep, D: int, dim: int, low: bool, nt):
    """One side of a face for ``face_matvec_plain``: its leaves' rows (E,
    C), the weights L_k(face) n_k of each row (the side's face is at +1 in
    its frame if it is the low side, else at -1, where L_k = (-1)^k), and
    the tangential mode of each row."""
    e = torch.as_tensor(basis.basis_indices(D), device=start.device).long()
    k = e[:, dim]
    sign = torch.ones_like(k) if low else 1 - 2 * (k % 2)
    mode = e[:, (dim + 1) % 3] * 13 + e[:, (dim + 2) % 3]
    w = sign * nt[k[None, :], dep[:, None]]
    return start[:, None] + torch.arange(e.shape[0], device=start.device), \
        w, mode


# --------------------------------------------------------------------------
# The CG iteration: K9 and K9u, and their plain versions
# --------------------------------------------------------------------------

class Csr(NamedTuple):
    """The COO sorted by row on its device: ``rowptr`` (n + 1) and ``cols``
    (i32), ``vals`` (f64)."""
    rowptr: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    @property
    def n(self) -> int:
        return self.rowptr.shape[0] - 1


def csr(R: torch.Tensor, C: torch.Tensor, V: torch.Tensor, n: int) -> Csr:
    """Sort the COO (R, C, V) by row once on its device (``torch.sort``,
    stable: a row's entries keep their COO order), count the rows
    (``torch.bincount``) and take their offsets (``cumsum``)."""
    if R.shape[0] >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"csr: {R.shape[0]} entries in {n} rows exceed "
                         "32-bit indices")
    rows, order = torch.sort(R, stable=True)
    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=R.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return Csr(rowptr.to(torch.int32), C[order].to(torch.int32), V[order])


def cg_matvec_plain(R: torch.Tensor, C: torch.Tensor, V: torch.Tensor,
                    s: float, p: torch.Tensor):
    """K9's function on the COO, whatever the device: y = M p + s p
    (``index_add_``, as the reference's ``segment_sum(V * p[C], R) + s *
    p``) and p.y."""
    y = torch.zeros_like(p).index_add_(0, R, V * p[C]) + s * p
    return y, torch.dot(p, y)


def cg_update_plain(alpha, rz, p: torch.Tensor, Ap: torch.Tensor,
                    minv: torch.Tensor, x: torch.Tensor, r: torch.Tensor):
    """K9u's function, whatever the device: x + alpha p, r - alpha Ap, the
    new direction z + (rz_new / rz) p with z = minv r, rz_new = r.z and
    r.r."""
    x = x + alpha * p
    r = r - alpha * Ap
    z = minv * r
    rz_new = torch.dot(r, z)
    return x, r, z + (rz_new / rz) * p, rz_new, torch.dot(r, r)


# The f64 scalars of the kernels' state (csrc/continuity.cu kRz ...
# kRzOld): rz_part and rr_part are a rank's r.z and r.r in the row-sharded
# CG, before and after their all-reduce; rz_old is rz as K9u's first launch
# found it, which its second divides by
_SC = dict(rz=0, alpha=1, beta=2, rr=3, thresh=4, pap=5, rz_part=6,
           rr_part=7, rz_old=8)
# and its integers (kK ... kLive): iterations, max_iter, flag, block count,
# and the flag as K9u's first launch found it, which its second tests
_ST = dict(k=0, max_iter=1, active=2, count=3, live=4)
# threads a block of K9 and of the persistent launch (csrc/continuity.cu
# kThreads)
_BLOCK_THREADS = 256


class _State(NamedTuple):
    """The kernels' state on the card and the partial sums of a launch."""
    sc: torch.Tensor          # f64 [len(_SC)]
    st: torch.Tensor          # i32 [len(_ST)]
    partials: torch.Tensor    # f64

    @classmethod
    def new(cls, device, thresh, max_iter: int, alpha=0.0, rz=0.0):
        sc = torch.zeros(len(_SC), dtype=torch.float64, device=device)
        sc[_SC["alpha"]] = alpha
        sc[_SC["rz"]] = sc[_SC["rz_old"]] = rz
        sc[_SC["thresh"]] = thresh
        st = torch.tensor([0, max_iter, 1, 0, 1], dtype=torch.int32,
                          device=device)
        lib = _kernels.load()
        partials = torch.empty(lib.hpsdf_cg_scratch() // 8,
                               dtype=torch.float64, device=device)
        return cls(sc, st, partials)


def _check_cuda(name, dtype, n, *tensors):
    """Each tensor a contiguous CUDA tensor of ``dtype`` and n entries."""
    for t in tensors:
        if t.device.type != "cuda" or t.dtype != dtype:
            raise ValueError(f"{name}: needs {dtype} CUDA tensors, got "
                             f"{t.dtype} on {t.device}")
        if t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous ({n}, ...) tensors, "
                             f"got {tuple(t.shape)}")


def _face_args(name, op: FaceOperator):
    """The face operator's pointers and sizes as the C side takes them,
    after checking its tensors."""
    L = op.leaves.shape[0]
    _check_cuda(name, torch.int32, L, op.leaves, op.slots)
    _check_cuda(name, torch.int32, op.xrowptr.shape[0], op.xrowptr)
    _check_cuda(name, torch.int32, op.xvals.shape[0], op.xcols)
    _check_cuda(name, torch.float64, op.xcols.shape[0], op.xvals)
    if op.leaves.shape[1:] != (4,) or op.slots.shape[1:] != (6, 2):
        raise ValueError(f"{name}: leaves (L, 4) and slots (L, 6, 2), got "
                         f"{tuple(op.leaves.shape)}, {tuple(op.slots.shape)}")
    return (op.leaves.data_ptr(), op.slots.data_ptr(), op.xrowptr.data_ptr(),
            op.xcols.data_ptr(), op.xvals.data_ptr(), L, op.group,
            op.widest)


def _matvec_launch(A, s: float, p, y, state: _State):
    """K9 once on the face operator, or in its CSR form of PR 10 on a
    ``Csr``."""
    lib = _kernels.load()
    _check_cuda("cg_matvec", torch.float64, A.n, p, y)
    if isinstance(A, Csr):
        _check_cuda("cg_matvec", torch.int32, A.n + 1, A.rowptr)
        _check_cuda("cg_matvec", torch.int32, A.vals.shape[0], A.cols)
        _check_cuda("cg_matvec", torch.float64, A.cols.shape[0], A.vals)
        rc = lib.hpsdf_cg_matvec(
            A.rowptr.data_ptr(), A.cols.data_ptr(), A.vals.data_ptr(), A.n,
            float(s), p.data_ptr(), y.data_ptr(), state.partials.data_ptr(),
            state.sc.data_ptr(), state.st.data_ptr(), _kernels.stream_of(p))
    else:
        rc = lib.hpsdf_face_matvec(
            *_face_args("cg_matvec", A), A.n, float(s), p.data_ptr(),
            y.data_ptr(), state.partials.data_ptr(), state.sc.data_ptr(),
            state.st.data_ptr(), _kernels.stream_of(p))
    _kernels.check(lib, rc, "cg_matvec")
    cg_matvec.launches += 1


def _update_launch(init: bool, Ap, minv, x, r, p, state: _State):
    _check_cuda("cg_update", torch.float64, minv.shape[0], Ap, minv, x, r,
                p)
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_cg_update(
        int(init), minv.shape[0], Ap.data_ptr(), minv.data_ptr(),
        x.data_ptr(), r.data_ptr(), p.data_ptr(), state.partials.data_ptr(),
        state.sc.data_ptr(), state.st.data_ptr(), _kernels.stream_of(minv)),
        "cg_update")
    cg_update.launches += 1


class _Plan(NamedTuple):
    """The persistent launch's blocks and the doubles of shared memory each
    group of lanes keeps y of its leaves' rows in (0: y in a buffer of n on
    the card)."""
    blocks: int
    cap: int


def _chunk_plan(op: FaceOperator) -> _Plan:
    """As many blocks as stay resident together, no more than give each
    group of lanes a leaf. Group g of the launch's T owns leaves g, g + T,
    ...; y of their rows stays in shared memory where the card holds every
    block's at once (``hpsdf_cg_chunk_blocks``: the blocks that stay
    resident with that much shared memory, 0 if a block cannot have it)."""
    lib = _kernels.load()
    width = np.diff(op.host_starts)
    L = width.size
    per_block = _BLOCK_THREADS // 32 * (32 // op.group)

    def cap(blocks):
        T = blocks * per_block
        return int(np.bincount(np.arange(L) % T, weights=width,
                               minlength=T).max())

    most = max(1, min(lib.hpsdf_cg_chunk_blocks(0), -(-L // per_block)))
    blocks = most
    while True:
        fit = lib.hpsdf_cg_chunk_blocks(per_block * cap(blocks) * 8)
        if fit >= blocks:
            return _Plan(blocks, cap(blocks))
        if fit == 0:            # y through a buffer on the card
            return _Plan(most, 0)
        blocks = fit


def _chunk_launch(op: FaceOperator, plan: _Plan, s: float, minv, x, r, p, y,
                  state: _State, iters: int):
    """``iters`` iterations in one persistent cooperative launch
    (``cg_chunk_kernel``): K9's matvec and K9u's update as phases between
    grid barriers. Counted in ``_chunk_launch.launches``, apart from K9's
    and K9u's own launches."""
    _check_cuda("cg_chunk", torch.float64, op.n, minv, x, r, p, y)
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_cg_chunk(
        *_face_args("cg_chunk", op), op.n, plan.blocks, plan.cap, float(s),
        minv.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
        y.data_ptr(), state.partials.data_ptr(), state.sc.data_ptr(),
        state.st.data_ptr(), iters, _kernels.stream_of(minv)), "cg_chunk")
    _chunk_launch.launches += 1


_chunk_launch.launches = 0


def cg_matvec(A, s: float, p: torch.Tensor):
    """K9 once: (y, p.y) with y = M p + s p, M a ``FaceOperator`` (or PR
    10's ``Csr`` form). Kernel K9 on CUDA tensors (p.y as a 0-d tensor on
    the card); on CPU tensors the plain version, ``face_matvec_plain`` or
    ``cg_matvec_plain`` on the COO."""
    if p.device.type == "cpu":
        if not isinstance(A, Csr):
            return face_matvec_plain(A, s, p)
        rows = torch.repeat_interleave(torch.arange(A.n),
                                       A.rowptr.diff().long())
        return cg_matvec_plain(rows, A.cols.long(), A.vals, s, p)
    state = _State.new(p.device, 0.0, 1)
    y = torch.empty_like(p)
    _matvec_launch(A, s, p, y, state)
    return y, state.sc[_SC["pap"]]


def cg_update(alpha, rz, p: torch.Tensor, Ap: torch.Tensor,
              minv: torch.Tensor, x: torch.Tensor, r: torch.Tensor):
    """K9u once: (x + alpha p, r - alpha Ap, the new direction, r.z, r.r),
    as ``cg_update_plain``. Kernel K9u on CUDA tensors (x, r and p are
    copied first; the dot products as 0-d tensors on the card); the plain
    version on CPU tensors."""
    if minv.device.type == "cpu":
        return cg_update_plain(alpha, rz, p, Ap, minv, x, r)
    state = _State.new(minv.device, -1.0, 2 ** 31 - 1, alpha=alpha, rz=rz)
    x, r, p = x.clone(), r.clone(), p.clone()
    _update_launch(False, Ap, minv, x, r, p, state)
    return x, r, p, state.sc[_SC["rz"]], state.sc[_SC["rr"]]


cg_matvec.launches = 0
cg_update.launches = 0

# iterations between two reads of the kernels' flag
CG_CHUNK = 32


def _cg_kernels(op: FaceOperator, s: float, diag, b, x0, tol: float,
                max_iter: int):
    """The CG on the card: (x, iterations, residual) as ``_cg_plain``.
    After a K9 and a K9u launch that start it, CG_CHUNK iterations go out
    at a time in one persistent launch (``_chunk_launch``), which returns at
    once when the flag is down. The host reads the flag of the chunk before
    while the card runs this one: one host sync a chunk, and one for the
    result."""
    state = _State.new(b.device, 0.0, max_iter)
    state.sc[_SC["thresh"]] = tol * tol * torch.dot(b, b)
    minv = 1.0 / diag
    y = torch.empty_like(b)
    _matvec_launch(op, s, x0, y, state)        # y = (M + sI) x0
    x, r, p = x0.clone(), b - y, torch.empty_like(b)
    _update_launch(True, y, minv, x, r, p, state)
    flags = [torch.empty(len(_ST), dtype=torch.int32, pin_memory=True)
             for _ in range(2)]
    events = [torch.cuda.Event(), torch.cuda.Event()]
    plan = _chunk_plan(op)
    j = 0
    while True:
        _chunk_launch(op, plan, s, minv, x, r, p, y, state, CG_CHUNK)
        flags[j % 2].copy_(state.st, non_blocking=True)
        events[j % 2].record()
        if j:
            events[(j - 1) % 2].synchronize()
            _cg_kernels.host_syncs += 1
            if not flags[(j - 1) % 2][_ST["active"]]:
                break
        j += 1
    events[j % 2].synchronize()
    _cg_kernels.host_syncs += 1
    st = flags[j % 2]
    return x, int(st[_ST["k"]]), float(torch.sqrt(state.sc[_SC["rr"]]))


_cg_kernels.host_syncs = 0


def _cg_plain(matvec, diag, b, x0, tol, max_iter: int):
    """The CG of ``hpsdf_tpu.continuity._cg_solve`` by the plain versions,
    ``matvec(p)`` giving (M + sI) p and p.(M + sI) p, whatever the device
    (one host sync an iteration on a card): the same recurrences and
    stopping rule."""
    minv = 1.0 / diag
    y, _ = matvec(x0)
    x, r = x0, b - y
    p = minv * r
    rz, rr = torch.dot(r, p), torch.dot(r, r)
    thresh = tol * tol * torch.dot(b, b)
    k = 0
    while bool(rr > thresh) and k < max_iter:
        Ap, pap = matvec(p)
        x, r, p, rz, rr = cg_update_plain(rz / pap, rz, p, Ap, minv, x, r)
        k += 1
    return x, k, float(torch.sqrt(rr))


def _cg_solve_plain(R, C, V, s, diag, b, x0, n: int, tol, max_iter: int):
    """Jacobi-preconditioned CG on (M + sI) x = b, M in COO form (R, C
    int64, V f64, all on one device): ``hpsdf_tpu.continuity._cg_solve`` by
    ``_cg_plain`` on the COO (``cg_matvec_plain``), the stopping rule r.r >
    tol^2 b.b and k < max_iter. Returns (x, iterations, residual = |r|)."""
    return _cg_plain(lambda p: cg_matvec_plain(R, C, V, s, p), diag, b, x0,
                     tol, max_iter)


def cg_solve(op: FaceOperator, s, diag, b, x0, tol, max_iter: int):
    """The same CG on the face operator: the kernels on a CUDA device
    (``_cg_kernels``), ``face_matvec_plain`` on the CPU."""
    if b.device.type == "cpu":
        return _cg_plain(lambda p: face_matvec_plain(op, s, p), diag, b, x0,
                         tol, max_iter)
    return _cg_kernels(op, s, diag, b, x0, tol, max_iter)


# --------------------------------------------------------------------------
# The row-sharded CG: K9's partial mode and K9u's two launches
# --------------------------------------------------------------------------

class RowBlock(NamedTuple):
    """A rank's share of the face operator in the row-sharded CG.

    The ranks own contiguous blocks of leaves balanced by rows, a leaf never
    split (K9 gives a leaf to a group of lanes). Every rank's vectors are
    padded to ``width`` rows, so that p gathers into equal blocks: global
    row g of rank k's block sits at k * width + g - (k's first row).
    ``op`` holds the rank's leaves with their rows, their same-depth
    neighbours' rows and their cross-depth columns in that gathered layout
    (its ``n`` the gathered length, size * width); ``lo`` and ``rows`` give
    the rank's global rows, ``row0`` = rank * width where they start in the
    gathered vector, and ``order`` (host) the gathered index of every
    global row."""
    op: FaceOperator
    lo: int
    rows: int
    width: int
    row0: int
    order: np.ndarray

    def to(self, device) -> "RowBlock":
        return self._replace(op=self.op.to(device))


def row_cuts(starts: np.ndarray, size: int) -> np.ndarray:
    """The first leaf of each of ``size`` contiguous blocks, and the leaf
    count (size + 1,): each block starts at the leaf whose first row is the
    first at or past an equal share of the rows, and holds one leaf at
    least. ``starts`` the leaves' first rows and n (L + 1,)."""
    L = starts.size - 1
    if L < size:
        raise ValueError(f"row-sharded CG: {L} leaves for {size} ranks")
    cuts = np.searchsorted(starts[:L], np.arange(size + 1) * starts[L] / size)
    cuts[0], cuts[size] = 0, L
    for k in range(1, size):
        cuts[k] = min(max(cuts[k], cuts[k - 1] + 1), L - (size - k))
    return cuts


def row_block(op: FaceOperator, size: int, rank: int) -> RowBlock:
    """Rank ``rank``'s block of the host face operator ``op`` (``RowBlock``):
    its leaves (``row_cuts``), their row starts, their neighbours' starts
    and their cross-depth columns remapped once to the gathered layout, and
    their stretch of the cross-depth CSR."""
    starts = op.host_starts.astype(np.int64)
    cuts = row_cuts(starts, size)
    first = starts[cuts]                                   # (size + 1,)
    width = int(np.diff(first).max())
    if size * width >= 2 ** 31:
        raise ValueError(f"row_block: {size} x {width} rows exceed 32-bit "
                         "indices")

    def remap(g):
        k = np.searchsorted(first, g, side="right") - 1
        return (k * width + g - first[k]).astype(np.int32)

    l0, l1 = int(cuts[rank]), int(cuts[rank + 1])
    leaves = np.array(op.leaves[l0:l1], np.int32)
    w = leaves[:, 1] - leaves[:, 0]
    leaves[:, 0] = remap(leaves[:, 0].astype(np.int64))
    leaves[:, 1] = leaves[:, 0] + w
    slots = np.array(op.slots[l0:l1], np.int32)
    has = slots[:, :, 0] >= 0
    slots[:, :, 0][has] = remap(slots[:, :, 0][has].astype(np.int64))
    xoff = leaves[:, 3]
    xl = np.flatnonzero(xoff >= 0)
    if xl.size:                 # the rank's cross-depth rows are contiguous
        x0, x1 = int(xoff[xl[0]]), int(xoff[xl[-1]] + w[xl[-1]])
        e0, e1 = int(op.xrowptr[x0]), int(op.xrowptr[x1])
        xrowptr = (op.xrowptr[x0:x1 + 1] - e0).astype(np.int32)
        xcols = remap(np.asarray(op.xcols[e0:e1], np.int64))
        xvals = np.asarray(op.xvals[e0:e1], np.float64)
        leaves[xl, 3] -= x0
    else:
        xrowptr = np.zeros(1, np.int32)
        xcols, xvals = np.zeros(0, np.int32), np.zeros(0, np.float64)
    order = np.concatenate([k * width + np.arange(first[k + 1] - first[k])
                            for k in range(size)])
    return RowBlock(
        FaceOperator(leaves, slots, xrowptr, xcols, xvals, n=size * width,
                     nnz=op.nnz, widest=int(max(1, w.max(initial=1))),
                     host_starts=np.append(leaves[:, 0], leaves[-1, 1])),
        lo=int(first[rank]), rows=int(first[rank + 1] - first[rank]),
        width=width, row0=rank * width, order=order)


def face_matvec_rows_plain(blk: RowBlock, s: float, p: torch.Tensor):
    """K9's partial mode, whatever the device: y = M p + s p on the rank's
    rows (p the gathered vector, y of the rank's ``rows``) and the rank's
    share of p.y."""
    y = face_matvec_plain(blk.op, s, p)[0][blk.row0: blk.row0 + blk.rows]
    return y, torch.dot(p[blk.row0: blk.row0 + blk.rows], y)


def cg_update_rows_plain(init: bool, rz, pap, p, Ap, minv, x, r):
    """K9u's first launch in the row-sharded CG, whatever the device:
    alpha = rz / p.Ap, x + alpha p and r - alpha Ap (the first form: x and
    r as they are), z = minv r, and the rank's r.z and r.r."""
    if not init:
        alpha = rz / pap
        x = x + alpha * p
        r = r - alpha * Ap
    z = minv * r
    return x, r, z, torch.dot(r, z), torch.dot(r, r)


def cg_direction_plain(init: bool, rz, rz_new, z, p):
    """K9u's second launch, whatever the device: z + (rz_new / rz) p (the
    first form: z)."""
    return z.clone() if init else z + (rz_new / rz) * p


def _matvec_rows_launch(blk: RowBlock, s: float, p, y, state: _State):
    """K9's partial mode once: y (the rank's rows) and its p.y into
    sc[pap]."""
    lib = _kernels.load()
    _check_cuda("cg_matvec_rows", torch.float64, blk.op.n, p)
    if y.shape[0] < blk.rows:
        raise ValueError(f"cg_matvec_rows: y holds {y.shape[0]} of the "
                         f"rank's {blk.rows} rows")
    _check_cuda("cg_matvec_rows", torch.float64, y.shape[0], y)
    _kernels.check(lib, lib.hpsdf_face_matvec_rows(
        *_face_args("cg_matvec_rows", blk.op), blk.row0, float(s),
        p.data_ptr(), y.data_ptr(), state.partials.data_ptr(),
        state.sc.data_ptr(), state.st.data_ptr(), _kernels.stream_of(p)),
        "cg_matvec_rows")
    cg_matvec_rows.launches += 1


def _check_aligned(name, *tensors):
    """Each tensor's data 16-byte aligned (K9u's launches read rows in
    pairs)."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: needs 16-byte aligned tensors")


def _aligned(t):
    """t, or a copy of it where its data is not 16-byte aligned."""
    return t.clone() if t.data_ptr() % 16 else t


def _update_rows_launch(init: bool, n: int, Ap, minv, x, r, p, z,
                        state: _State):
    """K9u's first launch once over the first n rows."""
    _check_cuda("cg_update_rows", torch.float64, minv.shape[0], Ap, minv, x,
                r, p, z)
    _check_aligned("cg_update_rows", Ap, minv, x, r, p, z)
    if not 0 < n <= minv.shape[0]:
        raise ValueError(f"cg_update_rows: {n} rows of {minv.shape[0]}")
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_cg_update_rows(
        int(init), n, Ap.data_ptr(), minv.data_ptr(), x.data_ptr(),
        r.data_ptr(), p.data_ptr(), z.data_ptr(), state.partials.data_ptr(),
        state.sc.data_ptr(), state.st.data_ptr(), _kernels.stream_of(minv)),
        "cg_update_rows")
    cg_update_rows.launches += 1


def _direction_launch(init: bool, n: int, z, p, state: _State):
    """K9u's second launch once over the first n rows."""
    _check_cuda("cg_direction", torch.float64, z.shape[0], z, p)
    _check_aligned("cg_direction", z, p)
    if not 0 < n <= z.shape[0]:
        raise ValueError(f"cg_direction: {n} rows of {z.shape[0]}")
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_cg_direction(
        int(init), n, z.data_ptr(), p.data_ptr(), state.sc.data_ptr(),
        state.st.data_ptr(), _kernels.stream_of(z)), "cg_direction")
    cg_direction.launches += 1


def cg_matvec_rows(blk: RowBlock, s: float, p: torch.Tensor):
    """K9's partial mode once: (y, the rank's p.y) on the rank's rows of the
    gathered ``p``. Kernel K9 on CUDA tensors (p.y as a 0-d tensor on the
    card); ``face_matvec_rows_plain`` on CPU tensors."""
    if p.device.type == "cpu":
        return face_matvec_rows_plain(blk, s, p)
    state = _State.new(p.device, 0.0, 1)
    y = torch.empty(blk.rows, dtype=p.dtype, device=p.device)
    _matvec_rows_launch(blk, s, p, y, state)
    return y, state.sc[_SC["pap"]]


def cg_update_rows(init: bool, rz, pap, p, Ap, minv, x, r):
    """K9u's first launch once, as ``cg_update_rows_plain``: (x, r, z, r.z,
    r.r). Kernel K9u on CUDA tensors (x and r are copied first, and any
    input not 16-byte aligned; the dots as 0-d tensors on the card); the
    plain version on CPU tensors."""
    if minv.device.type == "cpu":
        return cg_update_rows_plain(init, rz, pap, p, Ap, minv, x, r)
    state = _State.new(minv.device, 0.0, 1, rz=0.0 if init else rz)
    state.sc[_SC["pap"]] = 1.0 if init else pap
    x, r, z = x.clone(), r.clone(), torch.empty_like(r)
    p = torch.zeros_like(r) if p is None else _aligned(p)
    _update_rows_launch(init, minv.shape[0], r if Ap is None else _aligned(Ap),
                        _aligned(minv), x, r, p, z, state)
    return x, r, z, state.sc[_SC["rz_part"]], state.sc[_SC["rr_part"]]


def cg_direction(init: bool, rz, rz_new, z, p):
    """K9u's second launch once, as ``cg_direction_plain``. Kernel K9u on
    CUDA tensors (p is copied first, and z where it is not 16-byte
    aligned); the plain version on CPU tensors."""
    if z.device.type == "cpu":
        return cg_direction_plain(init, rz, rz_new, z, p)
    state = _State.new(z.device, 0.0, 2 ** 31 - 1, rz=rz)
    state.sc[_SC["rz_part"]] = rz_new
    p = p.clone()
    _direction_launch(init, z.shape[0], _aligned(z), p, state)
    return p


cg_matvec_rows.launches = 0
cg_update_rows.launches = 0
cg_direction.launches = 0


def _cg_rows_plain(blk: RowBlock, s: float, diag, b, x0, tol: float,
                   max_iter: int, shard):
    """The row-sharded CG by the plain versions, whatever the device: the
    recurrences and stopping rule of ``_cg_plain`` on the rank's padded
    vectors, p all-gathered for each matvec and every dot all-reduced (one
    host read an iteration). Returns (x of the rank's rows, iterations,
    residual)."""
    from . import parallel

    def matvec(v):
        y, pap = face_matvec_rows_plain(blk, s, parallel.all_gather(v, shard))
        return torch.cat([y, y.new_zeros(blk.width - blk.rows)]), pap

    def reduce(*v):
        return parallel.all_reduce(torch.stack(v), shard)

    minv = 1.0 / diag
    y, _ = matvec(x0)
    x, r, z, rz, rr = cg_update_rows_plain(True, None, None, None, None,
                                           minv, x0, b - y)
    rz, rr = reduce(rz, rr)
    p = cg_direction_plain(True, rz, rz, z, None)
    thresh = tol * tol * reduce(torch.dot(b, b))[0]
    k = 0
    while bool(rr > thresh) and k < max_iter:
        Ap, pap = matvec(p)
        x, r, z, rz_new, rr = cg_update_rows_plain(False, rz, reduce(pap)[0],
                                                   p, Ap, minv, x, r)
        rz_new, rr = reduce(rz_new, rr)
        p = cg_direction_plain(False, rz, rz_new, z, p)
        rz = rz_new
        k += 1
    return x, k, float(torch.sqrt(rr))


def _cg_rows_kernels(blk: RowBlock, s: float, diag, b, x0, tol: float,
                     max_iter: int, shard):
    """The row-sharded CG on the card, as ``_cg_rows_plain``: each
    iteration all-gathers p, launches K9's partial mode, all-reduces p.Ap,
    launches K9u's first launch, all-reduces r.z and r.r and launches its
    second, the scalars kept in the state on the card; CG_CHUNK iterations
    go out at a time and the host reads the flag after each chunk (kernels
    whose flag is down return at once). Counted in
    ``_cg_rows_kernels.host_syncs``."""
    from . import parallel

    dev, n = b.device, blk.rows
    state = _State.new(dev, 0.0, max_iter)
    bb = parallel.all_reduce(torch.dot(b, b).reshape(1), shard)
    state.sc[_SC["thresh"]] = tol * tol * bb[0]
    pap = state.sc[_SC["pap"]: _SC["pap"] + 1]
    parts = state.sc[_SC["rz_part"]: _SC["rr_part"] + 1]
    minv = 1.0 / diag
    gathered = torch.empty(blk.op.n, dtype=b.dtype, device=dev)
    y = torch.zeros_like(b)          # the padded tail stays 0
    parallel.all_gather(x0, shard, gathered)
    _matvec_rows_launch(blk, s, gathered, y, state)       # y = (M + sI) x0
    x, r = x0.clone(), b - y
    p, z = torch.zeros_like(b), torch.zeros_like(b)
    _update_rows_launch(True, n, y, minv, x, r, p, z, state)
    parallel.all_reduce(parts, shard)
    _direction_launch(True, n, z, p, state)
    flags = torch.empty(len(_ST), dtype=torch.int32, pin_memory=True)
    while True:
        for _ in range(CG_CHUNK):
            parallel.all_gather(p, shard, gathered)
            _matvec_rows_launch(blk, s, gathered, y, state)
            parallel.all_reduce(pap, shard)
            _update_rows_launch(False, n, y, minv, x, r, p, z, state)
            parallel.all_reduce(parts, shard)
            _direction_launch(False, n, z, p, state)
        flags.copy_(state.st, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        _cg_rows_kernels.host_syncs += 1
        if not flags[_ST["active"]]:
            break
    return x, int(flags[_ST["k"]]), float(torch.sqrt(state.sc[_SC["rr"]]))


_cg_rows_kernels.host_syncs = 0


def cg_solve_rows(blk: RowBlock, s, diag, b, x0, tol, max_iter: int, shard):
    """The row-sharded CG on the rank's padded vectors (diag, b, x0 of
    ``blk.width`` rows, the rank's ``blk.rows`` first): the kernels on a
    CUDA device (``_cg_rows_kernels``), the plain versions on the CPU.
    Returns (x of the rank's padded rows, iterations, residual), the count
    and residual the same on every rank."""
    fn = _cg_rows_plain if b.device.type == "cpu" else _cg_rows_kernels
    return fn(blk, s, diag, b, x0, tol, max_iter, shard)


# --------------------------------------------------------------------------
# Public entry
# --------------------------------------------------------------------------

def _put(device, *arrays):
    """The host arrays of the system on the solve's device."""
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def enforce_continuity(tree: Octree, mesh=None, cg: str = "auto") -> Octree:
    """Return a tree whose coefficients minimize inter-cell jumps: solves
    (M + sI) c = s c0 with warm start (reference: Octree.cpp:1717-1762), on
    the tree's device, with M as the face operator (``face_operator``: no
    same-depth entry is assembled).

    ``cg``: "f64", "mixed" or "auto", all the f64 CG here (the H100 has
    f64; the reference's "mixed" exists for TPUs). ``mesh``: a
    ``torch.distributed`` DeviceMesh (``parallel.make_mesh``; every rank
    calls with the same tree): the CG runs row-sharded over all its ranks
    (``parallel.mesh_shard``, as the reference flattens its mesh;
    ``row_block``, ``cg_solve_rows``) and every rank returns the same
    tree; anything else but None raises TypeError."""
    shard = None
    if mesh is not None:
        from .parallel import all_gather, mesh_shard
        shard = mesh_shard(mesh)
    if cg not in ("auto", "mixed", "f64"):
        raise ValueError(f"cg must be 'auto', 'mixed' or 'f64', not {cg!r}")
    st = _LeafView(tree)
    if st.n_coeffs == 0:
        return tree
    s = float(tree.config.continuity_strength)
    n = st.n_coeffs
    op, diag = face_operator(st, *leaf_face_pairs(st.child_idx, st.n), s)

    # pack padded per-leaf rows into the flat coefficient vector
    coeffs = tree.coeffs.cpu().numpy()
    leaf_ids = np.flatnonzero(st.degree[: st.n] >= 0)
    widths = st.widths[leaf_ids]
    flat_rows = np.repeat(leaf_ids, widths)
    # each leaf's 0 .. width-1, in one pass (the reference concatenates an
    # arange a leaf)
    flat_cols = (np.arange(flat_rows.size)
                 - np.repeat(np.cumsum(widths) - widths, widths))
    c0 = coeffs[flat_rows, flat_cols]

    if shard is None:
        dt, bt, xt = _put(tree.device, diag, s * c0, c0)
        x, iters, resid = cg_solve(op.to(tree.device), s, dt, bt, xt,
                                   tol=consts.EPSILON_F32, max_iter=2 * n)
    else:
        blk = row_block(op, shard.size, shard.rank)
        mine = slice(blk.lo, blk.lo + blk.rows)
        pad = np.zeros(blk.width - blk.rows)
        dt, bt, xt = _put(tree.device, *(np.concatenate([v[mine], pad + f])
                                         for v, f in ((diag, 1.0),
                                                      (s * c0, 0.0),
                                                      (c0, 0.0))))
        x, iters, resid = cg_solve_rows(blk.to(tree.device), s, dt, bt, xt,
                                        consts.EPSILON_F32, 2 * n, shard)
        order, = _put(tree.device, blk.order)
        x = all_gather(x, shard)[order]
    if tree.config.enable_logging:
        print(f"[hpsdf continuity] n={n} nnz={op.nnz} cg=f64"
              f"{'' if shard is None else f' row-sharded over {shard.size}'} "
              f"iters={iters} residual={resid:.3e} "
              f"(tol {consts.EPSILON_F32:g}, max_iter {2 * n})")
    new_coeffs = tree.coeffs.clone()
    fr, fc = _put(tree.device, flat_rows, flat_cols)
    new_coeffs[fr, fc] = x
    return dataclasses.replace(tree, coeffs=new_coeffs)
