"""Packed read layout: one f32 row per node plus a dense grid of leaf rows.

The counterpart of ``hpsdf_tpu/accel.py``, with the same lane layout, so
the packed tables of a tree equal ``hpsdf_tpu.accel.pack_tree``'s bit for
bit:

    lane 0      : child_idx + 1 bitcast i32 -> f32 (0.0 for leaves; read
                  it back with ``.view(torch.int32)``)
    lane 1      : scale = 2**(depth+1)
    lanes 2..4  : cell centre (internal unit-cube coords)
    lanes 8..   : coefficients with the (depth, basis) normalizers folded in

and ``grid[cell]`` the row of the unique node at depth <= grid_depth that
covers each depth-``grid_depth`` cell. Locating a point is one grid row
read plus ``extra_rounds`` masked descents.

Three kernels serve this layout on CUDA tensors:

  * G  ``row_gather`` (``csrc/row_gather.cu``): ``out[b] = table[idx[b]]``,
    zeros out of range. It replaces the three Pallas row gathers of
    ``experiments/gather_probe.py`` (G1-G3) and derives the grid, the
    repacked tables and the mesh sign's triangle rows.
  * K2 ``packed_eval_kernel`` (``csrc/packed_eval.cu``): locate + Legendre
    eval per point, for ``values_at`` / ``query_packed``. A thread reads its
    row in 16-byte loads, so the tables' rows must be 16-byte aligned (W a
    multiple of 4, as ``_row_width`` makes it).
  * K5, the same source with the gradient: unit normals for ``normals``
    (with each point's row key and unnormalised gradient saved for K7's
    form 2 and K5h where the tables or the points need a gradient,
    NORMALS_SAVE), or the raw world-space gradient for the backward of
    ``values_at`` with respect to the points, and, fused into K2's launch,
    for ``values_and_gradient_at`` (with each point's row key saved for
    K5h where the points need a gradient, VALUES_AND_GRAD_SAVE);
  * K5h ``packed_hvp_kernel``, the same read with the Hessian, from the
    row key its forward saved: the VJPs of ``normals`` and
    ``values_and_gradient_at`` with respect to the points.

and two backward kernels make the reads differentiable on CUDA tensors:

  * G's backward ``row_scatter`` (``csrc/row_gather.cu``):
    ``d_table[idx[b]] += d_out[b]``, the VJP of ``row_gather``, so that
    ``repack_folded`` carries gradients from the grid to the rows. Each
    table row is summed once from its sources: with their inverse given
    (``gather_csr``; ``PackSupport`` keeps the grid's) in one plain launch,
    else grouped by row inside one cooperative launch;
  * K7 ``packed_grad_kernel`` (``csrc/packed_grad.cu``): the VJP of the
    values (form 0), of the raw gradients (form 1) and of the normals
    (form 2, from what K5's normals forward saved) with respect to the
    rows and the grid, into the coefficient lanes of the row each point
    read, the points grouped by that row inside one cooperative launch.
    The meta lanes (0-7) are the tree's topology and take no gradient, in
    the plain versions too.

The backward kernels write or clear every row of their outputs
themselves, so the wrappers allocate them with ``torch.empty``: one launch
a call, no zero-fill.

Tensors on the CPU take the plain torch versions in this module, and
autograd differentiates them. On CUDA tensors ``values_at``,
``query_packed``, ``values_and_gradient_at`` and ``normals`` (with respect
to the tables and the points) and ``row_gather`` carry gradients through
their backward kernels. The points are clamped into the root by
``query.clip_half``, whose derivative is ``jnp.clip``'s (1/2 on a face of
the root). The TPU
layout's one-hot meta matmul and zero-padded whole-row contraction
(``hpsdf_tpu/accel.py:27-33``) exist for XLA's gather fusion and are not carried
over: lanes are read by slicing.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import _kernels, basis, consts
from ._device import wants_grad
from .query import _grads, clip_half, clip_slope, unit_vector
from .tree import Octree

# Dense grid depth cap and row-table byte budget (hpsdf_tpu accel.py:60-68)
GRID_DEPTH_CAP = 5
GRID_BYTE_BUDGET = 20 << 20
COEFF_LANE = 8

# Low-degree (LOD) rows for the far-field march phase: meta lanes, the
# deg<=2 coefficient lanes, and a bound on the truncated rest
LO_W = 32
LO_COEFFS = 10                       # coeff_count(2)
LO_ERR_LANE = COEFF_LANE + LO_COEFFS

F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class PackedTree:
    rows: torch.Tensor        # f32[Np, W] packed node rows
    grid: torch.Tensor        # f32[G**3, W] packed row per depth-Dg cell
    deg_used: int
    grid_depth: int
    extra_rounds: int
    root_centre: tuple
    root_sizes: tuple

    @property
    def width(self) -> int:
        return self.rows.shape[1]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @functools.cached_property
    def lo(self):
        """(lo_grid, lo_rows), the LOD tables of the march's far-field
        phase, or None when the rows are low-degree already. Made at first
        use and kept with the tables they come from (``dataclasses.replace``
        starts afresh)."""
        if self.deg_used <= 2 or self.width <= LO_W:
            return None
        return lo_pack(self.grid), lo_pack(self.rows)


@dataclasses.dataclass(frozen=True)
class PackSupport:
    """What re-derives a PackedTree from new coefficients on the device
    (topology fixed, coefficient lanes new)."""
    meta_rows: torch.Tensor   # f32[Np, COEFF_LANE] lanes 0..7 of the rows
    fold: torch.Tensor        # f32[Np, cw] per-(depth, basis) normalizers
    grid_src: torch.Tensor    # i32[G**3] node index backing each grid cell
    # grid_src's inverse (gather_csr), for G's backward: the grid cells of
    # node r are grid_cells[grid_offsets[r]:grid_offsets[r + 1]], ascending
    grid_offsets: torch.Tensor    # i32[Np + 1]
    grid_cells: torch.Tensor      # i32[G**3]

    @property
    def grid_csr(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self.grid_offsets, self.grid_cells


# --------------------------------------------------------------------------
# Host packing (numpy, copied from hpsdf_tpu accel.py:88-137)
# --------------------------------------------------------------------------

def _row_width(cw: int) -> int:
    return -(-(COEFF_LANE + cw) // 8) * 8


def _pack_rows(tree: Octree) -> np.ndarray:
    child_idx = tree.child_idx.cpu().numpy()
    depth_np = tree.depth.cpu().numpy()
    coeffs = tree.coeffs.detach().cpu().numpy()
    n, cw = coeffs.shape
    rows = np.zeros((n, _row_width(cw)), np.float32)
    child = np.asarray(child_idx, np.int32) + 1    # 0 = leaf, finite
    rows[:, 0] = child.view(np.float32)
    depth = np.asarray(depth_np, np.float64)
    rows[:, 1] = np.exp2(depth + 1.0).astype(np.float32)
    rows[:, 2:5] = tree.centre.cpu().numpy().astype(np.float32)
    # fold the per-(depth, basis) normalizers into the coefficients
    norms = basis.coeff_norms(tree.deg_used)          # (D+1, cw)
    dep_i = np.asarray(depth_np, np.int64)
    rows[:, COEFF_LANE:COEFF_LANE + cw] = (
        np.asarray(coeffs, np.float64) * norms[dep_i]).astype(np.float32)
    return rows


def _grid_sources(tree: Octree, gd: int) -> np.ndarray:
    """Node index of the unique depth<=gd node covering each grid cell
    (host-side vectorized descent over all cells at once)."""
    g = 1 << gd
    ax = (np.arange(g, dtype=np.float64) + 0.5) / g - 0.5   # cell centres
    px, py, pz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([px, py, pz], axis=-1).reshape(-1, 3)

    child = tree.child_idx.cpu().numpy().astype(np.int64)
    centre = tree.centre.cpu().numpy().astype(np.float64)
    cur = np.zeros(pts.shape[0], np.int64)
    for _ in range(gd):
        c0 = child[cur]
        live = c0 >= 0
        cc = centre[cur]
        oct_ = ((pts[:, 0] >= cc[:, 0]).astype(np.int64)
                + ((pts[:, 1] >= cc[:, 1]).astype(np.int64) << 1)
                + ((pts[:, 2] >= cc[:, 2]).astype(np.int64) << 2))
        cur = np.where(live, c0 + oct_, cur)
    return cur


def _default_grid_depth(tree: Octree) -> int:
    """Deepest grid within GRID_DEPTH_CAP whose row table fits the byte
    budget (wider rows at deg >= 9 pull the cap down one level)."""
    W = _row_width(tree.coeffs.shape[1])
    gd = min(tree.depth_used, GRID_DEPTH_CAP)
    while gd > 0 and (8 ** gd) * W * 4 > GRID_BYTE_BUDGET:
        gd -= 1
    return gd


def _grid_src(tree: Octree, grid_depth: int) -> torch.Tensor:
    return torch.as_tensor(_grid_sources(tree, grid_depth), dtype=torch.int32,
                           device=tree.device)


def gather_csr(idx, n: int) -> tuple[np.ndarray, np.ndarray]:
    """The inverse of a row gather's indices ``idx`` (B,) into a table of
    ``n`` rows, as CSR on the host: (offsets i32 (n + 1,), order i32) with
    ``order[offsets[r]:offsets[r + 1]]`` the positions b, ascending, at
    which ``idx[b] == r``. Out-of-range indices are left out, as the
    gather reads zeros there."""
    idx = np.asarray(idx, np.int64).reshape(-1)
    pos = np.flatnonzero((idx >= 0) & (idx < n))
    order = pos[np.argsort(idx[pos], kind="stable")]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(idx[pos], minlength=n), out=offsets[1:])
    return offsets.astype(np.int32), order.astype(np.int32)


def pack_tree(tree: Octree, grid_depth: int | None = None) -> PackedTree:
    """The packed read layout of a fitted Octree, on the tree's device. The
    grid is gathered there from the rows (kernel G on CUDA)."""
    if grid_depth is None:
        grid_depth = _default_grid_depth(tree)
    rows = torch.as_tensor(_pack_rows(tree), device=tree.device)
    return PackedTree(
        rows=rows, grid=row_gather(rows, _grid_src(tree, grid_depth)),
        deg_used=tree.deg_used, grid_depth=grid_depth,
        extra_rounds=max(0, tree.depth_used - grid_depth),
        root_centre=tuple(np.asarray(tree.config.root_centre, np.float64)),
        root_sizes=tuple(np.asarray(tree.config.root_sizes, np.float64)))


def pack_support(tree: Octree, grid_depth: int | None = None) -> PackSupport:
    if grid_depth is None:
        grid_depth = _default_grid_depth(tree)
    rows = _pack_rows(tree)
    norms = basis.coeff_norms(tree.deg_used)
    dep_i = tree.depth.cpu().numpy().astype(np.int64)
    dev = tree.device
    src = _grid_sources(tree, grid_depth)
    offsets, cells = gather_csr(src, rows.shape[0])
    return PackSupport(
        meta_rows=torch.as_tensor(rows[:, :COEFF_LANE], device=dev),
        fold=torch.as_tensor(norms[dep_i].astype(np.float32), device=dev),
        grid_src=torch.as_tensor(src, dtype=torch.int32, device=dev),
        grid_offsets=torch.as_tensor(offsets, device=dev),
        grid_cells=torch.as_tensor(cells, device=dev))


def repack(packed: PackedTree, support: PackSupport,
           coeffs: torch.Tensor) -> PackedTree:
    """(rows, grid) for new coefficients (Np, cw), on the device."""
    return repack_folded(packed, support,
                         (coeffs * support.fold).to(torch.float32))


def repack_folded(packed: PackedTree, support: PackSupport,
                  folded: torch.Tensor) -> PackedTree:
    """Like :func:`repack`, from the normalizer-premultiplied coefficient
    lanes. Differentiable with respect to ``folded``: through the
    concatenation, and through the grid's gather (G's backward on CUDA, from
    the support's inverse of the grid sources)."""
    folded = folded.to(torch.float32)
    pad = packed.width - COEFF_LANE - folded.shape[1]
    parts = [support.meta_rows, folded]
    if pad:
        parts.append(folded.new_zeros((folded.shape[0], pad)))
    rows = torch.cat(parts, dim=1)
    return dataclasses.replace(packed, rows=rows, grid=row_gather(
        rows, support.grid_src, csr=support.grid_csr))


def lo_pack(rows: torch.Tensor) -> torch.Tensor:
    """(N, 32) low-degree rows from (N, W) packed rows: meta lanes, the
    deg<=2 folded coefficient lanes, and lane 18 = 1.001 * sum|c_m, deg>2|,
    a bound on |full - lo| anywhere in the leaf (hpsdf_tpu accel.py:282)."""
    c = rows[:, COEFF_LANE:]
    err = torch.sum(torch.abs(c[:, LO_COEFFS:]), dim=1,
                    keepdim=True) * np.float32(1.001)
    pad = rows.new_zeros((rows.shape[0], LO_W - LO_ERR_LANE - 1))
    return torch.cat([rows[:, :COEFF_LANE], c[:, :LO_COEFFS], err, pad],
                     dim=1)


# --------------------------------------------------------------------------
# Kernel G: row gather
# --------------------------------------------------------------------------

def _check_gather(table: torch.Tensor, idx: torch.Tensor) -> None:
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError(f"table must be f32 (N, W), got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"idx must be int32/int64 (B,), got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if table.device != idx.device:
        raise ValueError(f"table on {table.device}, idx on {idx.device}")


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G by index_select, whatever the device: rows of ``table`` at ``idx``,
    zeros where idx is outside [0, N) (G2's ``fill_value=0.0``)."""
    _check_gather(table, idx)
    idx = idx.long()
    ok = (idx >= 0) & (idx < table.shape[0])
    out = table.index_select(0, torch.where(ok, idx, 0))
    return torch.where(ok[:, None], out, 0.0)


class _RowGather(torch.autograd.Function):
    """G with G's backward (row_scatter) as its VJP."""

    @staticmethod
    def forward(ctx, table, idx, csr):
        ctx.save_for_backward(idx)
        ctx.n, ctx.csr = table.shape[0], csr
        return _row_gather(table, idx)

    @staticmethod
    def backward(ctx, d_out):
        (idx,) = ctx.saved_tensors
        return row_scatter(d_out.contiguous(), idx, ctx.n, ctx.csr), None, \
            None


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               csr: tuple[torch.Tensor, torch.Tensor] | None = None
               ) -> torch.Tensor:
    """Row gather ``out[b, :] = table[idx[b], :]`` (B, W) f32, zeros for
    out-of-range indices: kernel G on CUDA tensors, the plain version on
    CPU tensors. W must be a multiple of 4 (G moves 16-byte quarters of a
    row), as every table of the packed and mesh layouts is. Differentiable
    with respect to ``table``: its VJP is ``row_scatter``, given ``csr``,
    the inverse of ``idx`` (``gather_csr``, as tensors on idx's device),
    where the caller keeps one."""
    _check_gather(table, idx)
    if table.shape[1] % 4:
        raise ValueError(f"row_gather: width {table.shape[1]} is not a "
                         "multiple of 4")
    if wants_grad(table):
        return _RowGather.apply(table, idx, csr)
    return _row_gather(table, idx)


def _row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    N, W = table.shape
    if idx.device.type == "cpu":
        return row_gather_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {idx.device}")
    if table.stride(1) != 1 or table.stride(0) % 4 \
            or table.data_ptr() % 16:
        raise ValueError("row_gather: table lanes must be contiguous, with "
                         "rows 16-byte aligned")
    if N >= 2 ** 31 or table.stride(0) >= 2 ** 31:
        raise ValueError("row_gather: table too large for 32-bit indices")
    idx = idx.to(torch.int32).contiguous() if idx.dtype == torch.int64 \
        else idx.contiguous()
    B = idx.shape[0]
    out = torch.empty((B, W), dtype=torch.float32, device=idx.device)
    if B == 0 or W == 0:
        return out
    lib = _kernels.load()
    _kernels.check(lib, lib.hpsdf_row_gather(
        table.data_ptr(), N, W, table.stride(0), idx.data_ptr(), B,
        out.data_ptr(), _kernels.stream_of(idx)), "row_gather")
    row_gather.launches += 1
    return out


row_gather.launches = 0


def row_scatter_plain(d_out: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """G's backward by index_add_, whatever the device: (n, W) f32 with
    ``d_out[b]`` added into row ``idx[b]``, out-of-range indices dropped."""
    idx = idx.long()
    ok = (idx >= 0) & (idx < n)
    out = d_out.new_zeros((n, d_out.shape[1]))
    return out.index_add_(0, idx[ok], d_out[ok])


def row_scatter_csr_plain(d_out: torch.Tensor, offsets: torch.Tensor,
                          order: torch.Tensor) -> torch.Tensor:
    """G's backward from the inverse of the indices (``gather_csr``),
    whatever the device: row r of the (len(offsets) - 1, W) result is the
    sum of ``d_out[order[offsets[r]:offsets[r + 1]]]``, added in that
    order."""
    n = offsets.shape[0] - 1
    counts = (offsets[1:] - offsets[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=d_out.device), counts)
    out = d_out.new_zeros((n, d_out.shape[1]))
    return out.index_add_(0, rows, d_out[order.long()])


def _check_scatter(d_out: torch.Tensor, idx: torch.Tensor, n: int,
                   csr) -> None:
    if d_out.dtype != torch.float32 or d_out.dim() != 2 \
            or d_out.shape[0] != idx.shape[0] or d_out.device != idx.device:
        raise ValueError(f"row_scatter: d_out must be f32 ({idx.shape[0]}, "
                         f"W) on {idx.device}, got {d_out.dtype} "
                         f"{tuple(d_out.shape)} on {d_out.device}")
    if csr is not None:
        offsets, order = csr
        if offsets.shape != (n + 1,) or order.dim() != 1 \
                or offsets.dtype != torch.int32 or order.dtype != torch.int32 \
                or offsets.device != d_out.device \
                or order.device != d_out.device:
            raise ValueError(f"row_scatter: csr must be i32 offsets "
                             f"({n + 1},) and order on {d_out.device}")


def row_scatter(d_out: torch.Tensor, idx: torch.Tensor, n: int,
                csr: tuple[torch.Tensor, torch.Tensor] | None = None
                ) -> torch.Tensor:
    """The VJP of ``row_gather`` into a table of ``n`` rows: G's backward
    (``csrc/row_gather.cu``) on CUDA tensors, given ``csr`` (the inverse of
    ``idx``, ``gather_csr``) its CSR form, else its grouping form;
    ``row_scatter_csr_plain`` or ``row_scatter_plain`` on CPU tensors.
    ``launches`` counts both forms, ``csr_launches`` the CSR form's."""
    _check_scatter(d_out, idx, n, csr)
    if d_out.device.type == "cpu":
        if csr is not None:
            return row_scatter_csr_plain(d_out, *csr)
        return row_scatter_plain(d_out, idx, n)
    if d_out.device.type != "cuda":
        raise ValueError(f"row_scatter: unsupported device {d_out.device}")
    B, W = d_out.shape
    d_out = d_out.contiguous()
    if W % 4 or d_out.data_ptr() % 16:
        raise ValueError("row_scatter: rows must be a multiple of 4 lanes, "
                         "16-byte aligned")
    if n >= 2 ** 31 - 1:
        raise ValueError("row_scatter: too large for 32-bit indices")
    out = torch.empty((n, W), dtype=torch.float32, device=d_out.device)
    if n == 0 or W == 0:
        return out
    lib = _kernels.load()
    stream = _kernels.stream_of(d_out)
    if csr is not None:
        offsets, order = (t.contiguous() for t in csr)
        _kernels.check(lib, lib.hpsdf_row_scatter_csr(
            d_out.data_ptr(), W, offsets.data_ptr(), order.data_ptr(), n,
            out.data_ptr(), stream), "row_scatter")
        row_scatter.csr_launches += 1
    else:
        idx = idx.to(torch.int32).contiguous()
        size = lib.hpsdf_row_scatter_scratch(B, n)
        if size < 0:
            raise ValueError("row_scatter: too large for 32-bit indices")
        scratch = torch.empty(size, dtype=torch.uint8, device=d_out.device)
        _kernels.check(lib, lib.hpsdf_row_scatter(
            d_out.data_ptr(), W, idx.data_ptr(), B, n, scratch.data_ptr(),
            size, out.data_ptr(), stream), "row_scatter")
    row_scatter.launches += 1
    return out


row_scatter.launches = 0
row_scatter.csr_launches = 0


# --------------------------------------------------------------------------
# Device reads: plain torch versions of K2 / K5
# --------------------------------------------------------------------------

def _root_f32(pt: PackedTree, like: torch.Tensor):
    """(centre, 1/sizes) as the reads' dtype: 1/sizes is taken in f64 and
    then rounded, as hpsdf_tpu's to_unit does."""
    centre = torch.tensor(pt.root_centre, dtype=like.dtype, device=like.device)
    inv = torch.tensor(1.0 / np.asarray(pt.root_sizes), dtype=like.dtype,
                       device=like.device)
    return centre, inv


def to_unit(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    centre, inv = _root_f32(pt, pts)
    return (pts - centre) * inv


def _row_child(row: torch.Tensor) -> torch.Tensor:
    # lane 0 stores child_idx + 1 (module docstring); < 0 means leaf
    return row[..., 0].view(torch.int32) - 1


def locate_in(grid: torch.Tensor, rows: torch.Tensor, grid_depth: int,
              extra_rounds: int, unit: torch.Tensor) -> torch.Tensor:
    """Packed row (B, W) of the leaf containing each unit-cube point, read
    from explicit (grid, rows) tables: one grid row, then ``extra_rounds``
    masked descents. The cell index truncates as ``astype(int32)`` does;
    callers clip ``unit`` into the root first, so truncation is floor."""
    g = 1 << grid_depth
    cell = ((unit + 0.5) * g).to(torch.int32).clamp(0, g - 1).long()
    flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    row = grid[flat]
    for _ in range(extra_rounds):
        child = _row_child(row)
        is_leaf = child < 0
        cc = row[..., 2:5]
        oct_ = ((unit[..., 0] >= cc[..., 0]).int()
                + ((unit[..., 1] >= cc[..., 1]).int() << 1)
                + ((unit[..., 2] >= cc[..., 2]).int() << 2))
        nxt = torch.where(is_leaf, 0, child + oct_).long()
        row = torch.where(is_leaf[..., None], row, rows[nxt])
    return row


def locate(pt: PackedTree, unit: torch.Tensor) -> torch.Tensor:
    return locate_in(pt.grid, pt.rows, pt.grid_depth, pt.extra_rounds, unit)


def _products(local: torch.Tensor, degree: int, with_grad: bool = False):
    """Basis products L_i(x) L_j(y) L_k(z) over basis_indices(degree),
    (B, C), and with ``with_grad`` their three partial derivatives."""
    idx = torch.as_tensor(basis.basis_indices(degree), dtype=torch.long,
                          device=local.device)
    if not with_grad:
        L = basis.legendre_all(local, degree)
        return L[..., 0, idx[:, 0]] * L[..., 1, idx[:, 1]] * L[..., 2, idx[:, 2]]
    L, dL = basis.legendre_all_with_derivative(local, degree)
    Lx, Ly, Lz = (L[..., a, idx[:, a]] for a in range(3))
    dLx, dLy, dLz = (dL[..., a, idx[:, a]] for a in range(3))
    return dLx * Ly * Lz, Lx * dLy * Lz, Lx * Ly * dLz


def eval_local(row: torch.Tensor, local: torch.Tensor,
               degree: int) -> torch.Tensor:
    """The bare Legendre product sum of packed rows over their first
    coeff_count(degree) folded coefficient lanes, at points ``local`` of
    each leaf's [-1, 1]^3 frame."""
    prod = _products(local, degree)
    cw = prod.shape[-1]
    return torch.sum(row[..., COEFF_LANE:COEFF_LANE + cw] * prod, dim=-1)


def _local(row: torch.Tensor, unit: torch.Tensor) -> torch.Tensor:
    """Unit-cube points in their rows' [-1, 1]^3 leaf frames. The meta lanes
    (scale, centre) are the tree's topology: they take no gradient, as in
    the kernels."""
    return (unit - row[..., 2:5].detach()) * row[..., 1:2].detach()


def eval_row(pt: PackedTree, row: torch.Tensor,
             unit: torch.Tensor) -> torch.Tensor:
    """Evaluate packed leaf rows at unit-cube points."""
    return eval_local(row, _local(row, unit), pt.deg_used)


def _clamped(pt: PackedTree, pts: torch.Tensor):
    """The points' unit-cube coordinates clamped into the root
    (``clip_half``, whose derivative is jnp.clip's), and the row of the
    leaf each reads."""
    unit = clip_half(to_unit(pt, pts))
    return unit, locate(pt, unit.detach())


def values_at_plain(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    unit, row = _clamped(pt, pts)
    return eval_row(pt, row, unit)


def query_packed_plain(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    inside = torch.all(to_unit(pt, pts).abs() <= 0.5, dim=-1)
    unit, row = _clamped(pt, pts)
    return torch.where(inside, eval_row(pt, row, unit), F32_MAX)


def _local_gradient(pt: PackedTree, row: torch.Tensor, unit: torch.Tensor):
    """The gradient (B, 3) of the rows' product sums in their leaf frames
    at the clamped unit-cube points."""
    parts = _products(_local(row, unit), pt.deg_used, with_grad=True)
    cw = parts[0].shape[-1]
    coef = row[..., COEFF_LANE:COEFF_LANE + cw]
    return torch.stack([torch.sum(coef * d, dim=-1) for d in parts], dim=-1)


def _raw_gradient(pt: PackedTree, pts: torch.Tensor, row: torch.Tensor):
    """``point_gradient_plain`` at world points whose rows are ``row``."""
    raw = to_unit(pt, pts)
    g = _local_gradient(pt, row, clip_half(raw))
    inv = _root_f32(pt, pts)[1]
    return g * row[..., 1:2].detach() * inv * clip_slope(raw)


def point_gradient_plain(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    """The raw world-space gradient (B, 3) of ``values_at_plain`` at world
    points, as autodiff gives it: chained through local = (unit - centre) *
    scale and unit = clip_half((p - c) * (1 / sizes)), times the clamp's
    slope on each axis (1 inside the root, 1/2 on a face, 0 clamped)."""
    return _raw_gradient(pt, pts, _clamped(pt, pts)[1])


def _tables_vjp(fn, pt: PackedTree, pts: torch.Tensor, cot: torch.Tensor):
    """(d_rows, d_grid): the VJP of fn(pt, pts) with respect to the packed
    tables, by autograd."""
    return _grads(lambda rows, grid: fn(dataclasses.replace(
        pt, rows=rows, grid=grid), pts.detach()), (pt.rows, pt.grid), cot)


def values_at_vjp_plain(pt: PackedTree, pts: torch.Tensor, w: torch.Tensor):
    """K7's form 0 by autograd of ``values_at_plain``: (d_rows, d_grid) for
    weights w (B,)."""
    return _tables_vjp(values_at_plain, pt, pts, w)


def point_gradient_vjp_plain(pt: PackedTree, pts: torch.Tensor,
                             u: torch.Tensor):
    """K7's form 1 by autograd of ``point_gradient_plain``: (d_rows,
    d_grid) for cotangents u (B, 3)."""
    return _tables_vjp(point_gradient_plain, pt, pts, u)


def _normal_gradient(pt: PackedTree, row: torch.Tensor, unit: torch.Tensor):
    """The unnormalised world gradient (B, 3) the normals normalise: the
    rows' local gradients at the clamped unit-cube points times scale /
    sizes."""
    g = _local_gradient(pt, row, unit)
    sizes = torch.tensor(pt.root_sizes, dtype=torch.float32,
                         device=unit.device)
    return g * row[..., 1:2].detach() / sizes


def normals_plain(pt: PackedTree, p: torch.Tensor) -> torch.Tensor:
    """Unit normals: the normalised position gradient of the packed eval
    (hpsdf_tpu render._normals_at), chained through local = (unit -
    centre) * scale and unit = (p - c) / sizes, the points clamped into
    the root (``clip_half``) but no axis masked; the floor 1e-12."""
    unit, row = _clamped(pt, p)
    return unit_vector(_normal_gradient(pt, row, unit), 1e-12)


def locate_key_plain(pt: PackedTree, unit: torch.Tensor) -> torch.Tensor:
    """The key (B,) i32 of the row ``locate`` reads at the clamped
    unit-cube points: the grid cell k < 8^grid_depth, or 8^grid_depth +
    the node row of its last descent (``csrc/packed_rows.cuh``'s
    locate_key)."""
    g = 1 << pt.grid_depth
    cell = ((unit + 0.5) * g).to(torch.int32).clamp(0, g - 1).long()
    key = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
    row = pt.grid[key]
    for _ in range(pt.extra_rounds):
        child = _row_child(row)
        is_leaf = child < 0
        cc = row[..., 2:5]
        oct_ = ((unit[..., 0] >= cc[..., 0]).long()
                + ((unit[..., 1] >= cc[..., 1]).long() << 1)
                + ((unit[..., 2] >= cc[..., 2]).long() << 2))
        nxt = torch.where(is_leaf, 0, child.long() + oct_)
        row = torch.where(is_leaf[..., None], row, pt.rows[nxt])
        key = torch.where(is_leaf, key, g ** 3 + nxt)
    return key.int()


def keyed_rows(pt: PackedTree, key: torch.Tensor) -> torch.Tensor:
    """The rows (B, W) that the keys (B,) name (``locate_key_plain``'s):
    grid row k below 8^grid_depth, else node row k - 8^grid_depth."""
    key = key.long()
    G3 = 8 ** pt.grid_depth
    return torch.where((key < G3)[:, None], pt.grid[key.clamp(max=G3 - 1)],
                       pt.rows[(key - G3).clamp(min=0)])


def _saved_key(saved: torch.Tensor) -> torch.Tensor:
    """The row keys (B,) i32 of the normals' saved record (B, 4)."""
    return saved[:, 0].contiguous().view(torch.int32)


def normals_save_plain(pt: PackedTree, p: torch.Tensor):
    """``normals_plain`` with what K5's normals forward saves for K7's form
    2 and K5h where the tables or the points need a gradient
    (``packed_eval_kernel``'s NORMALS_SAVE): (normals (B, 3), saved (B, 4)
    f32), saved[:, 0] each
    point's row key (``locate_key_plain``) as the bits of an f32, saved[:,
    1:] the unnormalised gradient the normals normalise."""
    unit, row = _clamped(pt, p)
    G = _normal_gradient(pt, row, unit).detach()
    key = locate_key_plain(pt, unit.detach())
    return unit_vector(G, 1e-12), torch.cat(
        [key.view(torch.float32)[:, None], G], 1)


def normals_tables_vjp_plain(pt: PackedTree, p: torch.Tensor,
                             saved: torch.Tensor, wn: torch.Tensor):
    """K7's form 2 from what K5's normals forward saved (``saved`` (B, 4),
    ``normals_save_plain``'s): (d_rows, d_grid) for cotangents wn (B, 3),
    by autograd, the unit vector's VJP taken at the saved gradient, the
    rows located as ``normals_plain`` locates them (the saved keys name
    the same rows); on the CPU bit for bit ``normals_vjp_plain``'s."""
    return _normal_gradient_vjp(pt, p, _unit_vjp(saved, wn))


def _unit_vjp(saved: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """gb (B, 3): the unit vector's VJP for cotangents wn at the gradient
    the normals' forward saved (``saved`` (B, 4)), by autograd."""
    G = saved[:, 1:].detach().requires_grad_(True)
    with torch.enable_grad():
        (gb,) = torch.autograd.grad(unit_vector(G, 1e-12), G, wn)
    return gb


def normals_points_vjp_plain(pt: PackedTree, p: torch.Tensor,
                             saved: torch.Tensor, wn: torch.Tensor):
    """K5h's normals mode from what K5's normals forward saved (``saved``
    (B, 4), ``normals_save_plain``'s): the gradient (B, 3) of sum(wn *
    normals) with respect to the points, by autograd, the unit vector's VJP
    taken at the saved gradient and the unnormalised gradient's at the row
    each saved key names."""
    row = keyed_rows(pt, _saved_key(saved))
    return _grads(lambda q: _normal_gradient(pt, row, clip_half(to_unit(
        pt, q))), (p,), _unit_vjp(saved, wn))[0]


def _normal_gradient_vjp(pt: PackedTree, p: torch.Tensor, gb: torch.Tensor):
    """(d_rows, d_grid): the VJP with respect to the tables of the
    unnormalised gradient ``normals_plain`` normalises, for its cotangent
    gb (B, 3), by autograd."""
    return _grads(lambda rows, grid: _normal_gradient(
        pt, *reversed(_clamped(dataclasses.replace(pt, rows=rows, grid=grid),
                               p.detach()))), (pt.rows, pt.grid), gb)


# --------------------------------------------------------------------------
# Kernels K2 / K5
# --------------------------------------------------------------------------

def _check_packed(pt: PackedTree, pts: torch.Tensor) -> None:
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be f32 (B, 3), got {pts.dtype} "
                         f"{tuple(pts.shape)}")
    if pt.rows.device != pts.device or pt.grid.device != pts.device:
        raise ValueError(f"packed tables on {pt.rows.device}, pts on "
                         f"{pts.device}")
    for name, t in (("rows", pt.rows), ("grid", pt.grid)):
        if t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != pt.width or not t.is_contiguous():
            raise ValueError(f"packed {name} must be contiguous f32 "
                             f"(N, {pt.width})")
    if pt.width < COEFF_LANE + consts.coeff_count(pt.deg_used) \
            or pt.grid.shape[0] != 8 ** pt.grid_depth:
        raise ValueError("packed tables do not match deg_used / grid_depth")
    if pt.width % 4 or pt.rows.data_ptr() % 16 or pt.grid.data_ptr() % 16:
        raise ValueError("packed rows must be 16-byte aligned (width a "
                         "multiple of 4, tables 16-byte aligned)")


# what a K2/K5 launch computes (packed_eval_kernel's ``mode``)
VALUES, NORMALS, RAW_GRAD, VALUES_AND_GRAD, NORMALS_SAVE, \
    VALUES_AND_GRAD_SAVE = 0, 1, 2, 3, 4, 5


def packed_eval_kernel(pt: PackedTree, pts: torch.Tensor, mode: int,
                       outside_max: bool = False, n_grad: int = 0):
    """Launch K2 or K5 on CUDA tensors. ``mode`` VALUES: f32 values (B,)
    at world points, clamped into the root, or the f32-max sentinel outside
    it with ``outside_max``; NORMALS: unit normals (B, 3); RAW_GRAD: the raw
    world-space gradient (B, 3) of the values, as ``point_gradient_plain``;
    VALUES_AND_GRAD, the fused mode: (values (B,), the raw gradients of the
    first ``n_grad`` points (n_grad, 3)), bit-equal to those of VALUES and
    RAW_GRAD, in one launch; NORMALS_SAVE: (the unit normals (B, 3), what
    K7's form 2 and K5h's normals mode start from (B, 4) f32,
    ``normals_save_plain``'s), for the normals' backward;
    VALUES_AND_GRAD_SAVE: VALUES_AND_GRAD's pair and each point's row key
    (B,) i32, what K5h's second mode starts from
    (``values_and_gradient_save_plain``'s). Raises on anything else.
    ``launches`` counts every launch, ``grad_launches`` those of K5's
    normals (either normals mode), ``save_launches`` those that save the
    normals' record, ``raw_launches`` those of its raw-gradient form,
    ``fused_launches`` those of the fused mode (either) and
    ``key_launches`` those of it that save the keys."""
    _check_packed(pt, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"packed_eval_kernel needs CUDA tensors, got "
                         f"{pts.device}")
    if type(mode) is not int or mode not in (VALUES, NORMALS, RAW_GRAD,
                                             VALUES_AND_GRAD, NORMALS_SAVE,
                                             VALUES_AND_GRAD_SAVE):
        raise ValueError(f"packed_eval_kernel: unknown mode {mode}")
    fused = mode in (VALUES_AND_GRAD, VALUES_AND_GRAD_SAVE)
    save = mode == NORMALS_SAVE
    keyed = mode == VALUES_AND_GRAD_SAVE
    B = pts.shape[0]
    if fused and not 0 <= n_grad <= B:
        raise ValueError(f"packed_eval_kernel: n_grad {n_grad} outside "
                         f"[0, {B}]")
    pts = pts.detach().contiguous()
    out = torch.empty((B,) if mode in (VALUES, VALUES_AND_GRAD,
                                       VALUES_AND_GRAD_SAVE) else (B, 3),
                      dtype=torch.float32, device=pts.device)
    grad = torch.empty((n_grad, 3) if fused else (B, 4),
                       dtype=torch.float32,
                       device=pts.device) if fused or save else None
    keys = torch.empty(B, dtype=torch.int32,
                       device=pts.device) if keyed else None
    result = (out, grad, keys) if keyed else (
        (out, grad) if fused or save else out)
    if B == 0:
        return result
    lib = _kernels.load()
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    sz = np.asarray(pt.root_sizes, np.float32)
    _kernels.check(lib, lib.hpsdf_packed_eval(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        pt.grid_depth, pt.extra_rounds, pts.data_ptr(), B,
        *map(float, rc), *map(float, inv), *map(float, sz),
        int(outside_max), mode, out.data_ptr(),
        grad.data_ptr() if fused or save else None, n_grad if fused else 0,
        keys.data_ptr() if keyed else None, _kernels.stream_of(pts)),
        "packed_eval")
    packed_eval_kernel.launches += 1
    packed_eval_kernel.grad_launches += int(mode in (NORMALS, NORMALS_SAVE))
    packed_eval_kernel.save_launches += int(save)
    packed_eval_kernel.raw_launches += int(mode == RAW_GRAD)
    packed_eval_kernel.fused_launches += int(fused)
    packed_eval_kernel.key_launches += int(keyed)
    return result


packed_eval_kernel.launches = 0
packed_eval_kernel.grad_launches = 0
packed_eval_kernel.save_launches = 0
packed_eval_kernel.raw_launches = 0
packed_eval_kernel.fused_launches = 0
packed_eval_kernel.key_launches = 0


# what a K5h launch computes (packed_hvp_kernel's ``mode``)
NORMALS_VJP, VALUES_GRAD_VJP = 0, 1


def packed_hvp_kernel(pt: PackedTree, pts: torch.Tensor, mode: int,
                      w: torch.Tensor | None = None,
                      cot3: torch.Tensor | None = None,
                      saved: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K5h on CUDA tensors: the gradient (B, 3) f32 with respect to
    the points of, ``mode`` NORMALS_VJP, sum(cot3 * normals) (``cot3``
    (B, 3)) from ``saved`` (B, 4) f32, what K5's normals forward saved for
    these points (``packed_eval_kernel(..., NORMALS_SAVE)``);
    VALUES_GRAD_VJP, sum(w * values) + sum(cot3 * raw gradients) of
    ``values_and_gradient_at(pt, pts, n_grad)`` (``w`` (B,), ``cot3``
    (n_grad, 3)) from ``saved`` (B,) i32, the keys the fused read saved
    (VALUES_AND_GRAD_SAVE). Hessian-vector products of the packed eval at
    the rows the saved keys name, one launch a call. Raises on anything
    else, a missing ``saved`` too: K5h does not locate."""
    _check_packed(pt, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"packed_hvp_kernel needs CUDA tensors, got "
                         f"{pts.device}")
    B = pts.shape[0]
    f32, i32 = torch.float32, torch.int32
    if mode == NORMALS_VJP:
        need = (("cot3", cot3, (B, 3), f32), ("saved", saved, (B, 4), f32))
    elif mode == VALUES_GRAD_VJP:
        if cot3 is None or cot3.dim() != 2 or not 0 <= cot3.shape[0] <= B:
            raise ValueError("packed_hvp_kernel: cot3 must be (n_grad, 3), "
                             f"n_grad <= {B}")
        need = (("w", w, (B,), f32), ("cot3", cot3, (cot3.shape[0], 3), f32),
                ("saved", saved, (B,), i32))
    else:
        raise ValueError(f"packed_hvp_kernel: unknown mode {mode}")
    for name, t, shape, dtype in need:
        if t is None or t.shape != shape or t.dtype != dtype \
                or t.device != pts.device:
            raise ValueError(f"packed_hvp_kernel: {name} must be {dtype} "
                             f"{shape} on {pts.device}")
    pts = pts.detach().contiguous()
    w = None if w is None else w.detach().contiguous()
    cot3 = cot3.detach().contiguous()
    saved = saved.detach().contiguous()
    out = torch.empty((B, 3), dtype=torch.float32, device=pts.device)
    if B == 0:
        return out
    lib = _kernels.load()
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    sz = np.asarray(pt.root_sizes, np.float32)
    _kernels.check(lib, lib.hpsdf_packed_hvp(
        pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
        pt.grid_depth, pts.data_ptr(), B, *map(float, rc), *map(float, inv),
        *map(float, sz), mode, None if w is None else w.data_ptr(),
        cot3.data_ptr(), cot3.shape[0] if mode == VALUES_GRAD_VJP else B,
        saved.data_ptr(), out.data_ptr(), _kernels.stream_of(pts)),
        "packed_hvp")
    packed_hvp_kernel.launches += 1
    return out


packed_hvp_kernel.launches = 0


def packed_grad_kernel(pt: PackedTree, pts: torch.Tensor, cot: torch.Tensor,
                       form: int, saved: torch.Tensor | None = None):
    """Launch K7 on CUDA tensors: (d_rows, d_grid), the VJP with respect to
    the packed tables of ``values_at`` (form 0, weights ``cot`` (B,)), of
    the raw gradients ``point_gradient_plain`` gives (form 1, cotangents
    ``cot`` (B, 3)) or of ``normals`` (form 2, cotangents ``cot`` (B, 3);
    no axis masked; from ``saved`` (B, 4) f32, what K5's normals forward
    saved for these points, ``packed_eval_kernel(..., NORMALS_SAVE)``), in
    their coefficient lanes, zeros in the others. One launch a call.
    ``form2_launches`` counts form 2's. Raises on anything else."""
    _check_packed(pt, pts)
    if pts.device.type != "cuda":
        raise ValueError(f"packed_grad_kernel needs CUDA tensors, got "
                         f"{pts.device}")
    B = pts.shape[0]
    shape = (B,) if form == 0 else (B, 3)
    if form not in (0, 1, 2) or cot.shape != shape \
            or cot.dtype != torch.float32 or cot.device != pts.device:
        raise ValueError(f"packed_grad_kernel: form {form} takes f32 "
                         f"cotangents {shape}, got {cot.dtype} "
                         f"{tuple(cot.shape)}")
    if (form == 2) != (saved is not None) or form == 2 and (
            saved.shape != (B, 4) or saved.dtype != torch.float32
            or saved.device != pts.device):
        raise ValueError("packed_grad_kernel: form 2, and only form 2, "
                         "takes saved (B, 4) f32 from K5's NORMALS_SAVE")
    lib = _kernels.load()
    n_rows = pt.rows.shape[0]
    size = lib.hpsdf_packed_grad_scratch(B, pt.grid_depth, n_rows, form)
    if size < 0:
        raise ValueError("packed_grad_kernel: too large for 32-bit indices")
    pts = pts.detach().contiguous()
    cot = cot.detach().contiguous()
    d_rows = torch.empty_like(pt.rows, memory_format=torch.contiguous_format)
    d_grid = torch.empty_like(pt.grid, memory_format=torch.contiguous_format)
    scratch = torch.empty(size, dtype=torch.uint8, device=pts.device)
    rc = np.asarray(pt.root_centre, np.float32)
    inv = (1.0 / np.asarray(pt.root_sizes)).astype(np.float32)
    sz = np.asarray(pt.root_sizes, np.float32)
    if form == 2:
        if B == 0:
            return d_rows.zero_(), d_grid.zero_()
        saved = saved.detach().contiguous()
        _kernels.check(lib, lib.hpsdf_normals_grad(
            pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
            pt.grid_depth, n_rows, pts.data_ptr(), B, *map(float, rc),
            *map(float, inv), *map(float, sz), saved.data_ptr(),
            cot.data_ptr(), scratch.data_ptr(), size, d_grid.data_ptr(),
            d_rows.data_ptr(), _kernels.stream_of(pts)), "normals_grad")
    else:
        _kernels.check(lib, lib.hpsdf_packed_grad(
            pt.grid.data_ptr(), pt.rows.data_ptr(), pt.width, pt.deg_used,
            pt.grid_depth, pt.extra_rounds, n_rows, pts.data_ptr(), B,
            *map(float, rc), *map(float, inv), *map(float, sz),
            cot.data_ptr(), int(form), scratch.data_ptr(), size,
            d_grid.data_ptr(), d_rows.data_ptr(), _kernels.stream_of(pts)),
            "packed_grad")
    packed_grad_kernel.launches += 1
    packed_grad_kernel.form2_launches += int(form == 2)
    return d_rows, d_grid


packed_grad_kernel.launches = 0
packed_grad_kernel.form2_launches = 0


def normals_vjp_plain(pt: PackedTree, p: torch.Tensor, wn: torch.Tensor):
    """K7's form 2 and K5h's normals mode by autograd of ``normals_plain``:
    (d_rows, d_grid, d_p) for cotangents wn (B, 3)."""
    return (*_tables_vjp(normals_plain, pt, p, wn),
            _grads(lambda q: normals_plain(pt, q), (p,), wn)[0])


def values_and_gradient_vjp_plain(pt: PackedTree, pts: torch.Tensor,
                                  w: torch.Tensor, u: torch.Tensor):
    """K5h's second mode by autograd of ``values_and_gradient_at_plain``:
    the gradient (B, 3) with respect to the points for cotangents w (B,) of
    the values and u (n_grad, 3) of the raw gradients of the first
    n_grad points."""
    return _grads(lambda q: values_and_gradient_at_plain(pt, q, u.shape[0]),
                  (pts,), (w, u))[0]


class _ValuesAt(torch.autograd.Function):
    """K2, with K7 (form 0) and K5's raw gradient as its VJP."""

    @staticmethod
    def forward(ctx, rows, grid, pts, pt):
        ctx.save_for_backward(pts)
        ctx.pt = pt
        return packed_eval_kernel(pt, pts, VALUES)

    @staticmethod
    def backward(ctx, w):
        (pts,) = ctx.saved_tensors
        pt, w = ctx.pt, w.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = packed_grad_kernel(pt, pts, w, 0)
        if ctx.needs_input_grad[2]:
            d_pts = w[:, None] * packed_eval_kernel(pt, pts, RAW_GRAD)
        return d_rows, d_grid, d_pts, None


class _QueryPacked(torch.autograd.Function):
    """K2 with the f32-max sentinel; its VJP is values_at's with the
    weights zeroed outside the root (the sentinel is a constant): K7's
    form 0 to the tables, K5's raw gradient to the points."""

    @staticmethod
    def forward(ctx, rows, grid, pts, pt):
        ctx.save_for_backward(pts)
        ctx.pt = pt
        return packed_eval_kernel(pt, pts, VALUES, outside_max=True)

    @staticmethod
    def backward(ctx, w):
        (pts,) = ctx.saved_tensors
        inside = torch.all(to_unit(ctx.pt, pts).abs() <= 0.5, dim=-1)
        return _ValuesAt.backward(ctx, torch.where(inside, w, 0.0))


class _ValuesAndGradient(torch.autograd.Function):
    """K2 and K5's raw gradient in one launch (the fused mode), with K7's
    forms 0 and 1 as its VJP with respect to the tables and K5h's second
    mode with respect to the points. Where the points need a gradient the
    forward is VALUES_AND_GRAD_SAVE and saves each point's row key (4 B a
    point) for K5h; elsewhere it saves the points alone."""

    @staticmethod
    def forward(ctx, rows, grid, pts, pt, n_grad):
        ctx.pt, ctx.n_grad = pt, n_grad
        if not ctx.needs_input_grad[2]:
            ctx.save_for_backward(pts)
            return packed_eval_kernel(pt, pts, VALUES_AND_GRAD, n_grad=n_grad)
        v, g, keys = packed_eval_kernel(pt, pts, VALUES_AND_GRAD_SAVE,
                                        n_grad=n_grad)
        ctx.save_for_backward(pts, keys)
        return v, g

    @staticmethod
    def backward(ctx, w, u):
        pts, *keys = ctx.saved_tensors
        pt, w, u = ctx.pt, w.contiguous(), u.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = packed_grad_kernel(pt, pts, w, 0)
            if ctx.n_grad:
                g_rows, g_grid = packed_grad_kernel(pt, pts[:ctx.n_grad], u,
                                                    1)
                d_rows, d_grid = d_rows + g_rows, d_grid + g_grid
        if ctx.needs_input_grad[2]:
            d_pts = packed_hvp_kernel(pt, pts, VALUES_GRAD_VJP, w, u,
                                      keys[0])
        return d_rows, d_grid, d_pts, None, None


class _Normals(torch.autograd.Function):
    """K5's normals, with K7's form 2 as its VJP with respect to the tables
    and K5h's normals mode with respect to the points. ``normals`` applies
    it where the tables or the points need a gradient, and its forward is
    then K5's NORMALS_SAVE: it saves each point's row key and unnormalised
    gradient (16 B a point), which both start from."""

    @staticmethod
    def forward(ctx, rows, grid, pts, pt):
        ctx.pt = pt
        n, saved = packed_eval_kernel(pt, pts, NORMALS_SAVE)
        ctx.save_for_backward(pts, saved)
        return n

    @staticmethod
    def backward(ctx, wn):
        pts, saved = ctx.saved_tensors
        pt, wn = ctx.pt, wn.contiguous()
        d_rows = d_grid = d_pts = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d_rows, d_grid = packed_grad_kernel(pt, pts, wn, 2, saved)
        if ctx.needs_input_grad[2]:
            d_pts = packed_hvp_kernel(pt, pts, NORMALS_VJP, cot3=wn,
                                      saved=saved)
        return d_rows, d_grid, d_pts, None


def values_and_gradient_at_plain(pt: PackedTree, pts: torch.Tensor,
                                 n_grad: int):
    """``values_and_gradient_at`` by the plain versions, whatever the
    device."""
    return values_at_plain(pt, pts), point_gradient_plain(pt, pts[:n_grad])


def values_and_gradient_save_plain(pt: PackedTree, pts: torch.Tensor,
                                   n_grad: int):
    """``values_and_gradient_at_plain`` with what the fused read saves for
    K5h where the points need a gradient (``packed_eval_kernel``'s
    VALUES_AND_GRAD_SAVE): (values (B,), raw gradients (n_grad, 3), keys
    (B,) i32, each point's row key, ``locate_key_plain``'s)."""
    key = locate_key_plain(pt, clip_half(to_unit(pt, pts.detach())))
    return (*values_and_gradient_at_plain(pt, pts, n_grad), key)


def values_and_gradient_points_vjp_plain(pt: PackedTree, pts: torch.Tensor,
                                         keys: torch.Tensor, w: torch.Tensor,
                                         u: torch.Tensor):
    """K5h's second mode from the keys the fused read saved (``keys`` (B,)
    i32, ``values_and_gradient_save_plain``'s): the gradient (B, 3) with
    respect to the points of sum(w * values) + sum(u * raw gradients of the
    first n_grad = len(u) points), by autograd, at the rows the keys
    name."""
    row, n = keyed_rows(pt, keys), u.shape[0]
    return _grads(lambda q: (eval_row(pt, row, clip_half(to_unit(pt, q))),
                             _raw_gradient(pt, q[:n], row[:n])),
                  (pts,), (w, u))[0]


def values_and_gradient_at(pt: PackedTree, pts: torch.Tensor, n_grad: int):
    """(``values_at(pt, pts)``, the raw world-space gradients (n_grad, 3)
    of those values at ``pts[:n_grad]``, times the clamp's slope on each
    axis) in one read: the fused mode of K2/K5 on CUDA tensors (one
    launch), ``values_and_gradient_at_plain`` on CPU tensors.
    Differentiable with respect to ``pt.rows`` and ``pt.grid`` (K7's forms
    0 and 1 on CUDA tensors) and the points (K5h)."""
    if not 0 <= n_grad <= pts.shape[0]:
        raise ValueError(f"values_and_gradient_at: n_grad {n_grad} outside "
                         f"[0, {pts.shape[0]}]")
    if pts.device.type == "cpu":
        return values_and_gradient_at_plain(pt, pts, n_grad)
    if wants_grad(pt.rows, pt.grid, pts):
        return _ValuesAndGradient.apply(pt.rows, pt.grid, pts, pt, n_grad)
    return packed_eval_kernel(pt, pts, VALUES_AND_GRAD, n_grad=n_grad)


def values_at(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    """f32 SDF values at world points (B, 3) f32, boundary-clamped.
    Differentiable with respect to ``pt.rows``, ``pt.grid`` (their
    coefficient lanes) and the points."""
    if pts.device.type == "cpu":
        return values_at_plain(pt, pts)
    if wants_grad(pt.rows, pt.grid, pts):
        return _ValuesAt.apply(pt.rows, pt.grid, pts, pt)
    return packed_eval_kernel(pt, pts, VALUES)


def query_packed(pt: PackedTree, pts: torch.Tensor) -> torch.Tensor:
    """Batched f32 query on the packed layout; points outside the root
    return f32 max, as the reference returns f64 max
    (Source/HP/Octree.cpp:662-702). Differentiable with respect to the
    tables and the points (K7's form 0 and K5's raw gradient on CUDA
    tensors, nothing from outside the root)."""
    if pts.device.type == "cpu":
        return query_packed_plain(pt, pts)
    if wants_grad(pt.rows, pt.grid, pts):
        return _QueryPacked.apply(pt.rows, pt.grid, pts, pt)
    return packed_eval_kernel(pt, pts, VALUES, outside_max=True)


def normals(pt: PackedTree, p: torch.Tensor) -> torch.Tensor:
    """Unit surface normals (B, 3) at world points: K5 on CUDA tensors,
    ``normals_plain`` on CPU tensors. Differentiable with respect to the
    tables (K7's form 2) and the points (K5h)."""
    if p.device.type == "cpu":
        return normals_plain(pt, p)
    if wants_grad(pt.rows, pt.grid, p):
        return _Normals.apply(pt.rows, pt.grid, p, pt)
    return packed_eval_kernel(pt, p, NORMALS)
