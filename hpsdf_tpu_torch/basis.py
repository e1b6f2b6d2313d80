"""Legendre basis machinery: host tables in numpy, evaluation in torch.

The counterpart of ``hpsdf_tpu/basis.py``. The host tables are copied from
it verbatim (numpy, f64, cached):

  * ``leggauss``, ``fit_rule_size``, ``face_rule_size``,
    ``basis_indices``, ``norm_table``, ``coeff_norms``,
    ``quadrature_matrix``, ``legendre_all_np``.

The evaluation functions take and return torch tensors on any device. They
are the plain versions behind the query kernel (``csrc/query.cu``), which
fuses the same recurrences per point.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .consts import BASIS_MAX_DEGREE, TREE_MAX_DEPTH, coeff_count


# --------------------------------------------------------------------------
# Host-side tables (numpy, f64)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def leggauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights of the ``n``-point rule on [-1, 1]
    (the reference's literal tables, Include/HP/Legendre.h:7,2091)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


def fit_rule_size(degree: int) -> int:
    """Quadrature points per axis for a degree-``degree`` fit: the
    (4d+1)-point rule (Source/HP/Octree.cpp:1016-1017)."""
    return 4 * degree + 1


def face_rule_size(max_degree: int) -> int:
    """Quadrature points per axis for the cross-depth shared-face integral
    of the continuity matrix: the (maxDegree+1)-point rule
    (Source/HP/Octree.cpp:1270-1272)."""
    return max_degree + 1


@functools.lru_cache(maxsize=None)
def basis_indices(degree: int) -> np.ndarray:
    """(C, 3) int32 basis exponent triples, ordered as the reference's
    BasisIndexValues (Include/HP/Utility.h:133-160): by total degree p
    ascending, then lexicographic in (i, j, k)."""
    out = []
    for p in range(degree + 1):
        for i in range(p + 1):
            for j in range(p - i + 1):
                out.append((i, j, p - i - j))
    arr = np.asarray(out, dtype=np.int32)
    assert arr.shape[0] == coeff_count(degree)
    return arr


@functools.lru_cache(maxsize=None)
def norm_table() -> np.ndarray:
    """norm[p, depth] = sqrt((2p+1) * 2**depth) (Include/HP/Utility.h:63-78)."""
    p = np.arange(BASIS_MAX_DEGREE + 1, dtype=np.float64)[:, None]
    d = np.arange(TREE_MAX_DEPTH + 1, dtype=np.float64)[None, :]
    return np.sqrt((2.0 * p + 1.0) * np.exp2(d))


@functools.lru_cache(maxsize=None)
def coeff_norms(degree: int) -> np.ndarray:
    """(TREE_MAX_DEPTH+1, C) table: product over axes of norm_table for each
    basis triple, per depth."""
    idx = basis_indices(degree)
    nt = norm_table()
    return nt[idx[:, 0], :].T * nt[idx[:, 1], :].T * nt[idx[:, 2], :].T


@functools.lru_cache(maxsize=None)
def quadrature_matrix(degree: int) -> np.ndarray:
    """A[p, q] = w_q * L_p(x_q) for the fit rule of ``degree``, shape
    (degree+1, 4*degree+1). Contracting F samples against A along each axis
    is the separable Gauss-Legendre projection
    (Source/HP/Octree.cpp:1028-1056)."""
    x, w = leggauss(fit_rule_size(degree))
    Lv = np.ones((degree + 1, x.size), dtype=np.float64)
    if degree >= 1:
        Lv[1] = x
    for p in range(2, degree + 1):
        Lv[p] = ((2 * p - 1) / p) * x * Lv[p - 1] - ((p - 1) / p) * Lv[p - 2]
    return Lv * w[None, :]


def legendre_all_np(x: np.ndarray, degree: int) -> np.ndarray:
    """Host-side L_0..L_degree evaluation; returns shape (degree+1,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.ones((degree + 1,) + x.shape, dtype=np.float64)
    if degree >= 1:
        out[1] = x
    for p in range(2, degree + 1):
        out[p] = ((2 * p - 1) / p) * x * out[p - 1] - ((p - 1) / p) * out[p - 2]
    return out


# --------------------------------------------------------------------------
# Evaluation (torch)
# --------------------------------------------------------------------------

def legendre_all(x: torch.Tensor, degree: int) -> torch.Tensor:
    """L_0..L_degree at ``x`` by the three-term recurrence; returns shape
    x.shape + (degree+1,) (reference: Source/HP/Octree.cpp:988-1004)."""
    vals = [torch.ones_like(x)]
    if degree >= 1:
        vals.append(x)
    for p in range(2, degree + 1):
        vals.append(((2.0 * p - 1.0) / p) * x * vals[p - 1]
                    - ((p - 1.0) / p) * vals[p - 2])
    return torch.stack(vals, dim=-1)


def legendre_all_with_derivative(x: torch.Tensor, degree: int):
    """L_p(x) and L'_p(x) for p = 0..degree, by the derivative recurrence
    L'_p = L'_{p-2} + (2p-1) L_{p-1}."""
    L = legendre_all(x, degree)
    dvals = [torch.zeros_like(x)]
    if degree >= 1:
        dvals.append(torch.ones_like(x))
    for p in range(2, degree + 1):
        dvals.append(dvals[p - 2] + (2.0 * p - 1.0) * L[..., p - 1])
    return L, torch.stack(dvals, dim=-1)


def legendre_second_derivative(dL: torch.Tensor, degree: int) -> torch.Tensor:
    """L''_p for p = 0..degree from L'_p (..., degree+1) by the recurrence
    L''_p = L''_{p-2} + (2p-1) L'_{p-1}: the plain version of the second
    derivative the backward kernels K1h and K5h sum their Hessians with
    (``legendre_deriv2``, csrc/packed_rows.cuh)."""
    zero = torch.zeros_like(dL[..., 0])
    vals = [zero, zero] if degree >= 1 else [zero]
    for p in range(2, degree + 1):
        vals.append(vals[p - 2] + (2.0 * p - 1.0) * dL[..., p - 1])
    return torch.stack(vals, dim=-1)


def _tables(degree: int, like: torch.Tensor):
    idx = torch.as_tensor(basis_indices(degree), dtype=torch.long,
                          device=like.device)
    norms = torch.as_tensor(coeff_norms(degree), dtype=like.dtype,
                            device=like.device)
    return idx, norms


def eval_basis(coeffs: torch.Tensor, unit_pt: torch.Tensor,
               depth: torch.Tensor, degree: int) -> torch.Tensor:
    """Evaluate node bases at local points (FApprox, Octree.cpp:859-901).

    coeffs (..., C), unit_pt (..., 3) in the node's [-1, 1]^3 frame,
    depth (...,) integer node depths. Returns (...,) values.
    """
    idx, norms = _tables(degree, coeffs)
    L = legendre_all(unit_pt, degree)                            # (..., 3, P+1)
    Lx = L[..., 0, idx[:, 0]]
    Ly = L[..., 1, idx[:, 1]]
    Lz = L[..., 2, idx[:, 2]]
    n = norms[depth.long()]
    return torch.sum(coeffs * Lx * Ly * Lz * n, dim=-1)


def eval_basis_grad(coeffs: torch.Tensor, unit_pt: torch.Tensor,
                    depth: torch.Tensor, degree: int):
    """Value and local-frame gradient of the node basis (analytic, in place
    of FApproxWithGradient's central differences, Octree.cpp:904-985).
    Returns (value (...,), grad (..., 3))."""
    idx, norms = _tables(degree, coeffs)
    L, dL = legendre_all_with_derivative(unit_pt, degree)
    Lx, Ly, Lz = (L[..., a, idx[:, a]] for a in range(3))
    dLx, dLy, dLz = (dL[..., a, idx[:, a]] for a in range(3))
    cn = coeffs * norms[depth.long()]
    val = torch.sum(cn * Lx * Ly * Lz, dim=-1)
    gx = torch.sum(cn * dLx * Ly * Lz, dim=-1)
    gy = torch.sum(cn * Lx * dLy * Lz, dim=-1)
    gz = torch.sum(cn * Lx * Ly * dLz, dim=-1)
    return val, torch.stack([gx, gy, gz], dim=-1)
