"""Parity of hpsdf_tpu_torch.basis with hpsdf_tpu.basis (f64, atol 1e-12):
the Legendre recurrences and the basis evaluation that kernel K1 fuses."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import basis as jb
from hpsdf_tpu_torch import basis as tb

ATOL = 1e-12


@pytest.mark.parametrize("degree", [0, 1, 5, 12])
def test_legendre_all_and_derivative(degree):
    x = np.random.default_rng(degree).uniform(-1.0, 1.0, (257, 3))
    np.testing.assert_allclose(
        tb.legendre_all(torch.as_tensor(x), degree).numpy(),
        np.asarray(jb.legendre_all(jnp.asarray(x), degree)), rtol=0,
        atol=ATOL)
    L_t, dL_t = tb.legendre_all_with_derivative(torch.as_tensor(x), degree)
    L_j, dL_j = jb.legendre_all_with_derivative(jnp.asarray(x), degree)
    np.testing.assert_allclose(L_t.numpy(), np.asarray(L_j), rtol=0,
                               atol=ATOL)
    # |L'_p| <= p(p+1)/2 grows to 78 at p = 12: hold it relative to that
    np.testing.assert_allclose(dL_t.numpy(), np.asarray(dL_j), rtol=0,
                               atol=ATOL * max(1, degree * (degree + 1) / 2))


def test_host_tables_equal():
    for degree in (2, 6, 12):
        np.testing.assert_array_equal(tb.basis_indices(degree),
                                      jb.basis_indices(degree))
        np.testing.assert_array_equal(tb.coeff_norms(degree),
                                      jb.coeff_norms(degree))
        np.testing.assert_array_equal(tb.quadrature_matrix(degree),
                                      jb.quadrature_matrix(degree))


@pytest.mark.parametrize("degree", [2, 6])
def test_eval_basis_and_grad(degree):
    rng = np.random.default_rng(10 + degree)
    n, C = 500, jb.coeff_norms(degree).shape[1]
    depth = rng.integers(0, 7, n).astype(np.int32)
    # coefficients scaled by 1/norm, as a fit produces them: O(1) terms
    coeffs = rng.normal(size=(n, C)) / jb.coeff_norms(degree)[depth]
    unit = rng.uniform(-1.0, 1.0, (n, 3))

    v_t = tb.eval_basis(torch.as_tensor(coeffs), torch.as_tensor(unit),
                        torch.as_tensor(depth), degree).numpy()
    v_j = np.asarray(jb.eval_basis(jnp.asarray(coeffs), jnp.asarray(unit),
                                   jnp.asarray(depth), degree))
    np.testing.assert_allclose(v_t, v_j, rtol=0, atol=ATOL)

    gv_t, g_t = tb.eval_basis_grad(torch.as_tensor(coeffs),
                                   torch.as_tensor(unit),
                                   torch.as_tensor(depth), degree)
    gv_j, g_j = jb.eval_basis_grad(jnp.asarray(coeffs), jnp.asarray(unit),
                                   jnp.asarray(depth), degree)
    np.testing.assert_allclose(gv_t.numpy(), np.asarray(gv_j), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                               atol=ATOL * degree * (degree + 1) / 2)
