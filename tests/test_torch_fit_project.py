"""Kernel K6's plain versions (``build.fit_points_plain``,
``build.fit_project_plain``), the route a CPU tensor takes, against
hpsdf_tpu's point generation (``_FitCache._fused``, hpsdf_tpu/build.py:515-521,
run by jax under jit) and its ``_fit_impl``, on the same numpy-seeded
inputs.

The points must be equal bit for bit: half = 2^-(depth+1) makes half * x
exact, so each coordinate rounds once in both. The projection sums in
other orders (torch's einsums and XLA's): coefficients agree within 1e-14
of the batch's largest |c| and errors within 1e-13 relative in f64, both
within 1e-5 in f32; a polynomial weight whose cell mean passes sqrt 3 (at
a strength that is not an integer) is NaN in both packages. The kernels
themselves need nvcc and a card: ``chip_smoke.py``'s [k6] holds them to
these plain versions. Here a numpy model of the projection kernel's own
summation order (``chip_smoke.k6_model``: each cell's i-slabs split over
the blocks of its cluster, partial sums added in rank order) is held to
hpsdf_tpu's ``_fit_impl`` within the same tolerances, and the split it
assumes to the kernel's source."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import basis as JB
from hpsdf_tpu import build as JBuild
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import build as TB
from hpsdf_tpu_torch import consts

import chip_smoke

from .test_torch_query import few_torch_threads  # noqa: F401

STRENGTH = {"NONE": 0.0, "POLYNOMIAL": 1.5, "EXPONENTIAL": 3.0}
# cell means: one past sqrt 3 (a NaN polynomial weight), the rest well
# inside it
OFFSETS = (0.3, -1.0, 2.4, 0.05)


def _cells(degree, dt, seed):
    """F values uniform in [-1, 1] about each cell's offset, depths 0..10
    and the kept coefficients of a p-refinement (the cell's own lower
    degrees times factors in [0.5, 1.5]), as numpy."""
    rng = np.random.default_rng(seed)
    Q = 4 * degree + 1
    m = len(OFFSETS)
    Fv = (rng.uniform(-1.0, 1.0, (m, Q, Q, Q))
          + np.asarray(OFFSETS)[:, None, None, None]).astype(dt)
    depths = rng.integers(0, consts.TREE_MAX_DEPTH + 1, m).astype(np.int32)
    own, _ = TB.fit_project_plain(
        T.NearnessWeighting.NONE, 0.0, degree, 0, torch.as_tensor(Fv),
        torch.as_tensor(depths), _cn(degree, Fv.dtype), None)
    pw = consts.coeff_count(degree - 1)
    prev = own.numpy()[:, :pw] * rng.uniform(0.5, 1.5, (m, pw)).astype(dt)
    return Fv, depths, prev


def _cn(degree, dt):
    return TB.fit_tables(degree, torch.from_numpy(np.zeros(0, dt)).dtype,
                         torch.device("cpu")).cn


def _both(degree, pw, name, dt, seed=0):
    Fv, depths, prev = _cells(degree, dt, seed + degree)
    s = STRENGTH[name]
    jc, je = JBuild._fit_impl(
        hp.NearnessWeighting[name], s, degree, pw, jnp.asarray(Fv),
        jnp.asarray(depths),
        jnp.asarray(JB.coeff_norms(degree)[depths].astype(dt)),
        jnp.asarray(prev[:, :pw]))
    tc, te = TB.fit_project_plain(
        T.NearnessWeighting[name], s, degree, pw, torch.as_tensor(Fv),
        torch.as_tensor(depths), _cn(degree, dt),
        torch.as_tensor(prev[:, :pw]) if pw else None)
    return (np.asarray(jc), np.asarray(je)), (tc.numpy(), te.numpy())


@pytest.mark.parametrize("name", list(STRENGTH))
@pytest.mark.parametrize("kept", [False, True], ids=["pw0", "pw"])
@pytest.mark.parametrize("degree", [2, 3, 5, 8, 11])
def test_fit_project_plain_against_jax(degree, kept, name,
                                       few_torch_threads):  # noqa: F811
    pw = consts.coeff_count(degree - 1) if kept else 0
    (jc, je), (tc, te) = _both(degree, pw, name, np.float64)
    assert tc.shape == jc.shape == (len(OFFSETS), consts.coeff_count(degree))
    np.testing.assert_allclose(tc, jc, rtol=0,
                               atol=1e-14 * np.abs(jc).max())
    if pw:
        np.testing.assert_array_equal(tc[:, :pw], jc[:, :pw])
    nan = np.isnan(je)
    np.testing.assert_array_equal(np.isnan(te), nan)
    # NaN where the cell mean from c_0 (the kept one when pw > 0) passes
    # sqrt 3, under the polynomial weight only
    _, depths, _ = _cells(degree, np.float64, degree)
    fbar = np.abs(tc[:, 0] * np.exp2(1.5 * depths))
    np.testing.assert_array_equal(
        nan, (fbar > np.sqrt(3.0)) & (name == "POLYNOMIAL"))
    if not pw:
        assert nan.any() == (name == "POLYNOMIAL")
    np.testing.assert_allclose(te[~nan], je[~nan], rtol=1e-13, atol=0)


@pytest.mark.parametrize("name", list(STRENGTH))
@pytest.mark.parametrize("degree", [2, 5])
def test_fit_project_plain_against_jax_f32(degree, name,
                                           few_torch_threads):  # noqa: F811
    pw = consts.coeff_count(degree - 1)
    (jc, je), (tc, te) = _both(degree, pw, name, np.float32)
    assert tc.dtype == jc.dtype == np.float32
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-5 * np.abs(jc).max())
    nan = np.isnan(je)
    np.testing.assert_array_equal(np.isnan(te), nan)
    np.testing.assert_allclose(te[~nan], je[~nan], rtol=1e-5, atol=0)


@pytest.mark.parametrize("degree", list(TB.FIT_DEGREES))
def test_split_sums_against_jax(degree, few_torch_threads):  # noqa: F811
    """The projection kernel's summation order (csrc/fit.cu: a cell's
    i-slabs split evenly over the K6_SPLIT[degree] blocks of a cluster,
    each block's sum over its slabs in index order, the partial sums added
    in rank order), modelled in numpy f64 by ``chip_smoke.k6_model``,
    against hpsdf_tpu's ``_fit_impl``: coefficients within 1e-14 of the
    batch's largest |c|, errors within 1e-13 relative, as the plain
    version is held."""
    Fv, depths, _ = _cells(degree, np.float64, degree)
    jc, je = JBuild._fit_impl(
        hp.NearnessWeighting.NONE, 0.0, degree, 0, jnp.asarray(Fv),
        jnp.asarray(depths), jnp.asarray(JB.coeff_norms(degree)[depths]),
        jnp.asarray(np.zeros((len(OFFSETS), 0))))
    split = chip_smoke.K6_SPLIT[degree]
    mc, me = chip_smoke.k6_model(Fv, depths, degree, split)
    jc, je = np.asarray(jc), np.asarray(je)
    assert mc.shape == jc.shape == (len(OFFSETS), consts.coeff_count(degree))
    np.testing.assert_allclose(mc, jc, rtol=0, atol=1e-14 * np.abs(jc).max())
    np.testing.assert_allclose(me, je, rtol=1e-13, atol=0)
    # the split sums differ from one block's in the last bits somewhere:
    # the model sums what the kernel sums, not the unsplit order
    if split > 1:
        one, _ = chip_smoke.k6_model(Fv, depths, degree, 1)
        assert not np.array_equal(mc, one)


def test_split_table_is_the_kernels():
    """chip_smoke.K6_SPLIT and K6_CELLS, which the model and [k6] take, are
    csrc/fit.cu's kSplit and kCells; k6_ranges covers a cell's Q slabs
    once, in S ranges whose sizes differ by one at most."""
    path = os.path.join(os.path.dirname(TB.__file__), "csrc", "fit.cu")
    with open(path) as fh:
        src = fh.read()
    for name, table in (("kSplit", chip_smoke.K6_SPLIT),
                        ("kCells", chip_smoke.K6_CELLS)):
        vals = re.search(name + r"\[12\] = \{([^}]*)\}", src)[1]
        vals = [int(v) for v in vals.split(",")]
        assert {d: vals[d] for d in TB.FIT_DEGREES} == table
    for degree in TB.FIT_DEGREES:
        ranges = chip_smoke.k6_ranges(degree, chip_smoke.K6_SPLIT[degree])
        assert ranges[0][0] == 0 and ranges[-1][1] == 4 * degree + 1
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [b - a for a, b in ranges]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


def _jax_points(degree, dt):
    """hpsdf_tpu/build.py:515-521 as _FitCache._fused runs it, under jit."""
    Q = JB.fit_rule_size(degree)
    xj = np.asarray(JB.leggauss(Q)[0], dt)

    @jax.jit
    def points(c, d):
        cc = c.shape[0]
        half = jnp.exp2(-(d.astype(c.dtype) + 1.0))
        gax = c[:, :, None] + half[:, None, None] * xj
        px = jnp.broadcast_to(gax[:, 0, :, None, None], (cc, Q, Q, Q))
        py = jnp.broadcast_to(gax[:, 1, None, :, None], (cc, Q, Q, Q))
        pz = jnp.broadcast_to(gax[:, 2, None, None, :], (cc, Q, Q, Q))
        return jnp.stack([px, py, pz], axis=-1).reshape(-1, 3)
    return points


@pytest.mark.parametrize("dt", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("degree", list(TB.FIT_DEGREES))
def test_fit_points_plain_bit_for_bit_jax(degree, dt,
                                          few_torch_threads):  # noqa: F811
    """The port's points are c + 2^-(depth+1) x rounded once, bit for bit,
    at every depth 0..10; so are hpsdf_tpu's wherever XLA's exp2 gives half
    exactly. On the CPU its f64 exp2 is an ulp off 2^-(depth+1) at some
    depths (2, 5, 6, 7 and 10 in this jax), and there its points may differ
    from the port's by two ulps of the larger of half and the point."""
    rng = np.random.default_rng(degree)
    m = consts.TREE_MAX_DEPTH + 1
    c = rng.uniform(-0.5, 0.5, (m, 3)).astype(dt)
    d = np.arange(m, dtype=np.int32)
    Q = 4 * degree + 1
    got = TB.fit_points_plain(torch.as_tensor(c), torch.as_tensor(d),
                              degree).numpy()
    assert got.shape == (m * Q ** 3, 3) and got.dtype == dt
    gax = c[:, :, None] + np.ldexp(JB.leggauss(Q)[0].astype(dt)[None, :],
                                   -(d[:, None] + 1))[:, None, :]
    exact = np.stack(np.broadcast_arrays(gax[:, 0, :, None, None],
                                         gax[:, 1, None, :, None],
                                         gax[:, 2, None, None, :]), axis=-1)
    np.testing.assert_array_equal(got, exact.reshape(-1, 3))

    want = np.asarray(_jax_points(degree, dt)(jnp.asarray(c),
                                              jnp.asarray(d)))
    half = np.asarray(jax.jit(lambda d: jnp.exp2(-(d.astype(dt) + 1.0)))(
        jnp.asarray(d)))
    ok = half == np.ldexp(np.ones(m, dt), -(d + 1))
    assert ok.any()
    got, want = got.reshape(m, -1), want.reshape(m, -1)
    np.testing.assert_array_equal(got[ok], want[ok])
    # half one ulp off moves half * x by an ulp of half, then the add
    # rounds: two ulps of the larger of half and the point
    near = 2 * np.spacing(np.maximum(np.abs(got), half[:, None]))
    assert (np.abs(got - want) <= near)[~ok].all()


def test_cpu_route_launches_nothing(few_torch_threads):  # noqa: F811
    """A build on the CPU runs the plain versions: neither K6 counter
    moves, and the build's fits went through _fit_impl."""
    n0 = (TB.fit_points_kernel.launches, TB.fit_project_kernel.launches)
    tree = T.build_octree(
        T.Config(target_error=1e-5, continuity=False, max_depth=4,
                 max_degree=4),
        lambda p: torch.linalg.norm(p, dim=-1) - 0.3, device="cpu")
    assert tree.deg_used >= 2
    assert (TB.fit_points_kernel.launches,
            TB.fit_project_kernel.launches) == n0 == (0, 0)


def test_fit_impl_rows_on_cpu(few_torch_threads):  # noqa: F811
    """On CPU tensors _fit_impl writes the plain version's (coeffs, err)
    into the rows [coeffs | err] it is given and returns views of them."""
    Fv, depths, prev = _cells(3, np.float64, 7)
    args = (T.NearnessWeighting.EXPONENTIAL, 3.0, 3, prev.shape[1],
            torch.as_tensor(Fv), torch.as_tensor(depths), _cn(3, np.float64),
            torch.as_tensor(prev))
    coeffs, err = TB.fit_project_plain(*args)
    rows = torch.full((len(OFFSETS), consts.coeff_count(3) + 1), np.nan,
                      dtype=torch.float64)
    c, e = TB._fit_impl(*args, rows)
    assert torch.equal(rows[:, :-1], coeffs) and torch.equal(rows[:, -1], err)
    assert c.data_ptr() == rows.data_ptr() and torch.equal(e, err)


def test_kernel_wrappers_refuse(few_torch_threads):  # noqa: F811
    """The kernels' wrappers take CUDA tensors, f32 or f64, int32 depths
    and degrees 2..11 only: no fallback to the plain versions."""
    c = torch.zeros((2, 3), dtype=torch.float64)
    d = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        TB.fit_points_kernel(c, d, 3)
    with pytest.raises(ValueError, match="degree 12 outside 2..11"):
        TB.fit_points_kernel(c, d, 12)
    Fv = torch.zeros((2, 13, 13, 13), dtype=torch.float64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        TB.fit_project_kernel(T.NearnessWeighting.NONE, 0.0, 3, 0, Fv, d,
                              _cn(3, np.float64), None)
    with pytest.raises(ValueError, match="degree 12 outside 2..11"):
        TB.fit_project_kernel(T.NearnessWeighting.NONE, 0.0, 12, 0, Fv, d,
                              _cn(3, np.float64), None)
    assert (TB.fit_points_kernel.launches,
            TB.fit_project_kernel.launches) == (0, 0)
