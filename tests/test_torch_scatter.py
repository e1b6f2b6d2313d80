"""G's backward from the inverse of its indices (hpsdf_tpu_torch.accel on
CPU tensors): the host CSR that ``pack_support`` keeps for the repack's
grid (``gather_csr`` of ``grid_src``) and the plain version of the CSR
gather-sum (``row_scatter_csr_plain``), which the CUDA kernel
``row_scatter_csr_kernel`` is held to on the card, against
``row_scatter_plain`` (index_add_) and jax.grad of hpsdf_tpu's gather with
G2's out-of-range rule; the ctypes signatures of every kernel entry point
against the C sources; and the 7n points of an inverse chunk's
``values_at`` call, at which chip_smoke.py times K7.

Tolerance: f32 sums in another order than the reference's, 1e-5 relative
to the largest entry (as tests/test_torch_grad.py).
"""

import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import _kernels
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import tree as TT

import chip_smoke

from .test_torch_query import few_torch_threads  # noqa: F401

RTOL32 = 1e-5


def _close(got, want, rtol=RTOL32):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _random_tree(seed, max_depth=4, degree=2):
    """A random octree: the root split, then each node split with
    probability 0.55 down to ``max_depth``, children in blocks of eight;
    leaves of basis ``degree`` with seeded coefficients."""
    rng = np.random.default_rng(seed)
    child, centre, depth = [-1], [(0.0, 0.0, 0.0)], [0]
    todo = [0]
    while todo:
        i = todo.pop(0)
        if depth[i] >= max_depth or (i and rng.random() >= 0.55):
            continue
        child[i] = len(child)
        q = 2.0 ** -(depth[i] + 2)
        for o in range(8):
            centre.append(tuple(centre[i][a] + (q if o >> a & 1 else -q)
                                for a in range(3)))
            child.append(-1)
            depth.append(depth[i] + 1)
            todo.append(len(child) - 1)
    child = np.asarray(child, np.int32)
    leaf = child < 0
    C = (degree + 1) * (degree + 2) * (degree + 3) // 6
    coeffs = rng.standard_normal((len(child), C)) * leaf[:, None]
    return TT.pack(child, np.asarray(centre), np.asarray(depth, np.int32),
                   np.where(leaf, degree, -1).astype(np.int32), coeffs,
                   len(child), T.Config(continuity=False), device="cpu")


def _sphere(cfg, centre=(0.0, 0.0, 0.0), radius=0.3):
    c = torch.tensor(centre, dtype=torch.float64)
    return T.build_octree(cfg, lambda p: torch.linalg.norm(
        p - c.to(p.dtype), dim=-1) - radius, device="cpu")


_TREES = {
    # chip_smoke.py's slice config on the analytic sphere, and its
    # reference-default tree (bench.py:289-298)
    "slice": lambda: _sphere(T.Config(target_error=1e-7, max_depth=5,
                                      max_degree=6, continuity=False)),
    "refdefault": lambda: _sphere(
        T.Config(target_error=1e-10, continuity=False,
                 nearness_weighting=T.NearnessWeighting.EXPONENTIAL,
                 nearness_strength=3.0, max_degree=12, max_depth=10),
        centre=(0.25, 0.0, 0.0), radius=0.5),
    **{f"random{s}": (lambda s=s: _random_tree(s)) for s in range(3)},
}


@pytest.mark.parametrize("name", sorted(_TREES))
def test_grid_csr_inverts_grid_src(name):
    """pack_support's CSR is exactly the inverse of grid_src: node r's
    cells, ascending, at grid_cells[grid_offsets[r]:grid_offsets[r + 1]];
    a node behind no cell (internal, deeper than the grid, padding) has
    an empty row, and a leaf above the grid depth a row of 8^(gd - depth)
    cells."""
    tree = _TREES[name]()
    sup = TA.pack_support(tree)
    src = sup.grid_src.numpy()
    off, cells = sup.grid_offsets.numpy(), sup.grid_cells.numpy()
    n = tree.child_idx.shape[0]
    assert sup.grid_offsets.dtype == sup.grid_cells.dtype == torch.int32
    assert off.shape == (n + 1,) and off[0] == 0 and off[-1] == src.size
    assert cells.shape == src.shape and np.all(np.diff(off) >= 0)
    gd = int(round(np.log2(src.size) / 3))
    depth = tree.depth.numpy()
    for r in range(n):
        row = cells[off[r]:off[r + 1]]
        np.testing.assert_array_equal(row, np.flatnonzero(src == r))
        if row.size:
            assert depth[r] <= gd and row.size == 8 ** (gd - depth[r])
    assert (np.diff(off) == 0).any()             # some rows are empty


def test_grid_csr_root_leaf_covers_every_cell():
    """A tree that is one leaf: every cell of a depth-2 grid reads the root,
    so its one row holds all 64 cells, in order."""
    tree = TT.pack(np.asarray([-1], np.int32), np.zeros((1, 3)),
                   np.zeros(1, np.int32), np.zeros(1, np.int32),
                   np.ones((1, 1)), 1, T.Config(continuity=False),
                   device="cpu")
    sup = TA.pack_support(tree, grid_depth=2)
    assert sup.grid_offsets.tolist()[:2] == [0, 64]
    assert (sup.grid_offsets[1:] == 64).all()    # the padding rows: empty
    np.testing.assert_array_equal(sup.grid_cells.numpy(), np.arange(64))


def test_gather_csr_drops_out_of_range():
    off, order = TA.gather_csr(np.asarray([3, -1, 3, 0, 7, 3, 5]), 5)
    assert off.dtype == order.dtype == np.int32
    np.testing.assert_array_equal(off, [0, 1, 1, 1, 4, 4])
    np.testing.assert_array_equal(order, [3, 0, 2, 5])
    off, order = TA.gather_csr(np.zeros(0, np.int32), 3)
    np.testing.assert_array_equal(off, [0, 0, 0, 0])
    assert order.size == 0


def _scatter_cases(rng, n):
    return {
        "random": rng.integers(0, n, 3 * n),
        "out_of_range": rng.integers(-n, 2 * n, 3 * n),
        "one_row": np.full(2 * n, n // 3),
        "empty": np.zeros(0, np.int64),
    }


@pytest.mark.parametrize("case", ["random", "out_of_range", "one_row",
                                  "empty"])
def test_row_scatter_csr_plain_against_jax(case):
    """The CSR gather-sum against jax.grad of the gather (zeros outside
    [0, n), negative indices included) and against index_add_."""
    rng = np.random.default_rng(11)
    n, W = 37, 12
    idx = _scatter_cases(rng, n)[case].astype(np.int32)
    cot = rng.standard_normal((idx.size, W)).astype(np.float32)
    ok = jnp.asarray((idx >= 0) & (idx < n))[:, None]
    clip = jnp.asarray(np.clip(idx, 0, n - 1))
    want = jax.grad(lambda tab: jnp.sum(jnp.asarray(cot) * jnp.where(
        ok, tab[clip], 0.0)))(jnp.zeros((n, W), jnp.float32))
    off, order = (torch.as_tensor(a) for a in TA.gather_csr(idx, n))
    got = TA.row_scatter_csr_plain(torch.as_tensor(cot), off, order)
    assert got.shape == (n, W) and got.dtype == torch.float32
    _close(got, want)
    _close(got, TA.row_scatter_plain(torch.as_tensor(cot),
                                     torch.as_tensor(idx), n))
    if case == "empty":
        assert not got.any()


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 40), B=st.integers(0, 160),
       W=st.sampled_from([4, 8, 32]), seed=st.integers(0, 2 ** 31 - 1))
def test_row_scatter_csr_plain_random(n, B, W, seed):
    """Random indices, some outside [0, n): the CSR gather-sum, and the
    dispatcher given the CSR, equal index_add_ (the same adds, a row's in
    ascending b)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, n + 3, B).astype(np.int32)
    d_out = torch.as_tensor(rng.standard_normal((B, W)).astype(np.float32))
    csr = tuple(torch.as_tensor(a) for a in TA.gather_csr(idx, n))
    want = TA.row_scatter_plain(d_out, torch.as_tensor(idx), n)
    _close(TA.row_scatter_csr_plain(d_out, *csr), want)
    _close(TA.row_scatter(d_out, torch.as_tensor(idx), n, csr), want)


def test_repack_folded_backward_takes_the_grid_csr(monkeypatch):
    """repack_folded hands the support's CSR to G's backward: the gradient
    of the grid reaches the folded coefficients through the CSR form, and
    equals the index_add_ form's."""
    tree = _random_tree(5)
    pt, sup = TA.pack_tree(tree), TA.pack_support(tree)
    folded = (tree.coeffs * sup.fold).float()
    cot = torch.as_tensor(np.random.default_rng(2).standard_normal(
        pt.grid.shape).astype(np.float32))
    calls, plain = [], TA.row_scatter_csr_plain

    def csr_plain(d_out, offsets, order):
        calls.append(offsets.shape[0])
        return plain(d_out, offsets, order)

    monkeypatch.setattr(TA, "row_scatter_csr_plain", csr_plain)

    def grad():
        F = folded.clone().requires_grad_(True)
        (TA.repack_folded(pt, sup, F).grid * cot).sum().backward()
        return F.grad

    got = grad()
    assert calls == [pt.rows.shape[0] + 1]
    want = TA.row_scatter_plain(cot, sup.grid_src, pt.rows.shape[0])
    _close(got, want[:, TA.COEFF_LANE:TA.COEFF_LANE + folded.shape[1]])


def test_row_scatter_checks_the_csr():
    d_out, idx = torch.zeros((4, 8)), torch.zeros(4, dtype=torch.int32)
    good = tuple(torch.as_tensor(a) for a in TA.gather_csr(idx.numpy(), 3))
    for bad in ((good[0][:-1], good[1]), (good[0].long(), good[1]),
                (good[0], good[1].double())):
        with pytest.raises(ValueError, match="csr"):
            TA.row_scatter(d_out, idx, 3, bad)
    assert TA.row_scatter(d_out, idx, 3, good).shape == (3, 8)


_CTYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "float": ctypes.c_float, "double": ctypes.c_double}


def _c_signatures():
    """Each extern "C" entry point of csrc/ (and csrc/check/):
    its return type and its parameters as ctypes types, pointers as
    c_void_p."""
    out = {}
    for path in _kernels.sources() + _kernels.sources("check"):
        text = open(path).read()
        for m in re.finditer(
                r'extern "C" (int|int64_t) (hpsdf_\w+)\(([^)]*)\)', text):
            params = []
            for p in filter(str.strip, m.group(3).split(",")):
                p = " ".join(p.split())
                params.append(ctypes.c_void_p if "*" in p else
                              _CTYPES[p.rsplit(" ", 1)[0]
                                      .replace("const ", "")
                                      .replace("int32_t", "int")])
            out[m.group(2)] = (_CTYPES[m.group(1)], params)
    return out


def test_ctypes_signatures_match_the_sources():
    """The argument types _kernels declares for every entry point are the
    C sources' (ctypes passes what it is told: a wrong one corrupts the
    launch without an error), and every entry point of the sources is
    bound."""
    c = _c_signatures()
    sizes = {**_kernels._SIZE_SIGNATURES, **_kernels._CHECK_SIZE_SIGNATURES}
    bound = {**_kernels._SIGNATURES, **_kernels._CHECK_SIGNATURES, **sizes}
    assert set(bound) == set(c)
    assert {"hpsdf_fit_points", "hpsdf_fit_project",
            "hpsdf_fit_project_shape"} <= set(_kernels._SIGNATURES)
    assert {"hpsdf_fit_points_reference", "hpsdf_fit_project_reference",
            "hpsdf_inverse_terms_reference"} \
        <= set(_kernels._CHECK_SIGNATURES)
    # K13's terms: the forward (the loss) and the backward (the VJP) in
    # launches of their own; the single launch of before only in check/
    assert {"hpsdf_inverse_loss", "hpsdf_inverse_vjp",
            "hpsdf_signed_from_best"} <= set(_kernels._SIGNATURES)
    assert "hpsdf_inverse_terms" not in bound
    for name, args in bound.items():
        ret, params = c[name]
        assert list(args) == params, name
        assert ret is (ctypes.c_int64 if name in sizes else ctypes.c_int), \
            name


def test_k8_root_table_is_correctly_rounded():
    """K8's table of roots (csrc/coeff_scatter.cu odd_root): case 2q + odd
    holds sqrt(2q + 1) or sqrt(2 (2q + 1)) correctly rounded, for every
    degree's q <= 12, so that times 2^(d >> 1) it is the double
    sqrt((2q + 1) 2^d) the kernel it replaced computed, bit for bit."""
    import math

    path = os.path.join(os.path.dirname(_kernels.__file__), "csrc",
                        "coeff_scatter.cu")
    with open(path) as fh:
        body = fh.read().split("double odd_root(int q, int odd) {", 1)[1]
    body = body.split("\n}\n", 1)[0]
    got = {int(k): float(v) for k, v in
           re.findall(r"case (\d+): return ([0-9.]+);", body)}
    got[25] = float(re.search(r"default: return ([0-9.]+);", body)[1])
    assert sorted(got) == list(range(26))
    for q in range(13):
        for odd in (0, 1):
            want = math.sqrt((2 * q + 1) * (1 + odd))
            assert got[2 * q + odd] == want, (q, odd)
            for d in (odd, odd + 2, odd + 8):
                assert math.ldexp(want, d >> 1) == \
                    math.sqrt((2 * q + 1) * math.ldexp(1.0, d))


def test_inverse_points_are_values_at_points(monkeypatch):
    """chip_smoke.inverse_points gives the 7n points that an inverse
    chunk's terms read with values_and_gradient_at, in their order, and
    its band_points the first 3n, whose raw gradients it reads."""
    from hpsdf_tpu_torch import inverse

    tree = _sphere(T.Config(target_error=1e-3, max_depth=4, max_degree=2,
                            continuity=False))
    o, d = T.camera_rays((0.0, 0.0, -1.8), (0.0, 0.0, 0.0), width=8,
                         height=6, device="cpu")
    t_star, hit = inverse.render_targets(tree, o, d, t_max=5.0)
    s = {"o": o, "d": d, "t_star": t_star}
    seen = {}

    def fused(pk, pts, n_grad):
        seen["values_at"] = pts.detach().clone()
        seen["grad"] = pts[:n_grad].detach().clone()
        return TA.values_and_gradient_at_plain(pk, pts, n_grad)

    monkeypatch.setattr(TA, "values_and_gradient_at", fused)
    one = torch.tensor(1.0)
    inverse.chunk_loss(TA.pack_tree(tree), o, d, t_star, hit, t_star, hit,
                       one, one, 1.0, 0.1, 0.1)
    rays = slice(0, o.shape[0])
    np.testing.assert_array_equal(seen["values_at"].numpy(),
                                  chip_smoke.inverse_points(s, rays).numpy())
    np.testing.assert_array_equal(seen["grad"].numpy(),
                                  chip_smoke.band_points(s, rays).numpy())
    assert seen["values_at"].shape[0] == 7 * o.shape[0]


def test_backward_reference_kernels_are_checks_only():
    """The earlier forms of K7, G's backward and K8 live only under
    csrc/check/ with entry points of their own, bound only for the checks;
    the shipped K7 and G's backward group by row (group.cuh) instead of
    summing a warp's lanes before per-point atomics (scatter.cuh's PeerSum),
    G's backward adds with no atomic, and the shipped K8 sums each term
    over a warp's rays in one lane (a transposed scatter) where its earlier
    form summed by PeerSum."""
    pkg = os.path.dirname(_kernels.__file__)
    for name, entry in (("packed_grad_reference.cu",
                         "hpsdf_packed_grad_reference"),
                        ("row_scatter_reference.cu",
                         "hpsdf_row_scatter_reference"),
                        ("coeff_scatter_reference.cu",
                         "hpsdf_coeff_scatter_reference")):
        with open(os.path.join(pkg, "csrc", "check", name)) as fh:
            text = fh.read()
        assert f'extern "C" int {entry}(' in text
        assert entry in _kernels._CHECK_SIGNATURES
        assert entry not in _kernels._SIGNATURES
        if name == "coeff_scatter_reference.cu":
            assert "PeerSum" in text and '"../scatter.cuh"' in text
    for mod in os.listdir(pkg):
        if mod.endswith(".py") and mod != "_kernels.py":
            with open(os.path.join(pkg, mod)) as fh:
                assert "load_check" not in fh.read(), mod
    texts = {}
    for name in ("packed_grad.cu", "row_gather.cu", "coeff_scatter.cu"):
        with open(os.path.join(pkg, "csrc", name)) as fh:
            texts[name] = fh.read()
    for name in ("packed_grad.cu", "row_gather.cu"):
        assert '"group.cuh"' in texts[name]
        assert '"scatter.cuh"' not in texts[name]
    assert "atomicAdd" not in texts["row_gather.cu"]
    assert '"scatter.cuh"' in texts["coeff_scatter.cu"]
    assert "PeerSum" not in texts["coeff_scatter.cu"]
    assert "term_indices" in texts["coeff_scatter.cu"]


def test_rows_read_is_locate():
    """chip_smoke.rows_read, which counts how an inverse chunk's points
    crowd into K7's rows, names the row the packed read locates: a grid row,
    or a node row after a descent."""
    cfg = T.Config(continuity=False, root_min=chip_smoke.SYNTH_ROOT[0],
                   root_max=chip_smoke.SYNTH_ROOT[1])
    tree = TT.pack(*chip_smoke.synthetic_tree(3, seed=4), cfg, device="cpu")
    pt = TA.pack_tree(tree, grid_depth=1)
    assert pt.extra_rounds == 1
    lo, hi = (np.asarray(a) for a in chip_smoke.SYNTH_ROOT)
    pts = torch.as_tensor(np.random.default_rng(5).uniform(
        lo - 0.1, hi + 0.1, (2000, 3)).astype(np.float32))
    key = chip_smoke.rows_read(pt, pts)
    unit = TA.to_unit(pt, pts).clamp(-0.5, 0.5)
    np.testing.assert_array_equal(
        torch.cat([pt.grid, pt.rows])[key].numpy(),
        TA.locate(pt, unit).numpy())
    assert (key >= pt.grid.shape[0]).any() and (key < pt.grid.shape[0]).any()


def test_packed_read_bytes_counts_the_walk():
    """chip_smoke.packed_read_bytes, the table bytes in K7's and K5's bounds:
    a 32-byte sector of each row the points' walks visit (their grid cells
    and the node rows they descend to), and for a read of whole rows the
    rows the points end on in full."""
    cfg = T.Config(continuity=False, root_min=chip_smoke.SYNTH_ROOT[0],
                   root_max=chip_smoke.SYNTH_ROOT[1])
    tree = TT.pack(*chip_smoke.synthetic_tree(3, seed=4), cfg, device="cpu")
    pt = TA.pack_tree(tree, grid_depth=1)
    lo, hi = (np.asarray(a) for a in chip_smoke.SYNTH_ROOT)
    pts = torch.as_tensor(np.random.default_rng(6).uniform(
        lo - 0.1, hi + 0.1, (500, 3)).astype(np.float32))
    unit = np.clip(TA.to_unit(pt, pts).numpy(), -0.5, 0.5)
    g = 1 << pt.grid_depth
    cell = np.clip(((unit + 0.5) * g).astype(np.int64), 0, g - 1)
    cells = set(((cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]).tolist())
    read = set(chip_smoke.rows_read(pt, pts).tolist())
    assert len(chip_smoke.row_walk(pt, pts)) == 1 + pt.extra_rounds == 2
    assert read - cells and cells - read
    assert chip_smoke.packed_read_bytes(pt, pts) == 32 * len(cells | read)
    assert chip_smoke.packed_read_bytes(pt, pts, True) == \
        32 * len(cells - read) + 4 * pt.width * len(read)


def test_form2_reference_is_checks_only():
    """K7's form 2 as it was before its redesign (each point's row located
    and its gradient evaluated again where it is placed) lives only under
    csrc/check/, with entry points bound only for the checks; the shipped
    form 2 groups by row (group.cuh) from K5's saved key and gradient (no
    packed_leaf_sums in packed_grad.cu)."""
    pkg = os.path.dirname(_kernels.__file__)
    with open(os.path.join(pkg, "csrc", "check",
                           "packed_grad_form2_reference.cu")) as fh:
        text = fh.read()
    entry = "hpsdf_packed_grad_form2_reference"
    assert f'extern "C" int {entry}(' in text
    assert entry in _kernels._CHECK_SIGNATURES
    assert entry not in _kernels._SIGNATURES
    with open(os.path.join(pkg, "csrc", "packed_grad.cu")) as fh:
        ship = fh.read()
    assert '"group.cuh"' in ship and "hpsdf::PeerSum" not in ship
    assert "packed_leaf_sums" in text and "packed_leaf_sums" not in ship
    assert "hpsdf_normals_grad" in _kernels._SIGNATURES
