"""The port's packed read layout (hpsdf_tpu_torch.accel, CPU tensors: the
plain versions of kernels G and K2) against hpsdf_tpu.accel, on the two
trees of tests/test_accel.py, each also with a forced grid_depth=2 (extra
descent rounds).

The packed tables are bit-equal. The one exception is lo_pack's error-bound
lane, an f32 sum of |c| over the truncated lanes whose order XLA picks:
it is held to the bound of any summation order, K * eps_f32 relative for K
non-negative terms. Reads are f32 in both packages and agree to 1e-6 on
v / max(1, |v|), with the outside sentinel at the same positions.
"""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA

from .test_torch_query import few_torch_threads, port_config  # noqa: F401
from .util import box_sdf, sphere_sdf

ATOL = 1e-6
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")

_TREES = {
    "sphere": (hp.Config(target_error=1e-7, continuity=False, max_depth=5,
                         max_degree=6), sphere_sdf(radius=0.3)),
    "box_offcentre": (hp.Config(target_error=1e-6, continuity=False,
                                max_depth=5, max_degree=4,
                                root_min=(-0.25, -0.25, -0.25),
                                root_max=(1.75, 1.75, 1.75)),
                      box_sdf(centre=(0.75, 0.75, 0.75),
                              half=(0.4, 0.3, 0.5))),
}


def carry(jt, cfg):
    """The port's copy of an hpsdf_tpu tree."""
    return T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                        jt.n_nodes, jt.deg_used, jt.depth_used,
                        port_config(cfg), device="cpu")


@pytest.fixture(scope="module", params=sorted(_TREES))
def trees(request):
    cfg, F = _TREES[request.param]
    jt = hp.build_octree(cfg, F)
    return jt, carry(jt, cfg)


@pytest.fixture(params=[None, 2], ids=["default_grid", "grid_depth_2"])
def packed(request, trees):
    jt, tt = trees
    return (JA.pack_tree(jt, grid_depth=request.param),
            TA.pack_tree(tt, grid_depth=request.param))


def _points(tree, n, seed):
    """Uniform over the root AABB grown by 10% per side."""
    lo, hi = tree.root_aabb
    pad = 0.1 * (hi - lo)
    return np.random.default_rng(seed).uniform(
        lo - pad, hi + pad, (n, 3)).astype(np.float32)


def test_pack_tree_bit_equal(packed):
    jp, tp = packed
    np.testing.assert_array_equal(tp.rows.numpy(), np.asarray(jp.rows))
    np.testing.assert_array_equal(tp.grid.numpy(), np.asarray(jp.grid))
    assert (tp.deg_used, tp.grid_depth, tp.extra_rounds, tp.root_centre,
            tp.root_sizes) == (jp.deg_used, jp.grid_depth, jp.extra_rounds,
                               jp.root_centre, jp.root_sizes)


def test_row_child_lane(trees):
    jt, tt = trees
    tp = TA.pack_tree(tt)
    np.testing.assert_array_equal(TA._row_child(tp.rows).numpy(),
                                  np.asarray(jt.child_idx))


def test_pack_support_and_repack_bit_equal(trees):
    jt, tt = trees
    for gd in (None, 2):
        js, ts = JA.pack_support(jt, gd), TA.pack_support(tt, gd)
        for name in ("meta_rows", "fold", "grid_src"):
            np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                          np.asarray(getattr(js, name)),
                                          err_msg=name)
        jp, tp = JA.pack_tree(jt, gd), TA.pack_tree(tt, gd)
        rng = np.random.default_rng(3)
        coeffs = np.asarray(jt.coeffs) * rng.uniform(
            0.5, 1.5, np.asarray(jt.coeffs).shape)
        jr = JA.repack(jp, js, jnp.asarray(coeffs))
        tr = TA.repack(tp, ts, torch.as_tensor(coeffs))
        np.testing.assert_array_equal(tr.rows.numpy(), np.asarray(jr.rows))
        np.testing.assert_array_equal(tr.grid.numpy(), np.asarray(jr.grid))
        folded = rng.standard_normal(
            (jp.rows.shape[0], np.asarray(jt.coeffs).shape[1])
        ).astype(np.float32)
        jf = JA.repack_folded(jp, js, jnp.asarray(folded))
        tf = TA.repack_folded(tp, ts, torch.as_tensor(folded))
        np.testing.assert_array_equal(tf.rows.numpy(), np.asarray(jf.rows))
        np.testing.assert_array_equal(tf.grid.numpy(), np.asarray(jf.grid))


def test_lo_pack(packed):
    jp, tp = packed
    for j_tab, t_tab in ((jp.rows, tp.rows), (jp.grid, tp.grid)):
        want = np.asarray(JA.lo_pack(j_tab))
        got = TA.lo_pack(t_tab).numpy()
        assert got.shape == want.shape == (t_tab.shape[0], TA.LO_W)
        err = TA.LO_ERR_LANE
        keep = np.r_[0:err, err + 1:TA.LO_W]
        np.testing.assert_array_equal(got[:, keep], want[:, keep])
        k = max(1, t_tab.shape[1] - err)
        np.testing.assert_allclose(got[:, err], want[:, err], atol=0,
                                   rtol=k * np.finfo(np.float32).eps)


def test_query_packed(trees, packed):
    jt, _ = trees
    jp, tp = packed
    pts = _points(jt, 20000, seed=11)
    want = np.asarray(JA.query_packed(jp, jnp.asarray(pts)))
    got = TA.query_packed(tp, torch.as_tensor(pts)).numpy()
    outside = want == np.finfo(np.float32).max
    assert outside.any() and not outside.all()
    np.testing.assert_array_equal(got == np.finfo(np.float32).max, outside)
    w, g = want[~outside], got[~outside]
    scale = np.maximum(1.0, np.abs(w))
    np.testing.assert_allclose(g / scale, w / scale, rtol=0, atol=ATOL)


def test_values_at(trees, packed):
    jt, _ = trees
    jp, tp = packed
    pts = _points(jt, 20000, seed=12)
    want = np.asarray(JA.values_at(jp, jnp.asarray(pts)))
    got = TA.values_at(tp, torch.as_tensor(pts)).numpy()
    scale = np.maximum(1.0, np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", [(4681, 32), (300, 46), (1, 8)])
def test_row_gather_plain(shape):
    rng = np.random.default_rng(7)
    table = rng.standard_normal(shape).astype(np.float32)
    n = table.shape[0]
    idx = rng.integers(-3, n + 3, 5000)
    # the wrapper takes widths G can move in 16-byte quarters; the plain
    # version any width
    gathers = [TA.row_gather_plain]
    if shape[1] % 4 == 0:
        gathers.append(TA.row_gather)
    else:
        with pytest.raises(ValueError, match="multiple of 4"):
            TA.row_gather(torch.as_tensor(table), torch.as_tensor(idx))
    for gather in gathers:
        for dt in (torch.int32, torch.int64):
            got = gather(torch.as_tensor(table),
                         torch.as_tensor(idx).to(dt)).numpy()
            ok = (idx >= 0) & (idx < n)
            np.testing.assert_array_equal(got[ok], table[idx[ok]])
            assert not got[~ok].any()
            assert got.shape == (idx.size, table.shape[1])


def test_kernel_sources_and_build_key(tmp_path, monkeypatch):
    """The nvcc build takes every kernel source and keys the library by the
    sources and the headers they share."""
    from hpsdf_tpu_torch import _kernels

    names = {os.path.basename(p) for p in _kernels.sources()}
    assert {"closest_tri.cu", "query.cu", "row_gather.cu", "packed_eval.cu",
            "march.cu"} <= names
    assert "packed_rows.cuh" in {os.path.basename(p)
                                 for p in _kernels.headers()}
    key = _kernels.library_path()
    hdr = tmp_path / "packed_rows.cuh"
    hdr.write_text("// changed\n")
    monkeypatch.setattr(_kernels, "headers", lambda: [str(hdr)])
    assert _kernels.library_path() != key


def test_packed_eval_refuses_unaligned_rows():
    """K2 reads rows in 16-byte loads: the wrapper refuses tables whose rows
    are not 16-byte aligned before it looks at the device."""
    tree = T.build_octree(T.Config(target_error=1e-3, continuity=False,
                                   max_depth=4, max_degree=2),
                          lambda p: torch.linalg.norm(p, dim=-1) - 0.3,
                          device="cpu")
    pt = TA.pack_tree(tree)
    shifted = torch.zeros(pt.rows.numel() + 1)[1:].view(pt.rows.shape)
    pts = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TA.packed_eval_kernel(dataclasses.replace(pt, rows=shifted), pts,
                              mode=TA.VALUES)


@pytest.mark.parametrize("wrapper", ["packed_eval", "march", "row_gather"])
def test_kernel_wrappers_refuse_cpu(wrapper):
    """Kernel wrappers launch on CUDA tensors or raise: the launching
    wrappers never fall through to the plain version."""
    from hpsdf_tpu_torch import render as TR

    tree = T.build_octree(T.Config(target_error=1e-3, continuity=False,
                                   max_depth=4, max_degree=2),
                          lambda p: torch.linalg.norm(p, dim=-1) - 0.3,
                          device="cpu")
    pt = TA.pack_tree(tree)
    pts = torch.zeros((4, 3), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA|unsupported device"):
        if wrapper == "packed_eval":
            TA.packed_eval_kernel(pt, pts, mode=TA.VALUES)
        elif wrapper == "march":
            TR.march_kernel(pt, pts, pts, 5.0)
        else:       # dispatches CPU to the plain version, nothing else
            TA.row_gather(pt.rows.to("meta"),
                          torch.zeros(4, dtype=torch.int32, device="meta"))
