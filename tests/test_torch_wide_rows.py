"""The port's reads at basis degrees 0 to 12 (rows of 16 to 464 lanes),
against hpsdf_tpu on the same synthetic trees: a depth-2 octree
(``chip_smoke.synthetic_tree``, which chip_smoke.py also holds the CUDA
kernels to) packed by ``hpsdf_tpu.tree.pack`` and carried across with
``from_numpy``, read through a depth-1 grid and one descent. On CPU
tensors the port runs the plain versions of K2/K5 and K1.

Tolerances as in tests/test_torch_accel.py (f32 packed reads, 1e-6 on
v / max(1, |v|), the outside sentinel at the same positions),
tests/test_torch_render.py (normals) and tests/test_torch_query.py (f64
queries, 1e-12).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import accel as JA
from hpsdf_tpu import render as JR
from hpsdf_tpu import tree as JT
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import accel as TA

import chip_smoke

from .test_torch_query import few_torch_threads, port_config  # noqa: F401

DEGREES = (0, 1, 5, 8, 12)
K2_ATOL = 1e-6
K1_ATOL = 1e-12
N_PTS = 1000
_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


@pytest.fixture(scope="module", params=DEGREES, ids=lambda d: f"deg{d}")
def trees(request):
    deg = request.param
    cfg = hp.Config(continuity=False, root_min=chip_smoke.SYNTH_ROOT[0],
                    root_max=chip_smoke.SYNTH_ROOT[1])
    jt = JT.pack(*chip_smoke.synthetic_tree(deg, seed=deg), cfg)
    tt = T.from_numpy({k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
                      jt.n_nodes, jt.deg_used, jt.depth_used,
                      port_config(cfg), device="cpu")
    jp, tp = JA.pack_tree(jt, grid_depth=1), TA.pack_tree(tt, grid_depth=1)
    assert (jt.deg_used, tp.extra_rounds) == (deg, 1)
    lo, hi = jt.root_aabb
    pad = 0.1 * (hi - lo)
    pts = np.random.default_rng(100 + deg).uniform(lo - pad, hi + pad,
                                                   (N_PTS, 3))
    return deg, jt, tt, jp, tp, pts


def _scaled_close(got, want):
    scale = np.maximum(1.0, np.abs(want))
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=K2_ATOL)


def _outside_equal(got, want, sentinel):
    outside = want == sentinel
    assert outside.any() and not outside.all()
    np.testing.assert_array_equal(got == sentinel, outside)
    return outside


@pytest.mark.parametrize("read", ["values_at", "query_packed", "normals",
                                  "query", "query_with_gradient"])
def test_wide_rows(trees, read):
    deg, jt, tt, jp, tp, pts = trees
    p32 = pts.astype(np.float32)
    if read == "values_at":
        _scaled_close(TA.values_at(tp, torch.as_tensor(p32)).numpy(),
                      np.asarray(JA.values_at(jp, jnp.asarray(p32))))
    elif read == "query_packed":
        want = np.asarray(JA.query_packed(jp, jnp.asarray(p32)))
        got = TA.query_packed(tp, torch.as_tensor(p32)).numpy()
        inside = ~_outside_equal(got, want, np.finfo(np.float32).max)
        _scaled_close(got[inside], want[inside])
    elif read == "normals":
        want = np.asarray(JR._normals_at(jp, jnp.asarray(p32)))
        got = TA.normals(tp, torch.as_tensor(p32)).numpy()
        if deg == 0:        # a constant field: zero normals in both
            assert not got.any() and not want.any()
            return
        dots = np.sum(got * want, axis=-1)
        assert dots.mean() >= 0.9999 and dots.min() >= 0.999
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                                   atol=1e-6)
    elif read == "query":
        want = np.asarray(hp.query(jt, jnp.asarray(pts)))
        got = T.query(tt, torch.as_tensor(pts)).numpy()
        _outside_equal(got, want, np.finfo(np.float64).max)
        np.testing.assert_allclose(got, want, rtol=0, atol=K1_ATOL)
    else:
        v_j, g_j = hp.query_with_gradient(jt, jnp.asarray(pts))
        v_t, g_t = T.query_with_gradient(tt, torch.as_tensor(pts))
        _outside_equal(v_t.numpy(), np.asarray(v_j),
                       np.finfo(np.float64).max)
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0,
                                   atol=K1_ATOL)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=0,
                                   atol=K1_ATOL)


def _ptxas_entry(kernel, deg, grad, stack=0, regs=56, args=None,
                 spills=None):
    """ptxas's lines for one instantiation; ``grad`` None: a kernel whose
    only template argument is the degree (K3). ``args``: the mangled
    template arguments, in place of the degree and ``grad``; "" for a
    kernel that is no template. ``spills``: the spill stores and loads,
    ``stack`` when not given."""
    spills = stack if spills is None else spills
    flag = "" if grad is None else f"Lb{int(grad)}E"
    args = f"Li{deg}E{flag}" if args is None else args
    name = (f"_ZN40_GLOBAL__N__1f67f1e9_8_query_cu_1d77935312{kernel}"
            f"{f'I{args}E' if args else ''}EvPKiPKdS2_S4_iS4_lddddddiPdS5_")
    return (f"ptxas info    : Compiling entry function '{name}' for "
            f"'sm_90a'\nptxas info    : Function properties for {name}\n"
            f"    {stack} bytes stack frame, {spills} bytes spill stores, "
            f"{spills} bytes spill loads\nptxas info    : Used {regs} "
            f"registers, used 0 barriers, 22528 bytes smem\n")


@pytest.mark.parametrize("spill", [None, "K1", "K3", "K7", "G CSR", "K5F",
                                   "K9u", "chunk", "rows", "K10", "K11",
                                   "round", "leaf", "K8 nodes"],
                         ids=["clean", "spills", "march_spills",
                              "backward_spills", "csr_spills",
                              "fused_spills", "cg_spills", "chunk_spills",
                              "rows_spills", "hybrid_spills", "walk_spills",
                              "node_round_spills", "node_leaf_spills",
                              "node_scatter_spills"])
def test_ptxas_check(monkeypatch, spill):
    """chip_smoke.ptxas_check reads the kernels' instantiations from
    ptxas's report (the lines -Xptxas -v prints) and fails when K1, K3, K4,
    K5's raw gradient (alone or fused with K2), K7 or K8 at degree 3 or 5,
    either form of G's backward, or the continuity kernels (K9 on the face
    operator and in PR 10's CSR form, K9u's two forms, both forms of the
    persistent launch, both forms of each of the row-sharded CG's two K9u
    launches), K10 (either level count), K11, or K1's node-range descent
    round, its leaf evaluation or K8's node-range mode (at degree 3 or 5)
    has a stack frame or spills."""
    from hpsdf_tpu_torch import _kernels

    report = "".join(
        _ptxas_entry("query_kernel", d, g,
                     stack=8 if spill == "K1" and d == 5 else 0)
        for d in (3, 5, 12) for g in (False, True))
    report += _ptxas_entry("packed_eval_kernel", 3, False, regs=32)
    report += "".join(
        _ptxas_entry("march_kernel", d, None, regs=80,
                     stack=16 if spill == "K3" and d == 5 else 0)
        for d in (3, 5, 12))
    report += _ptxas_entry("cone_kernel", 2, None, regs=40, args="Li2ELb1E")
    for d in (3, 5):
        report += _ptxas_entry("cone_kernel", d, None, regs=40,
                               args=f"Li{d}ELb0E")
        report += _ptxas_entry("packed_eval_kernel", d, None,
                               args=f"Li{d}ELi2E")
        report += _ptxas_entry("packed_eval_kernel", d, None,
                               args=f"Li{d}ELi3E",
                               stack=16 if spill == "K5F" and d == 3 else 0)
        report += "".join(
            _ptxas_entry("packed_grad_kernel", d, None,
                         stack=24 if spill == "K7" and f else 0,
                         args=f"Li{d}ELi{f}E") for f in (0, 1))
        report += _ptxas_entry("coeff_scatter_kernel", d, None,
                               args=f"dLi{d}ELb0E")
        report += _ptxas_entry("coeff_scatter_kernel", d, None,
                               args=f"fLi{d}ELb1E")
    report += _ptxas_entry("row_scatter_kernel", 0, None, args="")
    report += _ptxas_entry("row_scatter_csr_kernel", 0, None, args="",
                           stack=8 if spill == "G CSR" else 0)
    report += _ptxas_entry("cg_matvec_kernel", 0, None, args="", regs=32)
    for init in (0, 1):
        report += _ptxas_entry("cg_update_kernel", 0, None, regs=32,
                               args=f"Lb{init}E",
                               stack=8 if spill == "K9u" and init else 0)
    report += _ptxas_entry("face_matvec_kernel", 0, None, args="", regs=98)
    for kernel in ("cg_update_rows_kernel", "cg_direction_kernel"):
        for init in (0, 1):
            report += _ptxas_entry(
                kernel, 0, None, regs=32, args=f"Lb{init}E",
                stack=8 if spill == "rows" and init
                and kernel == "cg_update_rows_kernel" else 0)
    for smem in (0, 1):
        report += _ptxas_entry("cg_chunk_kernel", 0, None, regs=128,
                               args=f"Lb{smem}E",
                               stack=16 if spill == "chunk" and smem else 0)
    for two in (0, 1):
        report += _ptxas_entry("hybrid_kernel", 0, None, regs=40,
                               args=f"Lb{two}E",
                               stack=8 if spill == "K10" and two else 0)
    report += _ptxas_entry("bvh_walk_kernel", 0, None, args="", regs=64,
                           stack=8 if spill == "K11" else 0)
    report += _ptxas_entry("descend_nodes_kernel", 0, None, args="",
                           regs=24, stack=8 if spill == "round" else 0)
    for d in (3, 5):
        report += _ptxas_entry("leaf_nodes_kernel", d, None, regs=48,
                               stack=8 if spill == "leaf" and d == 5 else 0)
        report += _ptxas_entry("coeff_scatter_nodes_kernel", d, None,
                               regs=40, stack=16 if spill == "K8 nodes"
                               and d == 3 else 0)
    monkeypatch.setattr(_kernels, "ptxas_report", lambda: report)
    if spill:
        with pytest.raises(RuntimeError, match={
                "K1": "K1 5/values", "K3": "K3 5: stack 16",
                "K7": "K7 3/form1: stack 24",
                "G CSR": "G backward CSR -: stack 8",
                "K5F": "K5 raw 3/fused: stack 16",
                "K9u": "K9u init: stack 8",
                "chunk": "K9 \\+ K9u persistent shared: stack 16",
                "rows": "K9u rows init: stack 8",
                "K10": "K10 two levels: stack 8",
                "K11": "K11 -: stack 8",
                "round": "K1 node round -: stack 8",
                "leaf": "K1 node leaf 5: stack 8",
                "K8 nodes": "K8 nodes 3: stack 16"}[spill]):
            chip_smoke.ptxas_check()
        return
    found = chip_smoke.ptxas_check()
    assert found["query_kernel"]["3/grad"] == [56, 0, 0, 0]
    assert set(found["query_kernel"]) == {f"{d}/{k}" for d in (3, 5, 12)
                                          for k in ("values", "grad")}
    assert found["packed_eval_kernel"]["3/values"] == [32, 0, 0, 0]
    assert set(found["packed_eval_kernel"]) == {
        "3/values", "3/raw", "5/raw", "3/fused", "5/fused"}
    assert set(found["coeff_scatter_kernel"]) == {
        f"{d}/{k}" for d in (3, 5) for k in ("f64 query", "f32 trace")}
    assert set(found["row_scatter_kernel"]) == {"-"}
    assert set(found["row_scatter_csr_kernel"]) == {"-"}
    assert found["march_kernel"] == {str(d): [80, 0, 0, 0]
                                     for d in (3, 5, 12)}
    assert found["cone_kernel"] == {k: [40, 0, 0, 0]
                                    for k in ("3/full", "5/full", "2/lo")}
    assert found["cg_matvec_kernel"] == {"-": [32, 0, 0, 0]}
    for kernel in ("cg_update_rows_kernel", "cg_direction_kernel"):
        assert found[kernel] == {k: [32, 0, 0, 0]
                                 for k in ("init", "iteration")}
    assert found["cg_update_kernel"] == {k: [32, 0, 0, 0]
                                         for k in ("init", "iteration")}
    assert found["face_matvec_kernel"] == {"-": [98, 0, 0, 0]}
    assert found["cg_chunk_kernel"] == {k: [128, 0, 0, 0]
                                        for k in ("shared", "buffer")}
    assert found["hybrid_kernel"] == {k: [40, 0, 0, 0]
                                      for k in ("one level", "two levels")}
    assert found["bvh_walk_kernel"] == {"-": [64, 0, 0, 0]}
    assert found["descend_nodes_kernel"] == {"-": [24, 0, 0, 0]}
    assert found["leaf_nodes_kernel"] == {k: [48, 0, 0, 0] for k in "35"}
    assert found["coeff_scatter_nodes_kernel"] == {k: [40, 0, 0, 0]
                                                   for k in "35"}
