"""The march's per-ray counts and the host-side logic around kernel K3.

``hpsdf_tpu_torch.render._march_block(with_stats=True)`` (the plain version
of K3, on CPU tensors) reports what each ray did: steps, relocations and
relocations that found the row already held, LOD phase and full phase
apart (``render.STATS``). K3 reports the same counts on the card, and
chip_smoke.py prices the kernel by them. Here the step counts are held
against ``hpsdf_tpu``'s ``_march_block(with_stats=True)`` on the same rays,
and the counts against what ``kk`` and ``TraceResult.steps`` imply; the
tile mapping, the SIMT-efficiency measure and the operation count of
chip_smoke.py, and the LOD tables kept with a PackedTree, are checked on
small inputs.

Both marches run in f32 and round in different places, so a grazing ray
may take one step more in one of them: step counts are held equal on
>= 99.5% of rays, the bound tests/test_torch_render.py holds hit masks to.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import render as JR
from hpsdf_tpu_torch import accel as TA
from hpsdf_tpu_torch import render as TR

import chip_smoke

from .test_torch_query import few_torch_threads  # noqa: F401
from .test_torch_render import _rays, trees  # noqa: F401

CASES = ["omega_default", "omega_1", "lod", "step_cap"]
STEPS_AGREE = 0.995
COL = {name: i for i, name in enumerate(TR.STATS)}


def _case(trees, case):
    """(jax packed, torch packed, jax lo, torch lo, kwargs) of a case."""
    _, _, jp, tp = trees["lod" if case == "lod" else "shallow"]
    kw = {"omega_1": dict(omega=1.0), "step_cap": dict(step_cap=0.02)}.get(
        case, {})
    lod = case == "lod"
    return (jp, tp, JR._lo_of(jp) if lod else None,
            tp.lo if lod else None, kw)


@pytest.fixture(scope="module")
def marched(trees):
    """Each case's plain march with its counts, once for the module."""
    o, d = _rays()
    out = {}
    for case in CASES:
        _, tp, _, t_lo, kw = _case(trees, case)
        out[case] = TR._march_block(tp, torch.as_tensor(o),
                                    torch.as_tensor(d), 5.0, 1e-4, 200,
                                    lo=t_lo, with_stats=True, **kw)
    return out


@pytest.mark.parametrize("case", CASES)
def test_step_counts_match_hpsdf_tpu(trees, marched, case):
    jp, _, j_lo, _, kw = _case(trees, case)
    o, d = _rays()
    *_, nj = JR._march_block(jp, jnp.asarray(o), jnp.asarray(d),
                             jnp.float32(5.0), 1e-4, 200, lo=j_lo,
                             with_stats=True, **kw)
    st = marched[case][3].numpy()
    steps = st[:, COL["steps_lo"]] + st[:, COL["steps_full"]]
    assert np.mean(steps == np.asarray(nj)) >= STEPS_AGREE
    assert abs(int(steps.sum()) - int(np.asarray(nj).sum())) \
        <= 0.005 * int(steps.sum())
    assert steps.max() > 20                      # grazing rays march long


@pytest.mark.parametrize("case", CASES)
def test_stats_change_no_result(trees, marched, case):
    _, tp, _, t_lo, kw = _case(trees, case)
    o, d = _rays()
    t, hit, kk = TR._march_block(tp, torch.as_tensor(o), torch.as_tensor(d),
                                 5.0, 1e-4, 200, lo=t_lo, **kw)
    ts, hs, ks, st = marched[case]
    assert torch.equal(t, ts) and torch.equal(hit, hs) and torch.equal(kk, ks)
    assert st.shape == (o.shape[0], len(TR.STATS)) and st.dtype == torch.int32


@pytest.mark.parametrize("case", CASES)
def test_counts_consistent(trees, marched, case):
    _, tp, _, t_lo, _ = _case(trees, case)
    _, _, kk, st = marched[case]
    st = st.numpy()
    c = {name: st[:, i] for name, i in COL.items()}
    # the lockstep block runs as many rounds as its longest ray relocates
    assert [c["relocations_lo"].max(), c["relocations_full"].max()] \
        == kk.tolist()
    assert (c["steps_lo"] + c["steps_full"]).max() <= 200
    assert (c["steps_lo"] <= TR.INNER_STEPS_LO * c["relocations_lo"]).all()
    assert (c["steps_full"]
            <= TR._inner_steps_for(tp) * c["relocations_full"]).all()
    # a ray's first relocation of a phase finds nothing held
    for ph in ("lo", "full"):
        assert (c[f"kept_{ph}"]
                <= np.maximum(c[f"relocations_{ph}"] - 1, 0)).all()
    assert (c["kept_lo"] + c["kept_full"]).sum() > 0
    if t_lo is None:
        assert not (c["steps_lo"].any() or c["relocations_lo"].any()
                    or c["kept_lo"].any())
    else:
        assert c["steps_lo"].sum() > 0 and c["steps_full"].sum() > 0


def test_trace_steps_are_the_round_counts(trees, marched):
    _, tt, _, tp = trees["shallow"]
    o, d = _rays()
    res = TR.trace(tt, o, d, t_max=5.0, packed=tp)
    _, _, kk, st = marched["omega_default"]
    assert res.steps == int(kk.sum()) \
        == int(st[:, COL["relocations_lo"]].max()
               + st[:, COL["relocations_full"]].max())


def _tile_ray(i, width):
    """csrc/march.cu tile_ray: thread index -> ray index, a warp on an 8x4
    pixel tile of an image `width` wide."""
    tile, within = i >> 5, i & 31
    tiles_x = width >> 3
    ty, tx = tile // tiles_x, tile % tiles_x
    return (ty * 4 + (within >> 3)) * width + tx * 8 + (within & 7)


@pytest.mark.parametrize("size", [(8, 4), (48, 48), (64, 20), (1024, 8)])
def test_tile_mapping_is_a_permutation(size):
    width, height = size
    n = width * height
    assert TR._tile_width(width, n) == width
    rays = _tile_ray(np.arange(n), width)
    assert np.array_equal(np.sort(rays), np.arange(n))
    # each warp's rays are one 8x4 block of pixels
    y, x = np.divmod(rays.reshape(-1, 32), width)
    assert (np.ptp(x, axis=1) == 7).all() and (np.ptp(y, axis=1) == 3).all()
    assert (x.min(axis=1) % 8 == 0).all() and (y.min(axis=1) % 4 == 0).all()
    # and they are the groups chip_smoke.simt_efficiency takes for (8, 4)
    idx = torch.arange(n).reshape(-1, 4, width // 8, 8).permute(0, 2, 1, 3)
    assert np.array_equal(idx.reshape(-1, 32).numpy(), rays.reshape(-1, 32))


@pytest.mark.parametrize("width,n_rays", [(0, 4096), (60, 3600), (64, 64 * 6),
                                          (-8, 64), (12, 48)])
def test_tile_width_falls_back_to_index_order(width, n_rays):
    assert TR._tile_width(width, n_rays) == 0


def test_simt_efficiency():
    w = torch.ones(64 * 8)
    assert chip_smoke.simt_efficiency(w, 64, (32, 1)) == 1.0
    assert chip_smoke.simt_efficiency(w, 64, (8, 4)) == 1.0
    # one long column of pixels: every strip holds one long ray, the tiles
    # gather four of them
    w = torch.ones(8, 64)
    w[:, 3] = 9.0
    strips = chip_smoke.simt_efficiency(w.reshape(-1), 64, (32, 1))
    tiles = chip_smoke.simt_efficiency(w.reshape(-1), 64, (8, 4))
    total = float(w.sum())
    assert strips == pytest.approx(total / (32 * (8 * 9 + 8 * 1)))
    assert tiles == pytest.approx(total / (32 * (2 * 9 + 14 * 1)))


@pytest.mark.parametrize("deg,ops", [(0, 46), (2, 90), (3, 136), (5, 279)])
def test_k3_ops(deg, ops):
    assert chip_smoke.k3_ops(deg) == ops
    assert chip_smoke.k3_ops(deg, lo=True) == chip_smoke.k3_ops(2) + 2


def test_k3_stats_summary(marched):
    st = marched["lod"][3]
    s = chip_smoke.k3_stats(st, 48, 6)
    n = st.numpy().astype(np.int64)
    assert s["steps"] == n[:, :2].sum() == s["steps_lo"] + s["steps_full"]
    assert s["relocations"] == n[:, 2:4].sum()
    assert s["kept_share"] == pytest.approx(n[:, 4:].sum() / n[:, 2:4].sum())
    assert s["steps_max"] == n[:, :2].sum(axis=1).max()
    assert sum(s["steps_hist"]) == n.shape[0]
    assert s["longest_rounds"] == n[:, 2:4].sum(axis=1).max() \
        == n[s["longest_ray"], 2:4].sum()
    assert s["ops"] == (s["steps_lo"] * chip_smoke.k3_ops(6, lo=True)
                        + s["steps_full"] * chip_smoke.k3_ops(6))
    for key in ("simt_strips_by_steps", "simt_tiles_by_steps"):
        assert 0.0 < s[key] <= 1.0


def test_lod_tables_stay_with_the_packed_tree(trees):
    _, _, _, shallow = trees["shallow"]
    _, _, _, lod = trees["lod"]
    assert shallow.lo is None
    lo = lod.lo
    assert lo is lod.lo                                 # made once
    for got, tab in zip(lo, (lod.grid, lod.rows)):
        assert torch.equal(got, TA.lo_pack(tab))
    # new tables start afresh
    again = dataclasses.replace(lod, rows=lod.rows.clone())
    assert again.lo is not lo and torch.equal(again.lo[1], lo[1])


def test_reference_kernel_is_on_no_path():
    """The kernels K3, K4, K7 (and its form 2), G's backward, K8, K8's
    node-range mode, K11, K6, K13's terms, K1v and K1h, K5h and the
    row-sharded CG's two K9u launches replaced are built into a library of
    their own, which no module of the package loads: only chip_smoke.py
    does, to hold the shipped kernels to them."""
    import glob
    import os

    from hpsdf_tpu_torch import _kernels

    main = {os.path.basename(p) for p in _kernels.sources()}
    check = {os.path.basename(p) for p in _kernels.sources("check")}
    assert "march.cu" in main and check == {
        "march_reference.cu", "packed_grad_reference.cu",
        "row_scatter_reference.cu", "coeff_scatter_reference.cu",
        "coeff_scatter_nodes_reference.cu", "cone_reference.cu",
        "bvh_walk_reference.cu", "fit_reference.cu",
        "inverse_terms_reference.cu", "query_vjp_reference.cu",
        "packed_grad_form2_reference.cu", "packed_hvp_reference.cu",
        "cg_rows_reference.cu"}
    assert not main & check
    assert _kernels.library_path("check") != _kernels.library_path()
    pkg = os.path.dirname(_kernels.__file__)
    users = [p for p in glob.glob(os.path.join(pkg, "**", "*.py"),
                                  recursive=True)
             if "load_check" in open(p).read()]
    assert users == [_kernels.__file__]
    with open(os.path.join(pkg, "csrc", "check", "march_reference.cu")) as fh:
        assert 'extern "C" int hpsdf_march_reference(' in fh.read()
    with open(os.path.join(pkg, "csrc", "check", "cone_reference.cu")) as fh:
        assert 'extern "C" int hpsdf_cone_reference(' in fh.read()
    with open(os.path.join(pkg, "csrc", "check",
                           "bvh_walk_reference.cu")) as fh:
        assert 'extern "C" int hpsdf_bvh_walk_reference(' in fh.read()
    with open(os.path.join(pkg, "csrc", "check",
                           "coeff_scatter_nodes_reference.cu")) as fh:
        assert ('extern "C" int hpsdf_coeff_scatter_nodes_reference('
                in fh.read())
    with open(os.path.join(pkg, "csrc", "check",
                           "packed_hvp_reference.cu")) as fh:
        assert 'extern "C" int hpsdf_packed_hvp_reference(' in fh.read()
    with open(os.path.join(pkg, "csrc", "check",
                           "cg_rows_reference.cu")) as fh:
        text = fh.read()
    assert 'extern "C" int hpsdf_cg_update_rows_reference(' in text
    assert 'extern "C" int hpsdf_cg_direction_reference(' in text
    with open(os.path.join(pkg, "csrc", "check", "fit_reference.cu")) as fh:
        text = fh.read()
    assert 'extern "C" int hpsdf_fit_points_reference(' in text
    assert 'extern "C" int hpsdf_fit_project_reference(' in text
