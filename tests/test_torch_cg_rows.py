"""The row-sharded continuity CG's two K9u launches, on the CPU.

``cg_update_rows_kernel`` and ``cg_direction_kernel`` (csrc/continuity.cu)
keep the iteration's state on the card in two small arrays, whose slots the
host names in ``continuity._SC`` and ``_ST``; the kernels as they were
before their redesign are kept in csrc/check/cg_rows_reference.cu for
chip_smoke.py to hold the shipped ones to. There is no card here, so these
tests read the sources, check chip_smoke.py's bounds for the two launches,
and hold the plain row-sharded CG (``continuity._cg_rows_plain``, which the
ranks run on CPU tensors) at one and two gloo ranks to
``hpsdf_tpu.continuity``'s sharded f64 CG on one and two devices: the same
iteration count, and coefficients within 1e-10 / 1e-12
(tests/test_parallel.py:117-130).
"""

import dataclasses
import glob
import os
import re
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
import hpsdf_tpu as hp
from hpsdf_tpu import continuity as JC
from hpsdf_tpu_torch import _kernels
from hpsdf_tpu_torch import continuity as TC

from .test_torch_query import _ARRAYS, few_torch_threads  # noqa: F401
from .util import sphere_sdf

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "_torch_cg_rows_worker.py")
_CSRC = os.path.join(_ROOT, "hpsdf_tpu_torch", "csrc")
# tests/test_parallel.py's tree, with continuity's strength set for the CG
CFG = dict(target_error=1e-6, continuity=False, continuity_strength=8.0,
           max_depth=4, max_degree=4)
CG_RTOL, CG_ATOL = 1e-10, 1e-12
RANK_S = 120                        # a rank's limit, start-up included


def _enums(path):
    """The two enums of a CUDA source, as lists of names: the f64 scalars'
    (from kRz) and the integers' (from kK)."""
    with open(path) as fh:
        text = fh.read()
    return [[name.strip().split("=")[0].strip()
             for name in re.search(r"enum \{ (" + first + r" = 0[^}]*)\}",
                                   text).group(1).split(",")]
            for first in ("kRz", "kK")]


def _same(enum, slots):
    """The enum's names (kRzPart) name the dict's slots (rz_part), in
    order."""
    return [e[1:].lower() for e in enum] == [
        k.replace("_", "") for k, _ in sorted(slots.items(),
                                              key=lambda kv: kv[1])]


def test_state_slots_match_the_source():
    """continuity._SC and _ST name, in order, the slots of
    csrc/continuity.cu's kRz ... and kK ... enums; the reference file's
    enums are their first slots, so the replaced kernels read and write the
    same state."""
    sc, st = _enums(os.path.join(_CSRC, "continuity.cu"))
    assert _same(sc, TC._SC) and _same(st, TC._ST), (sc, st)
    assert sorted(TC._SC.values()) == list(range(len(TC._SC)))
    assert sorted(TC._ST.values()) == list(range(len(TC._ST)))
    ref_sc, ref_st = _enums(os.path.join(_CSRC, "check",
                                         "cg_rows_reference.cu"))
    assert ref_sc == sc[:len(ref_sc)] and ref_st == st[:len(ref_st)]
    # the slots the redesign added, which the replaced kernels never touch
    assert sc[len(ref_sc):] == ["kRzOld"] and st[len(ref_st):] == ["kLive"]


def test_reference_entries_and_no_path_loads_them():
    """Every replaced entry point in _CHECK_SIGNATURES is defined in
    csrc/check/cg_rows_reference.cu with the shipped launch's signature,
    and no module of the package but _kernels loads the check library."""
    with open(os.path.join(_CSRC, "check", "cg_rows_reference.cu")) as fh:
        text = fh.read()
    for shipped in ("hpsdf_cg_update_rows", "hpsdf_cg_direction"):
        name = f"{shipped}_reference"
        assert _kernels._CHECK_SIGNATURES[name] == \
            _kernels._SIGNATURES[shipped]
        assert re.search(r'extern "C" int ' + name + r"\(", text), name
    for kernel in ("cg_update_rows_reference_kernel",
                   "cg_direction_reference_kernel"):
        assert kernel in text and kernel in chip_smoke.CHECK_PTXAS_KERNELS
    pkg = os.path.dirname(_kernels.__file__)
    users = [p for p in glob.glob(os.path.join(pkg, "**", "*.py"),
                                  recursive=True)
             if "load_check" in open(p).read()]
    assert users == [_kernels.__file__]


@pytest.mark.parametrize("n", [1, 2, 40960, 2606040])
def test_row_bounds_count_what_moves(n):
    """chip_smoke.py's bounds for K9u's two launches: 64 n bytes for the
    first (Ap, 1/diag, x, r, p read, x, r, z written), 24 n for the second
    (z, p read, p written), and for a dead launch its flag and the two
    scalars it reads with it (and the first's copy of the flag written);
    each operation bound under its byte bound (test_k9u_ops_bound's
    pattern)."""
    assert chip_smoke.rows_bytes("k9u", n) == 64 * n
    assert chip_smoke.rows_bytes("direction", n) == 24 * n
    assert chip_smoke.rows_bytes("k9u", n, live=False) == 4 + 16 + 4
    assert chip_smoke.rows_bytes("direction", n, live=False) == 4 + 16
    for kind, ops in (("k9u", 10 * n), ("direction", 2 * n)):
        bytes_ms, ops_ms = chip_smoke.rows_bound(kind, n)
        assert bytes_ms == pytest.approx(
            chip_smoke.rows_bytes(kind, n) / chip_smoke.HBM_RATE * 1e3,
            rel=1e-12)
        assert ops_ms == pytest.approx(ops / chip_smoke.F64_PEAK * 1e3,
                                       rel=1e-12)
        assert ops_ms < bytes_ms
        dead = chip_smoke.rows_bound(kind, n, live=False)
        assert dead[1] == 0 and dead[0] == pytest.approx(
            chip_smoke.rows_bytes(kind, n, live=False)
            / chip_smoke.HBM_RATE * 1e3, rel=1e-12)


@pytest.fixture(scope="module")
def small_tree():
    return hp.build_octree(hp.Config(**CFG), sphere_sdf(radius=0.3))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _port_ranks(jt, size, tmp):
    """The port's enforce_continuity(mesh=) on ``size`` gloo ranks: each
    rank's (coefficients, iterations, residual)."""
    np.savez(tmp / "tree.npz",
             **{k: np.asarray(getattr(jt, k)) for k in _ARRAYS},
             n_nodes=jt.n_nodes, deg_used=jt.deg_used,
             depth_used=jt.depth_used,
             **{f"cfg_{k}": v for k, v in CFG.items()})
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, _WORKER, str(r), str(size),
                               str(port), str(tmp)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(size)]
    try:
        outs = [p.communicate(timeout=RANK_S)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    got = [np.load(tmp / f"rank{r}.npz") for r in range(size)]
    return [(g["coeffs"], int(g["iterations"]), float(g["residual"]))
            for g in got]


@pytest.mark.parametrize("size", [1, 2])
def test_plain_rows_cg_matches_sharded_reference(small_tree, size,
                                                 tmp_path, capsys):
    """_cg_rows_plain at ``size`` gloo ranks against hpsdf_tpu's
    _cg_solve_sharded on ``size`` devices (conftest's virtual CPU devices):
    the same iteration count on every rank, the coefficients within
    CG_RTOL / CG_ATOL, every rank returning the same tree."""
    jt = dataclasses.replace(small_tree, config=dataclasses.replace(
        small_tree.config, enable_logging=True))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:size]), ("x",))
    want = np.asarray(JC.enforce_continuity(jt, mesh=mesh).coeffs)
    iters = [int(m) for m in re.findall(
        r"\[hpsdf continuity\].* iters=(\d+)", capsys.readouterr().out)]
    assert len(iters) == 1 and iters[0] > 0, iters
    got = _port_ranks(small_tree, size, tmp_path)
    for coeffs, k, resid in got:
        assert k == iters[0]
        assert np.isfinite(resid)
        np.testing.assert_array_equal(coeffs, got[0][0])
    np.testing.assert_allclose(got[0][0], want, rtol=CG_RTOL, atol=CG_ATOL)
    assert not np.array_equal(got[0][0], np.asarray(small_tree.coeffs))


def test_pair_checks_catch_planted_faults():
    """chip_smoke.py's comparison of the shipped launches with the replaced
    ones (``rows_differences``) passes two equal snapshots and dots within
    CONT_RTOL, and reports every fault ``rows_planted`` plants: an entry
    of each vector moved, and a scalar written to another's slot."""
    import torch

    rng = np.random.default_rng(3)
    snap = {k: torch.as_tensor(rng.normal(size=33))
            for k in ("x", "r", "z", "p")}
    snap["sc"] = torch.as_tensor(rng.normal(size=len(TC._SC)))
    snap["st"] = torch.tensor([4, 100, 1, 0, 1], dtype=torch.int32)
    want = {k: v.clone() for k, v in snap.items()}
    assert chip_smoke.rows_differences(snap, want) == []
    near = {**snap, "sc": snap["sc"].clone()}
    near["sc"][TC._SC["rz_part"]] *= 1 + chip_smoke.CONT_RTOL / 2
    assert chip_smoke.rows_differences(near, want) == []
    near["sc"][TC._SC["rz_part"]] = want["sc"][TC._SC["rz_part"]] * (
        1 + 4 * chip_smoke.CONT_RTOL)
    assert chip_smoke.rows_differences(near, want) == ["rz_part"]
    planted = chip_smoke.rows_planted(snap)
    assert sorted(name for name, _ in planted) == sorted(
        ["x", "r", "z", "p", "beta", "rz_part", "k"])
    for name, bad in planted:
        assert name in chip_smoke.rows_differences(bad, want), name
