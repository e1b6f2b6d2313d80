"""The port's sharding (hpsdf_tpu_torch.parallel and the ``mesh`` /
``fit_mesh`` arguments) on the CPU: ranks of a gloo group, spawned as
processes (tests/_torch_parallel_worker.py, which imports neither jax nor
hpsdf_tpu), at world sizes 2 and 3 (3 pads the 1,003 points and the rays,
as the reference's test_parallel.py does on 8 devices). Each rank writes
what the sharded entry points returned; this process, with conftest's 8
virtual JAX devices, holds it to the port's one-device results and to
hpsdf_tpu.parallel on the same inputs:

  * shard_query bit for bit against the port's query, 1e-12 against
    hpsdf_tpu's shard_query; shard_trace bit for bit against the port's
    trace, hits equal and t within 1e-5 against hpsdf_tpu's, also as an
    image through the cone prepass;
  * the sharded SGD step against hpsdf_tpu's train_step: loss rtol 1e-10,
    coefficients atol 1e-12, and the second loss lower;
  * build(fit_mesh=) bit for bit against the port's one-device build at
    the same chunk size, and against hpsdf_tpu's sharded build with
    tests/test_torch_build.py's tolerances (topology equal, 1e-10);
  * the row-sharded CG within rtol 1e-10, atol 1e-12 of the port's and
    hpsdf_tpu's solves (tests/test_parallel.py:117-130);
  * fit_to_depth(mesh=) at 64^2 rays, 2 steps: losses rtol 1e-4,
    coefficients rtol 1e-4, atol 1e-7 against the one-rank run;
  * the node axis, on make_mesh(node_parallel=size) (uneven row blocks at
    3): shard_query(shard_nodes=True) bit for bit against the port's query
    and 1e-12 against hpsdf_tpu's node-sharded shard_query
    (tests/test_parallel.py:37-43), at most ceil(N / size) rows a rank and
    depth_used + 1 collectives over the node axis, each of the batch
    share's size; the default (node-sharded) train step as the sharded SGD
    step above (tests/test_parallel.py:62-84), returning the rank's block.

A world of GRID_RANKS ranks on a (2, 2) mesh runs
__graft_entry__.dryrun_multichip's sequence at its sizes and tolerances:
the fit with fit_mesh bit for bit the one-device fit and spread over all
four ranks, as the row-sharded CG (within 1e-10 / 1e-12 of the port's and
hpsdf_tpu's solves) is; the node-sharded train step's loss within 1e-10 of
hpsdf_tpu's train_step; shard_query (replicated and node-sharded) and
shard_trace against the port's one-device calls; fit_to_depth over the
batch axis against the one-device run at another chunk size.

The plain versions of K9's partial mode and K9u's two launches, which the
CPU ranks run, are held to the one-device operator on row blocks here.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu import continuity as JC
from hpsdf_tpu import parallel as JP
from hpsdf_tpu.render import camera_rays
import hpsdf_tpu_torch as T
from hpsdf_tpu_torch import build as TB
from hpsdf_tpu_torch import continuity as TC

from .test_torch_accel import carry
from .test_torch_query import _ARRAYS, few_torch_threads  # noqa: F401
from .util import sphere_sdf, uniform_pts

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "_torch_parallel_worker.py")
SIZES = (2, 3)
GRID_RANKS = 4                      # a (2, 2) mesh
# __graft_entry__.dryrun_multichip's tree
DRY_CFG = dict(target_error=1e-3, continuity=False, max_depth=4,
               max_degree=3)
CFG = dict(target_error=1e-6, continuity=False, continuity_strength=8.0,
           max_depth=4, max_degree=4)
# off every mirror plane of the cell grid (tests/test_torch_build.py)
FIT_CENTRE = np.array([0.0131, -0.0217, 0.0093])
# the CG's tree: leaves at depths 4 and 5, so the operator has cross-depth
# entries (11,775 leaves, n 117,750)
CG_CFG = dict(target_error=3e-7, continuity=False, continuity_strength=8.0,
              max_depth=5, max_degree=3)
INV_SIDE, INV_CHUNK = 64, 1500      # 4,096 rays: 3 chunks, the last padded
CG_RTOL, CG_ATOL = 1e-10, 1e-12
INV_RTOL, INV_ATOL = 1e-4, 1e-7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rays(side, eye=(0.0, 0.0, -1.8), width=None):
    o, d = camera_rays(eye, (0.0, 0.0, 0.0), width=width or side,
                       height=side)
    return np.array(o, np.float32), np.array(d, np.float32)


@pytest.fixture(scope="module")
def small_tree():
    """tests/test_parallel.py's tree, built by hpsdf_tpu, with continuity's
    strength set for the CG."""
    cfg = hp.Config(**CFG)
    return hp.build_octree(cfg, sphere_sdf(radius=0.3)), cfg


@pytest.fixture(scope="module")
def inputs(small_tree, cg_tree, dry_tree, tmp_path_factory):
    jt, cfg = small_tree
    d = tmp_path_factory.mktemp("inputs")
    inp = {k: np.asarray(getattr(jt, k)) for k in _ARRAYS}
    inp.update(n_nodes=jt.n_nodes, deg_used=jt.deg_used,
               depth_used=jt.depth_used,
               **{f"cfg_{k}": v for k, v in CFG.items()})
    inp["pts"] = uniform_pts(1003, seed=3)
    n = 37
    rng = np.random.default_rng(5)
    tgt = rng.uniform(-0.1, 0.1, (n, 2))
    o = np.concatenate([np.zeros((n, 2)), np.full((n, 1), -2.0)], axis=1)
    dd = np.concatenate([tgt, np.full((n, 1), 2.0)], axis=1)
    inp["o"], inp["d"] = o, dd / np.linalg.norm(dd, axis=1, keepdims=True)
    # 24 x 16 rays: three rows of 8 x 8 tiles
    inp["img_o"], inp["img_d"] = _rays(24, (0.1, 0.0, -1.6), width=16)
    inp["img_tiles"] = np.array([24, 16, 8])
    inp["noisy"] = inp["coeffs"] + np.random.default_rng(7).normal(
        0, 1e-3, inp["coeffs"].shape)
    inp["train_pts"] = uniform_pts(4096, seed=6)
    inp["train_target"] = np.linalg.norm(inp["train_pts"], axis=-1) - 0.3
    inp["fit_centre"] = FIT_CENTRE
    inv_cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=4,
                        max_degree=3)
    for name, radius in (("inv_init", 0.30), ("inv_target", 0.33)):
        it = hp.build_octree(inv_cfg, sphere_sdf(radius=radius))
        for k in _ARRAYS:
            inp[f"{name}_{k}"] = np.asarray(getattr(it, k))
        inp[f"{name}_n_nodes"] = it.n_nodes
        inp[f"{name}_deg_used"] = it.deg_used
        inp[f"{name}_depth_used"] = it.depth_used
    inp["inv_o"], inp["inv_d"] = _rays(INV_SIDE)
    inp["inv_chunk"] = INV_CHUNK
    for pre, t in (("cg_", cg_tree[0]), ("dry_", dry_tree)):
        for k in _ARRAYS:
            inp[f"{pre}{k}"] = np.asarray(getattr(t, k))
        inp.update({f"{pre}n_nodes": t.n_nodes, f"{pre}deg_used": t.deg_used,
                    f"{pre}depth_used": t.depth_used})
    # __graft_entry__.py:70-85's points and rays
    inp["dry_pts"] = np.random.default_rng(1).uniform(-0.5, 0.5, (256, 3))
    inp["dry_o"] = np.tile(np.float32([[0.0, 0.0, -2.0]]), (16, 1))
    inp["dry_d"] = np.tile(np.float32([[0.0, 0.0, 1.0]]), (16, 1))
    np.savez(d / "inputs.npz", **inp)
    return d, inp


@pytest.fixture(scope="module")
def dry_tree():
    return hp.build_octree(hp.Config(**DRY_CFG), sphere_sdf(radius=0.3))


@pytest.fixture(scope="module")
def cg_tree():
    cfg = hp.Config(**CG_CFG)
    return hp.build_octree(cfg, sphere_sdf(FIT_CENTRE, 0.3)), cfg


def _spawn(size, inp_dir, out_dir):
    port = _free_port()
    os.symlink(inp_dir / "inputs.npz", out_dir / "inputs.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    return [subprocess.Popen(
        [sys.executable, _WORKER, str(r), str(size), str(port),
         str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=_ROOT) for r in range(size)]


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every world's ranks (SIZES, then GRID_RANKS), started together;
    {size: [rank 0's results, ...]}."""
    inp_dir, _ = inputs
    runs = {}
    for size in SIZES + (GRID_RANKS,):
        out_dir = tmp_path_factory.mktemp(f"world{size}")
        runs[size] = (out_dir, _spawn(size, inp_dir, out_dir))
    got = {}
    for size, (out_dir, procs) in runs.items():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=240)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0 and f"RANK-OK {r}" in out, (
                f"world {size} rank {r} rc={p.returncode}\n{out[-4000:]}")
        got[size] = [dict(np.load(out_dir / f"rank{r}.npz"))
                     for r in range(size)]
    return got


@pytest.fixture(scope="module")
def port_tree(small_tree):
    jt, cfg = small_tree
    return carry(jt, cfg)


@pytest.fixture(params=SIZES, ids=[f"world{s}" for s in SIZES])
def world(request, ranks):
    """One world size's results: rank 0's, after checking that every rank
    returned the same arrays."""
    got = ranks[request.param]
    for other in got[1:]:
        for k in ("query", "trace_t", "trace_hit", "cone_t", "train_losses",
                  "train_coeffs", "fit_coeffs", "cg_coeffs", "inv_losses",
                  "inv_coeffs", "node_query", "node_losses", "node_coeffs"):
            np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)
    return request.param, got[0]


def test_make_mesh(world):
    """make_mesh(node_parallel=npar) gives the (size / npar, npar) mesh
    where npar divides the ranks (tests/test_parallel.py:21-27) and raises
    ValueError where it does not."""
    size, got = world
    assert tuple(got["mesh_shape"]) == (size, 1)
    for npar in range(2, size + 2):
        if size % npar == 0:
            assert tuple(got[f"node_parallel_{npar}"]) == (size // npar,
                                                           npar), npar
        else:
            assert str(got[f"node_parallel_{npar}"]) == "ValueError", npar


def test_shard_query(world, small_tree, port_tree, inputs):
    _, got = world
    _, inp = inputs
    want = T.query(port_tree, torch.as_tensor(inp["pts"])).numpy()
    np.testing.assert_array_equal(got["query"], want)
    jax_sharded = np.asarray(JP.shard_query(small_tree[0], inp["pts"],
                                            JP.make_mesh()))
    np.testing.assert_allclose(got["query"], jax_sharded, rtol=0,
                               atol=1e-12)


def test_shard_query_node_sharded(world, ranks, small_tree, port_tree,
                                  inputs):
    """The node-sharded query on make_mesh(node_parallel=size): bit for bit
    the port's query, 1e-12 of hpsdf_tpu's on make_mesh(node_parallel=2);
    each rank holds its ceil(N / size) rows (fewer on the last) and their
    share of the bytes; the query made depth_used + 1 all-reduces over the
    node axis, each of the batch share's (here all the points') size, and
    one all-gather over the batch axis, and nothing else."""
    size, got = world
    _, inp = inputs
    want = T.query(port_tree, torch.as_tensor(inp["pts"])).numpy()
    np.testing.assert_array_equal(got["node_query"], want)
    jax_sharded = np.asarray(JP.shard_query(
        small_tree[0], inp["pts"], JP.make_mesh(node_parallel=2),
        shard_nodes=True))
    np.testing.assert_allclose(got["node_query"], jax_sharded, rtol=0,
                               atol=1e-12)
    rows = port_tree.child_idx.shape[0]
    per = -(-rows // size)
    whole = sum(getattr(port_tree, k).nbytes for k in _ARRAYS)
    blocks = [r["node_block"] for r in ranks[size]]
    assert [tuple(b[:3]) for b in blocks] == [
        (k * per, min((k + 1) * per, rows), rows) for k in range(size)]
    assert sum(int(b[3]) for b in blocks) == whole
    assert max(int(b[3]) for b in blocks) <= whole * per / rows
    n = inp["pts"].shape[0]
    want_calls = [["node", str(n)]] * (port_tree.depth_used + 1) \
        + [["batch", str(n)]]
    for r in ranks[size]:
        assert r["node_collectives"].tolist() == want_calls


def test_node_sharded_train_step(world, small_tree, inputs):
    """make_sharded_train_step's default on make_mesh(node_parallel=size):
    the loss within 1e-10 of hpsdf_tpu's train_step and falling over two
    steps, the gathered coefficients within 1e-12, the rank's block
    returned (tests/test_parallel.py:62-84)."""
    _, got = world
    _, inp = inputs
    jt = dataclasses.replace(small_tree[0], coeffs=jnp.asarray(inp["noisy"]))
    t1, l1 = JP.train_step(jt, jnp.asarray(inp["train_pts"]),
                           jnp.asarray(inp["train_target"]), 1e-4)
    l1g, l2g = got["node_losses"]
    np.testing.assert_allclose(l1g, float(l1), rtol=1e-10)
    np.testing.assert_allclose(got["node_coeffs"], np.asarray(t1.coeffs),
                               rtol=0, atol=1e-12)
    assert l2g < l1g
    assert str(got["node_step_type"]) == "ShardedTree"


def test_shard_trace(world, small_tree, port_tree, inputs):
    _, got = world
    _, inp = inputs
    one = T.trace(port_tree, inp["o"], inp["d"], t_max=5.0)
    np.testing.assert_array_equal(got["trace_t"], one.t.numpy())
    np.testing.assert_array_equal(got["trace_hit"], one.hit.numpy())
    js = JP.shard_trace(small_tree[0], inp["o"], inp["d"], JP.make_mesh(),
                        t_max=5.0)
    hit = np.asarray(js.hit)
    np.testing.assert_array_equal(got["trace_hit"], hit)
    assert hit.sum() > 10
    np.testing.assert_allclose(got["trace_t"][hit], np.asarray(js.t)[hit],
                               atol=1e-5)
    img = T.trace(port_tree, inp["img_o"], inp["img_d"], t_max=5.0,
                  cone_tiles=tuple(inp["img_tiles"]))
    np.testing.assert_array_equal(got["cone_t"], img.t.numpy())
    np.testing.assert_array_equal(got["cone_hit"], img.hit.numpy())
    assert img.hit.any() and not img.hit.all()


def test_sharded_train_step(world, small_tree, inputs):
    _, got = world
    _, inp = inputs
    jt = dataclasses.replace(small_tree[0], coeffs=jnp.asarray(inp["noisy"]))
    t1, l1 = JP.train_step(jt, jnp.asarray(inp["train_pts"]),
                           jnp.asarray(inp["train_target"]), 1e-4)
    l1g, l2g = got["train_losses"]
    np.testing.assert_allclose(l1g, float(l1), rtol=1e-10)
    np.testing.assert_allclose(got["train_coeffs"], np.asarray(t1.coeffs),
                               rtol=0, atol=1e-12)
    assert l2g < l1g


def test_sharded_fit(world, ranks):
    size, got = world
    # the one-device build at the same chunk size (rank 0 of world 2)
    one = ranks[SIZES[0]][0]
    np.testing.assert_array_equal(got["fit_child_idx"],
                                  one["fit_one_child_idx"])
    np.testing.assert_array_equal(got["fit_coeffs"], one["fit_one_coeffs"])
    cj = jnp.asarray(FIT_CENTRE)
    js = hp.build_octree(hp.Config(target_error=1e-6, continuity=False,
                                   max_depth=4, max_degree=4),
                         lambda p: jnp.linalg.norm(p - cj, axis=-1) - 0.3,
                         fit_mesh=JP.make_mesh())
    np.testing.assert_array_equal(got["fit_child_idx"],
                                  np.asarray(js.child_idx))
    np.testing.assert_allclose(got["fit_coeffs"], np.asarray(js.coeffs),
                               rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def cg_one(cg_tree):
    """The one-device solves of the CG's tree: the port's and hpsdf_tpu's
    f64 CG."""
    jt, cfg = cg_tree
    tt = carry(jt, cfg)
    return (tt.coeffs.numpy(), TC.enforce_continuity(tt).coeffs.numpy(),
            np.asarray(JC.enforce_continuity(jt, cg="f64").coeffs))


def test_sharded_cg(world, cg_one):
    _, got = world
    before, port, jax_one = cg_one
    np.testing.assert_allclose(got["cg_coeffs"], port, rtol=CG_RTOL,
                               atol=CG_ATOL)
    np.testing.assert_allclose(got["cg_coeffs"], jax_one, rtol=CG_RTOL,
                               atol=CG_ATOL)
    assert not np.array_equal(got["cg_coeffs"], before)


@pytest.fixture(scope="module")
def inverse_one(inputs):
    """fit_to_depth without a mesh on the ranks' inputs."""
    _, inp = inputs
    cfg = T.Config(target_error=1e-6, continuity=False, max_depth=4,
                   max_degree=3)
    ti, to = (T.from_numpy({k: inp[f"{name}_{k}"] for k in (
        "child_idx", "centre", "depth", "degree", "coeffs")},
        int(inp[f"{name}_n_nodes"]), int(inp[f"{name}_deg_used"]),
        int(inp[f"{name}_depth_used"]), cfg, device="cpu")
        for name in ("inv_init", "inv_target"))
    tt, th = T.inverse.render_targets(to, inp["inv_o"], inp["inv_d"],
                                      t_max=5.0)
    return T.inverse.fit_to_depth(ti, inp["inv_o"], inp["inv_d"], tt, th,
                                  n_steps=2, lr=1e-3, t_max=5.0,
                                  ray_chunk=INV_CHUNK)


def test_sharded_fit_to_depth(world, inverse_one):
    _, got = world
    np.testing.assert_allclose(got["inv_losses"],
                               inverse_one.losses.numpy(), rtol=INV_RTOL)
    np.testing.assert_allclose(got["inv_coeffs"],
                               inverse_one.tree.coeffs.numpy(),
                               rtol=INV_RTOL, atol=INV_ATOL)


# --------------------------------------------------------------------------
# A (2, 2) mesh: __graft_entry__.dryrun_multichip's sequence
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid(ranks):
    """The GRID_RANKS ranks' results, after checking that every rank
    returned the same arrays."""
    got = ranks[GRID_RANKS]
    for other in got[1:]:
        for k in ("grid_fit_equal", "grid_loss", "grid_step_coeffs",
                  "grid_query_0", "grid_query_1", "grid_trace_t",
                  "grid_trace_hit", "grid_cg_coeffs", "grid_inv_losses"):
            np.testing.assert_array_equal(other[k], got[0][k], err_msg=k)
    return got


@pytest.fixture(scope="module")
def dry_port(dry_tree):
    return carry(dry_tree, hp.Config(**DRY_CFG))


def test_grid_mesh(grid):
    """make_mesh(node_parallel=2) on 4 ranks: a (2, 2) mesh whose batch and
    node axes have two ranks each, and whose ranks together (mesh_shard,
    the fit's and the CG's) are four."""
    for r in grid:
        assert tuple(r["grid_shape"]) == (2, 2)
        assert tuple(r["grid_sizes"]) == (2, 2, 4)


def test_grid_fit(grid):
    """build(fit_mesh=) on the (2, 2) mesh: bit for bit the one-device
    build, the cells the one device fits shared out over the four ranks,
    each fitting some."""
    cells = [int(r["grid_fit_cells"]) for r in grid]
    assert all(bool(r["grid_fit_equal"]) for r in grid)
    assert min(cells) > 0
    assert sum(cells) == int(grid[0]["grid_fit_one_cells"])


def test_grid_train_step(grid, dry_tree, dry_port, inputs):
    """The default train step on the (2, 2) mesh (__graft_entry__.py:
    72-79): the loss within 1e-10 of hpsdf_tpu's train_step, the
    coefficients within 1e-12, each rank holding half the rows."""
    _, inp = inputs
    pts = inp["dry_pts"]
    target = np.linalg.norm(pts, axis=-1) - 0.3
    t1, loss = JP.train_step(dry_tree, jnp.asarray(pts),
                             jnp.asarray(target), 1e-4)
    rows = dry_port.child_idx.shape[0]
    for r in grid:
        assert str(r["grid_step_type"]) == "ShardedTree"
        assert int(r["grid_step_rows"]) <= -(-rows // 2)
    assert abs(float(grid[0]["grid_loss"]) - float(loss)) < 1e-10
    np.testing.assert_allclose(grid[0]["grid_step_coeffs"],
                               np.asarray(t1.coeffs), rtol=0, atol=1e-12)


def test_grid_query_and_trace(grid, dry_tree, dry_port, inputs):
    """shard_query (replicated and node-sharded) and shard_trace on the
    (2, 2) mesh against the port's one-device calls, bit for bit, and
    hpsdf_tpu's (1e-12; hits equal and t within 1e-5,
    __graft_entry__.py:82-92)."""
    _, inp = inputs
    pts = inp["dry_pts"][:64]
    want = T.query(dry_port, torch.as_tensor(pts)).numpy()
    jq = np.asarray(hp.query(dry_tree, jnp.asarray(pts)))
    for nodes in (0, 1):
        np.testing.assert_array_equal(grid[0][f"grid_query_{nodes}"], want)
        np.testing.assert_allclose(grid[0][f"grid_query_{nodes}"], jq,
                                   rtol=0, atol=1e-12)
    one = T.trace(dry_port, inp["dry_o"], inp["dry_d"], t_max=5.0)
    np.testing.assert_array_equal(grid[0]["grid_trace_t"], one.t.numpy())
    np.testing.assert_array_equal(grid[0]["grid_trace_hit"],
                                  one.hit.numpy())
    js = hp.trace(dry_tree, inp["dry_o"], inp["dry_d"], t_max=5.0)
    np.testing.assert_array_equal(grid[0]["grid_trace_hit"],
                                  np.asarray(js.hit))
    np.testing.assert_allclose(grid[0]["grid_trace_t"], np.asarray(js.t),
                               atol=1e-5)
    assert bool(grid[0]["grid_trace_hit"][0])


def test_grid_cg(grid, dry_tree, dry_port):
    """enforce_continuity(mesh=) on the (2, 2) mesh: row blocks over all
    four ranks, within 1e-10 / 1e-12 of the port's one-device solve and
    hpsdf_tpu's (__graft_entry__.py:94-101)."""
    ccfg = dict(DRY_CFG, continuity=True, continuity_strength=8.0)
    port = TC.enforce_continuity(dataclasses.replace(
        dry_port, config=T.Config(**ccfg))).coeffs.numpy()
    jax_one = np.asarray(JC.enforce_continuity(dataclasses.replace(
        dry_tree, config=hp.Config(**ccfg)), cg="f64").coeffs)
    assert sorted(tuple(r["grid_cg_block"]) for r in grid) == [
        (GRID_RANKS, k) for k in range(GRID_RANKS)]
    for want in (port, jax_one):
        np.testing.assert_allclose(grid[0]["grid_cg_coeffs"], want,
                                   rtol=CG_RTOL, atol=CG_ATOL)
    assert not np.array_equal(grid[0]["grid_cg_coeffs"],
                              dry_port.coeffs.numpy())


def test_grid_fit_to_depth(grid):
    """fit_to_depth(mesh=) on the (2, 2) mesh, rays over the batch axis in
    chunks of 64, against the one-device run in chunks of 256: losses
    within 1e-4 (__graft_entry__.py:103-113)."""
    losses = grid[0]["grid_inv_losses"]
    assert np.isfinite(losses).all() and losses.shape == (2,)
    np.testing.assert_allclose(losses, grid[0]["grid_inv_one"], rtol=1e-4)


# --------------------------------------------------------------------------
# The plain versions of the row-sharded modes, in this process
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def operator(cg_tree):
    """The host face operator of the CG's tree."""
    st = TC._LeafView(carry(*cg_tree))
    return TC.face_operator(st, *TC.leaf_face_pairs(st.child_idx, st.n),
                            8.0)


@pytest.mark.parametrize("size", [1, 2, 3, 5])
def test_row_blocks_cover_the_operator(operator, size):
    """The ranks' blocks tile the leaves and rows in order, none empty,
    and K9's partial mode on each block, fed the gathered vector, gives
    the one-device matvec's rows and their share of p.y."""
    op, _ = operator
    n = op.n
    assert op.xvals.size > 0
    p = torch.as_tensor(np.random.default_rng(size).normal(size=n))
    y, pap = TC.face_matvec_plain(op.to("cpu"), 8.0, p)
    blocks = [TC.row_block(op, size, k).to("cpu") for k in range(size)]
    assert [b.lo for b in blocks] == sorted(b.lo for b in blocks)
    assert sum(b.rows for b in blocks) == n and min(b.rows
                                                     for b in blocks) > 0
    assert all(b.width == max(c.rows for c in blocks) for b in blocks)
    np.testing.assert_array_equal(np.sort(blocks[0].order),
                                  blocks[0].order)
    gathered = torch.zeros(size * blocks[0].width, dtype=torch.float64)
    gathered[torch.as_tensor(blocks[0].order)] = p
    total = 0.0
    for b in blocks:
        yb, papb = TC.cg_matvec_rows(b, 8.0, gathered)
        np.testing.assert_allclose(yb.numpy(),
                                   y[b.lo: b.lo + b.rows].numpy(),
                                   rtol=1e-13, atol=1e-13 * float(
                                       y.abs().max()))
        total += float(papb)
    np.testing.assert_allclose(total, float(pap), rtol=1e-12)


def test_update_rows_and_direction_plain():
    """K9u's two launches together give one iteration of K9u's update
    (``cg_update_plain``): the same x, r, r.z, r.r and new direction."""
    rng = np.random.default_rng(11)
    p, Ap, x, r = (torch.as_tensor(rng.normal(size=50)) for _ in range(4))
    minv = torch.as_tensor(rng.uniform(0.5, 2.0, 50))
    rz, pap = torch.tensor(2.0), torch.tensor(7.0)
    want = TC.cg_update_plain(rz / pap, rz, p, Ap, minv, x, r)
    xs, rs, z, rz_new, rr = TC.cg_update_rows(False, rz, pap, p, Ap, minv,
                                              x, r)
    ps = TC.cg_direction(False, rz, rz_new, z, p)
    for a, b in zip((xs, rs, ps, rz_new, rr), want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-15)
    _, _, z0, rz0, rr0 = TC.cg_update_rows(True, None, None, None, None,
                                           minv, x, r)
    np.testing.assert_array_equal(
        TC.cg_direction(True, rz0, rz0, z0, p).numpy(), (minv * r).numpy())
    np.testing.assert_allclose(float(rz0), float(torch.dot(r, minv * r)))


def test_refuses_what_is_not_a_mesh(port_tree):
    """Every sharded entry point raises TypeError for an object that is not
    a DeviceMesh, before any collective."""
    from hpsdf_tpu_torch import parallel

    pts = torch.zeros(4, 3, dtype=torch.float64)
    for call in (lambda: parallel.shard_query(port_tree, pts, object()),
                 lambda: parallel.shard_trace(port_tree, pts, pts, object()),
                 lambda: parallel.make_sharded_train_step(object(),
                                                          port_tree)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
    assert TB.BLOCK_PTS == 1 << 20
