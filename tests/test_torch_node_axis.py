"""The node-range modes of K1 and K8 (hpsdf_tpu_torch.query), in one
process and with no ranks: a tree split into blocks of node rows
(``parallel.node_block``), each block answering the points whose node it
holds and 0 for the others, as the ranks of the node axis do between their
all-reduces (``parallel._query_nodes``). On the CPU the plain versions run,
which are what the kernels are held to on the card.

  * the blocks' descent rounds, summed, give ``query.descend``'s leaves and
    hpsdf_tpu's exactly; their leaf evaluations, summed, give
    ``query_plain`` exactly and hpsdf_tpu's query within 1e-12;
  * K8's mode on each block, concatenated, gives ``query_vjp_plain`` and
    the VJP of hpsdf_tpu's query within 1e-12;
  * a block that no point reaches and a block with no rows answer zeros;
  * by arithmetic on the node-sharded record, the reference's capacity
    test (tests/test_parallel.py:133-182) at depth 6: 8 blocks of at most
    ceil(N / 8) rows, each about an eighth of the bytes;
  * the kernel wrappers refuse CPU tensors: they launch or raise.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hpsdf_tpu as hp
from hpsdf_tpu.query import _to_unit as j_to_unit, descend as j_descend
from hpsdf_tpu_torch import parallel as P
from hpsdf_tpu_torch.query import (OUTSIDE_VALUE, _to_unit,
                                   coeff_scatter_nodes_kernel,
                                   coeff_scatter_nodes_plain, descend,
                                   descend_round_plain, leaf_eval_plain,
                                   node_buckets_kernel,
                                   query_nodes_kernel, query_plain,
                                   query_vjp_plain)

import chip_smoke
from .test_torch_accel import carry
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import sphere_sdf

SPLITS = (1, 2, 3, 5)
CFG = dict(target_error=1e-6, continuity=False, max_depth=4, max_degree=4)
VAL_ATOL = GRAD_ATOL = 1e-12


@pytest.fixture(scope="module")
def trees():
    cfg = hp.Config(**CFG)
    jt = hp.build_octree(cfg, sphere_sdf(radius=0.3))
    return jt, carry(jt, cfg)


@pytest.fixture(scope="module")
def points():
    """Points straddling the root, and cotangents."""
    rng = np.random.default_rng(3)
    return rng.uniform(-0.6, 0.6, (2003, 3)), rng.normal(size=2003)


def node_query(blocks, tree, pts):
    """The node-sharded query of ``pts`` over ``blocks`` summed in this
    process: (values with the sentinel, leaves)."""
    unit = _to_unit(tree, pts)
    clamped = unit.clamp(-0.5, 0.5)
    cur = torch.zeros(pts.shape[0], dtype=torch.int32)
    for _ in range(tree.depth_used):
        cur = sum(descend_round_plain(b, clamped, cur)
                  for b in blocks).int()
    val = sum(leaf_eval_plain(b, clamped, cur) for b in blocks)
    return (torch.where(torch.all(unit.abs() <= 0.5, dim=-1), val,
                        OUTSIDE_VALUE), cur)


@pytest.mark.parametrize("size", SPLITS)
def test_descent_rounds_sum_to_the_leaves(trees, points, size):
    jt, tt = trees
    pts = torch.as_tensor(points[0])
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    _, leaves = node_query(blocks, tt, pts)
    clamped = _to_unit(tt, pts).clamp(-0.5, 0.5)
    np.testing.assert_array_equal(leaves.numpy(),
                                  descend(tt, clamped).numpy())
    junit = jnp.clip(j_to_unit(jt, jnp.asarray(points[0])), -0.5, 0.5)
    np.testing.assert_array_equal(leaves.numpy(),
                                  np.asarray(j_descend(jt, junit)))


@pytest.mark.parametrize("size", SPLITS)
def test_leaf_evaluations_sum_to_the_query(trees, points, size):
    jt, tt = trees
    pts = torch.as_tensor(points[0])
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    val, _ = node_query(blocks, tt, pts)
    np.testing.assert_array_equal(val.numpy(), query_plain(tt, pts).numpy())
    want = np.asarray(hp.query(jt, jnp.asarray(points[0])))
    np.testing.assert_array_equal(val.numpy() == OUTSIDE_VALUE,
                                  want == OUTSIDE_VALUE)
    np.testing.assert_allclose(val.numpy(), want, rtol=0, atol=VAL_ATOL)


@pytest.mark.parametrize("size", SPLITS)
@pytest.mark.parametrize("outside_value_max", [False, True])
def test_k8_blocks_concatenate_to_the_vjp(trees, points, size,
                                          outside_value_max):
    jt, tt = trees
    pts, w = (torch.as_tensor(x) for x in points)
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    _, leaves = node_query(blocks, tt, pts)
    got = torch.cat([coeff_scatter_nodes_plain(b, pts, leaves, w,
                                               outside_value_max)
                     for b in blocks])
    assert max(b.hi - b.lo for b in blocks) == -(-got.shape[0] // size)
    want = query_vjp_plain(tt, pts, w, outside_value_max)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=GRAD_ATOL)

    def f(c):
        return jnp.sum(jnp.asarray(points[1]) * hp.query(
            dataclasses.replace(jt, coeffs=c), jnp.asarray(points[0]),
            outside_value_max=outside_value_max))

    jg = np.asarray(jax.grad(f)(jt.coeffs))
    np.testing.assert_allclose(got.numpy(), jg, rtol=0, atol=GRAD_ATOL)


def test_blocks_without_points_or_rows(trees):
    """Points in one corner of the root leave blocks that no point reaches:
    they answer zeros in every round, the leaf and K8, and the sum is still
    the query. A block of no rows (a node axis longer than the tree's rows
    allow) answers zeros too."""
    _, tt = trees
    pts = torch.as_tensor(np.random.default_rng(9).uniform(
        0.3, 0.45, (257, 3)))
    size = 5
    blocks = [P.node_block(tt, size, k) for k in range(size)]
    val, leaves = node_query(blocks, tt, pts)
    np.testing.assert_array_equal(val.numpy(), query_plain(tt, pts).numpy())
    clamped = _to_unit(tt, pts).clamp(-0.5, 0.5)
    idle = [b for b in blocks
            if not bool(((leaves >= b.lo) & (leaves < b.hi)).any())]
    assert idle
    w = torch.ones(pts.shape[0], dtype=torch.float64)
    for b in idle:
        assert not leaf_eval_plain(b, clamped, leaves).any()
        assert not coeff_scatter_nodes_plain(b, pts, leaves, w).any()
    rows = tt.child_idx.shape[0]
    assert P.node_range(rows, rows + 3, rows + 2) == (rows, rows)
    empty = dataclasses.replace(
        P.node_block(tt, 1, 0), lo=rows, hi=rows,
        **{k: getattr(tt, k)[rows:] for k in P._ARRAYS})
    assert not descend_round_plain(empty, clamped, leaves).any()
    assert not leaf_eval_plain(empty, clamped, leaves).any()
    assert coeff_scatter_nodes_plain(empty, pts, leaves, w).shape == (
        0, tt.coeffs.shape[1])


def test_node_sharded_capacity():
    """The reference's capacity test by arithmetic on the node-sharded
    record: on bench.py's complete octree of depth 6 (299,593 nodes, 299,600
    rows) split over 8 ranks, each block holds at most ceil(N / 8) rows and
    at most an eighth of the bytes (rounded up to a row), the blocks cover
    the tree in order, and the node-sharded query of 4,096 points is the
    query's: block 0 (levels 0-5) answers every descent round, the others
    the leaves."""
    tree = chip_smoke.complete_tree(6, 0, "cpu")
    rows = tree.child_idx.shape[0]
    assert (tree.n_nodes, rows) == (299_600, 299_600)
    whole = sum(getattr(tree, k).nbytes for k in P._ARRAYS)
    blocks = [P.node_block(tree, 8, k) for k in range(8)]
    per = -(-rows // 8)
    assert [(b.lo, b.hi) for b in blocks] == [
        (k * per, min((k + 1) * per, rows)) for k in range(8)]
    row_bytes = whole // rows
    assert all(b.nbytes <= whole / 8 + row_bytes for b in blocks)
    assert sum(b.nbytes for b in blocks) == whole
    pts = chip_smoke.node_points(4096, 0, "cpu")
    val, leaves = node_query(blocks, tree, pts)
    np.testing.assert_array_equal(val.numpy(),
                                  query_plain(tree, pts).numpy())
    assert all(bool(((leaves >= b.lo) & (leaves < b.hi)).any())
               for b in blocks[1:])


def test_kernel_wrappers_refuse_cpu_tensors(trees):
    """CPU tensors never reach the kernels' plain versions through the
    wrappers: query_nodes_kernel, coeff_scatter_nodes_kernel and its
    sort, node_buckets_kernel, launch on CUDA tensors or raise."""
    _, tt = trees
    blk = P.node_block(tt, 2, 1)
    unit = torch.zeros(4, 3, dtype=torch.float64)
    idx = torch.zeros(4, dtype=torch.int32)
    for leaf in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            query_nodes_kernel(blk, unit, idx, leaf=leaf)
    for wrapper in (coeff_scatter_nodes_kernel, node_buckets_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(blk, unit, idx, torch.ones(4, dtype=torch.float64))
