"""Trees cross between hpsdf_tpu and hpsdf_tpu_torch: the npz schema both
ways, bit-exact, and the in-memory from_numpy / to_numpy carry."""

import dataclasses

import numpy as np
import pytest

import hpsdf_tpu as hp
import hpsdf_tpu_torch as T

from .util import sphere_sdf

_ARRAYS = ("child_idx", "centre", "depth", "degree", "coeffs")


def port_config(cfg):
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["nearness_weighting"] = T.NearnessWeighting(cfg.nearness_weighting.value)
    return T.Config(**kw)


@pytest.fixture(scope="module")
def jax_tree():
    cfg = hp.Config(target_error=1e-6, continuity=False, max_depth=5,
                    max_degree=4, root_min=(-0.5, -0.25, -0.5),
                    root_max=(0.75, 0.5, 0.5),
                    nearness_weighting=hp.NearnessWeighting.EXPONENTIAL,
                    nearness_strength=1.5)
    return hp.build_octree(cfg, sphere_sdf(centre=(0.1, 0.05, 0.0),
                                           radius=0.2))


def _assert_same(jtree, arrays, meta):
    for k in _ARRAYS:
        a = np.asarray(getattr(jtree, k))
        assert arrays[k].dtype == a.dtype
        np.testing.assert_array_equal(arrays[k], a)
    assert meta == (jtree.n_nodes, jtree.deg_used, jtree.depth_used)


def test_save_jax_load_torch(tmp_path, jax_tree):
    p = str(tmp_path / "jax.npz")
    hp.save(jax_tree, p)
    t = T.load(p, device="cpu")
    _assert_same(jax_tree, T.to_numpy(t), (t.n_nodes, t.deg_used,
                                            t.depth_used))
    assert t.config == port_config(jax_tree.config)


def test_save_torch_load_jax(tmp_path, jax_tree):
    arrays = {k: np.asarray(getattr(jax_tree, k)) for k in _ARRAYS}
    t = T.from_numpy(arrays, jax_tree.n_nodes, jax_tree.deg_used,
                     jax_tree.depth_used, port_config(jax_tree.config),
                     device="cpu")
    p_t, p_j = str(tmp_path / "torch.npz"), str(tmp_path / "jax.npz")
    T.save(t, p_t)
    hp.save(jax_tree, p_j)
    back = hp.load(p_t)
    _assert_same(jax_tree, {k: np.asarray(getattr(back, k))
                            for k in _ARRAYS},
                 (back.n_nodes, back.deg_used, back.depth_used))
    # the two files hold the same members, byte for byte
    with np.load(p_t) as zt, np.load(p_j) as zj:
        assert zt.files == zj.files
        for k in zt.files:
            assert zt[k].dtype == zj[k].dtype
            assert zt[k].tobytes() == zj[k].tobytes()


def test_from_numpy_to_numpy_roundtrip(jax_tree):
    arrays = {k: np.asarray(getattr(jax_tree, k)) for k in _ARRAYS}
    t = T.from_numpy(arrays, jax_tree.n_nodes, jax_tree.deg_used,
                     jax_tree.depth_used, port_config(jax_tree.config),
                     device="cpu")
    assert t.num_leaves() == jax_tree.num_leaves()
    assert t.total_coeffs() == jax_tree.total_coeffs()
    _assert_same(jax_tree, T.to_numpy(t), (t.n_nodes, t.deg_used,
                                            t.depth_used))


def test_pack_pad_to_by_position(jax_tree):
    """``pack(..., config, pad_to)`` with pad_to by position, as
    hpsdf_tpu.tree.pack takes it: the same packed tree in both packages."""
    from hpsdf_tpu import tree as JT
    from hpsdf_tpu_torch import tree as TT
    a = {k: np.asarray(getattr(jax_tree, k)) for k in _ARRAYS}
    n = jax_tree.n_nodes
    args = (a["child_idx"], a["centre"], a["depth"], a["degree"],
            a["coeffs"], n)
    for pad_to in (16, 24):
        jt = JT.pack(*args, jax_tree.config, pad_to)
        tt = TT.pack(*args, port_config(jax_tree.config), pad_to,
                     device="cpu")
        assert tt.child_idx.shape[0] == -(-n // pad_to) * pad_to
        _assert_same(jt, T.to_numpy(tt), (tt.n_nodes, tt.deg_used,
                                          tt.depth_used))
