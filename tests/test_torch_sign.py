"""Kernel K14's route on CPU tensors (``mesh.sdf._signed_from_best``: the
plain version, ``signed_from_best_plain``) against hpsdf_tpu's
``_signed_from_best`` on the same best indices, and ``mesh_sdf``'s three
paths through it against hpsdf_tpu's ``mesh_sdf``.

The mesh is icosphere(0.3, 2) from both packages' ``mesh.gen`` (the same
arrays), its BVH built by hpsdf_tpu and carried across. The points hit all
seven feature regions of Ericson's cascade (three vertices, three edges,
the face): uniform points, points outside vertices, edge midpoints and face
centroids, inside face centroids, points on the surface and 1e-4 off an
edge. Distances agree within 1e-6 and signs wherever |d| > 1e-6 (XLA
contracts the cascade's a*b + c into FMAs where torch does not, so a
surface point's sign may differ)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hpsdf_tpu import mesh as JM
from hpsdf_tpu.mesh import gen as JG
from hpsdf_tpu.mesh import sdf as JS
from hpsdf_tpu_torch import mesh as TM
from hpsdf_tpu_torch.mesh import bvh as TB
from hpsdf_tpu_torch.mesh import gen
from hpsdf_tpu_torch.mesh import sdf as TS
from hpsdf_tpu_torch.mesh import tri as TT

import chip_smoke
from .test_torch_query import few_torch_threads  # noqa: F401
from .util import uniform_pts

SIGNED_ATOL = 1e-6


@pytest.fixture(scope="module")
def ico():
    v, f = gen.icosphere(0.3, 2)                  # 320 triangles
    jv, jf = JG.icosphere(0.3, 2)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    jmesh = JM.build_mesh(v, f)
    jb = JM.build_bvh(jmesh)
    tb = TB.from_numpy(np.asarray(jb.node_rows), np.asarray(jb.tri_rows),
                       jb.n_tris, jb.depth, device="cpu")
    return v, f, jmesh, jb, TM.build_mesh(v, f), tb


def _feature_points(v, f, seed):
    """Points whose closest feature is each kind: outside vertices, edge
    midpoints and face centroids, inside centroids, centroids and random
    points on the faces, 1e-4 off edge midpoints, and uniform points."""
    rng = np.random.default_rng(seed)
    tri = v[f]                                             # (F, 3, 3)
    cen = tri.mean(axis=1)
    mids = np.concatenate([(tri[:, k] + tri[:, (k + 1) % 3]) / 2
                           for k in range(3)])
    bary = rng.dirichlet(np.ones(3), size=f.shape[0])
    on_face = np.einsum("fk,fkc->fc", bary, tri)

    def out(p, s):
        return p * (1.0 + s / np.linalg.norm(p, axis=-1, keepdims=True))

    pts = np.concatenate([
        out(v, 0.05), out(mids, 0.04), out(cen, 0.03), out(cen, -0.05),
        cen, on_face, out(mids, 1e-4), out(mids, -1e-4),
        uniform_pts(400, seed=seed)])
    return pts.astype(np.float32)


def _best(tb, pts):
    _, idx = TM.closest_tri_tiles(tb.tri_rows, torch.as_tensor(pts))
    return idx


def _check(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=SIGNED_ATOL)
    clear = np.abs(want) > SIGNED_ATOL
    np.testing.assert_array_equal(np.sign(got[clear]), np.sign(want[clear]))


@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_signed_from_best_matches_reference(ico, idx_dtype):
    v, f, _, jb, _, tb = ico
    pts = _feature_points(v, f, seed=1)
    idx = _best(tb, pts).to(idx_dtype)
    # every feature region of the cascade is taken
    rows = tb.tri_rows[idx.long()]
    _, feat = TT.closest_point_triangle(torch.as_tensor(pts),
                                        *TS._tri_parts(rows))
    assert sorted(set(feat.tolist())) == list(range(7))
    want = JS._signed_from_best(jnp.asarray(jb.tri_rows),
                                jnp.asarray(idx.numpy()), jnp.asarray(pts))
    TS.signed_from_best_kernel.launches = 0
    got = TS._signed_from_best(tb.tri_rows, idx, torch.as_tensor(pts))
    assert got.dtype == torch.float32 and got.shape == (pts.shape[0],)
    assert TS.signed_from_best_kernel.launches == 0
    _check(got, want)
    # the plain version is the oracle's own arithmetic on the gathered rows
    assert torch.equal(got, TS._signed(rows, torch.as_tensor(pts)))


def test_signed_from_best_gathers_zeros_out_of_range(ico):
    *_, tb = ico
    pts = torch.as_tensor(uniform_pts(8, seed=3).astype(np.float32))
    idx = torch.tensor([0, -1, tb.n_leaves, 5, 2 ** 31 - 1, 1, 0, -7])
    got = TS._signed_from_best(tb.tri_rows, idx, pts)
    zero = TS._signed(torch.zeros(8, tb.tri_rows.shape[1]), pts)
    out = (idx < 0) | (idx >= tb.n_leaves)
    assert torch.equal(got[out], zero[out])
    assert torch.equal(got[~out], TS._signed(tb.tri_rows[idx[~out]],
                                             pts[~out]))


def test_kernel_refuses_int64_indices(ico):
    *_, tb = ico
    with pytest.raises(ValueError, match="int32"):
        TS.signed_from_best_kernel(tb.tri_rows, torch.zeros(4, dtype=torch
                                                            .int64),
                                   torch.zeros(4, 3))


def test_kernel_refuses_cpu_tensors(ico):
    *_, tb = ico
    pts = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        TS.signed_from_best_kernel(tb.tri_rows, torch.zeros(4, dtype=torch
                                                            .int32), pts)


@pytest.mark.parametrize("method", ["tiles", "hybrid", "bvh"])
def test_mesh_sdf_paths_match_reference(ico, method, monkeypatch):
    v, f, jmesh, jb, tmesh, tb = ico
    pts = _feature_points(v, f, seed=2).astype(np.float64)
    calls = []
    plain = TS.signed_from_best_plain

    def counted(*args):
        calls.append(args[1].shape[0])
        return plain(*args)

    monkeypatch.setattr(TS, "signed_from_best_plain", counted)
    want = JM.mesh_sdf(jmesh, jb, 0, method)(jnp.asarray(pts))
    got = TM.mesh_sdf(tmesh, tb, 0, method)(torch.as_tensor(pts))
    assert got.dtype == torch.float64
    assert calls == [pts.shape[0]]            # one sign call, through K14's
    _check(got.numpy(), want)                 # route


def test_k14_sector_bytes_count_the_sectors_touched():
    """chip_smoke.sign_sector_bytes: 20 bytes a point and 32 a sector, the
    sectors those of distinct in-range rows: sectors 0 and 1 (vertex lanes
    0..11) and those of each (row, feature)'s pseudo-normal lanes, against
    a count by hand."""
    idx = torch.tensor([0, 0, 1, 2, -1, 12, 2], dtype=torch.int32)
    feat = torch.tensor([0, 6, 4, 5, 0, 1, 1], dtype=torch.int8)
    pts = torch.zeros(7, 3)
    # row 0: 0, 1 (codes 0, 6 inside them); row 1: 0, 1, 3 (bc at 24..26);
    # row 2: 0, 1, 3 (ca at 27..29), 1 and 2 (vertex b at 15..17)
    assert chip_smoke.sign_sector_bytes(idx, pts, feat, 10) \
        == 7 * 20 + 32 * 9


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_k14_sector_bytes_match_a_brute_force(seed):
    """chip_smoke.sign_sector_bytes against a set of (row, sector) pairs
    built point by point over seeded rows (some out of range) and codes."""
    rng = np.random.default_rng(seed)
    idx = torch.as_tensor(rng.integers(-2, 40, 500).astype(np.int32))
    feat = torch.as_tensor(rng.integers(0, 7, 500).astype(np.int8))
    seen = set()
    for r, c in zip(idx.tolist(), feat.tolist()):
        if 0 <= r < 37:
            seen |= {(r, 0), (r, 1)}
            lane = chip_smoke.K14_PN_LANES[c] if c < 6 else 9
            seen |= {(r, lane // 8), (r, (lane + 2) // 8)}
    pts = torch.zeros(500, 3)
    assert chip_smoke.sign_sector_bytes(idx, pts, feat, 37) \
        == 500 * 20 + 32 * len(seen)


def test_k14_check_fails_every_mutation(ico):
    """chip_smoke.k14_wrong counts the distances more than SIGNED_ATOL off
    and the signs flipped beyond it; each of k14_teeth's wrong results
    breaks that check, on the plain version's distances (a stand-in for
    the kernel's on the card)."""
    v, f, *_, tb = ico
    pts = torch.as_tensor(_feature_points(v, f, seed=4))
    idx = _best(tb, pts)
    want = TS._signed(tb.tri_rows[idx.long()], pts)
    assert chip_smoke.SIGNED_ATOL == SIGNED_ATOL
    assert chip_smoke.k14_wrong(want, want) == (0, 0)
    near = want + 0.5 * SIGNED_ATOL * torch.sign(want)
    assert chip_smoke.k14_wrong(near, want) == (0, 0)
    small = want.abs() <= 0.5 * SIGNED_ATOL
    flip = torch.where(small, -want, want)    # only where |d| <= atol / 2
    assert chip_smoke.k14_wrong(flip, want) == (0, 0)
    teeth = chip_smoke.k14_teeth(want, want)
    assert len(teeth) == 2 and all(teeth.values())
