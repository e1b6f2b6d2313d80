"""Point nearest-neighbour index (a copy of ``hpsdf_tpu/mesh/nn.py``).

Capability equivalent of Meshing::NNOctree (reference:
Include/Meshing/NNOctree.h, Source/Meshing/NNOctree.cpp): a dynamic
insert/remove point set with nearest-neighbour queries under a
``max_distance`` prune (NNOctree.cpp:120-182). In the reference it is a
host-side helper used only to accelerate BVH construction; here the BVH
builds from a median-split sort instead (bvh.py), so this index exists for API
parity and general use.

Design: a uniform-grid bucket index over the current point set, memoized
per (point set, cell size) on the immutable instance -- insert/remove
return NEW instances, so repeated ``nearest`` calls at the same
``max_distance`` reuse the built grid instead of re-sorting. Queries are
vectorized numpy over all 27 neighbouring cells at once; the grid cell size
matches ``max_distance`` so the 27-cell neighbourhood is exhaustive for any
hit within range.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PointIndex:
    points: np.ndarray          # (N, 3) f64, the live point set
    ids: np.ndarray             # (N,) i64 caller-supplied ids

    # -- construction -------------------------------------------------------

    @staticmethod
    def empty() -> "PointIndex":
        return PointIndex(points=np.zeros((0, 3), np.float64),
                          ids=np.zeros((0,), np.int64))

    def insert(self, pts: np.ndarray, ids=None) -> "PointIndex":
        pts = np.atleast_2d(np.asarray(pts, np.float64))
        if ids is None:
            base = int(self.ids.max(initial=-1)) + 1
            ids = np.arange(base, base + pts.shape[0], dtype=np.int64)
        else:
            ids = np.atleast_1d(np.asarray(ids, np.int64))
        return PointIndex(points=np.concatenate([self.points, pts]),
                          ids=np.concatenate([self.ids, ids]))

    def remove(self, ids) -> "PointIndex":
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        keep = ~np.isin(self.ids, ids)
        return PointIndex(points=self.points[keep], ids=self.ids[keep])

    @property
    def size(self) -> int:
        return self.points.shape[0]

    # -- queries -------------------------------------------------------------

    @staticmethod
    def _flat(k):
        # spatial hash that keeps distinct nearby cells distinct
        return (k[:, 0] * 73856093) ^ (k[:, 1] * 19349663) \
            ^ (k[:, 2] * 83492791)

    def _grid(self, cell: float):
        """(uniq sorted cell hashes, (n_cells, bmax) point-row buckets),
        memoized per cell size on this immutable instance."""
        cache = self.__dict__.get("_grid_cache")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_grid_cache", cache)
        hit = cache.get(cell)
        if hit is not None:
            return hit
        keys_p = np.floor(self.points / cell).astype(np.int64)
        kp = self._flat(keys_p)
        order = np.argsort(kp, kind="stable")
        kp_sorted = kp[order]
        uniq, start = np.unique(kp_sorted, return_index=True)
        counts = np.diff(np.append(start, kp_sorted.size))
        bmax = int(counts.max())
        buckets = np.full((uniq.size, bmax), -1, np.int64)
        grp = np.repeat(np.arange(uniq.size), counts)
        pos = np.arange(kp_sorted.size) - np.repeat(start, counts)
        buckets[grp, pos] = order
        cache[cell] = (uniq, buckets)
        return uniq, buckets

    def nearest(self, queries: np.ndarray, max_distance: float,
                chunk: int = 8192):
        """Nearest live point within ``max_distance`` of each query.

        Returns (ids (Q,) i64 with -1 for no hit, dists (Q,) f64 with inf
        for no hit). Exhaustive within range (cell size = max_distance =>
        the 27-neighbourhood covers the search ball), mirroring the
        reference's pruned best-first search semantics
        (NNOctree.cpp:120-182).
        """
        q = np.atleast_2d(np.asarray(queries, np.float64))
        out_id = np.full(q.shape[0], -1, np.int64)
        out_d = np.full(q.shape[0], np.inf, np.float64)
        if self.size == 0:
            return out_id, out_d

        cell = max(float(max_distance), 1e-12)
        uniq, buckets = self._grid(cell)

        offs = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                                    indexing="ij"), axis=-1).reshape(-1, 3)
        for s0 in range(0, q.shape[0], chunk):
            qc = q[s0:s0 + chunk]
            kq = np.floor(qc / cell).astype(np.int64)
            best_d2 = np.full(qc.shape[0], np.inf)
            best_i = np.full(qc.shape[0], -1, np.int64)
            for off in offs:
                kk = self._flat(kq + off)
                u = np.searchsorted(uniq, kk)
                u = np.clip(u, 0, uniq.size - 1)
                hit = uniq[u] == kk
                cand = np.where(hit[:, None], buckets[u], -1)   # (c, bmax)
                valid = cand >= 0
                ptc = self.points[np.maximum(cand, 0)]          # (c, bmax, 3)
                d2 = np.sum((ptc - qc[:, None, :]) ** 2, axis=-1)
                d2 = np.where(valid, d2, np.inf)
                j = np.argmin(d2, axis=1)
                d2j = d2[np.arange(d2.shape[0]), j]
                better = d2j < best_d2
                best_d2 = np.where(better, d2j, best_d2)
                best_i = np.where(better,
                                  cand[np.arange(cand.shape[0]), j], best_i)
            d = np.sqrt(best_d2)
            ok = (best_i >= 0) & (d <= max_distance)
            out_id[s0:s0 + chunk] = np.where(ok, self.ids[np.maximum(best_i, 0)],
                                             -1)
            out_d[s0:s0 + chunk] = np.where(ok, d, np.inf)
        return out_id, out_d
