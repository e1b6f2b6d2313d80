"""Half-edge topology + Baerentzen-Aanaes pseudo-normals (host precompute),
as ``hpsdf_tpu/mesh/core.py`` computes them (Meshing::Mesh, reference
Source/Meshing/Mesh.cpp):

  * half-edge pairing via an edge map; FAILS on non-watertight meshes, as
    the reference does (any unpaired half-edge => error, Mesh.cpp:122-128).
  * angle-weighted vertex pseudo-normals (one-ring walk, Mesh.cpp:216-242)
    -- a vectorized scatter-add of angle * face_normal.
  * edge pseudo-normals = pi-weighted two-face average (Mesh.cpp:200-213).

The pairing and the geometry pass run in the native host library
(``hpsdf_tpu_torch.native``) when it is available; the numpy code below is
the fallback and the oracle the tests hold the native paths to.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import native as _native


class NotWatertightError(ValueError):
    """Raised when half-edge pairing finds boundary or non-manifold edges
    (the reference returns false from Mesh::CreateFromObj, Mesh.cpp:122-128)."""


@dataclasses.dataclass(frozen=True)
class TriMesh:
    vertices: np.ndarray        # (V, 3) f64
    faces: np.ndarray           # (F, 3) i32
    face_normals: np.ndarray    # (F, 3) f64, unit
    vertex_pn: np.ndarray       # (V, 3) f64, unit angle-weighted pseudo-normals
    edge_pn: np.ndarray         # (F, 3, 3) f64 pseudo-normal of edge e of face f
                                # (edge e runs faces[f,e] -> faces[f,(e+1)%3])
    twin: np.ndarray            # (F, 3) i32 half-edge twin as flat index 3*f+e

    @property
    def n_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0]


def build_mesh(vertices: np.ndarray, faces: np.ndarray) -> TriMesh:
    """Build topology + pseudo-normals; raises NotWatertightError when the
    mesh has boundary or non-manifold edges."""
    v = np.asarray(vertices, np.float64)
    fc = np.asarray(faces, np.int32)
    F = fc.shape[0]

    # --- half-edge pairing (reference: Mesh.cpp:87-131) --------------------
    # native C++ pairing when built (same contract); the numpy sort-based
    # pairing below is the fallback and oracle
    twin = _native.half_edge_twins(fc, v.shape[0])
    if twin is None:
        he_from = fc.ravel()                              # (3F,)
        he_to = fc[:, [1, 2, 0]].ravel()
        key = (np.minimum(he_from, he_to).astype(np.int64) * v.shape[0]
               + np.maximum(he_from, he_to))
        order = np.argsort(key, kind="stable")
        ks = key[order]
        # each undirected edge must appear exactly twice, opposite direction
        if ks.size % 2 or not np.all(ks[0::2] == ks[1::2]):
            raise NotWatertightError(
                "unpaired edge (boundary or non-manifold)")
        a, b = order[0::2], order[1::2]
        if not np.all(he_from[a] == he_to[b]):
            raise NotWatertightError("inconsistently oriented edge pair")
        twin = np.empty(3 * F, np.int32)
        twin[a] = b
        twin[b] = a

    # --- geometry: the native single pass when available, else numpy ------
    geom = _native.mesh_geom(v, fc, twin)
    if geom is not None:
        fn, vpn, epn = geom
        return TriMesh(vertices=v, faces=fc, face_normals=fn, vertex_pn=vpn,
                       edge_pn=epn, twin=twin.reshape(F, 3))

    # --- face normals -------------------------------------------------------
    e1 = v[fc[:, 1]] - v[fc[:, 0]]
    e2 = v[fc[:, 2]] - v[fc[:, 0]]
    fn = np.cross(e1, e2)
    lens = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = np.divide(fn, lens, out=np.zeros_like(fn), where=lens > 0)

    # --- angle-weighted vertex pseudo-normals (Mesh.cpp:216-242) -----------
    # np.bincount per component: a scatter-add with np.add.at is ~10x slower
    vpn = np.zeros_like(v)
    nv = v.shape[0]
    for e in range(3):
        p0 = v[fc[:, e]]
        p1 = v[fc[:, (e + 1) % 3]]
        p2 = v[fc[:, (e + 2) % 3]]
        u1 = p1 - p0
        u2 = p2 - p0
        cosang = (np.sum(u1 * u2, axis=1)
                  / np.maximum(np.linalg.norm(u1, axis=1)
                               * np.linalg.norm(u2, axis=1), 1e-300))
        ang = np.arccos(np.clip(cosang, -1.0, 1.0))
        idx = fc[:, e].astype(np.int64)
        for k in range(3):
            vpn[:, k] += np.bincount(idx, weights=ang * fn[:, k],
                                     minlength=nv)
    lens = np.linalg.norm(vpn, axis=1, keepdims=True)
    vpn = np.divide(vpn, lens, out=np.zeros_like(vpn), where=lens > 0)

    # --- edge pseudo-normals: average of the two adjacent face normals
    #     (pi-weighted sum, Mesh.cpp:200-213) -------------------------------
    twin_face = twin // 3
    epn = fn[:, None, :] + fn[twin_face.reshape(F, 3)]
    lens = np.linalg.norm(epn, axis=2, keepdims=True)
    epn = np.divide(epn, lens, out=np.zeros_like(epn), where=lens > 0)

    return TriMesh(vertices=v, faces=fc, face_normals=fn, vertex_pn=vpn,
                   edge_pn=epn, twin=twin.reshape(F, 3))


def mesh_from_obj(path: str) -> TriMesh:
    """Mesh::CreateFromObj equivalent (Mesh.cpp:15-39): parse, then build."""
    from .obj import load_obj
    v, f, _ = load_obj(path)
    return build_mesh(v, f)
