"""Wavefront .obj parsing (host side): a copy of ``hpsdf_tpu/mesh/obj.py``.

Equivalent of Meshing::ObjParser (reference: Source/Meshing/ObjParser.cpp):
``v``/``vn``/``vt``/``f`` lines, the three face encodings ``f v``,
``f v//vn``, ``f v/vt/vn`` (ObjParser.cpp:87-136), and vertex normals
computed by accumulating unit face normals when the file has none
(ObjParser.cpp:141-164). Vectorized numpy line handling instead of the
reference's per-character scanner; parsing is a one-off host task.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str, native: bool | None = None
             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a triangle .obj file.

    Returns (vertices (V, 3) f64, faces (F, 3) i32 0-based, normals (V, 3)).
    Polygonal faces are fan-triangulated. Negative (relative) indices are
    resolved per the .obj spec.

    ``native=None`` (default) uses the C++ parser (hpsdf_tpu_torch.native)
    when available and falls back to this Python implementation; True requires
    the native parser; False forces Python.
    """
    if native is not False:
        from .. import native as _native
        out = _native.load_obj(path) if _native.available() else None
        if out is not None:
            return out
        if native:
            raise RuntimeError("native obj parser unavailable")
    verts: list[list[float]] = []
    norms: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    face_norm_idx: list[tuple[int, int, int]] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] not in "vf":
                continue
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif tag == "f":
                idx = []
                nidx = []
                for tok in parts[1:]:
                    sub = tok.split("/")
                    vi = int(sub[0])
                    idx.append(vi - 1 if vi > 0 else len(verts) + vi)
                    if len(sub) == 3 and sub[2]:
                        ni = int(sub[2])
                        nidx.append(ni - 1 if ni > 0 else len(norms) + ni)
                for k in range(1, len(idx) - 1):   # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))
                    if len(nidx) == len(idx):
                        face_norm_idx.append((nidx[0], nidx[k], nidx[k + 1]))

    v = np.asarray(verts, np.float64).reshape(-1, 3)
    fc = np.asarray(faces, np.int32).reshape(-1, 3)

    if norms and len(face_norm_idx) == len(faces):
        # average the file's normals onto vertices
        nsrc = np.asarray(norms, np.float64)
        vn = np.zeros_like(v)
        fn_idx = np.asarray(face_norm_idx, np.int64)
        np.add.at(vn, fc.astype(np.int64).ravel(), nsrc[fn_idx.ravel()])
    else:
        # accumulate unit face normals (reference: ObjParser.cpp:141-164)
        e1 = v[fc[:, 1]] - v[fc[:, 0]]
        e2 = v[fc[:, 2]] - v[fc[:, 0]]
        fn = np.cross(e1, e2)
        lens = np.linalg.norm(fn, axis=1, keepdims=True)
        fn = np.divide(fn, lens, out=np.zeros_like(fn), where=lens > 0)
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, fc[:, k].astype(np.int64), fn)
    lens = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = np.divide(vn, lens, out=np.zeros_like(vn), where=lens > 0)
    return v, fc, vn
