"""ctypes bindings for the native host library (the counterpart of
``hpsdf_tpu/native.py``, with the same entry points and structures).

The host stages of the mesh pipeline -- .obj parsing, half-edge pairing,
the pseudo-normal pass, the kd ordering and the packing of triangle and
heap-node rows -- have C++ versions in the repository's
``native/hpsdf_native.cpp``. At first use that source is compiled with g++
(the flags of ``hpsdf_tpu/native.py``) into
``build/hpsdf_tpu_torch/libhpsdf_native.so`` at the repository root; the
source itself is only read. Without a toolchain or the source every caller
takes the numpy paths of ``mesh/obj.py``, ``mesh/core.py`` and
``mesh/bvh.py``, which stay the behavioural oracles; ``HPSDF_NO_NATIVE=1``
forces them. These are host stages, not device kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG_DIR)
_SRC = os.path.join(_ROOT, "native", "hpsdf_native.cpp")
_LIB_PATH = os.path.join(_ROOT, "build", "hpsdf_tpu_torch",
                         "libhpsdf_native.so")
_VERSION = b"hpsdf_native 4"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


class _ObjData(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_double)),
        ("normals", ctypes.POINTER(ctypes.c_double)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("n_verts", ctypes.c_int64),
        ("n_faces", ctypes.c_int64),
    ]


def _build() -> bool:
    if not os.path.exists(_SRC):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # compile to a private name, then rename: a concurrent loader never maps
    # a half-written library, and dlopen sees a fresh inode
    tmp = _LIB_PATH + f".tmp{os.getpid()}"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def _open() -> ctypes.CDLL | None:
    """The library at _LIB_PATH if it loads and is of the source's version."""
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.hpsdf_version.restype = ctypes.c_char_p
        return lib if lib.hpsdf_version() == _VERSION else None
    except (OSError, AttributeError):
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P = ctypes.POINTER
    f32, f64, i32, i64 = (ctypes.c_float, ctypes.c_double, ctypes.c_int32,
                          ctypes.c_int64)
    lib.hpsdf_parse_obj.restype = ctypes.c_int
    lib.hpsdf_parse_obj.argtypes = [ctypes.c_char_p, P(_ObjData)]
    lib.hpsdf_free_obj.argtypes = [P(_ObjData)]
    lib.hpsdf_half_edges.restype = ctypes.c_int
    lib.hpsdf_half_edges.argtypes = [P(i32), i64, i64, P(i32)]
    lib.hpsdf_kd_order.restype = None
    lib.hpsdf_kd_order.argtypes = [P(f32), i64, i64, P(i32)]
    lib.hpsdf_pack_tris.restype = None
    lib.hpsdf_pack_tris.argtypes = [P(f64), P(i32), P(f64), P(f64), P(f64),
                                    P(i32), P(i64), i64, i64, f32, P(f32)]
    lib.hpsdf_bvh_nodes.restype = None
    lib.hpsdf_bvh_nodes.argtypes = [P(f32), i64, P(f32)]
    lib.hpsdf_mesh_geom.restype = None
    lib.hpsdf_mesh_geom.argtypes = [P(f64), P(i32), P(i32), i64, i64, P(f64),
                                    P(f64), P(f64)]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("HPSDF_NO_NATIVE", "0") == "1":
            return None
        lib = _open() if os.path.exists(_LIB_PATH) else None
        if lib is None:             # missing, or of an older source
            if not _build():
                return None
            lib = _open()
        if lib is not None:
            _lib = _bind(lib)
        return _lib


def available() -> bool:
    """True when the native library is loaded (building it if needed)."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_obj(path: str):
    """Native .obj parse. Returns (vertices (V,3) f64, faces (F,3) i32,
    vertex normals (V,3) f64) with the semantics of mesh.obj.load_obj, or
    None if the native library is unavailable. Raises OSError / ValueError
    on unreadable / malformed files."""
    lib = _load()
    if lib is None:
        return None
    data = _ObjData()
    rc = lib.hpsdf_parse_obj(os.fsencode(path), ctypes.byref(data))
    if rc == 1:
        raise OSError(f"cannot open {path!r}")
    if rc != 0:
        raise ValueError(f"malformed .obj file {path!r}")
    try:
        V, F = data.n_verts, data.n_faces
        v = np.ctypeslib.as_array(data.verts, (V, 3)).copy() if V else \
            np.zeros((0, 3), np.float64)
        n = np.ctypeslib.as_array(data.normals, (V, 3)).copy() if V else \
            np.zeros((0, 3), np.float64)
        f = np.ctypeslib.as_array(data.faces, (F, 3)).copy() if F else \
            np.zeros((0, 3), np.int32)
    finally:
        lib.hpsdf_free_obj(ctypes.byref(data))
    return v, f, n


def half_edge_twins(faces: np.ndarray, n_verts: int):
    """Native half-edge pairing. faces: (F, 3) int32. Returns the (3F,)
    int32 twin array, or None if the native library is unavailable.
    Raises mesh.core.NotWatertightError on boundary / non-manifold /
    mis-oriented edges (the numpy path's contract)."""
    lib = _load()
    if lib is None:
        return None
    fc = np.ascontiguousarray(faces, np.int32)
    twin = np.empty(3 * fc.shape[0], np.int32)
    rc = lib.hpsdf_half_edges(_ptr(fc, ctypes.c_int32), fc.shape[0],
                              int(n_verts), _ptr(twin, ctypes.c_int32))
    if rc != 0:
        from .mesh.core import NotWatertightError
        raise NotWatertightError(
            "unpaired edge (boundary or non-manifold)" if rc == 1
            else "inconsistently oriented edge pair")
    return twin


def kd_order(cent: np.ndarray, T2: int):
    """Native recursive median-split ordering (mesh.bvh.kd_order's
    contract): cent (T,3) centroids -> (T2,) int32 permutation of slot ids,
    values >= T being dummy slots. nth_element per segment, O(n log n).
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(cent, np.float32)
    out = np.empty(T2, np.int32)
    lib.hpsdf_kd_order(_ptr(c, ctypes.c_float), c.shape[0], int(T2),
                       _ptr(out, ctypes.c_int32))
    return out


def pack_tri_rows(verts, faces, face_n, vertex_pn, edge_pn,
                  order, slots, T2: int, big: float):
    """Native packed-triangle-row fill (mesh.bvh.pack_triangles and its
    scatter): returns (T2, 32) f32 rows, ``big`` everywhere except row
    slots[k] = packed triangle order[k]. None if the library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    fc = np.ascontiguousarray(faces, np.int32)
    fn = np.ascontiguousarray(face_n, np.float64)
    vpn = np.ascontiguousarray(vertex_pn, np.float64)
    epn = np.ascontiguousarray(edge_pn, np.float64)
    od = np.ascontiguousarray(order, np.int32)
    sl = np.ascontiguousarray(slots, np.int64)
    rows = np.empty((T2, 32), np.float32)
    lib.hpsdf_pack_tris(
        _ptr(v, ctypes.c_double), _ptr(fc, ctypes.c_int32),
        _ptr(fn, ctypes.c_double), _ptr(vpn, ctypes.c_double),
        _ptr(epn, ctypes.c_double), _ptr(od, ctypes.c_int32),
        _ptr(sl, ctypes.c_int64), od.size, int(T2), float(big),
        _ptr(rows, ctypes.c_float))
    return rows


def mesh_geom(verts: np.ndarray, faces: np.ndarray, twin: np.ndarray):
    """Native pseudo-normal pass (mesh.core.build_mesh's geometry phase):
    returns (face_normals (F,3), vertex_pn (V,3), edge_pn (F,3,3)), f64
    unit vectors, or None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    fc = np.ascontiguousarray(faces, np.int32)
    tw = np.ascontiguousarray(twin, np.int32).ravel()
    F = fc.shape[0]
    fn = np.empty((F, 3), np.float64)
    vpn = np.empty((v.shape[0], 3), np.float64)
    epn = np.empty((F, 3, 3), np.float64)
    lib.hpsdf_mesh_geom(
        _ptr(v, ctypes.c_double), _ptr(fc, ctypes.c_int32),
        _ptr(tw, ctypes.c_int32), v.shape[0], F, _ptr(fn, ctypes.c_double),
        _ptr(vpn, ctypes.c_double), _ptr(epn, ctypes.c_double))
    return fn, vpn, epn


def bvh_node_rows(tri_rows: np.ndarray):
    """Native heap-node-row build (mesh.bvh.build_bvh's leaf boxes and level
    unions): tri_rows (T2, 32) f32 -> (T2, 16) f32 node rows. None if the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    tr = np.ascontiguousarray(tri_rows, np.float32)
    out = np.empty((tr.shape[0], 16), np.float32)
    lib.hpsdf_bvh_nodes(_ptr(tr, ctypes.c_float), tr.shape[0],
                        _ptr(out, ctypes.c_float))
    return out
