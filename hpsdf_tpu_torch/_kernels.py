"""Build and bind the hand-written CUDA kernels in ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by nvcc for Hopper
(``sm_90a``), one nvcc process per source, all started together, and the
objects are linked into one shared library with a plain C interface, which
is loaded with ctypes. The library goes to ``build/hpsdf_tpu_torch/`` at
the repository root, under a name keyed by a hash of the sources, the
headers they share (``csrc/*.cuh``) and the flags, so a changed file
rebuilds and an unchanged one is reused. Nothing is fetched: the sources
are the package's own. What ptxas reports of each kernel (registers,
stack frame, spills) is kept beside the library (``ptxas_report``).
``csrc/check/`` holds reference kernels that no path of the package runs
(earlier forms of kernels, kept so that a check can hold the shipped ones
to them, bit for bit where both add in the same order, and time both);
``load_check`` builds them the same way into a library of their own.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "hpsdf_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_F32, _F64 = ctypes.c_float, ctypes.c_double
# C signatures of the entry points (see the .cu sources)
_SIGNATURES = {
    "hpsdf_stage_rows": (_P, _I64, _I64, _P, _P),
    "hpsdf_closest_tri": (_P, _P, _P, _I64, _P, _I64, _I32, _P, _P, _P, _P),
    "hpsdf_hybrid": (_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64,
                     _I32, _I64, _I64, _I64, _I64, _I64, _P, _I64, _P, _P,
                     _P, _P, _P),
    "hpsdf_bvh_walk": (_P, _P, _I64, _I64, _I32, _P, _I64, _I64, _P, _P, _P,
                       _P),
    "hpsdf_query": (_P, _P, _P, _P, _I32, _I32, _P, _I64,
                    _F64, _F64, _F64, _F64, _F64, _F64, _I32, _P, _P, _P),
    "hpsdf_descend_nodes": (_P, _P, _I32, _I32, _P, _P, _I64, _P, _P),
    "hpsdf_leaf_nodes": (_P, _P, _P, _I32, _I32, _I32, _P, _P, _I64, _P, _P),
    "hpsdf_row_gather": (_P, _I64, _I64, _I64, _P, _I64, _P, _P),
    "hpsdf_packed_eval": (_P, _P, _I32, _I32, _I32, _I32, _P, _I64,
                          _F32, _F32, _F32, _F32, _F32, _F32,
                          _F32, _F32, _F32, _I32, _I32, _P, _P, _I64, _P),
    "hpsdf_march": (_P, _P, _I32, _I32, _P, _P, _I32, _I32, _I32, _P, _I64,
                    _P, _I64, _P, _F32, _F32, _I32, _F32, _I32, _F32, _I32,
                    _P, _P, _P, _P, _P, _I32, _P),
    "hpsdf_cone": (_P, _P, _I32, _I32, _P, _P, _I32, _I32, _P, _I64, _P,
                   _I32, _I32, _I32, _P, _F32, _F32, _I32, _P, _P, _P),
    "hpsdf_row_scatter": (_P, _I64, _P, _I64, _I64, _P, _I64, _P, _P),
    "hpsdf_row_scatter_csr": (_P, _I64, _P, _P, _I64, _P, _P),
    "hpsdf_packed_grad": (_P, _P, _I32, _I32, _I32, _I32, _I32, _P, _I64,
                          _F32, _F32, _F32, _F32, _F32, _F32,
                          _P, _I32, _P, _I64, _P, _P, _P),
    "hpsdf_coeff_scatter": (_P, _P, _P, _P, _I32, _I32, _P, _P, _P, _P, _P,
                            _I64, _F64, _F64, _F64, _F64, _F64, _F64,
                            _P, _I32, _I32, _P, _P),
    "hpsdf_coeff_scatter_nodes": (_P, _P, _I32, _I32, _I32, _P, _P, _I64,
                                  _F64, _F64, _F64, _F64, _F64, _F64, _P,
                                  _I32, _P, _P),
    "hpsdf_cg_matvec": (_P, _P, _P, _I64, _F64, _P, _P, _P, _P, _P, _P),
    "hpsdf_cg_update": (_I32, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "hpsdf_cg_iterations": (_P, _P, _P, _I64, _F64, _P, _P, _P, _P, _P, _P,
                            _P, _P, _I32, _P),
    "hpsdf_face_matvec": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I64, _F64,
                          _P, _P, _P, _P, _P, _P),
    "hpsdf_cg_chunk": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I64, _I32,
                       _I32, _F64, _P, _P, _P, _P, _P, _P, _P, _P, _I32, _P),
    "hpsdf_face_matvec_rows": (_P, _P, _P, _P, _P, _I32, _I32, _I32, _I64,
                               _F64, _P, _P, _P, _P, _P, _P),
    "hpsdf_cg_update_rows": (_I32, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P),
    "hpsdf_cg_direction": (_I32, _I64, _P, _P, _P, _P, _P),
}
# entry points that return a size in bytes (int64_t), not an error code
_SIZE_SIGNATURES = {
    "hpsdf_row_scatter_scratch": (_I64, _I64),
    "hpsdf_packed_grad_scratch": (_I64, _I32, _I32, _I32),
    "hpsdf_cg_scratch": (),
    "hpsdf_cg_chunk_blocks": (_I64,),
}
# and of the reference kernels under csrc/check/, which only checks load
_CHECK_SIGNATURES = {
    "hpsdf_march_reference": (_P, _P, _I32, _I32, _P, _P, _I32, _I32, _I32,
                              _P, _P, _I64, *(_F32,) * 12, _F32, _F32, _I32,
                              _F32, _I32, _F32, _I32, _P, _P, _P, _P),
    "hpsdf_packed_grad_reference": (_P, _P, _I32, _I32, _I32, _I32, _P, _I64,
                                    _F32, _F32, _F32, _F32, _F32, _F32,
                                    _P, _I32, _P, _P, _P),
    "hpsdf_row_scatter_reference": (_P, _I64, _P, _I64, _I64, _P, _P),
    "hpsdf_coeff_scatter_reference": _SIGNATURES["hpsdf_coeff_scatter"],
    "hpsdf_cone_reference": (_P, _P, _I32, _I32, _P, _P, _I32, _I32, _P,
                             _I64, _P, _I32, _I32, _I32, _P, _F32, _F32,
                             _I32, _P, _P),
    "hpsdf_bvh_walk_reference": _SIGNATURES["hpsdf_bvh_walk"],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_check_lock = threading.Lock()
_check_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA toolkit is needed to build the "
        "hpsdf_tpu_torch kernels for CUDA tensors")


def sources(sub: str = "") -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, sub, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))


def library_path(sub: str = "") -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(sub) + headers():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(
        BUILD_DIR, f"libhpsdf_{sub or 'kernels'}_{h.hexdigest()[:16]}.so")


def _build(path: str, sub: str = "") -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: a concurrent loader never sees a
    # half-written library
    tmp = f"{path}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources(sub)]
    jobs = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources(sub), objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        outs = [p.communicate() for p in procs]      # waits for every one
        for cmd, p, (out, err) in zip(jobs, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{out}\n{err}")
        with open(f"{tmp}.ptxas.txt", "w") as fh:
            fh.writelines(out + err for out, err in outs)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}): {' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(f"{tmp}.ptxas.txt", f"{path}.ptxas.txt")
    os.replace(tmp, path)


def ptxas_report(sub: str = "") -> str:
    """ptxas's report of the built library's kernels (``-Xptxas -v``)."""
    with open(f"{library_path(sub)}.ptxas.txt") as fh:
        return fh.read()


def _load(sub: str, signatures: dict) -> ctypes.CDLL:
    path = library_path(sub)
    if not os.path.exists(path):
        _build(path, sub)
    lib = ctypes.CDLL(path)
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = _I64 if name in _SIZE_SIGNATURES else ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _load("", {**_SIGNATURES, **_SIZE_SIGNATURES})
            lib.hpsdf_error_string.argtypes = [ctypes.c_int]
            lib.hpsdf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def load_check() -> ctypes.CDLL:
    """The reference kernels of ``csrc/check/``, a library of its own that
    no path of the package loads: earlier forms kept so that a check can
    hold the shipped kernels to them."""
    global _check_lib
    with _check_lock:
        if _check_lib is None:
            _check_lib = _load("check", _CHECK_SIGNATURES)
        return _check_lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.hpsdf_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
