"""Build and bind the port's CUDA kernels (pcd_tpu_torch/csrc/*.cu).

Each source is compiled by hand with nvcc for sm_90a into a shared
library with a plain C interface and loaded through ctypes: seconds of
build, where a PyTorch C++ extension takes minutes.  The build happens at
first use, one nvcc per source started together, into csrc/build/, keyed
by a hash of the sources and flags; nothing is compiled when a module is
imported (the CPU tests import every module and have no nvcc).  There is
no fallback: a failed build or a refused launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
HEADERS = ("ptx.cuh", "field.cuh", "ec.cuh", "ec_group.cuh", "rows.cuh")
SOURCES = {"madd_accumulate": "madd_accumulate.cu",
           "complete_add": "complete_add.cu",
           "madd": "madd.cu",
           "bucket_finish": "bucket_finish.cu",
           "sched_digits": "sched_digits.cu",
           "ntt": "ntt.cu",
           "spmv": "spmv.cu",
           "fp_vec": "fp_vec.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
BUILD_INFO: dict = {}   # name -> {"seconds", "ptxas", "so"} of this process


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in HEADERS + (SOURCES[name],):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every kernel source that has no up-to-date library, all
    in parallel; returns BUILD_INFO.  Raises with nvcc's output on a
    failed build."""
    with _lock:
        todo = {n: _so_path(n) for n in SOURCES}
        todo = {n: so for n, so in todo.items()
                if n not in BUILD_INFO and not os.path.exists(so)}
        if not todo:
            return BUILD_INFO
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n, so in todo.items():
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[n] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC, SOURCES[n])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, so)
        failed = []
        for n, (proc, tmp, so) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}:\n{log[-4000:]}")
                continue
            os.replace(tmp, so)
            BUILD_INFO[n] = {"seconds": time.perf_counter() - t0,
                             "ptxas": log, "so": so}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return BUILD_INFO


# the C entry of each kernel source: (function, restype, argtypes)
_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
ENTRIES = {
    "madd_accumulate": [("pcd_madd_accumulate", _ci,
                         [_ci, _vp, _vp, _vp, _vp, _cl, _ci, _ci, _vp, _vp])],
    "complete_add": [("pcd_complete_add", _ci,
                      [_ci, _vp, _vp, _vp, _cl, _vp, _vp, _vp]),
                     ("pcd_complete_add_info", _ci, [_ci, _ci, _vp])],
    "madd": [("pcd_madd", _ci,
              [_ci, _vp, _vp, _vp, _vp, _cl, _vp, _vp, _vp]),
             ("pcd_madd_info", _ci, [_ci, _ci, _vp])],
    "bucket_finish": [("pcd_bucket_finish", _ci,
                       [_ci, _vp, _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci,
                        _ci, _vp, _vp]),
                      ("pcd_finish_block", _ci, [])],
    "sched_digits": [("pcd_p1_digits", _ci,
                      [_vp, _cl, _ci, _ci, _ci, _ci, _ci, _vp, _vp, _vp]),
                     ("pcd_p1_hist", _ci, [_vp, _ci, _cl, _ci, _vp, _vp]),
                     ("pcd_p1_scan", _ci, [_vp, _ci, _ci, _ci, _vp, _vp]),
                     ("pcd_p1_scatter", _ci,
                      [_vp, _ci, _cl, _ci, _vp, _vp, _vp, _vp]),
                     ("pcd_p1_tile", _ci, []), ("pcd_p1_warps", _ci, [])],
    "ntt": [("pcd_ntt_pass", _ci,
             [_vp, _vp, _vp, _vp, _cl, _ci, _vp, _vp, _vp, _ci, _vp, _cl,
              _ci, _vp, _cl])],
    "spmv": [("pcd_spmv_rows", _ci,
              [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _cl, _cl, _vp, _vp])],
    "fp_vec": [("pcd_fp_vec", _ci, [_ci, _cl, _cl, _cl, _vp, _vp, _vp, _vp,
                                    _vp, _vp, _vp, _vp, _vp])],
}


def load(so: str, name: str) -> ctypes.CDLL:
    """The library at `so`, a build of kernel source `name` (this tree's
    or another's), with the C entries of that source bound."""
    L = ctypes.CDLL(so)
    for fn, res, args in ENTRIES[name]:
        f = getattr(L, fn)
        f.restype = res
        f.argtypes = args
    return L


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source `name`, built on first use."""
    hit = _libs.get(name)
    if hit is not None:
        return hit
    build()
    so = _so_path(name)
    with _lock:
        if name not in _libs:
            _libs[name] = load(so, name)
        return _libs[name]
