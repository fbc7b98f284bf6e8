"""Builds the port's CUDA kernels at first use and loads them with ctypes.

One `nvcc` per source under `shockwave_tpu_torch/csrc/` (the narrow
kernels, the wide ones, the TMA-fed K1-K3 in bf16 and in f32), all
started together,
compiles an object
file, and a last `nvcc` links them into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds, not minutes).
The library lands in `shockwave_tpu_torch/csrc/build/<hash>/`, keyed by a
hash of the sources, the headers they include and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import: the CPU tests import every module of the
port and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
SOURCES = ("flash_attention.cu", "flash_attention_wide.cu", "flash_attention_tma.cu",
           "flash_attention_tma_f32.cu")
HEADERS = ("flash_attention_common.cuh", "flash_attention_tma.cuh")
LIB_NAME = "libswt_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (name, argtypes) of every C entry point; each returns a cudaError_t as int.
_ENTRY_POINTS = (
    ("swt_flash_fwd", [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dq", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dkv", [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_fwd_f32", [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dq_f32", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dkv_f32", [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_fwd_wide", [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dq_wide", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dkv_wide", [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_fwd_wide_f32", [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dq_wide_f32", [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_dkv_wide_f32", [_P] * 9 + [_I] * 6 + [_F, _I, _I, _P]),
    ("swt_flash_occupancy", [_I] * 4 + [_P]),
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, _source_hash(), LIB_NAME)


def build() -> str:
    """Compile the library if this hash has not been built; returns its
    path. Raises with nvcc's output when the compiler fails. The
    compiler's report (registers, shared memory, spills per kernel) is
    kept beside the library as `build.log`."""
    path = library_path()
    if os.path.exists(path):
        return path
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objects = [os.path.join(out_dir, f"{os.path.splitext(s)[0]}.{tag}.o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(CSRC_DIR, src)]
                for src, obj in zip(SOURCES, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in compiles]
    log = []
    for cmd, proc in zip(compiles, procs):
        out, err = proc.communicate()
        if proc.returncode != 0:
            for other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{out}\n{err}")
        log.append(out + err)
    tmp = f"{path}.{tag}"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", tmp, *objects]
    proc = subprocess.run(link, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(link)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    for obj in objects:
        os.remove(obj)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("".join(log))
    os.replace(tmp, path)
    return path


def build_log() -> str:
    """The compiler's report of the current build ('' before a build)."""
    log = os.path.join(os.path.dirname(library_path()), "build.log")
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.swt_error_string.argtypes = [ctypes.c_int]
            lib.swt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.swt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
