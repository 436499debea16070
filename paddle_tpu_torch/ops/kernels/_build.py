"""Build and load the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``) at first use, one ``nvcc -c`` per source started together,
then linked into one shared library with a plain C interface under
``_build/`` (listed in ``.gitignore``), and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses the library.

Nothing here runs at import: :func:`library` builds on its first call,
which happens only when a wrapper is handed a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("rms_norm.cu", "paged_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
_NVCC_TIMEOUT_S = 600  # each source builds in seconds

# dtype codes of the C entry points (csrc/common.cuh, ptt::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C signatures: every pointer and the stream are c_void_p (a pointer
# passed as a bare Python int would be cut to 32 bits)
_SIGNATURES = {
    # x, w, y, rows, hidden, eps, dtype, stream
    "ptt_rms_norm": (_P, _P, _P, _I64, _I64, _F32, _I32, _P),
    # q, k_pages, v_pages, page_table, seq_lens, q_lens, out,
    # B, T, H, KVH, D, NP, P, MP, scale, window, dtype, stream
    "ptt_paged_ragged_attention": (
        _P, _P, _P, _P, _P, _P, _P,
        _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
        _F32, _I64, _I32, _P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's build (None: reused)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand:
            path = os.path.join(cand, "bin", "nvcc")
            if os.path.exists(path):
                return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/"
            "bin and PATH): the port's CUDA kernels are built from "
            "paddle_tpu_torch/ops/kernels/csrc at first use")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _compile(target: str) -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        errors = []
        try:
            for name in SOURCES:
                obj = os.path.join(tmp, name + ".o")
                objs.append(obj)
                procs.append((name, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                     "-o", obj],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            for name, proc in procs:
                out, _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
                if proc.returncode != 0:
                    errors.append(f"--- {name} (exit {proc.returncode})\n"
                                  + out.decode(errors="replace"))
        finally:
            for _, proc in procs:  # none outlives a failed build
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib_tmp = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", lib_tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            timeout=_NVCC_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(lib_tmp, target)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            target = os.path.join(BUILD_DIR,
                                  f"libpaddle_tpu_torch_{_digest()}.so")
            if not os.path.exists(target):
                t0 = time.perf_counter()
                _compile(target)
                build_seconds = time.perf_counter() - t0
            lib = ctypes.CDLL(target)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error (the launch's
    ``cudaGetLastError()``): a refused launch never runs, and a later
    synchronize would not report it."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error "
                           f"{status}")
