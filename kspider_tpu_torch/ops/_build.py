"""Build and load the port's CUDA kernels at first use.

The sources under ``kspider_tpu_torch/csrc/`` are compiled by ``nvcc`` into
a shared library with a plain C interface and loaded with ``ctypes``.  The
library lands in ``kspider_tpu_torch/build/`` under a name that carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
build is never loaded.  Nothing is compiled at import time.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("gram_int8.cu", "gram_bf16.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` if set, else ``nvcc`` on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        path = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin/ on PATH"
        )
    return path


def library_path() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_CSRC_DIR, name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libkspider_torch_{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the hashed library exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(_CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ks_gram_tile.restype = ci
    lib.ks_gram_tile.argtypes = []
    for name in ("ks_gram_chunk", "ks_gram_chunk_bf16"):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = []
    for name in ("ks_gram_int8_tiles", "ks_gram_bf16_tiles"):
        getattr(lib, name).restype = ci
        getattr(lib, name).argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
        ]
    return lib
