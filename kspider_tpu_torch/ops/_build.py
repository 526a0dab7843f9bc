"""Build and load the port's CUDA kernels at first use.

The sources under ``kspider_tpu_torch/csrc/`` are compiled by ``nvcc``, one
process per source, all started together, and linked into a shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``kspider_tpu_torch/build/`` under a name that carries a hash of the sources,
the headers they include and the flags, so an edited source or header is
rebuilt and a stale build is never loaded.  Nothing is compiled at import
time.  :func:`hashed_path` and :func:`build_library` build every shared
library of the port; :func:`build_host` builds its host C++ libraries (the
TSV library of ``io/tsv_rows``, the panel plan of ``ops/tiled_pairwise``)
with the host compiler, never ``nvcc``.
"""

import ctypes
import functools
import glob
import hashlib
import os
import shlex
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
SOURCES = ("gram_int8.cu", "gram_bf16.cu")
#: headers the sources include: part of the library's hash
HEADERS = ("gram_wgmma.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
#: flags of the host C++ libraries
CXX_FLAGS = ("-O3", "-std=c++17", "-pthread", "-fPIC", "-shared")


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


def hashed_path(build_dir: str, stem: str, words, inputs) -> str:
    """``<build_dir>/<stem>_<hash>.so``, the hash over ``words`` (the
    compiler and its flags) and the bytes of the files ``inputs``: an
    edited input gets a new name, so a stale build is never loaded."""
    digest = hashlib.sha256(" ".join(words).encode())
    for name in inputs:
        with open(name, "rb") as f:
            digest.update(f.read())
    return os.path.join(build_dir, f"{stem}_{digest.hexdigest()[:16]}.so")


def build_library(path: str, stages) -> str:
    """Build the host library ``path`` (a :func:`hashed_path`) unless it
    exists; returns ``path``.

    ``stages(tmp)`` gives the commands that build it into ``tmp + ".tmp"``:
    a list of stages, each a list of commands started all at once, a stage
    after the one before.  Object files they leave as ``tmp + ".*.o"`` are
    removed, and the library takes its name in one ``os.replace``, so a
    reader never loads a half-written file.  A failed command raises
    ``RuntimeError`` with the command and its stderr."""
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}"
    for cmds in stages(tmp):
        with ThreadPoolExecutor(len(cmds)) as pool:
            list(pool.map(_run, cmds))
    for obj in glob.glob(glob.escape(tmp) + ".*.o"):
        os.remove(obj)
    os.replace(f"{tmp}.tmp", path)
    return path


def compiler() -> list:
    """The host C++ compiler: ``$CXX`` split into words, else ``g++``."""
    return shlex.split(os.environ.get("CXX") or "g++")


def build_host(build_dir: str, stem: str, source: str) -> str:
    """Compile the host C++ ``source`` into ``<build_dir>/<stem>_<hash>.so``
    with :func:`compiler` and ``CXX_FLAGS`` unless it exists; returns its
    path."""
    words = compiler() + list(CXX_FLAGS)
    return build_library(hashed_path(build_dir, stem, words, [source]),
                         lambda tmp: [[[*words, source, "-o", f"{tmp}.tmp"]]])


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed ({proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr}"
        )


def library_path() -> str:
    return hashed_path(BUILD_DIR, "libkspider_torch", NVCC_FLAGS,
                       [os.path.join(_CSRC_DIR, n) for n in SOURCES + HEADERS])


def build() -> str:
    """Compile the sources unless the hashed library exists; returns its path:
    each source by its own ``nvcc``, all at once, then one link."""

    def stages(tmp):
        nvcc = find_nvcc()
        objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
        return [
            [[nvcc, *NVCC_FLAGS, "-c", os.path.join(_CSRC_DIR, s), "-o", o]
             for s, o in zip(SOURCES, objs)],
            [[nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.tmp", *objs]],
        ]

    return build_library(library_path(), stages)


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
    # pointers, then num_pairs, n_blocks, block, n_limbs, npad_i, npad_j,
    # (bf16: segment_chunks,) stream
    lib.ks_gram_int8_tiles.restype = ci
    lib.ks_gram_int8_tiles.argtypes = [vp] * 6 + [ci] * 6 + [vp]
    lib.ks_gram_bf16_tiles.restype = ci
    lib.ks_gram_bf16_tiles.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    return lib
