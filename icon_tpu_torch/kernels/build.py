"""Build the port's CUDA kernels (nvcc -> cached shared library).

The library is built from the repository's ``csrc/*.cu`` sources at first
use, for ``sm_90a``, with a plain C interface that :mod:`ctypes` binds. The
output is cached under ``icon_tpu_torch/_build/`` by a hash of the sources
and flags; concurrent builds race safely through an atomic rename. A
failed build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import shutil
import subprocess
import tempfile

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SRC_DIR = osp.join(_PKG, "csrc")
_CACHE_DIR = osp.join(_PKG, "_build")

SOURCES = ("knn.cu",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``; raises if
    none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(osp.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if osp.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(osp.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if the cached library is missing; return its
    path. Raises ``RuntimeError`` with nvcc's output on failure."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    so_path = osp.join(_CACHE_DIR, f"libicon_kernels-{_source_hash()}.so")
    if osp.exists(so_path):
        return so_path
    nvcc = find_nvcc()
    srcs = [osp.join(_SRC_DIR, s) for s in SOURCES]
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           *srcs, "-o", tmp_path]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp_path, so_path)     # atomic under concurrent builds
    finally:
        if osp.exists(tmp_path):
            os.unlink(tmp_path)
    return so_path
