"""Build the port's native libraries (cached shared libraries).

:func:`build`: each of the repository's ``csrc/*.cu`` sources becomes its
own shared library at first use, for ``sm_90a``, with a plain C interface
that :mod:`ctypes` binds; the nvcc processes run in parallel.
:func:`build_host`: the host lattice decoder ``csrc/latticecodec.cc``,
compiled by ``g++`` (no CUDA toolkit needed, so the CPU frames use it too).
The outputs are cached under ``icon_tpu_torch/_build/`` by a hash of each
source and the flags; concurrent builds race safely through an atomic
rename. A failed build raises: there is no fallback.
"""

from __future__ import annotations

import hashlib
import os
import os.path as osp
import shutil
import signal
import subprocess
import tempfile
from typing import Dict

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
_SRC_DIR = osp.join(_PKG, "csrc")
_CACHE_DIR = osp.join(_PKG, "_build")

SOURCES = ("knn.cu", "raster.cu", "voxelize.cu", "winding.cu",
           "marching.cu", "lattice.cu", "bodyfeat.cu", "level.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
HOST_SOURCE = "latticecodec.cc"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-Wall", "-Werror"]


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


def _library_path(name: str, flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    with open(osp.join(_SRC_DIR, name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    stem = osp.splitext(name)[0]
    return osp.join(_CACHE_DIR, f"libicon_{stem}-{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose cached library is missing, one nvcc
    process per source, all started together; return ``{source: library
    path}``. Raises ``RuntimeError`` with nvcc's output on failure."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    paths = {name: _library_path(name) for name in SOURCES}
    todo = [name for name, path in paths.items() if not osp.exists(path)]
    if not todo:
        return paths
    nvcc = find_nvcc()
    jobs = []
    try:
        for name in todo:
            fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
                   osp.join(_SRC_DIR, name), "-o", tmp_path]
            # a session of its own, so that a kill takes nvcc's children
            jobs.append((name, tmp_path, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, start_new_session=True)))
        failed = []
        for name, tmp_path, cmd, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
            else:
                if verbose:
                    print(out, end="")
                os.replace(tmp_path, paths[name])  # atomic under races
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp_path, _, proc in jobs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            if osp.exists(tmp_path):
                os.unlink(tmp_path)
    return paths


def build_host() -> str:
    """Compile the host lattice decoder with ``g++`` if its cached library
    is missing; return the library path. Raises ``RuntimeError`` with the
    compiler's output on failure."""
    os.makedirs(_CACHE_DIR, exist_ok=True)
    path = _library_path(HOST_SOURCE, CXX_FLAGS)
    if osp.exists(path):
        return path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the lattice decoder cannot be "
                           "built")
    fd, tmp_path = tempfile.mkstemp(suffix=".so", dir=_CACHE_DIR)
    os.close(fd)
    try:
        cmd = [cxx, *CXX_FLAGS, osp.join(_SRC_DIR, HOST_SOURCE), "-o",
               tmp_path]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp_path, path)         # atomic under races
    finally:
        if osp.exists(tmp_path):
            os.unlink(tmp_path)
    return path
