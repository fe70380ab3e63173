"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>.so`` beside the package at first use,
and loaded with ``ctypes``. A library is rebuilt when its source is newer
than the built file. Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build")
SOURCES = ("wkv7", "wkv7_train", "attention")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

# Launches of each kernel: a wrapper adds one where it launches its kernel.
LAUNCHES: collections.Counter = collections.Counter()


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cands.append(os.path.join(home, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of visualrwkv_torch are built from csrc/ at first use"
    )


def _paths(name: str):
    return os.path.join(CSRC_DIR, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _start(name: str, nvcc: str):
    src, lib = _paths(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, proc, tmp: str, lib: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return out


def build(names: Optional[Iterable[str]] = None, force: bool = False) -> Dict[str, str]:
    """Compile the given kernel sources (default: all) with one ``nvcc`` per
    source, all started together. Returns ``{name: compiler output}`` for
    the sources that were compiled (``-Xptxas -v``: registers, spills)."""
    names = tuple(SOURCES if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    nvcc = find_nvcc()
    started = [(n, *_start(n, nvcc)) for n in todo]
    return {n: _finish(n, proc, tmp, lib) for n, proc, tmp, lib in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths(name)[1])
        lib.vrwkv_error_string.argtypes = [ctypes.c_int]
        lib.vrwkv_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.vrwkv_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

