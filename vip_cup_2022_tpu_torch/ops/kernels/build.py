"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``<package>/_build/lib<name>-<hash>.so`` at first use and loaded with
``ctypes``. The file name carries a hash of the source, of the shared
headers (``csrc/*.cuh``) and of the flags, so an edited source builds anew
and a finished build is reused by later processes. :func:`build_all` runs
one ``nvcc`` per source, all at once.
Nothing here runs at import time: the CPU tests import every module and this
host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Sequence

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append(DEFAULT_NVCC)
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use")


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC_DIR, f"{name}.cu"),
                 *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str, verbose: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.
    ``verbose`` adds ``-Xptxas -v`` to a compile and prints the compiler's
    report (registers, shared memory and spills per kernel)."""
    out = library_path(name)
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    if verbose:
        print(f"[build] {name}: nvcc {time.perf_counter() - t0:.1f} s -> {out}")
        print(proc.stdout + proc.stderr)
    return out


def build_all(names: Sequence[str], verbose: bool = False) -> Dict[str, str]:
    """:func:`build` every source in ``names`` concurrently, one nvcc each."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        paths = list(pool.map(lambda n: build(n, verbose), names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name))
        return _LIBS[name]
