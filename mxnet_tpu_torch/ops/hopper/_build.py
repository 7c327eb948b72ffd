"""Build and load the port's CUDA kernels.

Each kernel source ``mxnet_tpu_torch/csrc/<name>.cu`` compiles with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. The build runs at first use, never on import, into
``build/mxnet_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, so an edited source rebuilds. A machine without ``nvcc`` gets a
clear error: nothing falls back to a plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from ...base import MXNetError

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "mxnet_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS = {}  # name -> ctypes.CDLL
BUILD_LOGS = {}  # name -> {"seconds", "path", "log"} of this process's builds


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises :class:`MXNetError` when there is
    none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels are built from "
        "mxnet_tpu_torch/csrc at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: the name carries a
    hash of the source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. Raises :class:`MXNetError` with the
    compiler's output when ``nvcc`` fails."""
    return build_many([name])[0]


def build_many(names) -> list:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` process each, all started together; returns their paths in
    order. Raises :class:`MXNetError` with the compiler's output if any
    ``nvcc`` fails (after every process has ended)."""
    outs = [library_path(n) for n in names]
    todo = [(n, o) for n, o in zip(names, outs) if not o.exists()]
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        BUILD_LOGS[name] = {"seconds": time.perf_counter() - t0,
                            "path": str(out), "log": log}
    if failed:
        raise MXNetError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib
