"""Build and load the port's CUDA kernels.

Each kernel source ``mxnet_tpu_torch/csrc/<name>.cu`` compiles with
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
loaded with ``ctypes``. The build runs at first use, never on import, into
``build/mxnet_tpu_torch/`` at the root of the checkout (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, so an edited source rebuilds. A source may be built more than once
with different ``-D`` defines (a *variant*: the flash-attention kernels
build one library per dtype pair), each variant its own library and its
own ``nvcc`` process. A machine without ``nvcc`` gets a clear error:
nothing falls back to a plain version.
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
_LIBS = {}  # variant key -> ctypes.CDLL
BUILD_LOGS = {}  # variant key -> {"seconds", "path", "log"} of this process's builds


def variant_key(name: str, defines=()) -> str:
    """``name``, or ``name[D1,D2]`` for a build with ``-D`` defines."""
    return f"{name}[{','.join(defines)}]" if defines else name


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


def library_path(name: str, defines=()) -> Path:
    """Where the library of ``csrc/<name>.cu`` (built with ``-D`` each of
    ``defines``) goes: the name carries a hash of the source, the flags and
    the defines."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, defines=()) -> Path:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its library is
    already built; returns the library's path. Raises :class:`MXNetError`
    with the compiler's output when ``nvcc`` fails."""
    return build_many([(name, defines)])[0]


def build_many(specs) -> list:
    """Compile the libraries of ``specs`` (``(name, defines)`` pairs) that
    are not built yet, one ``nvcc`` process each, all started together;
    returns their paths in order. Raises :class:`MXNetError` with the
    compiler's output if any ``nvcc`` fails (after every process has
    ended)."""
    specs = [(name, tuple(defines)) for name, defines in specs]
    outs = [library_path(n, d) for n, d in specs]
    todo = [(n, d, o) for (n, d), o in zip(specs, outs) if not o.exists()]
    if not todo:
        return outs
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, defines, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((variant_key(name, defines), out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for key, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {key} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        BUILD_LOGS[key] = {"seconds": time.perf_counter() - t0,
                           "path": str(out), "log": log}
    if failed:
        raise MXNetError("\n".join(failed))
    return outs


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``,
    built on first use."""
    key = variant_key(name, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, tuple(defines))))
            _LIBS[key] = lib
        return lib
