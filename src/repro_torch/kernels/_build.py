"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface, and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). A build happens at
first use, into ``build/repro_torch/`` at the checkout root, under a
file name keyed by a hash of the sources and flags; a second process
finds the finished library and loads it. Every C entry point launches on
the stream it is given, allocates nothing and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an
exception.

The compiler's own contraction into FMA is off (``--fmad=false``) and
fast math is never on: the traversal kernels place their fused
multiply-adds explicitly, so their float32 distance tests reproduce the
reference's bit for bit.
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

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "function", "check",
           "build_log"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: one shared library per ``csrc/*.cu`` file, built in parallel
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA "
                           "kernels of repro_torch need the CUDA toolkit")
    return str(path)


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) of the
    current build of `name`, or "" when it was not built yet."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> float:
    """Compile every source of `names` that has no current library, all
    nvcc processes at once. Returns the wall seconds spent; raises with
    the compiler's output when one fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def _library(name: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(_library_path(name)))
        return lib


def function(lib: str, fn: str, argtypes):
    """The C entry point `fn` of library `lib`, typed: pointers and the
    stream are ``ctypes.c_void_p``, sizes ``ctypes.c_int``; every entry
    point returns a ``cudaError_t`` as int."""
    key = (lib, fn)
    f = _FUNCS.get(key)
    if f is None:
        f = getattr(_library(lib), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _FUNCS[key] = f
    return f


def check(lib: str, err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        name = getattr(_library(lib), "repro_error_string")
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({name(err).decode()})")
