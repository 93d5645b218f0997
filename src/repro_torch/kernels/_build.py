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

ctypes converts a Python int to a ``c_int`` argument without a range
check: 2^31 + 5 arrives as -2147483643 and 2^40 as 0, so a size past
int32 would launch a kernel on a wrong size and raise nothing. The entry
points :func:`function` returns are guarded: every integer argument is
checked against the range of its ctypes type first, and one outside it
raises OverflowError, naming the entry and the argument, before any
launch. ``python -m repro_torch.analysis`` (KRN001) checks that every C
entry is reached through :func:`function` and its code through
:func:`check`.

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
           "build_log", "Entry", "entries"]

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


_INT_TYPES = (ctypes.c_int, ctypes.c_uint, ctypes.c_long, ctypes.c_ulong,
              ctypes.c_longlong, ctypes.c_ulonglong, ctypes.c_short,
              ctypes.c_ushort, ctypes.c_int8, ctypes.c_uint8, ctypes.c_int16,
              ctypes.c_uint16, ctypes.c_int32, ctypes.c_uint32,
              ctypes.c_int64, ctypes.c_uint64, ctypes.c_size_t,
              ctypes.c_ssize_t)


def _int_range(ctype):
    """(lowest, highest) int a ctypes integer type passes unchanged, or
    None for a type that is not an integer (pointers, floats)."""
    if ctype not in _INT_TYPES:
        return None
    bits = 8 * ctypes.sizeof(ctype)
    if ctype(-1).value == -1:
        return -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return 0, (1 << bits) - 1


class Entry:
    """A C entry point behind the int guard: calling it checks every
    integer argument (the sizes; not the pointers) against the range of
    its ctypes type and raises OverflowError, naming the entry and the
    argument, before any launch; then it calls `raw`. ``calls`` counts
    the calls that passed."""

    def __init__(self, lib: str, name: str, raw, argtypes):
        self.lib, self.name, self.raw = lib, name, raw
        self.argtypes = list(argtypes)
        #: (position, lowest, highest) of each integer argument
        self.int_args = [(i, *r) for i, r in
                         enumerate(map(_int_range, self.argtypes))
                         if r is not None]
        self.calls = 0

    def check_args(self, args):
        """Raise OverflowError on the first integer argument outside its
        type's range (TypeError on a wrong argument count). A value that
        is not a number is left to ctypes, which refuses it."""
        if len(args) != len(self.argtypes):
            raise TypeError(f"{self.lib}.{self.name} takes "
                            f"{len(self.argtypes)} arguments, got {len(args)}")
        for i, lo, hi in self.int_args:
            a = args[i]
            try:
                ok = lo <= a <= hi
            except TypeError:
                continue
            if not ok:
                raise OverflowError(
                    f"{self.lib}.{self.name}: argument {i} "
                    f"({self.argtypes[i].__name__}) is {int(a)}, outside "
                    f"[{lo}, {hi}]; not launched")

    def __call__(self, *args):
        self.check_args(args)
        self.calls += 1
        return self.raw(*args)


def function(lib: str, fn: str, argtypes) -> Entry:
    """The C entry point `fn` of library `lib`, typed and guarded
    (:class:`Entry`): pointers and the stream are ``ctypes.c_void_p``,
    sizes ``ctypes.c_int``; every entry point returns a ``cudaError_t``
    as int."""
    key = (lib, fn)
    f = _FUNCS.get(key)
    if f is None:
        raw = getattr(_library(lib), fn)
        raw.argtypes = list(argtypes)
        raw.restype = ctypes.c_int
        f = _FUNCS[key] = Entry(lib, fn, raw, argtypes)
    return f


def entries() -> dict:
    """{(lib, fn): Entry} of every entry point loaded in this process."""
    return dict(_FUNCS)


def check(lib: str, err: int, what: str) -> None:
    """Raise when a launch reported a CUDA error."""
    if err != 0:
        name = getattr(_library(lib), "repro_error_string")
        name.restype = ctypes.c_char_p
        name.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({name(err).decode()})")
