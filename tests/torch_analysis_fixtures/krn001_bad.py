"""Fixture: C entries reached around the int guard, and a return code
that never reaches the error check (KRN001)."""
import ctypes

from repro_torch.kernels import _build


def launch_raw(n, stream):
    lib = ctypes.CDLL("build/repro_torch/morton.so")    # BAD: no guard
    return lib.morton64_launch(None, None, None, n, 3, 21, None, None, stream)


def launch_unchecked(n, stream, args):
    fn = _build.function("morton", "morton64_launch", args)
    fn(None, None, None, n, 3, 21, None, None, stream)  # BAD: code dropped


def launch_library(n):
    return _build._library("morton").morton64_launch    # BAD: raw entry
