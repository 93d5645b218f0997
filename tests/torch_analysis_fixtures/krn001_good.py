"""Fixture twin: the entry through the guard, its code through the
check (KRN001-clean)."""
from repro_torch.kernels import _build


def launch(n, stream, args, use_key):
    if use_key:
        fn = _build.function("morton", "morton_key_launch", args)
    else:
        fn = _build.function("morton", "morton64_launch", args)
    err = fn(None, None, None, n, 3, 21, None, None, stream)
    _build.check("morton", err, "morton64")
