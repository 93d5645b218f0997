#!/usr/bin/env python3
"""Time design variants of the tensor-core flash-attention kernel on one
CUDA card, in turns, beside scaled_dot_product_attention.

    python3 scripts/flash_variants.py        # from the checkout root

Each variant is a text edit of the committed
``src/repro_torch/csrc/flash_attention.cu``, built with the port's nvcc
flags into ``build/flash_variants/`` and called through its C entry
point:

  committed      the source as it is
  exp2f          the library's exp2f in place of ex2.approx
  two_consumers  two consumer warpgroups of 240 registers at DH = 64
                 (128-row blocks) in place of three of 160
  three_stages   a K/V ring of three stages in place of two
  no_setmaxnreg  no register moves between producer and consumers
  setmaxnreg_128 the moves at DH = 128 too (consumers of 240)

Each variant is first held against the twin on ragged and windowed
shapes at the bound of ``chip_smoke.py`` (2e-5 + two steps of the
output type + u ref(q, k, |v|)), then timed by CUDA events at four
bf16 causal shapes: the TinyLlama layer (B = 4, Hq = 32, Hkv = 4,
S = 2048, D = 64), S = 8192, D = 128 with Hkv = 8, and zamba2-7b's
shared block (B = 1, 32 heads, S = 1024, D = 112). The variants run in
one order and then in the reverse one; each line gives both times.
Needs one card; exits nonzero without one.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SHAPES = ((4, 32, 4, 2048, 64), (4, 32, 4, 8192, 64), (4, 32, 8, 2048, 128),
          (1, 32, 32, 1024, 112))
CHECKS = ((1, 4, 4, 100, 100, 64, True, None), (1, 4, 2, 300, 300, 64, True, 100),
          (1, 4, 2, 192, 64, 64, True, None), (1, 8, 2, 700, 700, 80, True, 256),
          (1, 8, 2, 500, 500, 8, False, None), (2, 4, 2, 77, 77, 16, True, 10))


def _edit(src, old, new):
    if old not in src:
        raise SystemExit(f"flash_variants: the source no longer holds {old!r}")
    return src.replace(old, new)


def variants(src):
    return {
        "committed": src,
        "exp2f": _edit(src, "asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) : \"f\"(x));",
                       "y = exp2f(x);"),
        "two_consumers": _edit(_edit(src, "kConsumers = DH == 64 ? 3 : 2;",
                                     "kConsumers = 2;"),
                               "kConsumerRegs = 160;", "kConsumerRegs = 240;"),
        "three_stages": _edit(src, "constexpr int kStages = 2;",
                              "constexpr int kStages = 3;"),
        "no_setmaxnreg": _edit(src, "kMoveRegs = DH == 64;",
                               "kMoveRegs = false;"),
        "setmaxnreg_128": _edit(_edit(src, "kMoveRegs = DH == 64;",
                                      "kMoveRegs = true;"),
                                "kConsumerRegs = 160;",
                                "kConsumerRegs = DH == 64 ? 160 : 240;"),
    }


def build(names_sources):
    """{name: (ctypes function, spill-store bytes per tensor-core instance)}"""
    from repro_torch.kernels import _build
    out = os.path.join(ROOT, "build", "flash_variants")
    os.makedirs(out, exist_ok=True)
    for header in ("common.cuh", "hopper.cuh"):
        shutil.copy(os.path.join(_build.CSRC, header), out)
    procs = {}
    for name, text in names_sources.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               os.path.join(out, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"flash_variants: {name} failed to build:\n{log}")
        spills = re.findall(r"flash_kernel_tcI13__nv_bfloat16Li(\d+)E\S* for "
                            r"'sm_90a'\n.*\n\s*\d+ bytes stack frame, (\d+) "
                            r"bytes spill stores", log)
        fn = ctypes.CDLL(os.path.join(out, f"{name}.so")).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        built[name] = (fn, {f"DH {d}": int(b) for d, b in spills})
    return built


def main():
    import torch
    from repro_torch.kernels import flash_attention as KF
    if not torch.cuda.is_available():
        raise SystemExit("flash_variants: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        torch.cuda.get_device_name(0)
    print(card, flush=True)
    from repro_torch.kernels import _build
    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        built = build(variants(f.read()))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def qkv(b, hq, hkv, sq, skv, d, dtype):
        return tuple(torch.randn(s, generator=gen, device=dev).to(dtype)
                     for s in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))

    def launch(fn, q, k, v, out, causal=True, window=None):
        b, hq, sq, d = q.shape
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 1 if q.dtype == torch.bfloat16 else 2, b, hq, k.shape[1], sq,
                 k.shape[2], d, int(causal), window or 0, float(d ** -0.5),
                 stream)
        if err:
            raise SystemExit(f"flash_variants: launch returned {err}")

    def time_ms(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    worst = {name: 0.0 for name in built}
    for i, (b, hq, hkv, sq, skv, d, causal, window) in enumerate(CHECKS):
        dtype = torch.bfloat16 if i % 2 == 0 else torch.float16
        u, step = ((2.0 ** -8, 2.0 ** -7) if dtype == torch.bfloat16
                   else (2.0 ** -11, 2.0 ** -10))
        q, k, v = qkv(b, hq, hkv, sq, skv, d, dtype)
        want = KF.flash_attention_ref(q, k, v, causal=causal,
                                      window=window).float()
        tol = (2e-5 + 2 * step * want.abs() + u * KF.flash_attention_ref(
            q.float(), k.float(), v.float().abs(), causal=causal,
            window=window))
        for name, (fn, _) in built.items():
            out = torch.empty_like(q)
            launch(fn, q, k, v, out, causal, window)
            torch.cuda.synchronize()
            ratio = float(((out.float() - want).abs() / tol).max())
            if not ratio <= 1.0:
                raise SystemExit(f"flash_variants: {name} is outside the "
                                 f"tolerance on {(b, hq, hkv, sq, skv, d)}")
            worst[name] = max(worst[name], ratio)
    print(json.dumps({"spill_stores": {n: s for n, (_, s) in built.items()},
                      "worst_share_of_tolerance": worst}), flush=True)
    order = list(built) + list(reversed(list(built)))
    for b, hq, hkv, s, d in SHAPES:
        q, k, v = qkv(b, hq, hkv, s, s, d, torch.bfloat16)
        out = torch.empty_like(q)
        ms = {}
        for name in order:
            fn = built[name][0]
            ms.setdefault(name, []).append(
                round(time_ms(lambda: launch(fn, q, k, v, out)), 4))
        sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        print(json.dumps({"shape": [b, hq, hkv, s, d], "ms": ms,
                          "sdpa_ms": round(sdpa, 4), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
