"""Batched serving driver: prefill a batch of prompts, then decode
greedily with a shared cache, the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --smoke --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Weights come from ``LM.from_config(cfg, seed)``, prompts from a
``torch.Generator`` seeded with ``seed`` on the target device, and for
encdec the frame embeddings (16 frames) from the same generator. It runs
on the CUDA card unless ``--device`` says otherwise, and raises without
one. Prints the generated shape and the prefill seconds and decode
milliseconds per token (host clock, the device synchronised at each
end), and returns the generated tokens as a (batch, gen) numpy array.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from ..configs import get_config
from ..core.index import resolve_device
from ..models import serve
from ..models.lm import LM

__all__ = ["Generation", "generate", "main"]

#: frames of the encdec family's stub encoder input (the reference's 16)
ENC_FRAMES = 16


class Generation(NamedTuple):
    tokens: torch.Tensor          # (B, gen) int64 on the model's device
    cache: dict
    prefill_s: float
    decode_s: float               # the gen - 1 steps after the prefill


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model, cache: dict, prompts, gen: int) -> Generation:
    """The reference's greedy loop: prefill the (B, S) `prompts`, take the
    argmax of the last logits, then `gen` - 1 decode steps, each feeding
    back its argmax. Tokens stay on the device throughout; the clock reads
    after a device sync at the end of the prefill and of the decode."""
    dev = model.device
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = serve.prefill(model, cache, prompts)
    _sync(dev)
    t1 = time.perf_counter()
    tok = logits[:, -1:].argmax(-1)
    out = [tok]
    for _ in range(gen - 1):
        lg, cache = serve.decode_step(model, cache, tok)
        tok = lg[:, -1:].argmax(-1)
        out.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), cache, t1 - t0, t2 - t1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    model = LM.from_config(cfg, seed=args.seed, device=dev)
    dtype = getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    cache = serve.init_cache(cfg, args.batch, args.prompt_len + args.gen,
                             dtype=dtype, device=dev)
    with torch.inference_mode():
        if cfg.family == "encdec":
            src = torch.randn((args.batch, ENC_FRAMES, cfg.d_model),
                              generator=gen, device=dev).to(dtype)
            cache = serve.prefill_encoder(model, cache, src)
        out = generate(model, cache, prompts, args.gen)

    print("generated shape:", tuple(out.tokens.shape))
    print(f"prefill: {out.prefill_s:.2f}s  decode: "
          f"{out.decode_s / max(args.gen - 1, 1) * 1e3:.1f} ms/token  "
          f"({args.batch} seqs)")
    return out.tokens.cpu().numpy()


if __name__ == "__main__":
    main()
