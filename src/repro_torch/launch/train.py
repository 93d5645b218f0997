"""End-to-end training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        [--device cpu]

Config -> init (``LM.from_config(cfg, seed)``, or the reference's
parameter tree passed as `init_params`) or auto-resume from the latest
committed checkpoint -> the train loop with straggler monitoring (the
device synchronised before each step's time is read) -> async
checkpoints in the reference's layout (``convert.lm_to_numpy`` /
``opt_to_numpy`` trees, so either package resumes the other's run).
Runs on the CUDA card unless ``--device`` says otherwise, and raises
without one. Prints the reference's lines and returns the last loss.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..convert import lm_from_numpy, lm_to_numpy, opt_from_numpy, opt_to_numpy
from ..core.index import resolve_device
from ..data import TokenPipeline
from ..models.lm import LM
from ..optim import adamw_init
from ..train import StragglerMonitor, make_train_step

__all__ = ["main"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, *, init_params: dict | None = None):
    """Train as the reference's ``main(argv)``; `init_params` (the
    reference's parameter tree, numpy) replaces ``LM.from_config``'s
    weights. Returns the last step's loss (None when no step ran)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs the mesh and sharding modules "
            "(the reference's launch/mesh.py, sharding.py and specs.py), "
            "which the port's next slice brings")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = (LM.from_config(cfg, seed=args.seed, device=device)
             if init_params is None
             else lm_from_numpy(cfg, init_params, device))
    opt = adamw_init(model)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        restored = mgr.restore()
        if restored is not None:
            start_step, tree, _ = restored
            model = lm_from_numpy(cfg, tree["params"], device)
            opt = opt_from_numpy(model, tree["opt"])
            print(f"resumed from step {start_step}")

    def state():
        return {"params": lm_to_numpy(model), "opt": opt_to_numpy(opt)}

    step_fn = make_train_step(cfg, lr=args.lr, total_steps=args.steps,
                              n_micro=args.n_micro)
    pipe = TokenPipeline(args.seed, args.batch, args.seq, cfg.vocab,
                         step=start_step, device=device)
    mon = StragglerMonitor()
    metrics = None
    t0 = time.time()
    for step in range(start_step, args.steps):
        mon.start()
        batch = pipe.next()
        metrics = step_fn(model, opt, batch)
        _sync(device)
        action = mon.stop(step)
        if action in ("checkpoint", "rebalance") and mgr:
            mgr.save(step, state())
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e}")
        if mgr and step and step % args.ckpt_every == 0:
            mgr.save(step, state())
    if mgr:
        mgr.save(args.steps, state())
        mgr.wait()
    dt = time.time() - t0
    tokens = (args.steps - start_step) * args.batch * args.seq
    print(f"done: {dt:.1f}s, {tokens / max(dt, 1e-9):.0f} tok/s, "
          f"straggler summary: {mon.summary()}")
    return None if metrics is None else float(metrics["loss"])


if __name__ == "__main__":
    main()
