"""End-to-end training driver, the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        [--device cpu] [--model-parallel 2]

Config -> init (``LM.from_config(cfg, seed)``, or the reference's
parameter tree passed as `init_params`) or auto-resume from the latest
committed checkpoint -> the train loop with straggler monitoring (the
device synchronised before each step's time is read) -> async
checkpoints in the reference's layout (``convert.lm_to_numpy`` /
``opt_to_numpy`` trees, so either package resumes the other's run).
Runs on the CUDA card unless ``--device`` says otherwise, and raises
without one. Prints the reference's lines and returns the last loss.

In a ``torch.distributed`` world (each rank a process that has called
``init_process_group``, or that ``torchrun`` started: it then joins
its world, NCCL on the card, gloo on the CPU) or with
``--model-parallel k > 1``, it trains on
``launch.mesh.make_host_mesh(k)``: the sharding rules installed, the
model at ``launch.sharding.param_specs``' placements, the AdamW moments
at ``zero1_specs``' (ZeRO-1), each batch row-sharded over "data" when
``batch_spec`` says so. Every rank runs the same loop and takes part in
every collective (the printed loss and every checkpoint gather on all of
them); rank 0 alone prints and writes the checkpoints, which keep the
reference's full layout, so a sharded run resumes an unsharded one and
the other way round.
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..convert import lm_from_numpy, lm_to_numpy, opt_from_numpy, opt_to_numpy
from ..core.index import resolve_device
from ..data import TokenPipeline
from ..models.layers import set_sharding_rules
from ..models.lm import LM
from ..optim import adamw_init
from ..train import StragglerMonitor, make_train_step
from . import sharding as SH
from .mesh import make_host_mesh

__all__ = ["main"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _value(t) -> float:
    """A 0-d metric as a float; a DTensor's is gathered (a collective)."""
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def _join_world(device) -> bool:
    """Join the world a launcher describes (``torchrun`` sets WORLD_SIZE,
    RANK, MASTER_ADDR and MASTER_PORT) when there is one and no process
    group yet: NCCL on the card, gloo on the CPU. Returns whether it did."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return True


def _agreed(flag: bool, mesh, device) -> bool:
    """`flag` on any rank of the mesh's world (itself off a mesh): a
    straggler seen by one rank saves on all of them, since a save gathers
    the shards."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


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

    device = resolve_device(args.device)
    joined = _join_world(device)
    if joined and device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    mesh = None
    if args.model_parallel > 1 or (dist.is_initialized()
                                   and dist.get_world_size() > 1):
        mesh = make_host_mesh(args.model_parallel, device.type)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    cfg = get_config(args.arch, smoke=args.smoke)
    model = (LM.from_config(cfg, seed=args.seed, device=device)
             if init_params is None
             else lm_from_numpy(cfg, init_params, device))
    pspecs = ospecs = None
    if mesh is not None:
        set_sharding_rules(SH.logical_rules(mesh), mesh)
        pspecs = SH.param_specs(model, mesh)
        ospecs = SH.zero1_specs(pspecs, model, mesh)
        SH.distribute_model(model, mesh, pspecs)
    opt = adamw_init(model, mesh=mesh, specs=ospecs)
    start_step = 0
    mgr = None
    try:
        if args.ckpt_dir:
            mgr = CheckpointManager(args.ckpt_dir, keep=3)
            restored = mgr.restore()
            if restored is not None:
                start_step, tree, _ = restored
                model = lm_from_numpy(cfg, tree["params"], device, mesh=mesh,
                                      specs=pspecs)
                opt = opt_from_numpy(model, tree["opt"], mesh=mesh,
                                     specs=ospecs)
                if lead:
                    print(f"resumed from step {start_step}")

        def save(step):
            state = {"params": lm_to_numpy(model), "opt": opt_to_numpy(opt)}
            if lead:
                mgr.save(step, state)

        step_fn = make_train_step(cfg, lr=args.lr, total_steps=args.steps,
                                  n_micro=args.n_micro)
        pipe = TokenPipeline(args.seed, args.batch, args.seq, cfg.vocab,
                             step=start_step, device=device)
        bspec = None if mesh is None else SH.batch_spec(mesh, args.batch)
        mon = StragglerMonitor()
        metrics = None
        t0 = time.time()
        for step in range(start_step, args.steps):
            mon.start()
            batch = pipe.next()
            if mesh is not None:
                batch = {k: SH.to_dtensor(v, mesh, bspec)
                         for k, v in batch.items()}
            metrics = step_fn(model, opt, batch)
            _sync(device)
            action = mon.stop(step)
            if _agreed(action in ("checkpoint", "rebalance"), mesh, device) \
                    and mgr:
                save(step)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = _value(metrics["loss"])
                if lead:
                    print(f"step {step:5d} loss={loss:.4f} "
                          f"gnorm={_value(metrics['grad_norm']):.3f} "
                          f"lr={_value(metrics['lr']):.2e}")
            if mgr and step and step % args.ckpt_every == 0:
                save(step)
        if mgr:
            save(args.steps)
            mgr.wait()
        dt = time.time() - t0
        tokens = (args.steps - start_step) * args.batch * args.seq
        if lead:
            print(f"done: {dt:.1f}s, {tokens / max(dt, 1e-9):.0f} tok/s, "
                  f"straggler summary: {mon.summary()}")
        return None if metrics is None else _value(metrics["loss"])
    finally:
        if mesh is not None:
            set_sharding_rules(None)
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
