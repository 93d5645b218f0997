"""Multi-pod dry-run: run every (architecture x input shape) cell once
against the production meshes on the meta device and derive the
roofline terms per device: the port of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
        --shape train_4k [--multi-pod | --both-meshes] [--out experiments/dryrun]

Where the reference lowers and compiles under ``XLA_FLAGS`` with 512 fake
host devices, the port joins a fake ``torch.distributed`` world of 256
(or 512) ranks in one process (the ``"fake"`` backend of
``torch.testing._internal.distributed.fake_pg``, a private testing API:
its collectives return at once and move nothing), builds the production
mesh over it, and runs the step as rank 0 on meta tensors: the
parameters, optimizer state, cache and batch are DTensors at the
reference's specs whose local shards allocate nothing. ``opanalysis``
counts the run. Per cell it records:

  arg_bytes / out_bytes  the local shards' bytes of the step's arguments
                         (parameters, optimizer state or cache, batch) and
                         of what it returns (the port updates the
                         parameters, moments and cache in place, where the
                         reference returns new ones)
  temp_bytes             the high-water mark of live local tensors during
                         the step, as the dispatch mode tracks them: not
                         the allocator's figure
  flops / bytes          per device, from the local ops (``opanalysis``)
  collectives            bytes by kind, from the redistributions' ops

H100 SXM constants for the roofline terms: 989e12 FLOP/s dense bf16,
3.35e12 B/s HBM, and one link constant, NVLink 4 at 450e9 B/s a
direction. An axis that crosses nodes (the 16-wide "model" axis on
8-GPU nodes, and "pod") runs at InfiniBand NDR's 50e9 B/s a GPU, so
there ``t_collective`` is a lower bound. The numbers are predictions for
a card, counted on the host; none is a measurement.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch
import torch.distributed as dist

from ..configs import all_archs, get_config
from ..models.layers import set_sharding_rules
from . import sharding as SH
from .mesh import make_production_mesh
from .opanalysis import analyze
from .specs import (SHAPES, build_step, cache_struct, cell_applicable,
                    input_specs, opt_struct, params_struct)

__all__ = ["run_cell", "main", "fake_world", "local_bytes", "TRAIN_KNOBS",
           "PEAK_FLOPS", "HBM_BW", "LINK_BW"]

# H100 SXM (target hardware) constants
PEAK_FLOPS = 989e12          # dense bf16 / GPU
HBM_BW = 3.35e12             # bytes/s / GPU
LINK_BW = 450e9              # bytes/s / GPU, NVLink 4, one direction

# per-arch training knobs that make the big models fit (DESIGN.md §5)
TRAIN_KNOBS = {
    "deepseek-v3-671b": dict(n_micro=16, opt_dtype=torch.bfloat16,
                             fsdp=True, accum_dtype=torch.bfloat16,
                             moe_impl="gather"),
    "mixtral-8x22b": dict(n_micro=8, opt_dtype=torch.bfloat16, fsdp=True,
                          accum_dtype=torch.bfloat16, moe_impl="gather"),
    "llava-next-mistral-7b": dict(n_micro=4, opt_dtype=torch.float32,
                                  fsdp=True),
    "starcoder2-7b": dict(n_micro=4, opt_dtype=torch.float32, fsdp=True),
    "chatglm3-6b": dict(n_micro=4, opt_dtype=torch.float32, fsdp=True),
    "zamba2-7b": dict(n_micro=8, opt_dtype=torch.float32, fsdp=True),
    "phi3-mini-3.8b": dict(n_micro=4, opt_dtype=torch.float32, fsdp=True),
    "tinyllama-1.1b": dict(n_micro=2, opt_dtype=torch.float32, fsdp=True),
    "seamless-m4t-medium": dict(n_micro=2, opt_dtype=torch.float32,
                                fsdp=True),
    "mamba2-780m": dict(n_micro=4, opt_dtype=torch.float32, fsdp=True),
}
DEFAULT_KNOBS = dict(n_micro=1, opt_dtype=torch.float32, fsdp=False)
for _k in TRAIN_KNOBS.values():
    _k.setdefault("accum_dtype", torch.float32)

TEMP_NOTE = ("temp_bytes: high-water mark of live local tensors during the "
             "step as the dispatch mode tracks them; not the allocator's "
             "figure")


def fake_world(world: int):
    """Join a fake process group of `world` ranks as rank 0 (replacing any
    fake group of another size; a real group is left alone and must be
    that size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} world of "
                               f"{dist.get_world_size()} ranks is running; "
                               f"the dry-run needs a fake one of {world}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def local_bytes(tree) -> int:
    """The bytes of the local shards (or tensors) of a module, a tensor or
    a nested dict of them: what one rank holds."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, torch.nn.Module):
        return sum(local_bytes(p) for p in tree.parameters())
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def setup_cell(cfg, shape: str, mesh, knobs: dict):
    """(step, args, mode) of the cell on `mesh`, every argument a meta
    DTensor at the reference's specs."""
    cell = SHAPES[shape]
    model = params_struct(cfg)
    pspecs = SH.param_specs(model, mesh,
                            expert_2d=bool(knobs.get("expert_2d")))
    if knobs["fsdp"]:
        pspecs = SH.zero1_specs(pspecs, model, mesh)
    SH.distribute_model(model, mesh, pspecs)
    batch = input_specs(cfg, shape)
    bspec = {k: SH.batch_spec(mesh, v.shape[0]) for k, v in batch.items()}
    batch = SH.distribute_tree(batch, mesh, bspec)
    if cell.mode == "train":
        ospecs = SH.zero1_specs(pspecs, model, mesh)
        opt = opt_struct(cfg, model, knobs["opt_dtype"], mesh=mesh,
                         specs=ospecs)
        step = build_step(cfg, "train", n_micro=knobs["n_micro"],
                          opt_dtype=knobs["opt_dtype"],
                          accum_dtype=knobs.get("accum_dtype",
                                                torch.float32))
        return step, (model, opt, batch), cell.mode
    if cell.mode == "prefill":
        return build_step(cfg, "prefill"), (model, batch), cell.mode
    cache = cache_struct(cfg, shape)
    cspecs = SH.cache_specs(cfg, cache, mesh, cell.global_batch)
    cache = SH.distribute_tree(cache, mesh, cspecs)
    return build_step(cfg, "decode"), (model, cache, batch), cell.mode


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True, knobs_override: dict | None = None):
    cfg = get_config(arch)
    knobs = dict(TRAIN_KNOBS.get(arch, DEFAULT_KNOBS))
    if knobs_override:
        knobs.update(knobs_override)
    # knob entries naming ModelConfig fields override the config
    cfg_fields = {f.name for f in dataclasses.fields(cfg)}
    cfg_over = {k: v for k, v in knobs.items() if k in cfg_fields}
    if cfg_over:
        cfg = dataclasses.replace(cfg, **cfg_over)
    ok, reason = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec

    chips = 512 if multi_pod else 256
    mesh = None
    try:
        t0 = time.time()
        fake_world(chips)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        set_sharding_rules(SH.logical_rules(mesh), mesh)
        step, args, mode = setup_cell(cfg, shape, mesh, knobs)
        arg_bytes = local_bytes(dict(enumerate(args)))
        ana = analyze(step, *args)
        t1 = time.time()
        rec.update(
            status="ok", compile_s=round(t1 - t0, 1), chips=chips, mode=mode,
            arg_bytes=int(arg_bytes), out_bytes=int(ana["out_bytes"]),
            temp_bytes=int(ana["temp_bytes"]),
            peak_bytes=int(ana["temp_bytes"]) + int(arg_bytes),
            flops_per_device=float(ana["flops"]),
            hlo_bytes_per_device=float(ana["hbm_bytes"]),
            # no compiled module: XLA's visit-the-loop-body-once figures
            # have no counterpart
            xla_flops_body_once=None, xla_bytes_body_once=None,
            collective_bytes=ana["collectives"],
            collective_total=float(ana["collective_bytes"]),
            top_collectives=[list(t) for t in ana["top_collectives"]],
            top_hbm=[list(t) for t in ana["top_hbm"]],
            knobs={k: str(v) for k, v in knobs.items()},
            note=TEMP_NOTE)
        rec["t_compute"] = rec["flops_per_device"] / PEAK_FLOPS
        rec["t_memory"] = rec["hlo_bytes_per_device"] / HBM_BW
        rec["t_collective"] = rec["collective_total"] / LINK_BW
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        if verbose:
            print(f"[{arch} / {shape} / {rec['mesh']}] OK "
                  f"run={rec['compile_s']}s peak/dev="
                  f"{rec['peak_bytes'] / 2**30:.2f}GiB "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bottleneck={rec['bottleneck']}")
            print("  memory:", {k: rec[k] for k in
                                ("arg_bytes", "out_bytes", "temp_bytes")})
            print("  cost: flops=%.3e bytes=%.3e" %
                  (rec["flops_per_device"], rec["hlo_bytes_per_device"]))
            print("  collectives:", {k: f"{v / 2**20:.1f}MiB"
                                     for k, v in ana["collectives"].items()})
    except Exception as e:  # noqa: BLE001 - record failures, keep sweeping
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        if verbose:
            print(f"[{arch} / {shape} / {rec['mesh']}] FAILED: "
                  f"{rec['error']}")
    finally:
        set_sharding_rules(None)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = all_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, multi_pod=mp)
                tag = f"{arch}__{shape}__{'mp' if mp else 'sp'}.json"
                with open(os.path.join(args.out, tag), "w") as f:
                    json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
