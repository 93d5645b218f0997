"""Checkpointing: save / restore, async writer, retention, auto-resume
(the port of ``repro.checkpoint.manager``), in the reference's format,
so that each package restores the other's checkpoints.

Format: one directory per step holding

    manifest.json  step, the sorted leaf keys, ``extra``, and ``dtypes``
                   (this port's: the leaves it wrote as float32 that were
                   bfloat16)
    arrays.npz     one entry per leaf, keyed by its tree path joined by |
    COMMITTED      written last: a directory without it is ignored

The trees are nested dicts of numpy arrays or tensors (``convert``'s
``lm_to_numpy`` / ``opt_to_numpy`` give the reference's layout).

One departure from the reference: its ``np.savez`` of a bfloat16 leaf
writes raw 2-byte voids (``|V2``), which it cannot cast back on restore.
Here a bfloat16 leaf is written as float32, which holds it exactly, its
dtype noted in the manifest, and cast back on restore; a ``|V2`` entry
of a reference checkpoint is read as bfloat16 bits.

The async writer snapshots the leaves to host memory synchronously, so
the step's values are frozen, then writes on a worker thread; ``wait()``
drains the queue and raises the first write error.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint"]

_SEP = "|"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat):
    tree = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _snapshot(tree):
    """(flat {key: numpy copy} with bfloat16 leaves as float32, the keys
    of those leaves). Copies: no later in-place update reaches them."""
    flat, bf16 = {}, []
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if isinstance(v, DTensor):
                v = v.full_tensor()     # a collective: every rank saves
            if v.dtype == torch.bfloat16:
                bf16.append(k)
                v = v.float()
            v = v.to("cpu", copy=True).numpy()
        else:
            v = np.array(v)
            if v.dtype.name == "bfloat16":
                bf16.append(k)
                v = v.astype(np.float32)
        flat[k] = v
    return flat, bf16


def _write(path, step, flat, bf16, extra):
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    manifest = {"step": step, "keys": sorted(flat), "extra": extra or {},
                "dtypes": {k: "bfloat16" for k in sorted(bf16)}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(path, "COMMITTED"), "w") as f:
        f.write(str(step))


def save_checkpoint(path: str, step: int, tree, *, extra: dict | None = None):
    """Synchronous save of a tree of arrays or tensors."""
    _write(path, step, *_snapshot(tree), extra)


def _bf16_bits(a: np.ndarray) -> torch.Tensor:
    """A ``|V2`` array of bfloat16 bits as a bfloat16 tensor."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def load_checkpoint(path: str, device=None):
    """(step, tree, extra). The port's counterpart of the reference's
    ``shardings=``: with `device` None the leaves are numpy arrays on the
    host (bfloat16 leaves as float32); with a device they are tensors
    there, bfloat16 leaves (this port's, or a reference checkpoint's
    ``|V2`` entries) as bfloat16."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    bf16 = manifest.get("dtypes", {})
    flat = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k in manifest["keys"]:
            a = data[k]
            t = _bf16_bits(a) if a.dtype.kind == "V" else None
            if device is None:
                flat[k] = a if t is None else t.float().numpy()
                continue
            t = torch.from_numpy(a) if t is None else t
            if bf16.get(k) == "bfloat16":
                t = t.to(torch.bfloat16)
            flat[k] = t.to(device)
    return manifest["step"], _unflatten(flat), manifest.get("extra", {})


class CheckpointManager:
    """Retention + async writes + auto-resume.

    directory/
      step_000100/ ...
      step_000200/ ...
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._async = async_write
        self._error: BaseException | None = None
        self._worker = None
        if async_write:
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # -- writes -----------------------------------------------------------
    def save(self, step: int, tree, *, extra=None):
        """Snapshot `tree` to host memory now (later updates of the
        tensors in place do not reach the checkpoint), then write it, on
        the worker thread when async."""
        snap = _snapshot(tree)
        if self._async:
            self._q.put((step, snap, extra))
        else:
            self._write(step, snap, extra)

    def _drain(self):
        while True:
            step, snap, extra = self._q.get()
            try:
                if self._error is None:
                    self._write(step, snap, extra)
            except BaseException as e:    # raised again by wait()
                self._error = e
            finally:
                self._q.task_done()

    def _write(self, step, snap, extra):
        path = self._path(step)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        _write(tmp, step, *snap, extra)
        if not os.path.exists(path):
            os.replace(tmp, path)
        self._retain()

    def wait(self):
        """Block until every queued write is on disk; raise the first
        write error."""
        if self._async:
            self._q.join()
        if self._error is not None:
            raise self._error

    # -- reads ------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.directory, d,
                                                    "COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, step: int | None = None, *, device=None):
        """Load `step` (default the latest). Returns (step, tree, extra),
        or None when no committed checkpoint exists (a fresh start)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        return load_checkpoint(self._path(step), device=device)

    # -- internals --------------------------------------------------------
    def _path(self, step):
        return os.path.join(self.directory, f"step_{step:06d}")

    def _retain(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._path(s), ignore_errors=True)
