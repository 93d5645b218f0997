"""Data pipelines: deterministic, resumable, shardable (the port of
``repro.data.pipeline``).

Token stream: numpy's counter-based generator keyed on (seed, step), as
the reference's: any step's batch is reproducible without replaying the
stream, which makes checkpoint-resume exact and lets every host make its
own shard. The numbers are the reference's, bit for bit; the batches are
int64 tensors on the pipeline's device (the CUDA card unless the caller
passes one).

Point clouds: generators for the geometric benchmarks (uniform, gaussian
blobs, cosmology-like filaments), numpy as the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.index import resolve_device

__all__ = ["TokenPipeline", "synthetic_batch", "point_cloud"]


def synthetic_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                    *, np_out: bool = False, device=None):
    """Deterministic (tokens, labels) for a global step: labels are the
    next-token shift with the last position -100. numpy int32 arrays with
    `np_out`, else int64 tensors on `device` (the card by default)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    labels = np.concatenate(
        [tokens[:, 1:], np.full((batch, 1), -100, np.int32)], axis=1)
    out = {"tokens": tokens, "labels": labels}
    if np_out:
        return out
    return _to_device(out, resolve_device(device))


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class TokenPipeline:
    """Resumable synthetic-token pipeline.

    state == step index; ``restore(step)`` is exact resume. With
    ``host_count > 1`` a host takes its rows only (data-parallel
    file-less sharding). ``next()`` returns int64 tensors on ``device``
    (the card unless the caller passes one)."""
    seed: int
    batch: int
    seq: int
    vocab: int
    step: int = 0
    host_index: int = 0
    host_count: int = 1
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def next(self) -> dict:
        b = synthetic_batch(self.seed, self.step, self.batch, self.seq,
                            self.vocab, np_out=True)
        self.step += 1
        if self.host_count > 1:
            per = self.batch // self.host_count
            lo = self.host_index * per
            b = {k: v[lo:lo + per] for k, v in b.items()}
        return _to_device(b, self.device)

    def restore(self, step: int):
        self.step = step
        return self


def point_cloud(kind: str, n: int, dim: int = 3, seed: int = 0):
    """(n, dim) float32 numpy points: "uniform" | "normal" | "clusters" |
    "filaments" (cosmology-like, the DBSCAN / halo-finder workload)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 1, (n, dim)).astype(np.float32)
    if kind == "normal":
        return rng.normal(0, 1, (n, dim)).astype(np.float32)
    if kind == "clusters":
        k = max(int(np.sqrt(n) / 4), 2)
        centers = rng.uniform(0, 1, (k, dim))
        idx = rng.integers(0, k, n)
        return (centers[idx]
                + rng.normal(0, 0.01, (n, dim))).astype(np.float32)
    if kind == "filaments":
        k = max(n // 2048, 2)
        a = rng.uniform(0, 1, (k, dim))
        b = rng.uniform(0, 1, (k, dim))
        seg = rng.integers(0, k, n)
        t = rng.uniform(0, 1, (n, 1))
        pts = a[seg] * (1 - t) + b[seg] * t
        return (pts + rng.normal(0, 0.005, (n, dim))).astype(np.float32)
    raise ValueError(kind)
