#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # from the checkout root; needs one card

Phases (one line or more each, then the two closing lines):

  1. device: the card's name and count, and nvidia-smi's name and power
     limit; fails without a CUDA device.
  2. build: compiles every CUDA kernel of ``src/repro_torch/csrc`` (one
     nvcc per source, all at once) and prints the seconds.
  3. kernels: each kernel's wrapper against its plain PyTorch twin on the
     card, at the main path's widths (N = 2^20 uniform points in the unit
     cube, ArborX bvh_driver's "filled box"; Q = 2^17 queries):
     karras_ranges integer-identical, timed through its wrapper and alone
     beside two bounds (the fixed search's probes, and the probes this
     run's bounded searches made); bvh_traverse_spatial (the tree's node
     records) identical counts and buffers for Points values (fine_sqrt)
     and Boxes values, the fill and the count timed;
     bvh_traverse_knn (k = 10, the tree's node records) identical indices
     and distances, with no tie exception; the self-kNN case (the 2^20
     points as queries, walked in the leaf order) identical to the same
     kernel in the caller's order on every row and to the twin on the
     first 2^14, both orders timed; the self CSR query (the 2^20 points
     as sphere centres, walked in the leaf order) identical, count and
     buffer, to the same kernel in the caller's order and to the twin on
     every row, both orders timed.
  4. main path: ``BVH(Points)`` and ``BVH(Boxes)`` at N = 2^20 on the card,
     each answering ``query(intersects(Spheres(c, r)))`` (r = 0.0132, about
     10 neighbours, bvh_driver's convention) and ``query(nearest(Points,
     k=10))`` for Q = 2^17; checked on 2048 queries against BruteForce
     (CSR offsets and index sets equal) and against an exact float64
     oracle (kNN distances within 1e-6 relative); the Points index also
     answers the self-kNN query (``nearest(Points(points), k=10)``, every
     row at distance 0 first) and the self CSR query (spheres centred on
     the points, checked on 2048 rows against BruteForce). The launch
     counters are zeroed before this phase and read after it: one
     morton64 launch (the build's key), one karras_ranges launch and one
     lbvh_tail launch per build, the node records kept by the build, two
     spatial launches per CSR query,
     one kNN launch per kNN query, each handed the tree's node records,
     and the self queries the leaf order.
  5. timings: CUDA events around repeated launches after a warm-up, for
     each kernel and its twin, and end-to-end build / query times (the
     first spatial query of a fresh index once: the build made its node
     records), and the peak device memory of a Points build above what
     was allocated before it.
  6. profile: one build + CSR query + kNN query of the Points index under
     torch.profiler: device-busy share of the window and the kernels that
     take the device time ("not measured" when the profiler sees no
     device activity).
  6b. build path: the card's ``BVH(Points | Boxes | Triangles)`` trees at
     N = 2^20 (the triangles of the ray phase's soup), a build over points
     with two NaN coordinates and a refit of the points moved by
     N(0, 0.002^2), each held node for node, records too, against the
     twins run on the card (``morton_key_ref``, the sort,
     ``karras_ranges_fused``, ``lbvh_tail_ref`` / ``lbvh_refit_ref``:
     tolerance 0, NaN by place); then ``lbvh_tail`` over the Boxes build's
     ranges against its twin, timed through its wrapper, its C entry
     alone and its two kernels' device time, beside the twin, the twin's
     ``aabb_rmq`` alone and the tail's bytes bound.
  7. callback kernel: ``bvh_traverse_callback`` against its twin on the
     Points, Boxes and Spheres (radii 0.005) indexes at N = 2^20 with
     Q = 2^17 sphere queries of r = 0.0132: every epilogue (counting,
     count_with_limit(5), min_distance, collect_first_k(8),
     collect_hits(32), min_where over seeded flags and weights) on Points
     and Boxes, counting on Spheres; states bit-identical, kernel timed
     beside the twin and a walk-independent bound.
  8. DBSCAN (the callback path): 2^20 points in 3-D, 64 Gaussian blobs
     (sigma 0.01) of 15,360 points and 65,536 uniform noise points, eps =
     0.003, min_pts = 3. Its two walks at Q = N, count_with_limit(3) and
     a hook round's min_where, bit-identical to their twins and timed
     beside their bounds: the wrapper call (the kernels line's ms), the
     kernel's own device time under torch.profiler (the dim = 3
     instance, its registers and spills), the wrapper's steps (the walk
     order, which is the tree's leaf order; the node records, kept as
     ``LBVH.records``; min_where's weights) and the twin's node visits
     per query; then ``dbscan`` with both algorithms, each equal
     (labels and core flags) to an oracle built from the spatial kernel's
     CSR and scipy's connected components. Counters are zeroed before
     the two runs and read after: one callback-kernel launch per
     kernel-route batch, and no loop-route batch. A third FDBSCAN run
     under torch.profiler gives the device-busy share and the kernels
     that take the time. The kernels line gives the callback kernel the
     min_where walk's numbers.
  9. loop route: ``query(callback=sum_payload(...))`` at Q = 2^12 on the
     card through the general walk, equal to the sums over the CSR result
     taken in the same order; the route counter shows ``loop``.
 10. rays: a triangle soup of N = 2^20 (a uniform in the unit cube, b and
     c = a + U(-0.01, 0.01)^3) and R = 2^17 rays (uniform origins,
     standard-normal directions). With the counters zeroed just before:
     ``BVH(Triangles)``, ``cast_intersect`` and ``cast_ordered`` (two
     callback-kernel launches each, no loop-route batch),
     ``cast_nearest`` k = 1 and 4 (the kernel route: one ray kNN kernel
     launch each) and ``ray_box_nearest`` over the soup's bounding boxes;
     counters read just after. Then, on all R rays: cast_ordered
     ascending in t with cast_intersect's sets, cast_nearest's t equal to
     cast_ordered's first k and its indices in cast_intersect's sets;
     cast_nearest k = 4 identical to its twin (the reference's k-nearest
     walk, a host loop on the card) over the soup, the Boxes and the
     Spheres indexes, the kernel timed at k = 1, 4 and 10 beside its bound
     with the twin's node visits per ray and the cost of packing the
     records; every epilogue's ray instance over the soup, the Boxes
     index and the Spheres index, with the index's kept node and value
     records as the engine passes them, timed beside its bound and held
     against its twin (tolerance 0); on
     2048 rays the hit sets against BruteForce (boxes equal; triangles
     and spheres may differ only at pairs a float64 evaluation puts
     within the float32 error bound of the boundary, counted) and, for
     the soup, against a float64 oracle (differences only within 1e-5 of
     an edge, counted);
     ``ray_box_nearest`` against its twin and against ``cast_nearest(k=1)``
     over ``BVH(Boxes)`` of the same boxes (t identical, indices where
     the minimum is unique), timed beside its operations bound and the
     instruction-issue time of its slab tests, with its rays per thread,
     stages, splits and registers, and the device time of its second
     kernel, the decode pass.

 10b. serve (slice 12): ``QueryServer`` on the card
     (``ServiceConfig(capacity=64, min_bucket=8, max_bucket=4096)``) over
     "cloud" (the search points) and "scene" (the soup's 2^20
     triangles); every bucket from 8 to 4096 warmed for within (r =
     0.0132), kNN (k = 10) and rays (k = 1 and 4); then 1,000 seeded
     mixed requests of 1-512 rows in handle() calls of 8, with every twin
     of the path made to raise: no cache miss and no library load after
     the warm-up, one kernel launch per group, every response equal to
     ``BVH.query`` (kernel route) on the version it reports. Each
     bucket's handle() time beside the wrapper's (CUDA events), its
     device time with the stream held by a spin (``device_ms``) and the
     kernel's under the profiler, for kNN and within; the
     ``engine.kernel`` span's kernel_us with telemetry on against CUDA
     events, and its Chrome trace through ``validate_chrome_trace``;
     three refits (N(0, 0.002^2) moves) and a rebuild (N - 1 points)
     through ``IndexStore.update``. Then a ``ServingPipeline`` over an
     ``IndexStore(keep_versions=64)``: 4 closed-loop clients of 500
     requests each (half with 20 ms deadlines) while the maintenance
     stream moves "cloud" 20 times by steps that add up, as in
     ``examples/moving_points_service.py`` (a refit each, or a rebuild
     when the SAH monitor says the tree has degraded: at least one), and
     rebuilds it at N - 1: every ticket served, no failure, no stall
     behind maintenance, versions monotone per client, two responses per
     (index, version, kind) equal to ``BVH.query`` on that version; p50
     / p99 latency, miss rate, occupancy, requests/s. Counters are zeroed
     before each of its serving runs and read after; the phase logs and
     checks its own launches, which stay out of the kernels line.
 10c. emst (slice 13): ``emst`` at N = 2^20 in 3-D over the search
     points and over a ``clusters`` cloud (the reference data pipeline's
     formula: floor(sqrt(N) / 4) centres, sigma 0.01, its own seed),
     with every round's exclusion query recorded: a spanning tree (N - 1
     edges, one component by scipy), with the counters zeroed just before
     and read just after one run and every twin made to raise: one
     ``bvh_traverse_knn_exclude`` launch a Borůvka round, no call of
     ``traversal.knn_walk``; rounds, components per round, ms per run,
     the exclusion query's ms per round, host syncs and, under the
     profiler, the device's busy share and the kernel's share; the
     kernel against its twin on all N rows in the first round (timed
     beside it: the kernels line), and in every round of a run over the
     first 2^14 points on every row (tolerance 0; the twin, a host loop,
     takes 12-24 s a round at 2^20 rows, so the per-round check runs at
     the smaller N); the total weight at 2^17 points against scipy's
     ``minimum_spanning_tree`` over the ``Delaunay`` edges in float64,
     within 1e-6 relative (each float32 edge length is within a few u of
     its float64 value, and a float32 tie broken the other way swaps
     edges of lengths within that).
 10d. mls (slice 13): ``mls_interpolate`` of bench_mls.py's function
     from the 2^20 search points onto the 2^17 queries, degree 0, 1 and 2
     (k = 4, 10, 22): one kNN kernel launch a call (counters zeroed just
     before, read just after), no loop walk, the neighbours equal to
     ``BVH.query(nearest)``, 2048 values within the bound that
     ``tests/test_torch_mls.py`` derives of a float64 solve of the same
     systems; ms per call beside the build's and the kNN query's, the
     busy share under the profiler, the mean |value - f|.
 10e. geometry (slice 14; run right after 6b, so that its host workers
     overlap the later phases): ``BVH`` over the cube [0, 56]^3 cut into
     56^3 unit cells of 6 Kuhn tetrahedra (1,053,696), the ray phase's
     soup of 2^20 triangles, 2^20 uniform segments of length 0.01, the
     soup's 2^20 14-DOPs and the ray phase's 2^20 spheres, with Q = 2^17
     uniform points (times 56 for the mesh): point location
     (``intersects(Points)``), spheres of r = 0.005 over the soup and
     the segments, boxes of side 0.01 over the k-DOPs (two
     callback-kernel launches a query), ``nearest(Points)`` at k = 1 and
     10 over the soup and the segments and k = 10 over the spheres (one
     fine kNN launch a query), the counters zeroed just before and read
     just after, no loop walk; each query's time (CUDA events) and each
     build's. Then: every point in its own tetrahedron (the cell
     floor(x), the order of the fractional parts) and, farther than 1e-6
     from a cell face or a fractional tie, in that one alone; the
     callback kernel's counting and collect_hits(64) walks against their
     twin on the first 2^12 queries (tolerance 0) over every full index;
     on the first 2^10 queries, CSR sets and kNN lists against float64
     oracles (Ericson's closest point on a triangle, the clamped
     projection on a segment, the sphere distance): distances within
     2^-21 absolute, pairs apart only within 2^-21 of the radius,
     indices apart only at near ties (counted), and the k-DOPs' sets
     equal BruteForce's; the two new instances' registers and spills.
     The fine kNN twin (a host loop that steps once per node of the
     longest rope walk) runs over the first 2^8 queries of each of the
     five nearest queries, on the main path's own 2^20-value indexes, in
     four spawned processes on the host CPU; after the lm phase the main
     path's rows are held against its lists (tolerance 0, ties and
     order). The kernels line takes the callback kernel's
     spheres-over-the-soup walk (ms at Q = 2^17, plain_ms the twin on the
     card over the first 2^12 queries) and the fine kNN walk at k = 10
     over the soup (ms at Q = 2^17, plain_ms the twin on the host CPU,
     one thread, over the first 2^8 queries: each plain_ms is at a
     smaller shape than its ms).
 11. ops (slice 4's main path): ``kernels.ops.morton64`` over the 2^20
     search points and ``kernels.ops.bruteforce_knn`` of 2^13 of the
     queries against them (k = 10), the two launch counters zeroed just
     before and read just after: one launch each.
 12. morton: the op bit-identical to its twin (``core.morton.morton64``)
     on every point, at N = 2^20 in 3-D and at 2^16 points in dims 1, 2,
     4, 6 and 10 (the bits rule, the hi lane); the build instance
     (``morton_key``) against ``morton_key_ref`` at 64 and 32 bits over the
     same sweep and over the main path's Boxes and Points inputs; each
     timed through its wrapper, its C entry alone and its kernels' device
     time, beside its bytes bound and the twin. The kernels line takes the
     build instance over the Boxes inputs, and counts the builds' launches
     on the main path with the op's.
 13. bruteforce: the kernel bit-identical to its twin on every row at
     Q = 2^13, N = 2^20, k = 10 (2^33 pairs; the point axis in the S
     chunks of ``kernels.bruteforce_knn.plan``), its distances against
     ``BVH.query(nearest)`` within the expansion's error, timed beside its
     operations bound, the twin and ``torch.topk(torch.cdist(q, p))`` (the
     yardstick, two calls); at ``bench_bruteforce.py``'s crossover sizes
     (Q = 1024, k = 8, N = 512, 4096, 32768) beside BVH kNN and
     ``BruteForce.query``; at k = 256, dim 64, float16 inputs and the
     k > N tail in one panel and in three, each against its twin.
 14. sanitize: ``repro_torch.analysis``'s ``--strict`` pass: its sanitize
     smoke (``analysis.smoke``: every wrapper armed with
     ``REPRO_SANITIZE=1``, each held to an oracle, on the card, N = 2000)
     with every C entry's guard count zeroed first, then each of the 15 C
     entries checked to have launched through its int guard, and the
     guard checked to refuse 2^31 in each int argument (no launch); the
     guard's host cost a call.
 15. flash: the tensor-core kernel's registers, spills and shared memory
     (from its build log); ``flash_attention``'s kernel against its twin
     on the card at the LM's shape (B = 4, Hq = 32, Hkv = 4, S = 2048,
     D = 64, bf16, causal), ``tests/test_kernels.py``'s float32 sweep
     (GQA, MQA, unaligned S, Sq < Skv, window 32, bidirectional D = 128),
     Sq > Skv (rows of zeros), D = 8, 16, 80, 96, 112 (zamba2-7b's
     shared block, B = 1, 32 heads, S = 1024) and 128, windows and ragged
     tiles, float16; within 2e-5 plus two steps of the output type, plus
     for 16-bit inputs u times the p-weighted mean of |v| (the kernel
     rounds p to the input type). Timed beside the twin, its bound (bf16
     tensor-core rate), ``scaled_dot_product_attention`` (the yardstick,
     never called by the port) and the float32 instance, with TFLOP/s,
     the share of the bound and the ratio to SDPA.
 16. lm (slice 5's main path): ``LM.from_config`` of TinyLlama-1.1B with
     attn_impl="flash" at full width and depth (22 layers), random bf16
     weights from the seed, one forward of 4 x 2048 seeded tokens with the
     counters zeroed just before and read just after: 22 flash launches,
     no twin call, finite logits. The logits against the plain path
     (attn_impl="xla") on the same weights: bf16 at full depth within 2e-2
     of max |logit| with top-1 agreement of at least 0.95, float32 at
     full width with the depth cut to 2 layers within 1e-5 (top-1 at
     least 0.999). The forward's
     time (ms, tokens/s) and one profiled forward, with the flash
     kernel's share of device time.
 16b. lm-serve (slice 18): the flash kernel against its twin at the new
     forwards' attention shapes (a window of 4096 at S = 4160, the
     non-causal encoder, cross-attention with Sq 32 / Skv 256, heads of
     112, 640 rows with a window); ``repro_torch.launch.serve.main`` for
     TinyLlama-1.1B at full depth (B = 4, prompt 128, gen 32); then one
     model at a time at its published width, bf16, ``LM.from_config``
     weights (LMS_MODELS: TinyLlama; Mixtral-8x22B at 2 of 56 layers, B
     = 1, a prompt of 4096 + 64 so the ring of 4096 wraps; DeepSeek-V3
     at 4 of 61 layers, its 3 first_k_dense and 1 MLA + MoE; Mamba2-780m;
     Zamba2-7B, 81 layers; SeamlessM4T-medium over 256 frames;
     LLaVA-NeXT with 576 patch rows in the flash forward), the MoE
     families at capacity factor 8.0: the prefill's logits (the
     sequential decode steps) against the forward's on the same tokens
     (max |diff| / max |logit| and top-1 agreement within
     LMS_GAP / LMS_MOE_GAP and LMS_TOP1); decode ms per step and tokens/s
     by CUDA events (TinyLlama's steps under sync-debug "error", and one
     profiled step's busy share), prefill s, peak device memory, the
     cache's bytes and the step's bound (every weight it uses and the
     cache read once at 3.35 TB/s); a forward with attn_impl="flash"
     against the plain path on the same weights, the flash counter zeroed
     just before and read just after (one launch per attention call,
     no twin call), MLA's refused with a ValueError. The kernels line
     adds these launches to flash's.

 16c. train (slice 19): TinyLlama-1.1B at full width and depth, bf16,
     remat, B = 4 x S = 2048 from ``TokenPipeline``: 3 warm and 5 timed
     train steps (ms per step, tokens/s, peak device memory, the busy
     share of one profiled step, 6 N tokens / step time / 989 TFLOP/s);
     host syncs under sync-debug "warn" of a step and of its forward and
     backward alone (the step adds none). A fresh model memorizes a
     fixed batch: 20 steps at lr 1e-3, the last loss below 0.7 of the
     first; then its ``make_eval_step`` on a held-out batch with
     attn_impl="flash", the flash counter zeroed just before and read
     just after (22 launches, no twin call), the loss within
     TRAIN_EVAL_ABS of the plain path's.
     At 2 of the 22 layers, full width, float32, B = 2 x S = 64: the
     card's loss and gradients against the CPU port's on the same
     weights (``convert.lm_to_numpy``), and AdamW's state after one step
     from the same gradients on both; at 2 layers, bf16, B = 4 x S =
     2048: remat on and off give bit-identical losses and gradients, both
     peak memories printed. Every family's smoke configuration one step
     on the card (loss and grad norm finite, every nonzero leaf moved,
     the loss against the CPU port's). ``launch.train.main`` --smoke for
     4 steps into a checkpoint directory, then to 8 from it ("resumed
     from step 4"). The kernels line adds the eval step's flash launches
     to flash's.
 16d. mesh (slice 20): (b) ``launch.opanalysis.analyze`` over
     [train]'s step (TinyLlama-1.1B, bf16, remat, B = 4 x S = 2048) on
     the meta device in a fake world of one rank, a (1, 1) ("data",
     "model") mesh: its per-device FLOPs beside 6 N T, the attention's
     and remat's, its temp_bytes beside the card's peak, t_compute beside
     the measured step. (a) In an NCCL world of one rank, the same mesh:
     3 train steps at ``launch.sharding``'s placements (the rules
     installed, ``distribute_model``, ZeRO-1 moments, the batch at
     ``batch_spec``) against 3 plain steps from the same weights and
     batches: losses, every weight and every moment bit-identical
     (MESH_A_TOL); the sharded step's ms beside the plain step's (the
     DTensor overhead at one rank); the analyzer's arg_bytes equal to the
     card's parameter, moment, step and batch bytes. Then the sharded
     eval step with attn_impl="flash", each rank's heads through
     ``local_map``, the counter zeroed just before and read just after
     (22 launches, no twin call), its loss against the unsharded flash
     eval's within TRAIN_EVAL_ABS; the kernels line adds the launches.
     No world of gloo ranks on the card: this torch's gloo crashes in
     ``all_gather_into_tensor`` of CUDA tensors
     (``scripts/gloo_cuda_probe.py``); the CPU tests hold the
     multi-rank path.

 17. distributed (slice 15; run last, once the host's cores are free of
     the twins' workers): one world of 4 gloo ranks on the one card
     (``python3 chip_smoke.py --rank r ...``: fresh processes, a file
     store, a 60 s timeout on every collective; collectives staged
     through host memory), each rank holding 2^18 of the 2^20 points and
     of the boxes and 2^15 of the 2^17 queries: ``DistributedTree``
     builds, kNN (k = 10), count, CSR and ``min_distance`` (combine =
     torch.minimum) of the main path's spheres, RayNearest (k = 4) of
     2^15 seeded rays over the boxes, and ``ship_values`` over 2^10
     queries, each rank's counters zeroed just before and read just
     after (every kernel of the path launched on every rank: the builds'
     morton64, karras_ranges and lbvh_tail, the kNN, callback and ray
     kNN kernels). The parent holds the results against one BVH over
     all the points (boxes) on the card with the kernel route: counts and
     states bit-identical, CSR sets equal, kNN and ray distances
     bit-identical with indices apart only among ties (rows counted), the
     shipped values the matched points. Then an NCCL world of one rank
     repeats the queries with device tensors, identical to the single
     BVH, indices included. Each kind's ms per call (rank 0) and, with
     telemetry on, per stage (``distributed.gather / local / exchange /
     merge / ship``), beside the card's name and power limit. A failed
     rank fails the phase; every rank is stopped at the end.
 18. sharded (slice 15, in the same gloo world): a ``ShardedIndexStore``
     behind a ``QueryServer`` over each rank's blocks of "cloud" and
     "scene", warmed as [serve] warms, then [serve]'s 1,000 requests,
     timed with telemetry off and split by stage in a second pass with
     telemetry on: identical on every rank, all warm, each equal to the
     single-device QueryServer's response in [serve] (distances bit-
     identical, indices apart only among ties, within sets equal); the
     ms per group of each stage (``sharded.gather / local_traverse /
     exchange / merge``) by kind; a drifted update (a refit on every
     rank) and a scrambled one (a rebuild), versions and actions checked.
     Then the pipeline over the same 4 ranks (``ServingPipeline`` at
     R = 4: rank 0 leads, ranks 1-3 follow): a new store on the warm
     engine, "cloud" and "scene" built through the leader's
     ``create_index`` (the global values broadcast, each rank its
     block), 4 client threads on the leader, 100 requests each from
     [serve]'s mix (closed loop), every second one with a 20 ms deadline,
     while "cloud" moves 5 times through ``update_index``. Every response
     equal to a single-device QueryServer's at the version it was served
     at; 0 failed tickets, 0 stalls behind maintenance, 0 maintenance
     errors, the same versions on every rank, each rank's kernel
     launches above 0; requests/s, p50 / p99 latency, the version
     sequence and each rank's groups served.
     Both phases' launches stay on their own lines, per rank; the kernels
     line reads each entry's launches from its own path only.

The line before the last is ``{"kernels": [...]}`` (14 entries: name,
route, source, replaced TPU kernel, launches, max_abs_err, ms, plain_ms,
bound_ms, bound_by, library_ms); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises and the script exits nonzero without them.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N = 1 << 20
Q = 1 << 17
K = 10
RADIUS = 0.0132
BOX_SIDE = 0.01
N_CHECK = 2048
N_SELF_TWIN = 1 << 14    # self-kNN rows held against the twin
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, and float32
# operations/s outside the tensor cores, which also serves as the rate
# for the integer work (the card's int32 rate is not higher, so the
# bound stays a floor)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# bf16 dense tensor-core peak: the flash kernel's inputs are bf16 and
# their products exact in float32, so the least time its work could take
# is at the tensor cores' rate (the other kernels' bounds keep the
# float32 rate)
BF16_OPS_PER_S = 989e12


def log(*a):
    print(*a, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, reps, warmup=1):
    """Mean milliseconds per call, by CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
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


def timed_once(fn):
    """(result, ms) of one call of fn, by CUDA events."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tree_bytes(n, dim, range_last):
    """Bytes of the tree arrays a walk takes, each read once: node boxes
    and ropes (and range_last) over 2N-1 nodes, left children, leaf_perm."""
    per_node = 2 * dim * 4 + 4 + (4 if range_last else 0)
    return (2 * n - 1) * per_node + (n - 1) * 4 + n * 4


# operations of one leaf test: dim differences, clamps and squares, and
# the sum, plus the compare (and, for kNN, the insert's compare)
def leaf_ops(dim):
    return 6 * dim + 2


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"[device] {name} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(card)
    return name, count, card


def phase_build():
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} sources in {secs:.1f} s "
        f"({', '.join(_build.SOURCES)})")
    for src in _build.SOURCES:
        for fn, regs, spill in _ptxas_summary(_build.build_log(src)):
            log(f"[build] {src} {fn}: {regs} registers, {spill} B spill stores")


def _ptxas_summary(text):
    """(kernel, registers, spill-store bytes) per entry of `-Xptxas -v`."""
    out, fn, spill = [], None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"karras_kernel", m.group(1))
            # the walks bounded at a block of 256 or 512 threads (block_q)
            sp = re.search(r"(spatial_kernel3?)ILi(\d+)ELb([01])E",
                           m.group(1))
            kn = re.search(r"(knn_kernel|knn_exclude_kernel)I(?:Li(\d+)E)?"
                           r"NS_\d+(Records3|Flat)EN3knn\d+"
                           r"(KeyList|KeyHeap)ILi(\d+)E", m.group(1))
            cb = re.search(r"(callback_kernel3|callback_kernel|ray_kernel3|"
                           r"ray_kernel|shaped_kernel3)ILi(\d+)E.*?"
                           r"(CountWithLimit|Counting|MinDistance|"
                           r"CollectILb[01]E|MinWhere)", m.group(1))
            rn = re.search(r"ray_knn_nf_kernelIN3knn\d+(KeyList|KeyHeap)"
                           r"ILi(\d+)E", m.group(1))
            rk = re.search(r"(ray_knn_kernel|nf_kernel)I.*?(Records3|Flat|"
                           r"LeafBox|LeafSphere3|LeafTriangle3|LeafFlat)E.*?"
                           r"(LeafBox|LeafSphere3|LeafTriangle3|LeafFlat)?E?"
                           r"N3knn\d+(KeyList|KeyHeap)ILi(\d+)E", m.group(1))
            fk = re.search(r"(fine_nf_kernel|fine_rope_kernel)INS_\d+"
                           r"(Records3|Flat)EN3knn\d+"
                           r"(KeyList|KeyHeap)ILi(\d+)E", m.group(1))
            rb3 = re.search(r"ray_box3_kernelILi(\d+)EE", m.group(1))
            rb = re.search(r"ray_box_kernel|ray_box_decode|lanes_generic|"
                           r"key_generic|scene_generic|scene_final|"
                           r"link_kernel|rope_kernel|parent_kernel",
                           m.group(1))
            mt = re.search(r"(lanes_kernel|key_kernel|scene_kernel|"
                           r"climb_kernel3?)I(?:Li(\d+)E|Lb([01])E)"
                           r"(?:Li(\d+)E)?", m.group(1))
            fa = re.search(r"flash_kernel_(tc|f32)I(6__half|13__nv_bfloat16)?"
                           r"Li(\d+)E", m.group(1))
            bf = re.search(r"scan_kernelILi(n?\d+)EN3knn\d+(KeyList|KeyHeap)"
                           r"ILi(\d+)E", m.group(1))
            bm = re.search(r"merge_kernelIN3knn\d+(KeyList|KeyHeap)ILi(\d+)E",
                           m.group(1))
            fn = (f"{fk.group(1)}<{fk.group(2)}, {fk.group(3)} "
                  f"{fk.group(4)}>" if fk
                  else f"{mt.group(1)}<{mt.group(2) or mt.group(3)}"
                  f"{', ' + mt.group(4) if mt.group(4) else ''}>" if mt
                  else f"ray_knn_nf_kernel<{rn.group(1)} {rn.group(2)}>" if rn
                  else f"{rk.group(1)}<"
                  f"{', '.join(g for g in rk.group(2, 3) if g)}, "
                  f"{rk.group(4)} {rk.group(5)}>" if rk
                  else (f"flash_kernel_tc<{fa.group(2).lstrip('0123456789')}, "
                   f"DH {fa.group(3)}>" if fa.group(1) == "tc"
                   else f"flash_kernel_f32<D {fa.group(3)}>") if fa
                  else f"{cb.group(1)}<{cb.group(2)}, {cb.group(3)}>" if cb
                  else f"{sp.group(1)}<{sp.group(2)}, {sp.group(3)}>" if sp
                  else f"scan_kernel<dim {bf.group(1).replace('n', '-')}, "
                       f"{bf.group(2)} {bf.group(3)}>" if bf
                  else f"merge_kernel<{bm.group(1)} {bm.group(2)}>" if bm
                  else f"{kn.group(1)}<"
                       f"{kn.group(2) + ', ' if kn.group(2) else ''}"
                       f"{kn.group(3)}, {kn.group(4)} {kn.group(5)}>" if kn
                  else f"ray_box3_kernel<T {rb3.group(1)}>"
                  if rb3
                  else k.group(0) if k else rb.group(0) if rb
                  else m.group(1))
            fn = re.sub(r"ILb([01])E", r"<\1>", re.sub(r"ILi(\d+)E", r"<\1>", fn))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((fn, int(m.group(1)), spill))
    return out


def make_data(dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pts = torch.rand((N, 3), generator=gen, device=dev)
    box_lo = torch.rand((N, 3), generator=gen, device=dev)
    qc = torch.rand((Q, 3), generator=gen, device=dev)
    return pts, box_lo, box_lo + BOX_SIDE, qc


def phase_kernels(dev, pts, box_lo, box_hi, qc):
    """Each kernel against its twin at the main path's shapes. Returns the
    per-kernel records (without launches) for the kernels line."""
    import torch
    from repro_torch.core import geometry as G
    from repro_torch.core import lbvh as L
    from repro_torch.core import morton as M
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB

    rec = {}

    # -- karras_ranges on the sorted Morton keys of the points ----------
    codes = M.morton64(pts, pts.amin(0), pts.amax(0))
    perm0 = torch.arange(N, device=dev)
    codes_s, _ = M.sort_by_morton(codes, perm0)
    hi, lo, idx = M.combined_delta_key(codes_s, N)
    ml2 = max((N - 1).bit_length(), 1)
    got = KB.karras_ranges(hi, lo, idx, N, ml2)
    want = KB.karras_ranges_fused(hi, lo, idx, N, ml2)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    check(err == 0, f"karras_ranges differs from its twin (max {err})")
    ms = time_ms(lambda: KB.karras_ranges(hi, lo, idx, N, ml2), reps=50)
    # the kernel alone: its C entry on the same lanes and outputs
    from repro_torch.kernels import _build
    entry = _build.function("karras", "karras_ranges_launch", KB._LAUNCH_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lanes = [t.contiguous() for t in (hi, lo, idx)]
    k_ms = time_ms(lambda: entry(*(t.data_ptr() for t in lanes), N,
                                 *(o.data_ptr() for o in got), stream), reps=50)
    plain = time_ms(lambda: KB.karras_ranges_fused(hi, lo, idx, N, ml2), reps=3)
    # bound 1 (the row's, kept from the fixed search so the row stays
    # comparable): 2 (max_log2 + 1) + 3 probes a node, 4-byte lanes
    probes = 2 * (ml2 + 1) + 3
    b_ms, b_by = bound(3 * N * 4 + 3 * (N - 1) * 4, (N - 1) * probes * 12)
    # bound 2: the probes the bounded searches make in this run, 3 + 3
    # (floor(log2 l) + 1) for a node of range length l, and the int64
    # lanes the kernel reads
    length = (got[1] - got[0]).to(torch.float64)
    mean_probes = float((3 + 3 * (torch.floor(torch.log2(length)) + 1)).mean())
    b2_ms, b2_by = bound(3 * N * 8 + 3 * (N - 1) * 4,
                         (N - 1) * mean_probes * 12)
    # the kernels line carries bound 2, the bound of the function as now
    # computed; the log line keeps both
    rec["karras_ranges"] = dict(
        source="src/repro_torch/csrc/karras.cu",
        replaces="src/repro/kernels/lbvh_build.py:196",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b2_ms,
        bound_by=b2_by)
    log(f"[kernels] karras_ranges N={N}: identical to twin (tolerance 0); "
        f"{ms:.4f} ms through the wrapper, the kernel alone {k_ms:.4f} ms, "
        f"vs twin {plain:.3f} ms; bound {b_ms:.4f} ms ({b_by}; the fixed "
        f"search's {probes} probes a node); bound {b2_ms:.4f} ms ({b2_by}; "
        f"the bounded search's {mean_probes:.3f} probes a node on the mean)")
    del codes, codes_s, hi, lo, idx, got, want

    # -- bvh_traverse_spatial: Points values (fine_sqrt) and Boxes values --
    r = torch.full((Q,), RADIUS, device=dev)
    spatial = []
    for label, boxes, fine in (("points", G.Boxes(pts, pts), True),
                               ("boxes", G.Boxes(box_lo, box_hi), False)):
        t = L.build(boxes)
        args = (t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm, qc, qc, r)
        # the tree's node records, as the engine hands them to the kernel
        kept = dict(fine_sqrt=fine, records=t.records)
        cnt, _ = T.bvh_traverse_spatial(*args, capacity=1, **kept)
        cap = max(int(cnt.max()), 1)
        stats = {}
        got = T.bvh_traverse_spatial(*args, capacity=cap, **kept)
        want = T.bvh_traverse_spatial_ref(*args, capacity=cap, fine_sqrt=fine,
                                          stats=stats)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for a, b in zip(got, want))
        check(err == 0 and torch.equal(got[1], want[1]),
              f"bvh_traverse_spatial ({label}) differs from its twin")
        ms = time_ms(lambda: T.bvh_traverse_spatial(*args, capacity=cap,
                                                    **kept), reps=20)
        c_ms = time_ms(lambda: T.bvh_traverse_spatial(*args, capacity=1,
                                                      **kept), reps=20)
        plain = time_ms(lambda: T.bvh_traverse_spatial_ref(
            *args, capacity=cap, fine_sqrt=fine), reps=1, warmup=0)
        # the bound does not depend on the walk: queries (lo, hi, r) and
        # the tree read once, counts and buffer written once, and one leaf
        # test per match, the least any exact range search does
        nbytes = Q * (2 * 3 * 4 + 4) + tree_bytes(N, 3, True) + Q * 4 * (1 + cap)
        b_ms, b_by = bound(nbytes, int(got[0].sum()) * leaf_ops(3))
        spatial.append(dict(label=label, cap=cap, visits=stats["visits"],
                            max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by))
        log(f"[kernels] bvh_traverse_spatial {label} N={N} Q={Q} cap={cap}: "
            f"identical to twin (tolerance 0); the fill {ms:.3f} ms, the "
            f"count (cap 1) {c_ms:.3f} ms, through the wrapper with the "
            f"tree's records, vs twin {plain:.1f} ms; {stats['visits']} node "
            f"visits ({stats['visits'] / Q:.1f} per query); bound "
            f"{b_ms:.4f} ms ({b_by})")
        if label == "points":
            tree_points = t
        del t, args, got, want, kept
    p = spatial[0]
    rec["bvh_traverse_spatial"] = dict(
        source="src/repro_torch/csrc/bvh_traverse.cu",
        replaces="src/repro/kernels/bvh_traverse.py:177",
        max_abs_err=max(s["max_abs_err"] for s in spatial), ms=p["ms"],
        plain_ms=p["plain_ms"], bound_ms=p["bound_ms"], bound_by=p["bound_by"])

    # -- bvh_traverse_knn, k = 10, over the points -------------------------
    t = tree_points
    args = (t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm, qc)
    stats = {}
    gd, gi = T.bvh_traverse_knn(*args, k=K, records=t.records)
    wd, wi = T.bvh_traverse_knn_ref(*args, k=K, stats=stats)
    torch.cuda.synchronize()
    err = float((gd - wd).abs().max())
    swapped = int((gi != wi).sum())
    # no tie exception: the walk keeps the twin's leaves at the k-th
    # distance and its order among equal distances
    check(torch.equal(gd, wd) and swapped == 0,
          f"bvh_traverse_knn differs from its twin (max |d| {err}, "
          f"{swapped} indices)")
    ms = time_ms(lambda: T.bvh_traverse_knn(*args, k=K, records=t.records),
                 reps=10)
    plain = time_ms(lambda: T.bvh_traverse_knn_ref(*args, k=K), reps=1,
                    warmup=0)
    # the bound does not depend on the walk either: queries and the tree
    # read once, (dists, idxs) written once, and one leaf test for each
    # leaf within the query's k-th distance (at least k; more on ties),
    # the least any exact k-NN computes. That count comes from the spatial
    # kernel, held against its twin above, at r = the k-th distance.
    within, _ = T.bvh_traverse_spatial(
        t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last, t.leaf_perm,
        qc, qc, gd[:, K - 1].contiguous(), capacity=1, fine_sqrt=True,
        records=t.records)
    leaves = int(within.clamp_min(K).sum())
    nbytes = Q * 3 * 4 + tree_bytes(N, 3, False) + Q * K * 8
    b_ms, b_by = bound(nbytes, leaves * leaf_ops(3))
    # the library yardstick at the row's shape: chunked cdist + topk over
    # all N points (one chunk first, so the timed call finds its kernels
    # loaded)
    _library_knn(qc[:LIB_CHUNK], pts, K)
    lib = time_ms(lambda: _library_knn(qc, pts, K), reps=1, warmup=0)
    rec["bvh_traverse_knn"] = dict(
        source="src/repro_torch/csrc/bvh_traverse.cu",
        replaces="src/repro/kernels/bvh_traverse.py:301",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib)
    log(f"[kernels] bvh_traverse_knn N={N} Q={Q} k={K}: identical to twin "
        f"(tolerance 0; {swapped} tied indices swapped); {ms:.3f} ms vs twin "
        f"{plain:.1f} ms; the twin's rope walk {stats['visits']} node visits "
        f"({stats['visits'] / Q:.0f} per query); {leaves} leaves within the "
        f"k-th distance; bound {b_ms:.4f} ms ({b_by}); library (cdist + "
        f"topk, {LIB_CHUNK}-query chunks) {lib:.1f} ms")

    # -- the self-kNN case: the points themselves, in the leaf order -------
    sargs = args[:5] + (pts,)
    order = T.knn_order(pts, pts, t.leaf_perm)
    check(order is t.leaf_perm, "knn_order: the points are not their own "
          "queries")
    sd, si = T.bvh_traverse_knn(*sargs, k=K, records=t.records, order=order)
    cd, ci = T.bvh_traverse_knn(*sargs, k=K, records=t.records)
    wd, wi = T.bvh_traverse_knn_ref(*args[:5], pts[:N_SELF_TWIN], k=K)
    torch.cuda.synchronize()
    check(torch.equal(sd, cd) and torch.equal(si, ci),
          "bvh_traverse_knn: the leaf order changed a self-kNN result")
    check(torch.equal(sd[:N_SELF_TWIN], wd) and torch.equal(
        si[:N_SELF_TWIN], wi), "bvh_traverse_knn self-kNN differs from its "
          "twin")
    s_ms = time_ms(lambda: T.bvh_traverse_knn(*sargs, k=K, records=t.records,
                                              order=order), reps=5)
    c_ms = time_ms(lambda: T.bvh_traverse_knn(*sargs, k=K, records=t.records),
                   reps=5)
    log(f"[kernels] bvh_traverse_knn self-kNN N=Q={N} k={K}: the leaf order "
        f"{s_ms:.3f} ms, the caller's order {c_ms:.3f} ms; identical to "
        f"each other on every row and to the twin on the first "
        f"{N_SELF_TWIN} rows")

    # -- the self CSR query: spheres centred on the points, walked in the
    # leaf order as the engine walks them, held on every row against the
    # same kernel in the caller's order and against the twin. The rows
    # come from torch.empty, so the kernel must write each of them: a
    # block of the buffer's size is poisoned and freed first, which the
    # caching allocator hands to the next buffer of that size.
    cargs = args[:4] + (t.range_last, t.leaf_perm, pts, pts,
                        torch.full((N,), RADIUS, device=dev))
    own = dict(fine_sqrt=True, records=t.records)
    poison = torch.full((N,), -7, dtype=torch.int32, device=dev)
    del poison
    oc, _ = T.bvh_traverse_spatial(*cargs, capacity=1, order=t.leaf_perm,
                                   **own)
    cc, _ = T.bvh_traverse_spatial(*cargs, capacity=1, **own)
    scap = max(int(oc.max()), 1)
    poison = torch.full((N, scap), -7, dtype=torch.int32, device=dev)
    del poison
    of = T.bvh_traverse_spatial(*cargs, capacity=scap, order=t.leaf_perm,
                                **own)
    cf = T.bvh_traverse_spatial(*cargs, capacity=scap, **own)
    wf = T.bvh_traverse_spatial_ref(*cargs, capacity=scap, fine_sqrt=True)
    torch.cuda.synchronize()
    check(torch.equal(oc, cc) and torch.equal(of[0], oc),
          "bvh_traverse_spatial: the leaf order changed a self count")
    check(torch.equal(of[0], cf[0]) and torch.equal(of[1], cf[1]),
          "bvh_traverse_spatial: the leaf order changed a self fill")
    check(torch.equal(of[0], wf[0]) and torch.equal(of[1], wf[1]),
          "bvh_traverse_spatial self query differs from its twin")

    def self_query(order):
        T.bvh_traverse_spatial(*cargs, capacity=1, order=order, **own)
        T.bvh_traverse_spatial(*cargs, capacity=scap, order=order, **own)
    s_ms = time_ms(lambda: self_query(t.leaf_perm), reps=5)
    c_ms = time_ms(lambda: self_query(None), reps=5)
    log(f"[kernels] bvh_traverse_spatial self query N=Q={N} cap={scap}: "
        f"count + fill in the leaf order {s_ms:.3f} ms, in the caller's "
        f"order {c_ms:.3f} ms; counts and buffers identical to each other "
        f"and to the twin on all {N} rows (tolerance 0), "
        f"{int(of[0].sum())} matches")
    del oc, cc, of, cf, wf
    return rec, spatial


def _oracle_knn(values_lo, values_hi, queries, k, block=128):
    """Exact k nearest in float64 (point-to-box distance; points are boxes
    with lo == hi): (dists (Qc, k), idx (Qc, k)). Independent of the port."""
    import torch
    lo, hi = values_lo.double(), values_hi.double()
    ds, ix = [], []
    for s in range(0, queries.shape[0], block):
        qb = queries[s:s + block].double()[:, None, :]
        g = torch.clamp_min(torch.maximum(lo - qb, qb - hi), 0.0)
        d, i = torch.topk((g * g).sum(-1).sqrt(), k, dim=1, largest=False)
        ds.append(d)
        ix.append(i)
    return torch.cat(ds), torch.cat(ix)


def check_csr(res, ref, nq, label):
    import torch
    off = res.offsets[:nq + 1].to(torch.int64)
    check(torch.equal(off - off[0], ref.offsets.to(torch.int64)),
          f"{label}: CSR offsets differ from BruteForce")
    a = res.indices[:int(off[-1])].to(torch.int64)
    b = ref.indices.to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(nq, device=a.device),
                                   (off[1:] - off[:-1]))
    # per-query sets: sort (row, index) pairs on both sides
    ka = torch.sort(rows * (1 << 32) + a).values
    kb = torch.sort(rows * (1 << 32) + b).values
    check(torch.equal(ka, kb), f"{label}: per-query index sets differ")


def check_knn(res, ref, oracle, label):
    """BVH kNN vs the port's BruteForce and the float64 oracle."""
    import torch
    d, i = res.distances[:N_CHECK], res.indices[:N_CHECK]
    od, _ = oracle
    check(bool((i >= 0).all()), f"{label}: kNN has padding at N={N}")
    check(bool((d[:, 1:] >= d[:, :-1]).all()), f"{label}: kNN not ascending")
    rel = float(((d.double() - od) / od.clamp_min(1e-30)).abs().max())
    check(rel <= 1e-6, f"{label}: kNN distances off the float64 oracle by "
          f"{rel:.3g} relative (tolerance 1e-6)")
    # indices: equal to BruteForce's except among equal distances
    same = i == ref.indices
    tie = torch.zeros_like(same)
    tie[:, 1:] |= d[:, 1:] == d[:, :-1]
    tie[:, :-1] |= d[:, :-1] == d[:, 1:]
    # BruteForce over Points uses the reference's |x|^2 - 2x.y + |y|^2
    # expansion: its distances carry that rounding, about
    # 4 * 2^-23 * (|q|^2 + |p|^2) in the square (coordinates in [0, 1]^3)
    d2_tol = 4 * 2.0 ** -23 * 6
    bf_err = float((d.double() ** 2 - ref.distances.double() ** 2).abs().max())
    near = (d.double() ** 2 - ref.distances.double() ** 2).abs() <= d2_tol
    check(bool((same | tie | near).all()) and bf_err <= d2_tol,
          f"{label}: kNN differs from BruteForce beyond ties "
          f"(max |d2 diff| {bf_err:.3g})")
    return rel, bf_err, int((~same).sum())


def phase_main_path(dev, pts, box_lo, box_hi, qc):
    """The port's entry points end to end, with launch counts."""
    import torch
    import repro_torch as rt
    from repro_torch.core import engine as E
    from repro_torch.core import geometry as G
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM

    counters = {"morton64": KM.morton64, "karras_ranges": KB.karras_ranges,
                "lbvh_tail": KB.lbvh_tail,
                "bvh_traverse_spatial": T.bvh_traverse_spatial,
                "bvh_traverse_knn": T.bvh_traverse_knn}

    def counts():
        return {k: f.launches for k, f in counters.items()}

    # what the engine hands the kNN and spatial kernels: the tree's
    # records, the order
    knn_calls, spatial_calls = [], []
    real_knn, real_spatial = E.bvh_traverse_knn, E.bvh_traverse_spatial

    def knn_spy(*a, **kw):
        knn_calls.append((kw.get("records"), kw.get("order")))
        return real_knn(*a, **kw)

    def spatial_spy(*a, **kw):
        spatial_calls.append((kw.get("records"), kw.get("order")))
        return real_spatial(*a, **kw)

    spheres = rt.intersects(G.Spheres(qc, torch.full((Q,), RADIUS, device=dev)))
    knn = rt.nearest(G.Points(qc), k=K)
    sub_spheres = rt.intersects(G.Spheres(qc[:N_CHECK],
                                          torch.full((N_CHECK,), RADIUS,
                                                     device=dev)))
    sub_knn = rt.nearest(G.Points(qc[:N_CHECK]), k=K)
    policy = rt.ExecutionPolicy()          # device=None: the card
    results = {}

    E.bvh_traverse_knn = knn_spy
    E.bvh_traverse_spatial = spatial_spy
    for f in counters.values():
        f.launches = 0
    for label, values in (("points", G.Points(pts)),
                          ("boxes", G.Boxes(box_lo, box_hi))):
        c0 = counts()
        index = rt.BVH(values, policy=policy)
        check(index.device.type == "cuda", "BVH did not land on the card")
        c1 = counts()
        csr = index.query(spheres)
        c2 = counts()
        nn = index.query(knn)
        torch.cuda.synchronize()
        c3 = counts()
        for kname in ("morton64", "karras_ranges", "lbvh_tail"):
            check(c1[kname] - c0[kname] == 1,
                  f"{label}: build did not launch {kname} once")
        check("records" in index.tree.__dict__,
              f"{label}: the build did not keep the node records")
        check(c2["bvh_traverse_spatial"] - c1["bvh_traverse_spatial"] == 2,
              f"{label}: CSR query did not launch the spatial kernel twice")
        check(c3["bvh_traverse_knn"] - c2["bvh_traverse_knn"] == 1,
              f"{label}: kNN query did not launch the kNN kernel once")
        check(knn_calls[-1][0] is index.tree.records
              and knn_calls[-1][1] is None,
              f"{label}: the kNN kernel did not get the tree's records")
        check(len(spatial_calls) >= 2 and all(
            r is index.tree.records and o is None
            for r, o in spatial_calls[-2:]),
              f"{label}: the spatial kernel did not get the tree's records")
        if label == "points":
            # the self-kNN query: the points themselves, in the leaf order
            self_nn = index.query(rt.nearest(values, k=K))
            torch.cuda.synchronize()
            check(counts()["bvh_traverse_knn"] - c3["bvh_traverse_knn"] == 1,
                  "points: the self-kNN query did not launch the kNN kernel "
                  "once")
            check(knn_calls[-1][0] is index.tree.records
                  and knn_calls[-1][1] is index.tree.leaf_perm,
                  "points: the self-kNN query did not walk in the leaf order")
            check(bool((self_nn.distances[:, 0] == 0).all()),
                  "points: a self-kNN row does not start at distance 0")
            log(f"[main] points: self-kNN N=Q={N} k={K} through "
                "BVH.query(nearest): one kNN launch with the tree's records "
                "and its leaf order; every row starts at distance 0")
            # the self CSR query: spheres centred on the points themselves
            c4 = counts()
            self_csr = index.query(rt.intersects(G.Spheres(
                pts, torch.full((N,), RADIUS, device=dev))))
            torch.cuda.synchronize()
            check(counts()["bvh_traverse_spatial"]
                  - c4["bvh_traverse_spatial"] == 2,
                  "points: the self CSR query did not launch the spatial "
                  "kernel twice")
            check(all(r is index.tree.records and o is index.tree.leaf_perm
                      for r, o in spatial_calls[-2:]),
                  "points: the self CSR query did not walk in the leaf order")
            check_csr(self_csr, rt.BruteForce(values, policy=policy).query(
                rt.intersects(G.Spheres(pts[:N_CHECK], torch.full(
                    (N_CHECK,), RADIUS, device=dev)))), N_CHECK, "points self")
            log(f"[main] points: self CSR N=Q={N} through "
                "BVH.query(intersects(Spheres)): two spatial launches with "
                "the tree's records and its leaf order; "
                f"{int(self_csr.offsets[-1])} matches, {N_CHECK} queries "
                "equal to BruteForce")
        results[label] = (index, values, csr, nn)
    E.bvh_traverse_knn = real_knn
    E.bvh_traverse_spatial = real_spatial
    launches = counts()
    torch.cuda.synchronize()

    summary = {}
    for label, (index, values, csr, nn) in results.items():
        check(csr.offsets.shape == (Q + 1,) and not csr.overflow,
              f"{label}: bad CSR shape")
        check(bool((csr.indices >= 0).all() & (csr.indices < N).all()),
              f"{label}: CSR indices out of range")
        check(nn.distances.shape == (Q, K) and bool(torch.isfinite(nn.distances).all()),
              f"{label}: kNN shape or values")
        bf = rt.BruteForce(values, policy=policy)
        check_csr(csr, bf.query(sub_spheres), N_CHECK, label)
        if isinstance(values, G.Points):
            oracle = _oracle_knn(values.coords, values.coords, qc[:N_CHECK], K)
        else:
            oracle = _oracle_knn(values.lo, values.hi, qc[:N_CHECK], K)
        rel, bf_err, swapped = check_knn(nn, bf.query(sub_knn), oracle, label)
        total = int(csr.offsets[-1])
        log(f"[main] {label}: BVH N={N}; CSR Q={Q} {total} matches "
            f"(mean {total / Q:.2f}), {N_CHECK} queries equal to BruteForce; "
            f"kNN k={K}: max rel err vs float64 oracle {rel:.3g} (tol 1e-6), "
            f"max |d2| vs BruteForce {bf_err:.3g}, {swapped} tie swaps")
        summary[label] = index
    log(f"[main] launches in the main path: {json.dumps(launches)}")
    return launches, summary, spheres, knn, policy


def phase_timings(dev, pts, box_lo, box_hi, spheres, knn, policy, card):
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G

    out = {}
    for label, values in (("points", G.Points(pts)),
                          ("boxes", G.Boxes(box_lo, box_hi))):
        holder = {}

        def build():
            holder["index"] = rt.BVH(values, policy=policy)

        build_ms = time_ms(build, reps=3)
        index = holder["index"]
        # the first query of a fresh index: the build made the node
        # records, so it pays no pack
        _, first_ms = timed_once(lambda: index.query(spheres))
        q_ms = time_ms(lambda: index.query(spheres), reps=5)
        k_ms = time_ms(lambda: index.query(knn), reps=5)
        out[label] = dict(build_ms=build_ms, spatial_query_ms=q_ms,
                          knn_query_ms=k_ms)
        log(f"[time] {label}: build N={N} {build_ms:.2f} ms; "
            f"query(intersects(Spheres)) Q={Q} {q_ms:.2f} ms (the first "
            f"of the index {first_ms:.2f} ms); "
            f"query(nearest k={K}) Q={Q} {k_ms:.2f} ms  [{card}]")
    holder.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt.BVH(G.Points(pts), policy=policy)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[time] peak device memory of a Points build N={N}: "
        f"{peak / 2**20:.0f} MiB, {(peak - base) / 2**20:.1f} MiB above the "
        f"{base / 2**20:.0f} MiB allocated before it  [{card}]")
    return out


def same_bits(a, b):
    """a and b equal bit for bit, NaN by position (the twin's torch.minimum
    makes an all-ones NaN, the kernel keeps an operand's)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a[~nan].view(torch.int32), b[~nan].view(torch.int32)
    return torch.equal(a, b)


def same_tree(got, want, label):
    """Every LBVH field and the records of `got` equal to `want`'s."""
    import torch
    from repro_torch.core import lbvh as L
    for f in L.FIELDS:
        check(same_bits(getattr(got, f), getattr(want, f)),
              f"{label}: {f} differs from the twin's")
    if got.records is not None or want.records is not None:
        cols = [0, 1, 2, 4, 5, 6]
        check(same_bits(got.records[:, cols].view(torch.float32),
                        want.records[:, cols].view(torch.float32))
              and torch.equal(got.records[:, [3, 7]],
                              want.records[:, [3, 7]]),
              f"{label}: the records differ from the twin's")


def twin_build(boxes):
    """The build through the plain twins, on the boxes' device: the key
    (core.morton's quantize and interleave), the sort, the Karras twin,
    the tail twin (the RMQ sparse table, the closed forms, pack_nodes)."""
    import torch
    from repro_torch.core import lbvh as L
    from repro_torch.core import morton as M
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    n = boxes.lo.shape[0]
    key, perm = torch.sort(KM.morton_key_ref(boxes.lo, boxes.hi), stable=True)
    first, last, gamma = KB.karras_ranges_fused(*M.key_lanes(key), n,
                                                KB.max_log2(n))
    *fields, records = KB.lbvh_tail_ref(first, last, gamma, perm, boxes.lo,
                                        boxes.hi)
    return L._with_records(L.LBVH(*fields, first), records)


def tail_bytes(n, dim, records):
    """Bytes the tail must move, each input read once and each output
    written once: the ranges (3 int32 an internal node), the permutation
    (int64) and the leaf boxes; the node boxes, links, ropes, range_last,
    leaf_perm and (3-D) the 32-byte records."""
    inputs = 12 * (n - 1) + 8 * n + 2 * dim * 4 * n
    outputs = (2 * dim * 4 * (2 * n - 1) + 8 * (n - 1) + 8 * (2 * n - 1)
               + 4 * n + (32 * (2 * n - 1) if records else 0))
    return inputs + outputs


def phase_build_path(dev, pts, box_lo, box_hi, policy, card):
    """The card's builds node for node against the twins on the card:
    BVH(Points | Boxes | Triangles) at N = 2^20, a build over points with
    NaN coordinates, and a refit; then the tail kernel timed through its
    wrapper and alone beside its twin and its bytes bound. Returns the
    kernels line's record of the tail."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import lbvh as L
    from repro_torch.core import morton as M
    from repro_torch.kernels import _build
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    t0 = time.perf_counter()
    a, b, c, _, _ = make_soup(dev)
    for label, values in (("points", G.Points(pts)),
                          ("boxes", G.Boxes(box_lo, box_hi)),
                          ("triangles", G.Triangles(a, b, c))):
        got = rt.BVH(values, policy=policy).tree
        same_tree(got, twin_build(G.to_boxes(values)), label)
        log(f"[build] {label} N={N}: BVH's tree identical to the twins' on "
            "the card, every field and the node records (tolerance 0, NaN by "
            "place)")
    del a, b, c
    nan_pts = pts.clone()
    nan_pts[7, 0] = float("nan")
    nan_pts[N // 2, 2] = float("nan")
    nan_boxes = G.Boxes(nan_pts, nan_pts)
    got = L.build(nan_boxes)
    want = twin_build(nan_boxes)
    same_tree(got, want, "NaN points")
    check(bool(torch.isnan(got.node_lo[0]).any()),
          "NaN points: the root box lost the NaN")
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    moved = pts + 0.002 * torch.randn(pts.shape, generator=gen, device=dev)
    tree = L.build(G.Boxes(pts, pts))
    refit = L.refit(tree, G.Boxes(moved, moved))
    twin_lo, twin_hi, twin_rec = KB.lbvh_refit_ref(
        tree.left_child, tree.right_child, tree.rope, tree.range_first,
        tree.range_last, tree.leaf_perm, moved, moved)
    same_tree(refit, L._with_records(dataclasses.replace(
        tree, node_lo=twin_lo, node_hi=twin_hi), twin_rec), "refit")
    log(f"[build] NaN coordinates (2 points) and a refit of the points "
        f"(moved by N(0, 0.002^2)) N={N}: identical to the twins (NaN by "
        "place); the root box is NaN where a point is")

    # the tail kernel over the Boxes build's ranges
    key, perm = torch.sort(KM.morton_key(box_lo, box_hi), stable=True)
    first, last, gamma = KB.karras_ranges(*M.key_lanes(key), N,
                                          KB.max_log2(N))
    args = (first, last, gamma, perm, box_lo, box_hi)
    ms = time_ms(lambda: KB.lbvh_tail(*args), reps=20)
    out = KB.lbvh_tail(*args)
    scratch = torch.empty((4 * N - 3,), dtype=torch.int32, device=dev)
    entry = _build.function("lbvh_tail", "lbvh_tail_launch", KB._TAIL_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in args] + [N, 3] + \
        [t.data_ptr() for t in out] + [scratch.data_ptr(), stream]
    alone = time_ms(lambda: entry(*ptrs), reps=20)
    dev_ms = kernel_ms(lambda: entry(*ptrs), ("climb_kernel3",), reps=10)
    link_ms = kernel_ms(lambda: entry(*ptrs), ("link_kernel",), reps=10)
    plain = time_ms(lambda: KB.lbvh_tail_ref(*args), reps=3)
    want = KB.lbvh_tail_ref(*args)
    torch.cuda.synchronize()
    for g, w, f in zip(out, want, L.FIELDS[:7] + ("records",)):
        check(same_bits(g, w), f"lbvh_tail: {f} differs from its twin")
    b_ms, b_by = bound(tail_bytes(N, 3, True), 0)
    rmq = time_ms(lambda: KB.aabb_rmq(box_lo[perm], box_hi[perm], first,
                                      last, KB.max_log2(N)), reps=3)
    log(f"[build] lbvh_tail N={N} boxes: identical to its twin; "
        f"{ms:.4f} ms through the wrapper, the C entry alone {alone:.4f} ms "
        f"(device: link_kernel {fmt_ms(link_ms)}, climb_kernel3 "
        f"{fmt_ms(dev_ms)}); twin "
        f"{plain:.3f} ms (its aabb_rmq alone {rmq:.3f} ms); bound "
        f"{b_ms:.4f} ms ({b_by}); phase {time.perf_counter() - t0:.1f} s  "
        f"[{card}]")
    return dict(source="src/repro_torch/csrc/lbvh_tail.cu",
                replaces="src/repro/core/lbvh.py:247", max_abs_err=0,
                ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def profile_window(label, fn, card, share_of=None):
    """Run fn under torch.profiler: log the device-busy share of the
    window and the kernels that take the device time ("not measured" when
    the profiler sees no device activity); with `share_of`, also the share
    of device time of the kernels whose names contain it. Returns (busy
    share of the window, that share), None where not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side events only (the kernels themselves): the CPU ops that
    # launched them carry the same device time and would count it twice
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"[profile] {label}: device time not measured: the profiler saw "
            "no device activity")
        return None, None
    log(f"[profile] {label}: window {wall_us / 1e3:.2f} ms under the "
        f"profiler, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f} %)  [{card}]")
    for us, key, count in rows[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms  {count:5d}x  {key[:90]}")
    mine_us = None
    if share_of:
        mine = [r for r in rows if share_of in r[1]]
        mine_us = sum(r[0] for r in mine)
        log(f"[profile]   {share_of}: {mine_us / 1e3:.3f} ms in "
            f"{sum(r[2] for r in mine)} launches, "
            f"{100 * mine_us / busy:.1f} % of device time")
    return busy / wall_us, None if mine_us is None else mine_us / busy


def fmt_ms(ms):
    """A device time from kernel_ms for a log line."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def kernel_ms(fn, keys, reps):
    """Mean device milliseconds of the kernels whose names contain every
    string of `keys` per call of fn, over `reps` calls under torch.profiler; None when the
    profiler sees none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and all(k in e.key for k in keys))
    return us / 1e3 / reps if us else None


#: cycles of the spin that holds the stream in device_ms (about 50 ms at
#: the H100's 1.98 GHz)
SPIN_CYCLES = 10 ** 8


def device_ms(fn, reps):
    """Mean device milliseconds per call of fn, without the profiler: a
    spin kernel holds the stream while the host enqueues `reps` calls, so
    the events between them time the device's work alone, host gaps
    excluded. None when the host took longer to enqueue than the spin
    held the stream (or fn waited for the device)."""
    import torch
    fn()
    torch.cuda.synchronize()
    held, start, stop = (torch.cuda.Event(enable_timing=True)
                         for _ in range(3))
    held.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    if host_ms >= held.elapsed_time(start):
        return None
    return start.elapsed_time(stop) / reps


def phase_profile(pts, spheres, knn, policy, card):
    import repro_torch as rt
    from repro_torch.core import geometry as G

    def run():
        index = rt.BVH(G.Points(pts), policy=policy)
        index.query(spheres)
        index.query(knn)

    profile_window(f"build + CSR query + kNN query (Points, N={N}, Q={Q})",
                   run, card)


# ---------------------------------------------------------------------------
# slice 2: the callback kernel, DBSCAN and the loop route
# ---------------------------------------------------------------------------

SPHERE_RADIUS = 0.005
DB_BLOBS, DB_BLOB_PTS, DB_NOISE = 64, 15360, 1 << 16
DB_SIGMA, DB_EPS, DB_MIN_PTS = 0.01, 0.003, 3
Q_LOOP = 1 << 12


EPILOGUE_NAMES = ("counting", "count_with_limit", "min_distance",
                  "collect_first_k", "collect_hits", "min_where")


def _epilogues(n, dev):
    """name -> (cb, state0) of every epilogue; min_where over seeded
    flags and int32 weights of the index's N values."""
    import torch
    from repro_torch.core import callbacks as CB
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    flags = torch.rand((n,), generator=gen, device=dev) < 0.5
    weights = torch.randint(0, 1 << 30, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    return {"counting": CB.counting(), "count_with_limit": CB.count_with_limit(5),
            "min_distance": CB.min_distance(),
            "collect_first_k": CB.collect_first_k(8),
            "collect_hits": CB.collect_hits(32),
            "min_where": CB._min_where(flags, weights, 2**31 - 1)}


def _leaves(state):
    return state if isinstance(state, tuple) else (state,)


def _state_bytes(state):
    return sum(a.numel() * a.element_size() for a in _leaves(state))


def check_state(got, want, label):
    """Fail unless two callback states are bit-identical; return their
    largest absolute difference (0.0)."""
    import torch
    err = 0.0
    for x, y in zip(_leaves(got), _leaves(want)):
        check(x.dtype == y.dtype and x.shape == y.shape,
              f"{label}: state leaf {x.dtype} {tuple(x.shape)} against "
              f"{y.dtype} {tuple(y.shape)}")
        d = torch.where(x == y, 0.0, (x.double() - y.double()).abs())
        err = max(err, float(d.max()) if d.numel() else 0.0)
        check(torch.equal(x, y), f"{label}: differs from its twin (max abs "
              f"{err:.3g})")
    return err


def callback_bound(q, n, floats, state, leaves, extra_bytes=0):
    """Bound of one callback walk over 3-D sphere queries: the queries,
    every tree array and the N values (`floats` float32s each) once, the
    state read in and written out, any closed-over arrays, and one leaf
    test per leaf the answer needs."""
    return bound(q * 4 * 4 + tree_bytes(n, 3, True) + n * floats * 4
                 + 2 * _state_bytes(state) + extra_bytes, leaves * leaf_ops(3))


def phase_callback_kernel(dev, pts, box_lo, box_hi, qc, policy, card):
    """bvh_traverse_callback against its twin for every epilogue at
    Q = 2^17, with the kernel's time beside the bound. Returns the largest
    absolute difference seen."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core.index import _bcast_state
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import bvh_traverse as T

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    radii = torch.full((N,), SPHERE_RADIUS, device=dev)
    indexes = (("points", G.Points(pts), 3),
               ("boxes", G.Boxes(box_lo, box_hi), 6),
               ("spheres", G.Spheres(torch.rand((N, 3), generator=gen,
                                                device=dev), radii), 4))
    preds = rt.intersects(G.Spheres(qc, torch.full((Q,), RADIUS, device=dev)))
    max_err = 0.0
    for label, values, floats in indexes:
        index = rt.BVH(values, policy=policy)
        t = index.tree
        tree = (t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm)
        names = ("counting",) if label == "spheres" else (
            "counting", "count_with_limit", "min_distance", "collect_first_k",
            "collect_hits", "min_where")
        epilogues = _epilogues(N, dev)
        counts = None
        for name in names:
            cb, s0 = epilogues[name]
            s0q = _bcast_state(s0, Q, dev)
            full = KC.bvh_traverse_callback(*tree, values, preds, cb, s0q)
            want, plain = timed_once(lambda: KC.bvh_traverse_callback_ref(
                *tree, values, preds, cb, s0q))
            max_err = max(max_err, check_state(
                full, want, f"bvh_traverse_callback {label}/{name} Q={Q}"))
            ms = time_ms(lambda: KC.bvh_traverse_callback(
                *tree, values, preds, cb, s0q, records=t.records), reps=10)
            if name == "counting":
                counts = full.to(torch.int64)
                if label != "spheres":
                    # the spatial kernel, held against its twin above,
                    # counts the same matches
                    sp, _ = T.bvh_traverse_spatial(
                        t.node_lo, t.node_hi, t.rope, t.left_child,
                        t.range_last, t.leaf_perm, qc, qc, preds.geom.radius,
                        capacity=1, fine_sqrt=label == "points",
                        records=t.records)
                    check(torch.equal(sp.to(torch.int64), counts),
                          f"callback counting ({label}) differs from the "
                          "spatial kernel's counts")
            # leaves the answer needs: every match, except where the
            # epilogue stops at a limit
            cap = {"count_with_limit": 5, "collect_first_k": 8}.get(name)
            leaves = int((counts.clamp_max(cap) if cap else counts).sum())
            b_ms, b_by = callback_bound(
                Q, N, floats, full, leaves,
                N * 5 if name == "min_where" else 0)
            log(f"[callback] {label} {name} N={N} Q={Q}: identical to twin "
                f"(tolerance 0); {ms:.3f} ms vs twin {plain:.1f} ms; "
                f"{leaves} leaves needed; bound {b_ms:.4f} ms ({b_by})  "
                f"[{card}]")
        del index, t, tree
    return max_err


def make_cloud(dev):
    """DBSCAN's cloud: 64 Gaussian blobs and uniform noise, 2^20 points."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    centres = 0.1 + 0.8 * torch.rand((DB_BLOBS, 3), generator=gen, device=dev)
    blobs = (centres[:, None, :] + DB_SIGMA * torch.randn(
        (DB_BLOBS, DB_BLOB_PTS, 3), generator=gen, device=dev)).reshape(-1, 3)
    noise = torch.rand((DB_NOISE, 3), generator=gen, device=dev)
    return torch.cat([blobs, noise]).contiguous()


def dbscan_oracle(coords, policy):
    """(labels, is_core, neighbour counts) from the CSR of every point's
    eps-neighbourhood through the spatial kernel and scipy's connected
    components over core-core edges: clusters labelled by their min index,
    border points by the min label among their core neighbours, noise -1.
    Independent of the callback code."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import connected_components
    import repro_torch as rt
    from repro_torch.core import geometry as G

    n = coords.shape[0]
    dev = coords.device
    index = rt.BVH(G.Points(coords), policy=policy)
    res = index.query(rt.intersects(G.Spheres(
        coords, torch.full((n,), DB_EPS, device=dev))))
    counts = res.offsets.diff().to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), counts)
    cols = res.indices.to(torch.int64)
    core = counts >= DB_MIN_PTS
    cc = core[rows] & core[cols]
    r, c = rows[cc].cpu().numpy(), cols[cc].cpu().numpy()
    graph = sp.csr_matrix((np.ones(r.shape[0], np.int8), (r, c)), shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    big = np.iinfo(np.int64).max
    # component ids run 0.., and a component's first index is its min
    _, first = np.unique(comp, return_index=True)
    core_np = core.cpu().numpy()
    labels = np.where(core_np, first[comp], big)
    lab = torch.from_numpy(labels).to(dev)
    # border points: min label among core neighbours
    bc = ~core[rows] & core[cols]
    border = torch.full((n,), big, dtype=torch.int64, device=dev)
    border.scatter_reduce_(0, rows[bc], lab[cols[bc]], "amin")
    lab = torch.where(core, lab, border)
    lab = torch.where(lab == big, -1, lab)
    return lab, core, counts


def _registers(src, fn):
    """"R registers, S B spill stores" of one kernel instance of `src`,
    from its build log."""
    from repro_torch.kernels import _build
    for name, regs, spill in _ptxas_summary(_build.build_log(src)):
        if name == fn:
            return f"{regs} registers, {spill} B spill stores"
    fail(f"{src}: no build-log entry for {fn}")


# bytes a 3-D walk gathered per leaf hit before the packed records and
# min_where's one weight (leaf_perm, the point, and min_where's flag and
# weight) and after them (min_where's one weight)
LEAF_BYTES_BEFORE = {"count_with_limit": 4 + 12, "min_where": 4 + 12 + 1 + 4}
LEAF_BYTES_AFTER = {"count_with_limit": 0, "min_where": 4}


def dbscan_walks(coords, is_core, counts, policy, card):
    """The two callback walks of DBSCAN at Q = N on its cloud, each
    against its twin: the core-point pass (count_with_limit(min_pts)) and
    the first hook round (min_where over the oracle's core flags and the
    initial labels). Each is timed as the wrapper call, which the kernels
    line reports, and as the kernel's device time alone (torch.profiler),
    with the wrapper's steps (the walk order, the node records,
    min_where's weights) and the twin's node visits per query. Returns
    the kernels-line record of the min_where walk, the one every hook
    round runs."""
    import torch
    import repro_torch as rt
    from repro_torch.core import callbacks as CB
    from repro_torch.core import geometry as G
    from repro_torch.core.dbscan import _BIG
    from repro_torch.core.index import _bcast_state
    from repro_torch.kernels import bvh_callback as KC

    n = coords.shape[0]
    dev = coords.device
    index = rt.BVH(G.Points(coords), policy=policy)
    t = index.tree
    tree = (t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
            t.leaf_perm)
    radii = torch.full((n,), DB_EPS, device=dev)
    preds = rt.intersects(G.Spheres(coords, radii))
    order_ms = time_ms(lambda: KC.query_order(preds, index.values,
                                              t.leaf_perm), reps=5)
    check(KC.query_order(preds, index.values, t.leaf_perm) is t.leaf_perm,
          "dbscan: the walk order of the indexed points is not leaf_perm")
    pack_ms = time_ms(lambda: KC.pack_nodes(
        t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm), reps=5)
    labels0 = torch.where(is_core, torch.arange(n, dtype=torch.int32,
                                                device=dev), _BIG)
    walks = (("count_with_limit", CB.count_with_limit(DB_MIN_PTS),
              counts.clamp_max(DB_MIN_PTS), 0, "CountWithLimit"),
             ("min_where", CB._min_where(is_core, labels0, _BIG), counts,
              n * 5, "MinWhere"))
    record = None
    for name, (cb, s0), need, extra, ep in walks:
        s0q = _bcast_state(s0, n, dev)
        got = KC.bvh_traverse_callback(*tree, index.values, preds, cb, s0q)
        stats = {}
        want, plain = timed_once(lambda: KC.bvh_traverse_callback_ref(
            *tree, index.values, preds, cb, s0q, stats=stats))
        err = check_state(got, want, f"bvh_traverse_callback dbscan/{name} "
                          f"Q={n}")
        def wrapper():
            return KC.bvh_traverse_callback(*tree, index.values, preds, cb,
                                            s0q, records=t.records)

        ms = time_ms(wrapper, reps=5)
        alone = kernel_ms(wrapper, ("callback_kernel3<", ep), reps=5)
        alone = "not measured" if alone is None else f"{alone:.3f} ms"
        steps = f"order {order_ms:.4f} ms (leaf_perm)"
        if name == "min_where":
            where_ms = time_ms(lambda: KC.min_where_weights(cb), reps=5)
            steps += f", weights {where_ms:.4f} ms"
        leaves = int(need.sum())
        hits = int(counts.sum()) if name == "min_where" else leaves
        b_ms, b_by = callback_bound(n, n, 3, got, leaves, extra)
        log(f"[dbscan] walk {name} N=Q={n}: identical to twin (tolerance "
            f"0); wrapper {ms:.3f} ms; the kernel alone {alone} "
            f"(callback_kernel3<{ep}>: "
            f"{_registers('bvh_callback', f'callback_kernel3<256, {ep}>')}, "
            f"profiler device time); the wrapper's steps: {steps}; the node "
            f"records written by the build (pack_nodes alone {pack_ms:.3f} "
            f"ms); twin "
            f"{plain:.1f} ms; {stats['visits'] / n:.1f} node visits and "
            f"{hits / n:.2f} leaf hits per query, leaf gathers "
            f"{hits / n * LEAF_BYTES_BEFORE[name]:.1f} -> "
            f"{hits / n * LEAF_BYTES_AFTER[name]:.1f} B per query; "
            f"{leaves} leaves needed; bound {b_ms:.4f} ms ({b_by})  [{card}]")
        record = dict(source="src/repro_torch/csrc/bvh_callback.cu",
                      replaces="src/repro/kernels/bvh_callback.py:251",
                      max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                      bound_by=b_by)
    return record


def phase_dbscan(dev, policy, card):
    """Both DBSCAN algorithms at 2^20 points against the oracle, after
    its two callback walks against their twins. Returns the launch counts
    of the two runs (counters zeroed just before) and the min_where
    walk's kernels-line record."""
    import torch
    import repro_torch as rt
    from repro_torch.core.dbscan import _dense_cells
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB

    coords = make_cloud(dev)
    n = coords.shape[0]
    t0 = time.perf_counter()
    want_labels, want_core, counts = dbscan_oracle(coords, policy)
    oracle_s = time.perf_counter() - t0
    _, dense = _dense_cells(coords, DB_EPS, DB_MIN_PTS)
    log(f"[dbscan] cloud N={n}: {DB_BLOBS} blobs x {DB_BLOB_PTS} (sigma "
        f"{DB_SIGMA}) + {DB_NOISE} noise; eps={DB_EPS} min_pts={DB_MIN_PTS}; "
        f"neighbours (self included) mean {float(counts.double().mean()):.2f}, "
        f"max {int(counts.max())}; {float(dense.double().mean()) * 100:.1f} % "
        f"of points in dense cells; {int(want_core.sum())} core points, "
        f"{int(torch.unique(want_labels[want_labels >= 0]).numel())} clusters, "
        f"{int((want_labels < 0).sum())} noise; oracle {oracle_s:.1f} s")
    record = dbscan_walks(coords, want_core, counts, policy, card)
    counters = {"karras_ranges": KB.karras_ranges,
                "bvh_traverse_spatial": T.bvh_traverse_spatial,
                "bvh_traverse_knn": T.bvh_traverse_knn,
                "bvh_traverse_callback": KC.bvh_traverse_callback}
    for f in counters.values():
        f.launches = 0
    for algorithm in ("fdbscan", "fdbscan-densebox"):
        engine = rt.QueryEngine()
        before = KC.bvh_traverse_callback.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels, core = rt.dbscan(coords, DB_EPS, DB_MIN_PTS,
                                 algorithm=algorithm,
                                 policy=policy.override(engine=engine))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = KC.bvh_traverse_callback.launches - before
        check(torch.equal(core, want_core),
              f"dbscan {algorithm}: core flags differ from the oracle "
              f"({int((core != want_core).sum())} points)")
        check(torch.equal(labels.to(torch.int64), want_labels),
              f"dbscan {algorithm}: labels differ from the oracle "
              f"({int((labels.to(torch.int64) != want_labels).sum())} points)")
        # core points, one launch per hook round, the border round
        check(launched == engine.callback_batches["kernel"] and launched >= 3,
              f"dbscan {algorithm}: {launched} callback-kernel launches for "
              f"{engine.callback_batches['kernel']} kernel-route batches")
        check(engine.callback_batches["loop"] == 0,
              f"dbscan {algorithm}: {engine.callback_batches['loop']} "
              "callback batches took the loop route")
        log(f"[dbscan] {algorithm}: {ms:.1f} ms (build + core + rounds + "
            f"border, host clock after synchronize); {launched - 2} hook "
            f"rounds; {launched} callback-kernel launches; "
            f"{engine.callback_batches['loop']} loop-route batches; labels "
            f"and core flags equal to the oracle  [{card}]")
    launches = {k: f.launches for k, f in counters.items()}
    log(f"[dbscan] launches in the DBSCAN path: {json.dumps(launches)}")
    profile_window(f"dbscan fdbscan N={n}", lambda: rt.dbscan(
        coords, DB_EPS, DB_MIN_PTS, policy=policy), card)
    return launches, record


def phase_loop_route(dev, pts, qc, policy):
    """A plain callable through the loop route on the card, against the
    CSR result summed in the walk's order."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G

    engine = rt.QueryEngine()
    index = rt.BVH(G.Points(pts), policy=policy.override(engine=engine))
    preds = rt.intersects(G.Spheres(qc[:Q_LOOP], torch.full(
        (Q_LOOP,), RADIUS, device=dev)))
    cb = rt.callbacks.sum_payload(lambda p, v: v.coords[:, 0])
    t0 = time.perf_counter()
    got = index.query(preds, callback=(cb, 0.0))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(engine.callback_batches == {"kernel": 0, "loop": 1},
          f"sum_payload did not take the loop route: {engine.callback_batches}")
    res = index.query(preds)            # kernel fill: the walk's order
    cnt = res.offsets.diff().to(torch.int64)
    x = res.values.coords[:, 0]
    start = res.offsets[:-1].to(torch.int64)
    want = torch.zeros((Q_LOOP,), dtype=torch.float32, device=dev)
    for j in range(int(cnt.max())):
        live = cnt > j
        want[live] = want[live] + x[start[live] + j]
    check(got.dtype == torch.float32 and torch.equal(got, want),
          f"loop-route sums differ from the CSR sums (max "
          f"{float((got - want).abs().max()):.3g})")
    log(f"[loop] sum_payload Q={Q_LOOP} on the card: {ms:.1f} ms through "
        f"the loop route, equal to the CSR sums in walk order (tolerance 0); "
        f"route counts {json.dumps(engine.callback_batches)}")


# ---------------------------------------------------------------------------
# slice 3: ray tracing (the callback kernel's ray kinds, ray_box_nearest)
# ---------------------------------------------------------------------------

TRI_HALF = 0.01          # b, c = a + U(-TRI_HALF, TRI_HALF)^3
R_RAYS = 1 << 17
EDGE_MARGIN = 1e-5       # float64 barycentric / t distance of a near-edge pair
# A sphere pair is near the rim when, in float64, the discriminant
# b^2 - d.d c lies within RIM_DISC d.d (|o-c|^2 + r^2) of 0, or
# c = |o-c|^2 - r^2 within RIM_C (|o-c|^2 + r^2) of 0: the first-order
# float32 error bound of either order (the walk's fused one, brute
# force's eager one). o - c costs one rounding u = 2^-24, the sums of
# three products up to three more, and b^2 <= d.d |o-c|^2, so the
# discriminant is off by at most about 22 u d.d (|o-c|^2 + r^2), and c by
# about 6 u (|o-c|^2 + r^2) plus the root's rounding near t = 0.
RIM_DISC = 24 * 2.0 ** -24
RIM_C = 12 * 2.0 ** -24

# operations of one leaf test, counted from csrc/bvh_callback.cu: the slab
# test (2 subtractions, 2 products, min, max and the two running extrema
# per dimension, then clamp and compare), the quadratic and Moller-Trumbore
RAY_LEAF_OPS = {"boxes": 8 * 3 + 3, "spheres": 3 * 9 + 12, "triangles": 50}
RAY_VALUE_FLOATS = {"boxes": 6, "spheres": 4, "triangles": 9}


# FP32 instructions one 3-D slab test issues in ray_box3_kernel, counted
# from its source: per axis two subtractions, two products and the
# entry / exit min and max, then the running max and min on axes 1 and
# 2 (22); t = max(tmin, 0) (2), the hit and best compares (2) and the
# two selects of the update (2)
RAY_BOX_ISSUE = 28


def _max_sm_clock_mhz():
    """The card's maximum SM clock (nvidia-smi), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi clocks: {out.stderr.strip()}")
    return int(out.stdout.split()[0])


def make_soup(dev):
    """bench_raytracing.py's scene at N = 2^20: a uniform in the unit cube,
    b and c = a + U(-0.01, 0.01)^3 (the triangle size tied to the mean
    spacing); R = 2^17 rays from uniform origins with standard-normal
    directions."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    a = torch.rand((N, 3), generator=gen, device=dev)
    b = a + TRI_HALF * (2 * torch.rand((N, 3), generator=gen, device=dev) - 1)
    c = a + TRI_HALF * (2 * torch.rand((N, 3), generator=gen, device=dev) - 1)
    o = torch.rand((R_RAYS, 3), generator=gen, device=dev)
    d = torch.randn((R_RAYS, 3), generator=gen, device=dev)
    return a, b, c, o, d


def ray_bound(r, n, vkind, state, leaves):
    """Bound of one ray callback walk: the rays, every tree array and the
    N values once, the state read in and written out, and one leaf test
    per hit the answer needs."""
    return bound(r * 6 * 4 + tree_bytes(n, 3, True)
                 + n * RAY_VALUE_FLOATS[vkind] * 4 + 2 * _state_bytes(state),
                 leaves * RAY_LEAF_OPS[vkind])


def _tri64(o, d, a, b, c):
    """Float64 Moller-Trumbore over broadcasting (..., 3) tensors, without
    the port's code: (hit, near), `near` marking pairs within EDGE_MARGIN
    of an edge, of t = 0 or of the det threshold."""
    import torch
    dx, dy, dz = d.double().unbind(-1)
    a = a.double()
    e1 = (b.double() - a).unbind(-1)
    e2 = (c.double() - a).unbind(-1)
    tv = (o.double() - a).unbind(-1)
    p = (dy * e2[2] - dz * e2[1], dz * e2[0] - dx * e2[2],
         dx * e2[1] - dy * e2[0])
    det = e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2]
    inv = 1.0 / torch.where(det.abs() < 1e-12, 1e-12, det)
    u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv
    qv = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0])
    v = (dx * qv[0] + dy * qv[1] + dz * qv[2]) * inv
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
    hit = ((det.abs() > 1e-12) & (u >= -1e-7) & (v >= -1e-7)
           & (u + v <= 1 + 1e-7) & (t >= 0))
    edge = torch.minimum(torch.minimum((u + 1e-7).abs(), (v + 1e-7).abs()),
                         (1 + 1e-7 - u - v).abs())
    near = ((edge < EDGE_MARGIN) | (t.abs() < EDGE_MARGIN)
            | ((det.abs() - 1e-12).abs() < 1e-9))
    return hit, near


def _triangle_oracle(o, d, a, b, c, block=32):
    """(hit, near) (R, N) of every (ray, triangle) pair in float64."""
    import torch
    hits, nears = [], []
    for s in range(0, o.shape[0], block):
        h, nr = _tri64(o[s:s + block, None], d[s:s + block, None], a[None],
                       b[None], c[None])
        hits.append(h)
        nears.append(nr)
    return torch.cat(hits), torch.cat(nears)


def _pair_keys(off, idx, n):
    """Sorted (ray * n + index) keys of a CSR result."""
    import torch
    off = off.to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(off.shape[0] - 1,
                                                device=off.device),
                                   off[1:] - off[:-1])
    return torch.sort(rows * n + idx.to(torch.int64)).values


def _set_differences(res_a, res_b, n):
    """(ray, index) keys in one CSR result and not the other."""
    import torch
    ka = _pair_keys(res_a.offsets, res_a.indices, n)
    kb = _pair_keys(res_b.offsets, res_b.indices, n)
    both = torch.cat([ka, kb])
    uniq, cnt = torch.unique(both, return_counts=True)
    return uniq[cnt == 1]


def _near_boundary(vkind, values, o, d, keys, n):
    """Float64 check of (ray, index) pairs: is each within the stated
    margin of its value's boundary (a triangle edge, a sphere's rim)?
    Returns (near, the largest share of its margin any pair reaches)."""
    import torch
    ray, j = keys // n, keys % n
    oo, dd = o[ray].double(), d[ray].double()
    if vkind == "spheres":
        oc = oo - values.center[j].double()
        r2 = values.radius[j].double() ** 2
        d2 = (dd * dd).sum(1)
        s = (oc * oc).sum(1)
        disc = (oc * dd).sum(1) ** 2 - d2 * (s - r2)
        share = torch.minimum(disc.abs() / (RIM_DISC * d2 * (s + r2)),
                              (s - r2).abs() / (RIM_C * (s + r2)))
        return share <= 1, float(share.max()) if share.numel() else 0.0
    if vkind == "triangles":
        return _tri64(oo, dd, values.a[j], values.b[j], values.c[j])[1], None
    return torch.zeros_like(ray, dtype=torch.bool), None


def _first_hits_t(ord_t, off, counts, k):
    """(R, k): each ray's first k entries of cast_ordered's t, inf past
    its hits."""
    import torch
    j = torch.arange(k, device=ord_t.device)
    pos = (off[:-1, None].to(torch.int64) + j).clamp_max(
        max(ord_t.shape[0] - 1, 0))
    return torch.where(counts[:, None] > j, ord_t[pos], float("inf"))


def phase_rays(dev, box_lo, box_hi, policy, card):
    """Slice 3 end to end: the three cast_* entry points over a BVH of the
    triangle soup and ray_box_nearest over its bounding boxes (counters
    zeroed just before, read just after), then every ray instance of the
    callback kernel against its twin on all R rays, over the soup, the
    Boxes and the Spheres indexes, the sets against BruteForce and a
    float64 oracle, and ray_box_nearest against its twin and
    cast_nearest(k=1) on all R rays.
    Returns (launches, records for the kernels line)."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    from repro_torch.core.index import _bcast_state
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import ray_box as KR

    t0 = time.perf_counter()
    a, b, c, o, d = make_soup(dev)
    soup = G.Triangles(a, b, c)
    rays = G.Rays(o, d)
    tlo, thi = G.to_boxes(soup).lo, G.to_boxes(soup).hi
    counters = {"karras_ranges": KB.karras_ranges,
                "bvh_traverse_spatial": T.bvh_traverse_spatial,
                "bvh_traverse_knn": T.bvh_traverse_knn,
                "bvh_traverse_ray_knn": T.bvh_traverse_ray_knn,
                "bvh_traverse_callback": KC.bvh_traverse_callback,
                "ray_box_nearest": KR.ray_box_nearest}

    # -- the main path, counters zeroed just before and read just after ----
    engine = rt.QueryEngine()
    pol = policy.override(engine=engine)
    for f in counters.values():
        f.launches = 0
    t1 = time.perf_counter()
    index = rt.BVH(soup, policy=pol)
    c_build = counters["bvh_traverse_callback"].launches
    (_, hit_i, hit_off), inter_ms = timed_once(
        lambda: rt.raytracing.cast_intersect(index, rays))
    c_inter = KC.bvh_traverse_callback.launches
    (ord_i, ord_t, ord_off), ord_ms = timed_once(
        lambda: rt.raytracing.cast_ordered(index, rays))
    c_ord = KC.bvh_traverse_callback.launches
    batches = dict(engine.callback_batches)
    nearest = {}
    for k in (1, 4):
        nearest[k] = timed_once(lambda: rt.raytracing.cast_nearest(
            index, rays, k=k))
    (box_t, box_i), box_ms = timed_once(
        lambda: rt.kernels.ray_box_nearest(o, d, tlo, thi))
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    path_s = time.perf_counter() - t1
    check(c_build == 0, "BVH(Triangles) launched the callback kernel")
    check(c_inter - c_build == 2 and c_ord - c_inter == 2,
          f"cast_intersect / cast_ordered launched the callback kernel "
          f"{c_inter - c_build} / {c_ord - c_inter} times, not 2 each")
    check(batches == {"kernel": 4, "loop": 0},
          f"the ray epilogue batches took the loop route: {batches}")
    check(engine.callback_batches == batches
          and launches["bvh_traverse_knn"] == 0
          and launches["bvh_traverse_callback"] == 4
          and launches["bvh_traverse_ray_knn"] == 2,
          "cast_nearest k = 1 and 4 did not launch the ray kNN kernel once "
          f"each: {json.dumps(launches)}")
    check(launches["ray_box_nearest"] == 1, "ray_box_nearest did not launch")
    route = engine.route_knn(index, P.RayNearest(rays, 1))
    check(route == "kernel", f"cast_nearest routed to {route}")
    counts = hit_off.diff().to(torch.int64)
    log(f"[rays] soup N={N} (b, c = a + U(-{TRI_HALF}, {TRI_HALF})^3), "
        f"R={R_RAYS}: hits per ray mean {float(counts.double().mean()):.3f}, "
        f"max {int(counts.max())}, {int((counts == 0).sum())} rays without "
        f"a hit; main path {path_s:.1f} s; launches "
        f"{json.dumps(launches)}; callback batches {json.dumps(batches)}")
    log(f"[rays] cast_intersect R={R_RAYS}: {inter_ms:.2f} ms; cast_ordered: "
        f"{ord_ms:.2f} ms (CUDA events, one call each, two callback-kernel "
        f"launches each)  [{card}]")
    for k, ((tk, ik), ms) in nearest.items():
        log(f"[rays] cast_nearest k={k} R={R_RAYS} (route {route}, one ray "
            f"kNN kernel launch): {ms:.3f} ms  [{card}]")
    log(f"[rays] ray_box_nearest R={R_RAYS} B={N}: {box_ms:.2f} ms, "
        f"{int((box_i >= 0).sum())} rays hit a box  [{card}]")

    # -- results: shapes, order, sets ---------------------------------------
    check(ord_off.shape == (R_RAYS + 1,) and torch.equal(ord_off, hit_off),
          "cast_ordered and cast_intersect counts differ")
    ok = torch.ones((), dtype=torch.bool, device=dev)
    seg = torch.repeat_interleave(torch.arange(R_RAYS, device=dev), counts)
    same_ray = seg[1:] == seg[:-1]
    ok &= ((ord_t[1:] >= ord_t[:-1]) | ~same_ray).all()
    check(bool(ok) and bool(torch.isfinite(ord_t).all()),
          "cast_ordered is not ascending in t within a ray")
    keys = _pair_keys(hit_off, hit_i, N)
    check(torch.equal(_pair_keys(ord_off, ord_i, N), keys),
          "cast_ordered and cast_intersect hold different sets")
    for k, ((tk, ik), _) in nearest.items():
        check(tk.shape == (R_RAYS, k) and torch.equal(torch.isinf(tk), ik < 0),
              f"cast_nearest k={k}: shape or padding")
        check(torch.equal(tk, _first_hits_t(ord_t, hit_off, counts, k)),
              f"cast_nearest k={k}: t differs from cast_ordered's first "
              f"{k} hits")
        found = ik >= 0
        kk = (torch.arange(R_RAYS, device=dev)[:, None] * N
              + ik.to(torch.int64))[found]
        at = torch.searchsorted(keys, kk).clamp_max(keys.shape[0] - 1)
        check(bool((keys[at] == kk).all()),
              f"cast_nearest k={k}: an index outside cast_intersect's set")

    # -- the ray kNN kernel against its twin on all R rays, k = 4, and its
    #    records' cost ---------------------------------------------------------
    t_ = index.tree
    knn_tree = (t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.leaf_perm)
    stats = {}
    (want_t, want_i), knn_plain = timed_once(
        lambda: T.bvh_traverse_ray_knn_ref(*knn_tree, soup, rays, k=4,
                                           stats=stats))
    tk, ik = nearest[4][0]
    check(torch.equal(tk, want_t) and torch.equal(ik, want_i),
          f"cast_nearest k=4 differs from the twin on "
          f"{int((~((tk == want_t) & (ik == want_i)).all(1)).sum())} rays")
    visits = stats["visits"] / R_RAYS
    del want_t, want_i
    rec, vrec = t_.records, index.value_records
    _, pack_ms = timed_once(lambda: T.pack_values(soup, t_.leaf_perm))
    _, node_pack_ms = timed_once(lambda: T.pack_nodes(*knn_tree))
    knn_ms = {k: time_ms(lambda: T.bvh_traverse_ray_knn(
        *knn_tree, soup, rays, k=k, records=rec, value_records=vrec), reps=5)
        for k in (1, 4, 10)}
    hits4 = int(torch.isfinite(tk).sum())
    # bytes: the rays, the tree and the values once, the (R, k) outputs;
    # operations: one triangle test per hit returned
    kb_ms, kb_by = bound(R_RAYS * 6 * 4 + tree_bytes(N, 3, True)
                         + N * RAY_VALUE_FLOATS["triangles"] * 4
                         + R_RAYS * 4 * 8, hits4 * RAY_LEAF_OPS["triangles"])
    regs = _registers("ray_knn",
                      "ray_knn_kernel<Records3, LeafTriangle3, KeyList 4>")
    log(f"[rays] ray kNN kernel (cast_nearest) N={N} R={R_RAYS}: k=4 all "
        f"{R_RAYS} rays identical to the twin (tolerance 0; twin "
        f"{knn_plain:.1f} ms, {visits:.1f} node visits per ray, the "
        f"kernel's own node sequence); {', '.join(f'k={k} {ms:.3f} ms' for k, ms in knn_ms.items())} "
        f"(CUDA events, records kept); bound at k=4 {kb_ms:.4f} ms "
        f"({kb_by}; {hits4} hits); ray_knn_kernel<Records3, LeafTriangle3, "
        f"KeyList 4> {regs}; packs: value records {pack_ms:.3f} ms "
        f"({N * 48} bytes); the node records come with the build "
        f"(pack_nodes alone {node_pack_ms:.3f} ms)  [{card}]")
    knn_record = dict(source="src/repro_torch/csrc/ray_knn.cu",
                      replaces="src/repro/core/engine.py:590",
                      max_abs_err=0.0, ms=knn_ms[4], plain_ms=knn_plain,
                      bound_ms=kb_ms, bound_by=kb_by)
    del t_, knn_tree

    # -- every ray instance of the callback kernel against its twin, on all
    #    R rays, and ray_box_nearest's cast_nearest(k=1) check -------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    targets = (("triangles", index),
               ("boxes", rt.BVH(G.Boxes(box_lo, box_hi), policy=policy)),
               ("spheres", rt.BVH(G.Spheres(
                   torch.rand((N, 3), generator=gen, device=dev),
                   torch.full((N,), SPHERE_RADIUS, device=dev)),
                   policy=policy)))
    box_index = rt.BVH(G.Boxes(tlo, thi), policy=policy)
    preds = P.RayIntersect(rays)
    record, max_err = None, 0.0
    for vkind, idx in targets:
        t_ = idx.tree
        tree = (t_.node_lo, t_.node_hi, t_.rope, t_.left_child,
                t_.range_last, t_.leaf_perm)
        # the committed design's inputs, as the engine passes them
        kept = dict(records=t_.records, value_records=idx.value_records)
        if vkind != "triangles":
            stats = {}
            (want_t, want_i), plain = timed_once(
                lambda: T.bvh_traverse_ray_knn_ref(
                    t_.node_lo, t_.node_hi, t_.rope, t_.left_child,
                    t_.leaf_perm, idx.values, rays, k=4, stats=stats))
            (got_t, got_i), ms = timed_once(
                lambda: rt.raytracing.cast_nearest(idx, rays, k=4))
            check(torch.equal(got_t, want_t) and torch.equal(got_i, want_i),
                  f"cast_nearest over {vkind} differs from the twin")
            log(f"[rays] cast_nearest {vkind} k=4 R={R_RAYS}: {ms:.3f} ms, "
                f"all rays identical to the twin (twin {plain:.1f} ms, "
                f"{stats['visits'] / R_RAYS:.1f} node visits per ray in its "
                f"rope walk)  [{card}]")
            del want_t, want_i, got_t, got_i
        epilogues = _epilogues(N, dev)
        cb, s0 = epilogues["counting"]
        hits = KC.bvh_traverse_callback(*tree, idx.values, preds, cb,
                                        _bcast_state(s0, R_RAYS, dev), **kept
                                        ).to(torch.int64)
        if vkind == "triangles":
            check(torch.equal(hits, counts), "the counting walk differs "
                  "from cast_intersect's counts")
        for name in EPILOGUE_NAMES:
            cb, s0 = epilogues[name]
            s0q = _bcast_state(s0, R_RAYS, dev)
            full = KC.bvh_traverse_callback(*tree, idx.values, preds, cb, s0q,
                                            **kept)
            want, plain = timed_once(lambda: KC.bvh_traverse_callback_ref(
                *tree, idx.values, preds, cb, s0q))
            max_err = max(max_err, check_state(
                full, want, f"bvh_traverse_callback rays/{vkind}/{name}"))
            del want
            ms = time_ms(lambda: KC.bvh_traverse_callback(
                *tree, idx.values, preds, cb, s0q, **kept), reps=5)
            cap = {"count_with_limit": 5, "collect_first_k": 8}.get(name)
            leaves = int((hits.clamp_max(cap) if cap else hits).sum())
            b_ms, b_by = ray_bound(R_RAYS, N, vkind, full, leaves)
            log(f"[rays] walk {vkind} {name} N={N} R={R_RAYS}: {ms:.3f} ms; "
                f"all {R_RAYS} rays identical to twin (tolerance 0), twin "
                f"{plain:.1f} ms; {leaves} hits needed; bound {b_ms:.4f} ms "
                f"({b_by})  [{card}]; {time.perf_counter() - t0:.1f} s into "
                f"the phase")
            if vkind == "triangles" and name == "counting":
                log(f"[rays] ray_kernel3<Counting> "
                    f"({_registers('bvh_callback', 'ray_kernel3<256, Counting>')})")
                record = dict(source="src/repro_torch/csrc/bvh_callback.cu",
                              replaces="src/repro/kernels/bvh_callback.py:251",
                              ms=ms, plain_ms=plain, bound_ms=b_ms,
                              bound_by=b_by)
        del t_, tree
    record["max_abs_err"] = max_err

    # -- the sets on N_CHECK rays against BruteForce and a float64 oracle --
    for vkind, idx in targets:
        bf = rt.BruteForce(idx.values, policy=policy)
        sub_rays = rays.index(slice(0, N_CHECK))
        mine = idx.query(P.RayIntersect(sub_rays))
        ref = bf.query(P.RayIntersect(sub_rays))
        diff = _set_differences(mine, ref, N)
        near, share = _near_boundary(vkind, idx.values, o, d, diff, N)
        margin = {"boxes": "exact: the slab test has no products",
                  "spheres": f"float64 discriminant within {RIM_DISC:.3g} "
                             "d.d (|o-c|^2 + r^2), or c within "
                             f"{RIM_C:.3g} (|o-c|^2 + r^2), of 0",
                  "triangles": f"{EDGE_MARGIN} of an edge"}[vkind]
        check(bool(near.all()), f"rays/{vkind}: {int((~near).sum())} pairs "
              f"differ from BruteForce away from a boundary ({margin})")
        worst = (f"; the largest reaches {share:.3f} of its margin"
                 if share is not None and diff.numel() else "")
        log(f"[rays] {vkind}: {N_CHECK} rays' hit sets vs BruteForce: "
            f"{int(ref.offsets[-1])} hits, {int(diff.numel())} pairs differ, "
            f"{int(near.sum())} of them within the margin ({margin}){worst}; "
            f"the walk fuses products as the reference's jitted walk does, "
            f"brute force rounds each as its eager code does")
        if vkind == "triangles":
            hit64, near64 = _triangle_oracle(o[:N_CHECK], d[:N_CHECK], a, b, c)
            mask = torch.zeros_like(hit64)
            off = mine.offsets.to(torch.int64)
            rows = torch.repeat_interleave(torch.arange(N_CHECK, device=dev),
                                           off[1:] - off[:-1])
            mask[rows, mine.indices.to(torch.int64)] = True
            bad = mask != hit64
            check(bool((~bad | near64).all()),
                  f"rays/triangles: {int((bad & ~near64).sum())} pairs differ "
                  f"from the float64 oracle away from an edge")
            log(f"[rays] triangles: {N_CHECK} rays vs a float64 oracle: "
                f"{int(hit64.sum())} hits, {int(bad.sum())} pairs differ, all "
                f"within {EDGE_MARGIN} of an edge, t = 0 or the det "
                f"threshold")
        del bf
    del targets, idx

    # -- ray_box_nearest: twin and cast_nearest(k=1) over BVH(Boxes) on all
    #    R rays, bound ------------------------------------------------------
    (want_t, want_i), plain = timed_once(lambda: KR.ray_box_nearest_ref(
        o, d, tlo, thi))
    fin = torch.isfinite(want_t)
    box_err = (float((box_t[fin] - want_t[fin]).abs().max())
               if bool(fin.any()) else 0.0)
    idx_off = int((box_i != want_i).sum())
    check(torch.equal(box_t, want_t) and idx_off == 0,
          f"ray_box_nearest differs from its twin (max abs {box_err:.3g}, "
          f"{idx_off} indices)")
    tk, ik = rt.raytracing.cast_nearest(box_index, rays, k=1)
    check(torch.equal(tk[:, 0], box_t),
          "ray_box_nearest t differs from cast_nearest(k=1) over BVH(Boxes)")
    # where the two indices differ, both boxes reach the ray's minimum
    rows = torch.nonzero(ik[:, 0] != box_i).squeeze(1)
    ties_ok = bool((ik[rows, 0] >= 0).all() and (box_i[rows] >= 0).all())
    if ties_ok and rows.numel():
        for j in (ik[rows, 0].to(torch.int64), box_i[rows].to(torch.int64)):
            _, tj = G.ray_box(o[rows], d[rows], tlo[j], thi[j])
            ties_ok &= torch.equal(tj, box_t[rows])
    check(ties_ok, "ray_box_nearest index differs from cast_nearest(k=1) "
          "where the minimum is unique")
    ms = time_ms(lambda: KR.ray_box_nearest(o, d, tlo, thi), reps=3)
    decode = kernel_ms(lambda: KR.ray_box_nearest(o, d, tlo, thi),
                       ("ray_box_decode",), reps=1)
    decode = "not measured" if decode is None else f"{decode:.4f} ms"
    # 8 operations per dimension and 4 per box (clamp, compare, compare
    # with the best, select), for every (ray, box) pair: no early exit
    b_ms, b_by = bound(R_RAYS * 3 * 8 + N * 3 * 8 + R_RAYS * 8,
                       R_RAYS * N * (8 * 3 + 4))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits, chunk = KR.plan(R_RAYS, N, sms)
    clock = _max_sm_clock_mhz()
    issue_ms = R_RAYS * N * RAY_BOX_ISSUE / (128 * sms * clock * 1e6) * 1e3
    rb3 = f"ray_box3_kernel<T {KR.RAYS_PER_THREAD}>"
    log(f"[ray_box] ray_box_nearest R={R_RAYS} B={N}: all {R_RAYS} rays "
        f"identical to twin (tolerance 0; max abs {box_err}, {idx_off} "
        f"indices differ); t identical to cast_nearest(k=1) over BVH(Boxes) "
        f"on all rays, indices equal on all but {int(rows.numel())}, each "
        f"with two boxes at its minimum; {ms:.3f} ms vs twin {plain:.1f} ms; "
        f"{rb3} ({_registers('ray_box', rb3)}): {KR.RAYS_PER_THREAD} rays "
        f"per thread, {KR.STAGES} stages of {KR.TILE} boxes, {splits} "
        f"splits of {chunk} boxes, {-(-R_RAYS // (KR.THREADS * KR.RAYS_PER_THREAD)) * splits} "
        f"blocks on {sms} SMs; then ray_box_decode "
        f"({_registers('ray_box', 'ray_box_decode')}) {decode} of that, "
        f"profiler device time; bound {b_ms:.4f} ms ({b_by}); instruction "
        f"issue {issue_ms:.2f} ms ({RAY_BOX_ISSUE} per pair, 128 lanes x "
        f"{sms} SMs at {clock} MHz)  [{card}]; phase "
        f"{time.perf_counter() - t0:.1f} s")
    box_record = dict(source="src/repro_torch/csrc/ray_box.cu",
                      replaces="src/repro/kernels/ray_box.py:97",
                      max_abs_err=box_err, ms=ms, plain_ms=plain,
                      bound_ms=b_ms, bound_by=b_by)
    return launches, record, box_record, knn_record


# ---------------------------------------------------------------------------
# slice 4: the stand-alone kernel ops (morton64, bruteforce_knn), sanitizer
# ---------------------------------------------------------------------------

Q_BF = 1 << 13           # brute-force queries against the 2^20 points
MORTON_DIMS_N = 1 << 16  # points per dimension of the bits-rule sweep
XOVER_Q, XOVER_K, XOVER_N = 1024, 8, (512, 4096, 32768)
LIB_CHUNK = 2048         # cdist rows per call of the library yardstick


def _bf_module():
    """repro_torch.kernels.bruteforce_knn (the package exports the function
    under the module's name)."""
    import importlib
    return importlib.import_module("repro_torch.kernels.bruteforce_knn")


def morton_bound(n, dim):
    """Coordinates read once, the scene once, two int64 lanes written; per
    point 7 operations per dimension to quantize and 3 per interleaved
    bit."""
    from repro_torch.core.morton import bits_per_dim
    bits = min(bits_per_dim(dim) * dim, 64)
    return bound(n * dim * 4 + 2 * dim * 4 + n * 16, n * (7 * dim + 3 * bits))


def bf_bound(q, n, dim, k):
    """Queries and points read once, (dists, idxs) written once; per pair
    the dot product (2 dim - 1), the expansion (3), the clamp and the
    compare with the k-th best: every pair is needed."""
    return bound((q + n) * dim * 4 + q * k * 8, q * n * (2 * dim + 4))


def phase_ops_main(pts, qc):
    """The slice's main path: ``kernels.ops.morton64`` over the search cloud
    and ``kernels.ops.bruteforce_knn`` of Q_BF queries against it, as a
    user calls them; the two counters zeroed just before, read just after.
    Returns (launches, outputs, times)."""
    import torch
    from repro_torch.kernels import morton as KM
    from repro_torch.kernels import ops
    KB = _bf_module()
    qb = qc[:Q_BF].contiguous()
    KM.morton64.launches = 0
    KB.bruteforce_knn.launches = 0
    codes, m_ms = timed_once(lambda: ops.morton64(pts))
    knn, b_ms = timed_once(lambda: ops.bruteforce_knn(qb, pts, K))
    torch.cuda.synchronize()
    launches = {"morton64": KM.morton64.launches,
                "bruteforce_knn": KB.bruteforce_knn.launches}
    check(launches == {"morton64": 1, "bruteforce_knn": 1},
          f"the ops path launched {launches}, not one of each")
    log(f"[ops] main path: ops.morton64 N={N} {m_ms:.3f} ms, "
        f"ops.bruteforce_knn Q={Q_BF} N={N} k={K} {b_ms:.2f} ms (one call "
        f"each, CUDA events); launches {json.dumps(launches)}")
    return launches, codes, knn


def key_bound(n, dim, reads, total=64):
    """The build instance: `reads` distinct (N, dim) float32 arrays read
    once (1 when a Points build passes one array as both corners), one
    int64 key written; per point the centroid (2 operations a dimension),
    the quantization (7) and 3 per interleaved bit."""
    from repro_torch.core.morton import bits_per_dim
    bits = min(bits_per_dim(dim, total) * dim, total)
    return bound(reads * n * dim * 4 + n * 8, n * (9 * dim + 3 * bits))


def phase_morton(dev, pts, box_lo, box_hi, codes, card):
    """The Morton kernel bit-identical to its twins: the stand-alone op
    (``core.morton.morton64``) on every point of the search cloud and of a
    sweep of dims, and the build instance (``morton_key_ref``: the
    centroids, their scene, the codes and the sort key) at 64 and 32 bits
    over the main path's Boxes and Points inputs and the sweep of dims;
    each timed through its wrapper, its C entry alone and its kernels'
    device time, beside its bound and the twin. Returns the kernels
    line's record: the build instance over the Boxes build's inputs."""
    import torch
    from repro_torch.core.morton import bits_per_dim
    from repro_torch.kernels import _build
    from repro_torch.kernels import morton as KM
    lo, hi = pts.amin(0), pts.amax(0)
    want, plain = timed_once(lambda: KM.morton64_ref(pts, lo, hi))
    check(all(torch.equal(a, b) for a, b in zip(codes, want)),
          "morton64 differs from its twin on the search cloud")
    check(bool((codes[0] > 0).any()) and bool((codes[0] < 2**32).all()),
          "morton64: the hi lane is unused or out of the uint32 range")
    ms = time_ms(lambda: KM.morton64(pts, lo, hi), reps=50)
    plain = time_ms(lambda: KM.morton64_ref(pts, lo, hi), reps=3)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = _build.function("morton", "morton64_launch", KM._ARGS)
    oh, ol = torch.empty_like(codes[0]), torch.empty_like(codes[1])
    op_args = (pts.data_ptr(), lo.data_ptr(), hi.data_ptr(), N, 3,
               bits_per_dim(3), oh.data_ptr(), ol.data_ptr(), stream)
    alone = time_ms(lambda: fn(*op_args), reps=50)
    dev_ms = kernel_ms(lambda: fn(*op_args), ("lanes_kernel",), reps=20)
    b_ms, b_by = morton_bound(N, 3)
    log(f"[morton] op N={N} dim 3: all points identical to twin (tolerance "
        f"0); {ms:.4f} ms through the wrapper, the C entry alone "
        f"{alone:.4f} ms, lanes_kernel's device time {fmt_ms(dev_ms)}; twin "
        f"{plain:.3f} ms; bound {b_ms:.4f} ms ({b_by})  [{card}]")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for dim in (1, 2, 4, 6, 10):
        x = torch.rand((MORTON_DIMS_N, dim), generator=gen, device=dev)
        xlo, xhi = x.amin(0), x.amax(0)
        got = KM.morton64(x, xlo, xhi)
        twin = KM.morton64_ref(x, xlo, xhi)
        check(all(torch.equal(a, b) for a, b in zip(got, twin)),
              f"morton64 differs from its twin at dim {dim}")
        check(dim == 1 or bool((got[0] > 0).any()),
              f"morton64 dim {dim}: the hi lane is unused")
        for bits in (64, 32):
            check(torch.equal(KM.morton_key(x, x + 0.01, bits),
                              KM.morton_key_ref(x, x + 0.01, bits)),
                  f"morton_key differs from its twin at dim {dim}, {bits} "
                  "bits")
        dms = time_ms(lambda: KM.morton64(x, xlo, xhi), reps=20)
        kms = time_ms(lambda: KM.morton_key(x, x + 0.01), reps=20)
        log(f"[morton] N={MORTON_DIMS_N} dim {dim}: the op and the build "
            f"instance (64 and 32 bits) identical to their twins; the op "
            f"{dms:.4f} ms (bound "
            f"{morton_bound(MORTON_DIMS_N, dim)[0]:.4f}), the build "
            f"instance {kms:.4f} ms (bound "
            f"{key_bound(MORTON_DIMS_N, dim, 2)[0]:.4f})")

    kfn = _build.function("morton", "morton_key_launch", KM._KEY_ARGS)
    parts = KM.key_scratch(3, dev)
    key = torch.empty((N,), dtype=torch.int64, device=dev)
    record = None
    for label, blo, bhi, reads in (("boxes", box_lo, box_hi, 2),
                                   ("points", pts, pts, 1)):
        for bits in (64, 32):
            got = KM.morton_key(blo, bhi, bits)
            twin = KM.morton_key_ref(blo, bhi, bits)
            check(torch.equal(got, twin), f"morton_key differs from its twin "
                  f"over the {label} build's inputs at {bits} bits")
            k_ms = time_ms(lambda: KM.morton_key(blo, bhi, bits), reps=50)
            k_args = (blo.data_ptr(), bhi.data_ptr(), N, 3, bits,
                      parts.data_ptr(), key.data_ptr(), stream)
            k_alone = time_ms(lambda: kfn(*k_args), reps=50)
            scene_ms = kernel_ms(lambda: kfn(*k_args), ("scene",), reps=20)
            key_ms = kernel_ms(lambda: kfn(*k_args), ("key_kernel",), reps=20)
            k_plain = time_ms(lambda: KM.morton_key_ref(blo, bhi, bits),
                              reps=3)
            kb_ms, kb_by = key_bound(N, 3, reads, bits)
            log(f"[morton] build instance, {label} N={N} dim 3, {bits} bits: "
                f"identical to twin; {k_ms:.4f} ms through the wrapper, the "
                f"C entry alone {k_alone:.4f} ms (device: scene_kernel and "
                f"scene_final {fmt_ms(scene_ms)}, key_kernel {fmt_ms(key_ms)}); twin "
                f"{k_plain:.3f} ms; bound {kb_ms:.4f} ms ({kb_by})"
                f"  [{card}]")
            if record is None:
                record = dict(source="src/repro_torch/csrc/morton.cu",
                              replaces="src/repro/kernels/morton.py:59",
                              max_abs_err=0, ms=k_ms, plain_ms=k_plain,
                              bound_ms=kb_ms, bound_by=kb_by,
                              library_ms=None)
    return record


def _library_knn(q, p, k):
    """torch.topk(torch.cdist(q, p), k, largest=False) over LIB_CHUNK
    queries at a time (the (Q, N) matrix of the main size is 32 GiB)."""
    import torch
    for s in range(0, q.shape[0], LIB_CHUNK):
        torch.topk(torch.cdist(q[s:s + LIB_CHUNK], p), k, largest=False)


def _same_knn(got, want, label):
    import torch
    err = float(torch.where(got[0] == want[0], 0.0,
                            (got[0] - want[0]).abs()).max())
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{label}: differs from its twin (max abs {err:.3g}, "
          f"{int((got[1] != want[1]).sum())} indices)")
    return err


def phase_bruteforce(dev, pts, qc, knn, policy, card):
    """The brute-force kernel against its twin on every row, at the main
    size, the bench's crossover sizes, k = 256, dim 64, float16 inputs and
    the k > N tail; the main size also against BVH.query(nearest)."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.kernels import ops
    KB = _bf_module()
    qb = qc[:Q_BF].contiguous()
    t0 = time.perf_counter()
    want, plain = timed_once(lambda: KB.bruteforce_knn_ref(qb, pts, K))
    err = _same_knn(knn, want, f"bruteforce_knn Q={Q_BF} N={N}")
    del want
    check(bool(torch.isfinite(knn[0]).all())
          and bool((knn[0][:, 1:] >= knn[0][:, :-1]).all()),
          "bruteforce_knn: distances not finite and ascending")
    index = rt.BVH(G.Points(pts), policy=policy)
    nn = index.query(rt.nearest(G.Points(qb), k=K))
    # the kernel carries the expansion's rounding, about 4 * 2^-23 *
    # (|q|^2 + |p|^2) in the square (coordinates in [0, 1]^3)
    d2_tol = 4 * 2.0 ** -23 * 6
    gap = float((nn.distances.double() ** 2 - knn[0].double() ** 2).abs().max())
    same = nn.indices == knn[1]
    near = (nn.distances.double() ** 2 - knn[0].double() ** 2).abs() <= d2_tol
    check(gap <= d2_tol and bool((same | near).all()),
          f"bruteforce_knn differs from BVH.query(nearest) beyond the "
          f"expansion's error (max |d2 diff| {gap:.3g})")
    ms = time_ms(lambda: KB.bruteforce_knn(qb, pts, K), reps=5)
    torch.cuda.empty_cache()
    lib = time_ms(lambda: _library_knn(qb, pts, K), reps=2)
    b_ms, b_by = bf_bound(Q_BF, N, 3, K)
    tail = KB.tail_from(N)
    chunk = KB.plan(Q_BF, N, K, tail, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    log(f"[bruteforce] Q={Q_BF} N={N} k={K} dim 3 (S = "
        f"{KB.splits(N, tail, chunk)} chunks of {chunk} points): all rows "
        f"identical to twin (tolerance 0); {ms:.3f} ms vs twin {plain:.1f} ms; cdist + "
        f"topk ({LIB_CHUNK}-query calls) {lib:.3f} ms; bound {b_ms:.4f} ms "
        f"({b_by}); vs BVH.query(nearest): max |d2 diff| {gap:.3g} (tol "
        f"{d2_tol:.3g}), {int((~same).sum())} indices differ, all within "
        f"it  [{card}]")
    del index, nn

    # -- the bench's crossover sizes: kernel, BVH kNN, BruteForce ----------
    xq = qc[:XOVER_Q].contiguous()
    for n in XOVER_N:
        xp = pts[:n].contiguous()
        got = KB.bruteforce_knn(xq, xp, XOVER_K)
        err = max(err, _same_knn(got, KB.bruteforce_knn_ref(xq, xp, XOVER_K),
                                 f"bruteforce_knn crossover N={n}"))
        preds = rt.nearest(G.Points(xq), k=XOVER_K)
        bvh = rt.BVH(G.Points(xp), policy=policy)
        bf = rt.BruteForce(G.Points(xp), policy=policy)
        k_ms = time_ms(lambda: KB.bruteforce_knn(xq, xp, XOVER_K), reps=10)
        t_ms = time_ms(lambda: bvh.query(preds), reps=5)
        f_ms = time_ms(lambda: bf.query(preds), reps=5)
        l_ms = time_ms(lambda: torch.topk(torch.cdist(xq, xp), XOVER_K,
                                          largest=False), reps=5)
        log(f"[bruteforce] crossover Q={XOVER_Q} k={XOVER_K} N={n}: kernel "
            f"{k_ms:.3f} ms, BVH.query(nearest) {t_ms:.3f} ms, "
            f"BruteForce.query {f_ms:.3f} ms, cdist + topk {l_ms:.3f} ms; "
            f"kernel identical to twin  [{card}]")

    # -- k = 256, dim 64, float16, the k > N tail --------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    cases = (("k=256", qc[:1024], pts[:1 << 16], 256, 512),
             ("dim 64", torch.rand((1024, 64), generator=gen, device=dev),
              torch.rand((1 << 14, 64), generator=gen, device=dev), K, 512),
             ("tail, one panel", qc[:1024], pts[:100], 128, 512),
             ("tail, three panels", qc[:1024], pts[:300], 256, 128))
    for label, cq, cp, k, bn in cases:
        cq, cp = cq.contiguous(), cp.contiguous()
        got = ops.bruteforce_knn(cq, cp, k, bn=bn)
        err = max(err, _same_knn(got, KB.bruteforce_knn_ref(cq, cp, k, bn=bn),
                                 f"bruteforce_knn {label}"))
        c_ms = time_ms(lambda: ops.bruteforce_knn(cq, cp, k, bn=bn), reps=3)
        n = cp.shape[0]
        if k > n:
            tail = got[1][:, n:]
            start = KB.tail_from(n, bn)
            nearest_below = -1 if start == 0 else KB.bruteforce_knn_ref(
                cq, cp[:start], 1)[1]
            check(bool(torch.isinf(got[0][:, n:]).all())
                  and bool((tail == nearest_below).all()),
                  f"bruteforce_knn {label}: the rows past N are not the "
                  f"reference's tail")
        log(f"[bruteforce] {label}: Q={cq.shape[0]} N={n} dim "
            f"{cp.shape[1]} k={k} bn={bn}: identical to twin; {c_ms:.3f} ms; "
            f"bound {bf_bound(cq.shape[0], n, cp.shape[1], k)[0]:.4f} ms")
    hq, hp = qc[:1024].half(), pts[:1 << 16].half()
    got = ops.bruteforce_knn(hq, hp, K)
    err = max(err, _same_knn(got, KB.bruteforce_knn_ref(
        hq.float(), hp.float(), K), "bruteforce_knn float16"))
    log(f"[bruteforce] float16 inputs Q=1024 N={1 << 16}: identical to the "
        f"twin on the float32 cast; phase {time.perf_counter() - t0:.1f} s")
    return dict(source="src/repro_torch/csrc/bruteforce_knn.cu",
                replaces="src/repro/kernels/bruteforce_knn.py:102",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def phase_sanitized(card):
    """``python -m repro_torch.analysis --strict`` on the card: its
    sanitize smoke (every wrapper armed with REPRO_SANITIZE, each held to
    an oracle) with every C entry's guard count zeroed first, then each C
    entry checked to have launched through its int guard, which must
    refuse 2^31 in each int argument; and the guard's host cost."""
    from repro_torch.analysis import launches as AL
    t0 = time.perf_counter()
    findings = AL.strict(echo=lambda line: log(f"[sanitize] {line.strip()}"))
    check(not findings, "[sanitize] --strict: " + "; ".join(
        f.format() for f in findings))
    log(f"[sanitize] repro_torch.analysis --strict: the sanitize smoke "
        f"(analysis.smoke, N=2000, Q=256) held every wrapper to its oracle "
        f"on the card with REPRO_SANITIZE=1, and all "
        f"{len(AL.c_entries())} C entries launched through their int "
        f"guards, each refusing 2^31; {time.perf_counter() - t0:.1f} s")
    # what the guard adds to a launch: its check of the widest entry's
    # arguments, on the host
    from repro_torch.kernels import _build
    entry = _build.entries()[("bvh_callback", "bvh_callback_launch")]
    args, reps = [0] * len(entry.argtypes), 20000
    for i, lo, hi in entry.int_args:
        args[i] = min(max(0, lo), hi)
    t0 = time.perf_counter()
    for _ in range(reps):
        entry.check_args(args)
    log(f"[sanitize] the int guard's host cost: "
        f"{(time.perf_counter() - t0) / reps * 1e6:.2f} us a call of "
        f"bvh_callback_launch's {len(args)} arguments (host clock, mean of "
        f"{reps})  [{card}]")


# ---------------------------------------------------------------------------
# slice 5: the LM forward (TinyLlama-1.1B) and the flash-attention kernel
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama-1.1b"
LM_B, LM_S = 4, 2048
LM_F32_LAYERS = 2        # depth of the float32 comparison at full width
# logits, flash against the plain path ("xla"), as a share of max |logit|:
# float32 sums in other orders (6e-7 measured at 2 layers); in bf16 at
# full depth both paths round p to bf16 before P.V, but each against its
# own running max and its own tiles, and they round o and every layer's
# output at other places, so they drift apart through 22 layers (about
# 5e-3 measured, with p in float32 in the kernel and with p rounded);
# top-1 must agree
LM_F32_TOL, LM_BF16_TOL, LM_TOP1 = 1e-5, 2e-2, 0.95
# kernel against twin: 2e-5 plus two steps of the output type (the two
# round float32 values that differ in their last bits), plus, for 16-bit
# inputs, u times the p-weighted mean of |v| (the tensor-core kernel
# rounds p to the input type before P.V; the twin keeps float32)
FLASH_ABS = 2e-5
FLASH_CASES = (   # (B, Hq, Hkv, Sq, Skv, D, causal, window, dtype name)
    # tests/test_kernels.py's sweep, float32
    (1, 4, 4, 128, 128, 64, True, None, "float32"),
    (2, 8, 2, 128, 128, 64, True, None, "float32"),       # GQA 4:1
    (1, 4, 1, 256, 256, 32, True, None, "float32"),       # MQA
    (1, 4, 4, 100, 100, 64, True, None, "float32"),       # unaligned S
    (1, 2, 2, 64, 192, 64, True, None, "float32"),        # Sq < Skv
    (1, 4, 2, 128, 128, 64, True, 32, "float32"),         # window 32
    (1, 2, 2, 96, 96, 128, False, None, "float32"),       # bidirectional
    # rows with no key, the other head widths, float16
    (1, 4, 2, 192, 64, 64, True, None, "float32"),        # Sq > Skv
    (2, 32, 32, 512, 512, 96, True, None, "bfloat16"),    # Phi-3's heads
    (2, 4, 2, 300, 300, 16, True, None, "float32"),       # smoke heads
    (2, 32, 4, 1024, 1024, 64, True, None, "float16"),
    (1, 8, 2, 700, 700, 128, True, 256, "float16"),
    # the tensor-core kernel's edges: ragged tiles, windows, Sq > Skv
    (1, 4, 2, 300, 300, 64, True, 100, "bfloat16"),
    (1, 4, 2, 192, 64, 64, True, None, "bfloat16"),
    (1, 8, 2, 700, 700, 80, True, 256, "float16"),
    (1, 8, 2, 500, 500, 8, False, None, "bfloat16"),
    # zamba2-7b's shared attention block: 32 heads of 112
    (1, 32, 32, 1024, 1024, 112, True, None, "bfloat16"),
    (1, 8, 2, 700, 700, 112, True, 256, "float32"),
)


def flash_step(dtype):
    import torch
    return {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]


def flash_p_round(dtype):
    """Unit roundoff of p in the tensor-core kernel (0: float32 keeps p)."""
    import torch
    return {torch.float32: 0.0, torch.bfloat16: 2.0 ** -8,
            torch.float16: 2.0 ** -11}[dtype]


def visible_pairs(sq, skv, causal, window):
    """(query, key) pairs the masks leave visible, row by row."""
    import torch
    qpos = torch.arange(sq, dtype=torch.int64) + (skv - sq)
    hi = torch.minimum(qpos + 1, torch.tensor(skv)) if causal else \
        torch.full_like(qpos, skv)
    lo = torch.clamp_min(qpos - window + 1, 0) if window else \
        torch.zeros_like(qpos)
    return int(torch.clamp_min(hi - lo, 0).sum())


def flash_ops(b, hq, sq, skv, d, causal, window):
    """4 D operations (two products of length D) per visible pair."""
    return 4 * d * b * hq * visible_pairs(sq, skv, causal, window)


def flash_bound(b, hq, hkv, sq, skv, d, causal, window, itemsize):
    """q, k, v read once and o written once; flash_ops at the bf16
    tensor-core rate."""
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * skv * d) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flash_ops(b, hq, sq, skv, d, causal, window) / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _flash_against_twin(KF, q, k, v, causal, window, label):
    """The kernel and its twin on the same inputs; returns (max |diff|,
    max |diff| / tolerance, kernel output)."""
    import torch
    got = KF.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = KF.flash_attention_ref(q, k, v, causal=causal,
                                  window=window).float()
    diff = (got.float() - want).abs()
    tol = FLASH_ABS + 2 * flash_step(q.dtype) * want.abs()
    if flash_p_round(q.dtype):
        tol += flash_p_round(q.dtype) * KF.flash_attention_ref(
            q.float(), k.float(), v.float().abs(), causal=causal,
            window=window)
    check(got.dtype == q.dtype and got.shape == q.shape
          and bool(torch.isfinite(got).all()),
          f"flash_attention {label}: wrong dtype or shape, or not finite")
    check(bool((diff <= tol).all()),
          f"flash_attention {label}: differs from its twin beyond 2e-5 + two "
          f"steps of {q.dtype} + u ref(q, k, |v|) (max |diff| "
          f"{float(diff.max()):.3g})")
    return float(diff.max()), float((diff / tol).max()), got


def phase_flash(dev, card):
    """The flash kernel against its twin on the card: the LM's shape (B = 4,
    Hq = 32, Hkv = 4, S = 2048, D = 64, bf16, causal) and FLASH_CASES;
    timed beside the twin, its bound, scaled_dot_product_attention and
    the float32 instance at the same shape."""
    import ctypes
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as KF
    t0 = time.perf_counter()
    smem = _build.function("flash_attention", "flash_attention_smem_bytes",
                           [ctypes.c_int, ctypes.c_int])
    for fn, regs, spill in _ptxas_summary(_build.build_log("flash_attention")):
        if fn.startswith("flash_kernel_tc"):
            dh = int(fn.split("DH ")[1].rstrip(">"))
            moved = (" (setmaxnreg then moves the producer's to the "
                     "consumers)" if dh == 64 else "")
            log(f"[flash] {fn}: {regs} registers at launch{moved}, {spill} "
                f"B spill stores, {smem(1, dh) / 1024:.0f} KiB dynamic "
                f"shared memory")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)

    def qkv(b, hq, hkv, sq, skv, d, dtype):
        return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                     for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                   (b, hkv, skv, d)))

    cfg_shape = (LM_B, 32, 4, LM_S, LM_S, 64)
    q, k, v = qkv(*cfg_shape, torch.bfloat16)
    errs, worst = {}, 0.0
    err, ratio, _ = _flash_against_twin(KF, q, k, v, True, None, "LM shape")
    errs["bfloat16"], worst = err, ratio
    for b, hq, hkv, sq, skv, d, causal, window, dt in FLASH_CASES:
        cq, ck, cv = qkv(b, hq, hkv, sq, skv, d, getattr(torch, dt))
        label = f"({b}, {hq}, {hkv}, {sq}, {skv}, {d}, {causal}, {window}, {dt})"
        err, ratio, got = _flash_against_twin(KF, cq, ck, cv, causal, window,
                                              label)
        errs[dt] = max(errs.get(dt, 0.0), err)
        worst = max(worst, ratio)
        if causal and sq > skv:
            check(bool((got[:, :, :sq - skv] == 0).all()),
                  f"flash_attention {label}: rows with no key are not 0")
    log(f"[flash] kernel against twin on {len(FLASH_CASES) + 1} shapes (the "
        f"LM's, tests/test_kernels.py's sweep, Sq > Skv, D 8 / 16 / 80 / 96 "
        f"/ 112 / 128, windows, float16): max |diff| per dtype "
        f"{json.dumps(errs)}, at most {worst:.3f} of the tolerance (2e-5 + "
        f"two steps of the output type + u ref(q, k, |v|) for 16-bit inputs)")
    ms = time_ms(lambda: KF.flash_attention(q, k, v), reps=20)
    plain = time_ms(lambda: KF.flash_attention_ref(q, k, v), reps=3)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), reps=20)
    q32, k32, v32 = q.float(), k.float(), v.float()
    ms32 = time_ms(lambda: KF.flash_attention(q32, k32, v32), reps=5)
    del q32, k32, v32
    b_ms, b_by = flash_bound(*cfg_shape, True, None, 2)
    ops = flash_ops(LM_B, 32, LM_S, LM_S, 64, True, None)
    log(f"[flash] B={LM_B} Hq=32 Hkv=4 S={LM_S} D=64 bf16 causal: "
        f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f} % "
        f"of the bound {b_ms:.4f} ms ({b_by})) vs twin {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms ({ms / lib:.2f}x); "
        f"float32 instance {ms32:.4f} ms ({ops / ms32 / 1e9:.1f} TFLOP/s); "
        f"phase {time.perf_counter() - t0:.1f} s  [{card}]")
    return dict(source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:117",
                max_abs_err=max(errs.values()), ms=ms, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, library_ms=lib)


def _logit_gap(got, want):
    """(max |diff| / max |want|, top-1 agreement share) of two logit sets."""
    gap = float((got.float() - want.float()).abs().max())
    top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    return gap / float(want.float().abs().max()), top1


def _plain_twin_of(model, cfg):
    """The same weights behind attn_impl="xla" (the port's plain path)."""
    import dataclasses
    import repro_torch as rt
    twin = rt.LM(dataclasses.replace(cfg, attn_impl="xla"), model.device)
    twin.load_state_dict(model.state_dict())
    return twin


def phase_lm(dev, card):
    """The slice's main path: ``LM.from_config`` of TinyLlama-1.1B with
    attn_impl="flash" at full width and depth, bf16, one forward of
    B x S tokens with the counters zeroed just before and read just after
    (22 flash launches, no twin call). Then the logits against the plain
    path on the same weights (float32 at 2 layers, bf16 at full depth),
    the forward's time and a profiled forward. Returns the launches."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.kernels import flash_attention as KF
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), attn_impl="flash")
    model = rt.LM.from_config(cfg, seed=SEED)
    check(model.device.type == "cuda", "LM.from_config did not land on the card")
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device=dev)
    twin_calls = []
    twin = KF.flash_attention_ref

    def counted_twin(*a, **kw):
        twin_calls.append(1)
        return twin(*a, **kw)

    KF.flash_attention_ref = counted_twin
    with torch.inference_mode():
        KF.flash_attention.launches = 0
        logits, aux = model(tokens)
        torch.cuda.synchronize()
        launches = {"flash_attention": KF.flash_attention.launches}
        KF.flash_attention_ref = twin
        check(launches["flash_attention"] == cfg.n_layers and not twin_calls,
              f"the LM forward launched flash {launches['flash_attention']} "
              f"times for {cfg.n_layers} layers, the twin {len(twin_calls)}")
        check(logits.shape == (LM_B, LM_S, cfg.vocab)
              and logits.dtype == torch.bfloat16
              and bool(torch.isfinite(logits).all()) and float(aux) == 0.0,
              "LM forward: logits of the wrong shape or type, or not finite")
        log(f"[lm] {cfg.name} attn_impl=flash, {cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters, bf16; "
            f"B={LM_B} S={LM_S}: logits finite, max |logit| "
            f"{float(logits.float().abs().max()):.1f}; launches "
            f"{json.dumps(launches)}, twin calls 0")

        plain = _plain_twin_of(model, cfg)
        rel, top1 = _logit_gap(logits, plain(tokens)[0])
        check(rel <= LM_BF16_TOL and top1 >= LM_TOP1,
              f"LM bf16 flash vs plain: max |diff| {rel:.3g} of max |logit| "
              f"(tolerance {LM_BF16_TOL}), top-1 agreement {top1:.4f}")
        xla_ms = time_ms(lambda: plain(tokens), reps=1)
        del plain
        log(f"[lm] bf16, {cfg.n_layers} layers, flash vs the plain path on "
            f"the same weights: max |diff| {rel:.3g} of max |logit| "
            f"(tolerance {LM_BF16_TOL}), top-1 agreement {top1:.4f} (at "
            f"least {LM_TOP1})")
        c32 = dataclasses.replace(cfg, n_layers=LM_F32_LAYERS,
                                  dtype="float32")
        m32 = rt.LM.from_config(c32, seed=SEED)
        rel32, top32 = _logit_gap(m32(tokens)[0],
                                  _plain_twin_of(m32, c32)(tokens)[0])
        check(rel32 <= LM_F32_TOL and top32 >= 0.999,
              f"LM float32 flash vs plain: max |diff| {rel32:.3g} of max "
              f"|logit| (tolerance {LM_F32_TOL}), top-1 {top32:.4f}")
        del m32
        log(f"[lm] float32, full width, {LM_F32_LAYERS} layers: flash vs the "
            f"plain path max |diff| {rel32:.3g} of max |logit| (tolerance "
            f"{LM_F32_TOL}), top-1 agreement {top32:.4f}")

        torch.cuda.reset_peak_memory_stats()
        fwd_ms = time_ms(lambda: model(tokens), reps=3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[lm] forward B={LM_B} x S={LM_S}: {fwd_ms:.2f} ms, "
            f"{LM_B * LM_S / fwd_ms * 1e3:.0f} tokens/s (CUDA events, 3 "
            f"forwards after a warm-up); the plain path {xla_ms:.2f} ms; peak "
            f"device memory {peak:.2f} GiB  [{card}]")
        profile_window(f"LM forward ({cfg.name}, flash, B={LM_B}, S={LM_S})",
                       lambda: model(tokens), card, share_of="flash_kernel")
    del model, logits
    torch.cuda.empty_cache()
    log(f"[lm] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# slice 18: the LM serving path of every family
# ---------------------------------------------------------------------------

#: (arch, layers kept (None: full depth), B, prompt, gen, extra): each at
#: its published width, bf16, weights from LM.from_config; extra is the
#: encdec family's encoder frames or the vlm family's patch rows
LMS_MODELS = (
    ("tinyllama-1.1b", None, 4, 128, 32, 0),
    ("mixtral-8x22b", 2, 1, 4096 + 64, 16, 0),   # 141 B parameters: 2 of 56
    ("deepseek-v3-671b", 4, 2, 64, 16, 0),       # 3 first_k_dense + 1 MoE
    ("mamba2-780m", None, 4, 256, 32, 0),
    ("zamba2-7b", None, 2, 64, 16, 0),
    ("seamless-m4t-medium", None, 4, 32, 16, 256),
    ("llava-next-mistral-7b", None, 2, 64, 16, 576),
)
#: decode against forward, bf16 logits, as a share of max |logit| and a
#: top-1 agreement share. Both paths round every matmul output and every
#: residual to bf16 (u = 2^-8), at other places: the prefill's steps
#: multiply (1, d) rows where the forward multiplies (S, d) panels, keep
#: p and P.V in float32 where the forward rounds p, and the SSD forward
#: rounds its panels where the recurrence keeps float32. A layer's
#: output is then off by a few u of its scale, and the residual stream
#: sums the layers, so the logits stay within about 10 u (4e-2) of max
#: |logit|; 1e-1 leaves a factor 2.5. A wrong slot, position or mask
#: instead gives gaps of order 1 and near-random top-1. In the MoE
#: families a token whose router scores nearly tie can go to another
#: expert on one path (its FFN output then changes wholesale), so there
#: the gap only bounds the scale (1.0) and the top-1 share decides.
LMS_GAP, LMS_MOE_GAP, LMS_TOP1 = 1e-1, 1.0, 0.9
#: flash against the plain path on the same weights: the same two kinds
#: of bf16 rounding at other places, so the same gap (1e-1; [lm]'s 2e-2
#: held at TinyLlama's 22 layers, but Zamba2 carries its 13 attention
#: applications' differences through 81 Mamba layers: 2.8e-2 measured)
#: and, for the MoE family, the same router flips; top-1 [lm]'s 0.95
LMS_FLASH_TOP1 = LM_TOP1


def _attn_calls(cfg):
    """Attention calls of one forward: each layer's, the shared block's
    applications, the encoder's and the decoder's self and cross."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers
    return cfg.n_layers


def _set_attn_impl(model, impl):
    """Point every module's configuration at `impl` (the same weights)."""
    import dataclasses
    for m in model.modules():
        if hasattr(m, "cfg"):
            m.cfg = dataclasses.replace(m.cfg, attn_impl=impl)


def _step_bytes(model, cache):
    """Bytes a decode step must read: every weight it uses once (the MTP
    module is the loss's, unused here; under the dense MoE dispatch every
    expert) and the whole cache."""
    w = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
            if not n.startswith("mtp."))
    c = sum(t.numel() * t.element_size() for t in cache.values())
    return w, c


def _lm_serve_flash_shapes(dev):
    """The flash kernel against its twin on the card at the new forwards'
    attention shapes (random bf16 q, k, v): Mixtral's window of 4096 at S
    = 4160, the non-causal encoder and the cross-attention (Sq != Skv) of
    SeamlessM4T, Zamba2's heads of 112, LLaVA's 640 rows with a window.
    Returns (max |diff|, worst share of the tolerance, shapes)."""
    import torch
    from repro_torch.kernels import flash_attention as KF
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    shapes = ((1, 48, 8, 4160, 4160, 128, True, 4096),
              (4, 16, 16, 256, 256, 64, False, None),
              (4, 16, 16, 32, 256, 64, False, None),
              (2, 32, 32, 64, 64, 112, True, None),
              (2, 32, 8, 640, 640, 128, True, 4096))
    err = worst = 0.0
    for b, hq, hkv, sq, skv, d, causal, window in shapes:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in ((b, hq, sq, d), (b, hkv, skv, d),
                             (b, hkv, skv, d)))
        e, r, _ = _flash_against_twin(
            KF, q, k, v, causal, window,
            f"[lm-serve] ({b}, {hq}, {hkv}, {sq}, {skv}, {d}, {causal}, "
            f"{window})")
        err, worst = max(err, e), max(worst, r)
    return err, worst, len(shapes)


def _lm_serve_one(dev, card, arch, layers, b, prompt, gen, extra):
    """One model of [lm-serve]: prefill (the sequential decode steps)
    against the model's forward, decode timed, flash against the plain
    path. Returns (flash launches, flash attention calls expected)."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models import serve as S
    t0 = time.perf_counter()
    cfg = rt.get_config(arch)
    full_layers = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cfg.is_moe:      # no capacity drops: decode and forward route alike
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    model = rt.LM.from_config(cfg, seed=SEED)
    check(model.device.type == "cuda", f"{arch}: LM not on the card")
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device=dev).manual_seed(SEED + 37)
    tokens = torch.randint(0, cfg.vocab, (b, prompt), generator=g, device=dev)
    bf16 = getattr(torch, cfg.dtype)
    fwd_kw, flash_kw = {}, {}
    with torch.inference_mode():
        cache = S.init_cache(cfg, b, prompt + gen, dtype=bf16,
                             enc_len=extra if cfg.family == "encdec" else None)
        if cfg.family == "encdec":
            src = torch.randn((b, extra, cfg.d_model), generator=g,
                              device=dev).to(bf16)
            cache = S.prefill_encoder(model, cache, src)
            fwd_kw = flash_kw = {"src_embeds": src}
        elif cfg.family == "vlm":
            # the prefill has no patch rows: the forward takes none either
            fwd_kw = {"patch_embeds": torch.empty((b, 0, cfg.d_model),
                                                  device=dev, dtype=bf16)}
            flash_kw = {"patch_embeds": torch.randn(
                (b, extra, cfg.d_model), generator=g, device=dev).to(bf16)}
        w_bytes, c_bytes = _step_bytes(model, cache)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache, plog = S.prefill(model, cache, tokens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t1

        # decode: gen - 2 steps by CUDA events after the prefill's warm-up
        # (TinyLlama's under sync-debug "error": a host sync raises)
        tok = plog[:, -1:].argmax(-1)
        steps = gen - 2
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        strict = arch == LM_ARCH
        if strict:
            torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            for _ in range(steps):
                lg, cache = S.decode_step(model, cache, tok)
                tok = lg[:, -1:].argmax(-1)
            stop.record()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        step_ms = start.elapsed_time(stop) / steps
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(int(cache["index"]) == prompt + steps
              and bool(torch.isfinite(lg).all()),
              f"{arch}: decode index or logits wrong")
        if strict:
            profile_window(
                f"decode step ({cfg.name}, B={b}, context {prompt + steps})",
                lambda: S.decode_step(model, cache, tok), card)
        bound_ms = (w_bytes + c_bytes) / HBM_BYTES_PER_S * 1e3

        # (a) decode against forward on the same tokens
        flog, _ = model(tokens, **fwd_kw)
        rel, top1 = _logit_gap(plog, flog)
        shapes = (tuple(plog.shape), tuple(flog.shape))
        del plog
        gap_tol = LMS_MOE_GAP if cfg.is_moe else LMS_GAP
        check(shapes == ((b, prompt, cfg.vocab),) * 2
              and rel <= gap_tol and top1 >= LMS_TOP1,
              f"{arch}: prefill vs forward max |diff| {rel:.3g} of max "
              f"|logit| (tolerance {gap_tol}), top-1 {top1:.4f} (at least "
              f"{LMS_TOP1})")

        # (b) flash against the plain path, the counters around the forward
        launches = expected = 0
        flash_line = "no attention"
        if cfg.mla:
            _set_attn_impl(model, "flash")
            try:
                model(tokens[:, :8])
                fail(f"{arch}: attn_impl='flash' ran MLA's unequal widths")
            except ValueError as err:
                check("one head width" in str(err), f"{arch}: {err}")
            finally:
                _set_attn_impl(model, "xla")
            flash_line = ("attn_impl='flash' refused with a ValueError "
                          "(q / k 192, v 128)")
        elif _attn_calls(cfg):
            want = model(tokens, **flash_kw)[0] if flash_kw is not fwd_kw \
                else flog
            twin_calls = []
            twin = KF.flash_attention_ref

            def counted_twin(*a, **kw):
                twin_calls.append(1)
                return twin(*a, **kw)

            _set_attn_impl(model, "flash")
            KF.flash_attention_ref = counted_twin
            try:
                KF.flash_attention.launches = 0
                got, _ = model(tokens, **flash_kw)
                torch.cuda.synchronize()
                launches = KF.flash_attention.launches
            finally:
                KF.flash_attention_ref = twin
                _set_attn_impl(model, "xla")
            expected = _attn_calls(cfg)
            check(launches == expected and not twin_calls,
                  f"{arch}: flash launched {launches} times for {expected} "
                  f"attention calls, the twin {len(twin_calls)}")
            frel, ftop = _logit_gap(got, want)
            ftol = LMS_MOE_GAP if cfg.is_moe else LMS_GAP
            check(frel <= ftol and ftop >= LMS_FLASH_TOP1,
                  f"{arch}: flash vs plain max |diff| {frel:.3g} of max "
                  f"|logit| (tolerance {ftol}), top-1 {ftop:.4f}")
            rows = tokens.shape[1] + (extra if cfg.family == "vlm" else 0)
            flash_line = (f"flash vs plain over {rows} rows: max |diff| "
                          f"{frel:.3g} of max |logit| (tolerance {ftol}), "
                          f"top-1 {ftop:.4f}; {launches} flash launches = "
                          f"{expected} attention calls, twin calls 0")
            del got, want
        del flog
    cut = (f"{layers} of {full_layers} layers" if layers
           else f"{full_layers} layers")
    log(f"[lm-serve] {cfg.name}: {cut}, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters, {cfg.dtype}, B={b} prompt {prompt} "
        f"gen {gen}{f', extra rows {extra}' if extra else ''}: prefill "
        f"{prefill_s:.2f} s ({prompt} steps); decode {step_ms:.3f} ms/step "
        f"({b / step_ms * 1e3:.1f} tokens/s, CUDA events over {steps} steps"
        f"{', sync-debug error' if strict else ''}), bound "
        f"{bound_ms:.3f} ms (weights {w_bytes / 1e9:.3f} GB + cache "
        f"{c_bytes / 1e9:.4f} GB read once at 3.35 TB/s, {step_ms / bound_ms:.1f}x); "
        f"peak device memory {peak:.2f} GiB; prefill vs forward max |diff| "
        f"{rel:.3g} of max |logit| (tolerance {gap_tol}), top-1 {top1:.4f}; "
        f"{flash_line}; {time.perf_counter() - t0:.1f} s  [{card}]")
    del model, cache
    torch.cuda.empty_cache()
    return launches, expected


def phase_lm_serve(dev, card):
    """Slice 18's main path: ``repro_torch.launch.serve.main`` for
    TinyLlama-1.1B at full depth (B = 4, prompt 128, gen 32), then each
    model of LMS_MODELS: the prefill against the forward, the decode
    timed beside its bound, flash against the plain path with its
    launches counted around the forward. Returns the flash launches."""
    import torch
    from repro_torch.launch import serve as L
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    err, worst, n = _lm_serve_flash_shapes(dev)
    log(f"[lm-serve] flash kernel against twin at the new forwards' shapes "
        f"({n}: window 4096 at S = 4160, non-causal encoder, cross Sq 32 / "
        f"Skv 256, D 112, 640 rows with a window), bf16: max |diff| "
        f"{err:.3g}, at most {worst:.3f} of the tolerance")
    arch, _, b, prompt, gen, _ = LMS_MODELS[0]
    out = L.main(["--arch", arch, "--batch", str(b), "--prompt-len",
                  str(prompt), "--gen", str(gen), "--seed", str(SEED)])
    check(out.shape == (b, gen) and (out >= 0).all()
          and (out < L.get_config(arch).vocab).all(),
          f"launch.serve.main: tokens of shape {out.shape}")
    torch.cuda.empty_cache()
    total = 0
    for spec in LMS_MODELS:
        launches, _ = _lm_serve_one(dev, card, *spec)
        total += launches
    log(f"[lm-serve] flash launches in the new forwards: {total}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    return total



# ---------------------------------------------------------------------------
# slice 19: the LM's training
# ---------------------------------------------------------------------------

TRAIN_WARM, TRAIN_TIMED = 3, 5
TRAIN_LR, TRAIN_WARMUP = 3e-4, 100      # launch.train's defaults
BF16_PEAK = 989e12                      # dense bf16 tensor-core FLOP/s
#: the card against the CPU port at TRAIN_CMP_LAYERS layers, float32:
#: the loss within 1e-5 relative and each gradient leaf within 1e-4 of
#: its max |g| (cuBLAS and the CPU's BLAS sum in other orders, about
#: 1e-6 of a product's scale; the CPU tests hold the port to the
#: reference at these bounds); AdamW's m, v and weights after one step
#: from the same gradients within 1e-6 of each leaf's max (elementwise
#: float32: the card may fuse a multiply and an add)
TRAIN_CMP_LAYERS, TRAIN_CMP_B, TRAIN_CMP_S = 2, 2, 64
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_OPT_TOL = 1e-5, 1e-4, 1e-6
#: the fixed batch: steps, lr, warmup and the reference's bar
TRAIN_MEMO_STEPS, TRAIN_MEMO_LR, TRAIN_MEMO_WARMUP = 20, 1e-3, 2
TRAIN_MEMO_RATIO = 0.7
#: the eval step's loss, flash against the plain path, bf16 at full
#: depth, the memorized model on a held-out batch: [lm]'s logit gap
#: (5e-3 of max |logit|) averaged over the 8192 tokens' losses
TRAIN_EVAL_ABS = 1e-2
#: every family's smoke configuration: the card's first loss against the
#: CPU port's (float32)
TRAIN_FAMILY_RTOL = 1e-5


def _host_syncs(fn):
    """The host syncs fn makes, as the source lines that made them (the
    Python frame of each warning under sync-debug "warn")."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
            if "called a synchronizing CUDA operation" in str(w.message)]


def _loss_and_grads(model, batch):
    import torch
    from repro_torch.models.lm import loss_fn
    params = dict(model.named_parameters())
    total, _ = loss_fn(model.cfg, model, batch)
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), dict(zip(params, grads))


def _leaf_gap(got, want):
    """max over leaves of max |got - want| / max |want| (got on any
    device, want on the CPU)."""
    worst = 0.0
    for n, w in want.items():
        w = w.detach().float()
        scale = float(w.abs().max())
        gap = float((got[n].detach().float().cpu() - w).abs().max())
        worst = max(worst, gap / scale if scale else gap)
    return worst


def _train_family_batch(cfg, dev):
    import torch
    from repro_torch.data import synthetic_batch
    b = synthetic_batch(SEED, 0, 2, 32, cfg.vocab, device="cpu")
    gen = torch.Generator().manual_seed(SEED)
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                        generator=gen)
    if cfg.family == "encdec":
        b["src_embeds"] = torch.randn((2, 16, cfg.d_model), generator=gen)
    return b, {k: v.to(dev) for k, v in b.items()}


def _train_card_vs_cpu(dev, card):
    """TRAIN_CMP_LAYERS layers of TinyLlama, full width, float32: the
    card's loss and gradients against the CPU port's on the same weights,
    then AdamW's state after one step from the CPU's gradients on both."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch import convert
    from repro_torch.data import synthetic_batch
    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), dtype="float32",
                              n_layers=TRAIN_CMP_LAYERS)
    cpu = rt.LM.from_config(cfg, seed=SEED, device="cpu")
    gpu = convert.lm_from_numpy(cfg, convert.lm_to_numpy(cpu), dev)
    b = synthetic_batch(SEED, 0, TRAIN_CMP_B, TRAIN_CMP_S, cfg.vocab,
                        device="cpu")
    l_cpu, g_cpu = _loss_and_grads(cpu, b)
    l_gpu, g_gpu = _loss_and_grads(gpu, {k: v.to(dev) for k, v in b.items()})
    rel = abs(float(l_gpu) - float(l_cpu)) / abs(float(l_cpu))
    gap = _leaf_gap(g_gpu, g_cpu)
    check(rel <= TRAIN_LOSS_RTOL and gap <= TRAIN_GRAD_TOL,
          f"train: the card's loss {float(l_gpu)} against the CPU's "
          f"{float(l_cpu)} ({rel:.3g} relative, tolerance "
          f"{TRAIN_LOSS_RTOL}); gradients {gap:.3g} of a leaf's max "
          f"(tolerance {TRAIN_GRAD_TOL})")
    del g_gpu
    lr = cosine_schedule(1e-3, 2, 10)
    s_cpu, s_gpu = adamw_init(cpu), adamw_init(gpu)
    adamw_update(cpu, g_cpu, s_cpu, lr)
    adamw_update(gpu, {n: g.to(dev) for n, g in g_cpu.items()}, s_gpu, lr)
    opt_gap = max(_leaf_gap(s_gpu["m"], s_cpu["m"]),
                  _leaf_gap(s_gpu["v"], s_cpu["v"]),
                  _leaf_gap(dict(gpu.named_parameters()),
                            dict(cpu.named_parameters())))
    check(opt_gap <= TRAIN_OPT_TOL and int(s_gpu["step"]) == 1,
          f"train: AdamW on the card against the CPU from the same "
          f"gradients: {opt_gap:.3g} of a leaf's max (tolerance "
          f"{TRAIN_OPT_TOL})")
    log(f"[train] {TRAIN_CMP_LAYERS} layers, full width, float32, B="
        f"{TRAIN_CMP_B} x S={TRAIN_CMP_S}, the card against the CPU port on "
        f"the same weights: loss {float(l_gpu):.6f} vs {float(l_cpu):.6f} "
        f"({rel:.3g} relative, tolerance {TRAIN_LOSS_RTOL}); gradients "
        f"{gap:.3g} of a leaf's max |g| (tolerance {TRAIN_GRAD_TOL}); AdamW "
        f"after one step from the same gradients: m, v and weights within "
        f"{opt_gap:.3g} of a leaf's max (tolerance {TRAIN_OPT_TOL})")


def _train_remat(dev, card):
    """TRAIN_CMP_LAYERS layers, bf16, the main shape: remat on and off,
    losses and gradients bit-identical, both peak memories."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.data import TokenPipeline
    cfg = dataclasses.replace(rt.get_config(LM_ARCH),
                              n_layers=TRAIN_CMP_LAYERS, remat=True)
    on = rt.LM.from_config(cfg, seed=SEED)
    off = rt.LM(dataclasses.replace(cfg, remat=False), dev)
    off.load_state_dict(on.state_dict())
    batch = TokenPipeline(SEED, LM_B, LM_S, cfg.vocab).next()
    out, peak = [], []
    for model in (on, off):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out.append(_loss_and_grads(model, batch))
        torch.cuda.synchronize()
        peak.append((torch.cuda.max_memory_allocated() - base) / 2**30)
    (l_on, g_on), (l_off, g_off) = out
    same = torch.equal(l_on, l_off) and all(
        torch.equal(g_on[n], g_off[n]) for n in g_on)
    check(same, f"train: remat on and off differ: loss {float(l_on)} vs "
          f"{float(l_off)}, gradients {_leaf_gap(g_on, {n: g.cpu() for n, g in g_off.items()}):.3g}")
    per_layer = (peak[1] - peak[0]) / TRAIN_CMP_LAYERS
    log(f"[train] remat on / off at {TRAIN_CMP_LAYERS} layers, bf16, B={LM_B} "
        f"x S={LM_S}: loss and gradients bit-identical; peak device memory "
        f"above the weights {peak[0]:.2f} / {peak[1]:.2f} GiB ({per_layer:.2f} "
        f"GiB a layer more without remat)  [{card}]")
    return peak


def _train_families(dev, card):
    """Every family's smoke configuration, one train step on the card."""
    import torch
    import repro_torch as rt
    from repro_torch import convert
    from repro_torch.models.lm import loss_fn
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_train_step
    rows = []
    for arch in rt.configs.all_archs():
        cfg = rt.get_config(arch, smoke=True)
        cpu = rt.LM.from_config(cfg, seed=SEED, device="cpu")
        gpu = convert.lm_from_numpy(cfg, convert.lm_to_numpy(cpu), dev)
        b_cpu, b_gpu = _train_family_batch(cfg, dev)
        with torch.no_grad():
            want = float(loss_fn(cfg, cpu, b_cpu)[0])
        before = {n: p.detach().clone() for n, p in gpu.named_parameters()}
        m = make_train_step(cfg, lr=1e-3, warmup=1)(gpu, adamw_init(gpu),
                                                    b_gpu)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        rel = abs(loss - want) / abs(want)
        still = [n for n, p in gpu.named_parameters()
                 if bool(before[n].any()) and torch.equal(p, before[n])]
        check(math.isfinite(loss) and math.isfinite(gn) and not still
              and rel <= TRAIN_FAMILY_RTOL,
              f"train: {arch} smoke step: loss {loss} (the CPU's {want}, "
              f"{rel:.3g} relative), grad norm {gn}, unmoved leaves {still}")
        rows.append(f"{arch} {loss:.4f} ({rel:.2g})")
    log(f"[train] one step of every family's smoke configuration on the "
        f"card, loss (relative gap to the CPU port's, tolerance "
        f"{TRAIN_FAMILY_RTOL}); every nonzero leaf moved: " + "; ".join(rows))


def _train_launcher():
    """launch.train.main --smoke: 4 steps into a checkpoint directory, then
    to 8 from it."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as T
    ckpt = tempfile.mkdtemp(prefix="chip-smoke-train-")
    outs = []
    try:
        for steps in (4, 8):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                loss = T.main(["--smoke", "--steps", str(steps), "--ckpt-dir",
                               ckpt, "--log-every", "2"])
            outs.append(buf.getvalue().strip().splitlines())
            check(loss is not None and math.isfinite(loss),
                  f"launch.train.main --steps {steps}: loss {loss}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check("resumed from step 4" in outs[1] and "resumed" not in
          " ".join(outs[0]), f"launch.train.main did not resume: {outs[1]}")
    log(f"[train] launch.train.main --smoke --steps 4, then --steps 8 from "
        f"its checkpoint: \"{outs[1][0]}\"; last lines \"{outs[0][-1]}\" "
        f"and \"{outs[1][-1]}\"")


def phase_train(dev, card):
    """Slice 19's main path: TinyLlama-1.1B trained at full width and
    depth on the card (bf16, remat, B x S from TokenPipeline), its eval
    step through flash with the counter zeroed just before and read just
    after; then the checks of the docstring's 16c. Returns the flash
    launches of the eval step."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.models.lm import loss_fn
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_eval_step, make_train_step
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), remat=True)
    model = rt.LM.from_config(cfg, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_WARM + TRAIN_TIMED + 2)
    pipe = TokenPipeline(SEED, LM_B, LM_S, cfg.vocab)
    check(pipe.next()["tokens"].device.type == "cuda",
          "TokenPipeline did not land on the card")
    for _ in range(TRAIN_WARM):
        m = step(model, opt, pipe.next())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    batches = [pipe.next() for _ in range(TRAIN_TIMED)]
    t1 = time.perf_counter()
    for b in batches:
        m = step(model, opt, b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3 / TRAIN_TIMED
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    check(math.isfinite(loss) and math.isfinite(gn)
          and int(opt["step"]) == TRAIN_WARM + TRAIN_TIMED,
          f"train: loss {loss}, grad norm {gn}, step {int(opt['step'])}")
    tokens = LM_B * LM_S
    mfu = 6 * n_params * tokens / (step_ms / 1e3) / BF16_PEAK
    busy, _ = profile_window(f"train step ({cfg.name}, bf16, remat, "
                             f"B={LM_B}, S={LM_S})",
                             lambda: step(model, opt, pipe.next()), card)
    busy_s = "not measured" if busy is None else f"{100 * busy:.1f} %"
    log(f"[train] {cfg.name}, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters, bf16, remat, AdamW (float32 "
        f"moments); B={LM_B} x S={LM_S} from TokenPipeline: "
        f"{step_ms:.2f} ms a step ({TRAIN_TIMED} steps after {TRAIN_WARM}, "
        f"host clock around device syncs), {tokens / step_ms * 1e3:.0f} "
        f"tokens/s, peak device memory {peak:.2f} GiB, busy {busy_s} of "
        f"a profiled step, 6 N tokens / step time = {100 * mfu:.2f} % of "
        f"989 TFLOP/s; loss {loss:.4f}, grad norm {gn:.3f}  [{card}]")

    batch = pipe.next()
    params = list(model.parameters())
    fwd_bwd = _host_syncs(lambda: torch.autograd.grad(
        loss_fn(cfg, model, batch)[0], params))
    stepped = _host_syncs(lambda: step(model, opt, batch))
    own = [w for w in stepped if re.search(r"repro_torch/(train|optim)/", w)]
    # the counter sees a sync: one .item()
    seen = _host_syncs(lambda: float(opt["step"]))
    check(not own and len(seen) == 1, f"train: the step's own code synced "
          f"with the host at {own}; a known sync counted {len(seen)} times")
    log(f"[train] host syncs under sync-debug \"warn\": {len(stepped)} in "
        f"one train step {stepped}, {len(fwd_bwd)} in its forward and "
        f"backward alone {fwd_bwd}; none in train/ or optim/ (one .item() "
        f"counted {len(seen)})")

    del model, opt, m, batches, batch, params
    torch.cuda.empty_cache()

    # a fresh model memorizes a fixed batch
    model = rt.LM.from_config(cfg, seed=SEED + 1)
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=TRAIN_MEMO_LR, warmup=TRAIN_MEMO_WARMUP,
                           total_steps=TRAIN_MEMO_STEPS)
    fixed = TokenPipeline(SEED + 1, LM_B, LM_S, cfg.vocab).next()
    losses = torch.stack([step(model, opt, fixed)["loss"]
                          for _ in range(TRAIN_MEMO_STEPS)]).tolist()
    check(all(map(math.isfinite, losses))
          and losses[-1] < TRAIN_MEMO_RATIO * losses[0],
          f"train: the fixed batch's loss went {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (bar {TRAIN_MEMO_RATIO} x the first)")
    log(f"[train] fixed batch, {TRAIN_MEMO_STEPS} steps at lr "
        f"{TRAIN_MEMO_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({losses[-1] / losses[0]:.3f} of the first; bar "
        f"{TRAIN_MEMO_RATIO}); every 5th: "
        + ", ".join(f"{x:.3f}" for x in losses[::5]))

    # the eval step of the trained model on a held-out batch through flash,
    # the same weights through the plain path beside it (a fresh model's
    # tied embedding gives each token's own logit a value in the
    # hundreds or thousands, where a bf16 step is 2 to 8, which would
    # swamp the comparison)
    batch = TokenPipeline(SEED + 2, LM_B, LM_S, cfg.vocab).next()
    twin_calls = []
    twin = KF.flash_attention_ref

    def counted_twin(*a, **kw):
        twin_calls.append(1)
        return twin(*a, **kw)

    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    _set_attn_impl(model, "flash")
    KF.flash_attention_ref = counted_twin
    try:
        KF.flash_attention.launches = 0
        ev = make_eval_step(fcfg)(model, batch)
        torch.cuda.synchronize()
        launches = KF.flash_attention.launches
    finally:
        KF.flash_attention_ref = twin
    _set_attn_impl(model, "xla")
    plain = make_eval_step(cfg)(model, batch)
    gap = abs(float(ev["loss"]) - float(plain["loss"]))
    check(launches == cfg.n_layers and not twin_calls
          and gap <= TRAIN_EVAL_ABS,
          f"train: the flash eval step launched flash {launches} times for "
          f"{cfg.n_layers} layers, the twin {len(twin_calls)}; loss "
          f"{float(ev['loss'])} against the plain path's "
          f"{float(plain['loss'])} (tolerance {TRAIN_EVAL_ABS})")
    log(f"[train] eval step, attn_impl=flash: {launches} flash launches, twin "
        f"calls 0; loss {float(ev['loss']):.5f}, the plain path's "
        f"{float(plain['loss']):.5f} (|diff| {gap:.3g}, tolerance "
        f"{TRAIN_EVAL_ABS})")
    del model, opt
    torch.cuda.empty_cache()

    _train_card_vs_cpu(dev, card)
    _train_remat(dev, card)
    torch.cuda.empty_cache()
    _train_families(dev, card)
    _train_launcher()
    log(f"[train] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# slice 20: the mesh (DTensor placements, ZeRO-1, the dry-run's analyzer)
# ---------------------------------------------------------------------------

MESH_STEPS = 3           # (a): plain and sharded steps from the same weights
#: (a) at one rank every op runs on whole tensors and every collective is
#: a copy: the sharded steps are held to the plain ones bit for bit
MESH_A_TOL = 0.0


def _mesh_place(model, mesh):
    """launch.train's set-up on `mesh`: the rules installed, the model at
    its parameter specs, AdamW's moments at ZeRO-1's. Returns the state."""
    from repro_torch.launch import sharding as SH
    from repro_torch.models.layers import set_sharding_rules
    from repro_torch.optim import adamw_init
    set_sharding_rules(SH.logical_rules(mesh), mesh)
    pspecs = SH.param_specs(model, mesh)
    ospecs = SH.zero1_specs(pspecs, model, mesh)
    SH.distribute_model(model, mesh, pspecs)
    return adamw_init(model, mesh=mesh, specs=ospecs)


def _mesh_batch(batch, mesh):
    from repro_torch.launch import sharding as SH
    bspec = SH.batch_spec(mesh, next(iter(batch.values())).shape[0])
    return {k: SH.to_dtensor(v, mesh, bspec) for k, v in batch.items()}


def _mesh_analyzer(cfg, batch):
    """(b): ``opanalysis.analyze`` over the train step on the meta device
    in a fake world of one rank, (1, 1) mesh, the [train] shape. Returns
    the analysis and its argument bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun, opanalysis
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.layers import set_sharding_rules
    from repro_torch.models.lm import LM
    from repro_torch.train import make_train_step
    dryrun.fake_world(1)
    try:
        mesh = make_host_mesh(1, "cpu")
        model = LM(cfg, device="meta")
        opt = _mesh_place(model, mesh)
        mb = _mesh_batch({k: torch.empty(v.shape, dtype=v.dtype,
                                         device="meta")
                          for k, v in batch.items()}, mesh)
        step = make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                               total_steps=MESH_STEPS + 2)
        args = dryrun.local_bytes({"model": model, "opt": opt, "batch": mb})
        t0 = time.perf_counter()
        ana = opanalysis.analyze(step, model, opt, mb)
        ana["seconds"] = time.perf_counter() - t0
    finally:
        set_sharding_rules(None)
        dist.destroy_process_group()
    return ana, args


def _mesh_steps(step, model, opt, batches, mesh=None):
    """The steps' losses (float) and the mean ms of all but the first
    (host clock around device syncs)."""
    import torch
    losses, ms = [], []
    for b in batches:
        b = b if mesh is None else _mesh_batch(b, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(model, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        loss = m["loss"]
        losses.append(float(loss.full_tensor() if mesh is not None
                            else loss))
    return losses, sum(ms[1:]) / len(ms[1:])


def _mesh_gap(plain: dict, sharded: dict) -> float:
    """max over leaves of max |sharded - plain| / max |plain|, the sharded
    leaves' local tensors (whole at one rank)."""
    worst = 0.0
    for n, w in plain.items():
        got = sharded[n].detach().to_local().float()
        w = w.detach().float()
        gap = float((got - w).abs().max())
        scale = float(w.abs().max())
        worst = max(worst, gap / scale if scale else gap)
    return worst


def _mesh_one_rank(dev, card, cfg, batches):
    """(a): MESH_STEPS plain and sharded steps of TinyLlama-1.1B from the
    same weights and batches in an NCCL world of one rank, then the flash
    eval step on both, the sharded one's launches counted. Returns (the
    sharded eval's flash launches, the card's argument bytes, its peak
    memory above them, the sharded step's ms)."""
    import dataclasses
    import torch
    import repro_torch as rt
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.train import make_eval_step, make_train_step

    def new_step():
        return make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                               total_steps=MESH_STEPS + 2)

    plain = rt.LM.from_config(cfg, seed=SEED)
    popt = adamw_init(plain)
    p_losses, p_ms = _mesh_steps(new_step(), plain, popt, batches)
    sharded = rt.LM.from_config(cfg, seed=SEED)
    mesh = make_host_mesh(1, "cuda")
    sopt = _mesh_place(sharded, mesh)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    s_losses, s_ms = _mesh_steps(new_step(), sharded, sopt, batches, mesh)
    peak_raw = torch.cuda.max_memory_allocated()
    peak = peak_raw - base
    card_bytes = dryrun.local_bytes({"model": sharded, "opt": sopt,
                                     "batch": _mesh_batch(batches[0], mesh)})
    w_gap = _mesh_gap(dict(plain.named_parameters()),
                      dict(sharded.named_parameters()))
    m_gap = max(_mesh_gap(popt[k], sopt[k]) for k in ("m", "v"))
    l_gap = max(abs(a - b) / abs(a) for a, b in zip(p_losses, s_losses))
    check(l_gap <= MESH_A_TOL and w_gap <= MESH_A_TOL
          and m_gap <= MESH_A_TOL
          and int(sopt["step"]) == int(popt["step"]) == MESH_STEPS,
          f"mesh (a): the sharded steps against the plain: losses "
          f"{s_losses} / {p_losses}, weights {w_gap:.3g}, moments "
          f"{m_gap:.3g} of a leaf's max (tolerance {MESH_A_TOL})")
    log(f"[mesh] (a) {cfg.name}, {cfg.n_layers} layers, bf16, remat, B="
        f"{LM_B} x S={LM_S}, an NCCL world of one rank, a (1, 1) "
        f"(data, model) mesh: {MESH_STEPS} steps at param_specs' "
        f"placements with ZeRO-1 moments against {MESH_STEPS} plain steps "
        f"from the same weights and batches: losses "
        + ", ".join(f"{x:.6f}" for x in s_losses)
        + f"; losses, every weight and every moment apart by {l_gap:.3g}, "
        f"{w_gap:.3g}, {m_gap:.3g} (tolerance {MESH_A_TOL}); a step "
        f"{s_ms:.2f} ms sharded against {p_ms:.2f} ms plain "
        f"({s_ms / p_ms:.3f}x: DTensor's cost at one rank; the mean of "
        f"steps 2-{MESH_STEPS}, host clock around device syncs); "
        f"max_memory_allocated {peak_raw / 2**30:.2f} GiB, "
        f"{peak / 2**30:.2f} GiB above what the plain and sharded states "
        f"held before the steps  [{card}]")

    # the eval step through flash on both, the sharded one counted
    batch = _pipeline_batch(SEED + 2, cfg.vocab)
    fcfg = dataclasses.replace(cfg, attn_impl="flash")
    _set_attn_impl(plain, "flash")
    _set_attn_impl(sharded, "flash")
    want = make_eval_step(fcfg)(plain, batch)
    twin_calls = []
    twin = KF.flash_attention_ref

    def counted_twin(*a, **kw):
        twin_calls.append(1)
        return twin(*a, **kw)

    KF.flash_attention_ref = counted_twin
    try:
        db = _mesh_batch(batch, mesh)
        KF.flash_attention.launches = 0
        got = make_eval_step(fcfg)(sharded, db)
        torch.cuda.synchronize()
        launches = KF.flash_attention.launches
    finally:
        KF.flash_attention_ref = twin
    g, w = float(got["loss"].full_tensor()), float(want["loss"])
    check(launches == cfg.n_layers and not twin_calls
          and abs(g - w) <= TRAIN_EVAL_ABS,
          f"mesh (a): the sharded flash eval launched flash {launches} "
          f"times for {cfg.n_layers} layers, the twin {len(twin_calls)}; "
          f"loss {g} against the unsharded flash eval's {w} (tolerance "
          f"{TRAIN_EVAL_ABS})")
    log(f"[mesh] (a) the sharded eval step, attn_impl=flash, each rank's "
        f"heads through local_map: {launches} flash launches, twin calls "
        f"0; loss {g:.6f}, the unsharded flash eval's {w:.6f} (|diff| "
        f"{abs(g - w):.3g}, tolerance {TRAIN_EVAL_ABS})")
    del plain, popt, sharded, sopt
    torch.cuda.empty_cache()
    return launches, card_bytes, peak, s_ms


def _pipeline_batch(seed, vocab):
    """TokenPipeline's first (B = LM_B, S = LM_S) batch of `seed`, on the
    card."""
    from repro_torch.data import TokenPipeline
    return TokenPipeline(seed, LM_B, LM_S, vocab).next()


def phase_mesh(dev, card):
    """Slice 20's path, [mesh]: (b) the analyzer over the train step on
    meta, (a) the sharded steps and the sharded flash eval in an NCCL
    world of one rank. Returns the flash launches of the sharded eval
    step. Ranks sharing the card over gloo are not run: this torch's gloo
    crashes (SIGSEGV) in ``all_gather_into_tensor`` of CUDA tensors, the
    collective DTensor gathers a shard with
    (``scripts/gloo_cuda_probe.py``); the CPU tests' gloo worlds hold
    the multi-rank path."""
    import dataclasses
    import tempfile
    import torch
    import torch.distributed as dist
    import repro_torch as rt
    from repro_torch.launch.dryrun import PEAK_FLOPS
    from repro_torch.models.layers import set_sharding_rules
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(rt.get_config(LM_ARCH), remat=True)
    batches = [_pipeline_batch(SEED + 10 + i, cfg.vocab)
               for i in range(MESH_STEPS)]
    ana, meta_bytes = _mesh_analyzer(cfg, {k: v.cpu()
                                           for k, v in batches[0].items()})
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            launches, card_bytes, peak, s_ms = _mesh_one_rank(
                dev, card, cfg, batches)
        finally:
            set_sharding_rules(None)
            dist.destroy_process_group()
    meta = rt.LM(cfg, device="meta")
    n = sum(p.numel() for p in meta.parameters())
    n_blocks = sum(p.numel() for p in meta.layers.parameters())
    t = LM_B * LM_S
    # one pass of the plain attention's two products over every S x S
    # score; the forward, twice the backward and remat's second forward
    attn = 4 * cfg.n_layers * LM_B * cfg.n_heads * LM_S ** 2 * cfg.dh
    want_flops = 6 * n * t + 2 * n_blocks * t + 4 * attn
    check(meta_bytes == card_bytes and math.isfinite(ana["flops"]),
          f"mesh (b): the analyzer's arg_bytes {meta_bytes} against the "
          f"card's parameter, moment, step and batch bytes {card_bytes}")
    log(f"[mesh] (b) opanalysis over the same train step on meta, a fake "
        f"world of one rank ({ana['seconds']:.1f} s on the host): "
        f"arg_bytes {meta_bytes} = the card's parameters, moments, step "
        f"and batch {card_bytes}; flops {ana['flops']:.4e} against "
        f"6 N T {6 * n * t:.4e}, 6 N T + the attention's three passes "
        f"{6 * n * t + 3 * attn:.4e}, and with remat's second forward of "
        f"the blocks {want_flops:.4e} ({ana['flops'] / want_flops:.3f}x); "
        f"temp_bytes {ana['temp_bytes'] / 2**30:.2f} GiB against the "
        f"card's peak above its state {peak / 2**30:.2f} GiB "
        f"({ana['temp_bytes'] / peak:.3f}x); hbm_bytes "
        f"{ana['hbm_bytes']:.4e}; t_compute {ana['flops'] / PEAK_FLOPS * 1e3:.1f}"
        f" ms against the sharded step's {s_ms:.2f} ms measured  [{card}]")
    torch.cuda.empty_cache()
    log(f"[mesh] phase {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# slice 12: the serving path (QueryServer, ServingPipeline, telemetry)
# ---------------------------------------------------------------------------

SERVE_CAPACITY = 64
SERVE_MIN_BUCKET = 8
SERVE_MAX_BUCKET = 4096
SERVE_REQUESTS = 1000    # mixed requests through QueryServer.handle
SERVE_PER_CALL = 8       # requests per handle() call
SERVE_MAX_ROWS = 512
SERVE_RAY_KS = (1, 4)
SERVE_CLIENTS = 4
SERVE_PER_CLIENT = 500
SERVE_DEADLINE_US = 20_000.0
SERVE_REFITS = 20
SERVE_MOVE_SIGMA = 0.002
SERVE_KEEP_VERSIONS = 64
SERVE_SAMPLES = 2        # responses held per (index, version, kind)


def _serve_request(rng, kind, m, k):
    """One seeded request: kNN and within over "cloud" (uniform query
    points, r = RADIUS), rays over "scene" (uniform origins,
    standard-normal directions)."""
    from repro_torch.service import knn_request, ray_request, within_request
    a = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    if kind == "knn":
        return knn_request(a, k, "cloud")
    if kind == "within":
        return within_request(a, RADIUS, "cloud")
    return ray_request(a, rng.standard_normal((m, 3)).astype(np.float32), k,
                       "scene")


def _serve_draw(rng):
    """(kind, k) of one request of the mix: a third each of kNN (k = K),
    within and rays (k = 1 or 4)."""
    kind = ("knn", "within", "ray")[int(rng.integers(0, 3))]
    k = K if kind == "knn" else 0 if kind == "within" else \
        int(rng.choice(SERVE_RAY_KS))
    return kind, k


def _direct(index, req, dev):
    """The same request through BVH.query on `index` with the kernel route
    forced (the route the server reports): (counts or t, idx) on the host."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    pol = rt.ExecutionPolicy(engine=rt.QueryEngine(rt.EngineConfig(
        force="kernel")))
    a = torch.tensor(req.a, device=dev)
    if req.kind == "within":
        res = index.query(rt.intersects(G.Spheres(
            a, torch.tensor(req.b, device=dev))), policy=pol)
        counts = res.offsets.diff().cpu().numpy()
        idx = res.indices.cpu().numpy()
        off = res.offsets.cpu().numpy()
        return counts, [idx[off[i]:off[i + 1]] for i in range(len(counts))]
    if req.kind == "knn":
        res = index.query(rt.nearest(G.Points(a), k=req.k), policy=pol)
    else:
        res = index.query(P.RayNearest(G.Rays(
            a, torch.tensor(req.b, device=dev)), req.k), policy=pol)
    return res.distances.cpu().numpy(), res.indices.cpu().numpy()


def _same_as_direct(resp, index, req, dev, label):
    check(resp.stats.route == "kernel",
          f"{label}: served on route {resp.stats.route}")
    want = _direct(index, req, dev)
    if req.kind == "within":
        counts, rows = want
        check(np.array_equal(resp.counts, counts),
              f"{label}: within counts differ from BVH.query")
        check(resp.overflow == bool((counts > SERVE_CAPACITY).any()),
              f"{label}: overflow flag")
        for got, c, row in zip(resp.idxs, counts, rows):
            if c <= SERVE_CAPACITY:
                check(np.array_equal(np.sort(got[:c]), np.sort(row))
                      and (got[c:] == -1).all(),
                      f"{label}: within index set differs from BVH.query")
    else:
        check(np.array_equal(resp.dists, want[0])
              and np.array_equal(resp.idxs, want[1]),
              f"{label}: {req.kind} differs from BVH.query")


def _twins_raise():
    """Make every twin of the serving and EMST paths raise; returns the
    restorer."""
    from repro_torch.core import morton as CM
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    saved = []

    def boom(*a, **k):
        raise RuntimeError("a twin ran on a path held to the kernels")

    for mod, name in ((T, "bvh_traverse_spatial_ref"),
                      (T, "bvh_traverse_knn_ref"),
                      (T, "bvh_traverse_knn_exclude_ref"),
                      (T, "bvh_traverse_ray_knn_ref"),
                      (KB, "karras_ranges_fused"), (KB, "lbvh_tail_ref"),
                      (KB, "lbvh_refit_ref"), (KB, "aabb_rmq"),
                      (KM, "morton_key_ref"), (CM, "_interleave")):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, boom)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return restore


def phase_serve(dev, pts, card):
    """QueryServer and ServingPipeline on the card over "cloud" (the search
    points) and "scene" (the ray phase's triangles). Logs the kernel
    launches of the serving path (counters zeroed just before each part,
    read just after), which stay out of the kernels line. Returns the
    1,000 mixed requests (in their handle() calls) and QueryServer's
    responses, which [sharded] is held to."""
    import tempfile
    import threading
    import torch
    from repro_torch import telemetry
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    from repro_torch.service import (IndexStore, PipelineConfig,
                                     QueryServer, ServiceConfig,
                                     ServingPipeline, knn_request,
                                     ray_request, within_request)

    t_phase = time.perf_counter()
    counters = {"bvh_traverse_spatial": T.bvh_traverse_spatial,
                "bvh_traverse_knn": T.bvh_traverse_knn,
                "bvh_traverse_ray_knn": T.bvh_traverse_ray_knn,
                "morton64": KM.morton64, "karras_ranges": KB.karras_ranges,
                "lbvh_tail": KB.lbvh_tail}
    op_of = {"within": "bvh_traverse_spatial", "knn": "bvh_traverse_knn",
             "ray": "bvh_traverse_ray_knn"}
    a, b, c, _, _ = make_soup(dev)
    svc = ServiceConfig(capacity=SERVE_CAPACITY, min_bucket=SERVE_MIN_BUCKET,
                        max_bucket=SERVE_MAX_BUCKET)
    restore = _twins_raise()
    total = {k: 0 for k in counters}

    def take_counts():
        out = {k: f.launches for k, f in counters.items()}
        for k, v in out.items():
            total[k] += v
        return out

    def zero():
        for f in counters.values():
            f.launches = 0

    try:
        zero()
        srv = QueryServer(config=svc)
        check(srv.store.device.type == "cuda", "QueryServer is not on the card")
        srv.create_index("cloud", G.Points(pts))
        srv.create_index("scene", G.Triangles(a, b, c))
        ladder = []
        bkt = SERVE_MIN_BUCKET
        while bkt <= SERVE_MAX_BUCKET:
            ladder.append(bkt)
            bkt *= 2
        t0 = time.perf_counter()
        for bkt in ladder:
            z = np.zeros((bkt, 3), np.float32)
            srv.handle([within_request(z, RADIUS, "cloud"),
                        knn_request(z, K, "cloud")]
                       + [ray_request(z, np.ones((bkt, 3), np.float32), k,
                                      "scene") for k in SERVE_RAY_KS])
        warm_s = time.perf_counter() - t0
        eng = srv.engine
        warm = eng.stats.snapshot()
        check(warm.cache_misses == 4 * len(ladder), f"warm-up: {warm}")
        libs, funcs = len(_build._LIBS), len(_build._FUNCS)
        take_counts()

        # -- 1,000 mixed requests through handle() ----------------------
        rng = np.random.default_rng(SEED + 41)
        calls = []
        for _ in range(SERVE_REQUESTS // SERVE_PER_CALL):
            reqs = []
            for _ in range(SERVE_PER_CALL):
                kind, k = _serve_draw(rng)
                reqs.append(_serve_request(
                    rng, kind, int(rng.integers(1, SERVE_MAX_ROWS + 1)), k))
            calls.append(reqs)
        zero()
        groups = {k: 0 for k in op_of.values()}
        served = []
        t0 = time.perf_counter()
        for reqs in calls:
            for g in srv.batcher.plan(reqs):
                groups[op_of[g.kind]] += 1
            served.append(srv.handle(reqs))
        load_s = time.perf_counter() - t0
        got = take_counts()
        after = eng.stats.snapshot()
        check(after.cache_misses == warm.cache_misses,
              f"a cache miss after the warm-up: {after}")
        check((len(_build._LIBS), len(_build._FUNCS)) == (libs, funcs),
              "a kernel library was loaded after the warm-up")
        for name, n in groups.items():
            check(got[name] == n, f"{name}: {got[name]} launches for {n} "
                  "groups (one a group expected)")
        check(got["morton64"] == got["karras_ranges"] == got["lbvh_tail"] == 0,
              "serving launched a build kernel")
        n_req = 0
        for reqs, resps in zip(calls, served):
            for req, resp in zip(reqs, resps):
                check(resp.stats.cache_hit, "a cold dispatch after warm-up")
                entry = srv.store.get(resp.stats.index_name,
                                      resp.stats.index_version)
                _same_as_direct(resp, entry.bvh, req, dev,
                                f"handle {req.kind} m={req.m}")
                n_req += 1
        log(f"[serve] QueryServer on the card: \"cloud\" {N} points, "
            f"\"scene\" {N} triangles; warm-up of buckets "
            f"{SERVE_MIN_BUCKET}-{SERVE_MAX_BUCKET} (within r={RADIUS}, "
            f"kNN k={K}, rays k={SERVE_RAY_KS}) {warm_s:.2f} s, "
            f"{warm.cache_misses} cache entries")
        log(f"[serve] {n_req} mixed requests (m = 1-{SERVE_MAX_ROWS}) in "
            f"{len(calls)} handle() calls, {load_s:.3f} s "
            f"({n_req / load_s:.0f} requests/s): 0 cache misses, 0 library "
            f"loads; launches {json.dumps(got)} for "
            f"groups {json.dumps(groups)}; no twin; every response equal "
            "to BVH.query on its version  [" + card + "]")

        # -- handle() against its kernel, bucket by bucket ---------------
        cloud = srv.store.get("cloud").bvh
        rows = []
        for bkt in ladder:
            q = rng.uniform(0, 1, (bkt, 3)).astype(np.float32)
            for kind, req in (("knn", knn_request(q, K, "cloud")),
                              ("within", within_request(q, RADIUS, "cloud"))):
                walls = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    srv.handle([req])
                    walls.append((time.perf_counter() - t1) * 1e3)
                qd = torch.from_numpy(q).to(dev)
                if kind == "knn":
                    preds = P.nearest(G.Points(qd), k=K)

                    def launch():
                        return eng.kernel_knn(cloud, preds)
                    names = ("knn_kernel",)
                else:
                    preds = P.intersects(G.Spheres(qd, torch.full(
                        (bkt,), RADIUS, device=dev)))

                    def launch():
                        return eng.kernel_fill(cloud, preds, SERVE_CAPACITY)
                    names = ("spatial_kernel",)
                w_ms = time_ms(launch, reps=10)
                d_ms = device_ms(launch, reps=20)
                p_ms = kernel_ms(launch, names, reps=5)
                rows.append((kind, bkt, float(np.median(walls)), w_ms, d_ms,
                             p_ms))
        for kind in ("knn", "within"):
            log(f"[serve] handle() of one {kind} bucket against its kernel "
                "(bucket: handle() ms / the wrapper's call, CUDA events / "
                "its device time, the stream held / the kernel under the "
                "profiler / host share of handle() beyond the device time): "
                + "; ".join(
                    f"{bkt}: {h:.3f} / {w:.4f} / {fmt_ms(d)} / {fmt_ms(p)} / "
                    + ("not measured" if d is None
                       else f"{100 * (h - d) / h:.1f} %")
                    for kd, bkt, h, w, d, p in rows if kd == kind)
                + f"  [{card}]")

        # -- telemetry: the engine.kernel span against CUDA events ------
        q = rng.uniform(0, 1, (512, 3)).astype(np.float32)
        preds = P.nearest(G.Points(torch.from_numpy(q).to(dev)), k=K)
        ev_ms = time_ms(lambda: eng.kernel_knn(cloud, preds), reps=20)
        tracer = telemetry.enable(capacity=1 << 16)
        try:
            kus = [srv.handle([knn_request(q, K, "cloud")])[0].stats.kernel_us
                   for _ in range(5)]
            spans = tracer.drain()
        finally:
            telemetry.disable()
        kern = [s for s in spans if s.name == "engine.kernel"]
        check(len(kern) == 5 and all(s.clock == "device" for s in kern),
              "engine.kernel spans missing or not device-clocked")
        check(all(k > 0 for k in kus), "kernel_us is 0 with telemetry on")
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "serve_trace.json")
            telemetry.write_chrome_trace(path, spans)
            with open(path) as fh:
                problems = telemetry.validate_chrome_trace(json.load(fh))
        check(not problems, f"the serve trace is invalid: {problems[:3]}")
        log(f"[serve] kNN bucket 512: engine.kernel span kernel_us "
            f"{float(np.median(kus)):.1f} us (median of 5, fenced on the "
            f"serving stream) vs CUDA events {ev_ms * 1e3:.1f} us; the "
            f"Chrome trace ({len(spans)} spans) passes "
            f"validate_chrome_trace  [{card}]")

        # -- refits and a rebuild through the store ----------------------
        # each move is of the original points (a step's displacement), so
        # the quality monitor keeps refitting
        gen = torch.Generator(device=dev).manual_seed(SEED + 43)
        moves = [pts + SERVE_MOVE_SIGMA * torch.randn(
            pts.shape, generator=gen, device=dev) for _ in range(3)]
        torch.cuda.synchronize()
        zero()
        refit_ms = []
        for moved in moves:
            t1 = time.perf_counter()
            v = srv.update_index("cloud", G.Points(moved))
            refit_ms.append((time.perf_counter() - t1) * 1e3)
            check(v.action == "refit",
                  f"a small move did not refit: {v.action}")
        degradation = v.degradation
        t1 = time.perf_counter()
        v = srv.update_index("cloud", G.Points(moves[-1][:-1]))
        rebuild_ms = (time.perf_counter() - t1) * 1e3
        check(v.action == "rebuild" and v.bvh.size() == N - 1,
              "N - 1 points did not rebuild")
        take_counts()
        log(f"[serve] IndexStore.update at N={N}: three refits "
            + " / ".join(f"{ms:.3f}" for ms in refit_ms) + " ms (SAH "
            f"degradation {degradation:.4f}), a rebuild at N-1 "
            f"{rebuild_ms:.3f} ms (host clock, each ending in a stream "
            f"sync)  [{card}]")
        del moves
        del srv, cloud, v

        # -- the pipeline: 4 clients, 20 refits and a rebuild --------------
        zero()
        pipe = ServingPipeline(
            IndexStore(eng, keep_versions=SERVE_KEEP_VERSIONS),
            config=PipelineConfig(service=svc))
        check(pipe.maintenance_stream is not None,
              "the pipeline has no maintenance stream")
        pipe.create_index("cloud", G.Points(pts))
        pipe.create_index("scene", G.Triangles(a, b, c))
        results = [[] for _ in range(SERVE_CLIENTS)]
        errors = []
        go = threading.Event()

        def client(i):
            crng = np.random.default_rng(SEED + 100 + i)
            go.wait(60)
            try:
                for j in range(SERVE_PER_CLIENT):
                    kind, k = _serve_draw(crng)
                    req = _serve_request(crng, kind, int(crng.integers(
                        1, SERVE_MAX_ROWS + 1)), k)
                    dl = SERVE_DEADLINE_US if j % 2 == 0 else None
                    resp = pipe.submit(req, deadline_us=dl).result(120)
                    results[i].append((req, resp))
            except Exception as err:        # reported below, fails the phase
                errors.append(f"client {i}: {err!r}")

        def maintain():
            # the points drift as in examples/moving_points_service.py: each
            # step moves them from where the last one left them, so the
            # quality monitor rebuilds when the refit tree degrades
            go.wait(60)
            try:
                cur = pts
                for _ in range(SERVE_REFITS):
                    cur = cur + SERVE_MOVE_SIGMA * torch.randn(
                        pts.shape, generator=gen, device=dev)
                    pipe.update_index("cloud", G.Points(cur))
                    check(pipe.wait_maintenance_idle(60), "refit stuck")
                    time.sleep(0.05)
                pipe.update_index("cloud", G.Points(cur[:-1]))
                check(pipe.wait_maintenance_idle(60), "rebuild stuck")
            except BaseException as err:    # reported below
                errors.append(f"maintenance: {err!r}")

        threads = [threading.Thread(target=client, args=(i,), name=f"client{i}")
                   for i in range(SERVE_CLIENTS)]
        threads.append(threading.Thread(target=maintain, name="updates"))
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        go.set()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t0
        pipe.close()
        got = take_counts()
        check(not any(t.is_alive() for t in threads), "a pipeline thread hung")
        check(not errors, f"pipeline: {errors[:3]}")
        st = pipe.stats()
        n_served = SERVE_CLIENTS * SERVE_PER_CLIENT
        check(st.served == st.submitted == n_served and st.failed == 0,
              f"pipeline: served {st.served} of {st.submitted}, "
              f"{st.failed} failed")
        check(st.stalled_behind_maintenance == 0 and st.maintenance_errors == 0,
              f"pipeline: {st.stalled_behind_maintenance} stalls, "
              f"{st.maintenance_errors} maintenance errors")
        check(st.refits + st.rebuilds == SERVE_REFITS + 1,
              f"pipeline: {st.refits} refits and {st.rebuilds} rebuilds for "
              f"{SERVE_REFITS + 1} updates")
        # cloud's versions: 1 the build, then one per update in order
        steps = [pipe.store.get("cloud", v) for v in
                 range(2, SERVE_REFITS + 3)]
        drift = [e.version for e in steps[:-1] if e.action == "rebuild"]
        check(drift and all(e.bvh.size() == N for e in steps[:-1]),
              f"pipeline: no rebuild on drift (actions "
              f"{[e.action for e in steps]})")
        check(steps[-1].action == "rebuild" and steps[-1].bvh.size() == N - 1,
              "pipeline: N - 1 points did not rebuild")
        samples = {}
        lat = []
        for i, rs in enumerate(results):
            last = {}
            for req, resp in rs:
                s = resp.stats
                check(s.index_version >= last.get(s.index_name, 0),
                      f"client {i}: {s.index_name} went back from version "
                      f"{last.get(s.index_name)} to {s.index_version}")
                last[s.index_name] = s.index_version
                lat.append(s.queue_wait_us + s.service_us)
                samples.setdefault((s.index_name, s.index_version, req.kind),
                                   []).append((req, resp))
        versions = sorted({v for (n, v, _) in samples if n == "cloud"})
        check(len(versions) >= 2, f"clients saw only cloud versions {versions}")
        n_checked = 0
        for (name, version, kind), pairs in sorted(samples.items()):
            entry = pipe.store.get(name, version)
            for req, resp in pairs[:SERVE_SAMPLES]:
                _same_as_direct(resp, entry.bvh, req, dev,
                                f"pipeline {name} v{version} {kind}")
                n_checked += 1
        lat = np.sort(np.asarray(lat)) / 1e3
        log(f"[serve] ServingPipeline: {SERVE_CLIENTS} clients x "
            f"{SERVE_PER_CLIENT} requests (half with {SERVE_DEADLINE_US / 1e3:.0f}"
            f" ms deadlines) while the maintenance stream moved \"cloud\" "
            f"{SERVE_REFITS} times by N(0, {SERVE_MOVE_SIGMA}^2) steps that "
            f"add up ({st.refits} refits, rebuilt on drift at versions "
            f"{drift}) and rebuilt it at N-1: {n_served} served in {wall:.2f} s "
            f"({n_served / wall:.0f} requests/s), latency p50 "
            f"{lat[len(lat) // 2]:.3f} ms p99 {lat[int(0.99 * len(lat))]:.3f} "
            f"ms, miss rate {st.miss_rate:.4f}, occupancy {st.occupancy:.4f}, "
            f"{st.batches} batches, 0 failures, 0 stalls behind maintenance; "
            f"cloud versions seen {versions[0]}-{versions[-1]}, monotone per "
            f"client; {n_checked} responses equal to BVH.query on their "
            f"version; launches {json.dumps(got)}  [{card}]")
    finally:
        restore()
    # the serving path's own launches, apart from the main path's
    for kname, n in total.items():
        check(n > 0, f"{kname} was not launched on the serving path")
    log(f"[serve] launches on the serving path (counts zeroed at each "
        f"part's start, read at its end): {json.dumps(total)}")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return calls, served


# ---------------------------------------------------------------------------
# slice 21: the engine's route tables on the card
# ---------------------------------------------------------------------------

ROUTE_N = 1 << 16         # the adversarial tables' index
ROUTE_Q = 1 << 12
ROUTE_RADIUS = 0.033      # about 10 of the 2^16 uniform points a sphere
ROUTE_K = 4
ROUTE_CAP = 32            # the block sizes' fill width (at most 28 matches)
ROUTE_BLOCKS = (128, 256, 512)
# the reference's RouteRule defaults (repro.core.route_table), which its
# adversarial tables keep where they set nothing
REF_RULE = dict(bf_max_work=1 << 22, pallas_min_queries=128,
                pallas_min_leaves=256, pallas_max_nodes=1 << 17,
                pallas_max_capacity=4096, block_q=256)
# tests/test_build_conformance.py's adversarial tables: the defaults,
# everything to brute force, everything to the kernels at an absurd block,
# everything to the loop, a kernel that never fits, no buffer width
ADVERSARIAL = (
    {}, {"bf_max_work": 1 << 40},
    {"bf_max_work": 0, "pallas_min_queries": 1, "pallas_min_leaves": 1,
     "pallas_max_nodes": 1 << 30, "block_q": 8},
    {"bf_max_work": 0, "pallas_min_queries": 1 << 30},
    {"pallas_max_nodes": 1},
    {"bf_max_work": 0, "pallas_max_capacity": 0})


def _csr_keys(res, n):
    """The sorted (query, value) pairs of a CSR result, as q * n + index."""
    import torch
    cnt = res.offsets.diff().to(torch.int64)
    qid = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                               device=cnt.device), cnt)
    return torch.sort(qid * n + res.indices.to(torch.int64))[0]


def _route_results(index, engine, spheres, knn):
    """(routes, results, seconds) of count, CSR, kNN and a counting
    callback through `index`'s table."""
    import torch
    import repro_torch as rt
    t0 = time.perf_counter()
    cb, s0 = rt.callbacks.counting()
    out = dict(count=index.count(spheres),
               csr=_csr_keys(index.query(spheres), index.size()),
               knn=index.query(knn),
               callback=index.query(spheres, callback=(cb, s0)))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    from repro_torch.core.index import _bcast_state
    pol = index.policy
    state = _bcast_state(s0, len(spheres), index.device)
    routes = dict(spatial=engine.route_spatial(index, spheres, policy=pol),
                  knn=engine.route_knn(index, knn, policy=pol),
                  callback=engine.route_callback(index, spheres, cb, state,
                                                 policy=pol))
    return routes, out, secs


def phase_route(dev, pts, qc, card):
    """The route tables on the card: the tuner's quick table, loaded the
    three ways; the reference's adversarial tables and the tuned one
    change routes, never results; both build engines give one tree; the
    walks at 128, 256 and 512 threads a block give one result; the
    reference's ROUTE_TABLE.json is ignored with a RuntimeWarning."""
    import shutil
    import tempfile
    import warnings
    import torch
    import repro_torch as rt
    from repro_torch.core import engine as E
    from repro_torch.core import geometry as G
    from repro_torch.core import lbvh
    from repro_torch.core import route_table as RT
    from repro_torch.kernels import _build
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.launch import autotune as A

    t_phase = time.perf_counter()
    env = os.environ.get("REPRO_TORCH_ROUTE_TABLE")
    tmp = tempfile.mkdtemp(prefix="route-")
    os.environ["REPRO_TORCH_ROUTE_TABLE"] = "off"
    RT._reset_cache()
    try:
        # (1) the tuner's quick grid, into a temporary directory
        t0 = time.perf_counter()
        table = A.tune(quick=True, log=lambda m: log(f"[route] tuner {m}"))
        path = os.path.join(tmp, "ROUTE_TABLE_TORCH.json")
        table.save(path)
        tune_s = time.perf_counter() - t0
        fp = table.fingerprint
        check(fp.get("backend") == "cuda" and "torch" in fp
              and fp.get("device_kind") == torch.cuda.get_device_name(0),
              f"[route] the tuned table's fingerprint does not name the "
              f"card: {fp}")
        check(A.validate(path) == 0, "[route] the tuned table is invalid")
        for line in A.describe(table):
            log(f"[route] tuned rule {line}")
        log(f"[route] tune(quick=True) {tune_s:.1f} s, fingerprint "
            f"{json.dumps(fp)}")

        # (2) the three ways a table comes in, each routing by it: the
        # tuned table's own choice, and a table of this card that sends
        # everything to brute force
        probe = rt.BVH(G.Points(pts[:ROUTE_N]),
                       policy=rt.ExecutionPolicy(device=dev))
        spheres = rt.intersects(G.Spheres(qc[:ROUTE_Q], torch.full(
            (ROUTE_Q,), ROUTE_RADIUS, device=dev)))
        rule = table.rule("spatial")
        want_tuned = (
            "bruteforce" if ROUTE_N * ROUTE_Q <= rule.bf_max_work
            else "kernel" if (ROUTE_Q >= rule.pallas_min_queries
                              and ROUTE_N >= rule.pallas_min_leaves
                              and 2 * ROUTE_N - 1 <= rule.pallas_max_nodes)
            else "loop")
        bf_path = os.path.join(tmp, "everything_bf.json")
        RT.RouteTable(rules={"default": RT.RouteRule(bf_max_work=1 << 40)},
                      fingerprint=RT.hardware_fingerprint()).save(bf_path)
        for label, p, want in (("tuned", path, want_tuned),
                               ("brute force", bf_path, "bruteforce")):
            by_config = E.QueryEngine(E.EngineConfig(route_table=p))
            check(by_config.table().rules == RT.RouteTable.load(p).rules,
                  f"[route] EngineConfig(route_table=path) did not load {p}")
            got = [by_config.route_spatial(probe, spheres),
                   E.QueryEngine().route_spatial(
                       probe, spheres, policy=rt.ExecutionPolicy(
                           device=dev, route_table=p))]
            os.environ["REPRO_TORCH_ROUTE_TABLE"] = p
            RT._reset_cache()
            got.append(E.QueryEngine().route_spatial(probe, spheres))
            os.environ["REPRO_TORCH_ROUTE_TABLE"] = "off"
            RT._reset_cache()
            check(got == [want] * 3, f"[route] the {label} table routes "
                  f"{got} through EngineConfig, ExecutionPolicy and "
                  f"$REPRO_TORCH_ROUTE_TABLE, not {want}")
            log(f"[route] the {label} table through EngineConfig("
                f"route_table=path), ExecutionPolicy(route_table=path) and "
                f"$REPRO_TORCH_ROUTE_TABLE: N={ROUTE_N} Q={ROUTE_Q} -> {want}"
                f" all three")

        # (3) the reference's adversarial tables and the tuned one over a
        # 2^16-point index: the loop route's results are the baseline
        knn = rt.nearest(G.Points(qc[:ROUTE_Q]), k=ROUTE_K)
        tables = [(f"adversarial {i}", RT.RouteTable.single(
            **dict(REF_RULE, **o))) for i, o in enumerate(ADVERSARIAL)]
        tables.append(("tuned", table))
        base = None
        seen = {"spatial": set(), "knn": set(), "callback": set()}
        d2_tol = 4 * 2.0 ** -23 * 6     # brute force's expansion (check_knn)
        order = [3] + [i for i in range(len(tables)) if i != 3]
        for i in order:
            label, tbl = tables[i]
            engine = E.QueryEngine()
            index = rt.BVH(G.Points(pts[:ROUTE_N]), policy=rt.ExecutionPolicy(
                device=dev, engine=engine, route_table=tbl))
            routes, out, secs = _route_results(index, engine, spheres, knn)
            for op, r in routes.items():
                seen[op].add(r)
            if base is None:
                check(set(routes.values()) == {"loop"},
                      f"[route] {label} did not take the loop: {routes}")
                base = out
            check(torch.equal(out["count"], base["count"]),
                  f"[route] {label}: counts differ from the loop route's")
            check(torch.equal(out["csr"], base["csr"]),
                  f"[route] {label}: CSR sets differ from the loop route's")
            check(torch.equal(out["callback"], base["callback"]),
                  f"[route] {label}: callback states differ")
            d, bd = out["knn"].distances, base["knn"].distances
            if routes["knn"] == "bruteforce":
                gap = float((d.double() ** 2 - bd.double() ** 2).abs().max())
                check(gap <= d2_tol, f"[route] {label}: brute-force kNN off "
                      f"the walk's beyond the expansion's error ({gap:.3g})")
                knn_note = f"kNN within the expansion's error ({gap:.3g})"
            else:
                check(torch.equal(d, bd) and torch.equal(
                    out["knn"].indices, base["knn"].indices),
                    f"[route] {label}: kNN differs from the loop route's")
                knn_note = "kNN equal"
            log(f"[route] {label}: routes {json.dumps(routes)}; counts, CSR "
                f"sets and callback states equal to the loop route's, "
                f"{knn_note}; {secs:.2f} s")
        check(all(len(seen[op]) >= 2 for op in seen)
              and seen["spatial"] >= {"bruteforce", "kernel", "loop"},
              f"[route] the tables did not cover the routes: {seen}")

        # (4) both build engines at the main size: one tree, Karras for
        # "pallas" only
        boxes = G.Boxes(pts, pts)
        KB.karras_ranges.launches = 0
        fused = lbvh.build(boxes, engine="pallas")
        torch.cuda.synchronize()
        k_fused = KB.karras_ranges.launches
        plain = lbvh.build(boxes, engine="ref")
        fixpoint = lbvh.build(boxes, engine="ref", refit="iterative")
        torch.cuda.synchronize()
        k_plain = KB.karras_ranges.launches - k_fused
        same_tree(plain, fused, "[route] the ref build")
        same_tree(fixpoint, fused, "[route] the ref build, refit=iterative")
        check(k_fused == 1 and k_plain == 0,
              f"[route] Karras launches: pallas {k_fused}, ref {k_plain}")
        b_ms = {e: time_ms(lambda: lbvh.build(boxes, engine=e), reps=reps)
                for e, reps in (("pallas", 10), ("ref", 2))}
        log(f"[route] build N={N}: engine pallas and ref (refit rmq and "
            f"iterative) give the same tree bit for bit (NaN by place); "
            f"Karras launched {k_fused} / {k_plain}; pallas "
            f"{b_ms['pallas']:.3f} ms, ref {b_ms['ref']:.3f} ms")

        # (5) block_q on the main path's walks, N = 2^20, Q = 2^17
        index = rt.BVH(G.Points(pts), policy=rt.ExecutionPolicy(device=dev))
        eng = E.QueryEngine()
        main_spheres = rt.intersects(G.Spheres(qc, torch.full(
            (Q,), RADIUS, device=dev)))
        main_knn = rt.nearest(G.Points(qc), k=K)
        cb, _ = rt.callbacks.counting()
        s0 = torch.zeros((Q,), dtype=torch.int32, device=dev)
        runs = {}
        for bq in ROUTE_BLOCKS:
            pol = index.policy.override(
                route_table=RT.RouteTable.single(block_q=bq))
            walks = {
                "spatial": lambda: eng.kernel_fill(index, main_spheres,
                                                   ROUTE_CAP, policy=pol),
                "knn": lambda: eng.kernel_knn(index, main_knn, policy=pol),
                "callback": lambda: eng.kernel_callback(
                    index, main_spheres, cb, s0, policy=pol)}
            runs[bq] = {w: (fn(), time_ms(fn, reps=10))
                        for w, fn in walks.items()}
        for bq in ROUTE_BLOCKS:
            for w, (got, _) in runs[bq].items():
                want = runs[256][w][0]
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"[route] the {w} walk at block_q {bq} differs from "
                      f"256")
        for w in ("spatial", "knn", "callback"):
            log(f"[route] {w} walk N={N} Q={Q}: block_q " + ", ".join(
                f"{bq} {runs[bq][w][1]:.4f} ms" for bq in ROUTE_BLOCKS)
                + " (CUDA events, mean of 10); results bit-identical to 256's")
        for src in ("bvh_traverse", "bvh_callback"):
            rows = [r for r in _ptxas_summary(_build.build_log(src))
                    if "<512," in r[0]]
            check(rows, f"[route] {src}: no instance bounded at 512")
            log(f"[route] {src}: {len(rows)} instances bounded at 512 "
                f"threads, at most {max((r[1] for r in rows), default=0)} "
                f"registers, "
                f"{sum(r[2] or 0 for r in rows)} B spill stores in all")

        # (6) the reference's table as the ambient one: ignored, with a
        # RuntimeWarning; routing falls back to the defaults
        os.environ["REPRO_TORCH_ROUTE_TABLE"] = os.path.join(
            ROOT, "ROUTE_TABLE.json")
        RT._reset_cache()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ambient = RT.default_route_table()
            fallback = E.QueryEngine().table()
        check(ambient is None and fallback is E._FALLBACK_TABLE
              and any(issubclass(w.category, RuntimeWarning)
                      for w in caught),
              "[route] the reference's ROUTE_TABLE.json was not ignored")
        log(f"[route] $REPRO_TORCH_ROUTE_TABLE=ROUTE_TABLE.json (the "
            f"reference's, fingerprint jax/cpu): ignored with a "
            f"RuntimeWarning; the engine routes by the built-in defaults")
    finally:
        if env is None:
            os.environ.pop("REPRO_TORCH_ROUTE_TABLE", None)
        else:
            os.environ["REPRO_TORCH_ROUTE_TABLE"] = env
        RT._reset_cache()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[route] phase {time.perf_counter() - t_phase:.1f} s  [{card}]")


# ---------------------------------------------------------------------------
# slice 13: the remaining algorithms (EMST over Nearest.exclude, MLS)
# ---------------------------------------------------------------------------

EMST_SEED = 23            # the clusters cloud's own seed
EMST_TWIN_N = 1 << 14     # points of the run held to the twin every round
EMST_ORACLE_N = 1 << 17   # points of the scipy MST weight oracle
EMST_WEIGHT_RTOL = 1e-6   # the oracle's relative bound (phase_emst)
MLS_CHECK = 2048          # targets held to the float64 solve
U32 = 2.0 ** -24


def clusters_cloud(n, seed):
    """``point_cloud("clusters", n, 3, seed)`` of the reference's data
    pipeline: max(floor(sqrt(n) / 4), 2) uniform centres, each point one
    centre plus N(0, 0.01^2) per coordinate, float32."""
    rng = np.random.default_rng(seed)
    k = max(int(np.sqrt(n) / 4), 2)
    centres = rng.uniform(0, 1, (k, 3))
    idx = rng.integers(0, k, n)
    return (centres[idx] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)


def _tree_check(eu, ev, ew, n, label):
    """N - 1 edges between valid points with finite weights forming one
    component (so no cycle): the spanning-tree property."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    eu, ev, ew = (a.cpu().numpy() for a in (eu, ev, ew))
    check(eu.shape == (n - 1,) and (eu >= 0).all() and (ev >= 0).all()
          and (eu < n).all() and (ev < n).all() and np.isfinite(ew).all(),
          f"emst {label}: the edge buffer is not full of valid edges")
    parts = connected_components(coo_matrix(
        (np.ones(n - 1), (eu, ev)), shape=(n, n)), directed=False)[0]
    check(parts == 1, f"emst {label}: {parts} components, not a tree")
    return eu, ev, ew


def _mst_weight_oracle(x):
    """The float64 weight of the MST of the points `x` (numpy): scipy's
    minimum_spanning_tree over the Delaunay triangulation's edges (an EMST
    is a subgraph of it)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import Delaunay
    x = x.astype(np.float64)
    simplices = Delaunay(x).simplices
    pairs = np.concatenate([simplices[:, [a, b]] for a in range(4)
                            for b in range(a + 1, 4)])
    pairs = np.unique(np.sort(pairs, 1), axis=0)
    w = np.linalg.norm(x[pairs[:, 0]] - x[pairs[:, 1]], axis=1)
    # a zero length (duplicate points) would read as "no edge"
    w = np.maximum(w, np.finfo(np.float64).tiny)
    g = coo_matrix((w, (pairs[:, 0], pairs[:, 1])), shape=(len(x),) * 2)
    return float(minimum_spanning_tree(g).sum())


def _emst_rounds(coords):
    """Run emst once with each round's exclusion query recorded: the query
    labels, the kernel's (d, j), the query's CUDA-event ms, and the tree
    arguments and keywords the path gives the wrapper."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import bvh_traverse as T
    real = rt.BVH._knn_exclude
    rounds = []

    def recorded(self, preds):
        out, ms = timed_once(lambda: real(self, preds))
        t = self.tree
        rounds.append(dict(
            tree=tuple(getattr(t, f) for f in (
                "node_lo", "node_hi", "rope", "left_child", "leaf_perm",
                "range_first", "range_last")),
            labels=preds.exclude[0].clone(), d=out[0][:, 0].clone(),
            j=out[1][:, 0].clone(), ms=ms,
            kw=dict(k=1, records=t.records, order=T.knn_order(
                preds.geom.coords, self.values.coords, t.leaf_perm))))
        return out

    rt.BVH._knn_exclude = recorded
    try:
        result = rt.emst(coords)
    finally:
        rt.BVH._knn_exclude = real
    torch.cuda.synchronize()
    return result, rounds


def _emst_path(coords, label, card):
    """emst on the card with the counters zeroed just before and read just
    after, every twin made to raise: (eu, ev, ew, stats, ms, launches)."""
    import torch
    import repro_torch as rt
    from repro_torch.core import traversal as TT
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    counters = {"bvh_traverse_knn_exclude": T.bvh_traverse_knn_exclude,
                "bvh_traverse_knn": T.bvh_traverse_knn,
                "bvh_traverse_spatial": T.bvh_traverse_spatial,
                "karras_ranges": KB.karras_ranges,
                "lbvh_tail": KB.lbvh_tail, "morton64": KM.morton64}
    restore = _twins_raise()
    walks = TT.knn_walk.calls
    try:
        for f in counters.values():
            f.launches = 0
        stats = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eu, ev, ew = rt.emst(coords, stats=stats)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        restore()
    check(TT.knn_walk.calls == walks,
          f"emst {label}: the loop walk ran {TT.knn_walk.calls - walks} times")
    check(launches["bvh_traverse_knn_exclude"] == stats["rounds"],
          f"emst {label}: {launches['bvh_traverse_knn_exclude']} exclusion "
          f"launches in {stats['rounds']} rounds")
    return eu, ev, ew, stats, ms, launches


def phase_emst(dev, pts, card):
    """EMST at N = 2^20 in 3-D over the smoke's uniform points and over a
    clusters cloud: the tree property, one exclusion launch a round and no
    twin or loop walk on the path (counters zeroed just before, read just
    after), rounds, ms per run, the wrapper's ms per round, host syncs and
    the device's busy share; the first round's kernel against its twin on
    all N rows (the kernels line); every round of a run over the cloud's
    first EMST_TWIN_N points against the twin on every row (tolerance 0:
    the twin, a host loop, takes 12-24 s a round at N = 2^20); the total
    weight against scipy's MST over the Delaunay edges at EMST_ORACLE_N
    points. Returns (the uniform run's launches, the kernels-line record
    of bvh_traverse_knn_exclude)."""
    import torch
    import repro_torch as rt
    from repro_torch.kernels import bvh_traverse as T

    t_phase = time.perf_counter()
    clouds = (("uniform", pts),
              ("clusters", torch.from_numpy(clusters_cloud(N, EMST_SEED)).to(dev)))
    record = path_launches = None
    for label, coords in clouds:
        n = coords.shape[0]
        (eu, ev, ew), rounds = _emst_rounds(coords)
        _tree_check(eu, ev, ew, n, label)
        eu2, ev2, ew2, stats, ms, launches = _emst_path(coords, label, card)
        check(torch.equal(eu2, eu) and torch.equal(ev2, ev)
              and torch.equal(ew2, ew), f"emst {label}: two runs differ")
        check(stats["rounds"] == len(rounds)
              and stats["rounds"] <= math.ceil(math.log2(n)),
              f"emst {label}: {stats['rounds']} rounds")
        _, ms2 = timed_once(lambda: rt.emst(coords))
        comps = [int(torch.unique(rd["labels"]).numel()) for rd in rounds]
        busy, share = profile_window(
            f"emst {label} N={n}", lambda: rt.emst(coords), card,
            share_of="knn_exclude_kernel")
        kms = [rd["ms"] for rd in rounds]
        log(f"[emst] {label} N={n}: a tree (N-1 edges, one component), "
            f"weight {float(ew.double().sum()):.6f}; {stats['rounds']} "
            f"rounds, components per round {comps}; {ms:.1f} / {ms2:.1f} ms "
            f"per run (host clock after synchronize; CUDA events); "
            f"{stats['host_syncs']} host syncs; the exclusion query per "
            f"round {', '.join(f'{x:.3f}' for x in kms)} ms (sum "
            f"{sum(kms):.2f}; CUDA events); busy "
            f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}, "
            f"the kernel "
            f"{'not measured' if share is None else f'{100 * share:.1f} %'} "
            f"of device time; launches {json.dumps(launches)}  [{card}]")
        if label == "uniform":
            path_launches = launches
            record = _emst_kernel_record(coords, rounds[0], card)
        del rounds
        # every round against the twin, every row, at EMST_TWIN_N points
        small = coords[:EMST_TWIN_N]
        _, rounds = _emst_rounds(small)
        t0 = time.perf_counter()
        for r, rd in enumerate(rounds):
            wd, wj = T.bvh_traverse_knn_exclude_ref(
                *rd["tree"], small, rd["labels"], rd["labels"], k=1)
            check(torch.equal(wd[:, 0], rd["d"])
                  and torch.equal(wj[:, 0], rd["j"]),
                  f"emst {label} N={EMST_TWIN_N} round {r + 1}: the "
                  f"exclusion kernel differs from its twin on "
                  f"{int((wj[:, 0] != rd['j']).sum())} rows")
        log(f"[emst] {label} N={EMST_TWIN_N}: all {len(rounds)} rounds "
            f"identical to the twin on every row (tolerance 0; components "
            f"per round {[int(torch.unique(rd['labels']).numel()) for rd in rounds]}; "
            f"twins {time.perf_counter() - t0:.1f} s)")
    # the total weight against scipy at EMST_ORACLE_N points
    for label, coords in clouds:
        x = coords[:EMST_ORACLE_N]
        t0 = time.perf_counter()
        want = _mst_weight_oracle(x.cpu().numpy())
        oracle_s = time.perf_counter() - t0
        eu, ev, ew = _tree_check(*rt.emst(x), EMST_ORACLE_N, label)
        got = float(ew.astype(np.float64).sum())
        rel = abs(got - want) / want
        check(rel <= EMST_WEIGHT_RTOL,
              f"emst {label}: weight {got} against scipy's {want} "
              f"(relative {rel:.3g} > {EMST_WEIGHT_RTOL})")
        log(f"[emst] {label} N={EMST_ORACLE_N}: weight {got:.9f} against "
            f"scipy's MST over the Delaunay edges in float64 {want:.9f}: "
            f"relative {rel:.3g} (bound {EMST_WEIGHT_RTOL}); oracle "
            f"{oracle_s:.1f} s")
    log(f"[emst] phase {time.perf_counter() - t_phase:.1f} s")
    return path_launches, record


def _emst_kernel_record(coords, rd, card):
    """The kernels line's bvh_traverse_knn_exclude: the first round's
    inputs (every label distinct: each point's nearest other point) on all
    N rows, the wrapper against the twin (tolerance 0), both timed."""
    import torch
    from repro_torch.kernels import bvh_traverse as T
    n = coords.shape[0]
    args = (*rd["tree"], coords, rd["labels"], rd["labels"])
    ms = time_ms(lambda: T.bvh_traverse_knn_exclude(*args, **rd["kw"]),
                 reps=5)
    stats = {}
    (wd, wj), plain = timed_once(
        lambda: T.bvh_traverse_knn_exclude_ref(*args, k=1, stats=stats))
    check(torch.equal(wd[:, 0], rd["d"]) and torch.equal(wj[:, 0], rd["j"]),
          "bvh_traverse_knn_exclude: the first round differs from its twin")
    # each input read once (node records or boxes and links, ranges, leaf
    # labels, queries, query labels), each output written once
    nbytes = (tree_bytes(n, 3, True) + (n - 1) * 4 + n * 4 + n * 12 + n * 4
              + n * 8)
    b_ms, b_by = bound(nbytes, n * leaf_ops(3))
    log(f"[emst] bvh_traverse_knn_exclude N={n} k=1, the first round's "
        f"labels: identical to the twin on all {n} rows (tolerance 0); "
        f"{ms:.4f} ms (CUDA events, records and the leaf order as the path "
        f"gives them) vs twin {plain:.1f} ms ({stats['visits'] / n:.1f} node "
        f"visits per query); bound {b_ms:.4f} ms ({b_by})  [{card}]")
    return dict(source="src/repro_torch/csrc/bvh_traverse.cu",
                replaces="src/repro/core/bvh.py:197",
                max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by)


def mls_float64(src, values, tgt, idx, degree, reg=1e-8, expansion=False):
    """(c0, bound) per target: the float64 solution of the MLS systems the
    neighbours `idx` (T, k) give (the same float32 inputs, every step in
    float64) and the bound on a float32 pipeline's distance from it that
    tests/test_torch_mls.py derives (its docstring: weights through the
    fit's residuals, the basis, the k-term sums, LU with partial
    pivoting; twice the first-order sum). `expansion`: the distances came
    from brute force's expansion, else from the kNN kernel's fused sum."""
    import scipy.linalg
    src, values, tgt = (np.asarray(a, np.float64) for a in (src, values, tgt))
    t, k = idx.shape
    dim = src.shape[1]
    dx = src[idx] - tgt[:, None, :]
    d = np.sqrt((dx * dx).sum(-1))
    radius = np.maximum(d[:, -1:], 1e-30) * 1.1
    r = np.clip(d / radius, 0.0, 1.0)
    w = (1.0 - r) ** 4 * (4.0 * r + 1.0)
    parts = [np.ones(dx.shape[:-1] + (1,))]
    if degree >= 1:
        parts.append(dx)
    if degree >= 2:
        iu, ju = np.triu_indices(dim)
        parts.append(dx[..., iu] * dx[..., ju])
    p = np.concatenate(parts, -1)
    m = p.shape[-1]
    f = values[idx]
    a = np.einsum("tki,tk,tkj->tij", p, w, p) + reg * np.eye(m)
    b = np.einsum("tki,tk,tk->ti", p, w, f)
    c = np.linalg.solve(a, b[..., None])[..., 0]
    g = np.linalg.inv(a)[:, 0, :]
    gp = np.abs(np.einsum("ti,tki->tk", g, p))
    ag, ap, ac = np.abs(g), np.abs(p), np.abs(c)
    rho = np.abs(f - np.einsum("tki,ti->tk", p, c))
    pc = np.einsum("tki,ti->tk", ap, ac)
    dd = (dim + 3) * U32 * d
    if expansion:
        e = 2 * (dim + 3) * U32 * ((src * src).sum(-1)[idx]
                                   + (tgt * tgt).sum(-1)[:, None])
        dd = np.minimum(e / np.maximum(d, 1e-300), np.sqrt(e))
    eta = 2.11 * ((dd + r * dd[:, -1:]) / radius + 3 * U32) + 8 * U32
    lu = np.empty_like(a)
    for i in range(t):
        perm, low, up = scipy.linalg.lu(a[i])
        lu[i] = perm @ (np.abs(low) @ np.abs(up))
    weights = (eta * gp * rho).sum(-1)
    basis = 3 * U32 * (w * (np.einsum("ti,tki->tk", ag, ap) * rho
                            + gp * pc)).sum(-1)
    sums = (k + 2) * U32 * np.einsum("ti,tki,tk->t", ag, ap,
                                     w * (pc + np.abs(f)))
    solve = U32 * np.einsum("ti,ti->t", ag, reg * ac
                            + 3 * m * np.einsum("tij,tj->ti", lu, ac))
    return c[:, 0], 2.0 * (weights + basis + sums + solve)


def phase_mls(dev, pts, qc, policy, card):
    """MLS over the 2^20 search points with bench_mls.py's function onto
    the Q = 2^17 queries, degree 0, 1 and 2: one kNN kernel launch a call
    (counters zeroed just before, read just after), no loop walk, the
    neighbours equal to BVH.query(nearest), MLS_CHECK values within the
    stated bound of a float64 solve; ms per degree, the kNN and solve
    shares, the mean absolute error against f."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import interpolation as I
    from repro_torch.core import traversal as TT
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB

    t_phase = time.perf_counter()
    x = pts.double()
    fv = (torch.sin(2 * x[:, 0]) * torch.cos(3 * x[:, 1]) + x[:, 2]).float()
    want_t = (torch.sin(2 * qc[:, 0].double()) * torch.cos(3 * qc[:, 1].double())
              + qc[:, 2].double())
    rows = torch.randperm(Q, generator=torch.Generator(device=dev).manual_seed(
        SEED + 14), device=dev)[:MLS_CHECK]
    for degree in (0, 1, 2):
        k = 2 * I.polynomial_basis_size(3, degree) + 2
        seen = []
        real = rt.BVH._knn_impl

        def spy(self, preds, pol):
            out = real(self, preds, pol)
            seen.append(out)
            return out

        for f in (T.bvh_traverse_knn, KB.karras_ranges):
            f.launches = 0
        walks = TT.knn_walk.calls
        rt.BVH._knn_impl = spy
        try:
            got, ms = timed_once(lambda: rt.mls_interpolate(pts, fv, qc,
                                                            degree=degree))
        finally:
            rt.BVH._knn_impl = real
        launched = T.bvh_traverse_knn.launches
        check(launched == 1 and KB.karras_ranges.launches == 1
              and TT.knn_walk.calls == walks and len(seen) == 1,
              f"mls degree {degree}: {launched} kNN launches, "
              f"{TT.knn_walk.calls - walks} loop walks")
        check(got.shape == (Q,) and bool(torch.isfinite(got).all()),
              f"mls degree {degree}: not Q finite values")
        d, idx = seen[0]
        want = rt.BVH(G.Points(pts), policy=policy).query(
            rt.nearest(G.Points(qc), k=k))
        check(torch.equal(idx, want.indices) and torch.equal(d, want.distances),
              f"mls degree {degree}: neighbours differ from BVH.query(nearest)")
        c64, bnd = mls_float64(pts.cpu().numpy(), fv.cpu().numpy(),
                               qc[rows].cpu().numpy(),
                               idx[rows].cpu().numpy(), degree)
        err = np.abs(got[rows].cpu().numpy().astype(np.float64) - c64)
        check((err <= bnd).all(),
              f"mls degree {degree}: {int((err > bnd).sum())} of {MLS_CHECK} "
              f"values outside the float64 bound")
        mae = float((got.double() - want_t).abs().mean())
        ms_avg = time_ms(lambda: rt.mls_interpolate(pts, fv, qc, degree=degree),
                         reps=3)
        index = rt.BVH(G.Points(pts), policy=policy)
        build_ms = time_ms(lambda: rt.BVH(G.Points(pts), policy=policy),
                           reps=3)
        knn_ms = time_ms(lambda: index.query(rt.nearest(G.Points(qc), k=k)),
                         reps=3)
        busy, share = profile_window(
            f"mls degree {degree} N={N} T={Q}",
            lambda: rt.mls_interpolate(pts, fv, qc, degree=degree), card,
            share_of="knn_kernel")
        log(f"[mls] degree {degree} (k={k}) N={N} T={Q}: {ms:.2f} ms first "
            f"call, {ms_avg:.3f} ms per call (CUDA events): the build "
            f"{build_ms:.3f} ms ({100 * build_ms / ms_avg:.1f} %), the kNN "
            f"query {knn_ms:.3f} ({100 * knn_ms / ms_avg:.1f} %), the basis, "
            f"the normal equations and the solve the rest "
            f"({100 * (1 - (build_ms + knn_ms) / ms_avg):.1f} %); "
            f"{launched} kNN launch; neighbours equal to BVH.query(nearest); "
            f"{MLS_CHECK} values within the float64 bound (largest error "
            f"{err.max():.3g}, largest share of its bound "
            f"{(err / bnd).max():.3g}, median bound {np.median(bnd):.3g}); "
            f"mean |value - f| {mae:.3g}; busy "
            f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}  "
            f"[{card}]")
    log(f"[mls] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# slice 14: the remaining geometries
# ---------------------------------------------------------------------------

GEO_CELLS = 56            # the mesh: 56^3 unit cells of 6 Kuhn tetrahedra
GEO_RADIUS = 0.005        # intersects(Spheres) over triangles and segments
GEO_SEGMENT = 0.01        # the segments' length
GEO_BOX = 0.01            # intersects(Boxes) over the k-DOPs
GEO_TWIN = 1 << 12        # queries the callback kernel is held to its twin on
# queries of the main path's own 2^20-value indexes the fine kNN walk is
# held to its twin on, at each k the path runs: the twin's host loop steps
# once per node of the longest rope walk, about 10,800 visits a query at
# 2^20 triangles and k = 10, and a step of the triangle distance costs
# some 900 PyTorch operations, so it runs on the host CPU, in
# GEO_TWIN_WORKERS spawned processes, while the card goes on with the
# later phases
GEO_KNN_TWIN = 1 << 8
GEO_TWIN_WORKERS = 4
GEO_ORACLE = 1 << 10      # queries held against the float64 oracles
# The oracles' absolute tolerance on a distance: the float32 result
# carries the rounding of the vertices' differences and of the projection
# point, about ulp(1) / 2 = 6e-8 each in the unit cube (a simulation of
# the soup's shapes saw 8.1e-8 at most), so 2^-21 (4 ulp(1)) bounds it
# with room; a relative bound does not hold at the scenes' distances of
# a few 1e-3 and below.
GEO_ATOL = 2.0 ** -21
KUHN = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
# operations of one triangle leaf test, counted from csrc/point_tests.cuh
# (distance_point_triangle: the barycentric coordinates, then the
# projection or three segments), and the bytes of its value record
# (pack_values: three 16-byte vertices)
TRI_LEAF_OPS = 134
TRI_RECORD_BYTES = 48


def kuhn_mesh(dev, m):
    """The cube [0, m]^3 cut into m^3 unit cubes of 6 Kuhn tetrahedra each
    (the paths 0 -> e_s0 -> e_s0 + e_s1 -> (1, 1, 1) over the permutations
    s of the axes, KUHN): tetrahedron 6 cell + s of cell (i, j, k) =
    i m^2 + j m + k, vertices the integer corners in float32."""
    import torch
    ar = torch.arange(m, device=dev)
    ijk = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"),
                      -1).reshape(-1, 3)
    perms = torch.tensor(KUHN, device=dev)
    eye = torch.eye(3, dtype=torch.int64, device=dev)
    v = ijk[:, None, :].expand(-1, 6, -1)
    verts = [v]
    for j in range(3):
        v = v + eye[perms[:, j]]
        verts.append(v)
    return [x.reshape(-1, 3).to(torch.float32) for x in verts]


def kuhn_own(p, m):
    """(own tetrahedron, near a face) of each point of [0, m)^3: the cell
    floor(x) and the order of the fractional parts (exact in float64);
    near when a coordinate lies within 1e-6 of a cell face or two
    fractional parts lie within 1e-6 of each other."""
    import torch
    x = p.double()
    cell = torch.floor(x).clamp(0, m - 1)
    f = x - cell
    order = torch.argsort(-f, dim=1, stable=True)
    code = order[:, 0] * 9 + order[:, 1] * 3 + order[:, 2]
    table = torch.full((27,), -1, dtype=torch.int64, device=p.device)
    for s, (a, b, c) in enumerate(KUHN):
        table[a * 9 + b * 3 + c] = s
    ci = cell.to(torch.int64)
    cell_id = ci[:, 0] * m * m + ci[:, 1] * m + ci[:, 2]
    fs = torch.sort(f, dim=1).values
    near = ((torch.minimum(f, 1 - f) < 1e-6).any(1)
            | ((fs[:, 1:] - fs[:, :-1]) < 1e-6).any(1))
    return cell_id * 6 + table[code], near


def _segment64(p, a, b):
    """(Q, M) float64 distances from points to segments (clamped
    projection), independent of the port's formula."""
    import torch
    ab = b - a
    t = ((p[:, None] - a[None]) * ab[None]).sum(-1) / (ab * ab).sum(-1)
    t = t.clamp(0.0, 1.0)
    return (p[:, None] - (a[None] + t[..., None] * ab[None])).norm(dim=-1)


def _triangle64(p, a, b, c):
    """(Q, M) float64 distances from points to triangles (Ericson, Real-
    Time Collision Detection 5.1.5: the Voronoi regions of the vertices,
    the edges and the face), independent of the port's formula."""
    import torch
    P = p[:, None]
    ab, ac = (b - a)[None], (c - a)[None]
    ap, bp, cp = P - a[None], P - b[None], P - c[None]
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    va, vb, vc = d3 * d6 - d5 * d4, d5 * d2 - d1 * d6, d1 * d4 - d3 * d2
    den = va + vb + vc
    out = a[None] + ab * (vb / den)[..., None] + ac * (vc / den)[..., None]

    def put(mask, val):
        nonlocal out, done
        m = (mask & ~done)[..., None]
        out = torch.where(m, val, out)
        done = done | mask

    done = torch.zeros(d1.shape, dtype=torch.bool, device=p.device)
    safe = lambda x: torch.where(x == 0, torch.ones_like(x), x)  # noqa: E731
    put((d1 <= 0) & (d2 <= 0), a[None].expand_as(out))
    put((d3 >= 0) & (d4 <= d3), b[None].expand_as(out))
    put((vc <= 0) & (d1 >= 0) & (d3 <= 0),
        a[None] + (d1 / safe(d1 - d3))[..., None] * ab)
    put((d6 >= 0) & (d5 <= d6), c[None].expand_as(out))
    put((vb <= 0) & (d2 >= 0) & (d6 <= 0),
        a[None] + (d2 / safe(d2 - d6))[..., None] * ac)
    e = (d4 - d3) / safe((d4 - d3) + (d5 - d6))
    put((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
        b[None] + e[..., None] * (c - b)[None])
    return (P - out).norm(dim=-1)


def _oracle_rows(fn, queries, values, block):
    """fn(queries block, *values) over blocks of queries, float64."""
    import torch
    vals = [v.double() for v in values]
    return torch.cat([fn(queries[s:s + block].double(), *vals)
                      for s in range(0, queries.shape[0], block)])


def _check_knn_oracle(res, d64, k, label):
    """kNN distances within GEO_ATOL of the float64 oracle's k smallest,
    indices the oracle's except where its distances tie within 2 GEO_ATOL;
    returns (largest error, rows with an index swap at a near tie)."""
    import torch
    nq = d64.shape[0]
    od, oi = torch.topk(d64, k + 1, dim=1, largest=False)
    d = res.distances[:nq].double()
    err = float((d - od[:, :k]).abs().max())
    check(err <= GEO_ATOL, f"{label}: kNN distances off the float64 oracle "
          f"by {err:.3g} (tolerance {GEO_ATOL:.3g})")
    got = res.indices[:nq].to(torch.int64)
    gap = torch.cat([od[:, 1:] - od[:, :-1]], 1)
    near = torch.zeros_like(got, dtype=torch.bool)
    near |= gap[:, :k] <= 2 * GEO_ATOL
    near[:, 1:] |= gap[:, :k - 1] <= 2 * GEO_ATOL
    bad = (got != oi[:, :k]) & ~near
    check(not bool(bad.any()), f"{label}: {int(bad.sum())} kNN indices "
          f"differ from the float64 oracle away from a near tie")
    return err, int(((got != oi[:, :k]) & near).any(1).sum())


def _check_csr_oracle(res, d64, r, label):
    """CSR sets against {d64 <= r}: pairs may differ only where d64 lies
    within GEO_ATOL of r; returns the count of such pairs."""
    import torch
    nq, n = d64.shape
    mine = torch.zeros((nq, n), dtype=torch.bool, device=d64.device)
    off = res.offsets[:nq + 1].to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(nq, device=d64.device),
                                   off[1:] - off[:-1])
    mine[rows, res.indices[:int(off[-1])].to(torch.int64)] = True
    want = d64 <= r
    diff = mine != want
    near = (d64 - r).abs() <= GEO_ATOL
    check(bool((~diff | near).all()), f"{label}: {int((diff & ~near).sum())} "
          f"pairs differ from the float64 oracle away from the radius")
    return int(want.sum()), int(diff.sum())


def _fine_knn_twin(tree, kind, fields, queries, k):
    """The fine kNN walk's twin (bvh_traverse_fine_knn_ref) on the host
    CPU, in a spawned worker: `tree` (node_lo, node_hi, rope, left_child,
    leaf_perm) and `fields` (the values of class `kind`) are a main-path
    index's arrays and `queries` (Q, 3) points, all numpy. Returns
    (dists, idxs, seconds, node visits of all queries)."""
    import torch
    from repro_torch.core import geometry as G
    from repro_torch.kernels import bvh_traverse as T
    torch.set_num_threads(1)
    values = getattr(G, kind)(*map(torch.from_numpy, fields))
    stats = {}
    t0 = time.perf_counter()
    d, i = T.bvh_traverse_fine_knn_ref(
        *map(torch.from_numpy, tree), values,
        G.Points(torch.from_numpy(queries)), k=k, stats=stats)
    return d.numpy(), i.numpy(), time.perf_counter() - t0, stats["visits"]


GEO_FIELDS = {"Triangles": ("a", "b", "c"), "Segments": ("a", "b"),
              "Spheres": ("center", "radius")}


#: straddles of the fine kNN walk's certificate on the card: the
#: anomalous triangles of straddle_set at 5 scales and in the 8 octants
STRADDLE_SCALES = (-16, -8, 0, 8, 16)


def straddle_set():
    """(triangles (a, b, c), points) numpy float32 of the fine kNN walk's
    straddles (tests/test_torch_fine_knn_walk.py's straddle_instances):
    triangle A = (c, b, a), whose box's lo corner a lies just above the
    point q, has a fine distance below its box key (the edges' fma(1,
    a - x, x) round the vertex toward q), and the point a, as a
    degenerate triangle, lies at that box key from q: a nearest-first
    list keeps A where the rope walk may keep the point. A seeded search
    in the walk's float order on the host; each instance scaled by 2^e
    (e in STRADDLE_SCALES) and mirrored into an octant, which keep its
    float behaviour (exact power-of-two scalings, sign flips)."""
    import torch
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    rng = np.random.default_rng(SEED + 41)
    m = 512
    a = rng.uniform(0.05, 0.1, (m, 3)).astype(np.float32)
    b = (a + rng.uniform(0.2, 0.6, (m, 3))).astype(np.float32)
    c = (a + rng.uniform(0.2, 0.6, (m, 3))).astype(np.float32)
    q = (a - rng.uniform(0.0005, 0.02, (m, 3))).astype(np.float32)
    t = [torch.from_numpy(x) for x in (a, b, c, q)]
    pred = P.nearest(G.Points(t[3]), 1)
    tri = G.Triangles(t[2], t[1], t[0])
    box = G.to_boxes(tri)
    keep = ((P.leaf_distance(pred, tri, "walk")
             < P.node_min_distance(pred, box.lo, box.hi))
            & (P.leaf_distance(pred, G.Triangles(t[0], t[0], t[0]), "walk")
               == P.node_min_distance(pred, box.lo, box.hi))).numpy()
    count = 8 * len(STRADDLE_SCALES)
    check(int(keep.sum()) >= count, "straddle_set: too few anomalous "
          "triangles in the search")
    a, b, c, q = (x[keep][:count] for x in (a, b, c, q))
    octant = np.arange(count) % 8
    sign = np.stack([np.where(octant >> j & 1, -1.0, 1.0) for j in range(3)],
                    1)
    scale = np.ldexp(1.0, np.repeat(STRADDLE_SCALES, 8))[:, None] * sign
    a, b, c, q = ((x * scale).astype(np.float32) for x in (a, b, c, q))
    return (np.concatenate([c, a]), np.concatenate([b, a]),
            np.concatenate([a, a])), q


def _fine_variants():
    """scripts/fine_knn_variants.py as a module (its counting build)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "fine_knn_variants", os.path.join(ROOT, "scripts",
                                          "fine_knn_variants.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def start_counting_build():
    """The fine kNN walk's counting build (node visits a query;
    scripts/fine_knn_variants.py), one nvcc in a thread beside the
    phases: (the variants module, a future of its library)."""
    fv = _fine_variants()
    pool = concurrent.futures.ThreadPoolExecutor(1)
    counting = pool.submit(fv.build_counted,
                           os.path.join(ROOT, "build", "fine_knn_counted"))
    pool.shutdown(wait=False)
    return fv, counting


def geometry_scenes(dev):
    """(soup, spheres, segments, points) of phase_geometry's nearest
    queries: make_soup's 2^20 triangles, 2^20 spheres of radius
    SPHERE_RADIUS (the ray phase's), 2^20 segments of length GEO_SEGMENT,
    and Q uniform points in the unit cube, from the seed."""
    import torch
    from repro_torch.core import geometry as G
    a, b, c, _, _ = make_soup(dev)
    soup = G.Triangles(a, b, c)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    spheres = G.Spheres(torch.rand((N, 3), generator=gen, device=dev),
                        torch.full((N,), SPHERE_RADIUS, device=dev))
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    sa = torch.rand((N, 3), generator=gen, device=dev)
    u = torch.randn((N, 3), generator=gen, device=dev)
    segs = G.Segments(sa, sa + GEO_SEGMENT * u / u.norm(dim=1, keepdim=True))
    pq = torch.rand((Q, 3), generator=gen, device=dev)
    return soup, spheres, segs, pq


def phase_geometry(dev, policy, card, counting=None):
    """Slice 14 end to end: BVH over the tetrahedral mesh, the triangle
    soup, segments, k-DOPs and the ray phase's spheres, answering
    intersects (point location, spheres, boxes) and nearest (k = 1, 10)
    with the counters zeroed just before and read just after; then the
    callback kernel against its twin on the first GEO_TWIN queries (bit
    for bit), the results against float64 oracles on the first
    GEO_ORACLE, and each query's time. Starts the fine kNN twin over the
    first GEO_KNN_TWIN queries of every nearest query in worker processes
    (phase_geometry_twins collects them). `counting`: the started
    counting build (start_counting_build), else it starts here. Returns
    (launches, callback record, pending twin work)."""
    import torch
    import repro_torch as rt
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    from repro_torch.core import traversal as TW
    from repro_torch.core.index import _bcast_state
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import bvh_traverse as T

    t_phase = time.perf_counter()
    fv, counting = counting or start_counting_build()
    soup, spheres, segs, pq = geometry_scenes(dev)
    a, b, c = soup.a, soup.b, soup.c
    mesh = G.Tetrahedra(*kuhn_mesh(dev, GEO_CELLS))
    dirs = G.kdop_directions(3, 14, device=dev)
    support = torch.stack([a, b, c], 1) @ dirs.T
    kdops = G.KDOPs(support.amin(1), support.amax(1), dirs)
    del support
    points = G.Points(pq)
    mesh_points = G.Points(pq * GEO_CELLS)
    balls = G.Spheres(pq, torch.full((Q,), GEO_RADIUS, device=dev))
    boxes = G.Boxes(pq, pq + GEO_BOX)
    n_tet = len(mesh)
    check(n_tet == 6 * GEO_CELLS ** 3, f"the mesh holds {n_tet} tetrahedra")

    # -- the main path, counters zeroed just before and read just after ---
    engine = rt.QueryEngine()
    pol = policy.override(engine=engine)
    counters = {"bvh_traverse_callback": KC.bvh_traverse_callback,
                "bvh_traverse_fine_knn": T.bvh_traverse_fine_knn,
                "bvh_traverse_knn": T.bvh_traverse_knn,
                "bvh_traverse_spatial": T.bvh_traverse_spatial}
    for f in counters.values():
        f.launches = 0
    walks = TW.knn_walk.calls
    t1 = time.perf_counter()
    idx = {"tetrahedra": rt.BVH(mesh, policy=pol),
           "triangles": rt.BVH(soup, policy=pol),
           "segments": rt.BVH(segs, policy=pol),
           "kdops": rt.BVH(kdops, policy=pol),
           "spheres": rt.BVH(spheres, policy=pol)}
    queries = {"tetrahedra": ("intersects", P.intersects(mesh_points)),
               "triangles": ("intersects", P.intersects(balls)),
               "segments": ("intersects", P.intersects(balls)),
               "kdops": ("intersects", P.intersects(boxes))}
    knn_keys = (("triangles", 10), ("triangles", 1), ("segments", 10),
                ("spheres", 10), ("segments", 1))
    res, ms_once = {}, {}
    for kind, (_, pred) in queries.items():
        res[kind], ms_once[kind] = timed_once(lambda: idx[kind].query(pred))
    flag_counts = {}
    for kind, k in knn_keys:
        res[kind, k], ms_once[kind, k] = timed_once(
            lambda: idx[kind].query(P.nearest(points, k)))
        # the device count of the queries the rope walk re-walked, read
        # after the path
        flag_counts[kind, k] = T.bvh_traverse_fine_knn.flagged
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    batches = dict(engine.callback_batches)
    path_s = time.perf_counter() - t1
    check(launches["bvh_traverse_callback"] == 8 and batches == {
        "kernel": 8, "loop": 0}, "the four intersects queries did not launch "
          f"the callback kernel twice each: {json.dumps(launches)}, "
          f"batches {json.dumps(batches)}")
    check(launches["bvh_traverse_fine_knn"] == 5
          and launches["bvh_traverse_knn"] == 0
          and launches["bvh_traverse_spatial"] == 0
          and TW.knn_walk.calls == walks,
          "the five nearest queries did not launch the fine kNN kernel once "
          f"each (or a loop walk ran): {json.dumps(launches)}")
    for kind, r in res.items():
        if isinstance(kind, tuple):
            k = kind[1]
            check(r.distances.shape == (Q, k)
                  and bool(torch.isfinite(r.distances).all())
                  and bool((r.indices >= 0).all())
                  and bool((r.distances[:, 1:] >= r.distances[:, :-1]).all()),
                  f"nearest {kind}: shape, padding or order")
        else:
            check(r.offsets.shape == (Q + 1,)
                  and bool((r.offsets[1:] >= r.offsets[:-1]).all()),
                  f"intersects {kind}: offsets")
    log(f"[geometry] main path {path_s:.1f} s: BVH over {n_tet} tetrahedra "
        f"({GEO_CELLS}^3 Kuhn cells of side 1), {N} triangles (the soup), "
        f"{N} segments (length {GEO_SEGMENT}), {N} 14-DOPs (the soup's), {N} "
        f"spheres (the ray phase's); Q={Q}; launches {json.dumps(launches)}, "
        f"callback batches {json.dumps(batches)}, no loop walk")

    # -- the fine kNN walk (nearest first, the certificate, the rope walk's
    # re-walk of the flagged queries) against the rope walk alone on all Q
    # queries of each nearest query, bit for bit; the two timed in turns
    # (walk, rope, rope, walk); the node visits a query from the counting
    # build of scripts/fine_knn_variants.py -------------------------------
    counted = counting.result()
    fine_ms, rope_ms = {}, {}
    for kind, k in knn_keys:
        index = idx[kind]
        t_ = index.tree
        args = (t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.leaf_perm,
                index.values, points)
        kept = dict(k=k, records=t_.records,
                    value_records=index.value_records)
        rd, ri = T.bvh_traverse_fine_knn_rope(*args, **kept)
        r = res[kind, k]
        bad = ~((rd == r.distances) & (ri == r.indices)).all(1)
        check(not bool(bad.any()), f"fine kNN {kind} k={k}: the main path "
              f"differs from the rope walk on {int(bad.sum())} of {Q} "
              "queries")
        del rd, ri
        walk = lambda: T.bvh_traverse_fine_knn(*args, **kept)
        rope = lambda: T.bvh_traverse_fine_knn_rope(*args, **kept)
        w1, r1 = time_ms(walk, reps=3), time_ms(rope, reps=2)
        r2, w2 = time_ms(rope, reps=2), time_ms(walk, reps=3)
        fine_ms[kind, k], rope_ms[kind, k] = (w1 + w2) / 2, (r1 + r2) / 2
        visits, extra, ties = fv.counted_visits(counted, walk, Q)
        log(f"[geometry] fine kNN {kind} k={k}: all {Q} queries identical to "
            f"the rope walk (tolerance 0); "
            f"{int(flag_counts[kind, k].item())} flagged and re-walked on the "
            f"main path; {visits:.1f} node visits a query ({extra:.2f} more "
            f"in the certificate and tie pass, {ties} queries took the tie "
            f"pass); nearest first {w1:.3f} / {w2:.3f} ms, rope walk "
            f"{r1:.3f} / {r2:.3f} ms ({rope_ms[kind, k] / fine_ms[kind, k]:.1f}"
            f"x)  [{card}]")

    # -- the straddles: flagged on the card, the lists the twin's ---------
    (sa_, sb_, sc_), sq = straddle_set()
    st = G.Triangles(*(torch.from_numpy(x).to(dev) for x in (sa_, sb_, sc_)))
    sidx = rt.BVH(st, policy=policy)
    stree = sidx.tree
    sargs = (stree.node_lo, stree.node_hi, stree.rope, stree.left_child,
             stree.leaf_perm, st, G.Points(torch.from_numpy(sq).to(dev)))
    for k in (1, 4):
        gd, gi = T.bvh_traverse_fine_knn(*sargs, k=k, records=stree.records,
                                         value_records=sidx.value_records)
        flagged = int(T.bvh_traverse_fine_knn.flagged.item())
        wd, wi = T.bvh_traverse_fine_knn_ref(
            *(x.cpu() for x in sargs[:5]), st.to("cpu"),
            G.Points(torch.from_numpy(sq)), k=k)
        check(torch.equal(gd.cpu(), wd) and torch.equal(gi.cpu(), wi),
              f"fine kNN straddles k={k}: the kernel differs from the twin")
        check(k > 1 or flagged >= 1, "fine kNN straddles: no query flagged")
        log(f"[geometry] fine kNN straddles ({len(sq)} anomalous triangles "
            f"and their near vertices, scales 2^{STRADDLE_SCALES}, 8 "
            f"octants) k={k}: {flagged} of {len(sq)} queries flagged and "
            f"re-walked on the card; the lists identical to the twin "
            f"(tolerance 0)")
    del sidx, st, stree, sargs

    # -- the fine kNN twin on the first GEO_KNN_TWIN queries of each
    # nearest query, over the main path's own indexes, on the host CPU in
    # worker processes (the longest first) while the card goes on ------
    pool = multiprocessing.get_context("spawn").Pool(GEO_TWIN_WORKERS)
    atexit.register(pool.terminate)
    qn = pq[:GEO_KNN_TWIN].cpu().numpy()
    host = {}
    for kind in ("triangles", "segments", "spheres"):
        t_, v = idx[kind].tree, idx[kind].values
        host[kind] = ([x.cpu().numpy() for x in (
            t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.leaf_perm)],
            type(v).__name__,
            [getattr(v, f).cpu().numpy() for f in GEO_FIELDS[type(v).__name__]])
    jobs = {key: pool.apply_async(_fine_knn_twin,
                                  (*host[key[0]], qn, key[1]))
            for key in knn_keys}
    pool.close()
    del host
    rows = {key: (res[key].distances[:GEO_KNN_TWIN].cpu(),
                  res[key].indices[:GEO_KNN_TWIN].cpu()) for key in knn_keys}
    # the wrapper on those queries alone: the same rows, and the kernel's
    # time at the twin's shape
    sub_points = points.index(slice(0, GEO_KNN_TWIN))
    kernel_sub_ms = {}
    for kind, k in knn_keys:
        index = idx[kind]
        t_ = index.tree
        call = (lambda: T.bvh_traverse_fine_knn(
            t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.leaf_perm,
            index.values, sub_points, k=k, records=t_.records,
            value_records=index.value_records))
        gd, gi = call()
        check(torch.equal(gd.cpu(), rows[kind, k][0])
              and torch.equal(gi.cpu(), rows[kind, k][1]),
              f"fine kNN {kind} k={k}: the first {GEO_KNN_TWIN} queries alone "
              "differ from the main path's rows")
        kernel_sub_ms[kind, k] = time_ms(call, reps=3)

    # -- times (CUDA events; the first call above, then the mean of 3) ----
    times = {}
    for kind, (_, pred) in queries.items():
        times[kind] = time_ms(lambda: idx[kind].query(pred), reps=3)
    for key in knn_keys:
        times[key] = time_ms(lambda: idx[key[0]].query(
            P.nearest(points, key[1])), reps=3)
    build_ms = {kind: time_ms(lambda: rt.BVH(index.values, policy=policy),
                              reps=2) for kind, index in idx.items()}
    for key, ms in times.items():
        r = res[key]
        what = (f"nearest(Points, k={key[1]}) over {key[0]}"
                if isinstance(key, tuple) else
                f"{queries[key][0]}({type(P.geometry_of(queries[key][1])).__name__}) "
                f"over {key}, {int(r.offsets[-1])} pairs")
        log(f"[geometry] {what}: {ms:.3f} ms a query (first call "
            f"{ms_once[key]:.3f} ms), Q={Q}  [{card}]")
    log(f"[geometry] builds: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in build_ms.items()) + f"  [{card}]")

    # -- the tetrahedral mesh: analytic point location --------------------
    own, near = kuhn_own(mesh_points.coords, GEO_CELLS)
    rt_ = res["tetrahedra"]
    off = rt_.offsets.to(torch.int64)
    counts = off[1:] - off[:-1]
    rows_ = torch.repeat_interleave(torch.arange(Q, device=dev), counts)
    hit_own = torch.zeros((Q,), dtype=torch.bool, device=dev)
    hit_own[rows_[rt_.indices.to(torch.int64) == own[rows_]]] = True
    check(bool(hit_own.all()), f"point location: {int((~hit_own).sum())} "
          "points miss their own tetrahedron")
    inner = ~near
    check(bool((counts[inner] == 1).all()),
          f"point location: {int((counts[inner] != 1).sum())} inner points "
          "match more than their own tetrahedron")
    log(f"[geometry] point location over {n_tet} tetrahedra of [0, "
        f"{GEO_CELLS}]^3, Q={Q}: every point holds its own tetrahedron (cell "
        f"floor(x), the order of the fractional parts); the "
        f"{int(inner.sum())} points farther than 1e-6 from a cell face or a "
        f"fractional tie match it alone; {int(near.sum())} near points, "
        f"{int(counts[near].sum())} matches among them, counted")

    # -- the callback kernel against its twin on the first GEO_TWIN queries
    twin_ms, kernel_ms_, cb_err = {}, {}, 0.0
    sub = {"points": mesh_points.index(slice(0, GEO_TWIN)),
           "balls": P.intersects(balls.index(slice(0, GEO_TWIN))),
           "boxes": P.intersects(boxes.index(slice(0, GEO_TWIN)))}
    twin_preds = {"tetrahedra": P.intersects(sub["points"]),
                  "triangles": sub["balls"], "segments": sub["balls"],
                  "kdops": sub["boxes"]}
    for kind, pred in twin_preds.items():
        index = idx[kind]
        t_ = index.tree
        tree = (t_.node_lo, t_.node_hi, t_.rope, t_.left_child,
                t_.range_last, t_.leaf_perm)
        kept = dict(records=t_.records, value_records=index.value_records)
        for name in ("counting", "collect_hits"):
            cb, s0 = (rt.callbacks.counting() if name == "counting"
                      else rt.callbacks.collect_hits(64))
            s0q = _bcast_state(s0, GEO_TWIN, dev)
            got = KC.bvh_traverse_callback(*tree, index.values, pred, cb, s0q,
                                           **kept)
            want, plain = timed_once(lambda: KC.bvh_traverse_callback_ref(
                *tree, index.values, pred, cb, s0q))
            cb_err = max(cb_err, check_state(
                got, want, f"bvh_traverse_callback {kind}/{name}"))
            twin_ms[kind, name] = plain
            kernel_ms_[kind, name] = time_ms(lambda: KC.bvh_traverse_callback(
                *tree, index.values, pred, cb, s0q, **kept), reps=3)
            if name == "counting":
                check(torch.equal(got, (res[kind].offsets[1:GEO_TWIN + 1]
                                        - res[kind].offsets[:GEO_TWIN])),
                      f"{kind}: the counting walk differs from the CSR "
                      "query's counts")
        del want, got
    for (kind, name), plain in twin_ms.items():
        log(f"[geometry] callback {kind}/{name}: the first {GEO_TWIN} "
            f"queries identical to the twin (tolerance 0), twin "
            f"{plain:.1f} ms, kernel on those queries "
            f"{kernel_ms_[kind, name]:.3f} ms  [{card}]")
    log(f"[geometry] shaped_kernel3<Counting> "
        f"({_registers('bvh_callback', 'shaped_kernel3<256, Counting>')}), "
        f"shaped_kernel3<Collect<0>> "
        f"({_registers('bvh_callback', 'shaped_kernel3<256, Collect<0>>')}), "
        f"callback_kernel3<Counting> "
        f"({_registers('bvh_callback', 'callback_kernel3<256, Counting>')}); "
        f"fine_nf_kernel<Records3, KeyList 16> "
        f"({_registers('fine_knn', 'fine_nf_kernel<Records3, KeyList 16>')}), "
        f"<Records3, KeyList 1> "
        f"({_registers('fine_knn', 'fine_nf_kernel<Records3, KeyList 1>')}), "
        f"fine_rope_kernel<Records3, KeyList 16> "
        f"({_registers('fine_knn', 'fine_rope_kernel<Records3, KeyList 16>')})")

    # -- float64 oracles on the first GEO_ORACLE queries -------------------
    po = pq[:GEO_ORACLE]
    for kind, fn, verts in (("triangles", _triangle64, (a, b, c)),
                            ("segments", _segment64, (segs.a, segs.b))):
        d64 = _oracle_rows(fn, po, verts, 8)
        pairs, ndiff = _check_csr_oracle(res[kind], d64, GEO_RADIUS,
                                         f"intersects over {kind}")
        errs = []
        for k in (1, 10):
            err, swaps = _check_knn_oracle(res[kind, k], d64, k,
                                           f"nearest over {kind}")
            rel = float((res[kind, k].distances[:GEO_ORACLE].double()
                         - torch.topk(d64, k, dim=1, largest=False).values)
                        .abs().div(torch.topk(d64, k, dim=1, largest=False)
                                   .values.clamp_min(1e-30)).max())
            errs.append(f"k={k}: largest error {err:.3g} ({rel:.3g} relative), "
                        f"{swaps} rows with an index swap at a near tie")
        log(f"[geometry] {kind} vs a float64 oracle on {GEO_ORACLE} queries: "
            f"spheres r={GEO_RADIUS} {pairs} pairs, {ndiff} differ, all "
            f"within {GEO_ATOL:.3g} of r; {'; '.join(errs)}")
        del d64
    sc, sr = spheres.center.double(), spheres.radius.double()
    d64 = torch.cat([((po[s:s + 8].double()[:, None] - sc[None]).norm(dim=-1)
                      - sr[None]).clamp_min(0.0)
                     for s in range(0, GEO_ORACLE, 8)])
    err, swaps = _check_knn_oracle(res["spheres", 10], d64, 10,
                                   "nearest over spheres")
    log(f"[geometry] spheres k=10 vs a float64 oracle on {GEO_ORACLE} "
        f"queries: largest error {err:.3g}, {swaps} rows with a swap at a "
        f"near tie")
    del d64
    bf = rt.BruteForce(kdops, policy=policy).query(
        P.intersects(boxes.index(slice(0, GEO_ORACLE))))
    check_csr(res["kdops"], bf, GEO_ORACLE, "intersects(Boxes) over kdops")
    log(f"[geometry] k-DOPs: {GEO_ORACLE} boxes' CSR sets equal "
        f"BruteForce's ({int(bf.offsets[-1])} pairs)")

    # -- records for the kernels line --------------------------------------
    # bytes: the queries, the tree and the value records once, the output
    # state; operations: one leaf test per match (callback) or per
    # returned neighbour (kNN)
    pairs = int(res["triangles"].offsets[-1])
    cb_bound, cb_by = bound(Q * 16 + tree_bytes(N, 3, True)
                            + N * TRI_RECORD_BYTES + Q * 4,
                            pairs * TRI_LEAF_OPS)
    t_ = idx["triangles"].tree
    cb, s0 = rt.callbacks.counting()
    s0q = _bcast_state(s0, Q, dev)
    cb_full = time_ms(lambda: KC.bvh_traverse_callback(
        t_.node_lo, t_.node_hi, t_.rope, t_.left_child, t_.range_last,
        t_.leaf_perm, soup, P.intersects(balls), cb, s0q, records=t_.records,
        value_records=idx["triangles"].value_records), reps=3)
    cb_record = dict(source="src/repro_torch/csrc/bvh_callback.cu",
                     replaces="src/repro/kernels/bvh_callback.py:251",
                     max_abs_err=cb_err, ms=cb_full,
                     plain_ms=twin_ms["triangles", "counting"],
                     bound_ms=cb_bound, bound_by=cb_by)
    knn_bound, knn_by = bound(Q * 12 + tree_bytes(N, 3, False)
                              + N * TRI_RECORD_BYTES + Q * 10 * 8,
                              Q * 10 * TRI_LEAF_OPS)
    # max_abs_err and plain_ms come from the twin (phase_geometry_twins)
    knn_record = dict(source="src/repro_torch/csrc/fine_knn.cu",
                      replaces="src/repro/core/bvh.py:215",
                      ms=fine_ms["triangles", 10], bound_ms=knn_bound,
                      bound_by=knn_by)
    log(f"[geometry] kernels line: callback (shaped_kernel3<Counting>, "
        f"spheres over the soup) {cb_full:.3f} ms at Q={Q} ({pairs} matches; "
        f"bound {cb_bound:.4f} ms, {cb_by}; twin {twin_ms['triangles', 'counting']:.1f} "
        f"ms on the card over the first {GEO_TWIN} queries, a smaller shape); "
        f"fine kNN (triangles k=10) {fine_ms['triangles', 10]:.3f} ms a "
        f"call at Q={Q} (the rope walk alone "
        f"{rope_ms['triangles', 10]:.3f} ms; bound {knn_bound:.4f} ms, "
        f"{knn_by}), "
        f"{kernel_sub_ms['triangles', 10]:.3f} ms on the first "
        f"{GEO_KNN_TWIN} queries, the twin's shape  [{card}]; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del idx, res
    return ({"bvh_traverse_callback": launches["bvh_traverse_callback"],
             "bvh_traverse_fine_knn": launches["bvh_traverse_fine_knn"]},
            cb_record, dict(pool=pool, jobs=jobs, rows=rows,
                            kernel_sub_ms=kernel_sub_ms, record=knn_record))


def phase_geometry_twins(pending, card):
    """The fine kNN walk's main-path rows against the twin's lists from
    phase_geometry's workers, bit for bit (ties, order); returns the
    walk's record for the kernels line, its plain_ms the twin's host-CPU
    time over the first GEO_KNN_TWIN queries (triangles, k = 10)."""
    import torch
    t0 = time.perf_counter()
    err, twin_s = 0.0, {}
    for (kind, k), job in pending["jobs"].items():
        wd, wi, secs, visits = job.get(timeout=900)
        wd, wi = torch.from_numpy(wd), torch.from_numpy(wi)
        gd, gi = pending["rows"][kind, k]
        bad = ~((gd == wd) & (gi == wi)).all(1)
        check(not bool(bad.any()), f"fine kNN {kind} k={k}: the main path "
              f"differs from the twin on {int(bad.sum())} of the first "
              f"{GEO_KNN_TWIN} queries")
        fin = torch.isfinite(wd)
        err = max(err, float((gd[fin] - wd[fin]).abs().max()) if bool(
            fin.any()) else 0.0)
        twin_s[kind, k] = secs
        log(f"[geometry] fine kNN {kind} k={k} over the main path's {N} "
            f"values: the first {GEO_KNN_TWIN} queries identical to the twin "
            f"(tolerance 0, ties and order); twin {secs:.1f} s on the host "
            f"CPU, one thread ({visits / GEO_KNN_TWIN:.1f} node visits a "
            f"query); the kernel on those queries "
            f"{pending['kernel_sub_ms'][kind, k]:.3f} ms  [{card}]")
    pool = pending["pool"]
    pool.join()
    atexit.unregister(pool.terminate)
    log(f"[geometry] the twins' wait {time.perf_counter() - t0:.1f} s")
    return dict(pending["record"], max_abs_err=err,
                plain_ms=twin_s["triangles", 10] * 1e3)


# ---------------------------------------------------------------------------
# slice 15: distributed search (DistributedTree, the sharded serving stack)
# ---------------------------------------------------------------------------

DIST_RANKS = 4            # gloo ranks sharing the one card
DIST_RAYS = 1 << 15       # RayNearest (k = 4) over the main path's boxes
DIST_RAY_K = 4
DIST_SHIP = 1 << 10       # ship_values queries (the first of each block)
DIST_REPS = 3             # timed calls of each kind
DIST_GROUP_TIMEOUT_S = 60     # every collective of a rank's process group
DIST_WORLD_TIMEOUT_S = 600    # a whole world, start to exit
DIST_LABEL = ("4 gloo ranks sharing one card, collectives through host "
              "memory")
#: the kernels of the distributed path, with the wrappers' launch counters
DIST_KERNELS = ("morton64", "karras_ranges", "lbvh_tail", "bvh_traverse_knn",
                "bvh_traverse_callback", "bvh_traverse_ray_knn")
DIST_STAGES = ("gather", "local", "exchange", "merge", "ship")
SHARD_STAGES = ("gather", "local_traverse", "exchange", "merge")


def _dist_counters():
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels import lbvh_build as KB
    from repro_torch.kernels import morton as KM
    return {"morton64": KM.morton64, "karras_ranges": KB.karras_ranges,
            "lbvh_tail": KB.lbvh_tail, "bvh_traverse_knn": T.bvh_traverse_knn,
            "bvh_traverse_callback": KC.bvh_traverse_callback,
            "bvh_traverse_ray_knn": T.bvh_traverse_ray_knn}


def _stage_ms(spans, prefix, stages, reps):
    """Mean ms per call of each stage: the fenced spans `prefix.<stage>`
    summed over `reps` calls."""
    out = {}
    for st in stages:
        us = sum(s.dur_ns for s in spans if s.name == f"{prefix}.{st}") / 1e3
        if us:
            out[st] = us / 1e3 / reps
    return out


def _rank_distributed(dev, rank, ranks):
    """One rank's [distributed] work: its block of the main path's points
    (and boxes), its block of the queries; the counters zeroed just
    before the drive and read just after; then each kind timed, wall
    clock per call and, with telemetry on, per stage."""
    import torch
    import repro_torch as rt
    from repro_torch import telemetry
    from repro_torch.core import callbacks as CB
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    pts, box_lo, box_hi, qc = make_data(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    ro = torch.rand((DIST_RAYS, 3), generator=gen, device=dev)
    rd = torch.randn((DIST_RAYS, 3), generator=gen, device=dev)
    nl, ql, rl = N // ranks, Q // ranks, DIST_RAYS // ranks
    blk, qb, rb = (slice(rank * n, (rank + 1) * n) for n in (nl, ql, rl))
    counters = _dist_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    dt = rt.DistributedTree(None, G.Points(pts[blk]))
    bx = rt.DistributedTree(None, G.Boxes(box_lo[blk], box_hi[blk]))
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    sph = P.intersects(G.Spheres(qc[qb], torch.full((ql,), RADIUS,
                                                    device=dev)))
    ship_q = qc[qb][:DIST_SHIP // ranks]
    ship = P.intersects(G.Spheres(ship_q, torch.full(
        (len(ship_q),), RADIUS, device=dev)))
    kinds = {
        "knn": lambda: dt.query(P.nearest(G.Points(qc[qb]), k=K)),
        "count": lambda: dt.count(sph),
        "csr": lambda: dt.query(sph),
        "min_distance": lambda: dt.query(
            sph, callback=CB.min_distance(),
            policy=dt.policy.override(combine=torch.minimum)),
        "ray": lambda: bx.query(P.RayNearest(G.Rays(ro[rb], rd[rb]),
                                             DIST_RAY_K)),
        "ship": lambda: dt.query(ship, policy=dt.policy.override(
            ship_values=True)),
    }
    got = {name: fn() for name, fn in kinds.items()}
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    wall, stages = {}, {}
    for name, fn in kinds.items():
        t0 = time.perf_counter()
        for _ in range(DIST_REPS):
            fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3 / DIST_REPS
        tracer = telemetry.enable(capacity=1 << 16)
        try:
            for _ in range(DIST_REPS):
                fn()
            spans = tracer.drain()
        finally:
            telemetry.disable()
        stages[name] = _stage_ms(spans, "distributed", DIST_STAGES, DIST_REPS)

    def host(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    b = dt.bounds()
    return {
        "launches": launches, "build_ms": build_ms, "wall": wall,
        "stages": stages, "bounds": (host(b.lo), host(b.hi)),
        "knn": tuple(map(host, (got["knn"].distances, got["knn"].indices))),
        "count": host(got["count"]),
        "csr": (host(got["csr"].offsets), host(got["csr"].indices)),
        "min_distance": host(got["min_distance"]),
        "ray": tuple(map(host, (got["ray"].distances, got["ray"].indices))),
        "ship": (host(got["ship"].offsets), host(got["ship"].indices),
                 host(got["ship"].values.coords)),
    }


def _response_rows(resps):
    """The arrays of a list of Responses, in order."""
    return [(r.stats.route, r.stats.index_version, r.stats.cache_hit,
             r.dists, r.idxs, r.counts, r.overflow) for r in resps]


def _digest(rows):
    import hashlib
    h = hashlib.sha256()
    for row in rows:
        for x in row:
            h.update(x.tobytes() if isinstance(x, np.ndarray)
                     else repr(x).encode())
    return h.hexdigest()


def _rank_sharded(dev, rank, ranks):
    """One rank's [sharded] work: a ShardedIndexStore behind a QueryServer
    over its blocks of "cloud" and "scene", warmed as [serve] warms, then
    [serve]'s 1,000 requests with telemetry off (the rate; the counters
    zeroed just before and read just after) and again with telemetry on
    (every stage fenced, for the split); then a drifted update and a
    scrambled one."""
    import torch
    from repro_torch import telemetry
    from repro_torch.core import geometry as G
    from repro_torch.service import (QueryServer, ServiceConfig,
                                     ShardedIndexStore, knn_request,
                                     ray_request, within_request)
    pts = make_data(dev)[0]
    a, b, c, _, _ = make_soup(dev)
    nl = N // ranks
    blk = slice(rank * nl, (rank + 1) * nl)
    srv = QueryServer(store=ShardedIndexStore(None), config=ServiceConfig(
        capacity=SERVE_CAPACITY, min_bucket=SERVE_MIN_BUCKET,
        max_bucket=SERVE_MAX_BUCKET))
    v_cloud = srv.create_index("cloud", G.Points(pts[blk]))
    srv.create_index("scene", G.Triangles(a[blk], b[blk], c[blk]))
    t0 = time.perf_counter()
    bkt = SERVE_MIN_BUCKET
    while bkt <= SERVE_MAX_BUCKET:
        z = np.zeros((bkt, 3), np.float32)
        srv.handle([within_request(z, RADIUS, "cloud"),
                    knn_request(z, K, "cloud")]
                   + [ray_request(z, np.ones((bkt, 3), np.float32), k,
                                  "scene") for k in SERVE_RAY_KS])
        bkt *= 2
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 41)          # [serve]'s draw
    calls = []
    for _ in range(SERVE_REQUESTS // SERVE_PER_CALL):
        reqs = []
        for _ in range(SERVE_PER_CALL):
            kind, k = _serve_draw(rng)
            reqs.append(_serve_request(
                rng, kind, int(rng.integers(1, SERVE_MAX_ROWS + 1)), k))
        calls.append(reqs)
    # the rate from a pass with telemetry off (nothing fenced), the
    # counters zeroed just before and read just after
    counters = _dist_counters()
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    served = [srv.handle(reqs) for reqs in calls]
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    # the per-stage split from a second pass with telemetry on
    tracer = telemetry.enable(capacity=1 << 18)
    try:
        t0 = time.perf_counter()
        fenced = [srv.handle(reqs) for reqs in calls]
        torch.cuda.synchronize()
        fenced_s = time.perf_counter() - t0
        spans = tracer.drain()
    finally:
        telemetry.disable()
    groups = {}
    for sp in spans:
        if sp.name == "sharded.execute_group":
            groups[sp.args["kind"]] = groups.get(sp.args["kind"], 0) + 1
    stages = {}
    for kind, n in groups.items():
        mine = [sp for sp in spans if sp.args.get("kind") == kind]
        stages[kind] = _stage_ms(mine, "sharded", SHARD_STAGES + (
            "execute_group",), n)
        stages[kind]["assemble"] = sum(
            sp.dur_ns for sp in mine if sp.name == "server.assemble") / 1e6 / n
    rows = [_response_rows(resps) for resps in served]
    check(_digest([r for call in rows for r in call]) == _digest(
        [r for resps in fenced for r in _response_rows(resps)]),
          f"[sharded] rank {rank}: the fenced pass answered differently")
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    drift = pts + SERVE_MOVE_SIGMA * torch.randn(pts.shape, generator=gen,
                                                 device=dev)
    scrambled = pts[torch.randperm(N, generator=gen, device=dev)]
    t0 = time.perf_counter()
    v_drift = srv.update_index("cloud", G.Points(drift[blk]))
    refit_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    v_scr = srv.update_index("cloud", G.Points(scrambled[blk]))
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    (after,) = srv.handle([knn_request(np.asarray(
        drift[:4].cpu(), np.float32), K, "cloud")])
    return srv.engine, {
        "warm_s": warm_s, "load_s": load_s, "fenced_s": fenced_s,
        "launches": launches,
        "groups": groups, "stages": stages, "digest": _digest(
            [r for call in rows for r in call]),
        "rows": rows if rank == 0 else None,
        "cold": sum(not r.stats.cache_hit for rs in served for r in rs),
        "updates": [(v.version, v.action, v.sah, v.sah_built)
                    for v in (v_cloud, v_drift, v_scr)],
        "after_version": after.stats.index_version,
        "refit_ms": refit_ms, "rebuild_ms": rebuild_ms,
    }


PIPE_CLIENTS = 4          # client threads on the leader
PIPE_PER_CLIENT = 100     # closed-loop requests each
PIPE_MOVES = 5            # update_index calls of "cloud" during the load
PIPE_SEED = SEED + 91


def pipe_cloud(pts, v):
    """"cloud" at pipeline version v: the points (v = 1), then drifted
    by N(0, SERVE_MOVE_SIGMA^2) from a seed of their own (v = 2..6)."""
    import torch
    if v == 1:
        return pts
    gen = torch.Generator(device=pts.device).manual_seed(PIPE_SEED + v)
    return pts + SERVE_MOVE_SIGMA * torch.randn(pts.shape, generator=gen,
                                                device=pts.device)


def pipe_requests(client):
    """Client `client`'s requests: [serve]'s mix from a seed of its own,
    every second one with a 20 ms deadline."""
    rng = np.random.default_rng(PIPE_SEED + 100 * client)
    out = []
    for n in range(PIPE_PER_CLIENT):
        kind, k = _serve_draw(rng)
        req = _serve_request(rng, kind, int(rng.integers(1, SERVE_MAX_ROWS
                                                         + 1)), k)
        out.append((req, SERVE_DEADLINE_US if n % 2 else None))
    return out


def _rank_pipeline(dev, rank, ranks, engine):
    """One rank's pipeline pass: ``ServingPipeline`` over a new
    ShardedIndexStore on the warm engine. Rank 0 leads: it builds "cloud"
    and "scene" (global values), runs the clients and moves "cloud";
    the other ranks follow until its close."""
    import threading
    import torch
    from repro_torch.core import geometry as G
    from repro_torch.service import (PipelineConfig, ServiceConfig,
                                     ServingPipeline, ShardedIndexStore)
    from repro_torch.service.pipeline import PipelineStats
    store = ShardedIndexStore(None, engine=engine)
    pipe = ServingPipeline(store=store, config=PipelineConfig(
        service=ServiceConfig(capacity=SERVE_CAPACITY,
                              min_bucket=SERVE_MIN_BUCKET,
                              max_bucket=SERVE_MAX_BUCKET)))
    counters = _dist_counters()
    out = {}
    if rank == 0:
        pts = make_data(dev)[0]
        a, b, c, _, _ = make_soup(dev)
        t0 = time.perf_counter()
        pipe.create_index("cloud", G.Points(pts))
        pipe.create_index("scene", G.Triangles(a, b, c))
        out["create_s"] = time.perf_counter() - t0
        reqs = [pipe_requests(cl) for cl in range(PIPE_CLIENTS)]
        done, versions = [0], [(1, "build")]
        cv = threading.Condition()
        results = [[None] * PIPE_PER_CLIENT for _ in range(PIPE_CLIENTS)]
        errors = []

        def client(cl):
            for n, (req, deadline) in enumerate(reqs[cl]):
                t = time.perf_counter()
                try:
                    resp = pipe.submit(req, deadline_us=deadline).result(120)
                except Exception as err:        # counted, checked after
                    errors.append(f"client {cl} request {n}: {err!r}")
                    resp = None
                results[cl][n] = (resp, time.perf_counter() - t)
                with cv:
                    done[0] += 1
                    cv.notify_all()

        def mover():
            step = PIPE_CLIENTS * PIPE_PER_CLIENT // (PIPE_MOVES + 1)
            for v in range(2, PIPE_MOVES + 2):
                with cv:
                    cv.wait_for(lambda: done[0] >= step * (v - 1))
                pipe.update_index("cloud", G.Points(pipe_cloud(pts, v)))
                check(pipe.wait_maintenance_idle(120.0),
                      "[sharded] pipeline: maintenance did not go idle")
                e = store.get("cloud")
                versions.append((e.version, e.action))

        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        threads = [threading.Thread(target=client, args=(cl,))
                   for cl in range(PIPE_CLIENTS)]
        threads.append(threading.Thread(target=mover))
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads[:-1]:
            th.join()
        load_s = time.perf_counter() - t0
        threads[-1].join()
        pipe.close()
        lat = np.array([t for rs in results for _, t in rs]) * 1e3
        out.update(
            load_s=load_s, errors=errors, versions=versions,
            p50_ms=float(np.percentile(lat, 50)),
            p99_ms=float(np.percentile(lat, 99)),
            rows=[[(r.kind, r.k, r.a, r.b, d,
                    None if resp is None else _response_rows([resp])[0])
                   for (r, d), (resp, _) in zip(reqs[cl], results[cl])]
                  for cl in range(PIPE_CLIENTS)])
    else:
        torch.cuda.synchronize()
        for f in counters.values():
            f.launches = 0
        pipe.close(timeout=DIST_WORLD_TIMEOUT_S)
    torch.cuda.synchronize()
    s = pipe.stats()
    out.update(
        launches={k: f.launches for k, f in counters.items()},
        stats={f: getattr(s, f) for f in PipelineStats._FIELDS},
        alive=pipe._scheduler.is_alive() or pipe._maintainer.is_alive(),
        error=None if pipe.error is None else repr(pipe.error),
        version=store.get("cloud").version,
        action=store.get("cloud").action)
    return out


def rank_main(argv):
    """One rank of a world that phase_distributed starts: ``--rank r
    --ranks R --backend gloo|nccl --store FILE --out DIR --role
    distributed|nccl``. Joins the group, runs its part on the card and
    saves its results to DIR/rank<r>.pt."""
    import argparse
    import datetime
    import torch
    import torch.distributed as dist
    p = argparse.ArgumentParser()
    for flag in ("--rank", "--ranks"):
        p.add_argument(flag, type=int, required=True)
    for flag in ("--backend", "--store", "--out", "--role"):
        p.add_argument(flag, required=True)
    args = p.parse_args(argv)
    check(torch.cuda.is_available(), "a rank found no CUDA device")
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    dist.init_process_group(
        args.backend, init_method="file://" + args.store, rank=args.rank,
        world_size=args.ranks,
        timeout=datetime.timedelta(seconds=DIST_GROUP_TIMEOUT_S))
    restore = _twins_raise()
    try:
        out = {"backend": dist.get_backend()}
        out.update(_rank_distributed(dev, args.rank, args.ranks))
        if args.role == "distributed":
            engine, out["sharded"] = _rank_sharded(dev, args.rank,
                                                   args.ranks)
            out["pipeline"] = _rank_pipeline(dev, args.rank, args.ranks,
                                             engine)
        torch.save(out, os.path.join(args.out, f"rank{args.rank}.pt"))
    finally:
        restore()
        dist.destroy_process_group()
    return 0


def _world(role, backend, ranks, tmp):
    """Run `ranks` fresh processes of this script, one rank each, in one
    process group; every process is stopped on a failure or after
    DIST_WORLD_TIMEOUT_S, and a failed rank fails the phase. Returns
    (each rank's results, the world's wall seconds)."""
    import torch
    out = os.path.join(tmp, role)
    os.makedirs(out)
    store = os.path.join(tmp, f"{role}.store")
    logs = [open(os.path.join(tmp, f"{role}{r}.log"), "w+")
            for r in range(ranks)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--ranks", str(ranks), "--backend", backend, "--store", store,
         "--out", out, "--role", role], stdout=lg, stderr=subprocess.STDOUT)
        for r, lg in enumerate(logs)]

    def stop():
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()

    atexit.register(stop)
    failed = None
    try:
        while any(pr.poll() is None for pr in procs):
            bad = [r for r, pr in enumerate(procs)
                   if pr.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                break
            if time.perf_counter() - t0 > DIST_WORLD_TIMEOUT_S:
                failed = f"the world outlived {DIST_WORLD_TIMEOUT_S} s"
                break
            time.sleep(0.2)
        if failed is None:
            bad = [r for r, pr in enumerate(procs) if pr.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
    finally:
        stop()
        atexit.unregister(stop)
    texts = []
    for lg in logs:
        lg.seek(0)
        texts.append(lg.read())
        lg.close()
    if failed is not None:
        fail(f"[{role}] {failed}:\n" + "\n".join(
            f"--- rank {r}\n{t[-4000:]}" for r, t in enumerate(texts)))
    return ([torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
             for r in range(ranks)], time.perf_counter() - t0)


def _tie_rows(d, gi, wi):
    """Rows whose indices differ from `wi` only where the distance ties a
    neighbour in its row; fails on any other difference."""
    import torch
    diff = gi != wi
    tie = torch.zeros_like(diff)
    eq = d[:, 1:] == d[:, :-1]
    tie[:, 1:] |= eq
    tie[:, :-1] |= eq
    check(not bool((diff & ~tie).any()),
          f"{int((diff & ~tie).sum())} kNN indices differ beyond ties")
    return int(diff.any(1).sum())


def _cat_csr(parts):
    """(offsets, indices) of the ranks' CSR blocks, in rank order."""
    import torch
    offs, at = [parts[0][0][:1]], 0
    for off, _ in parts:
        offs.append(off[1:] + at)
        at += int(off[-1])
    return torch.cat(offs), torch.cat([idx for _, idx in parts])


def _same_csr_sets(off, idx, w_off, w_idx, n, label):
    import torch
    check(torch.equal(off, w_off), f"{label}: CSR offsets differ")
    q = torch.repeat_interleave(torch.arange(len(off) - 1),
                                (off[1:] - off[:-1]).long())
    check(torch.equal(torch.sort(q * n + idx.long())[0],
                      torch.sort(q * n + w_idx.long())[0]),
          f"{label}: CSR index sets differ")


def _same_response(got, want, label):
    """A sharded response against the single-device server's: the same
    version and overflow, counts equal and index sets equal where a row
    fits the capacity; distances (t for rays) bit-identical and indices
    equal except among ties. Returns 1 when tie swaps moved indices."""
    import torch
    route, version, hit, d, i, counts, over = got
    check(route == "sharded", f"{label}: served on route {route}")
    check(version == want.stats.index_version, f"{label}: version")
    check(over == want.overflow, f"{label}: overflow flag")
    if counts is not None:
        check(np.array_equal(counts, want.counts), f"{label}: counts differ")
        for row, c, w in zip(i, counts, want.idxs):
            if c <= SERVE_CAPACITY:
                check(np.array_equal(np.sort(row[:c]), np.sort(w[:c]))
                      and (row[c:] == -1).all(),
                      f"{label}: within index set differs")
        return 0
    check(np.array_equal(d.view(np.int32), want.dists.view(np.int32)),
          f"{label}: distances differ")
    return int(_tie_rows(torch.from_numpy(d), torch.from_numpy(i),
                         torch.from_numpy(want.idxs)) > 0)


def phase_distributed(dev, pts, box_lo, box_hi, qc, serve_calls, serve_resps,
                      card):
    """[distributed] and [sharded] in one world of DIST_RANKS gloo ranks
    on the one card, then [distributed]'s queries again in an NCCL world
    of one rank; every result held against one port BVH over all 2^20
    points (or boxes) on the card, and [sharded]'s responses against
    [serve]'s single-device QueryServer. Each rank's launches are checked
    and logged here; none goes into the kernels line."""
    import tempfile
    import torch
    import repro_torch as rt
    from repro_torch.core import callbacks as CB
    from repro_torch.core import geometry as G
    from repro_torch.core import predicates as P
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        gloo, gloo_s = _world("distributed", "gloo", DIST_RANKS, tmp)
        nccl, nccl_s = _world("nccl", "nccl", 1, tmp)
    check([r["backend"] for r in gloo] == ["gloo"] * DIST_RANKS
          and nccl[0]["backend"] == "nccl", "a world ran on another backend")

    # the single BVH over all the points (and boxes), on the card, held
    # to the kernel route, which the ranks' local steps take
    pol = rt.ExecutionPolicy(engine=rt.QueryEngine(rt.EngineConfig(
        force="kernel")))
    bvh = rt.BVH(G.Points(pts), policy=pol)
    bvb = rt.BVH(G.Boxes(box_lo, box_hi), policy=pol)
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    ro = torch.rand((DIST_RAYS, 3), generator=gen, device=dev)
    rd = torch.randn((DIST_RAYS, 3), generator=gen, device=dev)
    sph = P.intersects(G.Spheres(qc, torch.full((Q,), RADIUS, device=dev)))
    w_knn = bvh.query(P.nearest(G.Points(qc), k=K))
    w_csr = bvh.query(sph)
    want = {
        "knn": (w_knn.distances.cpu(), w_knn.indices.cpu()),
        "count": bvh.count(sph).cpu(),
        "csr": (w_csr.offsets.cpu(), w_csr.indices.cpu()),
        "min_distance": bvh.query(sph, callback=CB.min_distance()).cpu(),
    }
    w_ray = bvb.query(P.RayNearest(G.Rays(ro, rd), DIST_RAY_K))
    want["ray"] = (w_ray.distances.cpu(), w_ray.indices.cpu())
    pts_h = pts.cpu()

    def held(res, label, exact):
        """The world's results (`res`, its ranks' blocks in order) against
        the single BVH; returns the kNN and ray rows with tie swaps."""
        d = torch.cat([r["knn"][0] for r in res])
        i = torch.cat([r["knn"][1] for r in res])
        check(torch.equal(d.view(torch.int32), want["knn"][0].view(
            torch.int32)), f"{label}: kNN distances differ")
        ties = {"knn": _tie_rows(d, i, want["knn"][1])}
        for key in ("count", "min_distance"):
            got = torch.cat([r[key] for r in res])
            check(torch.equal(got.view(torch.int32),
                              want[key].view(torch.int32)),
                  f"{label}: {key} states differ")
        off, idx = _cat_csr([r["csr"] for r in res])
        _same_csr_sets(off, idx, *want["csr"], N, f"{label} CSR")
        t = torch.cat([r["ray"][0] for r in res])
        ri = torch.cat([r["ray"][1] for r in res])
        check(torch.equal(t.view(torch.int32), want["ray"][0].view(
            torch.int32)), f"{label}: ray t differ")
        ties["ray"] = _tie_rows(t, ri, want["ray"][1])
        ql = Q // len(res)          # each rank ships its block's first rows
        ship_rows = torch.cat([torch.arange(r * ql, r * ql + DIST_SHIP
                                            // len(res))
                               for r in range(len(res))])
        s_off, s_idx = _cat_csr([r["ship"][:2] for r in res])
        s_val = torch.cat([r["ship"][2] for r in res])
        w_off = torch.cat([torch.zeros(1, dtype=torch.int32), torch.cumsum(
            want["count"][ship_rows], 0).to(torch.int32)])
        check(torch.equal(s_off, w_off), f"{label}: ship offsets differ")
        check(torch.equal(s_val.view(torch.int32),
                          pts_h[s_idx.long()].view(torch.int32)),
              f"{label}: shipped values are not the matched points")
        w_off_all, w_idx_all = want["csr"]
        w_sub = torch.cat([w_idx_all[w_off_all[q]:w_off_all[q + 1]]
                           for q in ship_rows.tolist()])
        _same_csr_sets(s_off, s_idx, w_off, w_sub, N, f"{label} ship")
        if exact:
            check(torch.equal(i, want["knn"][1])
                  and torch.equal(ri, want["ray"][1]),
                  f"{label}: kNN or ray indices differ from the single BVH")
        return ties

    ties = held(gloo, f"[distributed] {DIST_LABEL}", exact=False)
    held(nccl, "[distributed] NCCL, one rank", exact=True)
    for r, res in enumerate(gloo):
        for k in DIST_KERNELS:
            check(res["launches"][k] > 0,
                  f"[distributed] rank {r}: {k} was not launched")
    for r, res in enumerate(gloo):
        log(f"[distributed] rank {r} launches (counts zeroed just before "
            f"its builds and six queries, read just after): "
            f"{json.dumps(res['launches'])}")
    log(f"[distributed] {DIST_RANKS} ranks x {N // DIST_RANKS} points (and "
        f"boxes of side {BOX_SIDE}) a rank, Q = {Q} ({Q // DIST_RANKS} a "
        f"rank): kNN k={K}, count / CSR / min_distance (combine="
        f"torch.minimum) of spheres r={RADIUS}, RayNearest k={DIST_RAY_K} "
        f"over {DIST_RAYS} rays and the boxes, ship_values over {DIST_SHIP} "
        f"queries; all equal to one BVH over the {N} points (boxes) on the "
        f"card: counts and states bit-identical, CSR sets equal, kNN and "
        f"ray distances bit-identical, indices apart only among ties in "
        f"{ties['knn']} kNN rows and {ties['ray']} ray rows, the shipped "
        f"values the matched points; the NCCL world (one rank, device "
        f"tensors) identical, indices included; worlds {gloo_s:.1f} s "
        f"(gloo) and {nccl_s:.1f} s (NCCL), start to exit  [{card}]")
    for label, res in ((DIST_LABEL, gloo[0]), ("NCCL, one rank", nccl[0])):
        log(f"[distributed] {label}: build of the local trees "
            f"{res['build_ms']:.1f} ms (rank 0); ms per call (wall clock, "
            f"rank 0, mean of {DIST_REPS}) and, with telemetry on, per "
            f"stage: " + "; ".join(
                f"{k} {res['wall'][k]:.2f} (" + ", ".join(
                    f"{st} {ms:.2f}" for st, ms in res["stages"][k].items())
                + ")" for k in res["wall"]) + f"  [{card}]")

    # [sharded]
    shard = [r["sharded"] for r in gloo]
    check(len({s["digest"] for s in shard}) == 1,
          "[sharded] the ranks' responses differ")
    rows = shard[0]["rows"]
    swaps = n_req = 0
    for reqs, resps, got in zip(serve_calls, serve_resps, rows):
        for req, want_r, got_r in zip(reqs, resps, got):
            swaps += _same_response(got_r, want_r,
                                    f"[sharded] {req.kind} m={req.m}")
            n_req += 1
    for r, s in enumerate(shard):
        check(s["cold"] == 0, f"[sharded] rank {r}: a cold plan after the "
              "warm-up")
        for k in ("bvh_traverse_knn", "bvh_traverse_callback",
                  "bvh_traverse_ray_knn"):
            check(s["launches"][k] > 0, f"[sharded] rank {r}: {k} was not "
                  "launched")
        check(all(s["launches"][k] == 0 for k in
                  ("morton64", "karras_ranges", "lbvh_tail")),
              f"[sharded] rank {r}: serving launched a build kernel")
        acts = [(v, a) for v, a, _, _ in s["updates"]]
        check(acts == [(1, "build"), (2, "refit"), (3, "rebuild")]
              and s["after_version"] == 3,
              f"[sharded] rank {r}: versions and actions {acts}")
    s0 = shard[0]
    log(f"[sharded] ShardedIndexStore + QueryServer, {DIST_LABEL}: \"cloud\" "
        f"and \"scene\" of {N} points / triangles ({N // DIST_RANKS} a "
        f"rank); warm-up of buckets {SERVE_MIN_BUCKET}-{SERVE_MAX_BUCKET} "
        f"{s0['warm_s']:.2f} s; [serve]'s {n_req} mixed requests in "
        f"{len(rows)} handle() calls, {s0['load_s']:.3f} s "
        f"({n_req / s0['load_s']:.0f} requests/s, telemetry off; "
        f"{s0['fenced_s']:.3f} s with telemetry on, every stage fenced), "
        f"identical on every rank, all warm, each equal to the "
        f"single-device QueryServer's response (ties swapped indices in "
        f"{swaps}); groups {json.dumps(s0['groups'])}; rank 0 launches "
        f"{json.dumps(s0['launches'])}  [{card}]")
    for kind, st in s0["stages"].items():
        log(f"[sharded] {kind}: ms per group (rank 0, fenced spans): "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
            + f"  [{DIST_LABEL}; {card}]")
    log(f"[sharded] updates on every rank: a drift of N(0, "
        f"{SERVE_MOVE_SIGMA}^2) refit {s0['refit_ms']:.1f} ms (per-rank SAH "
        + ", ".join(f"{x:.4f}" for x in s0["updates"][1][2])
        + f"), a scrambled cloud rebuilt {s0['rebuild_ms']:.1f} ms; "
        f"versions 1 build, 2 refit, 3 rebuild  [{card}]")
    phase_sharded_pipeline(dev, pts, [r["pipeline"] for r in gloo], card)
    log(f"[distributed] phase {time.perf_counter() - t_phase:.1f} s")


def phase_sharded_pipeline(dev, pts, pipes, card):
    """[sharded]'s pipeline pass, checked: the ranks' loops ended on the
    leader's stop, every ticket served, nothing stalled or failed in
    maintenance, the same versions and groups on every rank, the path's
    kernels launched on every rank, and every response equal to a
    single-device QueryServer's at the version it was served at."""
    from repro_torch.core import geometry as G
    from repro_torch.service import (QueryServer, ServiceConfig, knn_request,
                                     ray_request, within_request)
    lead = pipes[0]
    n_req = PIPE_CLIENTS * PIPE_PER_CLIENT
    check(not lead["errors"], "[sharded] pipeline: failed tickets: "
          + "; ".join(lead["errors"][:3]))
    st = lead["stats"]
    check(st["served"] == n_req and st["failed"] == 0,
          f"[sharded] pipeline: served {st['served']}, failed {st['failed']}")
    want_versions = list(range(1, PIPE_MOVES + 2))
    check([v for v, _ in lead["versions"]] == want_versions,
          f"[sharded] pipeline: versions {lead['versions']}")
    for r, p in enumerate(pipes):
        label = f"[sharded] pipeline rank {r}"
        check(not p["alive"] and p["error"] is None,
              f"{label}: loops alive {p['alive']}, ended on {p['error']}")
        check(p["stats"]["maintenance_errors"] == 0
              and p["stats"]["stalled_behind_maintenance"] == 0,
              f"{label}: maintenance errors or stalls {p['stats']}")
        check((p["version"], p["action"]) == lead["versions"][-1],
              f"{label}: cloud at {p['version']} {p['action']}, the leader "
              f"at {lead['versions'][-1]}")
        check(p["stats"]["swap_count"] == PIPE_MOVES,
              f"{label}: {p['stats']['swap_count']} swaps")
        check(p["stats"]["batches"] == st["batches"],
              f"{label}: served {p['stats']['batches']} groups, the leader "
              f"{st['batches']}")
        for k in ("bvh_traverse_knn", "bvh_traverse_callback",
                  "bvh_traverse_ray_knn"):
            check(p["launches"][k] > 0, f"{label}: {k} was not launched")
    # every response against a single-device server at its version
    a, b, c, _, _ = make_soup(dev)
    srv = QueryServer(config=ServiceConfig(
        capacity=SERVE_CAPACITY, min_bucket=SERVE_MIN_BUCKET,
        max_bucket=SERVE_MAX_BUCKET))
    srv.create_index("cloud", G.Points(pts))
    srv.create_index("scene", G.Triangles(a, b, c))
    by_version = {}
    for rows in lead["rows"]:
        for kind, k, qa, qb, _, got in rows:
            if kind == "knn":
                req = knn_request(qa, k, "cloud")
            elif kind == "within":
                req = within_request(qa, qb, "cloud")
            else:
                req = ray_request(qa, qb, k, "scene")
            v = 0 if kind == "ray" else got[1]
            by_version.setdefault(v, []).append((req, got))
    swaps = 0
    for v in sorted(by_version):
        if v > 1:
            while srv.store.get("cloud").version < v:
                nxt = srv.store.get("cloud").version + 1
                srv.update_index("cloud", G.Points(pipe_cloud(pts, nxt)))
        reqs = [req for req, _ in by_version[v]]
        for (req, got), want in zip(by_version[v], srv.handle(reqs)):
            swaps += _same_response(
                got, want, f"[sharded] pipeline {req.kind} m={req.m} v{v}")
    groups = [p["stats"]["batches"] for p in pipes]
    log(f"[sharded] pipeline, {DIST_LABEL}: ServingPipeline at R = "
        f"{len(pipes)} (rank 0 leads), \"cloud\" and \"scene\" built "
        f"through the leader in {lead['create_s']:.2f} s; {PIPE_CLIENTS} "
        f"closed-loop clients x {PIPE_PER_CLIENT} requests of [serve]'s mix "
        f"(every second one with a {SERVE_DEADLINE_US / 1e3:.0f} ms "
        f"deadline) in {lead['load_s']:.3f} s ({n_req / lead['load_s']:.0f} "
        f"requests/s), latency p50 {lead['p50_ms']:.2f} ms, p99 "
        f"{lead['p99_ms']:.2f} ms, {st['deadline_missed']} deadlines "
        f"missed; \"cloud\" moved {PIPE_MOVES} times: versions "
        + ", ".join(f"{v} {act}" for v, act in lead["versions"])
        + f", the same on every rank; groups served per rank {groups} "
        f"(occupancy {st['batch_rows'] / max(st['batch_slots'], 1):.3f}); "
        f"0 failed tickets, 0 stalls, 0 maintenance errors; every response "
        f"equal to the single-device QueryServer's at its version (ties "
        f"swapped indices in {swaps})  [{card}]")
    for r, p in enumerate(pipes):
        log(f"[sharded] pipeline rank {r} launches (counts zeroed just "
            + ("before the load" if r == 0 else "before the leader's "
               "builds") + f", read after the close): "
            f"{json.dumps(p['launches'])}")


def main():
    name, count, card = phase_device()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    phase_build()
    # the counting build beside the phases before [geometry]
    counting = start_counting_build()
    pts, box_lo, box_hi, qc = make_data(dev)
    records, _ = phase_kernels(dev, pts, box_lo, box_hi, qc)
    launches, _, spheres, knn, policy = phase_main_path(dev, pts, box_lo,
                                                        box_hi, qc)
    phase_timings(dev, pts, box_lo, box_hi, spheres, knn, policy, card)
    phase_profile(pts, spheres, knn, policy, card)
    records["lbvh_tail"] = phase_build_path(dev, pts, box_lo, box_hi, policy,
                                            card)
    # early, so that the fine kNN twin's host workers overlap the later
    # phases
    geo_launches, records["bvh_traverse_callback_shapes"], geo_twins = \
        phase_geometry(dev, policy, card, counting)
    launches["bvh_traverse_callback_shapes"] = \
        geo_launches["bvh_traverse_callback"]
    launches["bvh_traverse_fine_knn"] = geo_launches["bvh_traverse_fine_knn"]
    cb_err = phase_callback_kernel(dev, pts, box_lo, box_hi, qc, policy, card)
    db_launches, record = phase_dbscan(dev, policy, card)
    # the walk the DBSCAN path launches most, with the largest difference
    # any callback comparison found
    record["max_abs_err"] = max(record["max_abs_err"], cb_err)
    records["bvh_traverse_callback"] = record
    launches["bvh_traverse_callback"] = db_launches["bvh_traverse_callback"]
    phase_loop_route(dev, pts, qc, policy)
    ray_launches, ray_record, box_record, knn_record = phase_rays(
        dev, box_lo, box_hi, policy, card)
    records["bvh_traverse_ray_knn"] = knn_record
    launches["bvh_traverse_ray_knn"] = ray_launches["bvh_traverse_ray_knn"]
    records["bvh_traverse_callback_rays"] = ray_record
    launches["bvh_traverse_callback_rays"] = \
        ray_launches["bvh_traverse_callback"]
    records["ray_box_nearest"] = box_record
    launches["ray_box_nearest"] = ray_launches["ray_box_nearest"]
    serve_calls, serve_resps = phase_serve(dev, pts, card)
    emst_launches, records["bvh_traverse_knn_exclude"] = phase_emst(
        dev, pts, card)
    launches["bvh_traverse_knn_exclude"] = \
        emst_launches["bvh_traverse_knn_exclude"]
    phase_mls(dev, pts, qc, policy, card)
    phase_route(dev, pts, qc, card)
    ops_launches, codes, knn_out = phase_ops_main(pts, qc)
    # morton64: the builds' launches on the main path and the op's
    launches["morton64"] += ops_launches["morton64"]
    launches["bruteforce_knn"] = ops_launches["bruteforce_knn"]
    records["morton64"] = phase_morton(dev, pts, box_lo, box_hi, codes, card)
    records["bruteforce_knn"] = phase_bruteforce(dev, pts, qc, knn_out,
                                                 policy, card)
    del codes, knn_out
    phase_sanitized(card)
    records["flash_attention"] = phase_flash(dev, card)
    launches.update(phase_lm(dev, card))
    # flash in the new families' forwards
    launches["flash_attention"] += phase_lm_serve(dev, card)
    # flash in the training path's eval step
    launches["flash_attention"] += phase_train(dev, card)
    # flash in the sharded eval step, each rank's heads through local_map
    launches["flash_attention"] += phase_mesh(dev, card)
    records["bvh_traverse_fine_knn"] = phase_geometry_twins(geo_twins, card)
    # last, with the host's cores free of the twins' workers: the gloo
    # ranks stage their collectives through host memory. Their launches
    # stay on the phase's own lines, checked per rank, as [serve]'s do.
    phase_distributed(dev, pts, box_lo, box_hi, qc, serve_calls, serve_resps,
                      card)
    kernels = []
    for kname in ("karras_ranges", "lbvh_tail", "bvh_traverse_spatial",
                  "bvh_traverse_knn", "bvh_traverse_knn_exclude",
                  "bvh_traverse_ray_knn", "bvh_traverse_fine_knn",
                  "bvh_traverse_callback", "bvh_traverse_callback_rays",
                  "bvh_traverse_callback_shapes",
                  "ray_box_nearest", "morton64", "bruteforce_knn",
                  "flash_attention"):
        r = records[kname]
        check(launches[kname] > 0, f"{kname} was not launched in its path")
        kernels.append({"name": kname, "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"],
                        "launches": launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r.get("library_ms")})
        check(all(math.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms"))
              and (r.get("library_ms") is None
                   or math.isfinite(r["library_ms"])),
              f"{kname}: a time is not finite")
    log(f"[done] {time.perf_counter() - t0:.1f} s after the device phase")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    if "--rank" in sys.argv:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
