#!/usr/bin/env python3
"""Time design variants of the callback kernel's ray walks and of the ray
kNN walk on one CUDA card, in turns.

    python3 scripts/ray_variants.py [knn | walk] [--parent DIR]
                     # from the checkout root; one phase, or both

Each variant is either a text edit of the committed
``src/repro_torch/csrc/bvh_callback.cu`` or ``ray_knn.cu``, built with
the port's nvcc flags into ``build/ray_variants/``, or the committed
library called through its C entry point with other arguments. The
scenes are ``chip_smoke.py``'s: its triangle soup (N = 2^20, R = 2^17
rays), its Boxes (side 0.01) and its Spheres (radius 0.005) at N = 2^20.

  ray kNN walk (``cast_nearest``; k = 1, 4 and 10)
    committed        node records, value records, the caller's order;
                     over Boxes nearest first with the tie pass, over
                     Spheres and Triangles the rope walk
    ray_order        the rays sorted by :func:`ray_order` (direction
                     octant, then the origin's Morton code) before the
                     launch, the results put back in the caller's rows
                     for the comparison; the sort step timed apart
    rope_walk        Boxes: the rope walk (an edit of the dispatch)
    no_records       Boxes: the any-dim instance over the flat arrays (the
                     rope walk)
    nearest_first    Spheres, Triangles: the Boxes walk with the leaf's hit
                     t offered (a kernel appended to the source, with its
                     own C entry), replaying a ray as the rope walk when a
                     leaf's hit t falls below its own box's entry t; the
                     line counts the rays that still differ from the
                     committed walk (a leaf the stack walk never tested can
                     hold such a t)
    nearest_first_no_replay   the same without the replay
  node tests per ray of both walks, from edited builds that count them
  (``counted``), and the rays the appended stack walk replayed or sent
  through its tie pass.
  callback ray walks (counting and collect_hits(32))
    committed        ray_kernel3: node records, value records (Spheres,
                     Triangles), the leaf test from the node test (Points,
                     Boxes), no range_last read, the caller's order
    ray_order        the rays sorted by :func:`ray_order`, as above
    gathered_values  Spheres, Triangles: each leaf gathers its value
                     through leaf_perm from the flat arrays (an edit)
    leaf_slab        Boxes: each leaf gathers its box and runs the slab
                     test again (an edit)
    range_last       every internal node reads range_last (an edit)
    parent           with ``--parent DIR``: the ``bvh_callback.cu`` of
                     another checkout (``git archive`` of the parent commit
                     unpacked into DIR, whose one ray walk is the any-dim
                     design: the flat arrays, leaf_perm gathers,
                     range_last), through its own C entry

Each variant is first compared with the committed kernel (identical
outputs, or the count of rays that differ where the line says so), then
timed by CUDA events; the variants run in one order and then in the
reverse one, and each line gives both times. Needs one card; exits
nonzero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

OUT = os.path.join(ROOT, "build", "ray_variants")
KS = (1, 4, 10)
COLLECT_CAP = 32

# a counter of node tests (the tie pass's included) in the committed ray
# kNN walks, read and zeroed by ray_knn_visits
COUNTER = r"""
__device__ unsigned long long g_visits[1];

REPRO_EXPORT int ray_knn_visits(void* out) {
  unsigned long long zero[1] = {0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_visits, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_visits, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""
RECORDS_KEY = """  __device__ __forceinline__ float key(const RayReg<3>& ray, int m, int,
                                       int& link, int& rope) const {
"""
FLAT_KEY = """  __device__ __forceinline__ float key(const RayReg<kMaxDim>& ray, int m,
                                       int dim, int& link, int& rp) const {
"""
NF_DISPATCH = "    return static_cast<int>(launch_nf_k(nodes, c));"

# Points and Boxes leaves for the rope walk: the node test at the leaf
LEAF_BOX = r"""
struct LeafBox {
  template <class Ray>
  __device__ __forceinline__ float hit_t(const Ray&, int, int, float kb,
                                         int) const {
    return kb;
  }
};

struct Call {"""

# nearest first with a stack over Spheres and Triangles (the committed
# Points / Boxes walk with the leaf's hit t offered in place of its box
# key), its tie pass, and a replay as the rope walk when a tested leaf's
# hit t is below its box key. g_nf: node tests, rays replayed, rays in
# the tie pass.
NEAREST_FIRST = r"""
__device__ unsigned long long g_nf[3];

REPRO_EXPORT int ray_knn_nf_counters(void* out) {
  unsigned long long zero[3] = {0, 0, 0};
  cudaError_t e = cudaMemcpyFromSymbol(out, g_nf, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_nf, zero, sizeof(zero));
  return static_cast<int>(e);
}

namespace {

template <class List>
__device__ __forceinline__ void nf_offer(List& best, float t, int pos, int k,
                                         float& lost) {
  if (best.admits_strict(t)) {
    lost = fminf(lost, best.bound());
    best.insert(t, pos, k);
  } else {
    lost = fminf(lost, t);
  }
}

template <class Leaf, class List>
__global__ void __launch_bounds__(kThreads)
    nf_kernel(Records3 nodes, Leaf leaf, const int* __restrict__ perm, int n,
              const float* __restrict__ origin,
              const float* __restrict__ direction, int q, int k, int replay,
              float* __restrict__ ts, int* __restrict__ idxs) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= q) return;
  Ray3 ray;
  ray.load(origin + 3LL * qi, direction + 3LL * qi, 3);
  List best;
  best.init(k);
  float lost = INFINITY;
  float st_d[96];
  int st_link[96];
  int top = 0;
  const int leaf0 = n - 1;
  bool anomaly = false;
  unsigned long long tests = 1;
  int link, rope;
  const float d_root = nodes.key(ray, 0, 3, link, rope);
  bool go = best.admits_strict(d_root);
  while (go) {
    int link_l, link_r, rope_r;
    const int l = link;
    const float dl = nodes.key(ray, l, 3, link_l, rope);
    const int r = rope;
    const float dr = nodes.key(ray, r, 3, link_r, rope_r);
    tests += 2;
#pragma unroll 1
    for (int side = 0; side < 2; ++side) {
      const int c = side == 0 ? l : r;
      if (c >= leaf0) {
        const float kb = side == 0 ? dl : dr;
        if (best.admits_strict(kb)) {
          const float t = leaf.hit_t(ray, c - leaf0, side == 0 ? link_l : link_r,
                                     kb, 3);
          anomaly = anomaly || t < kb;
          nf_offer(best, t, c - leaf0, k, lost);
        } else {
          lost = fminf(lost, kb);
        }
      }
    }
    bool go_l = false, go_r = false;
    if (l < leaf0) {
      go_l = best.admits_strict(dl);
      if (!go_l) lost = fminf(lost, dl);
    }
    if (r < leaf0) {
      go_r = best.admits_strict(dr);
      if (!go_r) lost = fminf(lost, dr);
    }
    if (go_l && go_r) {
      const bool left_nearer = dl <= dr;
      st_d[top] = left_nearer ? dr : dl;
      st_link[top] = left_nearer ? link_r : link_l;
      ++top;
      link = left_nearer ? link_l : link_r;
    } else if (go_l || go_r) {
      link = go_l ? link_l : link_r;
    } else {
      go = false;
      while (top > 0) {
        --top;
        if (best.admits_strict(st_d[top])) {
          link = st_link[top];
          go = true;
          break;
        }
        lost = fminf(lost, st_d[top]);
      }
    }
  }
  best.finish(k);
  float dk = best.bound();
  int below = k, ties = 0;
  int ring[List::kSlots];
  if (replay && anomaly) {
    atomicAdd(&g_nf[1], 1ull);
    best.init(k);
    int node = 0;
    while (node != -1) {
      int lk, rp;
      const float kb = nodes.key(ray, node, 3, lk, rp);
      ++tests;
      const bool promising = best.admits_strict(kb);
      if (node < leaf0) {
        node = promising ? lk : rp;
        continue;
      }
      if (promising) {
        const float t = leaf.hit_t(ray, node - leaf0, lk, kb, 3);
        if (best.admits_strict(t)) best.insert(t, node - leaf0, k);
      }
      node = rp;
    }
    best.finish(k);
    dk = best.bound();
  } else if (lost == dk && dk != INFINITY) {
    atomicAdd(&g_nf[2], 1ull);
    below = 0;
#pragma unroll
    for (int j = 0; j < List::kSlots; ++j) {
      below += j < k && best.dist(j) < dk ? 1 : 0;
    }
    const int m = k - below;
    int seen = 0;
    int node = 0;
    while (node != -1 && seen < k) {
      int lk, rp;
      const float kb = nodes.key(ray, node, 3, lk, rp);
      ++tests;
      if (!(kb <= dk)) {
        node = rp;
      } else if (node < leaf0) {
        node = lk;
      } else {
        const float t = leaf.hit_t(ray, node - leaf0, lk, kb, 3);
        if (t <= dk) {
          ++seen;
          if (t == dk) ring[ties++ % m] = node - leaf0;
        }
        node = rp;
      }
    }
  }
  float* ot = ts + static_cast<long long>(qi) * k;
  int* oi = idxs + static_cast<long long>(qi) * k;
#pragma unroll
  for (int j = 0; j < List::kSlots; ++j) {
    if (j < k) {
      int p;
      float t;
      if (j < below) {
        p = best.pos(j);
        t = best.dist(j);
      } else {
        p = ring[(ties - 1 - (j - below)) % (k - below)];
        t = dk;
      }
      ot[j] = t;
      oi[j] = p < 0 ? -1 : __ldg(perm + p);
    }
  }
  atomicAdd(&g_nf[0], tests);
}

template <class Leaf, class List>
void nf_launch(const Records3& nodes, const Leaf& leaf, const int* perm,
               int n, const float* o, const float* d, int q, int k,
               int replay, float* ts, int* idxs, cudaStream_t s) {
  nf_kernel<Leaf, List><<<(q + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      nodes, leaf, perm, n, o, d, q, k, replay, ts, idxs);
}

template <class Leaf>
int nf_k(const Records3& nodes, const Leaf& leaf, const int* perm, int n,
         const float* o, const float* d, int q, int k, int replay, float* ts,
         int* idxs, cudaStream_t s) {
  using knn::KeyList;
  if (k <= 1) nf_launch<Leaf, KeyList<1, true>>(nodes, leaf, perm, n, o, d, q, k, replay, ts, idxs, s);
  else if (k <= 4) nf_launch<Leaf, KeyList<4, true>>(nodes, leaf, perm, n, o, d, q, k, replay, ts, idxs, s);
  else if (k <= 16) nf_launch<Leaf, KeyList<16, true>>(nodes, leaf, perm, n, o, d, q, k, replay, ts, idxs, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_EXPORT int ray_knn_nf_launch(const void* records, const void* vrec,
                                   const void* perm, const void* origin,
                                   const void* direction, int n, int q, int k,
                                   int val_kind, int replay, void* ts,
                                   void* idxs, void* stream) {
  const Records3 nodes{static_cast<const int4*>(records)};
  auto pm = static_cast<const int*>(perm);
  auto o = static_cast<const float*>(origin);
  auto d = static_cast<const float*>(direction);
  auto t = static_cast<float*>(ts);
  auto ix = static_cast<int*>(idxs);
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<const int4*>(vrec);
  if (val_kind == kTriangles) {
    return nf_k(nodes, LeafTriangle3{v}, pm, n, o, d, q, k, replay, t, ix, s);
  }
  if (val_kind == kSpheres) {
    return nf_k(nodes, LeafSphere3{v}, pm, n, o, d, q, k, replay, t, ix, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
"""

# each leaf gathers its value through leaf_perm from the flat arrays
GATHER_SPHERE = r"""
        const float* cen = vg.a + 3LL * rb.w;
        hit = ray_sphere(
            ray.o, [&](int c) { return ray.d[c]; },
            [&](int c) { return __ldg(cen + c); }, __ldg(vg.r + rb.w), 3, th);
"""
GATHER_TRIANGLE = r"""
        float a_[3], b_[3], c_[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          a_[j] = __ldg(vg.a + 3LL * rb.w + j);
          b_[j] = __ldg(vg.b + 3LL * rb.w + j);
          c_[j] = __ldg(vg.c + 3LL * rb.w + j);
        }
        hit = ray_triangle(ray.o, ray.d, a_, b_, c_, th);
"""
LEAF_SLAB = r"""      float th = tn;
      bool hit = true;
      if (vg.kind == kBoxes) {
        hit = ray_slab(ray.o, ray.inv, ray.zero, vg.a + 3LL * rb.w,
                       vg.b + 3LL * rb.w, 3, LoadLdg(), th);
      } else if (vg.kind == kPoints) {
        hit = ray_slab(ray.o, ray.inv, ray.zero, vg.a + 3LL * rb.w,
                       vg.a + 3LL * rb.w, 3, LoadLdg(), th);
      }"""


def ray_order(origin, direction, scene_lo, scene_hi):
    """(R,) int64 order of rays for coherent walks: by the octant of the
    direction (the signs of its components), then by the 32-bit Morton
    code of the origin in the box [scene_lo, scene_hi] (stable)."""
    import torch
    from repro_torch.core import morton as M
    dim = direction.shape[-1]
    sign = (direction < 0).to(torch.int64)
    octant = (sign << torch.arange(dim, device=sign.device)).sum(-1)
    code = M.morton32(origin, scene_lo, scene_hi).to(torch.int64)
    return torch.sort((octant << 32) | code, stable=True).indices


def sorted_rays(o, d, tree):
    """(order, origins, directions): the rays in :func:`ray_order` over
    the tree's root box."""
    order = ray_order(o, d, tree.node_lo[0], tree.node_hi[0])
    return order, o[order].contiguous(), d[order].contiguous()


def unsorted(x, order):
    """Rows of `x` (one per sorted ray) back in the caller's order."""
    y = x.clone()
    y[order] = x
    return y


def _edit(src, old, new):
    if old not in src:
        raise SystemExit(f"ray_variants: the source no longer holds {old!r}")
    return src.replace(old, new)


def _ray_part(src):
    """(before, after) of bvh_callback.cu split at ray_kernel3."""
    at = src.index("    ray_kernel3(const int4* __restrict__ records,")
    return src[:at], src[at:]


def callback_sources(src):
    head, ray = _ray_part(src)
    gathered = _edit(_edit(ray, "        hit = sphere_record_hit(ray, vrec, pos, th);\n",
                           GATHER_SPHERE),
                     "        hit = triangle_record_hit(ray, vrec, pos, th);\n",
                     GATHER_TRIANGLE)
    return {
        "gathered_values": head + gathered,
        "leaf_slab": head + _edit(ray, "      float th = tn;\n      bool hit = true;",
                                  LEAF_SLAB),
        "range_last": head + _edit(ray, "(mp < 0 || __ldg(range_last + node) > mp)",
                                   "__ldg(range_last + node) > mp"),
    }


def knn_sources(src):
    count = "    atomicAdd(&g_visits[0], 1ull);\n"
    counted = _edit(src, '#include "ray_tests.cuh"\n',
                    '#include "ray_tests.cuh"\n' + COUNTER)
    counted = _edit(counted, RECORDS_KEY, RECORDS_KEY + count)
    counted = _edit(counted, FLAT_KEY, FLAT_KEY + count)
    def rope(text):
        return _edit(_edit(text, "\nstruct Call {", LEAF_BOX), NF_DISPATCH,
                     "    return static_cast<int>(launch_k(nodes, LeafBox{}, "
                     "c));")

    return {"ray_knn_counted": counted, "ray_knn_rope_boxes": rope(src),
            "ray_knn_rope_boxes_counted": rope(counted),
            "ray_knn_nf": src + NEAREST_FIRST}


def knn_phase(card, libs):
    import torch
    import repro_torch as rt
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.core import geometry as G
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_traverse as T
    from repro_torch.kernels.bvh_traverse import _stream

    dev = torch.device("cuda", 0)
    policy = rt.ExecutionPolicy(device=dev)
    committed = _build.function("ray_knn", "ray_knn_launch", T._RAY_KNN_ARGS)
    counted, visits_of = {}, {}
    for name in ("ray_knn_counted", "ray_knn_rope_boxes_counted"):
        counted[name] = WV.entry(libs[name], "ray_knn_launch",
                                 T._RAY_KNN_ARGS)
        visits_of[name] = WV.entry(libs[name], "ray_knn_visits",
                                   [ctypes.c_void_p])
    rope_boxes = WV.entry(libs["ray_knn_rope_boxes"], "ray_knn_launch",
                          T._RAY_KNN_ARGS)
    nf = WV.entry(libs["ray_knn_nf"], "ray_knn_nf_launch",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 3)
    nf_counters = WV.entry(libs["ray_knn_nf"], "ray_knn_nf_counters",
                           [ctypes.c_void_p])

    a, b, c, o, d = smoke.make_soup(dev)
    pts, box_lo, box_hi, _ = smoke.make_data(dev)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 3)
    centres = torch.rand((smoke.N, 3), generator=gen, device=dev)
    del pts
    kinds = {G.Points: 0, G.Boxes: 1, G.Spheres: 2, G.Triangles: 3}
    r = o.shape[0]

    def scene(label, values):
        index = rt.BVH(values, policy=policy)
        t = index.tree
        n = len(values)
        kind = kinds[type(values)]
        vrec = index.value_records
        order, os_, ds_ = sorted_rays(o, d, t)
        order_ms = smoke.time_ms(lambda: sorted_rays(o, d, t), reps=5)
        print(f"[variants] knn {label}: the ray order step (sort, gather of "
              f"the rays) {order_ms:.4f} ms", flush=True)
        tree = [t.node_lo, t.node_hi, t.rope, t.left_child, t.leaf_perm]
        for k in KS:
            ts = torch.empty((r, k), dtype=torch.float32, device=dev)
            ix = torch.empty((r, k), dtype=torch.int32, device=dev)

            def run(fn, records, rays=(o, d), ts=ts, ix=ix, k=k):
                def go():
                    err = fn(*(x.data_ptr() for x in tree),
                             None if records is None else records.data_ptr(),
                             None if vrec is None else vrec.data_ptr(),
                             None, None, rays[0].data_ptr(),
                             rays[1].data_ptr(), n, r, 3, kind, k,
                             ts.data_ptr(), ix.data_ptr(), _stream(dev))
                    if err:
                        raise SystemExit(f"ray_variants: launch refused ({err})")
                    return ts, ix
                return go

            def run_nf(replay, ts=ts, ix=ix, k=k):
                def go():
                    err = nf(t.records.data_ptr(),
                             None if vrec is None else vrec.data_ptr(),
                             t.leaf_perm.data_ptr(), o.data_ptr(),
                             d.data_ptr(), n, r, k, kind, replay,
                             ts.data_ptr(), ix.data_ptr(), _stream(dev))
                    if err:
                        raise SystemExit(f"ray_variants: nf refused ({err})")
                    return ts, ix
                return go

            variants = [("committed", run(committed, t.records)),
                        ("ray_order", run(committed, t.records, (os_, ds_)))]
            if kind <= 1:
                variants += [("rope_walk", run(rope_boxes, t.records)),
                             ("no_records", run(committed, None))]
            else:
                variants += [("nearest_first", run_nf(1)),
                             ("nearest_first_no_replay", run_nf(0))]
            ref, runs = None, []
            for name, go in variants:
                got = [x.clone() for x in go()]
                if name == "ray_order":
                    got = [unsorted(x, order) for x in got]
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                differ = int((~((got[0] == ref[0]) & (got[1] == ref[1]))
                              .all(1)).sum())
                if differ and not name.startswith("nearest_first"):
                    raise SystemExit(f"ray_variants: knn {label} k={k} {name} "
                                     "differs from committed")
                runs.append((f"{name} ({differ} rays differ)", go))
            for name, ms in WV.in_turns(runs, reps=3).items():
                print(f"[variants] knn {label} N={n} R={r} k={k} {name}: "
                      f"{ms[0]:.3f} / {ms[1]:.3f} ms  [{card}]", flush=True)
            buf = (ctypes.c_ulonglong * 3)()
            tests = {}
            for name in ("ray_knn_counted", "ray_knn_rope_boxes_counted"):
                visits_of[name](ctypes.addressof(buf))
                run(counted[name], t.records)()
                torch.cuda.synchronize()
                visits_of[name](ctypes.addressof(buf))
                tests[name] = buf[0] / r
            line = (f"committed {tests['ray_knn_counted']:.1f} node tests "
                    "per ray (its tie pass included)")
            if kind <= 1:
                line += (f"; the rope walk "
                         f"{tests['ray_knn_rope_boxes_counted']:.1f}")
            else:
                nf_counters(ctypes.addressof(buf))
                run_nf(1)()
                torch.cuda.synchronize()
                nf_counters(ctypes.addressof(buf))
                line += (f"; nearest first {buf[0] / r:.1f}, {buf[1]} rays "
                         f"replayed, {buf[2]} in its tie pass")
            print(f"[variants] knn {label} k={k}: {line}", flush=True)
        del index, t, tree

    scene("triangles", G.Triangles(a, b, c))
    scene("boxes", G.Boxes(box_lo, box_hi))
    scene("spheres", G.Spheres(centres, torch.full((smoke.N,),
                                                   smoke.SPHERE_RADIUS,
                                                   device=dev)))


def walk_phase(card, libs):
    import torch
    import repro_torch as rt
    import chip_smoke as smoke
    import walk_variants as WV
    from repro_torch.core import callbacks as CB
    from repro_torch.core import geometry as G
    from repro_torch.core.index import _bcast_state
    from repro_torch.kernels import _build
    from repro_torch.kernels import bvh_callback as KC
    from repro_torch.kernels.bvh_traverse import _stream

    dev = torch.device("cuda", 0)
    policy = rt.ExecutionPolicy(device=dev)
    committed = _build.function("bvh_callback", "bvh_callback_launch",
                                KC._ARGS)

    def lib(name):
        return WV.entry(libs[name], "bvh_callback_launch", KC._ARGS)

    parent = None
    if "parent" in libs:
        # the parent's entry: no value-records argument
        parent = WV.entry(libs["parent"], "bvh_callback_launch",
                          KC._ARGS[:7] + KC._ARGS[8:])

    a, b, c, o, d = smoke.make_soup(dev)
    pts, box_lo, box_hi, _ = smoke.make_data(dev)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 3)
    centres = torch.rand((smoke.N, 3), generator=gen, device=dev)
    del pts
    r = o.shape[0]
    mp = torch.full((r,), -1, dtype=torch.int32, device=dev)

    def scene(label, values, extra):
        index = rt.BVH(values, policy=policy)
        t = index.tree
        n = len(values)
        kind = KC._KIND[type(values)]
        vrec = index.value_records
        va, vb, vc, vr = KC._geom_ptrs(values, dev, "ray_variants")
        tree = [t.node_lo, t.node_hi, t.rope, t.left_child, t.range_last,
                t.leaf_perm]
        order, os_, ds_ = sorted_rays(o, d, t)
        for ep_name, epilogue, make in (
                ("counting", 0, CB.counting),
                (f"collect_hits({COLLECT_CAP})", 4,
                 lambda: CB.collect_hits(COLLECT_CAP))):
            _, s0 = make()
            s0 = [x.contiguous() for x in KC._state_leaves(
                _bcast_state(s0, r, dev))]
            out = [x.clone() for x in s0]

            def run(fn, records, rays=(o, d), slot=True):
                # slot: the committed entry's value-records argument
                def go():
                    for x, y in zip(out, s0):
                        x.copy_(y)
                    err = fn(*(x.data_ptr() for x in tree),
                             None if records is None else records.data_ptr(),
                             *((None if vrec is None else vrec.data_ptr(),)
                               if slot else ()),
                             None, rays[0].data_ptr(), rays[1].data_ptr(),
                             None,
                             *(None if x is None else x.data_ptr()
                               for x in (va, vb, vc, vr)),
                             mp.data_ptr(), n, r, 3, 4, kind, epilogue,
                             COLLECT_CAP if epilogue == 4 else 0, 0,
                             *(x.data_ptr() for x in out),
                             *([None] * (3 - len(out))), None, _stream(dev))
                    if err:
                        raise SystemExit(f"ray_variants: launch refused ({err})")
                    return out
                return go

            variants = [("committed", run(committed, t.records)),
                        ("ray_order", run(committed, t.records, (os_, ds_)))]
            variants += [(name, run(lib(name), t.records)) for name in extra]
            variants.append(("range_last", run(lib("range_last"), t.records)))
            if "parent" in libs:
                variants.append(("parent", run(parent, None, slot=False)))
            ref, runs = None, []
            for name, go in variants:
                got = [x.clone() for x in go()]
                if name == "ray_order":
                    got = [unsorted(x, order) for x in got]
                torch.cuda.synchronize()
                if ref is None:
                    ref = got
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise SystemExit(f"ray_variants: walk {label} {ep_name} "
                                     f"{name} differs from committed")
                runs.append((name, go))
            del ref
            for name, ms in WV.in_turns(runs, reps=3).items():
                print(f"[variants] walk {label} {ep_name} N={n} R={r} {name}: "
                      f"{ms[0]:.3f} / {ms[1]:.3f} ms, identical to committed  "
                      f"[{card}]", flush=True)
        del index, t, tree

    scene("triangles", G.Triangles(a, b, c), ("gathered_values",))
    scene("boxes", G.Boxes(box_lo, box_hi), ("leaf_slab",))
    scene("spheres", G.Spheres(centres, torch.full((smoke.N,),
                                                   smoke.SPHERE_RADIUS,
                                                   device=dev)),
          ("gathered_values",))


def main():
    import torch
    if not torch.cuda.is_available():
        print("ray_variants: needs a CUDA card", file=sys.stderr)
        return 1
    import walk_variants as WV
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"[variants] {card}", flush=True)
    cb_src = open(os.path.join(_build.CSRC, "bvh_callback.cu")).read()
    knn_src = open(os.path.join(_build.CSRC, "ray_knn.cu")).read()
    sources = {**callback_sources(cb_src), **knn_sources(knn_src)}
    if "--parent" in sys.argv:
        at = sys.argv.index("--parent")
        parent_dir = sys.argv[at + 1]
        del sys.argv[at:at + 2]
        sources["parent"] = open(os.path.join(
            parent_dir, "src", "repro_torch", "csrc", "bvh_callback.cu")).read()
    _build.build_all(("bvh_callback", "ray_knn", "karras"))
    libs = WV.build(sources, show=("ray_kernel3<Counting",
                                   "ray_kernel<Counting",
                                   "ray_knn_kernel<Records3, LeafTriangle3",
                                   "nf_kernel"), out=OUT)
    print(f"[variants] built in {time.perf_counter() - t0:.1f} s", flush=True)
    if "walk" not in sys.argv[1:]:
        knn_phase(card, libs)
    if "knn" not in sys.argv[1:]:
        walk_phase(card, libs)
    print(f"[variants] done in {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
