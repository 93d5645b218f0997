// Nearest ray-box hit over a flat box soup: for each ray the smallest
// entry parameter t >= 0 over all B boxes and the first box reaching it,
// (inf, -1) when no box is hit.
//
// Replaces: src/repro/kernels/ray_box.py::ray_box_nearest_pallas (body
//   _ray_box_kernel). The TPU kernel swept (br, bb) panels of rays x boxes
//   through VMEM with a running (t, idx) pair per ray carried across the
//   sequential box axis of its grid; here one thread holds one ray and its
//   running best in registers, and each block streams every box through
//   shared memory, a tile at a time.
// Bound on this card: operations. R * B slab tests of 8 * dim + 4
//   operations each, against R * dim * 8 + B * dim * 8 + R * 8 bytes.
// Design: one thread per ray with its origin and 1/d in registers (a bit
//   per zero direction component); the block stages kTile boxes' lo/hi in
//   shared memory (every thread reads the same address: a broadcast) and
//   tests them in ascending order with a strict < update, which keeps the
//   first box on equal t, the reference's tie rule. The slab test is
//   geometry.ray_box: no sums of products, so no contraction question;
//   IEEE division for 1/d. Ray tiles per warp, float4 loads and TMA
//   staging are later work.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kMaxDim = 16;
constexpr int kThreads = 128;
constexpr int kTile = 256;

__global__ void ray_box_kernel(const float* __restrict__ origins,
                               const float* __restrict__ directions,
                               const float* __restrict__ box_lo,
                               const float* __restrict__ box_hi, int r, int b,
                               int dim, float* __restrict__ t_out,
                               int* __restrict__ i_out) {
  extern __shared__ float tile[];  // lo (kTile, dim), then hi (kTile, dim)
  float* s_lo = tile;
  float* s_hi = tile + kTile * dim;
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < r;
  float o[kMaxDim], inv[kMaxDim];
  const unsigned zero =
      live ? load_ray(origins + static_cast<long long>(ray) * dim,
                      directions + static_cast<long long>(ray) * dim, dim, o,
                      inv)
           : 0u;
  float best = INFINITY;
  int best_i = -1;
  for (int base = 0; base < b; base += kTile) {
    const int nt = min(kTile, b - base);
    __syncthreads();
    for (int k = threadIdx.x; k < nt * dim; k += blockDim.x) {
      s_lo[k] = box_lo[static_cast<long long>(base) * dim + k];
      s_hi[k] = box_hi[static_cast<long long>(base) * dim + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < nt; ++j) {
      float te;
      if (ray_slab(o, inv, zero, s_lo + j * dim, s_hi + j * dim, dim,
                   LoadPlain(), te) &&
          te < best) {
        best = te;
        best_i = base + j;
      }
    }
  }
  if (live) {
    t_out[ray] = best;
    i_out[ray] = best_i;
  }
}

}  // namespace

// origins / directions (r, dim), box_lo / box_hi (b, dim), all float32
// and contiguous; t_out (r,) float32, i_out (r,) int32.
REPRO_EXPORT int ray_box_nearest_launch(const void* origins,
                                        const void* directions,
                                        const void* box_lo, const void* box_hi,
                                        int r, int b, int dim, void* t_out,
                                        void* i_out, void* stream) {
  if (dim < 1 || dim > kMaxDim || r < 1 || b < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (r + kThreads - 1) / kThreads;
  const size_t shmem = 2 * sizeof(float) * kTile * dim;
  ray_box_kernel<<<blocks, kThreads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(origins), static_cast<const float*>(directions),
      static_cast<const float*>(box_lo), static_cast<const float*>(box_hi), r,
      b, dim, static_cast<float*>(t_out), static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
