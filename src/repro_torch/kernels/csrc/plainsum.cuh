// Float sums in the plain versions' order.  Used by em_tick.cu (the
// single-device tick) and map_step.cu (the sharded route's MAP iteration).
//
// The plain versions sum with index_add_, which on the CPU adds element by
// element, the order jax.ops.segment_sum takes on the CPU.  A threshold on
// a sum (the convergence window on the hood sums, the degenerate and
// divergence tests on the M-step's parameters) then parts no iteration
// count from the plain path's when the card adds in that order too.
//
// * add_chunk: a hood's energy sum in element order, inside the warp that
//   walks the hood.  The warp takes a warp-uniform loop over chunks of 32
//   consecutive elements (lane j holds element base + j); after each chunk
//   the lanes' products are added to one accumulator one lane at a time, in
//   lane order, and only the lanes whose element is valid add.  So the sum
//   is the plain version's float sum, bit for bit: ((0 + p0) + p1) + ...
//   over the hood's valid elements in the order they are stored.  Cost: 32
//   shuffles and at most 32 dependent adds per chunk; at the slices' 16
//   elements a hood, one chunk.
// * label_sums: the M-step's per-label sums in vertex order, in one block
//   (a thread per label over tiles of the vertices in shared memory).

#pragma once

#include <cuda_runtime.h>

namespace plainsum {

// Add this chunk's products to `acc` in lane order: lane j's `prod` is
// added when its `take` is set (a lane past the hood's end sets none).
// Every lane of the warp calls it with the same `acc`, and every lane gets
// the same result.  The loop has a constant trip count so that it unrolls:
// the 32 shuffles do not wait on the sum, only the adds do.
__device__ __forceinline__ float add_chunk(float acc, float prod, bool take) {
  const unsigned takes = __ballot_sync(0xffffffffu, take);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float pj = __shfl_sync(0xffffffffu, prod, j);
    if (takes & (1u << j)) acc = __fadd_rn(acc, pj);
  }
  return acc;
}

// The M-step sums of `labels`: for each label l, the sums of w, w * y and
// (w * y) * y over the vertices labelled l (w the region weight, y the
// region mean) into stats[l], stats[K + l] and stats[2 K + l], each added
// vertex by vertex in vertex order.  Every thread of one block of
// kThreads calls it; `tiles` is 4 kThreads words of shared memory, at
// offsets known at compile time so that the serial loop over a tile reads
// its three sums from one base address.  The labels are read through L2
// (__ldcg), so that other blocks' writes made visible by a fence (a
// last-block-done ticket) are seen.
template <int kThreads>
__device__ __forceinline__ void label_sums(const int* labels, const float* region_weight,
                                           const float* region_mean, int n_vertices,
                                           int n_labels, float* tiles, float* stats) {
  int* tile_lab = reinterpret_cast<int*>(tiles);
  float* tile_w = tiles + kThreads;
  float* tile_wy = tiles + 2 * kThreads;
  float* tile_wyy = tiles + 3 * kThreads;
  for (int l0 = 0; l0 < n_labels; l0 += kThreads) {
    const int l = l0 + threadIdx.x;
    float sw = 0.0f, swy = 0.0f, swyy = 0.0f;
    for (int t0 = 0; t0 < n_vertices; t0 += kThreads) {
      const int v = t0 + threadIdx.x;
      if (v < n_vertices) {
        const float wr = __ldg(region_weight + v);
        const float ym = __ldg(region_mean + v);
        const float wy = __fmul_rn(wr, ym);
        tile_lab[threadIdx.x] = __ldcg(labels + v);
        tile_w[threadIdx.x] = wr;
        tile_wy[threadIdx.x] = wy;
        tile_wyy[threadIdx.x] = __fmul_rn(wy, ym);
      }
      __syncthreads();
      const int len = min(kThreads, n_vertices - t0);
      if (l < n_labels) {
        for (int i = 0; i < len; ++i) {
          if (tile_lab[i] == l) {
            sw = __fadd_rn(sw, tile_w[i]);
            swy = __fadd_rn(swy, tile_wy[i]);
            swyy = __fadd_rn(swyy, tile_wyy[i]);
          }
        }
      }
      __syncthreads();
    }
    if (l < n_labels) {
      stats[l] = sw;
      stats[n_labels + l] = swy;
      stats[2 * n_labels + l] = swyy;
    }
  }
}

}  // namespace plainsum
