// The flag word of a MAP iteration that runs as one launch: each hood's
// convergence-window and finiteness tests, the blocks' join by a
// last-block-done ticket, and the word the last block publishes.  Used by
// em_tick.cu (the single-device tick) and map_step.cu (the sharded route's
// MAP iteration).
//
// Two words of device memory, zero between launches: sync[0] the ticket,
// sync[1] the accumulator of the hoods' "not converged" and "not finite"
// bits.  Every block folds its bits into the accumulator, fences its
// writes and draws a ticket; the block that draws the last one sees every
// other block's writes, and one of its threads publishes the word (bit 0:
// every hood converged and the caller's gate open, bit 1: a hood energy
// not finite) and resets both words.  No cluster (at most 16 blocks) and
// no cooperative launch (every block resident at once), so the number of
// blocks is unbounded.

#pragma once

#include <cuda_runtime.h>

namespace flagword {

constexpr unsigned kNotConverged = 1u;  // accumulator: some hood outside its window
constexpr unsigned kNonFinite = 2u;     // accumulator and flag: some hood energy not finite
constexpr int kConverged = 1;           // flag: every hood converged, gate open

// Hood `hood`'s window test on [he, ring row 0, ..., ring row rows-2],
// newest first (row r is ring row (head + r) % rows of a (rows, n_hoods)
// ring), then `he` into the oldest row when `write`.  Returns the hood's
// accumulator bits.  The tolerance is conv_tol * max(|he|, 1), each op
// rounded as the plain versions round it.
__device__ __forceinline__ unsigned close_window(float* ring, int rows, int head, int n_hoods,
                                                 int hood, float he, float conv_tol, bool write) {
  const float* col = ring + hood;
  auto row = [&](int r) {
    const int q = head + r;
    return col[static_cast<long long>(q < rows ? q : q - rows) * n_hoods];
  };
  const float tol = __fmul_rn(conv_tol, fmaxf(fabsf(he), 1.0f));
  bool ok = fabsf(__fsub_rn(he, row(0))) < tol;
  for (int r = 0; r + 2 < rows; ++r) ok = ok && fabsf(__fsub_rn(row(r), row(r + 1))) < tol;
  if (write) {
    const int q = head + rows - 1;
    ring[static_cast<long long>(q < rows ? q : q - rows) * n_hoods + hood] = he;
  }
  return (ok ? 0u : kNotConverged) | (isfinite(he) ? 0u : kNonFinite);
}

// Every thread of every block: fold the block's bits into the accumulator,
// fence and draw a ticket.  True in the block that draws the last one
// (uniform in the block).
__device__ __forceinline__ bool last_block_done(unsigned int* sync, unsigned bits) {
  __shared__ unsigned int is_last;
  const unsigned block_bits = (__syncthreads_or(bits & kNotConverged) ? kNotConverged : 0u) |
                              (__syncthreads_or(bits & kNonFinite) ? kNonFinite : 0u);
  if (threadIdx.x == 0 && block_bits != 0u) atomicOr(sync + 1, block_bits);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(sync, 1u) == gridDim.x - 1;
  __syncthreads();
  if (is_last) __threadfence();
  return is_last != 0u;
}

// One thread of the last block: the flag word of the accumulated bits
// (bit 0: every hood converged and the caller's gate open, bit 1: a hood
// energy not finite), the accumulator reset for the next launch.
__device__ __forceinline__ int take_word(unsigned int* sync, int gate) {
  const unsigned acc = atomicExch(sync + 1, 0u);
  return ((gate && !(acc & kNotConverged)) ? kConverged : 0) | static_cast<int>(acc & kNonFinite);
}

// One thread of the last block, after the launch's other work: publish
// `flag` to `flag_dev` and to `flag_host` (the device view of a word of
// mapped pinned host memory), either may be null, and reset the ticket.
__device__ __forceinline__ void publish_word(unsigned int* sync, int flag, int* flag_dev,
                                             int* flag_host) {
  if (flag_dev != nullptr) flag_dev[0] = flag;
  // No system-scope fence: the host reads the word only after the stream
  // has finished this launch.
  if (flag_host != nullptr) *reinterpret_cast<volatile int*>(flag_host) = flag;
  atomicExch(sync, 0u);
}

}  // namespace flagword
