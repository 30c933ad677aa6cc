// 1-D ReduceByKey (add or min) of float32 values into num_segments buckets.
//
// Replaces: src/repro/kernels/segment_reduce.py :: segment_reduce_pallas
// (the TPU kernel builds a (segments x values) one-hot tile per grid step,
// contracts it on the MXU, and walks the value blocks in order along an
// "arbitrary" grid axis, so its sums have a fixed order).
//
// What bounds it on an H100: memory and launch time.  Each element is read
// once per pass (4 B value + 4 B id); there is no tensor-core work.  At the
// main path's sizes (tens to hundreds of thousands of elements) each pass
// is a launch of a few microseconds and the bytes are a fraction of that.
//
// Design (segsum.cuh):
//   * add: no floating-point atomic.  An exponent pass, a fixed-point sum
//     pass and a read-out give each segment's sum rounded once, bit for bit
//     the same whatever order the elements arrive in, across calls and
//     across element permutations (src/repro_torch/testing/segsum.py models
//     it).  A NaN gives NaN, +inf with -inf NaN, one infinity itself.
//   * min: one pass of compare-and-swap on the float's bits in which a NaN
//     wins and -0.0 beats +0.0; the output starts at +inf.
//   * Lanes of a warp that hold one id in consecutive lanes combine before
//     one atomic, and a run whose value is the identity issues none: the
//     solve's hood-sorted ids and the plan's raster-ordered superpixel ids
//     arrive in runs, and the padding lanes that share one id no longer
//     serialise on it.
// Ids outside [0, num_segments) are skipped.  Empty segments give 0 (add)
// or +inf (min).
//
// Ordered add (repro_segment_reduce_ordered_f32): each segment's sum in
// element order, ((0 + v_i0) + v_i1) + ... over its elements i0 < i1 < ...,
// the order in which index_add_ adds on the CPU and jax.ops.segment_sum on
// the CPU (the plain version, ref.keyed_sum).  The EM modes static and
// faithful take it for their float sums (hood energies, the M-step's
// per-label terms), which feed thresholds (the convergence window, the
// degenerate test): a sum rounded in another order can move an iteration
// count.  Two passes after a memset:
//   * span pass: per segment the first and the last index that holds its
//     id and a non-zero value (integer atomicMin / atomicMax; a warp's run
//     of one id issues one of each); zeros change no such sum;
//   * sum pass: a warp per segment walks its span in chunks of 32 and adds
//     the lanes whose id is the segment's in lane order
//     (plainsum::add_chunk).  The hood sums' ids come in runs (hood h owns
//     elements offsets[h]:offsets[h+1]), so the spans hold only their own
//     elements and the pass reads each element about once; the M-step's
//     label ids come in any order over few segments, and each warp reads
//     the span of its label.  Ids in any order give the same sums; only
//     the time grows with the spans.  A NaN result is the card's canonical
//     NaN, where the CPU's keeps an operand's payload or sign.
// Bound on the H100: launches (three, each a few microseconds) at the
// solves' sizes; the bytes (8 per element, 4 per segment) are well under
// a microsecond.

#include <cuda_runtime.h>

#include "plainsum.cuh"
#include "segsum.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// first[s] (unsigned, memset to 0xffffffff) and last[s] (int, memset to -1)
// over the indices that hold id s and a value that is not zero.  A zero
// (+0.0 or -0.0) changes no element-order sum that starts at +0.0: the sum
// is never -0.0, and x + 0 = x for every other x, NaN and infinities
// included.  So the zeros are left out of the spans: the padding lanes of
// a sentinel or phantom segment, and the weight-0 vertices of the M-step,
// cost the sum pass nothing.
__global__ void span_pass(const float* __restrict__ values, const int* __restrict__ ids,
                          long long n, int num_segments, unsigned* __restrict__ first,
                          int* __restrict__ last) {
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // The loop's trip count is uniform over the block, so every lane of a
  // warp takes part in the shuffles.
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x; base < n; base += stride) {
    const long long i = base + threadIdx.x;
    int key = -1;
    if (i < n) {
      const int id = __ldg(ids + i);
      if (id >= 0 && id < num_segments && __ldg(values + i) != 0.0f) key = id;
    }
    const int prev = __shfl_up_sync(kFullMask, key, 1);
    const int next = __shfl_down_sync(kFullMask, key, 1);
    if (key >= 0) {
      if (lane == 0 || prev != key) atomicMin(first + key, static_cast<unsigned>(i));
      if (lane == 31 || next != key) atomicMax(last + key, static_cast<int>(i));
    }
  }
}

// One warp per segment (grid-stride over segments): the segment's non-zero
// elements in index order, added one lane at a time; a chunk in which no
// lane takes part costs one ballot.
__global__ void ordered_sum_pass(const float* __restrict__ values, const int* __restrict__ ids,
                                 int num_segments, const unsigned* __restrict__ first,
                                 const int* __restrict__ last, float* __restrict__ out,
                                 int* count) {
  segsum::count_launch(count);
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); s < num_segments; s += warps) {
    const int hi = last[s];
    float acc = 0.0f;
    if (hi >= 0) {
      for (long long base = first[s]; base <= hi; base += 32) {
        const long long j = base + lane;
        float v = 0.0f;
        bool take = false;
        if (j <= hi) {
          v = __ldg(values + j);
          take = v != 0.0f && __ldg(ids + j) == s;
        }
        if (__ballot_sync(kFullMask, take) == 0u) continue;
        acc = plainsum::add_chunk(acc, v, take);
      }
    }
    if (lane == 0) out[s] = acc;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: 0 = add, 1 = min.  For add, `workspace` holds 16 bytes a segment
// (zeroed here, on the stream) and `out` needs no initial value; for min,
// `out` holds +inf and the workspace is unused.  `count`, when not null, is
// a device word the last kernel of the call adds one to (a launch inside a
// graph, counted on the device).  Returns cudaGetLastError() after the
// launches.
int repro_segment_reduce_f32(const float* values, const int* ids, float* out,
                             long long n, int num_segments, int op, void* workspace,
                             int* count, void* stream) {
  if (op != 0 && op != 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const segsum::Keyed src{values, ids, num_segments};
  if (num_segments > 0 && op == 0) {
    const segsum::Workspace ws = segsum::carve(workspace, num_segments);
    const cudaError_t err = cudaMemsetAsync(workspace, 0, segsum::workspace_bytes(num_segments), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n > 0) {
      segsum::exponent_pass<<<segsum::grid_blocks(n), segsum::kThreads, 0, s>>>(src, n, ws);
    }
    segsum::launch_sum(src, n, num_segments, ws, out, s, count);
  } else if (num_segments > 0 && n > 0) {
    segsum::min_pass<<<segsum::grid_blocks(n), segsum::kThreads, 0, s>>>(src, n, out, count);
  }
  return static_cast<int>(cudaGetLastError());
}

// The ordered add.  `workspace` holds 8 bytes a segment (set here, on the
// stream); n < 2^31; `count` as above.  Returns cudaGetLastError() after the
// launches.
int repro_segment_reduce_ordered_f32(const float* values, const int* ids, float* out,
                                     long long n, int num_segments, void* workspace,
                                     int* count, void* stream) {
  if (num_segments <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* first = static_cast<unsigned*>(workspace);
  int* last = reinterpret_cast<int*>(first + num_segments);
  const cudaError_t err =
      cudaMemsetAsync(workspace, 0xff, 8 * static_cast<size_t>(num_segments), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    span_pass<<<segsum::grid_blocks(n), segsum::kThreads, 0, s>>>(values, ids, n, num_segments,
                                                                   first, last);
  }
  constexpr int kWarpsPerBlock = segsum::kThreads / 32;
  long long blocks = (static_cast<long long>(num_segments) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 132 * 16) blocks = 132 * 16;
  ordered_sum_pass<<<static_cast<unsigned>(blocks), segsum::kThreads, 0, s>>>(
      values, ids, num_segments, first, last, out, count);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
