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

#include <cuda_runtime.h>

#include "segsum.cuh"

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: 0 = add, 1 = min.  For add, `workspace` holds 16 bytes a segment
// (zeroed here, on the stream) and `out` needs no initial value; for min,
// `out` holds +inf and the workspace is unused.  Returns
// cudaGetLastError() after the launches.
int repro_segment_reduce_f32(const float* values, const int* ids, float* out,
                             long long n, int num_segments, int op, void* workspace,
                             void* stream) {
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
    segsum::launch_sum(src, n, num_segments, ws, out, s);
  } else if (num_segments > 0 && n > 0) {
    segsum::min_pass<<<segsum::grid_blocks(n), segsum::kThreads, 0, s>>>(src, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
