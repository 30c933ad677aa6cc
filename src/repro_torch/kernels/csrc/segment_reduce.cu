// 1-D ReduceByKey (add or min) of float32 values into num_segments buckets.
//
// Replaces: src/repro/kernels/segment_reduce.py :: segment_reduce_pallas
// (the TPU kernel builds a (segments x values) one-hot tile per grid step
// and contracts it on the MXU).
//
// What bounds it on an H100: memory and launch time.  Each element is read
// once (4 B value + 4 B id) and does one atomic; there is no tensor-core
// work.  At the main path's sizes (tens of thousands of elements) a launch
// is a few microseconds and the bytes are a fraction of that.
//
// Design: one thread per element in a grid-stride loop, each doing one
// atomic into the output, so the work is O(n) instead of the one-hot
// tile's O(segments x n) and any segment count works.  `add` is atomicAdd;
// `min` is a compare-and-swap loop on the float's bits.  Ids outside
// [0, num_segments) are skipped.  The caller initialises the output (0 for
// add, +inf for min), which also gives empty segments their identity.
//
// Order: atomics land in an order that changes from run to run, so a float
// `add` of non-integer values may differ in the last bits between runs.
// On the main path the values summed are 0/1 (neighbourhood sizes, pixel
// counts) or pixel intensities; sums of 0/1 values are exact in any order.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void atomic_min_f32(float* addr, float val) {
  unsigned int* bits = reinterpret_cast<unsigned int*>(addr);
  unsigned int old = *bits;
  while (val < __uint_as_float(old)) {
    const unsigned int assumed = old;
    old = atomicCAS(bits, assumed, __float_as_uint(val));
    if (old == assumed) break;
  }
}

__global__ void segment_reduce_kernel(const float* __restrict__ values,
                                      const int* __restrict__ ids,
                                      float* __restrict__ out, long long n,
                                      int num_segments, int op) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int s = ids[i];
    if (s < 0 || s >= num_segments) continue;
    if (op == 0) {
      atomicAdd(out + s, values[i]);
    } else {
      atomic_min_f32(out + s, values[i]);
    }
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: 0 = add, 1 = min.  Returns cudaGetLastError() after the launch.
int repro_segment_reduce_f32(const float* values, const int* ids, float* out,
                             long long n, int num_segments, int op,
                             void* stream) {
  if (op != 0 && op != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0 && num_segments > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
    segment_reduce_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        values, ids, out, n, num_segments, op);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
