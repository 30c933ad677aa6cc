// Known-bad fixture (synccheck class): a block barrier that only half the
// threads of a warp reach.  The kernel pass must catch it exactly once.
#include <cuda_runtime.h>

__global__ void fixture_divergent_sync_kernel(float* out) {
  const int lane = threadIdx.x & 31;
  float v = static_cast<float>(threadIdx.x);
  if (lane < 16) {
    __syncthreads();
    v += 1.0f;
  }
  out[threadIdx.x] = v;
}

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (32,) f32; one block of one warp.
int fixture_divergent_sync(float* out, void* stream) {
  fixture_divergent_sync_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
