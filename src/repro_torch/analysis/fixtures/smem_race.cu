// Known-bad fixture (racecheck class): thread 0 writes a shared word and
// every thread reads it with no barrier between, so the other warps may
// read it before the write.  The kernel pass must catch it exactly once.
#include <cuda_runtime.h>

__global__ void fixture_smem_race_kernel(float* out) {
  __shared__ float word;
  if (threadIdx.x == 0) word = 1.0f;
  out[threadIdx.x] = word;
}

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (64,) f32; one block of 64 threads (two warps).
int fixture_smem_race(float* out, void* stream) {
  fixture_smem_race_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
