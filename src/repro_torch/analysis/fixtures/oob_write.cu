// Known-bad fixture (memcheck class): one thread too many writes one float
// past the end of `out` (the guard is `<=`).  The kernel pass must catch it
// exactly once.
#include <cuda_runtime.h>

__global__ void fixture_oob_write_kernel(float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i <= n) out[i] = 1.0f;
}

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out (n,) f32; launches n + 1 threads in blocks of 128.
int fixture_oob_write(float* out, int n, void* stream) {
  fixture_oob_write_kernel<<<(n + 1 + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
