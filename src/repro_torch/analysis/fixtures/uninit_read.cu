// Known-bad fixture (initcheck class): the kernel reads a scratch buffer
// that nothing wrote (the caller allocates it uninitialised), and its
// garbage reaches the output.  The kernel pass must catch it exactly once.
#include <cuda_runtime.h>

__global__ void fixture_uninit_read_kernel(const float* scratch, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = scratch[i] + 1.0f;
}

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scratch, out (n,) f32; scratch is never written.
int fixture_uninit_read(const float* scratch, float* out, int n, void* stream) {
  fixture_uninit_read_kernel<<<(n + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      scratch, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
