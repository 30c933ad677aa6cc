// Binary (K = 2) MRF energies and the per-element label minimum.
//
// Replaces: src/repro/kernels/mrf_energy.py :: mrf_min_energy_pallas (the
// TPU kernel evaluates both label energies of 2048-element tiles in VMEM and
// writes only their minimum and argmin).
//
// What bounds it on an H100: memory.  Each element reads five float32
// operands (y, w, n1, nall, xf: 20 B) and writes min_e and arg (8 B); the
// arithmetic, about 30 float operations, is far below the card's rate.
//
// Design: one thread per element in a grid-stride loop; the parameters
// (mu, sigma, beta) are read once per thread from global memory, where
// every thread of the card hits the same cached lines.  The energies follow
// ref.mrf_min_energy's op order:
//   e_l = w * ((y - mu_l)^2 / (2 sigma_l sigma_l) + log sigma_l)
//       + beta * max(diff_l, 0) / max(nall - 1, 1)
// with diff_0 = n1 - xf and diff_1 = (nall - n1) - (1 - xf); label 1 wins
// only when strictly lower.  Every op is an explicitly rounded intrinsic so
// that nvcc cannot contract it into an FMA: min_e and arg equal the plain
// version bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void mrf_min_energy_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ n1, const float* __restrict__ nall,
    const float* __restrict__ xf, const float* __restrict__ mu,
    const float* __restrict__ sigma, const float* __restrict__ beta_p,
    long long n, float* __restrict__ min_e, int* __restrict__ arg) {
  const float mu0 = mu[0];
  const float mu1 = mu[1];
  const float s0 = sigma[0];
  const float s1 = sigma[1];
  const float beta = beta_p[0];
  const float two0 = __fmul_rn(__fmul_rn(2.0f, s0), s0);
  const float two1 = __fmul_rn(__fmul_rn(2.0f, s1), s1);
  const float log0 = logf(s0);
  const float log1 = logf(s1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float yv = y[i];
    const float wv = w[i];
    const float c1 = n1[i];
    const float na = nall[i];
    const float xv = xf[i];
    const float denom = fmaxf(__fsub_rn(na, 1.0f), 1.0f);

    const float d0 = __fsub_rn(yv, mu0);
    float e0 = __fmul_rn(wv, __fadd_rn(__fdiv_rn(__fmul_rn(d0, d0), two0), log0));
    e0 = __fadd_rn(e0, __fdiv_rn(__fmul_rn(beta, fmaxf(__fsub_rn(c1, xv), 0.0f)), denom));

    const float d1 = __fsub_rn(yv, mu1);
    float e1 = __fmul_rn(wv, __fadd_rn(__fdiv_rn(__fmul_rn(d1, d1), two1), log1));
    const float diff1 = __fsub_rn(__fsub_rn(na, c1), __fsub_rn(1.0f, xv));
    e1 = __fadd_rn(e1, __fdiv_rn(__fmul_rn(beta, fmaxf(diff1, 0.0f)), denom));

    const bool one = e1 < e0;
    // torch.minimum: NaN if either energy is NaN.
    min_e[i] = (e0 != e0) ? e0 : ((e1 != e1) ? e1 : (one ? e1 : e0));
    arg[i] = one ? 1 : 0;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs: y, w, n1, nall, xf (n,) f32; mu, sigma (2,) f32; beta (1,) f32.
// Outputs: min_e (n,) f32; arg (n,) i32.  Returns cudaGetLastError() after
// the launch.
int repro_mrf_min_energy(const float* y, const float* w, const float* n1,
                         const float* nall, const float* xf, const float* mu,
                         const float* sigma, const float* beta, long long n,
                         float* min_e, int* arg, void* stream) {
  if (n > 0) {
    const int threads = 256;
    long long blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond 16 blocks/SM
    mrf_min_energy_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        y, w, n1, nall, xf, mu, sigma, beta, n, min_e, arg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
