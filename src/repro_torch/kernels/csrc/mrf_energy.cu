// Binary (K = 2) MRF energies and the per-element label minimum.
//
// Replaces: src/repro/kernels/mrf_energy.py :: mrf_min_energy_pallas (the
// TPU kernel evaluates both label energies of 2048-element tiles in VMEM and
// writes only their minimum and argmin).
//
// What bounds it on an H100, at the two shapes chip_smoke.py times.
//   * The hood elements of the paper's 512^3 volume (512 slices of 50,485:
//     25,848,320 elements).  Each element reads five float32 operands (y,
//     w, n1, nall, xf: 20 B) and writes min_e and arg (8 B): 723,752,980 B,
//     216 us at 3.35 TB/s.  Its arithmetic, about 30 float operations (four
//     IEEE divisions), is about one operation a byte, far below the card's
//     20 float32 operations a byte of HBM.  So the bytes bound it, and the
//     design's job is to keep enough of them in flight: it reaches 84 % of
//     that bound (257 us on an H100 80GB HBM3 at 700 W).
//   * One 512x512 slice (50,485 elements, 1,413,600 B, 0.42 us).  The
//     launch bounds it: 2.3 us on the device against 1.5 us for n = 1.
//
// Design:
//   * 16-byte accesses.  Each thread loads a float4 of each of the five
//     inputs, kVecs = 2 such vectors per loop trip, all ten loads issued
//     before any arithmetic, and stores a float4 of min_e and an int4 of
//     arg: 160 B in flight per thread, enough bytes per SM to cover HBM's
//     latency at one wave of resident blocks.
//   * Ragged edges without padding.  When every pointer sits at the same
//     offset within 16 B (the wrapper allocates the outputs at the inputs'
//     offset, so views with a storage offset qualify), a scalar head of at
//     most three elements brings them to a 16-byte boundary and a scalar
//     tail takes the last n % 4.  Pointers at different offsets take the
//     scalar loop for every element.
//   * One wave.  The grid is the card's SMs times the blocks of 256 threads
//     an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//     fewer when n needs fewer, and the kernel grid-strides over n.
//   * Plain loads through the read-only path (__ldg) and plain stores.
//     Streaming hints (__ldcs / __stcs, evict first) were tried at the
//     volume and made no difference a run could see (0.2602 to 0.2623 ms a
//     call with them, 0.2606 to 0.2625 without, on an H100 80GB HBM3 at
//     700 W), so the kernel does without them.
//   * beta by value: a Python float reaches the kernel as an argument (no
//     copy, no allocation besides the two outputs); a CUDA tensor beta is
//     read by the kernel.
//   * No TMA: there is no reuse, and the vector loads reach 84 % of the
//     bound, above the 80 % under which a TMA bulk-copy ring would be worth
//     its complexity; not tried.
//
// The energies follow ref.mrf_min_energy's op order:
//   e_l = w * ((y - mu_l)^2 / (2 sigma_l sigma_l) + log sigma_l)
//       + beta * max(diff_l, 0) / max(nall - 1, 1)
// with diff_0 = n1 - xf and diff_1 = (nall - n1) - (1 - xf); label 1 wins
// only when strictly lower.  Every op is an explicitly rounded intrinsic so
// that nvcc cannot contract it into an FMA: min_e and arg equal the plain
// version bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;        // float4 vectors of each input per thread and loop trip
constexpr int kMaxDevices = 64;

// The per-label terms, the same for every element.
struct Terms {
  float mu0, mu1, two0, two1, log0, log1, beta;
};

// One element: returns min_e, sets *arg.
__device__ __forceinline__ float min_energy(const Terms& t, float yv, float wv, float c1, float na,
                                            float xv, int* arg) {
  const float denom = fmaxf(__fsub_rn(na, 1.0f), 1.0f);
  const float d0 = __fsub_rn(yv, t.mu0);
  float e0 = __fmul_rn(wv, __fadd_rn(__fdiv_rn(__fmul_rn(d0, d0), t.two0), t.log0));
  e0 = __fadd_rn(e0, __fdiv_rn(__fmul_rn(t.beta, fmaxf(__fsub_rn(c1, xv), 0.0f)), denom));

  const float d1 = __fsub_rn(yv, t.mu1);
  float e1 = __fmul_rn(wv, __fadd_rn(__fdiv_rn(__fmul_rn(d1, d1), t.two1), t.log1));
  const float diff1 = __fsub_rn(__fsub_rn(na, c1), __fsub_rn(1.0f, xv));
  e1 = __fadd_rn(e1, __fdiv_rn(__fmul_rn(t.beta, fmaxf(diff1, 0.0f)), denom));

  const bool one = e1 < e0;
  *arg = one ? 1 : 0;
  // torch.minimum: NaN if either energy is NaN.
  return (e0 != e0) ? e0 : ((e1 != e1) ? e1 : (one ? e1 : e0));
}

struct Args {
  const float* y;
  const float* w;
  const float* n1;
  const float* nall;
  const float* xf;
  float* min_e;
  int* arg;
};

__device__ __forceinline__ void scalar_element(const Args& a, const Terms& t, long long i) {
  int lab;
  const float m = min_energy(t, __ldg(a.y + i), __ldg(a.w + i), __ldg(a.n1 + i),
                             __ldg(a.nall + i), __ldg(a.xf + i), &lab);
  a.min_e[i] = m;
  a.arg[i] = lab;
}

// Elements [0, head) and [head + 4 n_vec, n) one at a time; the n_vec
// float4 vectors from element head (16-byte aligned) kVecs at a time.
__global__ void __launch_bounds__(kThreads) mrf_min_energy_kernel(
    Args a, const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ beta_p, float beta_v, long long n, long long head,
    long long n_vec) {
  Terms t;
  t.mu0 = mu[0];
  t.mu1 = mu[1];
  const float s0 = sigma[0];
  const float s1 = sigma[1];
  t.two0 = __fmul_rn(__fmul_rn(2.0f, s0), s0);
  t.two1 = __fmul_rn(__fmul_rn(2.0f, s1), s1);
  t.log0 = logf(s0);
  t.log1 = logf(s1);
  t.beta = beta_p != nullptr ? beta_p[0] : beta_v;

  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < head; i += nthreads) scalar_element(a, t, i);

  const float4* y4 = reinterpret_cast<const float4*>(a.y + head);
  const float4* w4 = reinterpret_cast<const float4*>(a.w + head);
  const float4* n14 = reinterpret_cast<const float4*>(a.n1 + head);
  const float4* na4 = reinterpret_cast<const float4*>(a.nall + head);
  const float4* x4 = reinterpret_cast<const float4*>(a.xf + head);
  float4* m4 = reinterpret_cast<float4*>(a.min_e + head);
  int4* a4 = reinterpret_cast<int4*>(a.arg + head);
  for (long long v0 = tid; v0 < n_vec; v0 += nthreads * kVecs) {
    float4 yv[kVecs], wv[kVecs], c1[kVecs], na[kVecs], xv[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long v = v0 + u * nthreads;
      if (v < n_vec) {
        yv[u] = __ldg(y4 + v);
        wv[u] = __ldg(w4 + v);
        c1[u] = __ldg(n14 + v);
        na[u] = __ldg(na4 + v);
        xv[u] = __ldg(x4 + v);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const long long v = v0 + u * nthreads;
      if (v < n_vec) {
        float4 m;
        int4 lab;
        m.x = min_energy(t, yv[u].x, wv[u].x, c1[u].x, na[u].x, xv[u].x, &lab.x);
        m.y = min_energy(t, yv[u].y, wv[u].y, c1[u].y, na[u].y, xv[u].y, &lab.y);
        m.z = min_energy(t, yv[u].z, wv[u].z, c1[u].z, na[u].z, xv[u].z, &lab.z);
        m.w = min_energy(t, yv[u].w, wv[u].w, c1[u].w, na[u].w, xv[u].w, &lab.w);
        m4[v] = m;
        a4[v] = lab;
      }
    }
  }

  for (long long i = head + 4 * n_vec + tid; i < n; i += nthreads) scalar_element(a, t, i);
}

// Blocks of one wave on the current device: SMs x resident blocks per SM.
int wave_blocks(int* blocks) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mrf_min_energy_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs: y, w, n1, nall, xf (n,) f32, each stride 1 at any 4-byte
// alignment; mu, sigma (2,) f32; beta (1,) f32, or nullptr to use beta_v.
// Outputs: min_e (n,) f32; arg (n,) i32.  No launch when n is 0.  Returns
// cudaGetLastError() after the launch.
int repro_mrf_min_energy(const float* y, const float* w, const float* n1,
                         const float* nall, const float* xf, const float* mu,
                         const float* sigma, const float* beta, float beta_v, long long n,
                         float* min_e, int* arg, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Args a{y, w, n1, nall, xf, min_e, arg};
  const std::uintptr_t at = reinterpret_cast<std::uintptr_t>(y) % 16;
  const void* others[] = {w, n1, nall, xf, min_e, arg};
  bool aligned = at % 4 == 0;
  for (const void* p : others) aligned = aligned && reinterpret_cast<std::uintptr_t>(p) % 16 == at;
  long long head = n, n_vec = 0;
  if (aligned) {
    head = static_cast<long long>((16 - at) % 16 / 4);
    if (head > n) head = n;
    n_vec = (n - head) / 4;
  }
  int wave = 0;
  const int rc = wave_blocks(&wave);
  if (rc != 0) return rc;
  // Threads needed: one per kVecs vectors, or one per element when every
  // element goes through the scalar loop.
  const long long items = aligned ? (n_vec + kVecs - 1) / kVecs : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  mrf_min_energy_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, mu, sigma, beta, beta_v, n,
                                                                head, n_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
