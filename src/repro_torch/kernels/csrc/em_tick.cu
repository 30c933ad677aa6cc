// The whole EM tick of the static-pallas route: per-(hood, label) counts,
// K label energies, per-element min/argmin, per-hood energy sums, label
// votes, plurality labels, M-step sums and the convergence-window flag.
//
// Replaces: src/repro/kernels/em_tick.py :: fused_em_tick_pallas.  The TPU
// kernel streams the hood elements twice through (segments x 1024) one-hot
// tiles held in VMEM and contracts them on the MXU; its dispatch refuses
// problems whose tiles pass 8 MB, which a 512x512 slice does.
//
// What bounds it on an H100: memory and launch time.  A tick reads each
// hood element once (y, w, nall, xf, valid, vertex: 24 B), writes one vote
// atomic per valid element and reads the region and history arrays once.
// At a 512x512 slice that is well under a megabyte, a fraction of a
// microsecond of HBM time, so the two launches' fixed cost dominates.
// There is no tensor-core work.
//
// Design: hood elements are sorted by (hood, vertex), so every hood is a
// contiguous run [offsets[h], offsets[h+1]).  That turns the per-hood
// reductions into segmented runs and needs no one-hot tiles:
//   1. hood pass, one warp per hood (a loop in steps of 32 for longer
//      hoods): label counts by warp reductions (integer-valued, so exact),
//      then the K energies per element with the op order of the JAX
//      helper label_energies_blocked, min/argmin with a strict '<' (ties go
//      to the lowest label), the hood's energy sum by a warp reduction in a
//      fixed order, and one atomicAdd per valid element into the zeroed
//      (K, V) vote field (integer-valued, so exact in any order);
//   2. finalize, one block: each vertex's vote argmax (strict '>', the
//      sentinel vertex V-1 set to 0), the M-step sums over the vertices as
//      block reductions, and the window predicate over hood_e and hist.
// The counts must be complete before any energy is computed, and the votes
// before any label; the warp owns its hood's counts, and the stream orders
// the second launch after the first.
//
// Arithmetic: every energy op is an explicitly rounded intrinsic
// (__fmul_rn, __fdiv_rn, ...) so nvcc cannot contract it into an FMA and
// each op rounds as PyTorch's separate ops do.  With bf16 every operand and
// every intermediate is rounded to bfloat16 (as a bfloat16 tensor op
// would), while counts, hood sums, votes and M-step sums stay float32.
// hood_e and the M-step sums are summed in another order than the plain
// version's index_add_, so they agree to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kHoodThreads = 256;
constexpr int kFinalThreads = 1024;

template <bool BF16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int K, bool BF16>
__global__ void __launch_bounds__(kHoodThreads) hood_pass_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ nall, const float* __restrict__ xf,
    const float* __restrict__ valid, const int* __restrict__ vertex,
    const int* __restrict__ offsets, const float* __restrict__ mu,
    const float* __restrict__ sigma, const float* __restrict__ beta_p,
    int n_hoods, int n_vertices, float* __restrict__ hood_e,
    float* __restrict__ votes) {
  const int hood = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (hood >= n_hoods) return;  // the whole warp leaves together
  const int begin = offsets[hood];
  const int end = offsets[hood + 1];

  // 1. How many elements of this hood carry each label.
  float cnt[K];
#pragma unroll
  for (int l = 0; l < K; ++l) cnt[l] = 0.0f;
  for (int e = begin + lane; e < end; e += kWarp) {
    const float v = valid[e];
    const int xi = min(max(static_cast<int>(xf[e]), 0), K - 1);
#pragma unroll
    for (int l = 0; l < K; ++l) cnt[l] += (xi == l) ? v : 0.0f;
  }
#pragma unroll
  for (int l = 0; l < K; ++l) cnt[l] = rnd<BF16>(warp_sum(cnt[l]));

  // Per-label terms shared by every element of the hood.
  float mu_l[K], two_ss[K], log_s[K];
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float s = rnd<BF16>(sigma[l]);
    mu_l[l] = rnd<BF16>(mu[l]);
    two_ss[l] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(2.0f, s)), s));
    log_s[l] = rnd<BF16>(logf(s));
  }
  const float beta = rnd<BF16>(beta_p[0]);

  // 2. Energies, min/argmin, the hood's energy sum and the votes.
  float acc = 0.0f;
  for (int e = begin + lane; e < end; e += kWarp) {
    const float v32 = valid[e];
    const float yv = rnd<BF16>(y[e]);
    const float wv = rnd<BF16>(w[e]);
    const float na = rnd<BF16>(nall[e]);
    const float xv = rnd<BF16>(xf[e]);
    const float vv = rnd<BF16>(v32);
    const float denom = rnd<BF16>(fmaxf(rnd<BF16>(__fsub_rn(na, 1.0f)), 1.0f));
    float best = 0.0f;
    int arg = 0;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float d = rnd<BF16>(__fsub_rn(yv, mu_l[l]));
      const float quad = rnd<BF16>(__fdiv_rn(rnd<BF16>(__fmul_rn(d, d)), two_ss[l]));
      const float data = rnd<BF16>(__fmul_rn(wv, rnd<BF16>(__fadd_rn(quad, log_s[l]))));
      const float eq = (xv == static_cast<float>(l)) ? 1.0f : 0.0f;
      const float diff = rnd<BF16>(
          __fsub_rn(rnd<BF16>(__fsub_rn(na, cnt[l])), __fsub_rn(1.0f, eq)));
      const float smooth = rnd<BF16>(__fmul_rn(
          rnd<BF16>(__fdiv_rn(rnd<BF16>(__fmul_rn(beta, fmaxf(diff, 0.0f))), denom)),
          vv));
      const float en = rnd<BF16>(__fadd_rn(data, smooth));
      if (l == 0 || en < best) {
        best = en;
        arg = l;
      }
    }
    acc = __fadd_rn(acc, __fmul_rn(best, v32));
    const int vtx = vertex[e];
    if (v32 > 0.0f && vtx >= 0 && vtx < n_vertices) {
      atomicAdd(votes + arg * n_vertices + vtx, v32);
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) hood_e[hood] = acc;
}

template <int K>
__global__ void __launch_bounds__(kFinalThreads) finalize_kernel(
    const float* __restrict__ votes, const float* __restrict__ region_mean,
    const float* __restrict__ region_weight, const float* __restrict__ hood_e,
    const float* __restrict__ hist, int hist_rows, int n_hoods, int n_vertices,
    float conv_tol, int* __restrict__ labels, float* __restrict__ stats,
    int* __restrict__ conv) {
  float sw[K], swy[K], swyy[K];
#pragma unroll
  for (int l = 0; l < K; ++l) sw[l] = swy[l] = swyy[l] = 0.0f;

  // Plurality labels and the M-step sums of the new labels.
  for (int v = threadIdx.x; v < n_vertices; v += blockDim.x) {
    float best = votes[v];
    int lab = 0;
#pragma unroll
    for (int l = 1; l < K; ++l) {
      const float c = votes[l * n_vertices + v];
      if (c > best) {
        best = c;
        lab = l;
      }
    }
    if (v == n_vertices - 1) lab = 0;
    labels[v] = lab;
    const float wr = region_weight[v];
    const float wy = __fmul_rn(wr, region_mean[v]);
    const float wyy = __fmul_rn(wy, region_mean[v]);
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l == lab) {
        sw[l] = __fadd_rn(sw[l], wr);
        swy[l] = __fadd_rn(swy[l], wy);
        swyy[l] = __fadd_rn(swyy[l], wyy);
      }
    }
  }

  // Window predicate on [hood_e, hist[0], ..., hist[rows-2]].
  int ok = 1;
  for (int h = threadIdx.x; h < n_hoods; h += blockDim.x) {
    const float he = hood_e[h];
    const float tol = __fmul_rn(conv_tol, fmaxf(fabsf(he), 1.0f));
    ok &= fabsf(__fsub_rn(he, hist[h])) < tol;
    for (int r = 0; r + 2 < hist_rows; ++r) {
      ok &= fabsf(__fsub_rn(hist[r * n_hoods + h], hist[(r + 1) * n_hoods + h])) < tol;
    }
  }
  const int all_ok = __syncthreads_and(ok);

  __shared__ float part[kFinalThreads / kWarp][3 * K];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    const float a = warp_sum(sw[l]);
    const float b = warp_sum(swy[l]);
    const float c = warp_sum(swyy[l]);
    if (lane == 0) {
      part[warp][l] = a;
      part[warp][K + l] = b;
      part[warp][2 * K + l] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x < 3 * K) {
    float s = 0.0f;
    for (int i = 0; i < static_cast<int>(blockDim.x) / kWarp; ++i) s += part[i][threadIdx.x];
    stats[threadIdx.x] = s;
  }
  if (threadIdx.x == 0) conv[0] = all_ok;
}

template <int K, bool BF16>
void launch(const float* y, const float* w, const float* nall, const float* xf,
            const float* valid, const int* vertex, const int* offsets,
            const float* region_mean, const float* region_weight,
            const float* hist, int hist_rows, const float* mu,
            const float* sigma, const float* beta, int n_hoods, int n_vertices,
            float conv_tol, int* labels, float* hood_e, float* votes,
            float* stats, int* conv, cudaStream_t stream) {
  if (n_hoods > 0) {
    const long long threads = static_cast<long long>(n_hoods) * kWarp;
    const unsigned int blocks =
        static_cast<unsigned int>((threads + kHoodThreads - 1) / kHoodThreads);
    hood_pass_kernel<K, BF16><<<blocks, kHoodThreads, 0, stream>>>(
        y, w, nall, xf, valid, vertex, offsets, mu, sigma, beta, n_hoods,
        n_vertices, hood_e, votes);
    if (cudaPeekAtLastError() != cudaSuccess) return;
  }
  finalize_kernel<K><<<1, kFinalThreads, 0, stream>>>(
      votes, region_mean, region_weight, hood_e, hist, hist_rows, n_hoods,
      n_vertices, conv_tol, labels, stats, conv);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs: y, w, nall, xf, valid (H,) f32; vertex (H,) i32; offsets
// (n_hoods+1,) i32; region_mean, region_weight (n_vertices,) f32; hist
// (hist_rows, n_hoods) f32; mu, sigma (n_labels,) f32; beta (1,) f32.
// Outputs: labels (n_vertices,) i32; hood_e (n_hoods,) f32; votes
// (n_labels, n_vertices) f32, zeroed by the caller; stats (3, n_labels) f32
// = sum_w, sum_wy, sum_wyy; conv (1,) i32.  Returns cudaGetLastError().
int repro_fused_em_tick(const float* y, const float* w, const float* nall,
                        const float* xf, const float* valid, const int* vertex,
                        const int* offsets, const float* region_mean,
                        const float* region_weight, const float* hist,
                        int hist_rows, const float* mu, const float* sigma,
                        const float* beta, int n_hoods, int n_vertices,
                        int n_labels, int bf16, float conv_tol, int* labels,
                        float* hood_e, float* votes, float* stats, int* conv,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_TICK_CASE(K)                                                     \
  case K:                                                                      \
    if (bf16) {                                                                \
      launch<K, true>(y, w, nall, xf, valid, vertex, offsets, region_mean,     \
                      region_weight, hist, hist_rows, mu, sigma, beta,         \
                      n_hoods, n_vertices, conv_tol, labels, hood_e, votes,    \
                      stats, conv, s);                                         \
    } else {                                                                   \
      launch<K, false>(y, w, nall, xf, valid, vertex, offsets, region_mean,    \
                       region_weight, hist, hist_rows, mu, sigma, beta,        \
                       n_hoods, n_vertices, conv_tol, labels, hood_e, votes,   \
                       stats, conv, s);                                        \
    }                                                                          \
    break;
  switch (n_labels) {
    REPRO_TICK_CASE(2)
    REPRO_TICK_CASE(3)
    REPRO_TICK_CASE(4)
    REPRO_TICK_CASE(5)
    REPRO_TICK_CASE(6)
    REPRO_TICK_CASE(7)
    REPRO_TICK_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TICK_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
