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
// K: K = 2..8 are template instantiations with the per-label values in
// registers.  Any K >= 9 takes one runtime-K variant of both launches with
// the same energy op order: the hood pass keeps the per-label terms in the
// block's shared memory and the counts in a shared row per warp (11 K
// floats a block), and the finalize writes the labels first.  Its float
// sums take the plain version's order, element by element: each hood's
// energy sum one element at a time, each label's M-step sums vertex by
// vertex (one thread per label over tiles staged in shared memory).  So at
// f32 it equals the plain version bit for bit wherever that version sums
// in element order (on the CPU, and on the card under
// torch.use_deterministic_algorithms): iteration counts then cannot part
// at a convergence threshold, which with 9 labels they did by one MAP
// iteration in the templated kernels' order.  The shared memory bounds K
// at kMaxLabels = 5,282 (227 KB a block on an H100).
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
constexpr int kSmemPerBlock = 232448;  // 227 KB: the most a block may take on an H100

// Dynamic shared memory of the runtime-K hood pass: 3 K terms and K counts
// per warp.
constexpr size_t hood_rt_smem_bytes(int n_labels) {
  return static_cast<size_t>(3 + kHoodThreads / kWarp) * n_labels * sizeof(float);
}
constexpr int kMaxLabels = kSmemPerBlock / static_cast<int>(hood_rt_smem_bytes(1));

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

// Runtime-K hood pass (K >= 9): hood_pass_kernel's energies with the
// per-label terms and the warp's counts in dynamic shared memory, and the
// hood's energy sum in element order.
template <bool BF16>
__global__ void __launch_bounds__(kHoodThreads) hood_pass_kernel_rt(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ nall, const float* __restrict__ xf,
    const float* __restrict__ valid, const int* __restrict__ vertex,
    const int* __restrict__ offsets, const float* __restrict__ mu,
    const float* __restrict__ sigma, const float* __restrict__ beta_p,
    int n_labels, int n_hoods, int n_vertices, float* __restrict__ hood_e,
    float* __restrict__ votes) {
  const int K = n_labels;
  extern __shared__ float smem[];  // [mu | 2 sigma^2 | log sigma | counts per warp]
  float* mu_l = smem;
  float* two_ss = smem + K;
  float* log_s = smem + 2 * K;
  float* cnt = smem + 3 * K + (threadIdx.x / kWarp) * K;
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const float s = rnd<BF16>(sigma[l]);
    mu_l[l] = rnd<BF16>(mu[l]);
    two_ss[l] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(2.0f, s)), s));
    log_s[l] = rnd<BF16>(logf(s));
  }
  __syncthreads();

  const int hood = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (hood >= n_hoods) return;  // the whole warp leaves together
  const int begin = offsets[hood];
  const int end = offsets[hood + 1];

  // 1. Label counts, one label at a time: each lane sums its elements in
  // the order of the templated kernel, then the warp tree.
  for (int l = 0; l < K; ++l) {
    float c = 0.0f;
    for (int e = begin + lane; e < end; e += kWarp) {
      const int xi = min(max(static_cast<int>(xf[e]), 0), K - 1);
      c += (xi == l) ? valid[e] : 0.0f;
    }
    c = rnd<BF16>(warp_sum(c));
    if (lane == 0) cnt[l] = c;
  }
  __syncwarp();
  const float beta = rnd<BF16>(beta_p[0]);

  // 2. Energies, min/argmin, the votes, and the hood's energy sum in
  // element order (the plain version's order): a warp-uniform loop over
  // chunks of 32 elements, each chunk's products added one lane at a time.
  float acc = 0.0f;
  for (int base = begin; base < end; base += kWarp) {
    const int e = base + lane;
    float part = 0.0f;
    bool take = false;
    if (e < end) {
      const float v32 = valid[e];
      const float yv = rnd<BF16>(y[e]);
      const float wv = rnd<BF16>(w[e]);
      const float na = rnd<BF16>(nall[e]);
      const float xv = rnd<BF16>(xf[e]);
      const float vv = rnd<BF16>(v32);
      const float denom = rnd<BF16>(fmaxf(rnd<BF16>(__fsub_rn(na, 1.0f)), 1.0f));
      float best = 0.0f;
      int arg = 0;
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
      take = v32 > 0.0f;
      part = __fmul_rn(best, v32);
      const int vtx = vertex[e];
      if (take && vtx >= 0 && vtx < n_vertices) {
        atomicAdd(votes + arg * n_vertices + vtx, v32);
      }
    }
    const unsigned takes = __ballot_sync(0xffffffffu, take);
    for (int j = 0; j < kWarp && base + j < end; ++j) {
      const float pj = __shfl_sync(0xffffffffu, part, j);
      if (takes & (1u << j)) acc = __fadd_rn(acc, pj);
    }
  }
  if (lane == 0) hood_e[hood] = acc;
}

// Runtime-K finalize (K >= 9): the labels first, then the M-step sums of
// each label in vertex order, as the plain version sums them.
__global__ void __launch_bounds__(kFinalThreads) finalize_kernel_rt(
    const float* __restrict__ votes, const float* __restrict__ region_mean,
    const float* __restrict__ region_weight, const float* __restrict__ hood_e,
    const float* __restrict__ hist, int hist_rows, int n_labels, int n_hoods,
    int n_vertices, float conv_tol, int* __restrict__ labels,
    float* __restrict__ stats, int* __restrict__ conv) {
  const int K = n_labels;
  // Plurality labels.
  for (int v = threadIdx.x; v < n_vertices; v += blockDim.x) {
    float best = votes[v];
    int lab = 0;
    for (int l = 1; l < K; ++l) {
      const float c = votes[l * n_vertices + v];
      if (c > best) {
        best = c;
        lab = l;
      }
    }
    if (v == n_vertices - 1) lab = 0;
    labels[v] = lab;
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

  // M-step sums in the plain version's order: vertex by vertex, one thread
  // per label, over tiles of the new labels and the region terms staged in
  // shared memory.
  __shared__ int tile_lab[kFinalThreads];
  __shared__ float tile_w[kFinalThreads], tile_wy[kFinalThreads], tile_wyy[kFinalThreads];
  for (int l0 = 0; l0 < K; l0 += blockDim.x) {
    const int l = l0 + threadIdx.x;
    float sw = 0.0f, swy = 0.0f, swyy = 0.0f;
    for (int t0 = 0; t0 < n_vertices; t0 += blockDim.x) {
      const int v = t0 + threadIdx.x;
      if (v < n_vertices) {
        const float wr = region_weight[v];
        const float wy = __fmul_rn(wr, region_mean[v]);
        tile_lab[threadIdx.x] = labels[v];
        tile_w[threadIdx.x] = wr;
        tile_wy[threadIdx.x] = wy;
        tile_wyy[threadIdx.x] = __fmul_rn(wy, region_mean[v]);
      }
      __syncthreads();
      const int len = min(static_cast<int>(blockDim.x), n_vertices - t0);
      if (l < K) {
        for (int i = 0; i < len; ++i) {
          if (tile_lab[i] == l) {
            sw = __fadd_rn(sw, tile_w[i]);
            swy = __fadd_rn(swy, tile_wy[i]);
            swyy = __fadd_rn(swyy, tile_wyy[i]);
          }
        }
      }
      __syncthreads();
    }
    if (l < K) {
      stats[l] = sw;
      stats[K + l] = swy;
      stats[2 * K + l] = swyy;
    }
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

template <bool BF16>
int launch_rt(const float* y, const float* w, const float* nall, const float* xf,
              const float* valid, const int* vertex, const int* offsets,
              const float* region_mean, const float* region_weight,
              const float* hist, int hist_rows, const float* mu,
              const float* sigma, const float* beta, int n_labels, int n_hoods,
              int n_vertices, float conv_tol, int* labels, float* hood_e,
              float* votes, float* stats, int* conv, cudaStream_t stream) {
  const size_t smem = hood_rt_smem_bytes(n_labels);
  if (n_labels > kMaxLabels) return static_cast<int>(cudaErrorInvalidValue);
  if (n_hoods > 0) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          hood_pass_kernel_rt<BF16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const long long threads = static_cast<long long>(n_hoods) * kWarp;
    const unsigned int blocks =
        static_cast<unsigned int>((threads + kHoodThreads - 1) / kHoodThreads);
    hood_pass_kernel_rt<BF16><<<blocks, kHoodThreads, smem, stream>>>(
        y, w, nall, xf, valid, vertex, offsets, mu, sigma, beta, n_labels, n_hoods,
        n_vertices, hood_e, votes);
    if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
  }
  finalize_kernel_rt<<<1, kFinalThreads, 0, stream>>>(
      votes, region_mean, region_weight, hood_e, hist, hist_rows, n_labels, n_hoods,
      n_vertices, conv_tol, labels, stats, conv);
  return static_cast<int>(cudaGetLastError());
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
      if (n_labels < 9) return static_cast<int>(cudaErrorInvalidValue);
      return bf16 ? launch_rt<true>(y, w, nall, xf, valid, vertex, offsets, region_mean,
                                    region_weight, hist, hist_rows, mu, sigma, beta,
                                    n_labels, n_hoods, n_vertices, conv_tol, labels,
                                    hood_e, votes, stats, conv, s)
                  : launch_rt<false>(y, w, nall, xf, valid, vertex, offsets, region_mean,
                                     region_weight, hist, hist_rows, mu, sigma, beta,
                                     n_labels, n_hoods, n_vertices, conv_tol, labels,
                                     hood_e, votes, stats, conv, s);
  }
#undef REPRO_TICK_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
