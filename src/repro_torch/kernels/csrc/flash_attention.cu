// Online-softmax (flash) attention with grouped-query heads.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (the TPU kernel walks a (batch, q-head, q-block, kv-block) grid with the
// kv-block axis sequential and innermost, keeps the running max, normaliser
// and f32 accumulator of one (128 x D) q-block in VMEM scratch, and maps
// q-head h to kv-head h // group in its BlockSpecs, so the (S x S) scores
// and repeated K/V never reach HBM).
//
// Computes, per (batch, q-head): softmax(scale * Q K^T [causal-masked]) V,
// scale = D^-1/2 by default, masked scores set to NEG_INF = -1e30 as in the
// reference, and the final division by max(l, 1e-30).  Inputs are float32
// or bfloat16, read and converted to float32; the output is in q's type.
//
// What bounds it on an H100: operations.  At the LM prefill's shape
// (B = 1, Hq = 12, Hkv = 2, S = 1024, D = 128, bf16, causal) the work is
// 4 * 12 * 1024^2 * 128 / 2 = 3.2 GFLOP, 3.3 us at the tensor cores' 989
// TFLOP/s bf16, against 7.3 MB of operands and output (2.2 us at 3.35
// TB/s).  This kernel runs on the CUDA cores in float32 (67 TFLOP/s peak),
// so it cannot come near that bound; tensor cores (mma.sync or wgmma), TMA
// and a pipelined K/V ring are the later design.
//
// Design (simple and right first):
// * One block of 256 threads per (batch, q-head, q-tile of 64 rows).  A
//   loop inside the block over K/V tiles of 64 rows takes the place of the
//   reference's sequential kv-block grid axis.  Under `causal` the loop
//   stops at the diagonal tile: tiles wholly above it are skipped.
// * The Q tile and each K/V tile are staged in shared memory as float32
//   (rows padded by one word so that the score loop's column reads fall on
//   distinct banks); rows past S are filled with zeros and their scores
//   masked, so every S reaches the kernel and none needs padding outside.
// * Thread (ty, tx), ty, tx in [0, 16), owns rows ty + 16 i (i < 4) of the
//   tile: a 4 x 4 block of scores (columns tx + 16 j) and a 4 x D/16 block
//   of the accumulator (columns tx + 16 j).  The 16 threads of a row sit in
//   one half-warp, so row maxima and sums are shuffle reductions; each
//   thread keeps its rows' running max m and normaliser l in registers.
// * Probabilities go through shared memory (64 x 64) to the P V product.
// * K/V heads are read through the head map (kv head = h / group); no
//   per-q-head copy is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // k rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr int smem_floats() {
  // Qs, Ks: BQ/BK x (D + 1); Vs: BK x D; Ps: BQ x (BK + 1).
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          int row0, int s, int d) {
  // Rows row0 .. row0 + 63 of a (s, d) matrix into dst (row stride ld);
  // rows past s are zero.
  for (int idx = threadIdx.x; idx < BK * d; idx += THREADS) {
    const int r = idx / d;
    const int c = idx - r * d;
    const int g = row0 + r;
    dst[r * ld + c] = g < s ? to_f32(src[static_cast<long long>(g) * d + c]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
                       int s, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int NJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * D;

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const long long head = static_cast<long long>(b) * hq + h;
  const long long kv_head = static_cast<long long>(b) * hkv + h / group;
  const T* qh = q + head * s * D;
  const T* kh = k + kv_head * s * D;
  const T* vh = v + kv_head * s * D;

  load_tile<T>(Qs, LD, qh, qt * BQ, s, D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  const int n_kt = (s + BK - 1) / BK;
  const int last = causal ? min(qt + 1, n_kt) : n_kt;  // BQ == BK
  for (int kt = 0; kt < last; ++kt) {
    __syncthreads();  // the previous tile's Ks, Vs and Ps are no longer read
    load_tile<T>(Ks, LD, kh, kt * BK, s, D);
    load_tile<T>(Vs, D, vh, kt * BK, s, D);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = qt * BQ + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt * BK + tx + 16 * j;
        const bool ok = kpos < s && (!causal || kpos <= qpos);
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - mx);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }

  T* oh = out + head * s * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = qt * BQ + ty + 16 * i;
    if (qpos >= s) continue;
    const float inv = 1.0f / fmaxf(l[i], 1.0e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) store(oh + static_cast<long long>(qpos) * D + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int hkv, int s, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((s + BQ - 1) / BQ, hq, b);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), hq,
                                          hkv, s, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int b, int hq,
                       int hkv, int s, int d, float scale, int causal, cudaStream_t stream) {
  switch (d) {
#define REPRO_FLASH_D(DD) \
  case DD:                \
    return launch<T, DD>(q, k, v, out, b, hq, hkv, s, scale, causal, stream);
    REPRO_FLASH_D(16) REPRO_FLASH_D(32) REPRO_FLASH_D(48) REPRO_FLASH_D(64)
    REPRO_FLASH_D(80) REPRO_FLASH_D(96) REPRO_FLASH_D(112) REPRO_FLASH_D(128)
    REPRO_FLASH_D(144) REPRO_FLASH_D(160) REPRO_FLASH_D(176) REPRO_FLASH_D(192)
    REPRO_FLASH_D(208) REPRO_FLASH_D(224) REPRO_FLASH_D(240) REPRO_FLASH_D(256)
#undef REPRO_FLASH_D
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (b, hq, s, d); k, v: (b, hkv, s, d); out: (b, hq, s, d); all contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16.  d is a multiple of 16 in
// [16, 256] and hq a multiple of hkv.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes or types it does not take).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                          int hq, int hkv, int s, int d, float scale, int causal, int dtype,
                          void* stream) {
  if (b < 1 || hkv < 1 || hq % hkv != 0 || s < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    e = dispatch_d<float>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st);
  } else if (dtype == 1) {
    e = dispatch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
