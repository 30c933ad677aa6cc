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
// or bfloat16; the output is in q's type.
//
// What bounds it on an H100: operations.  At the LM prefill's shape
// (B = 1, Hq = 12, Hkv = 2, S = 1024, D = 128, bf16, causal) the work is
// 4 * 12 * 1024 * 1025 / 2 * 128 = 3.2 GFLOP, 3.3 us at the tensor cores'
// 989 TFLOP/s bf16, against 7.3 MB of operands and output (2.2 us at 3.35
// TB/s).  At S = 512 the bytes bound (3.7 MB, 1.1 us) is the larger.
//
// Two kernels, chosen by (dtype, D) in repro_flash_attention:
//
// 1. bfloat16 at D = 64 or 128: flash_attention_tc_kernel, on the tensor
//    cores.  Bounded by the tensor cores' rate; what keeps it from that
//    bound at these sizes is the serial chain inside one warpgroup (score
//    product, softmax, value product) and the causal grid's imbalance.
//    * One block per (batch, q-head, 64-row q-tile): one consumer
//      warpgroup (warps 0-3) that owns the 64 q rows, and one producer
//      warp (warp 4).  The grid is ordered so that the heaviest causal
//      q-tiles start first.
//    * The producer loads the Q tile once and the K and V tiles into a
//      ring of two stages by TMA (3-D tensor maps (D, S, B*H), so rows
//      past S arrive zero-filled and no padding is needed outside), with
//      a full and an empty mbarrier per stage.  Tiles are 64-column
//      halves of 128 bytes a row, 128-byte swizzled, as wgmma reads them.
//    * S = Q K^T: wgmma m64n64k16, Q and K both K-major from shared
//      memory, f32 accumulators (bf16 x bf16 products are exact in f32).
//      The row max and sum are reduced over the four threads of a quad
//      that hold a row of the accumulator; masking (causal diagonal,
//      ragged tail) is applied to the last tile only, since every earlier
//      tile is wholly visible.  Tiles above the diagonal are not loaded.
//    * O += P V: wgmma m64nDk16 with P rounded to bf16 in registers (the
//      accumulator layout of the score product is the A-fragment layout
//      of the value product) and V read MN-major (transposed) from shared
//      memory.  Rounding P to bf16 is what the JAX reference does too
//      (p.astype(v.dtype)).  O stays in f32 registers (D/2 a thread).
//    * 80 KB of shared memory at D = 128 and about 40 at D = 64, so two
//      blocks fit on an SM and the softmax of one overlaps the products
//      of the other; the output is written from registers, rows past S
//      are not stored.
//
// 2. float32 at any D, and bfloat16 at D other than 64 and 128:
//    flash_attention_kernel, on the CUDA cores in float32 (67 TFLOP/s peak;
//    it cannot come near the bound above).  float32 stays here on purpose:
//    the tensor cores take float32 only as TF32 (10-bit mantissa) or after
//    rounding to bf16, which would break the float32 tolerances the callers
//    hold it to (2e-4 against the plain version; identical greedy tokens in
//    the LM check).
//    * One block of 256 threads per (batch, q-head, q-tile of 64 rows).  A
//      loop inside the block over K/V tiles of 64 rows takes the place of
//      the reference's sequential kv-block grid axis.  Under `causal` the
//      loop stops at the diagonal tile: tiles wholly above it are skipped.
//    * The Q tile and each K/V tile are staged in shared memory as float32
//      (rows padded by one word so that the score loop's column reads fall
//      on distinct banks); rows past S are filled with zeros and their
//      scores masked, so every S reaches the kernel and none needs padding
//      outside.
//    * Thread (ty, tx), ty, tx in [0, 16), owns rows ty + 16 i (i < 4) of
//      the tile: a 4 x 4 block of scores (columns tx + 16 j) and a 4 x D/16
//      block of the accumulator (columns tx + 16 j).  The 16 threads of a
//      row sit in one half-warp, so row maxima and sums are shuffle
//      reductions; each thread keeps its rows' running max m and
//      normaliser l in registers.
//    * Probabilities go through shared memory (64 x 64) to the P V product.
//    * K/V heads are read through the head map (kv head = h / group); no
//      per-q-head copy is made.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

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

// The choice of kernel, made here only: bfloat16 (dtype 1) at D = 64 and 128
// goes to the tensor-core kernel, so those two CUDA-core instantiations are
// not built.
constexpr bool on_tensor_cores(int dtype, int d) { return dtype == 1 && (d == 64 || d == 128); }

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int b, int hq,
                       int hkv, int s, int d, float scale, int causal, cudaStream_t stream) {
  switch (d) {
#define REPRO_FLASH_D(DD)                                                          \
  case DD:                                                                         \
    if constexpr (!on_tensor_cores(std::is_same<T, __nv_bfloat16>::value, DD))     \
      return launch<T, DD>(q, k, v, out, b, hq, hkv, s, scale, causal, stream);    \
    return cudaErrorInvalidValue;
    REPRO_FLASH_D(16) REPRO_FLASH_D(32) REPRO_FLASH_D(48) REPRO_FLASH_D(64)
    REPRO_FLASH_D(80) REPRO_FLASH_D(96) REPRO_FLASH_D(112) REPRO_FLASH_D(128)
    REPRO_FLASH_D(144) REPRO_FLASH_D(160) REPRO_FLASH_D(176) REPRO_FLASH_D(192)
    REPRO_FLASH_D(208) REPRO_FLASH_D(224) REPRO_FLASH_D(240) REPRO_FLASH_D(256)
#undef REPRO_FLASH_D
    default:
      return cudaErrorInvalidValue;
  }
}


// ---- bfloat16 on the tensor cores (D = 64, 128) ------------------------------

constexpr int TC_ROWS = 64;             // q rows per block = k rows per tile
constexpr int TC_STAGES = 2;            // K/V ring depth
constexpr int TC_THREADS = 128 + 32;    // one consumer warpgroup + one producer warp
constexpr int HALF_BYTES = 64 * 128;    // 64 rows x 64 bf16 columns (one TMA box)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcLayout {
  static constexpr int HALVES = D / 64;
  static constexpr int TILE = HALVES * HALF_BYTES;          // one 64 x D bf16 tile
  static constexpr int Q = 0;                               // offsets from a 1024-aligned base
  static constexpr int KV = TILE;                           // stage st: K at KV + 2 st TILE, V + TILE
  static constexpr int BARS = TILE * (1 + 2 * TC_STAGES);   // q_full, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * TC_STAGES) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Accumulator layout of wgmma m64nNk16 (f32): thread t = 32 w + lane of the
// warpgroup holds, for i < N/2, the element at row 16 w + lane / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (lane % 4) + i % 2.  Each thread thus owns two rows
// (r and r + 8) and shares each with the other three threads of its quad.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                          int bh, int hq, int group, int s, float scale_log2, int causal) {
  using L = TcLayout<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base + L::Q;
  const uint32_t q_full = base + L::BARS;
  auto k_tile = [&](int st) { return base + L::KV + 2 * st * L::TILE; };
  auto full = [&](int st) { return q_full + 8 + 8 * st; };
  auto empty = [&](int st) { return q_full + 8 + 8 * TC_STAGES + 8 * st; };

  // Heaviest q-tiles first: consecutive blocks take one q-tile of every
  // (batch, head), from the last q-tile down.
  const int n_tiles_q = (s + TC_ROWS - 1) / TC_ROWS;
  const int head = blockIdx.x % bh;                    // b * hq + h
  const int qt = n_tiles_q - 1 - blockIdx.x / bh;
  const int kv_head = (head / hq) * (hq / group) + (head % hq) / group;
  const int last = causal ? qt : n_tiles_q - 1;        // last K/V tile this block reads

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int st = 0; st < TC_STAGES; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // Producer warp: one thread issues every copy.
    if (threadIdx.x == 128) {
      hopper::mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int hf = 0; hf < L::HALVES; ++hf)
        hopper::tma_load_3d(sq + hf * HALF_BYTES, &tm_q, 64 * hf, qt * TC_ROWS, head, q_full);
      for (int t = 0; t <= last; ++t) {
        const int st = t % TC_STAGES;
        if (t >= TC_STAGES) hopper::mbar_wait(empty(st), ((t / TC_STAGES) - 1) & 1);
        hopper::mbar_arrive_expect_tx(full(st), 2 * L::TILE);
        const uint32_t sk = k_tile(st);
#pragma unroll
        for (int hf = 0; hf < L::HALVES; ++hf) {
          hopper::tma_load_3d(sk + hf * HALF_BYTES, &tm_k, 64 * hf, t * TC_ROWS, kv_head, full(st));
          hopper::tma_load_3d(sk + L::TILE + hf * HALF_BYTES, &tm_v, 64 * hf, t * TC_ROWS, kv_head,
                              full(st));
        }
      }
    }
    return;
  }

  // Consumer warpgroup.
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2);   // and row + 8
  const int col = 2 * (lane & 3);
  const int q0 = qt * TC_ROWS + row;

  float o[D / 2];
  float sc[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;

  hopper::mbar_wait(q_full, 0);
  for (int t = 0; t <= last; ++t) {
    const int st = t % TC_STAGES;
    hopper::mbar_wait(full(st), (t / TC_STAGES) & 1);
    const uint32_t sk = k_tile(st);
    const uint32_t sv = sk + L::TILE;

    // S = Q K^T over D in steps of 16: K-major descriptors move 32 bytes
    // along a 128-byte row, then to the next 64-column half.
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * HALF_BYTES + (kk % 4) * 32;
      hopper::wgmma_ss_m64n64k16(sc, hopper::sw128_desc(sq + off, 16, 1024),
                                 hopper::sw128_desc(sk + off, 16, 1024), kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // Scale into log2 units; mask the diagonal tile (causal) and keys past S.
    if (t == last) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qpos = q0 + 8 * ((i >> 1) & 1);
        const int kpos = t * TC_ROWS + 8 * (i >> 2) + col + (i & 1);
        const bool ok = kpos < s && (!causal || kpos <= qpos);
        sc[i] = ok ? sc[i] * scale_log2 : NEG_INF;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = exp2f(m0 - mx0);
    const float c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;

    // P in bf16, packed as the A fragments of the value product: k-step kk
    // (keys 16 kk .. 16 kk + 15) is p[4 kk .. 4 kk + 3].
    uint32_t p[16];
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const float a = exp2f(sc[i] - mx0), b = exp2f(sc[i + 1] - mx0);
      const float c = exp2f(sc[i + 2] - mx1), d = exp2f(sc[i + 3] - mx1);
      sum0 += a + b;
      sum1 += c + d;
      p[i / 2] = pack_bf16(a, b);
      p[i / 2 + 1] = pack_bf16(c, d);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      o[i] *= c0;
      o[i + 1] *= c0;
      o[i + 2] *= c1;
      o[i + 3] *= c1;
    }

    // O += P V over the tile's 64 keys in steps of 16 (16 rows = 2048 bytes);
    // V is MN-major: its two 64-column halves lie HALF_BYTES apart (LBO).
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
      const uint64_t desc = hopper::sw128_desc(sv + kk * 2048, HALF_BYTES, 1024);
      if constexpr (D == 128) {
        hopper::wgmma_rs_m64n128k16(o, a, desc);
      } else {
        hopper::wgmma_rs_m64n64k16(o, a, desc);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
    hopper::mbar_arrive(empty(st));
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1.0e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1.0e-30f);
  __nv_bfloat16* o0 = out + (static_cast<long long>(head) * s + q0) * D + col;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (q0 < s)
      *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    if (q0 + 8 < s)
      *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (d, s, heads) bf16 tensor map with (64, 64, 1) boxes, 128-byte swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int s, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {64, TC_ROWS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int b, int hq,
                      int hkv, int s, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_q, q, b * hq, s, D) || !tensor_map(&tm_k, k, b * hkv, s, D) ||
      !tensor_map(&tm_v, v, b * hkv, s, D))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_tc_kernel<D>;
  constexpr int smem = TcLayout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  const long long blocks = static_cast<long long>((s + TC_ROWS - 1) / TC_ROWS) * b * hq;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), b * hq, hq, hq / hkv, s, scale * LOG2E,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q: (b, hq, s, d); k, v: (b, hkv, s, d); out: (b, hq, s, d); all contiguous,
// of one type: dtype 0 = float32, 1 = bfloat16.  d is a multiple of 16 in
// [16, 256] and hq a multiple of hkv.  bfloat16 at d = 64 or 128 runs on the
// tensor cores (q, k, v 16-byte aligned, as TMA reads them); every other
// case on the CUDA cores.  This is the one place that choice is made: it is
// reported in *tensor_cores (1 or 0) before the launch.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes or
// types it does not take, cudaErrorMisalignedAddress for unaligned operands
// of the tensor-core kernel).
int repro_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                          int hq, int hkv, int s, int d, float scale, int causal, int dtype,
                          void* stream, int* tensor_cores) {
  *tensor_cores = 0;
  if (b < 1 || hkv < 1 || hq % hkv != 0 || s < 1 || d % 16 != 0 || d < 16 || d > 256 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_tensor_cores(dtype, d)) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
      return static_cast<int>(cudaErrorMisalignedAddress);
    *tensor_cores = 1;
    return static_cast<int>(d == 64 ? launch_tc<64>(q, k, v, out, b, hq, hkv, s, scale, causal, st)
                                    : launch_tc<128>(q, k, v, out, b, hq, hkv, s, scale, causal, st));
  }
  return static_cast<int>(
      dtype == 0 ? dispatch_d<float>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st)
                 : dispatch_d<__nv_bfloat16>(q, k, v, out, b, hq, hkv, s, d, scale, causal, st));
}

}  // extern "C"
