// One MAP iteration of the static-pallas route in one launch: the label
// gather, per-(hood, label) counts, K label energies, per-element
// min/argmin, per-hood energy sums, the hood's convergence window and
// finiteness, label votes, plurality labels and the M-step sums.
//
// Replaces: src/repro/kernels/em_tick.py :: fused_em_tick_pallas.  The TPU
// kernel streams the hood elements twice through (segments x 1024) one-hot
// tiles held in VMEM and contracts them on the MXU; its dispatch refuses
// problems whose tiles pass 8 MB, which a 512x512 slice does.
//
// What bounds it on an H100: launch and host time.  A MAP iteration reads
// each hood element once (y, w, nall, valid, vertex and the gathered
// label: 24 B), writes one vote atomic per valid element and reads the
// region arrays and the history ring once.  At a 512x512 slice that is
// under a megabyte, a fraction of a microsecond of HBM time, so what a
// solve pays is the launch, the wait for the flag and whatever the host
// does between iterations.  There is no tensor-core work.
//
// Design: one launch per MAP iteration and nothing else on the stream.
//   1. Hood pass, one warp per hood.  Hood elements are sorted by (hood,
//      vertex), so hood h is the run [offsets[h], offsets[h+1]).  The warp
//      gathers each element's label from the label buffer (x = labels_in
//      [vertex[e]], xf = x * valid[e]; or reads xf when the caller gives
//      it), counts the labels by warp reductions (integer-valued, so
//      exact), computes the K energies with the op order of the JAX helper
//      label_energies_blocked, takes the min/argmin with a strict '<'
//      (ties to the lowest label), sums the hood's energy in element
//      order (plainsum.cuh) and adds one atomic vote per valid element
//      into the (K, V) vote field (integer valued, so exact in any order).
//      Lane 0 then reads the hood's own column of the (rows, n_hoods)
//      history ring newest row first (from `head`), applies the window predicate of the old finalize, writes
//      hood_e into the oldest slot (no other warp touches the column), and
//      the block folds "some hood not converged" and "some hood_e not
//      finite" into one flag accumulator with one atomicOr.
//   2. Last-block-done handshake: every thread fences its writes, then one
//      thread of the block draws a ticket (atomicAdd).  The block that
//      draws the last ticket runs the finalize; no cluster (at most 16
//      blocks) and no cooperative launch (every block resident at once),
//      so n_hoods is unbounded.  It reads the votes and the accumulator
//      with coherent loads (__ldcg, atomicExch), never through the
//      read-only path.
//   3. Finalize (last block): each vertex's vote argmax (strict '>', the
//      sentinel vertex V-1 set to 0) into the other label buffer (the
//      caller swaps the two), then the flag word: bit 0 = every hood
//      converged and the caller's gate (MAP iteration > WINDOW) open, bit
//      1 = a hood energy not finite.  A launch that stops its MAP loop
//      (the flag word set, or the caller's `cap` bit at the loop's last
//      iteration) then takes the M-step sums of the new labels; the others
//      leave `stats` as it was (the driver reads it only after the loop).
//      It resets the ticket and the accumulator for the next launch.  The vote field is double
//      buffered too: every block zeroes the buffer of the previous launch
//      (nobody reads it in this one), so the next launch needs no memset
//      and this launch's votes stay readable until then.
//   The flag goes to a word of mapped pinned host memory as well, so the
//   host waits once on the stream and reads it with no copy.
//
// What changed: the tick was two launches and a memset (a hood pass, then
// a one-block finalize that also scanned the whole history ring), and the
// caller gathered the labels, rolled the ring and tested finiteness with
// separate tensor operations around it.
//
// Float order: hood_e, at every K, is the plain version's element-order
// sum: each warp adds its hood's valid products one element at a time, in
// the order they are stored (plainsum.cuh), as index_add_ does on the CPU
// and jax.ops.segment_sum does there.  The convergence window is a
// threshold on hood_e, so any other order can part an iteration count
// from the plain path's; with hood_e in element order the tick and the
// sharded route's step (map_step.cu, the same loop) give one trajectory.
// The M-step sums take the plain version's order at every K, vertex by
// vertex (plainsum::label_sums: one thread per label over tiles staged in
// shared memory), so a padded vertex (weight 0) adds +0 and changes no bit.
//
// Lane axis (the batched entry, the counterpart of the JAX kernel under
// vmap): grid (blocks per lane, B), blockIdx.y the lane.  Lane b reads
// and writes row b of stacked buffers (TickBatchPlan) with its own ticket,
// flag word, parity word and active word.  A lane whose active word is 0
// returns at once and writes nothing, as the reference's vmapped
// while_loop freezes a lane that has stopped; the launch that stops a
// lane's MAP loop sets its active word to 0, and the host sets the words
// of the lanes that run at each EM iteration.  Each lane computes what its
// own single-lane launch would, bit for bit.
//
// Pool entry (continuous batching, the counterpart of the reference's
// ticked pool): the lanes of one launch sit at different MAP iterations,
// so each lane also has its own MAP counter map_i[b], the iterations its
// current MAP loop has taken.  Lane b runs iteration i = map_i[b] + 1 and
// derives its controls from it, as the host would for one problem: the
// ring head (0 at i = 1, then one row back per iteration), the gate
// (i > WINDOW = hist_rows - 1) and the cap (i == max_map_iters).  The
// lane's last block writes map_i[b] = i beside its parity flip; the host
// zeroes the word when the lane starts an EM iteration.  The lockstep
// entry passes no counters (map_i null) and shares one head, gate and cap.
//
// K: K = 2..8 are template instantiations with the per-label values in
// registers.  Any K >= 9 takes the runtime-K variant with the same energy
// op order: the hood pass keeps the per-label terms in the block's shared
// memory and the counts in a shared row per warp (11 K floats a block).
// So at every K, at f32, the tick equals the plain version bit for bit
// wherever that version sums in element order (on the CPU).  The shared memory
// bounds K at kMaxLabels = 5,282 (227 KB a block on an H100).
//
// Arithmetic: every energy op is an explicitly rounded intrinsic
// (__fmul_rn, __fdiv_rn, ...) so nvcc cannot contract it into an FMA and
// each op rounds as PyTorch's separate ops do.  With bf16 every operand and
// every intermediate is rounded to bfloat16 (as a bfloat16 tensor op
// would), while counts, hood sums, votes and M-step sums stay float32
// (hood_e is the float32 sum of the rounded products, as in the plain
// version).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flagword.cuh"
#include "plainsum.cuh"

// A stack of B problems padded to one bucket, filled in by the caller once
// per solve (the pointers) and read by every batched step.  Lane b's
// arrays are row b of: y, w, nall, valid, vertex (B, capacity); offsets
// (B, n_hoods+1); region_mean, region_weight (B, n_vertices); mu, sigma
// (B, n_labels); beta (B,); labels (B, 2, n_vertices) and votes (B, 2,
// n_labels, n_vertices), swapped by the lane's parity word; ring (B,
// hist_rows, n_hoods); hood_e (B, n_hoods); stats (B, 3, n_labels); sync
// (B, 2) zero; flag_dev, flag_host_dev (the device view of B mapped host
// words), parity and active (B,); map_i (B,), the pool entry's per-lane MAP
// counters, or null for the lockstep entry; max_map_iters, the pool's cap.
struct TickBatchPlan {
  const float* y;
  const float* w;
  const float* nall;
  const float* valid;
  const int* vertex;
  const int* offsets;
  const float* region_mean;
  const float* region_weight;
  const float* mu;
  const float* sigma;
  const float* beta;
  int* labels;
  float* votes;
  float* ring;
  float* hood_e;
  float* stats;
  unsigned int* sync;
  int* flag_dev;
  int* flag_host_dev;
  int* flag_host;
  int* parity;
  int* active;
  int* map_i;
  void* stream;
  int batch;
  int capacity;
  int hist_rows;
  int n_hoods;
  int n_vertices;
  int n_labels;
  int bf16;
  int device;
  int max_map_iters;
  float conv_tol;
};

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;        // threads of a block of the runtime-K variant
constexpr int kWarps = kThreads / kWarp;
constexpr int kTemplThreads = 256;   // threads of a block of the K = 2..8 instantiations
constexpr int kSmemPerBlock = 232448;  // 227 KB: the most a block may take on an H100

// Dynamic shared memory of the runtime-K variant: 3 K terms and K counts
// per warp in the hood pass; four tiles of kThreads in the finalize.
constexpr size_t hood_rt_smem_bytes(int n_labels) {
  return static_cast<size_t>(3 + kWarps) * n_labels * sizeof(float);
}
constexpr size_t kTileBytes = 4 * kThreads * sizeof(float);
constexpr size_t rt_smem_bytes(int n_labels) {
  return hood_rt_smem_bytes(n_labels) > kTileBytes ? hood_rt_smem_bytes(n_labels) : kTileBytes;
}
constexpr int kMaxLabels = kSmemPerBlock / static_cast<int>(hood_rt_smem_bytes(1));

struct TickParams {
  const float* y;
  const float* w;
  const float* nall;
  const float* xf;         // (H,) or nullptr: gather from labels_in
  const float* valid;
  const int* vertex;
  const int* offsets;
  const float* region_mean;
  const float* region_weight;
  const float* mu;
  const float* sigma;
  const float* beta;
  const int* labels_in;    // (V,), read when xf is nullptr
  float* ring;             // (hist_rows, n_hoods); row (head + r) % rows is the r-th newest
  int* labels_out;         // (V,)
  float* hood_e;           // (n_hoods,)
  float* votes;            // (K, V), zero on entry
  float* votes_clear;      // (K, V) zeroed by this launch, or nullptr
  float* stats;            // (3, K): sum_w, sum_wy, sum_wyy
  unsigned int* sync;      // [0] ticket, [1] flag accumulator; 0 between launches
  int* flag_dev;           // (1,)
  int* flag_host;          // device view of a mapped host word, or nullptr
  int* lane_parity;        // batched entry: the lane's parity word, flipped here; else nullptr
  int* lane_active;        // batched entry: the lane's active word, 0 once it stops; else nullptr
  int hist_rows;
  int head;
  int ring_write;
  int gate;
  int stop_cap;            // 1: this launch stops the MAP loop at its cap (takes the M-step)
  int n_hoods;
  int n_vertices;
  int n_labels;
  float conv_tol;
  int* lane_map_i;         // pool entry: the lane's MAP counter, set to map_i here; else nullptr
  int map_i;               // pool entry: the MAP iteration this launch runs for the lane
};

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

// The element's current label as a float, 0 on padding lanes.
__device__ __forceinline__ float element_label(const TickParams& p, int e, float v32) {
  if (p.xf != nullptr) return __ldg(p.xf + e);
  const int vtx = __ldg(p.vertex + e);
  const int x = (vtx >= 0 && vtx < p.n_vertices) ? __ldg(p.labels_in + vtx) : 0;
  return __fmul_rn(static_cast<float>(x), v32);
}

// Lane 0 of hood `hood`'s warp: store hood_e, test the window predicate on
// [he, ring row 0, ..., ring row rows-2] (newest first) and write he into
// the oldest row.  Returns the hood's accumulator bits.
__device__ __forceinline__ unsigned close_hood(const TickParams& p, int hood, float he) {
  p.hood_e[hood] = he;
  return flagword::close_window(p.ring, p.hist_rows, p.head, p.n_hoods, hood, he, p.conv_tol,
                                p.ring_write != 0);
}

// Every block: zero the previous launch's vote buffer, then join the
// launch's ticket (flagword.cuh).  True in the block that draws the last
// ticket (uniform in the block).
__device__ __forceinline__ bool last_block_done(const TickParams& p, unsigned bits) {
  if (p.votes_clear != nullptr) {
    const long long n = static_cast<long long>(p.n_labels) * p.n_vertices;
    for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
      p.votes_clear[i] = 0.0f;
    }
  }
  return flagword::last_block_done(p.sync, bits);
}

// Last block, one thread, after the labels: take the launch's flag word
// (flagword.cuh; it resets the accumulator) and broadcast it to the
// block.  Every thread of the last block calls it.
__device__ __forceinline__ int take_flag(const TickParams& p) {
  __shared__ int word;
  if (threadIdx.x == 0) word = flagword::take_word(p.sync, p.gate);
  __syncthreads();
  return word;
}

// True when the launch stops its MAP loop: the flag word is set (the
// window closed, or a hood energy is not finite) or the loop is at its cap.
// Only such a launch takes the M-step sums.
__device__ __forceinline__ bool stops(const TickParams& p, int word) {
  return word != 0 || p.stop_cap != 0;
}

// Last block, one thread, after the sums: publish the flag word, reset the
// ticket, and on the batched entry flip the lane's parity and retire a
// lane that stopped; on the pool entry also count the lane's iteration.
__device__ __forceinline__ void finish(const TickParams& p, int word) {
  flagword::publish_word(p.sync, word, p.flag_dev, p.flag_host);
  if (p.lane_parity != nullptr) *p.lane_parity ^= 1;
  if (p.lane_active != nullptr && stops(p, word)) *p.lane_active = 0;
  if (p.lane_map_i != nullptr) *p.lane_map_i = p.map_i;
}

inline unsigned int grid_blocks(int n_hoods, int warps) {
  const long long blocks = (static_cast<long long>(n_hoods) + warps - 1) / warps;
  return static_cast<unsigned int>(blocks > 0 ? blocks : 1);
}

// K = 2..8: the per-label terms in registers.
template <int K, bool BF16>
__device__ __forceinline__ void tick_body(const TickParams& p) {
  constexpr int kBlockWarps = kTemplThreads / kWarp;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int hood = blockIdx.x * kBlockWarps + warp;
  unsigned bits = 0u;
  if (hood < p.n_hoods) {  // uniform in the warp
    const int begin = __ldg(p.offsets + hood);
    const int end = __ldg(p.offsets + hood + 1);

    // 1. How many elements of this hood carry each label.
    float cnt[K];
#pragma unroll
    for (int l = 0; l < K; ++l) cnt[l] = 0.0f;
    for (int e = begin + lane; e < end; e += kWarp) {
      const float v = __ldg(p.valid + e);
      const int xi = min(max(static_cast<int>(element_label(p, e, v)), 0), K - 1);
#pragma unroll
      for (int l = 0; l < K; ++l) cnt[l] += (xi == l) ? v : 0.0f;
    }
#pragma unroll
    for (int l = 0; l < K; ++l) cnt[l] = rnd<BF16>(warp_sum(cnt[l]));

    // Per-label terms shared by every element of the hood.
    float mu_l[K], two_ss[K], log_s[K];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      const float s = rnd<BF16>(__ldg(p.sigma + l));
      mu_l[l] = rnd<BF16>(__ldg(p.mu + l));
      two_ss[l] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(2.0f, s)), s));
      log_s[l] = rnd<BF16>(logf(s));
    }
    const float beta = rnd<BF16>(__ldg(p.beta));

    // 2. Energies, min/argmin, the votes, and the hood's energy sum in
    // element order (plainsum.cuh): a warp-uniform loop over chunks of 32
    // elements, each chunk's products added one lane at a time.
    float acc = 0.0f;
    for (int base = begin; base < end; base += kWarp) {
      const int e = base + lane;
      float prod = 0.0f;
      bool take = false;
      if (e < end) {
        const float v32 = __ldg(p.valid + e);
        const float yv = rnd<BF16>(__ldg(p.y + e));
        const float wv = rnd<BF16>(__ldg(p.w + e));
        const float na = rnd<BF16>(__ldg(p.nall + e));
        const float xv = rnd<BF16>(element_label(p, e, v32));
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
        take = v32 > 0.0f;
        prod = __fmul_rn(best, v32);
        const int vtx = __ldg(p.vertex + e);
        if (take && vtx >= 0 && vtx < p.n_vertices) {
          atomicAdd(p.votes + arg * p.n_vertices + vtx, v32);
        }
      }
      acc = plainsum::add_chunk(acc, prod, take);
    }
    if (lane == 0) bits = close_hood(p, hood, acc);
  }
  if (!last_block_done(p, bits)) return;

  // 3. Finalize: plurality labels, the flag word, then, in a launch that
  // stops the MAP loop, the M-step sums of the new labels in vertex order
  // (plainsum.cuh), over tiles staged in shared memory.
  __shared__ float tiles[4 * kTemplThreads];
  const int n_v = p.n_vertices;
  for (int v = threadIdx.x; v < n_v; v += kTemplThreads) {
    float best = __ldcg(p.votes + v);
    int lab = 0;
#pragma unroll
    for (int l = 1; l < K; ++l) {
      const float c = __ldcg(p.votes + l * n_v + v);
      if (c > best) {
        best = c;
        lab = l;
      }
    }
    if (v == n_v - 1) lab = 0;
    p.labels_out[v] = lab;
  }
  const int word = take_flag(p);  // its barrier also orders the labels before the sums
  if (stops(p, word)) {
    plainsum::label_sums<kTemplThreads>(p.labels_out, p.region_weight, p.region_mean, n_v, K,
                                        tiles, p.stats);
  }
  if (threadIdx.x == 0) finish(p, word);
}

// Runtime K (K >= 9): the per-label terms and the warp's counts in dynamic
// shared memory, every float sum in element order.
template <bool BF16>
__device__ __forceinline__ void tick_body_rt(const TickParams& p) {
  const int K = p.n_labels;
  extern __shared__ float smem[];  // [mu | 2 sigma^2 | log sigma | counts per warp]
  float* mu_l = smem;
  float* two_ss = smem + K;
  float* log_s = smem + 2 * K;
  float* cnt = smem + 3 * K + (threadIdx.x / kWarp) * K;
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const float s = rnd<BF16>(__ldg(p.sigma + l));
    mu_l[l] = rnd<BF16>(__ldg(p.mu + l));
    two_ss[l] = rnd<BF16>(__fmul_rn(rnd<BF16>(__fmul_rn(2.0f, s)), s));
    log_s[l] = rnd<BF16>(logf(s));
  }
  __syncthreads();

  const int hood = blockIdx.x * kWarps + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  unsigned bits = 0u;
  if (hood < p.n_hoods) {  // uniform in the warp
    const int begin = __ldg(p.offsets + hood);
    const int end = __ldg(p.offsets + hood + 1);

    // 1. Label counts in the warp's shared row, one pass over the elements:
    // valid is 0 or 1, so the sums are small integers, exact in any order.
    for (int l = lane; l < K; l += kWarp) cnt[l] = 0.0f;
    __syncwarp();
    for (int e = begin + lane; e < end; e += kWarp) {
      const float v = __ldg(p.valid + e);
      const int xi = min(max(static_cast<int>(element_label(p, e, v)), 0), K - 1);
      if (v != 0.0f) atomicAdd(cnt + xi, v);
    }
    __syncwarp();
    for (int l = lane; l < K; l += kWarp) cnt[l] = rnd<BF16>(cnt[l]);
    __syncwarp();
    const float beta = rnd<BF16>(__ldg(p.beta));

    // 2. Energies, min/argmin, the votes, and the hood's energy sum in
    // element order (the plain version's order): a warp-uniform loop over
    // chunks of 32 elements, each chunk's products added one lane at a time.
    float acc = 0.0f;
    for (int base = begin; base < end; base += kWarp) {
      const int e = base + lane;
      float prod = 0.0f;
      bool take = false;
      if (e < end) {
        const float v32 = __ldg(p.valid + e);
        const float yv = rnd<BF16>(__ldg(p.y + e));
        const float wv = rnd<BF16>(__ldg(p.w + e));
        const float na = rnd<BF16>(__ldg(p.nall + e));
        const float xv = rnd<BF16>(element_label(p, e, v32));
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
        prod = __fmul_rn(best, v32);
        const int vtx = __ldg(p.vertex + e);
        if (take && vtx >= 0 && vtx < p.n_vertices) {
          atomicAdd(p.votes + arg * p.n_vertices + vtx, v32);
        }
      }
      acc = plainsum::add_chunk(acc, prod, take);
    }
    if (lane == 0) bits = close_hood(p, hood, acc);
  }
  if (!last_block_done(p, bits)) return;

  // 3. Finalize: the labels first, the flag word, then, in a launch that
  // stops the MAP loop, the M-step sums of each label in vertex order
  // (plainsum.cuh), over tiles of the new labels and the region terms
  // staged in the (now free) shared memory.
  const int n_v = p.n_vertices;
  for (int v = threadIdx.x; v < n_v; v += blockDim.x) {
    float best = __ldcg(p.votes + v);
    int lab = 0;
    for (int l = 1; l < K; ++l) {
      const float c = __ldcg(p.votes + static_cast<long long>(l) * n_v + v);
      if (c > best) {
        best = c;
        lab = l;
      }
    }
    if (v == n_v - 1) lab = 0;
    p.labels_out[v] = lab;
  }
  const int word = take_flag(p);
  if (stops(p, word)) {
    plainsum::label_sums<kThreads>(p.labels_out, p.region_weight, p.region_mean, n_v, K, smem,
                                   p.stats);
  }
  if (threadIdx.x == 0) finish(p, word);
}

// Lane b's TickParams, the pointers offset to row b.  False when the lane
// is inactive: its blocks return at once and write nothing.  On the pool
// entry (t.map_i set) the lane's head, gate and cap come from its own MAP
// iteration i = map_i[b] + 1, in place of the launch's shared ones.  Every
// block reads map_i[b] before it draws its ticket, and the last block
// writes it after every ticket is drawn, as with the parity word.
__device__ __forceinline__ bool lane_params(const TickBatchPlan& t, int b, int head, int gate,
                                            int cap, TickParams* p) {
  if (t.active[b] == 0) return false;
  int i = 0;
  if (t.map_i != nullptr) {
    i = t.map_i[b] + 1;
    head = (t.hist_rows - (i - 1) % t.hist_rows) % t.hist_rows;
    gate = i > t.hist_rows - 1;
    cap = i == t.max_map_iters;
  }
  const long long e = static_cast<long long>(b) * t.capacity;
  const long long nv = t.n_vertices, nh = t.n_hoods, k = t.n_labels;
  const int q = t.parity[b] & 1;
  int* labels = t.labels + b * 2 * nv;
  float* votes = t.votes + b * 2 * k * nv;
  *p = TickParams{t.y + e, t.w + e, t.nall + e, nullptr, t.valid + e, t.vertex + e,
                  t.offsets + b * (nh + 1), t.region_mean + b * nv, t.region_weight + b * nv,
                  t.mu + b * k, t.sigma + b * k, t.beta + b, labels + q * nv,
                  t.ring + b * t.hist_rows * nh, labels + (1 - q) * nv, t.hood_e + b * nh,
                  votes + q * k * nv, votes + (1 - q) * k * nv, t.stats + b * 3 * k,
                  t.sync + 2 * b, t.flag_dev + b, t.flag_host_dev + b, t.parity + b,
                  t.active + b, t.hist_rows, head, /*ring_write=*/1, gate, cap, t.n_hoods,
                  t.n_vertices, t.n_labels, t.conv_tol,
                  t.map_i != nullptr ? t.map_i + b : nullptr, i};
  return true;
}

template <int K, bool BF16>
__global__ void __launch_bounds__(kTemplThreads) tick_kernel(const TickParams p) {
  tick_body<K, BF16>(p);
}

// The batched entry: grid (blocks per lane, B), lane b = blockIdx.y.
template <int K, bool BF16>
__global__ void __launch_bounds__(kTemplThreads)
    tick_kernel_batched(const TickBatchPlan t, int head, int gate, int cap) {
  TickParams p;
  if (lane_params(t, blockIdx.y, head, gate, cap, &p)) tick_body<K, BF16>(p);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads) tick_kernel_rt(const TickParams p) {
  tick_body_rt<BF16>(p);
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    tick_kernel_rt_batched(const TickBatchPlan t, int head, int gate, int cap) {
  TickParams p;
  if (lane_params(t, blockIdx.y, head, gate, cap, &p)) tick_body_rt<BF16>(p);
}

// One launch of the tick.  `batch` is nullptr for one problem (`p`), else
// the stack whose lanes the launch runs (`p` then carries only n_hoods and
// n_labels).
struct Launch {
  const TickParams* p;
  const TickBatchPlan* batch;
  int head, gate, cap;
};

template <int K, bool BF16>
int launch(const Launch& l, cudaStream_t stream) {
  const unsigned int blocks = grid_blocks(l.p->n_hoods, kTemplThreads / kWarp);
  if (l.batch == nullptr) {
    tick_kernel<K, BF16><<<blocks, kTemplThreads, 0, stream>>>(*l.p);
  } else {
    tick_kernel_batched<K, BF16><<<dim3(blocks, l.batch->batch), kTemplThreads, 0, stream>>>(
        *l.batch, l.head, l.gate, l.cap);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool BF16>
int launch_rt(const Launch& l, cudaStream_t stream) {
  if (l.p->n_labels > kMaxLabels) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = rt_smem_bytes(l.p->n_labels);
  const unsigned int blocks = grid_blocks(l.p->n_hoods, kWarps);
  cudaError_t err;
  if (l.batch == nullptr) {
    if ((err = allow_smem(tick_kernel_rt<BF16>, smem)) != cudaSuccess) return static_cast<int>(err);
    tick_kernel_rt<BF16><<<blocks, kThreads, smem, stream>>>(*l.p);
  } else {
    if ((err = allow_smem(tick_kernel_rt_batched<BF16>, smem)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    tick_kernel_rt_batched<BF16><<<dim3(blocks, l.batch->batch), kThreads, smem, stream>>>(
        *l.batch, l.head, l.gate, l.cap);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Launch& l, int bf16, cudaStream_t s) {
#define REPRO_TICK_CASE(K) \
  case K:                  \
    return bf16 ? launch<K, true>(l, s) : launch<K, false>(l, s);
  switch (l.p->n_labels) {
    REPRO_TICK_CASE(2)
    REPRO_TICK_CASE(3)
    REPRO_TICK_CASE(4)
    REPRO_TICK_CASE(5)
    REPRO_TICK_CASE(6)
    REPRO_TICK_CASE(7)
    REPRO_TICK_CASE(8)
    default:
      if (l.p->n_labels < 9) return static_cast<int>(cudaErrorInvalidValue);
      return bf16 ? launch_rt<true>(l, s) : launch_rt<false>(l, s);
  }
#undef REPRO_TICK_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(const TickParams& p, int bf16, cudaStream_t s) {
  return dispatch(Launch{&p, nullptr, 0, 0, 0}, bf16, s);
}

// Run `fn` with `device` current, then restore the caller's device.
template <typename Fn>
int on_device(int device, Fn fn) {
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int rc = fn();
  if (current != device) cudaSetDevice(current);
  return rc;
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One tick with the JAX kernel's operands.  Inputs: y, w, nall, xf, valid
// (H,) f32; vertex (H,) i32; offsets (n_hoods+1,) i32; region_mean,
// region_weight (n_vertices,) f32; hist (hist_rows, n_hoods) f32, newest
// row first, read only; mu, sigma (n_labels,) f32; beta (1,) f32.
// Outputs: labels (n_vertices,) i32; hood_e (n_hoods,) f32; votes
// (n_labels, n_vertices) f32, zeroed by the caller; stats (3, n_labels)
// f32 = sum_w, sum_wy, sum_wyy (always taken); flag (1,) i32, bit 0 = the
// window predicate; sync (2,) u32, zeroed by the caller.  Returns
// cudaGetLastError().
int repro_fused_em_tick(const float* y, const float* w, const float* nall,
                        const float* xf, const float* valid, const int* vertex,
                        const int* offsets, const float* region_mean,
                        const float* region_weight, const float* hist,
                        int hist_rows, const float* mu, const float* sigma,
                        const float* beta, int n_hoods, int n_vertices,
                        int n_labels, int bf16, float conv_tol, int* labels,
                        float* hood_e, float* votes, float* stats, int* flag,
                        unsigned int* sync, void* stream) {
  const TickParams p{y, w, nall, xf, valid, vertex, offsets, region_mean, region_weight,
                     mu, sigma, beta, nullptr, const_cast<float*>(hist), labels, hood_e,
                     votes, nullptr, stats, sync, flag, nullptr, nullptr, nullptr, hist_rows,
                     /*head=*/0, /*ring_write=*/0, /*gate=*/1, /*stop_cap=*/1, n_hoods,
                     n_vertices, n_labels, conv_tol};
  return dispatch(p, bf16, static_cast<cudaStream_t>(stream));
}

// A MAP-iteration workspace, filled in by the caller once per solve (the
// pointers) and read by every step.  Buffers: labels[2] (n_vertices,) i32
// and votes[2] (n_labels, n_vertices) f32, swapped by `parity`; the ring
// (hist_rows, n_hoods) f32; hood_e, stats, flag_dev as above; sync (2,)
// u32 zero; flag_host and flag_host_dev the two views of a word from
// repro_em_tick_host_word.
struct TickPlan {
  const float* y;
  const float* w;
  const float* nall;
  const float* valid;
  const int* vertex;
  const int* offsets;
  const float* region_mean;
  const float* region_weight;
  const float* mu;
  const float* sigma;
  const float* beta;
  int* labels[2];
  float* votes[2];
  float* ring;
  float* hood_e;
  float* stats;
  unsigned int* sync;
  int* flag_dev;
  int* flag_host_dev;
  int* flag_host;
  void* stream;
  int hist_rows;
  int n_hoods;
  int n_vertices;
  int n_labels;
  int bf16;
  int device;
  float conv_tol;
};

// One MAP iteration: the labels in labels[parity] become labels[1-parity],
// the votes land in votes[parity] and votes[1-parity] is zeroed; the ring's
// newest row is `head` and hood_e goes to row (head + rows - 1) % rows.
// The flag's bit 0 needs `gate`; `cap` says the MAP loop stops after this
// launch whatever its flag, and only a launch that stops the loop (the
// flag word set, or `cap`) writes the M-step sums.  One launch on the
// plan's stream.
int repro_em_tick_step(const TickPlan* t, int parity, int head, int gate, int cap) {
  return on_device(t->device, [&] {
    const int q = parity & 1;
    const TickParams p{t->y, t->w, t->nall, nullptr, t->valid, t->vertex, t->offsets,
                       t->region_mean, t->region_weight, t->mu, t->sigma, t->beta,
                       t->labels[q], t->ring, t->labels[1 - q], t->hood_e, t->votes[q],
                       t->votes[1 - q], t->stats, t->sync, t->flag_dev, t->flag_host_dev,
                       nullptr, nullptr, t->hist_rows, head, /*ring_write=*/1, gate, cap,
                       t->n_hoods, t->n_vertices, t->n_labels, t->conv_tol};
    return dispatch(p, t->bf16, static_cast<cudaStream_t>(t->stream));
  });
}

// One MAP iteration of every active lane of a stack, in one launch: lane b
// runs repro_em_tick_step on its own buffers with its own parity word
// (flipped by the launch), the shared `head`, `gate` and `cap` (or, when
// the plan carries map_i, its own: repro_em_tick_step_pool); a lane that
// stops (its flag word set, or `cap`) takes the M-step sums and sets its
// active word to 0.  An inactive lane writes nothing.
int repro_em_tick_step_batched(const TickBatchPlan* t, int head, int gate, int cap) {
  return on_device(t->device, [&] {
    TickParams shape{};
    shape.n_hoods = t->n_hoods;
    shape.n_labels = t->n_labels;
    return dispatch(Launch{&shape, t, head, gate, cap}, t->bf16,
                    static_cast<cudaStream_t>(t->stream));
  });
}

// One MAP iteration of every active lane of a pool, in one launch: lane b
// runs its own iteration map_i[b] + 1 (its ring head, gate and cap derived
// from it, lane_params) on its own buffers, sets map_i[b] to it, and, if it
// stops (its flag word set, or its cap), takes the M-step sums and sets its
// active word to 0.  An inactive lane writes nothing.  `t->map_i` must be
// set.
int repro_em_tick_step_pool(const TickBatchPlan* t) {
  if (t->map_i == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return repro_em_tick_step_batched(t, 0, 0, 0);
}

// Wait for the plan's stream and read the flag word the last step wrote.
int repro_em_tick_wait(const TickPlan* t, int* flag) {
  const cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(t->stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  *flag = *reinterpret_cast<volatile int*>(t->flag_host);
  return 0;
}

// Wait for the stack's stream and copy its B flag words (those of lanes
// that ran in the last launch are that launch's).
int repro_em_tick_wait_batched(const TickBatchPlan* t, int* flags) {
  const cudaError_t err = cudaStreamSynchronize(static_cast<cudaStream_t>(t->stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const volatile int* words = t->flag_host;
  for (int b = 0; b < t->batch; ++b) flags[b] = words[b];
  return 0;
}

// `n` words of pinned host memory mapped into the device's address space,
// zeroed: their host and device addresses.
int repro_em_tick_host_word(void** host, void** device, int n) {
  cudaError_t err = cudaHostAlloc(host, sizeof(int) * n, cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n; ++i) reinterpret_cast<volatile int*>(*host)[i] = 0;
  err = cudaHostGetDevicePointer(device, *host, 0);
  if (err != cudaSuccess) {
    cudaFreeHost(*host);
    *host = nullptr;
  }
  return static_cast<int>(err);
}

int repro_em_tick_free_host_word(void* host) {
  return static_cast<int>(cudaFreeHost(host));
}

}  // extern "C"
