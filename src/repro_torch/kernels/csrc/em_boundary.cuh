// The EM boundary of the static-pallas route on the device, and the start
// of a solve: the two kernels that, with the tick (em_tick.cu), make a
// bucket's whole solve one CUDA graph (the compiled EM program).
//
// Replaces: the XLA-compiled tail of the reference's EM driver,
// src/repro/core/pmrf/em.py :: em_body (params_from_stats, the divergence
// test, _degenerate_components, the total-energy ring, the window test and
// _boundary_status), which the reference's Segmenter.compile lowers with
// the two while_loops into one device program.  There is no Pallas kernel
// for it.
//
// What bounds it on an H100: launch latency.  A boundary reads each lane's
// M-step sums (3 K floats), its hood energies (n_hoods floats) and a few
// words, and writes 2 K parameters, the ring and a few words; at a 512x512
// slice that is about 7 KB a lane, a couple of nanoseconds of HBM time.
// Inside a graph a launch costs a few microseconds of the device's own
// time and no host time at all.
//
// Design: one block per lane (grid B; the single form is B = 1), every
// lane's words in one (kLaneWords, B) int32 block and the program's in a
// (kCtlWords,) block, both shared with the tick's lane entry (its active,
// MAP-counter, flag and parity words are rows of the lane block).
//   * program_init (once per solve, first node of the graph): each lane's
//     initial labels into the label buffer its parity word names, that
//     vote buffer zeroed, hood energies, history ring and total-energy ring
//     zeroed, mu/sigma and the EM-level parameters from mu0/sigma0 (the
//     tick's sigma clamped at sigma_min), the lane words (every lane
//     running, active if the MAP loop runs at all) and the program words;
//     it opens the outer loop when max_em_iters > 0.
//   * em_boundary_kernel (once per EM iteration, after the MAP loop): for
//     every lane that ran the iteration, what the reference's em_body
//     computes, op for op as the port's host boundary did: the M-step's
//     closed form (E[y^2] - mu^2 in float64, rounded once; the cluster-death
//     reseed), the divergence test (with the MAP loop's FLAG_DIVERGED), the
//     degeneracy test, the total energy (the float64 sum of the hood
//     energies, rounded once) into the lane's ring, the window test past
//     WINDOW, the status, the counters; a lane that goes on gets its next
//     clamped sigma, a zeroed history ring and its MAP words re-armed.  The
//     last block (ticket, as flagword.cuh) adds the lockstep MAP iterations
//     to `steps`, counts the lanes that go on (the next MAP loop's live
//     count), and sets the loops' conditions: the outer one while some lane
//     goes on, the inner one re-armed.
//   Counts and status also go to mapped pinned host words, so the host
//   reads a solve's result with one wait and no copy; beside them the
//   launches each kernel counted of itself in the solve (the tick's first
//   block and the boundary's adding one to a program word), the record of
//   what ran inside the graph.
//
// Arithmetic: every float op is an explicitly rounded intrinsic, so nvcc
// cannot contract it, and each op rounds as the PyTorch op it mirrors
// (clamp_min and maximum keep a NaN, as torch's do).  The two float64 sums
// (the total energy, and the label total above kSequentialLabels labels)
// are in a fixed order of this kernel's, rounded once to float32.

#pragma once

#include <cuda_runtime.h>

namespace em_program {

// Rows of the lane block, (kLaneWords, B) int32.
enum LaneWord : int {
  kActive = 0,    // the lane runs the next tick launch (the tick's active word)
  kMapI = 1,      // MAP iterations of the lane's current MAP loop (the tick's counter)
  kFlag = 2,      // the flag word of the lane's last tick launch
  kRunning = 3,   // the lane's EM has not finished
  kEmIters = 4,   // EM iterations done
  kMapIters = 5,  // MAP iterations done
  kStatus = 6,    // the health code (em.STATUS_*)
  kParity = 7,    // the tick's parity word: which label buffer holds the labels
  kLaneWords = 8,
};

// Words of the program, (kCtlWords,) int32.
enum CtlWord : int {
  kEmI = 0,      // EM iterations of the lockstep
  kSteps = 1,    // lockstep MAP iterations: tick launches
  kMapLive = 2,  // lanes still in the current MAP loop (the tick's last stopper ends it)
  kEmCond = 3,   // the outer loop's condition (mirrors its handle)
  kMapCond = 4,  // the inner loop's condition at the next MAP loop's start
  kTicket = 5,   // the boundary's last-block-done ticket
  kStepMax = 6,  // the boundary's scratch: the longest lane's MAP iterations
  kGoOn = 7,     // the boundary's scratch: lanes that go on
  kTickLaunches = 8,      // tick launches of this solve, counted by the tick itself
  kBoundaryLaunches = 9,  // boundary launches of this solve, counted by the boundary
  kSegAdd = 10,      // segment_reduce launches inside the graph (a mode's captured step and
  kSegOrdered = 11,  // M-step), counted by the kernels themselves: the order-free add, the
  kSegMin = 12,      // element-order add and min
  kCtlWords = 13,
};

// The program's words after the lanes' in the mapped result: the lockstep
// MAP iterations, the tick's and the boundary's launches, and the
// segment_reduce launches by variant (kSegAdd, kSegOrdered, kSegMin).
constexpr int kResultWords = 6;

enum Status : int { kOk = 0, kConvergedS = 1, kMaxIters = 2, kDiverged = 3, kDegenerate = 4 };

constexpr int kThreads = 256;
constexpr int kSequentialLabels = 8;  // energy.SEQUENTIAL_LABELS
constexpr float kSafeW = 1.0e-6f;     // energy.params_from_stats's clamp of the mass
constexpr float kDeadFrac = 1.0e-3f;  // a label with less than this share of the mass is dead
constexpr float kInertMu = 1.0e8f;    // energy.INERT_MU: padded labels are never real
constexpr int kFlagDiverged = 2;      // ref.FLAG_DIVERGED

// The operands of one program: a workspace's buffers, fixed for its life.
struct ProgramPlan {
  const float* stats;         // (B, 3, K): the M-step sums of each lane's stopping launch
  float* hood_e;              // (B, n_hoods)
  int* lane;                  // (kLaneWords, B)
  int* ctl;                   // (kCtlWords,)
  float* em_mu;               // (B, K): the EM-level parameters, the solve's result
  float* em_sigma;            // (B, K)
  float* mu;                  // (B, K): the tick's parameters
  float* sigma;               // (B, K): clamped at sigma_min
  float* ring;                // (B, window + 1, n_hoods): the tick's history ring
  float* total_hist;          // (B, window + 1): the total-energy ring, newest first
  const float* sigma_min;     // (B,)
  const float* reseed_mu;     // (B, K)
  const float* reseed_sigma;  // (B,)
  const float* mu0;           // (B, K): the solve's start
  const float* sigma0;        // (B, K)
  const int* labels0;         // (B, n_vertices)
  int* labels;                // (B, 2, n_vertices): the tick's label buffers
  float* votes;               // (B, 2, K, n_vertices): the tick's vote buffers
  int* result_host;           // device view of 3 B + kResultWords mapped host words, or null
  unsigned long long em_cond;   // cudaGraphConditionalHandle of the outer loop
  unsigned long long map_cond;  // of the inner loop
  int batch;
  int n_hoods;
  int n_vertices;
  int n_labels;
  int window;
  int max_em_iters;
  int max_map_iters;
  int conditional;  // bit 0: em_cond is live (in a graph), bit 1: map_cond is
  int stats_at_zero;  // 1: a lane's M-step sums are read even when its MAP loop ran no
                      // iteration (the modes' M-step reads the labels it starts from)
  float conv_tol;
};

// torch.clamp_min / torch.maximum: a NaN operand gives a NaN.
__device__ __forceinline__ float clamp_lo(float v, float lo) { return v < lo ? lo : v; }
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

// Word `w` of lane `b`'s block.
__device__ __forceinline__ int lane_word(const ProgramPlan& p, int w, int b) {
  return p.lane[w * p.batch + b];
}

__device__ __forceinline__ void publish(const ProgramPlan& p, int b) {
  if (p.result_host == nullptr) return;
  const int B = p.batch;
  volatile int* out = p.result_host + 3 * b;
  out[0] = p.lane[kEmIters * B + b];
  out[1] = p.lane[kMapIters * B + b];
  out[2] = p.lane[kStatus * B + b];
}

// Once per solve: every lane's start (see the file's comment).
__global__ void __launch_bounds__(kThreads) program_init(const ProgramPlan p) {
  const int b = blockIdx.x;
  const int B = p.batch, K = p.n_labels, nv = p.n_vertices, nh = p.n_hoods;
  const int rows = p.window + 1;
  if (p.labels != nullptr) {  // the tick's parity-swapped buffers (the modes' start copies theirs)
    const int q = lane_word(p, kParity, b) & 1;
    int* labels = p.labels + (2LL * b + q) * nv;
    float* votes = p.votes + (2LL * b + q) * K * static_cast<long long>(nv);
    for (int v = threadIdx.x; v < nv; v += blockDim.x) labels[v] = p.labels0[static_cast<long long>(b) * nv + v];
    for (long long j = threadIdx.x; j < static_cast<long long>(K) * nv; j += blockDim.x) votes[j] = 0.0f;
  }
  for (int h = threadIdx.x; h < nh; h += blockDim.x) p.hood_e[static_cast<long long>(b) * nh + h] = 0.0f;
  for (long long j = threadIdx.x; j < static_cast<long long>(rows) * nh; j += blockDim.x) {
    p.ring[static_cast<long long>(b) * rows * nh + j] = 0.0f;
  }
  for (int j = threadIdx.x; j < rows; j += blockDim.x) p.total_hist[b * rows + j] = 0.0f;
  const float smin = p.sigma_min[b];
  for (int l = threadIdx.x; l < K; l += blockDim.x) {
    const long long at = static_cast<long long>(b) * K + l;
    p.em_mu[at] = p.mu[at] = p.mu0[at];
    p.em_sigma[at] = p.sigma0[at];
    p.sigma[at] = nan_max(p.sigma0[at], smin);
  }
  if (threadIdx.x == 0) {
    p.lane[kActive * B + b] = (p.max_em_iters > 0 && p.max_map_iters > 0) ? 1 : 0;
    p.lane[kMapI * B + b] = 0;
    p.lane[kFlag * B + b] = 0;
    p.lane[kRunning * B + b] = 1;
    p.lane[kEmIters * B + b] = 0;
    p.lane[kMapIters * B + b] = 0;
    p.lane[kStatus * B + b] = kOk;
    publish(p, b);
    if (b == 0) {
      p.ctl[kEmI] = 0;
      p.ctl[kSteps] = 0;
      p.ctl[kMapLive] = p.max_map_iters > 0 ? B : 0;
      p.ctl[kEmCond] = p.max_em_iters > 0 ? 1 : 0;
      p.ctl[kMapCond] = p.max_map_iters > 0 ? 1 : 0;
      p.ctl[kTicket] = p.ctl[kStepMax] = p.ctl[kGoOn] = 0;
      p.ctl[kTickLaunches] = p.ctl[kBoundaryLaunches] = 0;
      p.ctl[kSegAdd] = p.ctl[kSegOrdered] = p.ctl[kSegMin] = 0;
      if (p.result_host != nullptr) {
        for (int j = 0; j < kResultWords; ++j) p.result_host[3 * B + j] = 0;
      }
      if (p.conditional & 1) cudaGraphSetConditional(p.em_cond, p.max_em_iters > 0 ? 1u : 0u);
    }
  }
}

// Once per EM iteration, after the MAP loop (see the file's comment).
__global__ void __launch_bounds__(kThreads) em_boundary_kernel(const ProgramPlan p) {
  const int b = blockIdx.x;
  const int B = p.batch, K = p.n_labels, nh = p.n_hoods, rows = p.window + 1;
  __shared__ double partial[kThreads / 32];  // the total energy's per-warp sums
  __shared__ float label_total;
  __shared__ int go_on;
  __shared__ unsigned int is_last;
  if (b == 0 && threadIdx.x == 0) atomicAdd(p.ctl + kBoundaryLaunches, 1);
  const bool run = lane_word(p, kRunning, b) != 0;  // uniform in the block
  const int i = lane_word(p, kMapI, b);             // the lane's MAP iterations (0: no MAP loop)
  if (run) {
    // The lane's own EM iteration: in a stack every running lane's is the
    // program's (kEmI), in a served pool each lane's own.
    const int em_i = lane_word(p, kEmIters, b) + 1;
    const float* st = p.stats + 3LL * b * K;
    const bool sums = i > 0 || p.stats_at_zero;
    auto sum_w = [&](int l) { return sums ? st[l] : 0.0f; };
    // The label total (energy.label_total): up to kSequentialLabels labels
    // added in label order, above that in float64, rounded once.
    if (threadIdx.x == 0) {
      if (K > kSequentialLabels) {
        double t = 0.0;
        for (int l = 0; l < K; ++l) t = __dadd_rn(t, static_cast<double>(sum_w(l)));
        label_total = __double2float_rn(t);
      } else {
        float t = sum_w(0);
        for (int l = 1; l < K; ++l) t = __fadd_rn(t, sum_w(l));
        label_total = t;
      }
    }
    // The total energy: the float64 sum of the hood energies, rounded once.
    double acc = 0.0;
    for (int h = threadIdx.x; h < nh; h += blockDim.x) {
      acc = __dadd_rn(acc, static_cast<double>(p.hood_e[static_cast<long long>(b) * nh + h]));
    }
    for (int o = 16; o > 0; o >>= 1) acc = __dadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = acc;
    __syncthreads();
    const float total = label_total;
    const float smin = p.sigma_min[b];
    const float dead_below = __fmul_rn(kDeadFrac, total);

    // The M-step's closed form per label, with the cluster-death reseed;
    // the new parameters go to the EM-level buffers.
    int div = 0, deg = 0;
    for (int l = threadIdx.x; l < K; l += blockDim.x) {
      const float sw = sum_w(l);
      const float swy = sums ? st[K + l] : 0.0f;
      const float swyy = sums ? st[2 * K + l] : 0.0f;
      const float safe_w = clamp_lo(sw, kSafeW);
      float m = __fdiv_rn(swy, safe_w);
      const double md = static_cast<double>(m);
      const float var = clamp_lo(
          __double2float_rn(__dsub_rn(static_cast<double>(__fdiv_rn(swyy, safe_w)), __dmul_rn(md, md))),
          0.0f);
      float s = nan_max(__fsqrt_rn(var), smin);
      const bool dead = sw < dead_below;
      const float rmu = p.reseed_mu[static_cast<long long>(b) * K + l];
      if (dead) {
        m = rmu;
        s = p.reseed_sigma[b];
      }
      div |= !isfinite(m) || !isfinite(s);
      deg |= dead && rmu < kInertMu && s <= smin;
      const long long at = static_cast<long long>(b) * K + l;
      p.em_mu[at] = m;
      p.em_sigma[at] = s;
    }
    div = __syncthreads_or(div);
    deg = __syncthreads_or(deg);

    if (threadIdx.x == 0) {
      // The total-energy ring, newest first, and the window test past WINDOW.
      float* hist = p.total_hist + static_cast<long long>(b) * rows;
      for (int j = rows - 1; j > 0; --j) hist[j] = hist[j - 1];
      double total_e = 0.0;
      for (int w = 0; w < kThreads / 32; ++w) total_e = __dadd_rn(total_e, partial[w]);
      hist[0] = __double2float_rn(total_e);
      bool conv = em_i > p.window;
      if (conv) {
        const float tol = __fmul_rn(p.conv_tol, clamp_lo(fabsf(hist[0]), 1.0f));
        for (int j = 0; j + 1 < rows; ++j) conv = conv && fabsf(__fsub_rn(hist[j], hist[j + 1])) < tol;
      }
      const bool diverged = div || (lane_word(p, kFlag, b) & kFlagDiverged);
      const bool finished = diverged || !(em_i < p.max_em_iters && !conv);
      const int status = diverged ? kDiverged
                         : (finished && deg) ? kDegenerate
                         : conv ? kConvergedS
                         : em_i >= p.max_em_iters ? kMaxIters : kOk;
      p.lane[kEmIters * B + b] = em_i;
      p.lane[kMapIters * B + b] += i;
      p.lane[kRunning * B + b] = !(conv || diverged);
      p.lane[kStatus * B + b] = status;
      publish(p, b);
      go_on = !finished;
      if (go_on) {
        p.lane[kMapI * B + b] = 0;
        p.lane[kFlag * B + b] = 0;
        p.lane[kActive * B + b] = p.max_map_iters > 0 ? 1 : 0;
      }
    }
    __syncthreads();
    if (go_on) {
      // The next EM iteration's start: its parameters (sigma clamped) and
      // an empty history ring.
      for (int l = threadIdx.x; l < K; l += blockDim.x) {
        const long long at = static_cast<long long>(b) * K + l;
        p.mu[at] = p.em_mu[at];
        p.sigma[at] = nan_max(p.em_sigma[at], smin);
      }
      for (long long j = threadIdx.x; j < static_cast<long long>(rows) * nh; j += blockDim.x) {
        p.ring[static_cast<long long>(b) * rows * nh + j] = 0.0f;
      }
    }
    if (threadIdx.x == 0) {
      atomicMax(p.ctl + kStepMax, i);
      if (go_on) atomicAdd(p.ctl + kGoOn, 1);
    }
  }

  // The join: the block that draws the last ticket closes the iteration.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(p.ctl + kTicket, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!is_last || threadIdx.x != 0) return;
  __threadfence();
  const int steps = p.ctl[kSteps] + atomicExch(p.ctl + kStepMax, 0);
  const int n_go = atomicExch(p.ctl + kGoOn, 0);
  p.ctl[kEmI] += 1;
  p.ctl[kSteps] = steps;
  p.ctl[kMapLive] = n_go;
  p.ctl[kEmCond] = n_go > 0 ? 1 : 0;
  p.ctl[kMapCond] = p.max_map_iters > 0 ? 1 : 0;
  p.ctl[kTicket] = 0;
  if (p.result_host != nullptr) {
    volatile int* out = p.result_host + 3 * B;
    out[0] = steps;
    out[1] = atomicAdd(p.ctl + kTickLaunches, 0);
    out[2] = atomicAdd(p.ctl + kBoundaryLaunches, 0);
    for (int j = 0; j < 3; ++j) out[3 + j] = p.ctl[kSegAdd + j];
  }
  if (p.conditional & 1) cudaGraphSetConditional(p.em_cond, n_go > 0 ? 1u : 0u);
  if (p.conditional & 2) cudaGraphSetConditional(p.map_cond, 1u);
}

}  // namespace em_program
