// One MAP iteration of the sharded static-pallas route: K label energies,
// per-element min/argmin, per-hood energy sums and (label, vertex) votes.
//
// Replaces: src/repro/kernels/map_step.py :: fused_map_step_pallas.  The TPU
// kernel walks a (blocks x K) grid, keeps a running min/argmin in revisited
// output blocks and contracts (segments x 1024) one-hot tiles on the MXU for
// the two keyed sums; its caller gathers each element's label counts first
// and all-reduces the counts, the hood sums and the votes around it.
//
// What bounds it on an H100: launch and host time.  A MAP iteration reads
// each of the rank's hood elements once (y, w, nall, valid, vertex and the
// K vote counts of its vertex: 20 + 4K B), the history ring and the
// previous votes once, and writes one vote atomic per valid element and
// the hood sums: at a 512x512 slice about 1-2 MB, under a microsecond of
// HBM time.  What a solve pays is the launches, the collectives and the
// host work between them.  There is no tensor-core work.
//
// Two entry points:
//
// repro_map_step_iteration, the route's: one launch per MAP iteration on a
// plan-owned workspace (MapStepPlan), the buffers rotating over three
// [hood_e (n_hoods) | votes (K, V)] buffers so that one all-reduce covers a
// step's hood sums and votes.  The launch does:
//   * Head (iteration i-1), replicated on every rank, from the all-reduced
//     buffer of the previous step: each vertex's label is the first argmax
//     of its votes column (the sentinel vertex V-1 gets 0); each hood's
//     column of the (rows, n_hoods) history ring takes its hood_e after the
//     window and finiteness tests (flagword.cuh), whose bits the block that
//     draws the last ticket publishes to a word of mapped pinned host memory.
//     On a MAP loop's first launch the labels are the caller's and nothing
//     is tested.
//   * Step (iteration i), one warp per hood with valid elements in this
//     rank's block.  Hood elements are sorted by (hood, vertex), so each
//     hood is a run of the partition's element arrays and only the hoods
//     at a block edge straddle ranks.  The warp counts the K labels over
//     the hood's whole run (every rank holds the whole partition's vertex
//     and valid arrays, and labels are replicated: integer counts, exact,
//     equal to the all-reduced counts the caller used to gather), taking
//     each element's label in place from the previous votes (K reads), so
//     no grid-wide wait for the labels is needed.  Over the hood's elements
//     in this block it computes the K energies with the op order of
//     ref.label_energies_blocked, min/argmin with a strict '<', one integer
//     vote atomic per valid element, and the hood's sum of min_e * valid by
//     segsum.cuh's order-free sum inside the warp (WarpSegment), with the
//     grid of the parent's call (frac_bits of the block length).  Hoods
//     without elements here get 0, so the all-reduce adds up.
//   * Every block zeroes the votes of the buffer the next step writes: with
//     three buffers no block zeroes one that another block of the same
//     launch still reads.
// No memset, no copy, no min_e/arg output.
//
// repro_fused_map_step, the JAX kernel's signature: per-element counts
// cnt_e given, elements in any order; one thread per element writes min_e
// and arg, votes by atomics, and the hood sums by segsum.cuh's three passes
// (the main kernel does the exponent pass): three launches.  On the sorted
// slice operands its hood sums and votes equal the route's bit for bit.
//
// Arithmetic: every energy op is an explicitly rounded intrinsic (__fmul_rn,
// __fdiv_rn, ...) so nvcc cannot contract it into an FMA and each op rounds
// as PyTorch's separate ops do: min_e, arg and votes equal the plain version
// bit for bit.  hood_e is a fixed-point sum rounded once, so it agrees with
// the plain version's element-order float sum to rounding.

#include <cuda_runtime.h>

#include "flagword.cuh"
#include "segsum.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr int kSmemPerBlock = 232448;  // 227 KB: the most a block may take on an H100

// Per-label terms shared by a block's elements: [mu | 2 sigma^2 | log sigma].
__device__ __forceinline__ void load_terms(float* terms, const float* mu, const float* sigma,
                                           int n_labels) {
  for (int l = threadIdx.x; l < n_labels; l += blockDim.x) {
    const float s = sigma[l];
    terms[l] = mu[l];
    terms[n_labels + l] = __fmul_rn(__fmul_rn(2.0f, s), s);
    terms[2 * n_labels + l] = logf(s);
  }
}

// Label l's energy of one element, in the op order of
// ref.label_energies_blocked at float32.
__device__ __forceinline__ float label_energy(const float* terms, int n_labels, int l, float yv,
                                              float wv, float na, float xv, float vv,
                                              float denom, float beta, float cnt) {
  const float d = __fsub_rn(yv, terms[l]);
  const float quad = __fdiv_rn(__fmul_rn(d, d), terms[n_labels + l]);
  const float data = __fmul_rn(wv, __fadd_rn(quad, terms[2 * n_labels + l]));
  const float eq = (xv == static_cast<float>(l)) ? 1.0f : 0.0f;
  const float diff = __fsub_rn(__fsub_rn(na, cnt), __fsub_rn(1.0f, eq));
  const float smooth = __fmul_rn(__fdiv_rn(__fmul_rn(beta, fmaxf(diff, 0.0f)), denom), vv);
  return __fadd_rn(data, smooth);
}

// The hood sums' source: min_e * valid of each valid element with a hood
// id in range (the product the main kernel forms), keyed by that hood.
struct HoodEnergy {
  const float* min_e;
  const float* valid;
  const int* hood_id;
  int n_hoods;
  __device__ int operator()(long long e, float* v) const {
    const float vv = valid[e];
    const int h = hood_id[e];
    *v = __fmul_rn(min_e[e], vv);
    return (vv > 0.0f && h >= 0 && h < n_hoods) ? h : -1;
  }
};

__global__ void __launch_bounds__(kThreads) map_step_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ cnt, const float* __restrict__ nall,
    const float* __restrict__ xf, const float* __restrict__ valid,
    const int* __restrict__ hood_id, const int* __restrict__ vertex,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ beta_p, long long n, int n_labels, int n_hoods,
    int n_vertices, float* __restrict__ min_e, int* __restrict__ arg_out,
    segsum::Workspace ws, float* __restrict__ votes) {
  extern __shared__ float terms[];  // [mu | 2 sigma^2 | log sigma], K each
  load_terms(terms, mu, sigma, n_labels);
  __syncthreads();

  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x % kWarp;
  int key = -1;  // hood this lane adds to; -1 adds nothing
  float part = 0.0f;
  if (e < n) {
    const float beta = beta_p[0];
    const float yv = y[e];
    const float wv = w[e];
    const float na = nall[e];
    const float xv = xf[e];
    const float vv = valid[e];
    const float denom = fmaxf(__fsub_rn(na, 1.0f), 1.0f);
    float best = 0.0f;
    int arg = 0;
    for (int l = 0; l < n_labels; ++l) {
      const float en = label_energy(terms, n_labels, l, yv, wv, na, xv, vv, denom, beta,
                                    cnt[static_cast<long long>(l) * n + e]);
      if (l == 0 || en < best) {
        best = en;
        arg = l;
      }
    }
    min_e[e] = best;
    arg_out[e] = arg;
    if (vv > 0.0f) {
      const int h = hood_id[e];
      if (h >= 0 && h < n_hoods) {
        key = h;
        part = __fmul_rn(best, vv);
      }
      const int v = vertex[e];
      if (v >= 0 && v < n_vertices) {
        atomicAdd(votes + static_cast<long long>(arg) * n_vertices + v, vv);
      }
    }
  }
  segsum::note_exponent(key, part, lane, ws);  // every lane takes part
}

// The route's MAP iteration (file comment): operands of one launch.
struct IterParams {
  const float* y;                  // (block,) the rank's elements
  const float* w;
  const float* nall;
  const float* valid;
  const int* vertex;               // (capacity,) every element of the partition
  const unsigned char* valid_all;  // (capacity,) bool
  const int* ranges;               // (n_local, 4): run begin, run end, block begin, block end
  const float* mu;
  const float* sigma;
  const float* beta;
  int* labels;                     // (n_vertices,)
  const float* prev;               // the previous step's all-reduced [hood_e | votes]
  float* cur;                      // this step's buffer, votes zero on entry
  float* next;                     // the next step's buffer: its votes are zeroed here
  float* scratch;                  // (block,) min_e * valid of this rank's valid elements
  float* ring;                     // (hist_rows, n_hoods)
  unsigned int* sync;              // ticket, accumulator
  int* flag_host;                  // device view of a mapped host word
  long long base;                  // the block's first element in the partition
  int fbits;
  int hist_rows;
  int head;
  int gate;
  int first;
  int step;
  int n_hoods;
  int n_vertices;
  int n_labels;
  int n_local;
  int hood_lo;
  float conv_tol;
};

// The first argmax over K of a vertex's votes; the sentinel vertex gets 0.
__device__ __forceinline__ int vote_label(const float* votes, long long v, int n_labels,
                                          int n_vertices) {
  if (v == n_vertices - 1) return 0;
  float best = votes[v];
  int lab = 0;
  for (int l = 1; l < n_labels; ++l) {
    const float c = votes[static_cast<long long>(l) * n_vertices + v];
    if (c > best) {
      best = c;
      lab = l;
    }
  }
  return lab;
}

// Vertex v's label this step: the caller's on a MAP loop's first launch,
// else the previous step's plurality.
__device__ __forceinline__ int current_label(const IterParams& p, int v) {
  if (v < 0 || v >= p.n_vertices) return 0;
  if (p.first) return min(max(p.labels[v], 0), p.n_labels - 1);
  return vote_label(p.prev + p.n_hoods, v, p.n_labels, p.n_vertices);
}

// Dynamic shared memory of the iteration kernel: 3 K terms and K counts per warp.
constexpr size_t iteration_smem_bytes(int n_labels) {
  return static_cast<size_t>(3 + kWarps) * n_labels * sizeof(float);
}

__global__ void __launch_bounds__(kThreads) map_iteration_kernel(const IterParams p) {
  extern __shared__ float smem[];  // [mu | 2 sigma^2 | log sigma | counts per warp], K each
  const int K = p.n_labels;
  const int nv = p.n_vertices;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;

  // Head: the previous step's labels and tests, every vertex and hood.
  unsigned bits = 0u;
  if (!p.first) {
    for (long long v = tid; v < nv; v += nthreads) p.labels[v] = vote_label(p.prev + p.n_hoods, v, K, nv);
    for (long long h = tid; h < p.n_hoods; h += nthreads) {
      bits |= flagword::close_window(p.ring, p.hist_rows, p.head, p.n_hoods, static_cast<int>(h),
                                     p.prev[h], p.conv_tol, true);
    }
  }
  float* next_votes = p.next + p.n_hoods;
  for (long long i = tid; i < static_cast<long long>(K) * nv; i += nthreads) next_votes[i] = 0.0f;

  if (p.step) {  // uniform in the grid
    const int warp = threadIdx.x / kWarp;
    const int lane = threadIdx.x % kWarp;
    float* cnt = smem + 3 * K + warp * K;
    load_terms(smem, p.mu, p.sigma, K);
    for (long long h = tid; h < p.n_hoods; h += nthreads) {
      if (h < p.hood_lo || h >= p.hood_lo + p.n_local) p.cur[h] = 0.0f;
    }
    __syncthreads();
    const int j = blockIdx.x * kWarps + warp;
    if (j < p.n_local) {  // uniform in the warp
      const int* r = p.ranges + 4 * j;
      const int run_begin = r[0], run_end = r[1], begin = r[2], end = r[3];

      // 1. Label counts over the hood's whole run (0/1 adds: exact).
      for (int l = lane; l < K; l += kWarp) cnt[l] = 0.0f;
      __syncwarp();
      for (int e = run_begin + lane; e < run_end; e += kWarp) {
        if (p.valid_all[e]) atomicAdd(cnt + current_label(p, p.vertex[e]), 1.0f);
      }
      __syncwarp();

      // 2. Energies, min/argmin and votes of the hood's elements in this
      // block, and the exponent pass of its order-free sum.
      const float beta = p.beta[0];
      float* votes = p.cur + p.n_hoods;
      segsum::WarpSegment seg;
      for (int g = begin + lane; g < end; g += kWarp) {
        const long long e = g - p.base;
        const float vv = p.valid[e];
        if (vv > 0.0f) {
          const int vtx = p.vertex[g];
          const float xv = __fmul_rn(static_cast<float>(current_label(p, vtx)), vv);
          const float yv = p.y[e];
          const float wv = p.w[e];
          const float na = p.nall[e];
          const float denom = fmaxf(__fsub_rn(na, 1.0f), 1.0f);
          float best = 0.0f;
          int arg = 0;
          for (int l = 0; l < K; ++l) {
            const float en = label_energy(smem, K, l, yv, wv, na, xv, vv, denom, beta, cnt[l]);
            if (l == 0 || en < best) {
              best = en;
              arg = l;
            }
          }
          const float part = __fmul_rn(best, vv);
          p.scratch[e] = part;
          seg.note(part);
          if (vtx >= 0 && vtx < nv) atomicAdd(votes + static_cast<long long>(arg) * nv + vtx, vv);
        }
      }
      seg.close_exponent();
      __syncwarp();

      // 3. The sum pass on the hood's grid and the read-out.
      for (int g = begin + lane; g < end; g += kWarp) {
        const long long e = g - p.base;
        if (p.valid[e] > 0.0f) seg.add(p.scratch[e], p.fbits);
      }
      const float he = seg.result(p.fbits);
      if (lane == 0) p.cur[p.hood_lo + j] = he;
    }
  }
  if (!flagword::last_block_done(p.sync, bits)) return;
  if (threadIdx.x == 0) flagword::publish(p.sync, p.gate, nullptr, p.flag_host);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs: y, w, nall, xf, valid (n,) f32; cnt (n_labels, n) f32; hood_id,
// vertex (n,) i32; mu, sigma (n_labels,) f32; beta (1,) f32.  Outputs:
// min_e (n,) f32; arg (n,) i32; hood_e (n_hoods,) f32; votes (n_labels,
// n_vertices) f32, zeroed by the caller.  workspace: 16 B per hood, zeroed
// by the caller.  Returns cudaGetLastError() after the launches.
int repro_fused_map_step(const float* y, const float* w, const float* cnt,
                         const float* nall, const float* xf, const float* valid,
                         const int* hood_id, const int* vertex, const float* mu,
                         const float* sigma, const float* beta, long long n,
                         int n_labels, int n_hoods, int n_vertices, float* min_e,
                         int* arg, float* hood_e, float* votes, void* workspace,
                         void* stream) {
  if (n_labels < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const segsum::Workspace ws = segsum::carve(workspace, n_hoods);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = 3 * static_cast<size_t>(n_labels) * sizeof(float);
    map_step_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, s>>>(
        y, w, cnt, nall, xf, valid, hood_id, vertex, mu, sigma, beta, n,
        n_labels, n_hoods, n_vertices, min_e, arg, ws, votes);
    if (cudaPeekAtLastError() != cudaSuccess) return static_cast<int>(cudaGetLastError());
  }
  segsum::launch_sum(HoodEnergy{min_e, valid, hood_id, n_hoods}, n, n_hoods, ws, hood_e, s);
  return static_cast<int>(cudaGetLastError());
}

// The route's MAP-iteration workspace, filled in by the caller once per
// (partition, rank, K) and per solve (the element pointers) and read by
// every launch.  Buffers: buffers (3, n_hoods + n_labels * n_vertices) f32,
// rotated by `rot`; labels (n_vertices,) i32; ring (hist_rows, n_hoods) f32;
// scratch (block,) f32; ranges (n_local, 4) i32; sync (2,) u32 zero;
// flag_host the device address of a word from repro_em_tick_host_word.
struct MapStepPlan {
  const float* y;
  const float* w;
  const float* nall;
  const float* valid;
  const int* vertex;
  const unsigned char* valid_all;
  const int* ranges;
  const float* mu;
  const float* sigma;
  const float* beta;
  int* labels;
  float* buffers;
  float* scratch;
  float* ring;
  unsigned int* sync;
  int* flag_host;
  void* stream;
  long long base;
  long long block;
  int hist_rows;
  int n_hoods;
  int n_vertices;
  int n_labels;
  int n_local;
  int hood_lo;
  int device;
  float conv_tol;
};

// One launch: the head tests the step in buffer (rot + 2) % 3 (unless
// `first`), the step (if `step`) writes buffer rot, and the votes of buffer
// (rot + 1) % 3 are zeroed.  The ring's newest row is `head`.
int repro_map_step_iteration(const MapStepPlan* t, int rot, int head, int gate, int first,
                             int step) {
  if (t->n_labels < 1 || iteration_smem_bytes(t->n_labels) > static_cast<size_t>(kSmemPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != t->device && (err = cudaSetDevice(t->device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long len = t->n_hoods + static_cast<long long>(t->n_labels) * t->n_vertices;
  const int q = ((rot % 3) + 3) % 3;
  const IterParams p{t->y, t->w, t->nall, t->valid, t->vertex, t->valid_all, t->ranges,
                     t->mu, t->sigma, t->beta, t->labels, t->buffers + ((q + 2) % 3) * len,
                     t->buffers + q * len, t->buffers + ((q + 1) % 3) * len, t->scratch,
                     t->ring, t->sync, t->flag_host, t->base, segsum::frac_bits(t->block),
                     t->hist_rows, head, gate, first, step, t->n_hoods, t->n_vertices,
                     t->n_labels, t->n_local, t->hood_lo, t->conv_tol};
  const size_t smem = iteration_smem_bytes(t->n_labels);
  int rc = 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(map_iteration_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) rc = static_cast<int>(err);
  }
  if (rc == 0) {
    const long long blocks = (static_cast<long long>(t->n_local) + kWarps - 1) / kWarps;
    map_iteration_kernel<<<static_cast<unsigned int>(blocks > 0 ? blocks : 1), kThreads, smem,
                           static_cast<cudaStream_t>(t->stream)>>>(p);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (current != t->device) cudaSetDevice(current);
  return rc;
}

}  // extern "C"
