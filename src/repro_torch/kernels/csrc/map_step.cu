// One MAP iteration of the sharded static-pallas route, given each
// element's neighbourhood label counts: K label energies, per-element
// min/argmin, per-hood energy sums and (label, vertex) votes.
//
// Replaces: src/repro/kernels/map_step.py :: fused_map_step_pallas.  The TPU
// kernel walks a (blocks x K) grid, keeps a running min/argmin in revisited
// output blocks and contracts (segments x 1024) one-hot tiles on the MXU for
// the two keyed sums.
//
// What bounds it on an H100: memory and launch time.  Each element is read
// once (y, w, nall, xf, valid, hood_id, vertex and its K counts: 28 + 4K B)
// and writes min_e and arg (8 B); the hood sums read min_e, valid and the
// hood id once more, and the keyed sums add one vote atomic per valid
// element and a few hood atomics per warp.  At a 512x512 slice that is
// about 2 MB, well under a microsecond of HBM time, so the launches
// dominate.  There is no tensor-core work.
//
// Design: one thread per element.
//   * The per-label terms (mu, 2 sigma^2, log sigma) are formed once per
//     block in shared memory; K is a runtime count, so any K works.
//   * Each thread computes its K energies in registers with the op order of
//     ref.label_energies_blocked, keeps min/argmin with a strict '<' (ties
//     go to the lowest label) and writes both, padding lanes included.
//   * Lanes with valid == 0 add nothing: a padded problem's padding lanes
//     all carry one sentinel id, and their atomics would serialise on it.
//   * Hood sums, order-fixed: the order-free keyed sum of segsum.cuh over
//     min_e * valid.  The main launch also does its exponent pass (each
//     warp combines its runs of equal hood ids, then one integer atomicMax
//     per run); a sum pass then adds each value on its hood's fixed-point
//     grid with 64-bit integer atomics, and a read-out rounds each hood's
//     sum once.  The sum is the same bit for bit whatever the warps'
//     schedule and whatever the order of the elements, so a hood that spans
//     many warps gets one answer; a NaN energy gives a NaN hood sum.
//   * Votes: one atomicAdd of the lane's valid weight (1.0) into
//     votes[arg * n_vertices + vertex].  Votes are integers below 2^24, so
//     the sum is exact in any order.
// Three launches in all.  The caller zeroes the votes and the workspace.
//
// Arithmetic: every energy op is an explicitly rounded intrinsic (__fmul_rn,
// __fdiv_rn, ...) so nvcc cannot contract it into an FMA and each op rounds
// as PyTorch's separate ops do: min_e, arg and votes equal the plain version
// bit for bit.  hood_e is a fixed-point sum rounded once, so it agrees with
// the plain version's element-order float sum to rounding.

#include <cuda_runtime.h>

#include "segsum.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

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
  for (int l = threadIdx.x; l < n_labels; l += blockDim.x) {
    const float s = sigma[l];
    terms[l] = mu[l];
    terms[n_labels + l] = __fmul_rn(__fmul_rn(2.0f, s), s);
    terms[2 * n_labels + l] = logf(s);
  }
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
      const float d = __fsub_rn(yv, terms[l]);
      const float quad = __fdiv_rn(__fmul_rn(d, d), terms[n_labels + l]);
      const float data = __fmul_rn(wv, __fadd_rn(quad, terms[2 * n_labels + l]));
      const float eq = (xv == static_cast<float>(l)) ? 1.0f : 0.0f;
      const float diff =
          __fsub_rn(__fsub_rn(na, cnt[static_cast<long long>(l) * n + e]), __fsub_rn(1.0f, eq));
      const float smooth =
          __fmul_rn(__fdiv_rn(__fmul_rn(beta, fmaxf(diff, 0.0f)), denom), vv);
      const float en = __fadd_rn(data, smooth);
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

}  // extern "C"
