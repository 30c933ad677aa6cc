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
// and writes min_e and arg (8 B); the keyed sums add one vote atomic per
// valid element and about one hood atomic per warp.  At a 512x512 slice
// that is about 2 MB, well under a microsecond of HBM time, so the launch
// dominates.  There is no tensor-core work.
//
// Design: one thread per element, one launch.
//   * The per-label terms (mu, 2 sigma^2, log sigma) are formed once per
//     block in shared memory; K is a runtime count, so any K works.
//   * Each thread computes its K energies in registers with the op order of
//     ref.label_energies_blocked, keeps min/argmin with a strict '<' (ties
//     go to the lowest label) and writes both, padding lanes included.
//   * Lanes with valid == 0 add nothing: a padded problem's padding lanes
//     all carry one sentinel id, and their atomics would serialise on it.
//   * Hood sums: elements arrive sorted by hood inside a shard's block, so
//     a warp sums each run of equal hood ids among its lanes (a segmented
//     shuffle reduction) and its first lane issues one atomicAdd.  Unsorted
//     ids only make more, shorter runs: the result does not depend on the
//     order.
//   * Votes: one atomicAdd of the lane's valid weight (1.0) into
//     votes[arg * n_vertices + vertex].  Votes are integers below 2^24, so
//     the sum is exact in any order.
// The caller zeroes hood_e and votes.
//
// Arithmetic: every energy op is an explicitly rounded intrinsic (__fmul_rn,
// __fdiv_rn, ...) so nvcc cannot contract it into an FMA and each op rounds
// as PyTorch's separate ops do: min_e, arg and votes equal the plain version
// bit for bit.  hood_e is summed in another order (shuffle tree, then
// atomics) and agrees to rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Sum `v` over each run of lanes that hold the same `key`; the first lane of
// a run returns the run's sum (other lanes return partial sums).
__device__ __forceinline__ float run_sum(int key, float v, int lane, bool* first) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  *first = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFull, *first);
  const unsigned later = heads & ~((2u << lane) - 1u);  // run starts after this lane
  const int last = later ? __ffs(later) - 2 : kWarp - 1;  // last lane of this run
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const float up = __shfl_down_sync(kFull, v, o);
    if (lane + o <= last) v = __fadd_rn(v, up);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) map_step_kernel(
    const float* __restrict__ y, const float* __restrict__ w,
    const float* __restrict__ cnt, const float* __restrict__ nall,
    const float* __restrict__ xf, const float* __restrict__ valid,
    const int* __restrict__ hood_id, const int* __restrict__ vertex,
    const float* __restrict__ mu, const float* __restrict__ sigma,
    const float* __restrict__ beta_p, long long n, int n_labels, int n_hoods,
    int n_vertices, float* __restrict__ min_e, int* __restrict__ arg_out,
    float* __restrict__ hood_e, float* __restrict__ votes) {
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
  bool first;
  const float sum = run_sum(key, part, lane, &first);  // every lane takes part
  if (first && key >= 0) atomicAdd(hood_e + key, sum);
}

}  // namespace

extern "C" {

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Inputs: y, w, nall, xf, valid (n,) f32; cnt (n_labels, n) f32; hood_id,
// vertex (n,) i32; mu, sigma (n_labels,) f32; beta (1,) f32.  Outputs:
// min_e (n,) f32; arg (n,) i32; hood_e (n_hoods,) f32 and votes
// (n_labels, n_vertices) f32, both zeroed by the caller.  Returns
// cudaGetLastError() after the launch.
int repro_fused_map_step(const float* y, const float* w, const float* cnt,
                         const float* nall, const float* xf, const float* valid,
                         const int* hood_id, const int* vertex, const float* mu,
                         const float* sigma, const float* beta, long long n,
                         int n_labels, int n_hoods, int n_vertices, float* min_e,
                         int* arg, float* hood_e, float* votes, void* stream) {
  if (n_labels < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const size_t smem = 3 * static_cast<size_t>(n_labels) * sizeof(float);
    map_step_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        y, w, cnt, nall, xf, valid, hood_id, vertex, mu, sigma, beta, n,
        n_labels, n_hoods, n_vertices, min_e, arg, hood_e, votes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
