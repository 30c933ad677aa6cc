// Keyed float32 reductions whose result does not depend on the order in
// which elements arrive: an order-free sum and a NaN-true minimum.  Used by
// segment_reduce.cu (the ReduceByKey kernel) and map_step.cu (the hood sums
// of its JAX-signature entry, whose elements come in any order).
// src/repro_torch/testing/segsum.py is a numpy model of the same arithmetic;
// the kernels equal it bit for bit.
//
// Sum, without a floating-point atomic (pre-rounding in the spirit of
// Demmel and Nguyen's reproducible summation).  A zeroed workspace holds
// three words per segment:
//   1. exponent pass: the largest exponent key of a finite non-zero value
//      (the biased exponent field, at least 1) by an integer atomicMax, and
//      the NaN / +inf / -inf flags by atomicOr;
//   2. sum pass: each finite value rounded, half to even, to a multiple of
//      2^q, q = key - 126 - fbits, an int64 of magnitude at most 2^fbits;
//      with fbits = 62 - ceil(log2 n) the n values of a call sum below
//      2^62, so the 64-bit integer atomicAdd is exact in any order;
//   3. read-out: the integer sum rounded once to float32, scaled by 2^q in
//      double (exact) and rounded to float32 (exact unless subnormal).  NaN,
//      or +inf with -inf, gives NaN; one infinity gives itself.
// Each value keeps at least fbits - 1 bits below its segment's top
// exponent: 41 at n = 10^6, against float32's 24.
//
// Minimum: a compare-and-swap on the float's bits under a total order in
// which NaN is least, then -inf .. -0.0 < +0.0 .. +inf, so a NaN lands and
// a -0.0 against +0.0 tie gives -0.0 whatever the order.
//
// Both passes first combine the lanes of a warp that hold one key in
// consecutive lanes (a segmented shuffle), and only the run's first lane
// issues the atomic, and only when its value is not the identity: sorted
// or near-sorted ids and padding lanes that share one id do not serialise.

#pragma once

#include <cuda_runtime.h>

namespace segsum {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNaNBits = 0x7fc00000u;
constexpr int kNaN = 1, kPosInf = 2, kNegInf = 4;

// The per-segment words, carved from one zeroed buffer of 16 B a segment.
struct Workspace {
  unsigned long long* acc;  // fixed-point sums (two's complement)
  int* key;                 // largest exponent key, 0 = no finite non-zero value
  int* flags;               // kNaN | kPosInf | kNegInf
};

inline size_t workspace_bytes(int segments) { return 16 * static_cast<size_t>(segments); }

inline Workspace carve(void* buffer, int segments) {
  Workspace ws;
  ws.acc = static_cast<unsigned long long*>(buffer);
  ws.key = reinterpret_cast<int*>(ws.acc + segments);
  ws.flags = ws.key + segments;
  return ws;
}

// Grid bits below a segment's top exponent for a call of n elements.
inline int frac_bits(long long n) {
  int l = 0;
  while (l < 62 && (1LL << l) < n) ++l;
  return 62 - l;
}

inline unsigned int grid_blocks(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond 32 blocks/SM
  return static_cast<unsigned int>(blocks < 1 ? 1 : blocks);
}

__device__ __forceinline__ int exponent_key(float v) {
  const unsigned field = (__float_as_uint(v) >> 23) & 0xffu;
  return (field == 0xffu || v == 0.0f) ? 0 : max(static_cast<int>(field), 1);
}

__device__ __forceinline__ int nonfinite_flag(float v) {
  if (v != v) return kNaN;
  if (isinf(v)) return v > 0.0f ? kPosInf : kNegInf;
  return 0;
}

__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double(static_cast<long long>(1023 + e) << 52);
}

__device__ __forceinline__ long long quantize(float v, int key, int fbits) {
  return __double2ll_rn(__dmul_rn(static_cast<double>(v), pow2(fbits + 126 - key)));
}

__device__ __forceinline__ float readout(unsigned long long acc, int key, int flags, int fbits) {
  if ((flags & kNaN) || (flags & (kPosInf | kNegInf)) == (kPosInf | kNegInf)) {
    return __uint_as_float(kNaNBits);
  }
  if (flags & kPosInf) return __uint_as_float(0x7f800000u);
  if (flags & kNegInf) return __uint_as_float(0xff800000u);
  if (key == 0) return 0.0f;
  const float f = __ll2float_rn(static_cast<long long>(acc));
  return __double2float_rn(__dmul_rn(static_cast<double>(f), pow2(key - 126 - fbits)));
}

// The minimum under the total order above.
__device__ __forceinline__ float min_total(float a, float b) {
  if (a != a || b != b) return __uint_as_float(kNaNBits);
  if (a < b) return a;
  if (b < a) return b;
  return __uint_as_float(__float_as_uint(a) | __float_as_uint(b));  // equal: -0.0 wins
}

__device__ __forceinline__ void atomic_min_total(float* addr, float val) {
  unsigned int* bits = reinterpret_cast<unsigned int*>(addr);
  unsigned int old = *bits;
  for (;;) {
    const unsigned int want = __float_as_uint(min_total(__uint_as_float(old), val));
    if (want == old) return;
    const unsigned int seen = atomicCAS(bits, old, want);
    if (seen == old) return;
    old = seen;
  }
}

struct Add {
  template <class T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Or {
  __device__ int operator()(int a, int b) const { return a | b; }
};
struct Min {
  __device__ float operator()(float a, float b) const { return min_total(a, b); }
};

// Combine `v` over each run of consecutive lanes that hold the same `key`;
// the run's first lane (*head) returns the run's total.  Every lane of the
// warp must take part.
template <class T, class Op>
__device__ __forceinline__ T run_reduce(int key, T v, int lane, bool* head, Op op) {
  const int prev = __shfl_up_sync(kFull, key, 1);
  *head = lane == 0 || prev != key;
  const unsigned heads = __ballot_sync(kFull, *head);
  const unsigned later = heads & ~((2u << lane) - 1u);  // run starts after this lane
  const int last = later ? __ffs(later) - 2 : kWarp - 1;  // last lane of this run
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const T up = __shfl_down_sync(kFull, v, o);
    if (lane + o <= last) v = op(v, up);
  }
  return v;
}

// Exponent pass for one lane's (key, value); key < 0 adds nothing.
__device__ __forceinline__ void note_exponent(int key, float v, int lane, const Workspace& ws) {
  bool head;
  const int ek = run_reduce(key, key >= 0 ? exponent_key(v) : 0, lane, &head, Max());
  const int fl = run_reduce(key, key >= 0 ? nonfinite_flag(v) : 0, lane, &head, Or());
  if (head && key >= 0) {
    if (ek) atomicMax(ws.key + key, ek);
    if (fl) atomicOr(ws.flags + key, fl);
  }
}

// A source gives each element's segment (or -1: the element adds nothing)
// and value: `int operator()(long long e, float* v) const`.

// Keys are ids in [0, segments); others add nothing.
struct Keyed {
  const float* values;
  const int* ids;
  int segments;
  __device__ int operator()(long long e, float* v) const {
    const int s = ids[e];
    *v = values[e];
    return (s >= 0 && s < segments) ? s : -1;
  }
};

// Calls body(e, lane) for every element index e < n, and for lanes past n
// with e >= n: a warp-uniform grid-stride loop, so that every lane of a
// warp runs every iteration and the shuffles see the whole warp.
template <class Body>
__device__ __forceinline__ void for_each_element(long long n, Body body) {
  const int lane = threadIdx.x % kWarp;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + (threadIdx.x - lane);
       base < n; base += stride) {
    body(base + lane, lane);
  }
}

template <class Src>
__global__ void __launch_bounds__(kThreads) exponent_pass(Src src, long long n, Workspace ws) {
  for_each_element(n, [&](long long e, int lane) {
    float v = 0.0f;
    const int key = e < n ? src(e, &v) : -1;
    note_exponent(key, v, lane, ws);
  });
}

template <class Src>
__global__ void __launch_bounds__(kThreads) sum_pass(Src src, long long n, int fbits, Workspace ws) {
  for_each_element(n, [&](long long e, int lane) {
    float v = 0.0f;
    const int key = e < n ? src(e, &v) : -1;
    long long q = 0;
    if (key >= 0 && isfinite(v) && v != 0.0f) q = quantize(v, ws.key[key], fbits);
    bool head;
    const long long s = run_reduce(key, q, lane, &head, Add());
    if (head && key >= 0 && s != 0) {
      atomicAdd(ws.acc + key, static_cast<unsigned long long>(s));
    }
  });
}

__global__ void __launch_bounds__(kThreads) readout_pass(Workspace ws, int segments, int fbits,
                                                         float* __restrict__ out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < segments) out[s] = readout(ws.acc[s], ws.key[s], ws.flags[s], fbits);
}

template <class Src>
__global__ void __launch_bounds__(kThreads) min_pass(Src src, long long n, float* __restrict__ out) {
  for_each_element(n, [&](long long e, int lane) {
    float v = __uint_as_float(0x7f800000u);  // +inf: the identity
    const int key = e < n ? src(e, &v) : -1;
    bool head;
    const float m = run_reduce(key, v, lane, &head, Min());
    if (head && key >= 0 && __float_as_uint(m) != 0x7f800000u) atomic_min_total(out + key, m);
  });
}

// Sum and read-out passes (the exponent pass has run): n elements of `src`
// into `segments` outputs.
template <class Src>
void launch_sum(Src src, long long n, int segments, Workspace ws, float* out, cudaStream_t stream) {
  const int fbits = frac_bits(n);
  if (n > 0) sum_pass<<<grid_blocks(n), kThreads, 0, stream>>>(src, n, fbits, ws);
  if (segments > 0) {
    readout_pass<<<(segments + kThreads - 1) / kThreads, kThreads, 0, stream>>>(ws, segments,
                                                                                   fbits, out);
  }
}

}  // namespace segsum
