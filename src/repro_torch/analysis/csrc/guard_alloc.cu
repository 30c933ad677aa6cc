// A guarding device allocator for the kernel pass's fallback when
// compute-sanitizer cannot run (torch.cuda.memory.CUDAPluggableAllocator).
//
// Every allocation gets kGuard bytes of canary on each side, and its body
// is filled with the poison byte of the moment (guard_set_poison).  At
// free, and at guard_check_all, the canaries are read back: a changed byte
// is a write past the allocation (memcheck's class), recorded with the
// allocation's size and the side and offset of the first changed byte.
// Running the same calls under two poison bytes and comparing what they
// computed finds reads of memory nothing wrote (initcheck's class).
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kGuard = 4096;
constexpr unsigned char kCanary = 0xA5;

struct Block {
  unsigned char* base;
  size_t size;
};

struct Violation {
  size_t size;    // the allocation's bytes
  int after;      // 1: past the end, 0: before the start
  size_t offset;  // of the first changed canary byte from the body's edge
};

std::mutex g_lock;
std::unordered_map<void*, Block> g_live;
std::vector<Violation> g_violations;
int g_poison = 0xFF;
long long g_allocs = 0;

// Read back both guards of `b`; record the first changed byte of each side.
void check_block(const Block& b) {
  std::vector<unsigned char> host(kGuard);
  for (int after = 0; after < 2; ++after) {
    const unsigned char* guard = after ? b.base + kGuard + b.size : b.base;
    if (cudaMemcpy(host.data(), guard, kGuard, cudaMemcpyDeviceToHost) != cudaSuccess) return;
    for (size_t i = 0; i < kGuard; ++i) {
      const size_t j = after ? i : kGuard - 1 - i;  // distance from the body
      if (host[j] != kCanary) {
        g_violations.push_back(Violation{b.size, after, i});
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

void* guard_malloc(ssize_t size, int device, cudaStream_t stream) {
  (void)device;
  (void)stream;
  unsigned char* base = nullptr;
  const size_t n = static_cast<size_t>(size);
  if (cudaMalloc(&base, n + 2 * kGuard) != cudaSuccess) return nullptr;
  cudaMemset(base, kCanary, kGuard);
  cudaMemset(base + kGuard, g_poison, n);
  cudaMemset(base + kGuard + n, kCanary, kGuard);
  cudaDeviceSynchronize();
  void* ptr = base + kGuard;
  std::lock_guard<std::mutex> lock(g_lock);
  g_live[ptr] = Block{base, n};
  ++g_allocs;
  return ptr;
}

void guard_free(void* ptr, ssize_t size, int device, cudaStream_t stream) {
  (void)size;
  (void)device;
  (void)stream;
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(g_lock);
  auto it = g_live.find(ptr);
  if (it == g_live.end()) return;
  check_block(it->second);
  cudaFree(it->second.base);
  g_live.erase(it);
}

void guard_set_poison(int byte) { g_poison = byte & 0xFF; }

// Check every live allocation's guards now; returns the violations so far.
int guard_check_all() {
  cudaDeviceSynchronize();
  std::lock_guard<std::mutex> lock(g_lock);
  for (const auto& kv : g_live) check_block(kv.second);
  return static_cast<int>(g_violations.size());
}

// Copy out up to `n` violations as (size, after, offset) triples; returns
// how many there are, and forgets them.
int guard_take_violations(long long* out, int n) {
  std::lock_guard<std::mutex> lock(g_lock);
  const int total = static_cast<int>(g_violations.size());
  for (int i = 0; i < total && i < n; ++i) {
    out[3 * i] = static_cast<long long>(g_violations[i].size);
    out[3 * i + 1] = g_violations[i].after;
    out[3 * i + 2] = static_cast<long long>(g_violations[i].offset);
  }
  g_violations.clear();
  return total;
}

long long guard_allocations() { return g_allocs; }

}  // extern "C"
