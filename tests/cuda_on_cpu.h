#pragma once
// The CUDA subset that nebulae_tpu_torch/csrc/trace.cu and vertex.cu use, on
// the CPU, for tests/test_torch_emulated.py and tests/test_torch_vertex.py.
// A launch runs its blocks one after another and each GPU thread of a block
// as a std::thread; a warp collective is a barrier per (warp, mask) that the
// mask's lanes meet at.  Device 0 has 32 SMs (group_rays() = 131,072 and
// K8's node_group_rays() = 8,192: the group bodies) and device 1 none (both
// 0: one thread per ray); emu_use_group_body picks one.
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 blockIdx, threadIdx;
inline dim3 blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidDevice = 101,
  cudaDevAttrMultiProcessorCount = 16,
  cudaDevAttrMaxThreadsPerMultiProcessor = 39
};
inline int emu_device = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = emu_device; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int dev) {
  *v = attr == cudaDevAttrMultiProcessorCount ? (dev == 0 ? 32 : 0) : 2048;
  return cudaSuccess;
}

template <class T> T __ldg(const T* p) { return *p; }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

// One meeting point of a warp's lanes under one mask, reused by each
// collective they make together.
struct Meet {
  std::barrier<> bar;
  uint32_t val[32];
  explicit Meet(int lanes) : bar(lanes) {}
};
inline std::mutex emu_mu;
inline std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Meet>>* emu_meets;

inline Meet& meet(unsigned mask) {
  std::lock_guard<std::mutex> g(emu_mu);
  auto& m = (*emu_meets)[std::make_pair(threadIdx.x / 32, mask)];
  if (!m) m = std::make_unique<Meet>(__builtin_popcount(mask));
  return *m;
}

// Each lane of `mask` gives v; src < 0 returns the ballot of the lanes'
// v != 0, else lane src's v.  A lane outside the mask, or a source outside
// it, aborts.
inline uint32_t exchange(unsigned mask, uint32_t v, int src) {
  Meet& m = meet(mask);
  int lane = threadIdx.x & 31;
  if (!((mask >> lane) & 1u)) std::abort();
  m.val[lane] = v;
  m.bar.arrive_and_wait();
  uint32_t out = 0;
  if (src < 0) {
    for (int k = 0; k < 32; ++k)
      if (((mask >> k) & 1u) && m.val[k]) out |= 1u << k;
  } else {
    if (!((mask >> src) & 1u)) std::abort();
    out = m.val[src];
  }
  m.bar.arrive_and_wait();
  return out;
}

inline unsigned __ballot_sync(unsigned mask, bool p) { return exchange(mask, p ? 1u : 0u, -1); }
template <class T> T __shfl_sync(unsigned mask, T v, int src) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  uint32_t u;
  std::memcpy(&u, &v, 4);
  u = exchange(mask, u, src);
  T o;
  std::memcpy(&o, &u, 4);
  return o;
}
template <class T> T __shfl_xor_sync(unsigned mask, T v, int off) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ off);
}

// kernel<<<grid, block, 0, stream>>>(args) becomes
// emu_launch(dim3(grid), dim3(block), [=] { kernel(args); }).
template <class F> void emu_launch(dim3 grid, dim3 block, F f) {
  blockDim = block;
  for (unsigned b = 0; b < grid.x; ++b) {
    std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Meet>> meets;
    emu_meets = &meets;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < block.x; ++t)
      threads.emplace_back([=] {
        blockIdx = dim3(b);
        threadIdx = dim3(t);
        f();
      });
    for (auto& t : threads) t.join();
  }
}

extern "C" void emu_use_group_body(int group) { emu_device = group ? 0 : 1; }
