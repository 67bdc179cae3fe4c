// Helpers shared by the port's kernels: element conversion, warp
// reductions, the masking constant, and the dtype codes of _build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// large-negative mask value of the JAX package (-2**30), exact in fp32
constexpr float kNegInf = -1073741824.0f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round-to-nearest-even, as torch's and XLA's casts do
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The local slots [lo, hi] that one-token decode at position p keeps in an
// L-slot cache shard holding the global slots [off, off + L): global slot
// off + j is kept when off + j <= p, inside the window (p - (off + j) <
// window) and the chunk of p ((off + j) / chunk == p / chunk) where those
// are set; empty when hi < lo. The chunk's start comes from the global p,
// so the offset is not folded into the position. A ring (a cache of T
// slots, global slot j holding token p - ((p - j) mod T)) keeps the global
// slots [0, min(p', T - 1)], so a shard of it holding [off, off + L) keeps
// [0, min(p' - off, L - 1)]: p' = p on a window ring (T <= window: every
// token >= 0 lies in the window), p' = p mod chunk on a chunked ring (T <=
// chunk: with T = chunk the current chunk's tokens fill the slots [0, p mod
// chunk], the others hold the chunk before; with T < chunk the positions
// never reach T, so p mod chunk = p). The window and chunk tests, which
// read slot j as token j, are skipped on a ring (the caller refuses a ring
// longer than its window or chunk).
__device__ __forceinline__ void kept_interval(long long p, long long off,
                                              int L, int window, int chunk,
                                              bool ring, long long* lo,
                                              long long* hi) {
  if (ring && chunk > 0) p %= chunk;
  *lo = 0;
  *hi = p - off < L - 1 ? p - off : static_cast<long long>(L) - 1;
  if (ring) return;
  if (window > 0 && p - window + 1 - off > *lo) *lo = p - window + 1 - off;
  if (chunk > 0 && (p / chunk) * chunk - off > *lo)
    *lo = (p / chunk) * chunk - off;
}

// 16 bytes of T unpacked to fp32: 4 floats or 8 bf16 values
template <typename T>
__device__ __forceinline__ void load16_f(const T* __restrict__ p, float* out) {
  constexpr int V = 16 / sizeof(T);
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f<T>(e[i]);
}

}  // namespace repro
