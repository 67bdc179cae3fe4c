// Fused decode-stat accumulation for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_stats/stats.py, _stats_kernel (called
// by decode_stats_accumulate_pallas). From fp32 scores s (B,KV,G,L) that
// arrive already NEG_INF-masked and the row max m (B,KV,G):
//   p = exp(s - m), with masked slots (s <= NEG_INF/2) set to 0, so a fully
//       masked row (m = NEG_INF) gives 0 and not exp(0) = 1;
//   l = sum_j p;   o = sum_j p * v[j], in fp32 whatever the cache dtype.
// Outputs o (B,1,H,D) and l (B,1,H) in fp32, H = KV*G.
//
// Bound on the H100: memory. One decode step reads the value cache once
// (B*L*KV*D elements) and s (B*H*L fp32) and does 2 flops per value element
// per query head (G = 3 at llama3.2-3b), about one flop per byte.
//
// Design: one block of 256 threads per (b, kv) row group; the TPU's
// sequential L axis becomes a loop inside the block over 128-slot tiles.
// Per tile the block turns the G x 128 scores into p in shared memory; a
// tile with no unmasked slot (every slot past the row's position, the bulk
// of a long cache early in a request) is skipped and its V rows are never
// read. Otherwise each thread reads 16 bytes of V (8 bf16 or 4 fp32 values
// of one slot) per step, threads side by side covering a slot's D values and
// the rest of the block covering other slots, so a warp's loads are
// contiguous; every thread keeps G x 8 (or G x 4) fp32 partial sums in
// registers, reduced across the slot lanes through shared memory at the end.
// B*KV = 64 blocks fill half of the 132 SMs; a split-L pass is later work.
#include "common.cuh"

namespace {

using repro::kNegInf;

constexpr int kThreads = 256;
constexpr int kTile = 128;              // cache slots per tile

template <typename TV, int G>
__global__ void __launch_bounds__(kThreads)
decode_stats_kernel(const float* __restrict__ s, const float* __restrict__ m,
                    const TV* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ l, int KV, int L, int D) {
  constexpr int V = 16 / sizeof(TV);
  __shared__ float sP[G * kTile];
  __shared__ float sRed[kThreads * V];  // [slot lanes][D] partial sums
  __shared__ float sM[G];

  const int bk = blockIdx.x;            // b * KV + kv
  const int b = bk / KV, kv = bk % KV;
  const int tid = threadIdx.x;
  const int DG = D / V;                 // threads across one slot's D values
  const int LS = kThreads / DG;         // slot lanes
  const int dg = tid % DG, ls = tid / DG;
  const float* srow = s + static_cast<size_t>(bk) * G * L;

  if (tid < G) sM[tid] = m[static_cast<size_t>(bk) * G + tid];
  __syncthreads();

  float acc[G][V], lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = 0; t0 < L; t0 += kTile) {
    int any = 0;
    for (int idx = tid; idx < G * kTile; idx += kThreads) {
      const int g = idx / kTile, pos = t0 + idx % kTile;
      float p = 0.f;
      if (pos < L) {
        const float sv = srow[static_cast<size_t>(g) * L + pos];
        if (sv > kNegInf * 0.5f) p = expf(sv - sM[g]);
      }
      sP[idx] = p;
      any |= p != 0.f;
    }
    // a tile whose p are all 0 adds nothing to o or l: skip its V rows
    if (!__syncthreads_or(any)) continue;

#pragma unroll 4
    for (int j = ls; j < kTile; j += LS) {
      const int pos = t0 + j;
      if (pos >= L) break;
      float vf[V];
      repro::load16_f(v + ((static_cast<size_t>(b) * L + pos) * KV + kv) * D + dg * V, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sP[g * kTile + j];
        lsum[g] += p;
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();                    // sP is rewritten by the next tile
  }

  float* orow = o + static_cast<size_t>(bk) * G * D;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < V; ++e) sRed[ls * D + dg * V + e] = acc[g][e];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float t = 0.f;
      for (int r = 0; r < LS; ++r) t += sRed[r * D + d];
      orow[g * D + d] = t;
    }
    __syncthreads();
  }
  // every thread of a slot lane saw the same p; lane dg == 0 reports them
  if (dg == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) sRed[ls * G + g] = lsum[g];
  }
  __syncthreads();
  if (tid < G) {
    float t = 0.f;
    for (int r = 0; r < LS; ++r) t += sRed[r * G + tid];
    l[static_cast<size_t>(bk) * G + tid] = t;
  }
}

template <typename TV, int G>
cudaError_t launch(const void* s, const void* m, const void* v, void* o,
                   void* l, int B, int KV, int L, int D, cudaStream_t stream) {
  decode_stats_kernel<TV, G><<<B * KV, kThreads, 0, stream>>>(
      static_cast<const float*>(s), static_cast<const float*>(m),
      static_cast<const TV*>(v), static_cast<float*>(o), static_cast<float*>(l),
      KV, L, D);
  return cudaGetLastError();
}

template <typename TV>
cudaError_t dispatch_g(const void* s, const void* m, const void* v, void* o,
                       void* l, int B, int KV, int G, int L, int D,
                       cudaStream_t st) {
  switch (G) {  // llama3.2-3b (24 / 8 heads) and its smoke config (4 / 2)
    case 2: return launch<TV, 2>(s, m, v, o, l, B, KV, L, D, st);
    case 3: return launch<TV, 3>(s, m, v, o, l, B, KV, L, D, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// s (B,KV,G,L) fp32, m (B,KV,G) fp32, v (B,L,KV,D) of v_dtype,
// o (B,KV,G,D) fp32, l (B,KV,G) fp32; all contiguous. The caller checked
// that D / (16 / sizeof(v)) is a power of two dividing 256 and G is 2 or 3.
extern "C" int repro_decode_stats(const void* s, const void* m, const void* v,
                                  void* o, void* l, int B, int KV, int G,
                                  int L, int D, int v_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (v_dtype == repro::kFloat32)
    e = dispatch_g<float>(s, m, v, o, l, B, KV, G, L, D, st);
  else if (v_dtype == repro::kBFloat16)
    e = dispatch_g<__nv_bfloat16>(s, m, v, o, l, B, KV, G, L, D, st);
  return static_cast<int>(e);
}
