// Masked decode scores and their row max for Hopper (sm_90a).
//
// Replaces: src/repro/models/attention.py:126, decode_stats_scores, a jnp
// function that XLA fuses on the TPU (no Pallas kernel), and the row max
// the serve engine takes right after it. From q (B,1,H,D), the key cache
// k (B,L,KV,D) read in place, H = KV*G, and a position per row:
//   x = round_T(q . k[j]) * D^-0.5, then cap*tanh(x/cap) when cap > 0,
//   s[b,kv,g,j] = x for the slots the mask keeps (global slot off + j <=
//   pos, inside the window and the chunk of pos, the cache a shard holding
//   the global slots [off, off + L); on a ring cache of L <= window slots,
//   the slots [0, min(pos, L - 1)], of L <= chunk slots [0, min(pos mod
//   chunk, L - 1)]: common.cuh kept_interval) and NEG_INF for the others;
//   m[b,kv,g] = max_j s[b,kv,g,j].
// The dot is summed in fp32 and rounded to the cache dtype T before the
// scale, where the reference rounds (its einsum is in T, then cast to fp32).
//
// Bound on the H100: bytes. The live K rows (a masked slot's row is never
// read), q, and the writes of s and m; about one flop per byte, far below
// the card's ~295 flop/byte line. The CUDA cores suffice; what counts is
// enough 16-byte loads in flight on every SM.
//
// Design: grid (split, b*KV), the nsplit <= 8 blocks of a row one thread
// block cluster. The slots a row keeps form one interval [lo, hi]; each of
// the row's blocks takes an equal share of it, so a short live prefix still
// spreads over many SMs, and writes NEG_INF into the masked slots of its
// fixed share of L without touching K. A lane takes one slot: it reads the
// slot's K row in 16-byte vectors, kChunk of them in flight, and sums its
// G dot products against q, which the block holds in shared memory as fp32
// (every lane reads the same q value at once: a broadcast). A warp's lanes
// hold consecutive slots, so their stores of s are coalesced, and no lane
// waits on another: no shuffles. The cluster's first block reads the
// blocks' maxima from their shared memory into m: no scratch in device
// memory and no atomics. A max does not depend on order, so m is
// deterministic. Blocks of 128 threads keep every row's cluster resident
// in one wave.
// decode_sweep.py builds its variants of this kernel at the lines tagged
// "sweep:".
#include <cooperative_groups.h>
#include <math_constants.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;            // the portable cluster size
// at least 3 blocks an SM: a row's 8-block cluster and 64 rows fit in one
// wave, and ptxas, given the target, spills no register (left to itself
// it spilled a few in some instances to fit more blocks)
constexpr int kMinBlocks = 3;
constexpr int kMaxD = 256;
// sweep: kChunk
constexpr int kChunk = 8;               // 16-byte K vectors a lane has in flight

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const long long* __restrict__ pos, int pos_stride,
                     long long slot_offset, float* __restrict__ s,
                     float* __restrict__ m,
                     int KV, int L, int D, float scale, int window, int chunk,
                     int ring, float cap) {
  constexpr int V = 16 / sizeof(T);     // values per 16-byte vector
  __shared__ __align__(16) float sQ[G * kMaxD];
  __shared__ float sMax[kWarps][G];
  __shared__ float sBlockMax[G];        // read by the cluster's first block

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int row = blockIdx.y;           // b * KV + kv
  const int b = row / KV, kv = row % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int NV = D / V;                 // vectors per K row

  // the position first: the K addresses wait for it, q does not
  const long long p = pos[static_cast<long long>(b) * pos_stride];
  // q of heads kv*G .. kv*G + G - 1 into shared memory, fp32
  const T* qrow = q + static_cast<size_t>(row) * G * D;
  for (int idx = tid; idx < G * NV; idx += kThreads)
    repro::load16_f(qrow + idx * V, sQ + idx * V);

  // the interval [lo, hi] of slots the mask keeps
  long long lo, hi;
  repro::kept_interval(p, slot_offset, L, window, chunk, ring != 0, &lo, &hi);
  const int n = hi >= lo ? static_cast<int>(hi - lo + 1) : 0;

  // sweep: cut1
  // NEG_INF into the masked slots of this block's fixed share of L
  float* srow = s + static_cast<size_t>(row) * G * L;
  const int fr = (L + nsplit - 1) / nsplit;
  const int f0 = min(L, split * fr), f1 = min(L, f0 + fr), fn = f1 - f0;
  for (int idx = tid; idx < G * fn; idx += kThreads) {
    const int g = idx / fn, j = f0 + idx % fn;
    if (j < lo || j > hi) srow[static_cast<size_t>(g) * L + j] = kNegInf;
  }
  const bool any_masked = fn > 0 && (f0 < lo || f1 - 1 > hi);

  // sweep: cut2
  // this block's equal share [d0, d1) of the kept slots
  const int per = (n + nsplit - 1) / nsplit;
  const int d0 = static_cast<int>(lo) + min(n, split * per);
  const int d1 = static_cast<int>(lo) + min(n, (split + 1) * per);

  float mx[G];
#pragma unroll
  for (int g = 0; g < G; ++g) mx[g] = -CUDART_INF_F;
  __syncthreads();                      // sQ

  const T* kbase = k + (static_cast<size_t>(b) * L * KV + kv) * D;
  for (int j = d0 + tid; j < d1; j += kThreads) {
    const T* krow = kbase + static_cast<size_t>(j) * KV * D;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int c0 = 0; c0 < NV; c0 += kChunk) {
      uint4 raw[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c0 + c < NV) raw[c] = *reinterpret_cast<const uint4*>(krow + (c0 + c) * V);
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c0 + c >= NV) break;
        const T* e8 = reinterpret_cast<const T*>(&raw[c]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* qv = sQ + g * D + (c0 + c) * V;
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g] = fmaf(qv[e], repro::to_f<T>(e8[e]), acc[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float x = repro::to_f<T>(repro::from_f<T>(acc[g])) * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      mx[g] = fmaxf(mx[g], x);
      // sweep: no_store
      srow[static_cast<size_t>(g) * L + j] = x;
    }
  }

  // sweep: cut3
  // the block's max per head, then the row's, by the cluster's first block
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float t = repro::warp_max(mx[g]);
    if (lane == 0) sMax[warp][g] = t;
  }
  __syncthreads();
  if (tid < G) {
    float t = any_masked ? kNegInf : -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) t = fmaxf(t, sMax[w][tid]);
    sBlockMax[tid] = t;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < G) {
    float part[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)   // independent loads, all in flight
      part[r] = r < nsplit ? *cluster.map_shared_rank(&sBlockMax[tid], r)
                           : -CUDART_INF_F;
    float t = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) t = fmaxf(t, part[r]);
    m[static_cast<size_t>(row) * G + tid] = t;
  }
  cluster.sync();                       // the maxima stay until read
}

struct Args {
  const void *q, *k, *pos;
  int pos_stride;
  long long slot_offset;
  void *s, *m;
  int B, KV, L, D, nsplit;
  float scale;
  int window, chunk, ring;
  float cap;
};

template <typename T, int G>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.nsplit, a.B * a.KV);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.nsplit;  // a row's blocks: one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, decode_scores_kernel<T, G>, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const long long*>(a.pos),
      a.pos_stride, a.slot_offset, static_cast<float*>(a.s),
      static_cast<float*>(a.m), a.KV,
      a.L, a.D, a.scale, a.window, a.chunk, a.ring, a.cap);
}

template <typename T>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
#define REPRO_SCORES_G(g) \
  case g:                 \
    return launch<T, g>(a, st);
  switch (G) {
    REPRO_SCORES_G(1) REPRO_SCORES_G(2) REPRO_SCORES_G(3) REPRO_SCORES_G(4)
    REPRO_SCORES_G(5) REPRO_SCORES_G(6) REPRO_SCORES_G(7) REPRO_SCORES_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_SCORES_G
}

}  // namespace

// q (B,1,H,D) and k (B,L,KV,D) of dtype, contiguous and 16-byte aligned,
// H = KV*G; pos int64, pos_stride 0 (one position) or 1 (one per row);
// slot_offset the global slot of k's first (a cache shard's; 0 for a whole
// cache); ring 1 for a ring cache (kept_interval); s (B,KV,G,L) and m
// (B,KV,G) fp32. The caller checked 1 <= G <= 8, D a
// multiple of 8 up to 256, L >= 1, 1 <= nsplit <= 8 and B*KV <= 65535.
extern "C" int repro_decode_scores(const void* q, const void* k,
                                   const void* pos, int pos_stride,
                                   long long slot_offset, void* s, void* m,
                                   int B, int KV, int G, int L,
                                   int D, int nsplit, float scale, int window,
                                   int chunk, int ring, float cap, int dtype,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > kMaxSplit || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, pos, pos_stride, slot_offset, s, m, B, KV, L, D,
               nsplit, scale, window, chunk, ring, cap};
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_g<__nv_bfloat16>(G, a, st));
  if (dtype == repro::kFloat32)
    return static_cast<int>(dispatch_g<float>(G, a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
