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
// Bound on the H100: bytes. A step reads s (B*H*L fp32), the V rows whose p
// is not 0, and writes o and l; 2 flops per value element per query head,
// about one flop per byte. At decode sizes the time goes to the chain of
// dependent memory round trips a block makes, so the design keeps it short.
//
// Design: grid (split, b*KV), the nsplit <= 8 blocks of a row one thread
// block cluster: B*KV = 64 rows fill the 132 SMs in one wave (the TPU's
// sequential L axis becomes blocks in parallel). Given the row's position
// (the one its scores were masked with, with the global slot of the
// cache's first, a sequence-parallel shard's), a block takes an equal share of
// the slots the mask keeps, so no block touches the masked bulk of a long
// cache, and reads its first V rows while its scores are still on the way;
// without it (scores masked otherwise, the JAX package's contract), an
// equal share of L, and a 64-slot piece whose p are all 0 reads no V. A block turns its G x 64 scores into p in shared memory. A
// group of TPS lanes (a power of two: 16 for D = 128 bf16) reads one V row
// in 16-byte vectors, kU rows in flight per lane; the warp's groups and the
// block's warps take other slots, and every lane keeps G x 8 (bf16) or
// G x 4 (fp32, x2 past D = 128) fp32 sums in registers. The sums are
// reduced across a warp's groups by shuffles and across its warps through
// shared memory. The cluster's blocks then sum the blocks' partial (o, l),
// each a slice of the outputs, read from the blocks' shared memory in
// split order (skipping those whose l is 0): no scratch in device memory,
// no atomics, and a result that does not depend on the blocks' order.
// Blocks of 128 threads keep every row's cluster resident in one wave.
// decode_sweep.py builds its variants of this kernel at the lines tagged
// "sweep:".
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 64;                // slots turned into p at a time
constexpr int kMaxSplit = 8;            // the portable cluster size
// at least 3 blocks an SM: a row's 8-block cluster and 64 rows fit in one
// wave, and ptxas, given the target, spills no register (left to itself
// it spilled a few in some instances to fit more blocks)
constexpr int kMinBlocks = 3;
constexpr int kMaxD = 256;

// kU V rows into vf: slot lanes u*LS apart from ``slot``, rows the lane
// reads only where u*LS < left (zeros past it), each lane's VPL vectors
// from ``lane_v`` on, vec_step values apart, those with ok[c] set.
template <typename TV, int kU, int VPL>
__device__ __forceinline__ void load_rows(float (&vf)[kU][VPL][16 / sizeof(TV)],
                                          const TV* lane_v, int slot, int LS,
                                          int left, int row_stride,
                                          int vec_step, const bool (&ok)[VPL]) {
  constexpr int V = 16 / sizeof(TV);
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const TV* r = lane_v + (slot + u * LS) * row_stride;
#pragma unroll
    for (int c = 0; c < VPL; ++c) {
      if (u * LS < left && ok[c]) {
        repro::load16_f(r + c * vec_step, vf[u][c]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) vf[u][c][e] = 0.f;
      }
    }
  }
}

template <typename TV, int G, int VPL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
decode_stats_kernel(const float* __restrict__ s, const float* __restrict__ m,
                    const TV* __restrict__ v,
                    const long long* __restrict__ pos, int pos_stride,
                    long long slot_offset, int window, int chunk, int ring,
                    float* __restrict__ o,
                    float* __restrict__ l, int KV, int L, int D,
                    int tps_log2) {
  constexpr int V = 16 / sizeof(TV);
  // sweep: kU
  constexpr int kU = G <= 4 ? 8 : 4;    // V rows a lane has in flight
  // the cross-warp reduction buffer: kWarps x GC heads x D
  constexpr int kRed = kWarps * (G < 4 ? G : 4) * kMaxD;
  __shared__ float sP[G * kSub];
  __shared__ float sRed[kRed];
  __shared__ float sM[G];
  __shared__ float sL[kWarps][G];
  __shared__ float sPartO[G * kMaxD];   // this block's partial o and l,
  __shared__ float sPartL[G];           // read by the cluster's blocks
  __shared__ float sLAll[kMaxSplit * G];  // every block's partial l

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int row = blockIdx.y;           // b * KV + kv
  const int b = row / KV, kv = row % KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TPS = 1 << tps_log2;        // lanes per V row
  const int li = lane & (TPS - 1);
  const int gi = lane >> tps_log2;
  const int groups = 32 >> tps_log2;
  const int LS = kWarps * groups;       // V rows the block reads at once
  const int ls = warp * groups + gi;
  const int NV = D / V;
  const bool hinted = pos != nullptr;   // every slot of the share is kept

  if (tid < G) sM[tid] = m[static_cast<size_t>(row) * G + tid];
  // this block's equal share [t0, t1) of the slots kept (or of L)
  long long lo = 0, hi = L - 1;
  if (hinted)
    repro::kept_interval(pos[static_cast<long long>(b) * pos_stride],
                         slot_offset, L, window, chunk, ring != 0, &lo, &hi);
  const int n_kept = hi >= lo ? static_cast<int>(hi - lo + 1) : 0;
  const int per = (n_kept + nsplit - 1) / nsplit;
  const int t0 = static_cast<int>(lo) + min(n_kept, split * per);
  const int t1 = static_cast<int>(lo) + min(n_kept, (split + 1) * per);
  // sweep: cut1
  const float* srow = s + static_cast<size_t>(row) * G * L;
  // this lane's first value of V row 0 of (b, kv); its vectors li + c*TPS
  const TV* lane_v = v + (static_cast<size_t>(b) * L * KV + kv) * D + li * V;
  const int row_stride = KV * D;        // slot to slot (the caller checked
                                        // L * KV * D < 2^31)
  bool ok[VPL];
#pragma unroll
  for (int c = 0; c < VPL; ++c) ok[c] = li + c * TPS < NV;

  float acc[G][VPL][V], lsum[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lsum[g] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][c][e] = 0.f;
  }

  float vf[kU][VPL][V];
  bool live = false;                    // the same in every thread
  __syncthreads();                      // sM
  for (int sub0 = t0; sub0 < t1; sub0 += kSub) {
    const int n = min(kSub, t1 - sub0);
    if (hinted)                         // in flight beside the scores
      load_rows<TV, kU, VPL>(vf, lane_v, sub0 + ls, LS, n - ls, row_stride,
                             TPS * V, ok);
    int any = 0;
    for (int idx = tid; idx < G * kSub; idx += kThreads) {
      const int g = idx / kSub, jj = idx % kSub;
      float p = 0.f;
      if (jj < n) {
        const float sv = srow[static_cast<size_t>(g) * L + sub0 + jj];
        if (sv > kNegInf * 0.5f) p = expf(sv - sM[g]);
      }
      sP[idx] = p;
      any |= p != 0.f;
    }
    // a piece whose p are all 0 adds nothing to o or l: skip its V rows
    if (!__syncthreads_or(any)) continue;
    live = true;
    for (int j0 = ls; j0 < n; j0 += kU * LS) {
      if (!hinted || j0 != ls)
        load_rows<TV, kU, VPL>(vf, lane_v, sub0 + j0, LS, n - j0, row_stride,
                               TPS * V, ok);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int jj = j0 + u * LS;
        if (jj >= n) break;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = sP[g * kSub + jj];
          lsum[g] += p;
#pragma unroll
          for (int c = 0; c < VPL; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e)
              // sweep: no_fma
              acc[g][c][e] = fmaf(p, vf[u][c][e], acc[g][c][e]);
        }
      }
    }
    __syncthreads();                    // sP is rewritten by the next piece
  }

  // sweep: cut2
  if (!live) {
    if (tid < G) sPartL[tid] = 0.f;     // nothing kept; sPartO is not read
  } else {
    // across the groups of a warp
    for (int off = TPS; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        lsum[g] += __shfl_xor_sync(0xffffffffu, lsum[g], off);
#pragma unroll
        for (int c = 0; c < VPL; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[g][c][e] += __shfl_xor_sync(0xffffffffu, acc[g][c][e], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) sL[warp][g] = lsum[g];
    }
    // across the warps, GC heads at a time
    const int GC = min(G, kRed / (kWarps * D));
    for (int g0 = 0; g0 < G; g0 += GC) {
      const int gn = min(GC, G - g0);
      if (gi == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g < g0 || g >= g0 + gn) continue;
#pragma unroll
          for (int c = 0; c < VPL; ++c) {
            const int vec = li + c * TPS;
            if (vec >= NV) continue;
#pragma unroll
            for (int e = 0; e < V; ++e)
              sRed[(warp * GC + g - g0) * D + vec * V + e] = acc[g][c][e];
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < gn * D; idx += kThreads) {
        float t = 0.f;
        for (int w = 0; w < kWarps; ++w) t += sRed[w * GC * D + idx];
        sPartO[g0 * D + idx] = t;
      }
      __syncthreads();                  // sRed is rewritten by the next heads
    }
    if (tid < G) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += sL[w][tid];
      sPartL[tid] = t;
    }
  }

  // sweep: cut3
  // the cluster's blocks sum the partials in split order, each a slice of
  // the G x D outputs, every block's partials read from its shared memory
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  if (tid < nsplit * G)
    sLAll[tid] = *cluster.map_shared_rank(&sPartL[tid % G], tid / G);
  __syncthreads();
  const int slice = (G * D + nsplit - 1) / nsplit;
  for (int idx = rank * slice + tid; idx < min(G * D, (rank + 1) * slice);
       idx += kThreads) {
    const int g = idx / D;
    float part[kMaxSplit];
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r)   // independent loads, all in flight
      part[r] = r < nsplit && sLAll[r * G + g] != 0.f
                    ? *cluster.map_shared_rank(&sPartO[idx], r) : 0.f;
    float t = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplit; ++r) t += part[r];
    o[static_cast<size_t>(row) * G * D + idx] = t;
  }
  if (rank == 0 && tid < G) {
    float t = 0.f;
    for (int r = 0; r < nsplit; ++r) t += sLAll[r * G + tid];
    l[static_cast<size_t>(row) * G + tid] = t;
  }
  cluster.sync();                       // the partials stay until read
}

struct Args {
  const void *s, *m, *v, *pos;
  int pos_stride;
  long long slot_offset;
  int window, chunk, ring;
  void *o, *l;
  int B, KV, L, D, nsplit, tps_log2;
};

template <typename TV, int G, int VPL>
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
      &cfg, decode_stats_kernel<TV, G, VPL>, static_cast<const float*>(a.s),
      static_cast<const float*>(a.m), static_cast<const TV*>(a.v),
      static_cast<const long long*>(a.pos), a.pos_stride, a.slot_offset,
      a.window, a.chunk, a.ring,
      static_cast<float*>(a.o), static_cast<float*>(a.l), a.KV, a.L, a.D,
      a.tps_log2);
}

template <typename TV, int VPL>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
#define REPRO_STATS_G(g) \
  case g:                \
    return launch<TV, g, VPL>(a, st);
  switch (G) {
    REPRO_STATS_G(1) REPRO_STATS_G(2) REPRO_STATS_G(3) REPRO_STATS_G(4)
    REPRO_STATS_G(5) REPRO_STATS_G(6) REPRO_STATS_G(7) REPRO_STATS_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_STATS_G
}

int tps_log2_of(int nv, int vpl) {
  int t = 0;
  while ((1 << t) * vpl < nv) ++t;
  return t;
}

}  // namespace

// s (B,KV,G,L) fp32, m (B,KV,G) fp32, v (B,L,KV,D) of v_dtype (16-byte
// aligned), o (B,KV,G,D) fp32, l (B,KV,G) fp32, all contiguous; pos int64
// with pos_stride 0 (one position) or 1 (one per row), the position s was
// masked with under window, chunk and ring (a ring cache, kept_interval),
// the cache a shard holding the global slots [slot_offset, slot_offset +
// L), or null (every slot may be kept).
// The caller checked 1 <= G <= 8, D a multiple of 8 up to 256, L >= 1,
// 1 <= nsplit <= 8 and B*KV <= 65535.
extern "C" int repro_decode_stats(const void* s, const void* m, const void* v,
                                  const void* pos, int pos_stride,
                                  long long slot_offset, int window,
                                  int chunk, int ring, void* o, void* l,
                                  int B, int KV,
                                  int G, int L, int D, int nsplit,
                                  int v_dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nsplit < 1 || nsplit > kMaxSplit || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{s, m, v, pos, pos_stride, slot_offset, window, chunk, ring, o, l, B,
         KV, L, D, nsplit, 0};
  if (v_dtype == repro::kBFloat16) {
    a.tps_log2 = tps_log2_of(D / 8, 1);
    return static_cast<int>(dispatch_g<__nv_bfloat16, 1>(G, a, st));
  }
  if (v_dtype == repro::kFloat32) {
    const int nv = D / 4;
    if (nv <= 32) {
      a.tps_log2 = tps_log2_of(nv, 1);
      return static_cast<int>(dispatch_g<float, 1>(G, a, st));
    }
    a.tps_log2 = tps_log2_of(nv, 2);
    return static_cast<int>(dispatch_g<float, 2>(G, a, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
