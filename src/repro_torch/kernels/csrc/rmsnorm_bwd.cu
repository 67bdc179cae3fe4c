// RMSNorm backward for Hopper (sm_90a), plain, residual and gated forms.
//
// Replaces: no TPU kernel. The JAX package trains through plain jnp RMSNorm
// differentiated by XLA (src/repro/models/layers.py, rmsnorm); the port's
// training forward is the kernel of rmsnorm.cu (replacing
// src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel), and this is that
// kernel's backward. For y = x * rstd * (1 + scale), rstd = rsqrt(mean(x^2)
// + eps), per row with g = dy * (1 + scale) and x^ = x * rstd:
//   dx     = rstd * (g - x^ * mean(g * x^))
//   dscale = sum over rows of dy * x^
// all in fp32, dx rounded to x's dtype. The residual form's input is the
// sum s = x + delta; the gradient of its s output (ds, when given) is added
// to dx as the eager add would (dx rounded first, then the sum rounded), and
// the result is the gradient of both x and delta. The gated form (the
// Mamba2 mixer's gate and norm, rmsnorm.cu's third form) normalises g =
// round(round(y) * round(silu(z))), recomputed per row from y (fp32) and z
// as the forward rounds it; from its dg, dy = dg silu(z) (fp32) and dz =
// dg round(y) silu'(z), silu'(z) = sigmoid(z) (1 + z (1 - sigmoid(z))),
// rounded to z's dtype.
//
// Bound on the H100: memory. At the llama3.2-3b training shape (4,096 rows
// of 3,072, bf16) the rows read x and dy and write dx, 75.5 MB, 22.5 us at
// 3.35 TB/s; at one FSDP rank's 1,024 rows 18.9 MB, 5.6 us. The gated form
// at mamba2-780m's (4,096 rows of 3,072) reads y (fp32), z and dout and
// writes dy (fp32) and dz, 176 MB, 52.6 us.
//
// Design: one launch a backward (redesigned from two: a rows kernel in
// blocks of 16 rows, 64 blocks at 1,024 rows with a block-wide barrier a
// row, and a second pass of 12 blocks for the dscale column sums, each
// thread summing 64 partials one load after another). Blocks of 256
// threads in clusters of 8, as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters: a cluster left for a second wave would
// double the time), two blocks an SM (at most 264; one where a thread
// holds more than 12 values of a row, which two would not fit in
// registers): 1,024 rows fill the blocks, one row a block at a time, rows
// strided over the blocks. A thread loads its columns of the row's x, dy
// and ds at once, 4 values an access (8 bytes of bf16, 16 of fp32; 1 when
// d % 4 != 0 or a row start is not aligned), and keeps them in registers;
// where two blocks fit an SM (rows of 3,072) the next row's loads are in
// flight while the current row is reduced and stored. The row's two sums
// need one barrier (the warps' sums double-buffered in shared memory), and
// each thread sums its columns' dy * x^ over its block's rows in registers.
// The dscale sums: the cluster's 8 blocks put their partials in shared
// memory and each sums one eighth of the columns over the 8 partials,
// through distributed shared memory in block order, into the cluster's
// partial in device memory; then a counter per eighth of the columns picks
// the cluster that finishes that eighth last, and its block sums the
// eighth over the clusters' partials in cluster order (32 loads in flight
// at a time) and writes dscale, and sets the counter back to 0 for the
// next launch. The cluster's second barrier is split (arrive after the
// reads of the other blocks' partials, wait before exit), so it is not on
// the path to dscale. No atomics in a sum: the counters only pick who
// sums, the order is fixed, so two calls are bitwise equal. The counters
// (8 ints) belong to the caller, zero before the first launch, and stay
// zero between launches; launches that share them must run one after
// another (the wrapper keeps a set per stream). Three blocks an SM, and no
// next-row loads in flight, were measured slower (PERF.md).
//
// The gated form split over a model tier (each rank holds d_inner / m
// columns of every row; rmsnorm.cu's two-launch forward): a row's two sums
// span the whole row, so the backward takes two launches with the tier's
// sum between them. rmsnorm_gated_rowdot_kernel writes each row's fp32
// sum of dout * (1 + scale) * g over the rank's columns (one block a row);
// the caller sums that over the tier; then the gated kernel below runs
// with the rows' totals given (row_ss, the forward's summed squares, and
// row_dot), dividing by the full row's width d_norm, and skips its own
// row reductions. Its dscale is the rank's columns', complete: every rank
// holds every row.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;            // blocks a cluster, eighths of dscale
constexpr int kMaxBlocks = 264;        // two an SM of 132
static_assert(kMaxBlocks % kCluster == 0, "whole clusters");
constexpr int kMaxD = 8192;
int g_last_blocks = 0;                 // the grid of the last launch

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// V values of T as one access, kept packed in registers until used
template <typename T, int V>
struct Raw {
  using type = T;
};
template <>
struct Raw<float, 4> {
  using type = float4;
};
template <>
struct Raw<__nv_bfloat16, 4> {
  using type = uint2;
};

template <typename T, int V>
__device__ __forceinline__ void unpack_v(const typename Raw<T, V>::type& r,
                                         float* out) {
  if constexpr (V == 1) {
    out[0] = to_f(r);
  } else if constexpr (sizeof(T) == 4) {
    out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
  } else {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = to_f(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* __restrict__ p, const float* v) {
  if constexpr (V == 1) {
    p[0] = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {                              // bf16, rounded to nearest even
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 r;
    r.x = *reinterpret_cast<const uint32_t*>(&lo);
    r.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = r;
  }
}


// the blocks of a launch: one a row, rounded up to whole clusters, at most
// the clusters that the card holds at once (a cluster left for a second
// wave would double the time) and kMaxBlocks
inline int grid_blocks(long long rows, int max_clusters) {
  long long cap = static_cast<long long>(max_clusters) * kCluster;
  if (cap > kMaxBlocks) cap = kMaxBlocks;
  if (cap < kCluster) cap = kCluster;
  const long long nb = (rows + kCluster - 1) / kCluster * kCluster;
  return static_cast<int>(nb < cap ? nb : cap);
}

// one row's values of a thread, as loaded (packed until used): V values a
// unit, NU units, thread t holding columns (t + kThreads * u) * V + e
template <typename TX, int V, int NU>
struct RowRaw {
  typename Raw<TX, V>::type x[NU], dy[NU], ds[NU];
};

template <typename TX, int V, int NU>
__device__ __forceinline__ void load_row(RowRaw<TX, V, NU>& r,
                                         const TX* __restrict__ x,
                                         const TX* __restrict__ dy,
                                         const TX* __restrict__ ds,
                                         size_t base, int d, int tid) {
  using R = typename Raw<TX, V>::type;
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = (tid + kThreads * u) * V;
    if (col < d) {
      r.x[u] = *reinterpret_cast<const R*>(x + base + col);
      r.dy[u] = *reinterpret_cast<const R*>(dy + base + col);
      if (ds != nullptr) r.ds[u] = *reinterpret_cast<const R*>(ds + base + col);
    }
  }
}

// dscale from every block's partial (part, a thread's columns of the rows
// it took): the cluster's 8 blocks through distributed shared memory (sPart,
// kMaxD floats of each block), then the cluster that finishes an eighth of
// the columns last sums it over the clusters' partials; see the file's note
template <typename TS, int V, int NU>
__device__ __forceinline__ void scale_sums(const float (&part)[V * NU],
                                           float* sPart, int* sLast,
                                           TS* __restrict__ dscale,
                                           float* __restrict__ partial,
                                           int* __restrict__ counters, int d,
                                           int tid) {
  cg::cluster_group cluster = cg::this_cluster();
  // the cluster's partial: block `rank` sums its eighth of the columns over
  // the 8 blocks' partials, in block order
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = (tid + kThreads * u) * V;
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (col + e < d) sPart[col + e] = part[u * V + e];
  }
  cluster.sync();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = gridDim.x / kCluster, cl = blockIdx.x / kCluster;
  const int c_lo = rank * d / kCluster, c_hi = (rank + 1) * d / kCluster;
  for (int col = c_lo + tid; col < c_hi; col += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      acc += *cluster.map_shared_rank(&sPart[col], r);
    partial[static_cast<size_t>(cl) * d + col] = acc;
  }
  // this block's reads of the others' partials are done; the others may
  // exit once every block has arrived (waited for at the end)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __threadfence();

  // the cluster that finishes this eighth last sums it over the clusters
  __syncthreads();
  if (tid == 0) *sLast = atomicAdd(&counters[rank], 1) == ncl - 1;
  __syncthreads();
  if (*sLast) {
    __threadfence();
    constexpr int kBatch = 32;            // loads in flight together
    for (int col = c_lo + tid; col < c_hi; col += kThreads) {
      float acc = 0.f;
      for (int k0 = 0; k0 < ncl; k0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          v[k] = k0 + k < ncl
                     ? __ldcg(&partial[static_cast<size_t>(k0 + k) * d + col])
                     : 0.f;
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (k0 + k < ncl) acc += v[k];
      }
      dscale[col] = from_f<TS>(acc);
    }
    if (tid == 0) counters[rank] = 0;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <typename TX, typename TS, int V, int NU>
__global__ void __launch_bounds__(kThreads, V * NU <= 12 ? 2 : 1)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   const TX* __restrict__ dy, const TX* __restrict__ ds,
                   TX* __restrict__ dx, TS* __restrict__ dscale,
                   float* __restrict__ partial, int* __restrict__ counters,
                   long long rows, int d, float eps) {
  constexpr int NPT = V * NU;            // values of a row a thread
  __shared__ float red[2][2][kWarps];        // double-buffered warp sums
  __shared__ float sPart[kMaxD];             // this block's dscale partial
  __shared__ int sLast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float sc[NPT], part[NPT];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = (tid + kThreads * u) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sc[u * V + e] = col + e < d ? 1.f + to_f(scale[col + e]) : 0.f;
      part[u * V + e] = 0.f;
    }
  }

  // rows strided over the blocks; the next row's loads are in flight while
  // this one is reduced, normalised and stored, where a row's values fit
  // two blocks an SM (12 a thread: 3,072 wide); wider rows take one block
  // an SM and load the row when they come to it
  constexpr bool kPrefetch = NPT <= 12;
  RowRaw<TX, V, NU> nxt;
  long long row = blockIdx.x;
  if (kPrefetch && row < rows)
    load_row<TX, V, NU>(nxt, x, dy, ds, static_cast<size_t>(row) * d, d, tid);
  int buf = 0;
  for (; row < rows; row += gridDim.x) {
    RowRaw<TX, V, NU> cur;
    if constexpr (kPrefetch) {
      cur = nxt;
      if (row + gridDim.x < rows)
        load_row<TX, V, NU>(nxt, x, dy, ds,
                            static_cast<size_t>(row + gridDim.x) * d, d, tid);
    } else {
      load_row<TX, V, NU>(cur, x, dy, ds, static_cast<size_t>(row) * d, d,
                          tid);
    }
    float xv[NPT], dyv[NPT];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (tid + kThreads * u) * V;
      if (col < d) {
        unpack_v<TX, V>(cur.x[u], &xv[u * V]);
        unpack_v<TX, V>(cur.dy[u], &dyv[u * V]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) xv[u * V + e] = dyv[u * V + e] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      ss = fmaf(xv[j], xv[j], ss);
      gx = fmaf(dyv[j] * sc[j], xv[j], gx);
    }
    ss = repro::warp_sum(ss);
    gx = repro::warp_sum(gx);
    if (lane == 0) {
      red[buf][0][warp] = ss;
      red[buf][1][warp] = gx;
    }
    // one barrier a row: the next row writes the other buffer, and the one
    // after waits at the next barrier for every read of this one
    __syncthreads();
    ss = gx = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ss += red[buf][0][w];
      gx += red[buf][1][w];
    }
    buf ^= 1;
    const float rstd = rsqrtf(ss / d + eps);
    const float c = rstd * rstd * rstd * gx / d;   // rstd * mean(g * x^)
    const size_t base = static_cast<size_t>(row) * d;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (tid + kThreads * u) * V;
      if (col >= d) continue;
      float out[V], dsv[V];
      if (ds != nullptr) unpack_v<TX, V>(cur.ds[u], dsv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = u * V + e;
        out[e] = rstd * dyv[j] * sc[j] - xv[j] * c;
        if (ds != nullptr) out[e] = rnd<TX>(out[e]) + dsv[e];
        part[j] = fmaf(dyv[j], xv[j] * rstd, part[j]);
      }
      store_v<TX, V>(dx + base + col, out);
    }
  }

  scale_sums<TS, V, NU>(part, sPart, &sLast, dscale, partial, counters, d,
                        tid);
}

// the split gated form's first backward launch: row_dot[row] = sum over
// the row's d columns of dout * (1 + scale) * g, g recomputed as the forward
// rounds it; one block a row, V values an access (4 where `vec`, else 1)
template <typename TX, typename TS, int V>
__global__ void __launch_bounds__(kThreads)
rmsnorm_gated_rowdot_kernel(const float* __restrict__ y, long long ld_y,
                            const TX* __restrict__ z, long long ld_z,
                            const TS* __restrict__ scale,
                            const TX* __restrict__ dout,
                            float* __restrict__ row_dot, int d) {
  using RY = typename Raw<float, V>::type;
  using RX = typename Raw<TX, V>::type;
  using RS = typename Raw<TS, V>::type;
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.x;
  float acc = 0.f;
  for (int col = tid * V; col < d; col += kThreads * V) {
    float yv[V], zv[V], sv[V], dv[V];
    unpack_v<float, V>(*reinterpret_cast<const RY*>(y + row * ld_y + col), yv);
    unpack_v<TX, V>(*reinterpret_cast<const RX*>(z + row * ld_z + col), zv);
    unpack_v<TS, V>(*reinterpret_cast<const RS*>(scale + col), sv);
    unpack_v<TX, V>(*reinterpret_cast<const RX*>(dout + row * d + col), dv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float silu = rnd<TX>(zv[e] / (1.f + expf(-zv[e])));
      const float g = rnd<TX>(rnd<TX>(yv[e]) * silu);
      acc = fmaf(dv[e] * (1.f + sv[e]), g, acc);
    }
  }
  acc = repro::warp_sum(acc);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += red[w];
    row_dot[row] = t;
  }
}

// the gated form: g = round(round(y) * round(silu(z))) recomputed per row
// as the forward rounds it (y fp32 rows of stride ld_y, z rows of stride
// ld_z), dg from the rows' math above, then dy = dg silu(z) (fp32) and dz =
// dg round(y) silu'(z) with silu'(z) = sigmoid(z) (1 + z (1 - sigmoid(z)));
// dscale from the same partial sums. No next-row loads in flight. With
// row_ss non-null (the split form's finish) the row's sum of g^2 and of
// dout (1 + scale) g are row_ss[row] and row_dot[row], over d_norm
// columns, and the kernel takes no row reduction of its own.
template <typename TX, typename TS, int V, int NU>
__global__ void __launch_bounds__(kThreads, V * NU <= 12 ? 2 : 1)
rmsnorm_gated_bwd_kernel(const float* __restrict__ y, long long ld_y,
                         const TX* __restrict__ z, long long ld_z,
                         const TS* __restrict__ scale,
                         const TX* __restrict__ dout, float* __restrict__ dy,
                         TX* __restrict__ dz, TS* __restrict__ dscale,
                         float* __restrict__ partial,
                         int* __restrict__ counters,
                         const float* __restrict__ row_ss,
                         const float* __restrict__ row_dot, long long rows,
                         int d, int d_norm, float eps) {
  constexpr int NPT = V * NU;
  using RY = typename Raw<float, V>::type;
  using RX = typename Raw<TX, V>::type;
  __shared__ float red[2][2][kWarps];
  __shared__ float sPart[kMaxD];
  __shared__ int sLast;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float sc[NPT], part[NPT];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
    const int col = (tid + kThreads * u) * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sc[u * V + e] = col + e < d ? 1.f + to_f(scale[col + e]) : 0.f;
      part[u * V + e] = 0.f;
    }
  }
  int buf = 0;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    float yr[NPT], zv[NPT], gv[NPT], dov[NPT];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (tid + kThreads * u) * V;
      if (col < d) {
        unpack_v<float, V>(*reinterpret_cast<const RY*>(y + row * ld_y + col),
                           &yr[u * V]);
        unpack_v<TX, V>(*reinterpret_cast<const RX*>(z + row * ld_z + col),
                        &zv[u * V]);
        unpack_v<TX, V>(*reinterpret_cast<const RX*>(dout + row * d + col),
                        &dov[u * V]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          yr[u * V + e] = zv[u * V + e] = dov[u * V + e] = 0.f;
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      yr[j] = rnd<TX>(yr[j]);
      const float silu = rnd<TX>(zv[j] / (1.f + expf(-zv[j])));
      gv[j] = rnd<TX>(yr[j] * silu);
      ss = fmaf(gv[j], gv[j], ss);
      gx = fmaf(dov[j] * sc[j], gv[j], gx);
    }
    if (row_ss != nullptr) {          // the split form: the tier's sums
      ss = row_ss[row];
      gx = row_dot[row];
    } else {
      ss = repro::warp_sum(ss);
      gx = repro::warp_sum(gx);
      if (lane == 0) {
        red[buf][0][warp] = ss;
        red[buf][1][warp] = gx;
      }
      __syncthreads();                // one barrier a row, as the plain form
      ss = gx = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        ss += red[buf][0][w];
        gx += red[buf][1][w];
      }
      buf ^= 1;
    }
    const float rstd = rsqrtf(ss / d_norm + eps);
    const float c = rstd * rstd * rstd * gx / d_norm;   // rstd * mean(dg^ g^)
    const size_t base = static_cast<size_t>(row) * d;
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int col = (tid + kThreads * u) * V;
      if (col >= d) continue;
      float oy[V], oz[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = u * V + e;
        const float dg = rstd * dov[j] * sc[j] - gv[j] * c;
        part[j] = fmaf(dov[j], gv[j] * rstd, part[j]);
        const float sig = 1.f / (1.f + expf(-zv[j]));
        oy[e] = dg * (zv[j] * sig);
        oz[e] = dg * yr[j] * sig * (1.f + zv[j] * (1.f - sig));
      }
      store_v<float, V>(dy + base + col, oy);
      store_v<TX, V>(dz + base + col, oz);
    }
  }
  scale_sums<TS, V, NU>(part, sPart, &sLast, dscale, partial, counters, d,
                        tid);
}

// one cluster launch of `kernel` over `rows` rows: as many clusters as the
// card holds at once (asked once per device and kernel instance)
template <auto kernel, typename... Args>
cudaError_t launch_clusters(long long rows, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int max_clusters[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && max_clusters[dev] == 0) {
    cfg.gridDim = dim3(kMaxBlocks);
    e = cudaOccupancyMaxActiveClusters(&max_clusters[dev], kernel, &cfg);
  }
  if (e != cudaSuccess) return e;
  cfg.gridDim = dim3(grid_blocks(rows, max_clusters[dev]));
  g_last_blocks = static_cast<int>(cfg.gridDim.x);
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// f(V, NU) for the widths the kernels are built for: 4 values an access
// where `vec`, else 1; NU units of kThreads * V columns cover d
template <typename F>
cudaError_t pick_width(bool vec, int d, F&& f) {
  using std::integral_constant;
  if (vec) {
    const int units = (d / 4 + kThreads - 1) / kThreads;
    if (units <= 1) return f(integral_constant<int, 4>{}, integral_constant<int, 1>{});
    if (units <= 2) return f(integral_constant<int, 4>{}, integral_constant<int, 2>{});
    if (units <= 3) return f(integral_constant<int, 4>{}, integral_constant<int, 3>{});
    if (units <= 4) return f(integral_constant<int, 4>{}, integral_constant<int, 4>{});
    return f(integral_constant<int, 4>{}, integral_constant<int, 8>{});
  }
  const int units = (d + kThreads - 1) / kThreads;
  if (units <= 1) return f(integral_constant<int, 1>{}, integral_constant<int, 1>{});
  if (units <= 2) return f(integral_constant<int, 1>{}, integral_constant<int, 2>{});
  if (units <= 4) return f(integral_constant<int, 1>{}, integral_constant<int, 4>{});
  if (units <= 8) return f(integral_constant<int, 1>{}, integral_constant<int, 8>{});
  if (units <= 16) return f(integral_constant<int, 1>{}, integral_constant<int, 16>{});
  return f(integral_constant<int, 1>{}, integral_constant<int, 32>{});
}

inline bool aligned(const void* p, uintptr_t a) {
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

template <typename TX, typename TS>
cudaError_t dispatch_width(const void* x, const void* scale, const void* dy,
                           const void* ds, void* dx, void* dscale,
                           float* partial, int* counters, long long rows,
                           int d, float eps, cudaStream_t stream) {
  // 4 values an access when d and every row start allow it
  const uintptr_t a = 4 * sizeof(TX);
  const bool vec = d % 4 == 0 && aligned(x, a) && aligned(dy, a) &&
                   aligned(dx, a) && (ds == nullptr || aligned(ds, a));
  return pick_width(vec, d, [&](auto v, auto nu) {
    constexpr int V = decltype(v)::value, NU = decltype(nu)::value;
    return launch_clusters<rmsnorm_bwd_kernel<TX, TS, V, NU>>(
        rows, stream, static_cast<const TX*>(x), static_cast<const TS*>(scale),
        static_cast<const TX*>(dy), static_cast<const TX*>(ds),
        static_cast<TX*>(dx), static_cast<TS*>(dscale), partial, counters,
        rows, d, eps);
  });
}

template <typename TX, typename TS>
cudaError_t dispatch_gated(const void* y, long long ld_y, const void* z,
                           long long ld_z, const void* scale,
                           const void* dout, void* dy, void* dz,
                           void* dscale, float* partial, int* counters,
                           const float* row_ss, const float* row_dot,
                           long long rows, int d, int d_norm, float eps,
                           cudaStream_t stream) {
  const uintptr_t a = 4 * sizeof(TX);
  const bool vec = d % 4 == 0 && ld_y % 4 == 0 && ld_z % 4 == 0 &&
                   aligned(y, 16) && aligned(dy, 16) && aligned(z, a) &&
                   aligned(dout, a) && aligned(dz, a);
  return pick_width(vec, d, [&](auto v, auto nu) {
    constexpr int V = decltype(v)::value, NU = decltype(nu)::value;
    return launch_clusters<rmsnorm_gated_bwd_kernel<TX, TS, V, NU>>(
        rows, stream, static_cast<const float*>(y), ld_y,
        static_cast<const TX*>(z), ld_z, static_cast<const TS*>(scale),
        static_cast<const TX*>(dout), static_cast<float*>(dy),
        static_cast<TX*>(dz), static_cast<TS*>(dscale), partial, counters,
        row_ss, row_dot, rows, d, d_norm, eps);
  });
}

template <typename TX, typename TS>
cudaError_t dispatch_rowdot(const void* y, long long ld_y, const void* z,
                            long long ld_z, const void* scale,
                            const void* dout, float* row_dot, long long rows,
                            int d, cudaStream_t stream) {
  const uintptr_t a = 4 * sizeof(TX);
  const bool vec = d % 4 == 0 && ld_y % 4 == 0 && ld_z % 4 == 0 &&
                   aligned(y, 16) && aligned(z, a) && aligned(dout, a) &&
                   aligned(scale, 4 * sizeof(TS));
  const dim3 grid(static_cast<unsigned>(rows));
  const float* yf = static_cast<const float*>(y);
  const TX* zx = static_cast<const TX*>(z);
  const TS* sc = static_cast<const TS*>(scale);
  const TX* dx = static_cast<const TX*>(dout);
  if (vec)
    rmsnorm_gated_rowdot_kernel<TX, TS, 4><<<grid, kThreads, 0, stream>>>(
        yf, ld_y, zx, ld_z, sc, dx, row_dot, d);
  else
    rmsnorm_gated_rowdot_kernel<TX, TS, 1><<<grid, kThreads, 0, stream>>>(
        yf, ld_y, zx, ld_z, sc, dx, row_dot, d);
  return cudaGetLastError();
}

// fn.template operator()<TX, TS>() for the dtype codes, else
// cudaErrorInvalidValue
template <typename F>
cudaError_t by_dtypes(int x_dtype, int scale_dtype, F&& fn) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    return fn(float{}, float{});
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    return fn(float{}, bf16{});
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    return fn(bf16{}, float{});
  if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    return fn(bf16{}, bf16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx (and ds, null for the plain form) rows x d in x's dtype,
// contiguous; scale and dscale (d,) in the scale's dtype; partial
// (repro_rmsnorm_bwd_partial_rows(), d) fp32 scratch for the clusters'
// dscale partials;
// counters 8 ints, zero (they are zero again when the launch ends). 1 <= d
// <= 8,192.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, const void* ds, void* dx,
                                 void* dscale, void* partial, void* counters,
                                 long long rows, int d, float eps,
                                 int x_dtype, int scale_dtype, void* stream) {
  if (d < 1 || d > kMaxD || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = by_dtypes(x_dtype, scale_dtype, [&](auto tx, auto ts) {
    return dispatch_width<decltype(tx), decltype(ts)>(
        x, scale, dy, ds, dx, dscale, static_cast<float*>(partial),
        static_cast<int*>(counters), rows, d, eps,
        static_cast<cudaStream_t>(stream));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The gated form: y fp32 rows of stride ld_y, z rows of stride ld_z in z's
// dtype (x_dtype), dout rows x d in z's dtype, contiguous; writes dy (rows x
// d fp32), dz (rows x d in z's dtype) and dscale; partial and counters as
// above. 1 <= d <= 8,192. row_ss and row_dot null: the whole row; else the
// split form's finish, their (rows,) fp32 totals over d_norm columns
// (row_ss the forward's summed squares, row_dot the tier's sum of
// repro_rmsnorm_gated_rowdot's).
extern "C" int repro_rmsnorm_gated_bwd(const void* y, long long ld_y,
                                       const void* z, long long ld_z,
                                       const void* scale, const void* dout,
                                       void* dy, void* dz, void* dscale,
                                       void* partial, void* counters,
                                       const void* row_ss,
                                       const void* row_dot, long long rows,
                                       int d, int d_norm, float eps,
                                       int x_dtype, int scale_dtype,
                                       void* stream) {
  if (d < 1 || d > kMaxD || rows < 1 || ld_y < d || ld_z < d ||
      (row_ss != nullptr) != (row_dot != nullptr) ||
      (row_ss != nullptr && d_norm < d))
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_ss == nullptr) d_norm = d;
  const cudaError_t e = by_dtypes(x_dtype, scale_dtype, [&](auto tx, auto ts) {
    return dispatch_gated<decltype(tx), decltype(ts)>(
        y, ld_y, z, ld_z, scale, dout, dy, dz, dscale,
        static_cast<float*>(partial), static_cast<int*>(counters),
        static_cast<const float*>(row_ss), static_cast<const float*>(row_dot),
        rows, d, d_norm, eps, static_cast<cudaStream_t>(stream));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The split gated form's first backward launch: row_dot (rows,) fp32 gets
// each row's sum of dout * (1 + scale) * g over its d values (y, z, dout as
// repro_rmsnorm_gated_bwd takes them). 1 <= d.
extern "C" int repro_rmsnorm_gated_rowdot(const void* y, long long ld_y,
                                          const void* z, long long ld_z,
                                          const void* scale,
                                          const void* dout, void* row_dot,
                                          long long rows, int d, int x_dtype,
                                          int scale_dtype, void* stream) {
  if (d < 1 || rows < 1 || ld_y < d || ld_z < d)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = by_dtypes(x_dtype, scale_dtype, [&](auto tx, auto ts) {
    return dispatch_rowdot<decltype(tx), decltype(ts)>(
        y, ld_y, z, ld_z, scale, dout, static_cast<float*>(row_dot), rows, d,
        static_cast<cudaStream_t>(stream));
  });
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the blocks of the last launch (a host-side record, for reports)
extern "C" int repro_rmsnorm_bwd_last_blocks() { return g_last_blocks; }

// the rows of repro_rmsnorm_bwd's partial buffer: a row for each cluster
// of the largest grid
extern "C" int repro_rmsnorm_bwd_partial_rows() {
  return kMaxBlocks / kCluster;
}
