// Fused RMSNorm for Hopper (sm_90a), in three forms.
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (called by
// rmsnorm_pallas): y = u * rsqrt(mean(u^2) + eps) * (1 + scale), the sum
// taken in fp32, the result cast back to the working dtype, where u is
//   plain     u = x
//   residual  u = s = x + delta, rounded to x's dtype (also written out)
//   gated     u = round(round(y) * round(silu(z))), y fp32, z in the working
//             dtype, each rounding to it as the eager ops round
// (the last two are the ops the serving paths ran before the norm: llama's
// residual add before ln2, Mamba2's gate before the mixer's norm).
//
// Bound on the H100: memory. Per row it reads the inputs once and writes
// once and does a few flops per value, far below the ~295 flops per byte at
// which the card stops being limited by its 3.35 TB/s. At the decode shape
// (8 rows) the bytes take tens of nanoseconds: the call is latency, one
// launch and one trip to device memory.
//
// Design: one pass over the row, one block per row. Each thread issues all
// its 16-byte loads of the inputs and of scale (one vector of 8 bf16 or 4
// fp32 values up to 1,024 vectors a row, else up to 4) before the
// reduction, keeps the row's values in registers, sums squares in fp32
// (warp shuffles, one shared-memory step) and writes y from registers, so
// device memory is reached once per input, with no second dependent read.
// Rows whose width is not a multiple of the vector or whose pointers are
// not 16-byte aligned take a scalar loop that reads the row twice (the
// second time from L1/L2). Splitting a decode row over a cluster of 2 or 4
// blocks, the partial sums added through distributed shared memory,
// measured 0.8-1.1 us slower at 8 x 3072 (PERF.md).
//
// The gated form split over a model tier (the Mamba2 mixer's d_inner split
// by heads over m ranks, each holding d_inner / m columns of every row): the
// statistic is the mean of u^2 over the whole d_inner row, so it takes two
// launches with the tier's sum between them. The first (stage kRowSq)
// writes each row's fp32 sum of u^2 over the rank's columns; the caller
// sums that (rows,) vector over the tier; the second (kFinish) recomputes
// u, reads the total and normalises with rsqrt(total / d_norm + eps), d_norm
// the full row's width. Both read y and z once each; the bound of the pair
// is the unsplit form's bytes (y and z read, out written).
#include <type_traits>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

enum Form { kPlain = 0, kResidual = 1, kGated = 2 };
// the whole norm in one launch, or the split gated form's two launches
enum Stage { kWhole = 0, kRowSq = 1, kFinish = 2 };
constexpr int kMaxVec = 4;           // 16-byte vectors a thread holds
constexpr int kMaxThreads = 1024;

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// the row value u from the first input (x, or y for the gated form) and
// the second (delta or z), both as fp32
template <int F, typename TX>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (F == kGated) {
    const float silu = rnd<TX>(b / (1.f + expf(-b)));
    return rnd<TX>(rnd<TX>(a) * silu);
  } else if constexpr (F == kResidual) {
    return rnd<TX>(a + b);
  } else {
    return a;
  }
}

// V values of T from a 16-byte aligned p (8, 16 or 32 bytes), as fp32
template <typename T, int V>
__device__ __forceinline__ void load_f(const T* __restrict__ p, float* out) {
  constexpr int kBytes = V * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
  } else {
    constexpr int E = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < E; ++i) out[q * E + i] = to_f(e[i]);
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float* v) {
  alignas(16) T out[V];
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = from_f<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(out);
}

// the sum over the block
__device__ __forceinline__ float row_sum(float ss) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = repro::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    t = repro::warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// x0: x (plain, residual) or y (gated) rows of stride ld0; x1: delta
// (residual, stride d) or z (gated, stride ld1); s: the residual sum out.
// K: 16-byte vectors per thread (0: the scalar loop); 1 up to 1,024
// vectors a row (d = 8,192 bf16): registers for 4 would allow one block of
// 384 threads per SM at d = 3,072. St: the stage; row_ss the rows' sums of
// squares (written by kRowSq, read by kFinish), d_norm the width the mean
// divides by (d, but the full row's for kFinish).
template <int F, typename TX, typename TS, int K, int St = kWhole>
__global__ void rmsnorm_kernel(const void* __restrict__ in0, long long ld0,
                               const TX* __restrict__ in1, long long ld1,
                               const TS* __restrict__ scale,
                               TX* __restrict__ out, TX* __restrict__ s,
                               float* __restrict__ row_ss, int d, int d_norm,
                               float eps) {
  using T0 = std::conditional_t<F == kGated, float, TX>;
  constexpr int V = 16 / sizeof(TX);
  const int row = blockIdx.x;
  const T0* x0 = static_cast<const T0*>(in0) + row * ld0;
  const TX* x1 = F == kPlain ? nullptr : in1 + row * ld1;
  TX* yr = out + static_cast<size_t>(row) * d;
  TX* sr = F == kResidual ? s + static_cast<size_t>(row) * d : nullptr;

  if constexpr (K > 0) {
    const int nvec = d / V;
    float u[K][V], w[K][V];
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {            // every load before the sum
      const int v = threadIdx.x + k * blockDim.x;
      if (v < nvec) {
        float b[V];
        load_f<T0, V>(x0 + v * V, u[k]);
        if constexpr (F != kPlain) load_f<TX, V>(x1 + v * V, b);
        if constexpr (St != kRowSq) load_f<TS, V>(scale + v * V, w[k]);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (F != kPlain) u[k][i] = combine<F, TX>(u[k][i], b[i]);
          ss += u[k][i] * u[k][i];
        }
        if constexpr (F == kResidual) store_v<TX, V>(sr + v * V, u[k]);
      }
    }
    if constexpr (St == kRowSq) {
      const float tot = row_sum(ss);
      if (threadIdx.x == 0) row_ss[row] = tot;
      return;
    }
    const float tot = St == kFinish ? row_ss[row] : row_sum(ss);
    const float inv = rsqrtf(tot / static_cast<float>(d_norm) + eps);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = threadIdx.x + k * blockDim.x;
      if (v < nvec) {
#pragma unroll
        for (int i = 0; i < V; ++i) u[k][i] *= inv * (1.f + w[k][i]);
        store_v<TX, V>(yr + v * V, u[k]);
      }
    }
  } else {
    auto value = [&](int i) {
      return combine<F, TX>(to_f(x0[i]), F == kPlain ? 0.f : to_f(x1[i]));
    };
    float tot;
    if constexpr (St == kFinish) {
      tot = row_ss[row];
    } else {
      float ss = 0.f;
      for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float v = value(i);
        if constexpr (F == kResidual) sr[i] = from_f<TX>(v);
        ss += v * v;
      }
      tot = row_sum(ss);
    }
    if constexpr (St == kRowSq) {
      if (threadIdx.x == 0) row_ss[row] = tot;
      return;
    }
    const float inv = rsqrtf(tot / static_cast<float>(d_norm) + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f<TX>(value(i) * inv * (1.f + to_f(scale[i])));
  }
}

template <int F, typename TX, typename TS, int St>
cudaError_t launch(const void* in0, long long ld0, const void* in1,
                   long long ld1, const void* scale, void* out, void* s,
                   float* row_ss, long long rows, int d, int d_norm,
                   float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int nvec = d / V;
  const int k = !vec || nvec > kMaxVec * kMaxThreads ? 0   // scalar loop
                : nvec > kMaxThreads ? kMaxVec : 1;
  const int work = k ? (nvec + k - 1) / k : d;
  int threads = ((work + 31) / 32) * 32;
  const int most = k ? kMaxThreads : 256;
  threads = threads < 32 ? 32 : (threads > most ? most : threads);
  const dim3 grid(static_cast<unsigned>(rows));
  const TX* x1 = static_cast<const TX*>(in1);
  const TS* sc = static_cast<const TS*>(scale);
  TX* y = static_cast<TX*>(out);
  TX* sum = static_cast<TX*>(s);
  if (k == 1)
    rmsnorm_kernel<F, TX, TS, 1, St><<<grid, threads, 0, stream>>>(
        in0, ld0, x1, ld1, sc, y, sum, row_ss, d, d_norm, eps);
  else if (k == kMaxVec)
    rmsnorm_kernel<F, TX, TS, kMaxVec, St><<<grid, threads, 0, stream>>>(
        in0, ld0, x1, ld1, sc, y, sum, row_ss, d, d_norm, eps);
  else
    rmsnorm_kernel<F, TX, TS, 0, St><<<grid, threads, 0, stream>>>(
        in0, ld0, x1, ld1, sc, y, sum, row_ss, d, d_norm, eps);
  return cudaGetLastError();
}

template <int F, int St = kWhole>
int dispatch(const void* in0, long long ld0, const void* in1, long long ld1,
             const void* scale, void* out, void* s, long long rows, int d,
             float eps, int x_dtype, int scale_dtype, int vec,
             void* stream, float* row_ss = nullptr, int d_norm = 0) {
  if (d_norm == 0) d_norm = d;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    e = launch<F, float, float, St>(in0, ld0, in1, ld1, scale, out, s,
        row_ss, rows, d, d_norm, eps, vec, st);
  else if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    e = launch<F, float, bf16, St>(in0, ld0, in1, ld1, scale, out, s,
        row_ss, rows, d, d_norm, eps, vec, st);
  else if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    e = launch<F, bf16, float, St>(in0, ld0, in1, ld1, scale, out, s,
        row_ss, rows, d, d_norm, eps, vec, st);
  else if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    e = launch<F, bf16, bf16, St>(in0, ld0, in1, ld1, scale, out, s,
        row_ss, rows, d, d_norm, eps, vec, st);
  return static_cast<int>(e);
}

}  // namespace

// All three: rows of d values; x_dtype is the working dtype (x, delta, z,
// the outputs), scale (d,) has its own. vec != 0 asks for 16-byte vector
// access (the caller checked d, the row strides and the pointers).
//
// y = rmsnorm(x); x and y (rows, d) contiguous.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, float eps, int x_dtype,
                             int scale_dtype, int vec, void* stream) {
  return dispatch<kPlain>(x, d, nullptr, 0, scale, y, nullptr, rows, d, eps,
                          x_dtype, scale_dtype, vec, stream);
}

// s = x + delta, y = rmsnorm(s); all (rows, d) contiguous.
extern "C" int repro_rmsnorm_residual(const void* x, const void* delta,
                                      const void* scale, void* s, void* y,
                                      long long rows, int d, float eps,
                                      int x_dtype, int scale_dtype, int vec,
                                      void* stream) {
  return dispatch<kResidual>(x, d, delta, d, scale, y, s, rows, d, eps,
                             x_dtype, scale_dtype, vec, stream);
}

// out = rmsnorm(round(round(y) * round(silu(z)))); y fp32 rows of stride
// ld_y, z rows of stride ld_z, out (rows, d) contiguous.
extern "C" int repro_rmsnorm_gated(const void* y, long long ld_y,
                                   const void* z, long long ld_z,
                                   const void* scale, void* out,
                                   long long rows, int d, float eps,
                                   int x_dtype, int scale_dtype, int vec,
                                   void* stream) {
  return dispatch<kGated>(y, ld_y, z, ld_z, scale, out, nullptr, rows, d,
                          eps, x_dtype, scale_dtype, vec, stream);
}

// The gated form split over a model tier, first launch: row_ss (rows,)
// fp32 gets each row's sum of u^2 over its d values (y, z as above).
extern "C" int repro_rmsnorm_gated_rowsq(const void* y, long long ld_y,
                                         const void* z, long long ld_z,
                                         void* row_ss, long long rows, int d,
                                         int x_dtype, int vec, void* stream) {
  return dispatch<kGated, kRowSq>(y, ld_y, z, ld_z, nullptr, nullptr,
                                  nullptr, rows, d, 0.f, x_dtype,
                                  repro::kFloat32, vec, stream,
                                  static_cast<float*>(row_ss));
}

// second launch: out = u * rsqrt(row_ss / d_norm + eps) * (1 + scale), with
// row_ss the tier's sum of the first launch's and d_norm the full row's
// width.
extern "C" int repro_rmsnorm_gated_finish(const void* y, long long ld_y,
                                          const void* z, long long ld_z,
                                          const void* scale,
                                          const void* row_ss, void* out,
                                          long long rows, int d, int d_norm,
                                          float eps, int x_dtype,
                                          int scale_dtype, int vec,
                                          void* stream) {
  return dispatch<kGated, kFinish>(
      y, ld_y, z, ld_z, scale, out, nullptr, rows, d, eps, x_dtype,
      scale_dtype, vec, stream,
      const_cast<float*>(static_cast<const float*>(row_ss)), d_norm);
}
