// RMSNorm backward for Hopper (sm_90a), plain and residual forms.
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
// the result is the gradient of both x and delta.
//
// Design: two kernels, each launched once per backward: the rows (one block
// of 256 threads per 16 rows, each thread holding its columns' values of a
// row in registers, both row sums in one block reduction), which also
// writes each block's fp32 partial of dscale; then the column sums of the
// partials in block order, one thread per column. No atomics, so two calls
// are bitwise equal.
//
// Bound on the H100: memory. At the training shape (4,096 rows of 3,072,
// bf16) the rows read x and dy and write dx, 75.5 MB, 22.5 us at 3.35
// TB/s; the partials (256 x 3,072 fp32) add 3.1 MB written and read.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;
constexpr int kRows = 16;             // rows a block, one dscale partial each

template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

template <typename TX, typename TS, int NPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   const TX* __restrict__ dy, const TX* __restrict__ ds,
                   TX* __restrict__ dx, float* __restrict__ partial,
                   long long rows, int d, float eps) {
  __shared__ float red[2][kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float sc[NPT], part[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int col = tid + kThreads * j;
    sc[j] = col < d ? 1.f + to_f(scale[col]) : 0.f;
    part[j] = 0.f;
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long r1 = r0 + kRows < rows ? r0 + kRows : rows;
  for (long long r = r0; r < r1; ++r) {
    const size_t base = static_cast<size_t>(r) * d;
    float xv[NPT], dyv[NPT];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int col = tid + kThreads * j;
      xv[j] = col < d ? to_f(x[base + col]) : 0.f;
      dyv[j] = col < d ? to_f(dy[base + col]) : 0.f;
      ss = fmaf(xv[j], xv[j], ss);
      gx = fmaf(dyv[j] * sc[j], xv[j], gx);
    }
    ss = repro::warp_sum(ss);
    gx = repro::warp_sum(gx);
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    ss = 0.f;
    gx = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      ss += red[0][w];
      gx += red[1][w];
    }
    __syncthreads();                  // red is free for the next row
    const float rstd = rsqrtf(ss / d + eps);
    const float c = rstd * rstd * rstd * gx / d;   // rstd * mean(g * x^)
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int col = tid + kThreads * j;
      if (col >= d) continue;
      float out = rstd * dyv[j] * sc[j] - xv[j] * c;
      if (ds != nullptr) out = rnd<TX>(out) + to_f(ds[base + col]);
      dx[base + col] = from_f<TX>(out);
      part[j] = fmaf(dyv[j], xv[j] * rstd, part[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < NPT; ++j) {
    const int col = tid + kThreads * j;
    if (col < d) partial[static_cast<size_t>(blockIdx.x) * d + col] = part[j];
  }
}

template <typename TS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scale_kernel(const float* __restrict__ partial,
                         TS* __restrict__ dscale, int nblocks, int d) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= d) return;
  float acc = 0.f;
  for (int b = 0; b < nblocks; ++b)
    acc += partial[static_cast<size_t>(b) * d + col];
  dscale[col] = from_f<TS>(acc);
}

template <typename TX, typename TS, int NPT>
cudaError_t launch_rows(const void* x, const void* scale, const void* dy,
                        const void* ds, void* dx, float* partial,
                        long long rows, int d, float eps,
                        cudaStream_t stream) {
  const long long blocks = (rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<TX, TS, NPT><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    stream>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(scale),
      static_cast<const TX*>(dy), static_cast<const TX*>(ds),
      static_cast<TX*>(dx), partial, rows, d, eps);
  return cudaGetLastError();
}

template <typename TX, typename TS>
cudaError_t dispatch_npt(const void* x, const void* scale, const void* dy,
                         const void* ds, void* dx, float* partial,
                         long long rows, int d, float eps,
                         cudaStream_t stream) {
  const int need = (d + kThreads - 1) / kThreads;
  if (need <= 4)
    return launch_rows<TX, TS, 4>(x, scale, dy, ds, dx, partial, rows, d,
                                   eps, stream);
  if (need <= 8)
    return launch_rows<TX, TS, 8>(x, scale, dy, ds, dx, partial, rows, d,
                                   eps, stream);
  if (need <= 16)
    return launch_rows<TX, TS, 16>(x, scale, dy, ds, dx, partial, rows, d,
                                   eps, stream);
  if (need <= 32)
    return launch_rows<TX, TS, 32>(x, scale, dy, ds, dx, partial, rows, d,
                                   eps, stream);
  return cudaErrorInvalidValue;      // rows wider than 8,192
}

template <typename TX>
cudaError_t dispatch_scale(int scale_dtype, const void* x, const void* scale,
                           const void* dy, const void* ds, void* dx,
                           float* partial, long long rows, int d, float eps,
                           cudaStream_t stream) {
  if (scale_dtype == repro::kFloat32)
    return dispatch_npt<TX, float>(x, scale, dy, ds, dx, partial, rows, d, eps,
                                   stream);
  if (scale_dtype == repro::kBFloat16)
    return dispatch_npt<TX, __nv_bfloat16>(x, scale, dy, ds, dx, partial, rows,
                                           d, eps, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// x, dy, dx (and ds, null for the plain form) rows x d in x's dtype,
// contiguous; scale (d,); partial (ceil(rows / 16), d) fp32, the per-block
// dscale sums for repro_rmsnorm_bwd_scale. d <= 8,192.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* scale,
                                 const void* dy, const void* ds, void* dx,
                                 void* partial, long long rows, int d,
                                 float eps, int x_dtype, int scale_dtype,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == repro::kFloat32)
    e = dispatch_scale<float>(scale_dtype, x, scale, dy, ds, dx, part, rows, d,
                              eps, st);
  else if (x_dtype == repro::kBFloat16)
    e = dispatch_scale<__nv_bfloat16>(scale_dtype, x, scale, dy, ds, dx, part,
                                      rows, d, eps, st);
  return static_cast<int>(e);
}

// dscale (d,) in the scale's dtype: the partials summed in block order
extern "C" int repro_rmsnorm_bwd_scale(const void* partial, void* dscale,
                                       int nblocks, int d, int scale_dtype,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kThreads - 1) / kThreads);
  const float* part = static_cast<const float*>(partial);
  if (scale_dtype == repro::kFloat32)
    rmsnorm_bwd_scale_kernel<float><<<grid, kThreads, 0, st>>>(
        part, static_cast<float*>(dscale), nblocks, d);
  else if (scale_dtype == repro::kBFloat16)
    rmsnorm_bwd_scale_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        part, static_cast<__nv_bfloat16*>(dscale), nblocks, d);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
