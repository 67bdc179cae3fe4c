// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm.py, _rmsnorm_kernel (called by
// rmsnorm_pallas): y = x * rsqrt(mean(x^2) + eps) * (1 + scale), the sum
// taken in fp32, the result cast back to x's dtype.
//
// Bound on the H100: memory. Per row it reads d values and writes d values
// and does ~4 flops per value, far below the ~295 flops per byte at which
// the card stops being limited by its 3.35 TB/s.
//
// Design: one block per row. Threads read the row in 16-byte vectors
// (8 bf16 or 4 fp32 values; a scalar loop when d is not a multiple of the
// vector width or the row is not 16-byte aligned), sum squares in fp32,
// reduce by warp shuffles and one shared-memory step, then read the row a
// second time to scale and write it. The second read hits L1/L2 (a row is
// at most a few tens of KB), so device memory sees x once and y once.
#include "common.cuh"

namespace {

using repro::to_f;
using repro::from_f;

template <typename TX, typename TS, bool VEC>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TS* __restrict__ scale,
                               TX* __restrict__ y, int d, float eps) {
  constexpr int V = 16 / sizeof(TX);
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * d;
  TX* yr = y + static_cast<size_t>(blockIdx.x) * d;

  float ss = 0.f;
  if (VEC) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      float f[V];
      repro::load16_f(xr + i * V, f);
#pragma unroll
      for (int k = 0; k < V; ++k) ss += f[k] * f[k];
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      const float f = to_f(xr[i]);
      ss += f * f;
    }
  }

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
  const float inv = rsqrtf(red[0] / static_cast<float>(d) + eps);

  if (VEC) {
    for (int i = threadIdx.x; i < d / V; i += blockDim.x) {
      float f[V];
      repro::load16_f(xr + i * V, f);
      alignas(16) TX out[V];
#pragma unroll
      for (int k = 0; k < V; ++k)
        out[k] = from_f<TX>(f[k] * inv * (1.f + to_f(scale[i * V + k])));
      *reinterpret_cast<uint4*>(yr + i * V) = *reinterpret_cast<const uint4*>(out);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f<TX>(to_f(xr[i]) * inv * (1.f + to_f(scale[i])));
  }
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows,
                   int d, float eps, int vec, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(TX);
  const int work = vec ? d / V : d;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const dim3 grid(static_cast<unsigned>(rows));
  if (vec)
    rmsnorm_kernel<TX, TS, true><<<grid, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale),
        static_cast<TX*>(y), d, eps);
  else
    rmsnorm_kernel<TX, TS, false><<<grid, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TS*>(scale),
        static_cast<TX*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x (rows, d) and y (rows, d) of one dtype, scale (d,) of its own dtype.
// vec != 0 asks for 16-byte vector access (the caller checked d % V == 0
// and 16-byte alignment of x and y).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             long long rows, int d, float eps, int x_dtype,
                             int scale_dtype, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  cudaError_t e = cudaErrorInvalidValue;
  if (x_dtype == repro::kFloat32 && scale_dtype == repro::kFloat32)
    e = launch<float, float>(x, scale, y, rows, d, eps, vec, s);
  else if (x_dtype == repro::kFloat32 && scale_dtype == repro::kBFloat16)
    e = launch<float, bf16>(x, scale, y, rows, d, eps, vec, s);
  else if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kFloat32)
    e = launch<bf16, float>(x, scale, y, rows, d, eps, vec, s);
  else if (x_dtype == repro::kBFloat16 && scale_dtype == repro::kBFloat16)
    e = launch<bf16, bf16>(x, scale, y, rows, d, eps, vec, s);
  return static_cast<int>(e);
}
