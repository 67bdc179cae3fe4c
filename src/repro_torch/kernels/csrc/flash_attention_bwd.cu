// Flash attention backward for Hopper (sm_90a): dq, dk and dv of the forward
// in flash_attention.cu, from q, k, v, o, dO and the row log-sum-exp that
// the forward writes when asked (lse, (B, H, S) fp32).
//
// Replaces: no TPU kernel. The JAX package trains through plain jnp
// attention, differentiated by XLA (src/repro/models/attention.py,
// multihead_attention); the port's training forward is the kernel of
// flash_attention.cu (replacing src/repro/kernels/flash_attention/flash.py,
// _flash_kernel), and this is that kernel's backward.
//
// Per head, with scale = D^-0.5 and the forward's masks (causal, window,
// chunk; the ragged T edge; a masked pair has P = 0, a row with no key
// lse = +inf and so a zero gradient):
//   P = exp(scale * q k^T - lse)        dV = P^T dO
//   dP = dO v^T                         Delta = rowsum(dO * o)
//   dS = P * (dP - Delta)               dQ = scale * dS k,  dK = scale * dS^T q
//
// Two kernels, each launched once per backward, in this order:
//   dq:   one block per (b * H + h, query tile): Delta of its rows from dO
//         and o (written out for the second kernel), then the key tiles its
//         rows reach, P and dS recomputed per tile, dQ summed in registers;
//   dkdv: one block per (b * KV + kvh, key tile): the G query heads of the
//         kv head and every query tile that reaches the key tile, P and dS
//         recomputed, dK and dV summed in registers over heads and tiles.
// No atomics: every output element is summed by one thread in a fixed order,
// so two calls are bitwise equal.
//
// Bound on the H100 at the training shape (llama3.2-3b, B = 4, S = 1024,
// 24/8 heads, D = 128, bf16, causal): operations. The recomputation makes it
// 7 D multiply-adds per attended pair (dq: q k^T, dO v^T, dS k; dkdv: q k^T,
// dO v^T, P^T dO, dS^T q) against the 5 D of one fused pass with atomics,
// 2.5x the forward's 2 D; 50.4 M pairs, 64.5 GFLOP of the 5 D count, 65 us
// at 989 TFLOP/s bf16 against 3 ms at 67 TFLOP/s fp32. The bytes, q, k, v,
// o, dO and the three gradients, are ~100 MB, 30 us.
//
// Design (correct and simple first; a tensor-core version is a later
// redesign): CUDA cores, fp32 throughout. Tiles of 64 rows (32 at D = 256)
// staged in shared memory as fp32, rows padded by one float so that the
// strided reads of a product fall on distinct banks; 256 threads, each
// holding a 16-strided (rows, columns) sub-tile of every product in
// registers (4 x 4 of a 64 x 64 tile, 4 x D/16 of a 64 x D one). Blocks
// run their tiles in causal order with a uniform reach test per tile, as the
// forward's fp32 instance does; masked pairs inside a tile are zeroed.
#include <math.h>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kThreads = 256;

template <int D>
struct BT {
  static constexpr int T = D <= 128 ? 64 : 32;   // query rows, keys a tile
  static constexpr int DP = D + 1;                // padded row of a D tile
  static constexpr int TP = T + 1;                // padded row of a T tile
  static constexpr int TM = T / 16;               // rows a thread holds
  static constexpr int DN = D / 16;               // D columns a thread holds
  static constexpr int SMEM_DKDV = 4 * T * DP + 2 * T * TP + 2 * T;
  static constexpr int SMEM_DQ = 4 * T * DP + T * TP + 2 * T;
};

// acc[i][j] += sum_k A(ty + 16 i, k) B(tx + 16 j, k), where A(r, k) =
// a[r * AR + k * AK] and B(c, k) = b[c * BR + k * BK] in shared memory
template <int M, int N, int K, int AR, int AK, int BR, int BK>
__device__ __forceinline__ void mm(float (&acc)[M][N],
                                   const float* __restrict__ a,
                                   const float* __restrict__ b, int ty,
                                   int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[M], bv[N];
#pragma unroll
    for (int i = 0; i < M; ++i) av[i] = a[(ty + 16 * i) * AR + k * AK];
#pragma unroll
    for (int j = 0; j < N; ++j) bv[j] = b[(tx + 16 * j) * BR + k * BK];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int M, int N>
__device__ __forceinline__ void zero(float (&acc)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
}

// rows [r0, r0 + T) of one head of a (B, L, heads, D) tensor into a padded
// fp32 tile, rows past L as zeros
template <typename TT, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const TT* __restrict__ src, int b,
                                          int L, int heads, int head, int r0) {
  using C = BT<D>;
  for (int idx = threadIdx.x; idx < C::T * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * C::DP + c] =
        row < L ? to_f(src[((static_cast<size_t>(b) * L + row) * heads + head) *
                               D + c])
                : 0.f;
  }
}

// the forward's masks for one (query, key) pair
__device__ __forceinline__ bool visible(int qp, int kp, int S, int T_len,
                                        int causal, int window, int chunk) {
  if (qp >= S || kp >= T_len) return false;
  if (causal && kp > qp) return false;
  if (window && qp - kp >= window) return false;
  if (chunk && qp / chunk != kp / chunk) return false;
  return true;
}

// whether any pair of the query tile at q0 and the key tile at k0 may be
// visible (uniform over the block, so the barriers stay uniform)
template <int T>
__device__ __forceinline__ bool reach(int q0, int k0, int causal, int window,
                                      int chunk) {
  const int q1 = q0 + T - 1, k1 = k0 + T - 1;
  if (causal && q1 < k0) return false;
  if (window && q0 - k1 >= window) return false;
  if (chunk && (q1 / chunk < k0 / chunk || k1 / chunk < q0 / chunk))
    return false;
  return true;
}

// P and dS of one tile, from the scores s and dO v^T in dp (thread rows
// ty + 16 i of the query tile, keys tx + 16 j), written to sP (when given)
// and sdS, both [T][TP]
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float (&s)[BT<D>::TM][BT<D>::TM],
    const float (&dp)[BT<D>::TM][BT<D>::TM], const float* __restrict__ sLse,
    const float* __restrict__ sDelta, float* __restrict__ sP,
    float* __restrict__ sdS, int q0, int k0, int S, int T_len, float scale,
    int causal, int window, int chunk, int ty, int tx) {
  using C = BT<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::TM; ++j) {
      const int c = tx + 16 * j;
      const float p =
          visible(q0 + r, k0 + c, S, T_len, causal, window, chunk)
              ? expf(s[i][j] * scale - sLse[r])
              : 0.f;
      if (sP != nullptr) sP[r * C::TP + c] = p;
      sdS[r * C::TP + c] = p * (dp[i][j] - sDelta[r]);
    }
  }
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const TT* __restrict__ q, const TT* __restrict__ k,
                    const TT* __restrict__ v, const TT* __restrict__ o,
                    const TT* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    TT* __restrict__ dq, int S, int T_len, int H, int KV,
                    float scale, int causal, int window, int chunk) {
  using C = BT<D>;
  extern __shared__ float smem[];
  float* sQ = smem;                     // [T][DP]
  float* sdO = sQ + C::T * C::DP;       // [T][DP]
  float* sK = sdO + C::T * C::DP;       // [T][DP]
  float* sV = sK + C::T * C::DP;        // [T][DP]
  float* sdS = sV + C::T * C::DP;       // [T][TP]
  float* sLse = sdS + C::T * C::TP;     // [T]
  float* sDelta = sLse + C::T;          // [T]

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = blockIdx.y * C::T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid >> 5, lane = tid & 31;

  load_tile<TT, D>(sQ, q, b, S, H, h, q0);
  load_tile<TT, D>(sdO, dout, b, S, H, h, q0);
  for (int r = tid; r < C::T; r += kThreads)
    sLse[r] = q0 + r < S ? lse[static_cast<size_t>(bh) * S + q0 + r]
                         : INFINITY;
  __syncthreads();
  // Delta = rowsum(dO * o), one warp per row
  for (int r = warp; r < C::T; r += kThreads / 32) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < S) {
      const TT* orow = o + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
      for (int c = lane; c < D; c += 32)
        acc = fmaf(sdO[r * C::DP + c], to_f(orow[c]), acc);
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      if (qp < S) delta[static_cast<size_t>(bh) * S + qp] = acc;
    }
  }

  float acc[C::TM][C::DN];
  zero(acc);
  const int nk = (T_len + C::T - 1) / C::T;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * C::T;
    if (!reach<C::T>(q0, k0, causal, window, chunk)) continue;
    __syncthreads();                    // the last tile's reads are done
    load_tile<TT, D>(sK, k, b, T_len, KV, kvh, k0);
    load_tile<TT, D>(sV, v, b, T_len, KV, kvh, k0);
    __syncthreads();
    float s[C::TM][C::TM], dp[C::TM][C::TM];
    zero(s);
    zero(dp);
    mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(s, sQ, sK, ty, tx);
    mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(dp, sdO, sV, ty, tx);
    p_and_ds<D>(s, dp, sLse, sDelta, nullptr, sdS, q0, k0, S, T_len, scale,
                causal, window, chunk, ty, tx);
    __syncthreads();
    // dQ(r, d) += sum_c dS(r, c) K(c, d)
    mm<C::TM, C::DN, C::T, C::TP, 1, 1, C::DP>(acc, sdS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    TT* out = dq + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < C::DN; ++j)
      out[tx + 16 * j] = from_f<TT>(acc[i][j] * scale);
  }
}

template <typename TT, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const TT* __restrict__ q, const TT* __restrict__ k,
                      const TT* __restrict__ v, const TT* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, TT* __restrict__ dk,
                      TT* __restrict__ dv, int S, int T_len, int H, int KV,
                      float scale, int causal, int window, int chunk) {
  using C = BT<D>;
  extern __shared__ float smem[];
  float* sK = smem;                     // [T][DP]
  float* sV = sK + C::T * C::DP;        // [T][DP]
  float* sQ = sV + C::T * C::DP;        // [T][DP]
  float* sdO = sQ + C::T * C::DP;       // [T][DP]
  float* sP = sdO + C::T * C::DP;       // [T][TP], rows are queries
  float* sdS = sP + C::T * C::TP;       // [T][TP]
  float* sLse = sdS + C::T * C::TP;     // [T]
  float* sDelta = sLse + C::T;          // [T]

  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV, G = H / KV;
  const int k0 = blockIdx.y * C::T;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  load_tile<TT, D>(sK, k, b, T_len, KV, kvh, k0);
  load_tile<TT, D>(sV, v, b, T_len, KV, kvh, k0);
  float acc_k[C::TM][C::DN], acc_v[C::TM][C::DN];
  zero(acc_k);
  zero(acc_v);
  const int nq = (S + C::T - 1) / C::T;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * C::T;
      if (!reach<C::T>(q0, k0, causal, window, chunk)) continue;
      __syncthreads();                  // the last tile's reads are done
      load_tile<TT, D>(sQ, q, b, S, H, h, q0);
      load_tile<TT, D>(sdO, dout, b, S, H, h, q0);
      for (int r = tid; r < C::T; r += kThreads) {
        const bool in = q0 + r < S;
        sLse[r] = in ? lse[row_base + q0 + r] : INFINITY;
        sDelta[r] = in ? delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[C::TM][C::TM], dp[C::TM][C::TM];
      zero(s);
      zero(dp);
      mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(s, sQ, sK, ty, tx);
      mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(dp, sdO, sV, ty, tx);
      p_and_ds<D>(s, dp, sLse, sDelta, sP, sdS, q0, k0, S, T_len, scale,
                  causal, window, chunk, ty, tx);
      __syncthreads();
      // dV(c, d) += sum_r P(r, c) dO(r, d); dK(c, d) += sum_r dS(r, c) Q(r, d)
      mm<C::TM, C::DN, C::T, 1, C::TP, 1, C::DP>(acc_v, sP, sdO, ty, tx);
      mm<C::TM, C::DN, C::T, 1, C::TP, 1, C::DP>(acc_k, sdS, sQ, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= T_len) continue;
    const size_t off = ((static_cast<size_t>(b) * T_len + kp) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < C::DN; ++j) {
      dk[off + tx + 16 * j] = from_f<TT>(acc_k[i][j] * scale);
      dv[off + tx + 16 * j] = from_f<TT>(acc_v[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, S, T_len, H, KV;
  float scale;
  int causal, window, chunk;
  cudaStream_t stream;
};

template <typename TT, int D>
cudaError_t launch(const Args& a, bool dq_pass) {
  using C = BT<D>;
  if (dq_pass) {
    const int smem = C::SMEM_DQ * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<TT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.H, (a.S + C::T - 1) / C::T);
    flash_bwd_dq_kernel<TT, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TT*>(a.q), static_cast<const TT*>(a.k),
        static_cast<const TT*>(a.v), static_cast<const TT*>(a.o),
        static_cast<const TT*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<TT*>(a.dq), a.S, a.T_len,
        a.H, a.KV, a.scale, a.causal, a.window, a.chunk);
  } else {
    const int smem = C::SMEM_DKDV * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<TT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.KV, (a.T_len + C::T - 1) / C::T);
    flash_bwd_dkdv_kernel<TT, D><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const TT*>(a.q), static_cast<const TT*>(a.k),
        static_cast<const TT*>(a.v), static_cast<const TT*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<TT*>(a.dk), static_cast<TT*>(a.dv), a.S, a.T_len, a.H,
        a.KV, a.scale, a.causal, a.window, a.chunk);
  }
  return cudaGetLastError();
}

template <typename TT>
cudaError_t dispatch_d(const Args& a, int D, bool dq_pass) {
  switch (D) {
    case 32: return launch<TT, 32>(a, dq_pass);
    case 64: return launch<TT, 64>(a, dq_pass);
    case 128: return launch<TT, 128>(a, dq_pass);
    case 256: return launch<TT, 256>(a, dq_pass);
    default: return cudaErrorInvalidValue;
  }
}

int run(const Args& a, int D, int dtype, bool dq_pass) {
  if (a.H % a.KV) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return static_cast<int>(dispatch_d<float>(a, D, dq_pass));
  if (dtype == repro::kBFloat16)
    return static_cast<int>(dispatch_d<__nv_bfloat16>(a, D, dq_pass));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dout, dq (B,S,H,D); k, v (B,T,KV,D); lse, delta (B,H,S) fp32; all
// contiguous, one dtype (bf16 or fp32) for the tensors of the attention.
// Writes dq and delta = rowsum(dout * o), which the dkdv pass reads: launch
// this one first, on the same stream.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int B, int S, int T_len, int H, int KV,
                                  int D, float scale, int causal, int window,
                                  int chunk, int dtype, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               B, S, T_len, H, KV, scale, causal, window, chunk,
               static_cast<cudaStream_t>(stream)};
  return run(a, D, dtype, true);
}

// dk, dv (B,T,KV,D), from the delta the dq pass wrote
extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S,
                                    int T_len, int H, int KV, int D,
                                    float scale, int causal, int window,
                                    int chunk, int dtype, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr,
               dk, dv, B, S, T_len, H, KV, scale, causal, window, chunk,
               static_cast<cudaStream_t>(stream)};
  return run(a, D, dtype, false);
}
