// Flash attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash.py, _flash_kernel
// (called by flash_attention): softmax(q k^T * D^-0.5) v per head with fp32
// running max m, sum l and accumulator, GQA (q head h reads kv head h / G),
// causal, sliding-window, chunked-local and tanh-softcap masks, kv tiles
// that no query of the tile can reach skipped, and rows with l == 0
// written as 0.
//
// Bound on the H100: at prefill lengths it is operations, 4*D flops per
// attended (query, key) pair (q.k and p.v) against ~2*D*(H+2*KV)/H bytes
// per query row; the flops win from a few hundred keys on. This first
// version uses fp32 FMA on the CUDA cores (67 TFLOP/s at most), not the
// tensor cores (989 TFLOP/s bf16), so it runs well above the bound; it is
// right first, and wgmma/TMA is later work.
//
// Design: one block per (b*H + h, 64-row q tile). The TPU's sequential kv
// grid axis becomes a loop inside the block over 64-key tiles staged in
// shared memory as fp32 (K rows padded by one float so the 32 lanes of a
// warp reading 32 different keys hit 32 different banks). Each warp owns
// 16 query rows (8 when D = 256, with twice the warps); lane j scores keys
// j and j+32 of the tile, the row max and sum go by warp shuffles, p goes
// through shared memory to the P.V product, where lane j owns output
// columns j, j+32, ... . Ragged q and kv edges are masked in the kernel,
// so any prompt length works in 64-row tiles.
#include "common.cuh"

namespace {

using repro::to_f;
using repro::from_f;
using repro::kNegInf;

template <int D>
struct Tile {
  static constexpr int BQ = 64;                     // query rows per block
  static constexpr int BK = 64;                     // keys per kv tile
  static constexpr int RW = D <= 128 ? 16 : 8;      // query rows per warp
  static constexpr int NW = BQ / RW;                // warps per block
  static constexpr int NT = NW * 32;
  static constexpr int DL = D / 32;                 // output columns per lane
  static constexpr int KP = D + 1;                  // padded K row
  static constexpr int SMEM_FLOATS = BQ * D + BK * KP + BK * D + BQ * BK;
};

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int H, int KV, float scale, int causal, int window, int chunk,
                 float cap) {
  using C = Tile<D>;
  extern __shared__ float smem[];
  float* sQ = smem;                     // [BQ][D]
  float* sK = sQ + C::BQ * D;           // [BK][KP]
  float* sV = sK + C::BK * C::KP;       // [BK][D]
  float* sP = sV + C::BK * D;           // [BQ][BK]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * C::BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * C::RW;        // first query row of this warp

  for (int idx = tid; idx < C::BQ * D; idx += C::NT) {
    const int r = idx / D, d = idx % D, qs = q0 + r;
    sQ[idx] = qs < S ? to_f(q[((static_cast<size_t>(b) * S + qs) * H + h) * D + d])
                     : 0.f;
  }

  float m_i[C::RW], l_i[C::RW], acc[C::RW][C::DL];
#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < C::DL; ++j) acc[i][j] = 0.f;
  }

  const int nk = (T_len + C::BK - 1) / C::BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * C::BK;
    // tile-level reachability, as flash.py decides it per (q, kv) block;
    // uniform over the block, so the barriers below stay uniform too
    bool reach = true;
    if (causal) reach = k0 <= q0 + C::BQ - 1;
    if (window) reach = reach && (k0 + C::BK - 1 >= q0 - (window - 1));
    if (chunk)
      reach = reach && ((q0 / chunk) * chunk <= k0 + C::BK - 1) &&
              (k0 <= q0 + C::BQ - 1);
    if (!reach) continue;

    __syncthreads();                    // sQ written; last tile's reads done
    for (int idx = tid; idx < C::BK * D; idx += C::NT) {
      const int r = idx / D, d = idx % D, ks = k0 + r;
      float kv_k = 0.f, kv_v = 0.f;
      if (ks < T_len) {
        const size_t off = ((static_cast<size_t>(b) * T_len + ks) * KV + kvh) * D + d;
        kv_k = to_f(k[off]);
        kv_v = to_f(v[off]);
      }
      sK[r * C::KP + d] = kv_k;
      sV[idx] = kv_v;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[C::RW][2];
#pragma unroll
    for (int i = 0; i < C::RW; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float ka = sK[lane * C::KP + d];
      const float kb = sK[(lane + 32) * C::KP + d];
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        const float qv = sQ[(row0 + i) * D + d];
        s[i][0] = fmaf(qv, ka, s[i][0]);
        s[i][1] = fmaf(qv, kb, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < C::RW; ++i) {
      const int qp = q0 + row0 + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kp = k0 + lane + 32 * c;
        float x = s[i][c] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        bool ok = kp < T_len;
        if (causal) ok = ok && qp >= kp;
        if (window) ok = ok && (qp - kp < window);
        if (chunk) ok = ok && (qp / chunk == kp / chunk);
        s[i][c] = ok ? x : kNegInf;
      }
      const float m_new = fmaxf(m_i[i], repro::warp_max(fmaxf(s[i][0], s[i][1])));
      const float p0 = expf(s[i][0] - m_new), p1 = expf(s[i][1] - m_new);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + repro::warp_sum(p0 + p1);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < C::DL; ++j) acc[i][j] *= alpha;
      sP[(row0 + i) * C::BK + lane] = p0;
      sP[(row0 + i) * C::BK + lane + 32] = p1;
    }
    __syncwarp();                       // this warp's P rows are written

#pragma unroll 2
    for (int c = 0; c < C::BK; ++c) {
      float vv[C::DL];
#pragma unroll
      for (int j = 0; j < C::DL; ++j) vv[j] = sV[c * D + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < C::RW; ++i) {
        const float p = sP[(row0 + i) * C::BK + c];
#pragma unroll
        for (int j = 0; j < C::DL; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::RW; ++i) {
    const int qp = q0 + row0 + i;
    if (qp >= S) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];   // fully-masked rows -> 0
    T* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * D;
#pragma unroll
    for (int j = 0; j < C::DL; ++j) out[lane + 32 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int S, int T_len, int H, int KV, float scale, int causal,
                   int window, int chunk, float cap, cudaStream_t stream) {
  using C = Tile<D>;
  const int smem = C::SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + C::BQ - 1) / C::BQ);
  flash_fwd_kernel<T, D><<<grid, C::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, KV, scale,
      causal, window, chunk, cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T_len, int H, int KV, int D,
                       float scale, int causal, int window, int chunk,
                       float cap, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, T_len, H, KV, scale, causal, window, chunk, cap, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, T_len, H, KV, scale, causal, window, chunk, cap, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, T_len, H, KV, scale, causal, window, chunk, cap, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, T_len, H, KV, scale, causal, window, chunk, cap, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,S,H,D), k/v (B,T,KV,D), o (B,S,H,D), all contiguous and of one dtype.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T_len, int H, int KV, int D,
                                     float scale, int causal, int window,
                                     int chunk, float cap, int dtype,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    e = dispatch_d<float>(q, k, v, o, B, S, T_len, H, KV, D, scale, causal,
                          window, chunk, cap, s);
  else if (dtype == repro::kBFloat16)
    e = dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, T_len, H, KV, D, scale,
                                  causal, window, chunk, cap, s);
  return static_cast<int>(e);
}
