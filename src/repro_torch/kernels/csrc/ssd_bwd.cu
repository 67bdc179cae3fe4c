// Mamba2 SSD chunked scan, backward, for Hopper (sm_90a).
//
// Replaces: no TPU kernel. The JAX package trains through the jnp
// ssd_chunked differentiated by XLA (src/repro/models/ssm.py, mamba_apply);
// the port's training forward is the kernel of ssd.cu (replacing
// src/repro/kernels/ssd/ssd.py, _ssd_kernel), and this is that kernel's
// backward. Per (batch, head), with h_t = exp(dt_t A) h_{t-1} + dt_t B_t
// x_t^T and y_t = C_t^T h_t, for the output gradient dy (all fp32):
//   dh_t  = exp(dt_{t+1} A) dh_{t+1} + C_t dy_t^T       (reverse scan)
//   dx_t  = dt_t B_t^T dh_t
//   dB_t  = dt_t dh_t x_t            summed over the heads of the group
//   dC_t  = h_t dy_t                 summed over the heads of the group
//   ddt_t = A dda_t + x_t . (B_t^T dh_t),   dA = sum over b, t of dt_t dda_t
// with dda_t = exp(dt_t A) <dh_t, h_{t-1}>. In chunks of 64 tokens (cum the
// within-chunk cumsum of dt A, seg its last value, E_ij = exp(cum_i - cum_j)
// for j <= i, S = C B^T, D = dy x^T, h the state before the chunk and Dh
// the gradient of the state after it from the chunks that follow):
//   M = S .* E,  G_ij = D_ij E_ij dt_j
//   dx_j  = dt_j (sum_i M_ij dy_i + exp(seg - cum_j) (B Dh)_j)
//   dC_i  = exp(cum_i) (dy h^T)_i + (G B)_i
//   dB_j  = exp(seg - cum_j) dt_j (x Dh^T)_j + (G^T C)_j
//   dcum_i = rowsum(G .* S)_i - colsum(G .* S)_i + exp(cum_i) C_i.(dy h^T)_i
//            - exp(seg - cum_i) dt_i x_i.(B Dh)_i,  and the last row gains
//            exp(seg) <Dh, h> + sum_j exp(seg - cum_j) dt_j x_j.(B Dh)_j
//   dda = the reverse cumsum of dcum within the chunk.
// The chunked form is exact algebra, so the 64-token chunks compute the
// plain version's gradient (any chunk length) up to fp32 rounding; a ragged
// last chunk's missing tokens are zeros (dt = 0 keeps cum flat).
//
// Bound on the H100 at the mamba2-780m training shape (Bt = 4, S = 1,024,
// H = 48, P = 64, N = 128, G = 1, bf16 x/B/C, fp32 dy): bytes. x, dy, dx,
// B, C, dB, dC, dt, ddt and the forward's chunk states (0.10 GB of them)
// move 0.21 GB, 62 us at 3.35 TB/s. The chunked form's multiply-adds (the
// chunks' contributions to the states, the three products against the
// states and the causal halves of five 64 x 64 products a chunk) are
// 8.9 G; as split-bf16 products on the tensor cores (as ssd.cu's forward
// runs them) 19.8 G, 40 us at 989 TFLOP/s; in fp32 on the CUDA cores, as
// this kernel runs them, 0.27 ms at 67 TFLOP/s (chip_smoke.py,
// ssd_bwd_case).
//
// Design (a simple kernel first: fp32 on the CUDA cores, no tensor cores):
// four launches a call, in order on the caller's stream.
// The state before each chunk (h) is the forward kernel's (ssd.cu's
// hchunks, written by the training forward).
// 1. ssd_bwd_contrib, one block of 256 threads per (b, chunk, h): the
//    chunk's contribution to the gradient of the state before it, D =
//    (exp(cum) .* C)^T dy, every chunk at once; then ssd_bwd_pass, one
//    thread per state element (b, h, n, p), a loop over the chunks that
//    turns the contributions into the gradient of the state after each
//    chunk (Dh), in place. A sequential scan a block per (b, h, 16 columns
//    of P) took 0.87–0.97 ms at the training shape: 15 dependent rounds of
//    loads a block (PERF.md).
// 3. ssd_bwd_chunks: one block of 256 threads per (b, chunk, h); every
//    chunk is independent once h and Dh are known. The products are 64 x 64
//    output tiles (4 x 4 a thread) over K streamed in slices of 32 through
//    shared memory; M and G stay in shared memory for the products that
//    take them. It writes dx and ddt, and its head's share of dB, dC (per
//    token and head) and dA (per chunk and head).
// 4. ssd_bwd_sums: dB and dC summed over the heads of each group, dA over
//    the chunks, each in a fixed order.
// No atomics: every sum runs in a fixed order, so two calls are bitwise
// equal. exp is taken only where j <= i (above the diagonal cum_i - cum_j
// > 0 can overflow). Scratch (h, Dh, seg, the per-head shares) is the
// caller's.
#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;

constexpr int kChunk = 64;           // tokens per chunk
constexpr int kMaxN = 256;
constexpr int kPTile = 16;           // P must be a multiple (ssd.cu's)
constexpr int kThreads = 256;
constexpr int kKS = 32;              // K slice of a tile product
constexpr int kLd = 68;              // row stride of a staged slice
constexpr int kLdS = 65;             // row stride of M and G

// Warp 0: the chunk's cumsum of dt * A (two tokens a lane, l valid), its
// exp(cum) and exp(seg - cum) dt and exp(seg - cum); returns seg on every
// lane.
__device__ __forceinline__ float chunk_cumsum(const float* __restrict__ dtp,
                                              size_t stride, int l, float a,
                                              int lane, float* cum,
                                              float* dts) {
  const float d0 = 2 * lane < l ? dtp[2 * lane * stride] : 0.f;
  const float d1 = 2 * lane + 1 < l ? dtp[(2 * lane + 1) * stride] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float c0 = excl + a0, c1 = c0 + a1;
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  dts[2 * lane] = d0;
  dts[2 * lane + 1] = d1;
  return __shfl_sync(0xffffffffu, c1, 31);
}

// ---------------------------------------------------------------------------
// the 64 x 64 tile products of a chunk
// ---------------------------------------------------------------------------
// A slice of one operand: f(k0 + kk, i) for kk < 32 (0 where k0 + kk >= K)
// and i < 64, 8 values a thread, loaded into registers first so that all
// of a thread's loads are in flight together; KC: consecutive threads take
// consecutive k (operands contiguous in k), else consecutive i
constexpr int kPer = kKS * 64 / kThreads;

template <bool KC>
__device__ __forceinline__ void slot(int tid, int m, int& kk, int& i) {
  const int e = tid + kThreads * m;
  kk = KC ? (e & (kKS - 1)) : (e >> 6);
  i = KC ? (e >> 5) : (e & 63);
}

template <bool KC, class F>
__device__ __forceinline__ void stage_load(float (&v)[kPer], int k0, int K,
                                           int tid, F f) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    int kk, i;
    slot<KC>(tid, m, kk, i);
    v[m] = k0 + kk < K ? f(k0 + kk, i) : 0.f;
  }
}

// s[kk][i] = the values stage_load gave
template <bool KC>
__device__ __forceinline__ void stage_store(float* __restrict__ s,
                                            const float (&v)[kPer],
                                            int tid) {
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    int kk, i;
    slot<KC>(tid, m, kk, i);
    s[kk * kLd + i] = v[m];
  }
}

// acc[r][q] += sum over k < K of fa(k, 4 ty + r) * fb(k, 4 tx + q): one
// 64 x 64 output tile, 4 x 4 a thread, K in slices of 32 through sA, sB.
// A slice's loads are issued before the barrier that frees sA and sB, so
// whatever fa and fb read from shared memory must be written before the
// caller's last barrier.
template <bool KCA, bool KCB, class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], int K,
                                             float* sA, float* sB, int tid,
                                             FA fa, FB fb) {
  const int tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kKS) {
    float va[kPer], vb[kPer];
    stage_load<KCA>(va, k0, K, tid, fa);
    stage_load<KCB>(vb, k0, K, tid, fb);
    __syncthreads();                       // the last slice's reads are done
    stage_store<KCA>(sA, va, tid);
    stage_store<KCB>(sB, vb, tid);
    __syncthreads();
    const int kn = K - k0 < kKS ? K - k0 : kKS;
    for (int kk = 0; kk < kn; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(sA + kk * kLd + 4 * ty);
      const float4 b = *reinterpret_cast<const float4*>(sB + kk * kLd + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
  }
}

// the sum over the 16 threads of a row of the tile (a half warp), in a
// fixed order
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
}

// acc (rows 4 ty + r, columns 4 tx + q of the tile at (r0, c0)) into
// dst's rows r0.. (< R) of stride ld, columns c0.. (< Cn; Cn and ld
// multiples of 4, so a thread's 4 columns are one 16-byte store)
__device__ __forceinline__ void store_tile(float* __restrict__ dst,
                                           const float (&acc)[4][4], int r0,
                                           int R, int c0, int Cn, int ld,
                                           int tid) {
  const int tx = tid & 15, ty = tid >> 4, col = c0 + 4 * tx;
  if (col >= Cn) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + 4 * ty + r;
    if (row < R)
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(row) * ld + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// ---------------------------------------------------------------------------
// 1. the states: each chunk's contribution, then a pass over the chunks
// ---------------------------------------------------------------------------
// One block per (b, chunk, h): the chunk's contribution to the gradient of
// the state before it, D = (exp(cum) .* C)^T dy (N x P, K = the chunk's
// tokens), into dhs; and its seg.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_contrib(const float* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Cg, const float* __restrict__ dy,
                float* __restrict__ dhs, float* __restrict__ seg_out, int S,
                int H, int G, int N, int P, int nc) {
  __shared__ __align__(16) float sA[kKS * kLd];
  __shared__ __align__(16) float sB[kKS * kLd];
  __shared__ float sCum[kChunk], sDt[kChunk], sEc[kChunk];
  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int g = h / (H / G);
  const int s0 = c * kChunk;
  const int l = S - s0 < kChunk ? S - s0 : kChunk;
  const int tid = threadIdx.x;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const size_t st0 = ((static_cast<size_t>(b) * nc + c) * H + h) * N * P;
  auto DY = [&](int i, int k) { return dy[((tok0 + i) * H + h) * P + k]; };
  auto CC = [&](int i, int k) { return to_f(Cg[((tok0 + i) * G + g) * N + k]); };
  if (tid < 32) {
    const float seg = chunk_cumsum(dt + tok0 * H + h, H, l, A[h], tid, sCum,
                                   sDt);
    __syncwarp();
    sEc[2 * tid] = expf(sCum[2 * tid]);
    sEc[2 * tid + 1] = expf(sCum[2 * tid + 1]);
    if (tid == 0) seg_out[static_cast<size_t>(bc) * H + h] = seg;
  }
  __syncthreads();                 // sEc: the loaders below read it
  for (int n0 = 0; n0 < N; n0 += 64)
    for (int p0 = 0; p0 < P; p0 += 64) {
      float acc[4][4];
      zero(acc);
      tile_product<false, false>(
          acc, l, sA, sB, tid,
          [&](int k, int n) { return n0 + n < N ? sEc[k] * CC(k, n0 + n) : 0.f; },
          [&](int k, int q) { return p0 + q < P ? DY(k, p0 + q) : 0.f; });
      store_tile(dhs + st0, acc, n0, N, p0, P, P, tid);
    }
}

// One thread per state element (b, h, n, p), a loop over the chunks from
// the last down that turns dhs's contributions into the gradient of the
// state after each chunk, in place: Dh = 0, then Dh <- exp(seg_c) Dh +
// D_c. 8 chunks' loads in flight at a time.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(float* __restrict__ dhs, const float* __restrict__ seg, int H,
             int NP, int nc, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const long long bh = e / NP;
  const int el = static_cast<int>(e - bh * NP);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  auto at = [&](int c) {
    return (static_cast<size_t>(b) * nc + c) * H + h;
  };
  float run = 0.f;
  for (int i0 = 0; i0 < nc; i0 += 8) {
    float v[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = nc - 1 - i0 - u;
      v[u] = c >= 0 ? dhs[at(c) * NP + el] : 0.f;
      d[u] = c >= 0 ? seg[at(c)] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = nc - 1 - i0 - u;
      if (c < 0) break;
      dhs[at(c) * NP + el] = run;
      run = fmaf(expf(d[u]), run, v[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the chunk gradients
// ---------------------------------------------------------------------------
// shared memory of ssd_bwd_chunks, in floats
constexpr int kSmemSlices = 2 * kKS * kLd;
constexpr int kSmemMG = 2 * 64 * kLdS;
constexpr int kSmemRed = 16 * 64;
constexpr int kSmemVec = 10 * 64;
constexpr int kSmemChunks = kSmemSlices + kSmemMG + kSmemRed + kSmemVec;

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunks(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bg,
               const T* __restrict__ Cg, const float* __restrict__ dy,
               const float* __restrict__ hs, const float* __restrict__ dhs,
               T* __restrict__ dx, float* __restrict__ ddt,
               float* __restrict__ dA_part, float* __restrict__ dB_part,
               float* __restrict__ dC_part, int S, int H, int G, int N, int P,
               int nc) {
  extern __shared__ __align__(16) float smem[];
  float* sA = smem;
  float* sB = sA + kKS * kLd;
  float* sM = sB + kKS * kLd;              // [64][65]: M (rows i, cols j)
  float* sG = sM + 64 * kLdS;              // [64][65]: G
  float* sRed = sG + 64 * kLdS;            // [16][64]
  float* sCum = sRed + kSmemRed;
  float* sDt = sCum + 64;
  float* sW = sDt + 64;                    // exp(seg - cum_j) dt_j
  float* sWp = sW + 64;                    // exp(seg - cum_j)
  float* sEc = sWp + 64;                   // exp(cum_i)
  float* sRow = sEc + 64;                  // rowsum(G .* S)
  float* sBdot = sRow + 64;                // x_j . (B Dh)_j
  float* sAdot = sBdot + 64;               // x_j . (dx_j / dt_j)
  float* sInter = sAdot + 64;              // exp(cum_i) C_i . (dy h^T)_i
  float* sMisc = sInter + 64;              // [0] seg, [2..9] <Dh, h> a warp

  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int g = h / (H / G);
  const int s0 = c * kChunk;
  const int l = S - s0 < kChunk ? S - s0 : kChunk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const size_t st0 = ((static_cast<size_t>(b) * nc + c) * H + h) * N * P;
  const bool has_h = c > 0, has_dh = c < nc - 1;
  // row i's entry k of x / dy (P wide), of B / C (N wide), of h / Dh
  auto X = [&](int i, int k) { return to_f(x[((tok0 + i) * H + h) * P + k]); };
  auto DY = [&](int i, int k) { return dy[((tok0 + i) * H + h) * P + k]; };
  auto BB = [&](int i, int k) { return to_f(Bg[((tok0 + i) * G + g) * N + k]); };
  auto CC = [&](int i, int k) { return to_f(Cg[((tok0 + i) * G + g) * N + k]); };

  if (tid < 32) {
    const float seg = chunk_cumsum(dt + tok0 * H + h, H, l, A[h], lane, sCum,
                                   sDt);
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      const float wp = expf(seg - sCum[j]);
      sWp[j] = wp;
      sW[j] = wp * sDt[j];
      sEc[j] = expf(sCum[j]);
    }
    if (lane == 0) sMisc[0] = seg;
  }

  // ---- S = C B^T and D = dy x^T; M, G and the row / column sums of G .* S
  float accS[4][4], accD[4][4];
  zero(accS);
  zero(accD);
  tile_product<true, true>(accS, N, sA, sB, tid,
                           [&](int k, int i) { return i < l ? CC(i, k) : 0.f; },
                           [&](int k, int j) { return j < l ? BB(j, k) : 0.f; });
  tile_product<true, true>(accD, P, sA, sB, tid,
                           [&](int k, int i) { return i < l ? DY(i, k) : 0.f; },
                           [&](int k, int j) { return j < l ? X(j, k) : 0.f; });
  float rowT[4] = {0.f, 0.f, 0.f, 0.f}, colT[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = 4 * ty + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * tx + q;
      float m = 0.f, gg = 0.f;
      if (j <= i) {                          // exp only on and below the diagonal
        const float e = expf(sCum[i] - sCum[j]);
        m = accS[r][q] * e;
        gg = accD[r][q] * e * sDt[j];
      }
      sM[i * kLdS + j] = m;
      sG[i * kLdS + j] = gg;
      const float t = gg * accS[r][q];
      rowT[r] += t;
      colT[q] += t;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) rowT[r] = row_sum(rowT[r]);
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r) sRow[4 * ty + r] = rowT[r];
#pragma unroll
  for (int q = 0; q < 4; ++q) sRed[ty * 64 + 4 * tx + q] = colT[q];
  __syncthreads();                 // M and G: loaders read them before the
                                   // next product's first barrier

  // ---- dx, tile by tile of 64 columns of P ----
  float bsum[4] = {0.f, 0.f, 0.f, 0.f}, dsum[4] = {0.f, 0.f, 0.f, 0.f};
  float hdot = 0.f;
  for (int p0 = 0; p0 < P; p0 += 64) {
    float acc[4][4], xv[4][4];
    zero(acc);
    // U = B Dh
    if (has_dh)
      tile_product<true, false>(
          acc, N, sA, sB, tid,
          [&](int k, int j) { return j < l ? BB(j, k) : 0.f; },
          [&](int k, int q) {
            return p0 + q < P ? dhs[st0 + static_cast<size_t>(k) * P + p0 + q]
                              : 0.f;
          });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ty + r;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 4 * tx + q;
        xv[r][q] = j < l && p < P ? X(j, p) : 0.f;
        s = fmaf(xv[r][q], acc[r][q], s);
        acc[r][q] *= sWp[j];
      }
      bsum[r] += s;
    }
    // + M^T dy
    tile_product<false, false>(
        acc, l, sA, sB, tid, [&](int k, int j) { return sM[k * kLdS + j]; },
        [&](int k, int q) { return p0 + q < P ? DY(k, p0 + q) : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ty + r;
      const float dtj = sDt[j];
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + 4 * tx + q;
        s = fmaf(xv[r][q], acc[r][q], s);
        if (j < l && p < P)
          dx[((tok0 + j) * H + h) * P + p] = from_f<T>(dtj * acc[r][q]);
      }
      dsum[r] += s;
    }
    if (has_h && has_dh)
      for (int e0 = 0; e0 < N * 64; e0 += kThreads * kPer) {
        float a[kPer], b[kPer];           // a thread's loads in flight at once
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int e = e0 + tid + kThreads * m, p = p0 + (e & 63);
          const size_t off = st0 + static_cast<size_t>(e >> 6) * P + p;
          const bool ok = e < N * 64 && p < P;
          a[m] = ok ? dhs[off] : 0.f;
          b[m] = ok ? hs[off] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kPer; ++m) hdot = fmaf(a[m], b[m], hdot);
      }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    bsum[r] = row_sum(bsum[r]);
    dsum[r] = row_sum(dsum[r]);
  }
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      sBdot[4 * ty + r] = bsum[r];
      sAdot[4 * ty + r] = dsum[r];
    }

  // ---- dC and dB, tile by tile of 64 columns of N ----
  float inter[4] = {0.f, 0.f, 0.f, 0.f};
  for (int n0 = 0; n0 < N; n0 += 64) {
    float acc[4][4];
    zero(acc);
    // exp(cum_i) (dy h^T)_i
    if (has_h)
      tile_product<true, true>(
          acc, P, sA, sB, tid,
          [&](int k, int i) { return i < l ? DY(i, k) : 0.f; },
          [&](int k, int n) {
            return n0 + n < N ? hs[st0 + static_cast<size_t>(n0 + n) * P + k]
                              : 0.f;
          });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * tx + q;
        acc[r][q] *= sEc[i];
        if (has_h && i < l && n < N) s = fmaf(CC(i, n), acc[r][q], s);
      }
      inter[r] += s;
    }
    // + G B
    tile_product<false, false>(
        acc, l, sA, sB, tid, [&](int k, int i) { return sG[i * kLdS + k]; },
        [&](int k, int n) { return n0 + n < N ? BB(k, n0 + n) : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * tx + q;
        if (i < l && n < N)
          dC_part[((tok0 + i) * H + h) * N + n] = acc[r][q];
      }
    }
    zero(acc);
    // exp(seg - cum_j) dt_j (x Dh^T)_j
    if (has_dh)
      tile_product<true, true>(
          acc, P, sA, sB, tid,
          [&](int k, int j) { return j < l ? X(j, k) : 0.f; },
          [&](int k, int n) {
            return n0 + n < N ? dhs[st0 + static_cast<size_t>(n0 + n) * P + k]
                              : 0.f;
          });
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] *= sW[4 * ty + r];
    // + G^T C
    tile_product<false, false>(
        acc, l, sA, sB, tid, [&](int k, int j) { return sG[k * kLdS + j]; },
        [&](int k, int n) { return n0 + n < N ? CC(k, n0 + n) : 0.f; });
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * ty + r;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * tx + q;
        if (j < l && n < N)
          dB_part[((tok0 + j) * H + h) * N + n] = acc[r][q];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) inter[r] = row_sum(inter[r]);
  if (tx == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r) sInter[4 * ty + r] = inter[r];
  hdot = repro::warp_sum(hdot);
  if (lane == 0) sMisc[2 + warp] = hdot;
  __syncthreads();            // sRed, sRow, sBdot, sAdot, sInter, sMisc

  // ---- dcum, its reverse cumsum dda, ddt and this chunk's share of dA ----
  if (tid < 32) {
    float hd = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) hd += sMisc[2 + w];
    float d[2], wb = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      float col = 0.f;
#pragma unroll
      for (int t = 0; t < 16; ++t) col += sRed[t * 64 + j];
      const float wbj = sW[j] * sBdot[j];
      d[e] = sRow[j] - col + sInter[j] - wbj;
      wb += wbj;
    }
    wb = repro::warp_sum(wb);
    if (lane == 31) d[1] += expf(sMisc[0]) * hd + wb;   // d seg
    float incl = d[0] + d[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    const float dda[2] = {excl + d[1] + d[0], excl + d[1]};
    const float a_h = A[h];
    float dap = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      if (j < l) {
        ddt[(tok0 + j) * H + h] = fmaf(a_h, dda[e], sAdot[j]);
        dap = fmaf(sDt[j], dda[e], dap);
      }
    }
    dap = repro::warp_sum(dap);
    if (lane == 0) dA_part[static_cast<size_t>(bc) * H + h] = dap;
  }
}

// ---------------------------------------------------------------------------
// 3. the sums over heads (dB, dC) and chunks (dA)
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums(const float* __restrict__ dB_part,
             const float* __restrict__ dC_part,
             const float* __restrict__ dA_part, T* __restrict__ dB,
             T* __restrict__ dC, float* __restrict__ dA, long long tokens,
             int H, int G, int N, int chunks) {
  const int Hg = H / G;
  const long long total = tokens * G * N;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(e % N);
    const long long tg = e / N;
    const int g = static_cast<int>(tg % G);
    const long long t = tg / G;
    const size_t off = (static_cast<size_t>(t) * H + g * Hg) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < Hg; ++k) {
      sb += dB_part[off + static_cast<size_t>(k) * N];
      sc += dC_part[off + static_cast<size_t>(k) * N];
    }
    dB[e] = from_f<T>(sb);
    dC[e] = from_f<T>(sc);
  }
  if (blockIdx.x == 0)
    for (int hh = threadIdx.x; hh < H; hh += kThreads) {
      float s = 0.f;
      for (int k = 0; k < chunks; ++k) s += dA_part[static_cast<size_t>(k) * H + hh];
      dA[hh] = s;
    }
}

template <typename K>
cudaError_t smem_opt_in(K kernel, int bytes) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) cudaGetLastError();   // clear it for the next launch
  return e;
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, const void* dy, void* dx,
                   void* ddt, void* dA, void* dB, void* dC, const void* hs,
                   void* dhs, void* seg, void* dA_part, void* dB_part,
                   void* dC_part, int Bt, int S, int H, int G, int N, int P,
                   cudaStream_t stream) {
  const int nc = (S + kChunk - 1) / kChunk;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt_ = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* dyf = static_cast<const float*>(dy);
  const float* hsf = static_cast<const float*>(hs);
  float* dhsf = static_cast<float*>(dhs);

  ssd_bwd_contrib<T><<<Bt * nc * H, kThreads, 0, stream>>>(
      dtf, Af, Ct, dyf, dhsf, static_cast<float*>(seg), S, H, G, N, P, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long elems = static_cast<long long>(Bt) * H * N * P;
  ssd_bwd_pass<<<static_cast<unsigned>((elems + kThreads - 1) / kThreads),
                 kThreads, 0, stream>>>(dhsf, static_cast<const float*>(seg),
                                        H, N * P, nc, elems);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int chunk_bytes = kSmemChunks * 4;
  e = smem_opt_in(ssd_bwd_chunks<T>, chunk_bytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_chunks<T><<<Bt * nc * H, kThreads, chunk_bytes, stream>>>(
      xt, dtf, Af, Bt_, Ct, dyf, hsf, dhsf, static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part),
      static_cast<float*>(dB_part), static_cast<float*>(dC_part), S, H, G, N,
      P, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const long long tokens = static_cast<long long>(Bt) * S;
  const long long total = tokens * G * N;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  ssd_bwd_sums<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(dB_part), static_cast<const float*>(dC_part),
      static_cast<const float*>(dA_part), static_cast<T*>(dB),
      static_cast<T*>(dC), static_cast<float*>(dA), tokens, H, G, N,
      Bt * nc);
  return cudaGetLastError();
}

}  // namespace

// x (Bt,S,H,P), B and C (Bt,S,G,N) of dtype `dtype`, dt (Bt,S,H), A (H,)
// and dy (Bt,S,H,P) fp32, all contiguous. Writes dx (x's shape and dtype),
// ddt (Bt,S,H) and dA (H,) fp32, dB and dC (B's shape and dtype). Scratch,
// hs (Bt, ceil(S/64), H, N, P) fp32, the state before each 64-token chunk
// (repro_ssd's hchunks). Scratch, fp32: dhs (hs's shape), seg and dA_part
// (Bt * ceil(S/64), H), dB_part and dC_part (Bt, S, H, N). The caller
// checked H % G == 0; P must be a multiple of 16 and 1 <= N <= 256, or the
// call returns cudaErrorInvalidValue. Four launches on `stream`, in order.
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             void* dx, void* ddt, void* dA, void* dB,
                             void* dC, const void* hs, void* dhs, void* seg,
                             void* dA_part, void* dB_part, void* dC_part,
                             int Bt, int S, int H, int G, int N, int P,
                             int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN || P < kPTile || P % kPTile || S < 1 || Bt < 1 ||
      G < 1 || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    e = launch<float>(x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, hs, dhs, seg,
                      dA_part, dB_part, dC_part, Bt, S, H, G, N, P, s);
  else if (dtype == repro::kBFloat16)
    e = launch<__nv_bfloat16>(x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, hs,
                              dhs, seg, dA_part, dB_part, dC_part, Bt, S, H,
                              G, N, P, s);
  return static_cast<int>(e);
}
