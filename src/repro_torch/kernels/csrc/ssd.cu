// Mamba2 SSD chunked scan (forward) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/ssd.py, _ssd_kernel (called by
// ssd_pallas). Per (batch, head), over chunks of tokens in order, all fp32:
//   da = dt*A;  cum = cumsum(da) within the chunk;  seg = cum[last]
//   y  = ((C B^T) .* tril(exp(cum_i - cum_j)) .* dt_j) x      intra-chunk
//      + exp(cum_i) * (C h)                                  inter-chunk
//   h <- exp(seg) h + B^T (exp(seg - cum_j) dt_j x_j)        state carry
// Inputs x (Bt,S,H,P), B and C (Bt,S,G,N) in fp32 or bf16 (one dtype),
// dt (Bt,S,H) and A (H,) fp32; head h reads group h / (H/G). Outputs
// y (Bt,S,H,P) and the final state h (Bt,H,N,P), fp32.
//
// Bound on the H100 at the mamba2-780m prefill (Bt = 1, H = 48, P = 64,
// N = 128, G = 1, bf16): bytes. x in, y and h out and B, C: 11.4 MB at
// S = 512, 3.4 us at 3.35 TB/s; the chunked form's multiply-adds times the
// split terms below (1.8 GFLOP at S = 512) take 1.8 us at 989 TFLOP/s.
//
// Design: one launch; one block of four warps per (b, h, 16 columns of P):
// 192 blocks at Bt*H = 48, P = 64, two resident per SM (108 KB of shared
// memory each at N = 128), so every SM works. The blocks of one head share
// nothing but the chunk's score C B^T, which each recomputes (a tensor-core
// product of 64 x 64 x N, cheap beside the chain of the chunk). A block
// walks the sequence in 64-token chunks in order; its N x 16 fp32 state
// stays in registers for the whole sequence (warp w holds the state rows of
// m-tiles w, w+4, ...), as the TPU kernel keeps it in VMEM. The chunked scan
// is exact algebra, so the 64-token chunking computes the plain version's
// function (any Q) up to fp32 rounding; the last chunk is ragged, its
// missing tokens loaded as zeros (dt = 0 leaves cum flat and adds nothing
// to h), and its rows of y are not written.
//
// Products on the tensor cores: mma.sync m16n8k16 bf16 with fp32
// accumulation (the pieces in mma.cuh, shared with ssd_bwd.cu), operands
// fed by ldmatrix from padded rows (no bank conflicts): the score C B^T (k = N, only the tiles on and below the
// diagonal), y_intra = L x with L = score .* decay .* dt built in the score's
// accumulator registers, which are already the A fragments of the next
// product (L never goes through shared memory), y_inter = C h_prev
// (k = N), and the state update B^T (w .* x) accumulated into the state
// registers. bf16 inputs enter the tensor cores exactly as they are. Every
// fp32 operand (L, h, w .* x, and on the fp32 path C, B and x) is split into
// hi = bf16(v) and lo = bf16(v - hi), |v - hi - lo| <= 2^-16 |v|; a product
// of an fp32 operand with an exact one is hi*b + lo*b, of two fp32 operands
// hi*hi + hi*lo + lo*hi (the dropped lo*lo is below 2^-16 |a||b|), the lo
// terms in accumulators of their own. So a product is within 2^-16 (one
// split operand) or ~3 * 2^-16 (two) of sum |a||b|: under the 1e-4 relative
// tolerance while sum |a||b| stays below ~2x-6x max |y|, and random-sign
// sums sit far below that; tests/test_torch_ssd_split.py emulates the split
// at the model's widths on the CPU (~1e-5, and ~3e-3 without the lo terms).
// Split-bf16 rather than 3xTF32: bf16 inputs need no split at all, and the
// bf16 instruction does twice the multiply-adds of the TF32 one.
//
// The chain of a chunk: x, B, C and dt of the next chunk are loaded by
// cp.async into the other of two stages while this one computes (bf16 with
// 16-byte rows; fp32 and unaligned inputs are loaded and split in place,
// one stage), issued by warps 0 and 1, whose causal rows of the score are
// the fewest; warp 0 takes the chunk's cumsum of dt*A*log2(e) as a warp
// scan while the other warps start the score; the decays are 2^x by the
// ex2 instruction (the accurate expf took a fifth of the time), taken only
// where j <= i (above the diagonal cum_i - cum_j > 0 could overflow). Three
// barriers per chunk. Measured no faster (PERF.md): P tiles of 32 (96
// blocks), the chunk-parallel decomposition in three launches (chunk
// states, an elementwise scan over chunks, then y), one bulk copy per row
// in place of the cp.async pieces, the prefetch issued by all warps or by
// warp 0 alone, and w .* x on warp 0 in place of the third barrier.
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::to_f;
using namespace repro::tc;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 64;                 // tokens per chunk
constexpr int kPT = 16;                    // columns of P per block
constexpr int kMaxMT = 4;                  // state m-tiles per warp: N <= 256
constexpr int kMaxN = 16 * kWarps * kMaxMT;

// Byte offsets of the block's shared memory. Two slots of the chunk's C, B
// ([64][N padded to 16, +8]) and x ([64][kPT+8]) in bf16: the two stages of
// the bf16 path, or the hi and lo planes of the fp32 path.
struct Layout {
  int np, ldn, ldp;          // N padded to 16; row strides in elements
  int c, b, x, slot;         // within a slot; bytes of a slot
  int dt, h, wx, cum, w, ecum, total;
};

__host__ __device__ inline Layout layout(int N) {
  Layout L;
  L.np = (N + 15) / 16 * 16;
  L.ldn = L.np + 8;          // 16-byte rows at an odd multiple of 16 bytes
  L.ldp = kPT + 8;
  L.c = 0;
  L.b = kChunk * L.ldn * 2;
  L.x = 2 * L.b;
  L.slot = L.x + kChunk * L.ldp * 2;
  L.dt = 2 * L.slot;                       // fp32 [2 stages][64]
  L.h = L.dt + 2 * kChunk * 4;             // bf16 [2 buffers][hi, lo][np][ldp]
  L.wx = L.h + 4 * L.np * L.ldp * 2;       // bf16 [hi, lo][64][ldp]
  L.cum = L.wx + 2 * kChunk * L.ldp * 2;   // fp32 [64] each
  L.w = L.cum + kChunk * 4;
  L.ecum = L.w + kChunk * 4;
  L.total = L.ecum + kChunk * 4;
  return L;
}

__device__ __forceinline__ void put(__nv_bfloat16* hi, __nv_bfloat16* lo,
                                    int i, float v, bool split) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  hi[i] = h;
  if (split) lo[i] = __float2bfloat16_rn(v - __bfloat162float(h));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bg,
               const T* __restrict__ Cg, float* __restrict__ y,
               float* __restrict__ hout, int S, int H, int G, int N, int P,
               int async) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int PT = kPT;
  constexpr int NT = PT / 8;                 // 8-column tiles of the P tile
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(N);
  const int ldn = L.ldn, ldp = L.ldp, nmt = L.np / 16;

  const int tiles = P / PT;
  const int bh = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * PT;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;   // mma group, thread in group
  const float a_h = A[h] * 1.4426950408889634f;   // dt*A in base 2
  const int nchunks = (S + kChunk - 1) / kChunk;
  const bool use_async = !kF32 && async;     // bf16 with 16-byte rows

  auto bf = [&](int off) { return reinterpret_cast<__nv_bfloat16*>(smem + off); };
  float* sdt_all = reinterpret_cast<float*>(smem + L.dt);
  float* scum = reinterpret_cast<float*>(smem + L.cum);
  float* sw = reinterpret_cast<float*>(smem + L.w);
  float* secum = reinterpret_cast<float*>(smem + L.ecum);
  const uint32_t s0_u32 = smem_u32(smem);

  // the columns N..np-1 of C and B are never loaded: zero them once
  for (int i = tid; i < 2 * 2 * kChunk * (L.np - N); i += kThreads) {
    const int n = N + i % (L.np - N), r = i / (L.np - N);
    bf((r / (2 * kChunk)) * L.slot + ((r / kChunk) & 1) * L.b)[(r % kChunk) * ldn + n] =
        __float2bfloat16_rn(0.f);
  }

  // chunk at token s0 (l tokens) into slot `st`: cp.async of 16-byte
  // pieces, issued by warps 0 and 1, whose rows of the score are the fewest
  const int pieces = N / 8;                  // 16-byte pieces of a B/C row
  const int dj = 64 / pieces, dq = 64 % pieces;
  auto load_async = [&](int st, int s0, int l) {
    __nv_bfloat16* sC = bf(st * L.slot + L.c);
    __nv_bfloat16* sB = bf(st * L.slot + L.b);
    __nv_bfloat16* sx = bf(st * L.slot + L.x);
    const T* gC = Cg + ((static_cast<size_t>(b) * S + s0) * G + g) * N;
    const T* gB = Bg + ((static_cast<size_t>(b) * S + s0) * G + g) * N;
    // piece i = tid + 64*k is row j, piece q: step both, no division
    for (int j = tid / pieces, q = tid % pieces; j < kChunk && tid < 64;
         j += dj + (q + dq >= pieces),
         q = q + dq >= pieces ? q + dq - pieces : q + dq) {
      const int off = (j < l ? j : 0) * G * N + q * 8;
      cp16(sC + j * ldn + q * 8, gC + off, j < l);
      cp16(sB + j * ldn + q * 8, gB + off, j < l);
    }
    const T* gx = x + (static_cast<size_t>(b) * S + s0) * H * P + h * P + p0;
#pragma unroll
    for (int i = tid; i < kChunk * NT && tid < 64; i += 64) {
      const int j = i / NT, q = i % NT;
      cp16(sx + j * ldp + q * 8, gx + (j < l ? j : 0) * H * P + q * 8, j < l);
    }
    if (tid < kChunk)
      cp4(sdt_all + st * kChunk + tid,
          dt + (static_cast<size_t>(b) * S + s0 + (tid < l ? tid : 0)) * H + h,
          tid < l);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  // chunk into slot 0 (hi) and, for fp32, slot 1 (lo): plain loads
  auto load_sync = [&](int s0, int l) {
    __nv_bfloat16 *cH = bf(L.c), *cL = bf(L.slot + L.c);
    __nv_bfloat16 *bH = bf(L.b), *bL = bf(L.slot + L.b);
    __nv_bfloat16 *xH = bf(L.x), *xL = bf(L.slot + L.x);
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int j = i / N, n = i % N;
      float cv = 0.f, bv = 0.f;
      if (j < l) {
        const size_t off = ((static_cast<size_t>(b) * S + s0 + j) * G + g) * N + n;
        cv = to_f(Cg[off]);
        bv = to_f(Bg[off]);
      }
      put(cH, cL, j * ldn + n, cv, kF32);
      put(bH, bL, j * ldn + n, bv, kF32);
    }
    for (int i = tid; i < kChunk * PT; i += kThreads) {
      const int j = i / PT, p = i % PT;
      const float v = j < l ? to_f(x[((static_cast<size_t>(b) * S + s0 + j) * H + h)
                                     * P + p0 + p]) : 0.f;
      put(xH, xL, j * ldp + p, v, kF32);
    }
    if (tid < kChunk)
      sdt_all[tid] = tid < l ? dt[(static_cast<size_t>(b) * S + s0 + tid) * H + h]
                             : 0.f;
  };

  float hreg[kMaxMT][NT][4];
#pragma unroll
  for (int r = 0; r < kMaxMT; ++r)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) hreg[r][t][e] = 0.f;

  if (use_async) load_async(0, 0, S < kChunk ? S : kChunk);

  // this block's columns of the state, rows in its warps' m-tiles, to dst
  // (N rows of stride P)
  auto store_state = [&](float* dst) {
#pragma unroll
    for (int r = 0; r < kMaxMT; ++r) {
      const int mi = warp + kWarps * r;
      if (mi >= nmt) break;
      const int m0 = 16 * mi + gq, m1 = m0 + 8;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col = 8 * t + 2 * tq;
        if (m0 < N)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(m0) * P + col) =
              make_float2(hreg[r][t][0], hreg[r][t][1]);
        if (m1 < N)
          *reinterpret_cast<float2*>(dst + static_cast<size_t>(m1) * P + col) =
              make_float2(hreg[r][t][2], hreg[r][t][3]);
      }
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * kChunk;
    const int l = S - s0 < kChunk ? S - s0 : kChunk;
    const int st = use_async ? (c & 1) : 0;
    if (use_async) {
      asm volatile("cp.async.wait_all;" ::: "memory");
    } else {
      if (c) __syncthreads();                // slot 0 is free again
      load_sync(s0, l);
    }
    __syncthreads();                                                   // S1
    if (use_async && c + 1 < nchunks) {
      const int s1 = s0 + kChunk;
      load_async((c + 1) & 1, s1, S - s1 < kChunk ? S - s1 : kChunk);
    }
    // hi and (fp32) lo planes of this chunk's operands
    const uint32_t cH = s0_u32 + st * L.slot + L.c, cL = s0_u32 + L.slot + L.c;
    const uint32_t bH = s0_u32 + st * L.slot + L.b, bL = s0_u32 + L.slot + L.b;
    const uint32_t xH = s0_u32 + st * L.slot + L.x, xL = s0_u32 + L.slot + L.x;
    const float* sdt = sdt_all + st * kChunk;

    if (warp == 0) {                  // cumsum of dt*A*log2(e): a warp scan
      const float d0 = sdt[2 * lane], d1 = sdt[2 * lane + 1];
      const float a0 = d0 * a_h, a1 = d1 * a_h;
      float incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float c0 = excl + a0, c1 = c0 + a1;
      const float seg = __shfl_sync(0xffffffffu, c1, 31);
      scum[2 * lane] = c0;
      scum[2 * lane + 1] = c1;
      sw[2 * lane] = ex2(seg - c0) * d0;     // exp(seg - cum_j) <= 1
      sw[2 * lane + 1] = ex2(seg - c1) * d1;
      secum[2 * lane] = ex2(c0);
      secum[2 * lane + 1] = ex2(c1);
    }

    // ---- score: rows 16*warp.. of C B^T, column tiles 0..2*warp+1 ----
    const int row0 = 16 * warp;
    float sacc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[t][e] = 0.f;
    const int a_off = ((row0 + (lane & 15)) * ldn + (lane >> 4) * 8) * 2;
    const int b_off = (((lane & 7) + ((lane >> 4) << 3)) * ldn + ((lane >> 3) & 1) * 8) * 2;
    for (int ks = 0; ks < nmt; ++ks) {
      uint32_t ah[4], al[4];
      ldsm(ah, cH + a_off + ks * 32);
      if (kF32) ldsm(al, cL + a_off + ks * 32);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > warp) break;
        uint32_t bh4[4];
        ldsm(bh4, bH + b_off + (16 * np * ldn + ks * 16) * 2);
        mma(sacc[2 * np], ah, bh4[0], bh4[1]);
        mma(sacc[2 * np + 1], ah, bh4[2], bh4[3]);
        if (kF32) {
          uint32_t bl4[4];
          ldsm(bl4, bL + b_off + (16 * np * ldn + ks * 16) * 2);
          mma(sacc[2 * np], ah, bl4[0], bl4[1]);
          mma(sacc[2 * np + 1], ah, bl4[2], bl4[3]);
          mma(sacc[2 * np], al, bh4[0], bh4[1]);
          mma(sacc[2 * np + 1], al, bh4[2], bh4[3]);
        }
      }
    }
    __syncthreads();                         // S2: cum, w, ecum

    // ---- w .* x, split, for the state update: 8 columns a thread ----
    for (int i = tid; i < kChunk * PT / 8; i += kThreads) {
      const int off = (i / (PT / 8)) * ldp + (i % (PT / 8)) * 8;
      const float wj = sw[i / (PT / 8)];
      const uint4 xh = *reinterpret_cast<const uint4*>(bf(st * L.slot + L.x) + off);
      const uint4 xl = kF32 ? *reinterpret_cast<const uint4*>(bf(L.slot + L.x) + off)
                            : make_uint4(0, 0, 0, 0);
      const uint32_t* h2 = &xh.x;
      const uint32_t* l2 = &xl.x;
      uint4 oh, ol;
      uint32_t* oh2 = &oh.x;
      uint32_t* ol2 = &ol.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {          // x = hi + lo on the fp32 path
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h2 + q));
        const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(l2 + q));
        split2(wj * (a.x + e.x), wj * (a.y + e.y), oh2[q], ol2[q]);
      }
      *reinterpret_cast<uint4*>(bf(L.wx) + off) = oh;
      *reinterpret_cast<uint4*>(bf(L.wx + kChunk * ldp * 2) + off) = ol;
    }

    // ---- y_intra = L x, L = score .* exp(cum_i - cum_j) .* dt_j, j <= i ----
    const int i0 = row0 + gq, i1 = i0 + 8;
    const float ci0 = scum[i0], ci1 = scum[i1];
    // hi and lo terms in separate accumulators: two chains, not one
    float yi[NT][4], yo[NT][4], yil[NT][4], yol[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) yi[t][e] = yo[t][e] = yil[t][e] = yol[t][e] = 0.f;
    const int bt_off = (((lane & 7) + ((lane >> 3) & 1) * 8) * ldp + (lane >> 4) * 8) * 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > warp) break;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int nt = 2 * kk + half;
        const int j0 = 8 * nt + 2 * tq, j1 = j0 + 1;
        const float2 cj = *reinterpret_cast<const float2*>(scum + j0);
        const float2 dj = *reinterpret_cast<const float2*>(sdt + j0);
        const float v00 = j0 <= i0 ? sacc[nt][0] * ex2(ci0 - cj.x) * dj.x : 0.f;
        const float v01 = j1 <= i0 ? sacc[nt][1] * ex2(ci0 - cj.y) * dj.y : 0.f;
        const float v10 = j0 <= i1 ? sacc[nt][2] * ex2(ci1 - cj.x) * dj.x : 0.f;
        const float v11 = j1 <= i1 ? sacc[nt][3] * ex2(ci1 - cj.y) * dj.y : 0.f;
        split2(v00, v01, ah[2 * half], al[2 * half]);
        split2(v10, v11, ah[2 * half + 1], al[2 * half + 1]);
      }
#pragma unroll
      for (int pp = 0; pp < NT / 2; ++pp) {
        const int off = bt_off + (16 * kk * ldp + 16 * pp) * 2;
        uint32_t xh4[4];
        ldsm_t(xh4, xH + off);
        mma(yi[2 * pp], ah, xh4[0], xh4[1]);
        mma(yi[2 * pp + 1], ah, xh4[2], xh4[3]);
        mma(yil[2 * pp], al, xh4[0], xh4[1]);
        mma(yil[2 * pp + 1], al, xh4[2], xh4[3]);
        if (kF32) {
          uint32_t xl4[4];
          ldsm_t(xl4, xL + off);
          mma(yil[2 * pp], ah, xl4[0], xl4[1]);
          mma(yil[2 * pp + 1], ah, xl4[2], xl4[3]);
        }
      }
    }

    // ---- y_inter = C h_prev (h of the chunks before this one) ----
    if (c > 0) {
      const uint32_t hH = s0_u32 + L.h + (c & 1) * 2 * L.np * ldp * 2;
      const uint32_t hL = hH + L.np * ldp * 2;
      for (int ks = 0; ks < nmt; ++ks) {
        uint32_t ah[4], al[4];
        ldsm(ah, cH + a_off + ks * 32);
        if (kF32) ldsm(al, cL + a_off + ks * 32);
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          const int off = bt_off + (16 * ks * ldp + 16 * pp) * 2;
          uint32_t hh4[4], hl4[4];
          ldsm_t(hh4, hH + off);
          ldsm_t(hl4, hL + off);
          mma(yo[2 * pp], ah, hh4[0], hh4[1]);
          mma(yo[2 * pp + 1], ah, hh4[2], hh4[3]);
          mma(yol[2 * pp], ah, hl4[0], hl4[1]);
          mma(yol[2 * pp + 1], ah, hl4[2], hl4[3]);
          if (kF32) {
            mma(yol[2 * pp], al, hh4[0], hh4[1]);
            mma(yol[2 * pp + 1], al, hh4[2], hh4[3]);
          }
        }
      }
    }
    {
      const float e0 = secum[i0], e1 = secum[i1];
      float* y0 = y + ((static_cast<size_t>(b) * S + s0 + i0) * H + h) * P + p0;
      float* y1 = y + ((static_cast<size_t>(b) * S + s0 + i1) * H + h) * P + p0;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int col = 8 * t + 2 * tq;
        if (i0 < l)
          *reinterpret_cast<float2*>(y0 + col) =
              make_float2(yi[t][0] + yil[t][0] + e0 * (yo[t][0] + yol[t][0]),
                          yi[t][1] + yil[t][1] + e0 * (yo[t][1] + yol[t][1]));
        if (i1 < l)
          *reinterpret_cast<float2*>(y1 + col) =
              make_float2(yi[t][2] + yil[t][2] + e1 * (yo[t][2] + yol[t][2]),
                          yi[t][3] + yil[t][3] + e1 * (yo[t][3] + yol[t][3]));
      }
    }
    __syncthreads();                         // S3: w .* x

    // ---- h <- exp(seg) h + B^T (w .* x); then h (hi, lo) for C h ----
    const float eseg = ex2(scum[kChunk - 1]);
    const uint32_t wH = s0_u32 + L.wx, wL = wH + kChunk * ldp * 2;
    const int kmax = (l + 15) / 16;
    const int at_off = (((lane & 7) + (lane >> 4) * 8) * ldn + ((lane >> 3) & 1) * 8) * 2;
    __nv_bfloat16* hnH = bf(L.h + ((c + 1) & 1) * 2 * L.np * ldp * 2);
    __nv_bfloat16* hnL = hnH + L.np * ldp;
#pragma unroll
    for (int r = 0; r < kMaxMT; ++r) {
      const int mi = warp + kWarps * r;
      if (mi >= nmt) break;
      float dl[NT][4];                       // the lo terms of this chunk
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hreg[r][t][e] *= eseg;
          dl[t][e] = 0.f;
        }
      for (int kk = 0; kk < kmax; ++kk) {
        uint32_t ah[4], al[4];
        const int aoff = at_off + (16 * kk * ldn + 16 * mi) * 2;
        ldsm_t(ah, bH + aoff);
        if (kF32) ldsm_t(al, bL + aoff);
#pragma unroll
        for (int pp = 0; pp < NT / 2; ++pp) {
          const int off = bt_off + (16 * kk * ldp + 16 * pp) * 2;
          uint32_t wh4[4], wl4[4];
          ldsm_t(wh4, wH + off);
          ldsm_t(wl4, wL + off);
          mma(hreg[r][2 * pp], ah, wh4[0], wh4[1]);
          mma(hreg[r][2 * pp + 1], ah, wh4[2], wh4[3]);
          mma(dl[2 * pp], ah, wl4[0], wl4[1]);
          mma(dl[2 * pp + 1], ah, wl4[2], wl4[3]);
          if (kF32) {
            mma(dl[2 * pp], al, wh4[0], wh4[1]);
            mma(dl[2 * pp + 1], al, wh4[2], wh4[3]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) hreg[r][t][e] += dl[t][e];
      if (c + 1 < nchunks) {
        const int m0 = 16 * mi + gq;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int col = 8 * t + 2 * tq;
          uint32_t hi, lo;
          split2(hreg[r][t][0], hreg[r][t][1], hi, lo);
          *reinterpret_cast<uint32_t*>(hnH + m0 * ldp + col) = hi;
          *reinterpret_cast<uint32_t*>(hnL + m0 * ldp + col) = lo;
          split2(hreg[r][t][2], hreg[r][t][3], hi, lo);
          *reinterpret_cast<uint32_t*>(hnH + (m0 + 8) * ldp + col) = hi;
          *reinterpret_cast<uint32_t*>(hnL + (m0 + 8) * ldp + col) = lo;
        }
      }
    }
  }

  // ---- the final state ----
  store_state(hout + static_cast<size_t>(bh) * N * P + p0);
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* h, int Bt,
                   int S, int H, int G, int N, int P, cudaStream_t stream) {
  const int bytes = layout(N).total;
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();          // clear it, or the next launch reports it
    return e;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int async = std::is_same<T, __nv_bfloat16>::value && N % 8 == 0 &&
                    aligned(x) && aligned(B) && aligned(C);
  ssd_fwd_kernel<T>
      <<<dim3(static_cast<unsigned>(Bt) * H * (P / kPT)), kThreads, bytes,
         stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(h), S, H, G, N, P, async);
  return cudaGetLastError();
}

}  // namespace

// x (Bt,S,H,P), B and C (Bt,S,G,N) of dtype `dtype`; dt (Bt,S,H) and A (H,)
// fp32; y (Bt,S,H,P) and h (Bt,H,N,P) fp32. One block per (b, h, 16
// columns of P). The caller checked H % G == 0; P must be a multiple of 16
// and N at most 256, or the call returns cudaErrorInvalidValue; an N whose
// shared memory a block cannot opt into returns the error of
// cudaFuncSetAttribute.
extern "C" int repro_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* h,
                         int Bt, int S, int H, int G, int N, int P, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN || P % kPT || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    e = launch<float>(x, dt, A, B, C, y, h, Bt, S, H, G, N, P, s);
  else if (dtype == repro::kBFloat16)
    e = launch<__nv_bfloat16>(x, dt, A, B, C, y, h, Bt, S, H, G, N, P, s);
  return static_cast<int>(e);
}
