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
// for j <= i, w_j = exp(seg - cum_j) dt_j, S = C B^T, D = dy x^T, h the
// state before the chunk and Dh the gradient of the state after it):
//   h   <- exp(seg) h + B^T (w .* x)                     over the chunks
//   Dh  <- exp(seg) Dh + C^T (exp(cum) .* dy)            back over them
//   M = S .* E,  G_ij = D_ij E_ij dt_j
//   dx_j  = dt_j ((M^T dy)_j + exp(seg - cum_j) (B Dh)_j)
//   dC_i  = exp(cum_i) (dy h^T)_i + (G B)_i          summed over heads
//   dB_j  = w_j (x Dh^T)_j + (G^T C)_j               summed over heads
//   dcum_i = rowsum(G .* S)_i - colsum(G .* S)_i + exp(cum_i) dy_i.(C h)_i
//            - w_i x_i.(B Dh)_i,  and the last row gains
//            exp(seg) <Dh, h> + sum_j w_j x_j.(B Dh)_j
//   dda = the reverse cumsum of dcum within the chunk.
// The chunked form is exact algebra, so the 64-token chunks compute the
// plain version's gradient (any chunk length) up to rounding; a ragged last
// chunk's missing tokens are zeros (dt = 0 keeps cum flat).
//
// Bound on the H100 at the mamba2-780m training shape (Bt = 4, S = 1,024,
// H = 48, P = 64, N = 128, G = 1, bf16 x/B/C, fp32 dy): operations. x, dy,
// dx, B, C, dB, dC, dt, ddt move 0.11 GB, 32 us at 3.35 TB/s; the chunked
// form's multiply-adds (per chunk and head the two state products, B Dh,
// dy h^T and x Dh^T, and the causal halves of D and M^T dy; per chunk and
// group the causal halves of S, (sum_h G_h) B and (sum_h G_h)^T C, B and C
// being the group's) are 8.9 G, as split-bf16 terms 19.8 G, 40.1 us at
// 989 TFLOP/s, and the sum over heads 6.4 M adds, 0.1 us on the CUDA
// cores: 40.2 us (chip_smoke.py, ssd_bwd_case).
//
// Design: four launches a call, in order on the caller's stream; every
// product of two 64-row tiles on the tensor cores, mma.sync m16n8k16 bf16
// with fp32 sums (mma.cuh, shared with ssd.cu's forward). bf16 inputs (x,
// B, C) enter exactly; every fp32 operand (dy, h, Dh, M, G, w x, exp(cum)
// dy, and x, B, C on the fp32 path) is split into bf16 hi + lo as the
// forward does: one split operand takes hi*b + lo*b, two take hi*hi +
// hi*lo + lo*hi, so a product is within ~2^-16 (one) or ~3 * 2^-16 (two)
// of sum |a||b|. tests/test_torch_ssd_bwd_split.py emulates these products
// at the model's widths on the CPU: every gradient within ~1.5e-5 of the
// plain backward (limits 1e-4, dA 1e-3), and 1.6e-3 to 3.1e-3 with single
// bf16 products; no product needs a third term. bf16 operands are fed by
// ldmatrix from rows padded to an odd multiple of 16 bytes; fp32 inputs
// are read from shared memory as they arrived and split at use (rows
// padded so that the reads are free of bank conflicts). Loads go by
// cp.async in 16-byte pieces (plain loads where a row is not 16-byte
// aligned) into two stages: the next slice arrives while this one
// computes.
// 1. ssd_bwd_scan, one block of 8 warps per (b, h, 64 columns of P) and
//    direction: the state before each chunk (forward, as ssd.cu carries
//    it) or the gradient of the state after it (reverse), N x 64 fp32 in
//    registers; each chunk's v .* y (w .* x, or exp(cum) .* dy) split into
//    bf16 planes in shared memory, and B^T or C^T times it accumulated into
//    the state. The training forward keeps no chunk states: this pass
//    recomputes them. Each chunk's state is stored as its bf16 hi and lo
//    planes (what the consumers' products take), staged in shared memory
//    and written by whole rows. The stores take most of its time: staged
//    so, they went faster than written from the registers; two to four
//    chunks in flight, or two blocks an SM, went no faster (PERF.md §7).
// 2. ssd_bwd_dbdc, one block of 8 warps per (b, chunk, group, 128 columns
//    of N, slice of the group's heads), a thread block cluster over the
//    slices (min(8, H/G) blocks; 6 heads a block at 48 heads a group): the
//    block walks its heads, one (head, 32 columns of P) stage at a time,
//    warps 0-3 for dC (rows i: D = dy x^T, G built from it in registers,
//    dy h^T), warps 4-7 for dB (rows j: D^T = x dy^T, G^T, x Dh^T). The
//    state terms sum over the heads in one accumulator each; G (G^T) sums
//    over the block's heads in fp32, each thread's own values in shared
//    memory, and takes one product with B (C) a block after the walk.
//    Then the cluster's blocks add their tiles in rank order through
//    distributed shared memory. As it holds h and Dh, it also writes each
//    head's dy_i . (C h)_i (as C_i . (dy h^T)_i) and <Dh, h>, per 128
//    columns of N and per warp.
// 3. ssd_bwd_dx, one block of 4 warps per (b, chunk, h), warp w the rows
//    16w.. of 64: D^T = x dy^T first (its G^T = D^T .* E .* dt kept in the
//    thread's slots of shared memory), then over 32-row slices of N (16 on
//    the fp32 path) S^T = B C^T and B Dh, the planes of Dh fed to ldmatrix
//    as they are; M^T = S^T .* E in the registers of S^T, split into the A
//    fragments of M^T dy; writes dx, ddt (with launch 2's terms), and dA's
//    share of the chunk. (Computing C h here, reading h a second time,
//    took longer in all.)
// 4. ssd_bwd_da: dA, the chunks' shares summed in order (one block).
// No atomics: every sum runs in a fixed order, so two calls are bitwise
// equal. exp is taken only where j <= i (above the diagonal cum_i - cum_j
// > 0 can overflow). Scratch (one buffer of the caller's, its size from
// repro_ssd_bwd_scratch_bytes, carved by scratch_of): hs and dhs, (Bt, ceil(S/64),
// H, 2, N, P) bf16 each (chunk 0 of hs and the last of dhs are never
// written or read), 101 MB each at the training shape; fp32 dA_part,
// inter_part and hd_part, 0.9 MB together. A call's device-memory traffic
// at the training shape is ~0.74 GB (the CUDA-core design's ~1.0): the
// scans read x and dy and write hs and dhs (0.28 GB), launch 2 reads hs,
// dhs, x and dy (0.27 GB), launch 3 reads dhs, x and dy (0.17 GB), and the
// outputs (0.03 GB); no per-head partial of dB or dC goes through device
// memory.
#include <type_traits>

#include <cooperative_groups.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::from_f;
using repro::to_f;
using namespace repro::tc;

constexpr int kChunk = 64;           // tokens per chunk
constexpr int kMaxN = 256;
constexpr int kPTile = 16;           // P must be a multiple (ssd.cu's)
constexpr int kMaxCluster = 8;       // blocks of a cluster of ssd_bwd_dbdc
constexpr float kLog2e = 1.4426950408889634f;
// ssd_bwd_dbdc: warps a block, columns of N a block, of P a stage
constexpr int kBCWarps = 8;
constexpr int kBCThreads = 32 * kBCWarps;
constexpr int kNW = 128;
constexpr int kPS = 32;
constexpr int kLd32 = 40;            // row stride of a 32-column tile

// operands of type T are split (fp32) or enter exactly (bf16)
template <typename T>
constexpr bool kSplit = std::is_same<T, float>::value;

__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

// Warp-wide: the chunk's cumsum of dt * A * log2(e) over 64 tokens, two a
// lane (d0, d1, 0 past the chunk's end) into c0, c1; returns seg, the last
// cumsum, on every lane.
__device__ __forceinline__ float cumsum2(float d0, float d1, float a2,
                                         int lane, float& c0, float& c1) {
  const float a0 = d0 * a2, a1 = d1 * a2;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  c0 = excl + a0;
  c1 = c0 + a1;
  return __shfl_sync(0xffffffffu, c1, 31);
}

// rows x COLS of T from src (row stride sld) into dst (row stride ld), the
// entries at rows >= nr or columns >= ncol zero: cp.async of 16-byte pieces
// when vec (src rows 16-byte aligned, ncol a whole number of pieces), else
// plain loads and stores; threads t, t + nt, ... COLS 0: `cols` columns.
template <typename T, int COLS>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src,
                                      size_t sld, int rows, int nr, int ncol,
                                      bool vec, int t, int nt, int cols = 0) {
  const int nc = COLS ? COLS : cols;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int pr = nc / V;
    for (int e = t; e < rows * pr; e += nt) {
      const int r = e / pr, q = (e - r * pr) * V;
      const bool ok = r < nr && q < ncol;
      cp16(dst + r * ld + q, ok ? src + r * sld + q : src, ok);
    }
  } else {
    for (int e = t; e < rows * nc; e += nt) {
      const int r = e / nc, q = e - r * nc;
      dst[r * ld + q] = r < nr && q < ncol ? src[r * sld + q] : from_f<T>(0.f);
    }
  }
}

// a chunk's 64 values of dt (stride H), 0 past its l tokens
__device__ __forceinline__ void stage_dt(float* dst, const float* src, int H,
                                         int l, int t) {
  if (t < kChunk) cp4(dst + t, src + static_cast<size_t>(t < l ? t : 0) * H,
                      t < l);
}

// the double-buffered walk over n stages: fetch(k, buffer) loads stage k
// (and commits a cp.async group; stage 0 already fetched when `fetched`);
// compute(k, buffer) runs once stage k is in every thread's view; stage
// k + 1 loads meanwhile
template <class I, class F>
__device__ __forceinline__ void ring(int n, I&& fetch, F&& compute,
                                     bool fetched = false) {
  if (!fetched) fetch(0, 0);
  for (int k = 0; k < n; ++k) {
    if (k + 1 < n) {
      fetch(k + 1, (k + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    compute(k, k & 1);
    __syncthreads();                 // the buffer is free for stage k + 2
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// the sum over the 4 threads of an mma row (lanes 4 gq .. 4 gq + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// B of two n8 tiles whose hi and lo halves are stored as two bf16 planes
__device__ __forceinline__ void frag_b2_pl(const __nv_bfloat16* hi,
                                           const __nv_bfloat16* lo, int ld,
                                           int n0, int k0, uint32_t (&bh)[4],
                                           uint32_t (&bl)[4]) {
  uint32_t u[4];
  frag_b2(hi, ld, n0, k0, bh, u);
  frag_b2(lo, ld, n0, k0, bl, u);
}

__device__ __forceinline__ void frag_bt2_pl(const __nv_bfloat16* hi,
                                            const __nv_bfloat16* lo, int ld,
                                            int n0, int k0, uint32_t (&bh)[4],
                                            uint32_t (&bl)[4]) {
  uint32_t u[4];
  frag_bt2(hi, ld, n0, k0, bh, u);
  frag_bt2(lo, ld, n0, k0, bl, u);
}

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// 1. the scans over the chunks
// ---------------------------------------------------------------------------
constexpr int kScanWarps = 8;
constexpr int kScanThreads = 32 * kScanWarps;
constexpr int kScanPT = 64;          // columns of P a block
constexpr int kScanNT = kScanPT / 8;
constexpr int kLdV = kScanPT + 8;
constexpr int kScanMT = 16 / kScanWarps;     // state m-tiles a warp: N <= 256
constexpr int kLd64 = 72;            // row stride of a 64-column tile
constexpr int kOutRows = 128;        // state rows staged for a store at once

// Byte offsets of a scan block's shared memory: two stages of the chunk's
// B or C ([64][N padded to 16, + pad] of T, read as [k][m]), x or dy
// ([64][64 + pad] of TY) and dt ([64] fp32); v .* y split into bf16 hi and
// lo planes ([2][64][72]); v ([64]) and exp(seg); the carried state's hi
// and lo planes on their way out, 128 rows at a time ([2][128][72]).
struct ScanLayout {
  int np, ldm, ldy, y, dt, stage, vy, v, so, total;
};

template <typename T, typename TY>
__host__ __device__ inline ScanLayout scan_layout(int N) {
  ScanLayout L;
  L.np = (N + 15) / 16 * 16;
  L.ldm = kSplit<T> ? L.np + 4 : L.np + 8;
  L.ldy = kSplit<TY> ? kScanPT + 4 : kScanPT + 8;
  L.y = align16(kChunk * L.ldm * static_cast<int>(sizeof(T)));
  L.dt = L.y + kChunk * L.ldy * static_cast<int>(sizeof(TY));
  L.stage = L.dt + kChunk * 4;
  L.vy = 2 * L.stage;
  L.v = L.vy + 2 * kChunk * kLdV * 2;
  L.so = L.v + align16((kChunk + 1) * 4);
  L.total = L.so + 2 * kOutRows * kLdV * 2;
  return L;
}

// One direction of one (b, h, 64 columns of P): forward (REV false, mg = B,
// y = x, v_j = w_j), the state before each chunk, written to out for chunks
// 1..nc-1; reverse (mg = C, y = dy, v_j = exp(cum_j)), the gradient of the
// state after each chunk, written for chunks nc-2..0. Both update the
// carried state as st <- exp(seg) st + mg^T (v .* y). out holds each
// chunk's state as bf16 hi and lo planes, (Bt, nc, H, 2, N, P).
template <typename T, typename TY, bool REV>
__device__ __forceinline__ void scan(unsigned char* smem, const TY* y,
                                     const T* mg, const float* dt,
                                     const float* A, bf16* out, int S, int H,
                                     int G, int N, int P, int nc, bool vec) {
  const ScanLayout L = scan_layout<T, TY>(N);
  const int tiles = (P + kScanPT - 1) / kScanPT;
  const int bh = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * kScanPT;
  const int pw = P - p0 < kScanPT ? P - p0 : kScanPT;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int nmt = L.np / 16;
  const float a2 = A[h] * kLog2e;
  float* sv = reinterpret_cast<float*>(smem + L.v);
  bf16* vyH = reinterpret_cast<bf16*>(smem + L.vy);
  bf16* vyL = vyH + kChunk * kLdV;
  auto chunk = [&](int k) { return REV ? nc - 1 - k : k; };

  auto fetch = [&](int k, int buf) {
    const int s0 = chunk(k) * kChunk;
    const int l = S - s0 < kChunk ? S - s0 : kChunk;
    unsigned char* base = smem + buf * L.stage;
    const size_t tok0 = static_cast<size_t>(b) * S + s0;
    stage<T, 0>(reinterpret_cast<T*>(base), L.ldm, mg + (tok0 * G + g) * N,
                static_cast<size_t>(G) * N, kChunk, l, N, vec, tid,
                kScanThreads, L.np);
    stage<TY, kScanPT>(reinterpret_cast<TY*>(base + L.y), L.ldy,
                       y + (tok0 * H + h) * P + p0,
                       static_cast<size_t>(H) * P, kChunk, l, pw, vec, tid,
                       kScanThreads);
    stage_dt(reinterpret_cast<float*>(base + L.dt), dt + tok0 * H + h, H, l,
             tid);
    cp_commit();
  };

  float st[kScanMT][kScanNT][4];
#pragma unroll
  for (int r = 0; r < kScanMT; ++r) zero(st[r]);

  fetch(0, 0);
  for (int k = 0; k < nc; ++k) {
    const int c = chunk(k), buf = k & 1;
    const int l = S - c * kChunk < kChunk ? S - c * kChunk : kChunk;
    cp_wait<0>();
    __syncthreads();          // stage k in view; chunk k - 1's reads done
    if (k + 1 < nc) fetch(k + 1, buf ^ 1);
    const unsigned char* base = smem + buf * L.stage;
    if (warp == 0) {
      const float* sdt = reinterpret_cast<const float*>(base + L.dt);
      const float d0 = sdt[2 * lane], d1 = sdt[2 * lane + 1];
      float c0, c1;
      const float seg = cumsum2(d0, d1, a2, lane, c0, c1);
      sv[2 * lane] = REV ? ex2(c0) : ex2(seg - c0) * d0;
      sv[2 * lane + 1] = REV ? ex2(c1) : ex2(seg - c1) * d1;
      if (lane == 0) sv[kChunk] = ex2(seg);
    }
    // the carried state is this chunk's: split, through shared memory (rows
    // r0.. r0 + 127 at a time), then out by whole rows
    bf16* so = reinterpret_cast<bf16*>(smem + L.so);
    auto stage_out = [&](int r0) {
#pragma unroll
      for (int r = 0; r < kScanMT; ++r) {
        const int mi = warp + kScanWarps * r;
        if (mi >= nmt || 16 * mi < r0 || 16 * mi >= r0 + kOutRows) continue;
#pragma unroll
        for (int t = 0; t < kScanNT; ++t) {
          const int col = 8 * t + 2 * tq;
          if (col >= pw) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int m = 16 * mi + gq + 8 * half;
            if (m >= N) continue;
            uint32_t hi, lo;
            split2(st[r][t][2 * half], st[r][t][2 * half + 1], hi, lo);
            const int o = (m - r0) * kLdV + col;
            *reinterpret_cast<uint32_t*>(so + o) = hi;
            *reinterpret_cast<uint32_t*>(so + kOutRows * kLdV + o) = lo;
          }
        }
      }
    };
    auto write_out = [&](int r0) {
      bf16* dh = out + ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * N * P
                 + p0;
      const int rows = N - r0 < kOutRows ? N - r0 : kOutRows;
      const int pr = pw / 8;             // 16-byte pieces of a row
      for (int e = tid; e < 2 * rows * pr; e += kScanThreads) {
        const int row = e / pr, q = 8 * (e - row * pr);
        const int pl = row >= rows, m = row - pl * rows;
        *reinterpret_cast<uint4*>(dh + static_cast<size_t>(pl) * N * P +
                                  static_cast<size_t>(r0 + m) * P + q) =
            *reinterpret_cast<const uint4*>(so + (pl * kOutRows + m) * kLdV +
                                            q);
      }
    };
    if (k > 0) stage_out(0);
    __syncthreads();          // v, exp(seg); the state's first rows
    if (k > 0)
      for (int r0 = 0; r0 < N; r0 += kOutRows) {
        if (r0 > 0) {
          __syncthreads();
          stage_out(r0);
          __syncthreads();
        }
        write_out(r0);
      }
    if (k + 1 == nc) break;   // the state after the last chunk: not needed
    // v .* y as bf16 hi and lo planes, the B operand of the update
    const TY* sy = reinterpret_cast<const TY*>(base + L.y);
    for (int e = tid; e < kChunk * kScanPT / 2; e += kScanThreads) {
      const int j = e / (kScanPT / 2), q = 2 * (e % (kScanPT / 2));
      const float v = sv[j];
      uint32_t hi, lo;
      split2(v * to_f(sy[j * L.ldy + q]), v * to_f(sy[j * L.ldy + q + 1]), hi,
             lo);
      *reinterpret_cast<uint32_t*>(vyH + j * kLdV + q) = hi;
      *reinterpret_cast<uint32_t*>(vyL + j * kLdV + q) = lo;
    }
    __syncthreads();
    const float eseg = sv[kChunk];
#pragma unroll
    for (int r = 0; r < kScanMT; ++r)
#pragma unroll
      for (int t = 0; t < kScanNT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[r][t][e] *= eseg;
    const T* sm = reinterpret_cast<const T*>(base);
    const int kmax = (l + 15) / 16;
    for (int kk = 0; kk < kmax; ++kk) {
      uint32_t ah[kScanMT][4], al[kScanMT][4];
#pragma unroll
      for (int r = 0; r < kScanMT; ++r)
        if (warp + kScanWarps * r < nmt)
          frag_at(sm, L.ldm, 16 * (warp + kScanWarps * r), 16 * kk, ah[r],
                  al[r]);
#pragma unroll
      for (int np = 0; np < kScanNT / 2; ++np) {
        uint32_t bh[4], bl[4];
        frag_bt2_pl(vyH, vyL, kLdV, 16 * np, 16 * kk, bh, bl);
#pragma unroll
        for (int r = 0; r < kScanMT; ++r) {
          if (warp + kScanWarps * r >= nmt) continue;
          mma_split<kSplit<T>, true>(st[r][2 * np], ah[r], al[r], bh[0], bh[1],
                                     bl[0], bl[1]);
          mma_split<kSplit<T>, true>(st[r][2 * np + 1], ah[r], al[r], bh[2],
                                     bh[3], bl[2], bl[3]);
        }
      }
    }
  }
}

// blockIdx.y 0: the states; 1: their gradients
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_bwd_scan(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bg,
             const T* __restrict__ Cg, const float* __restrict__ dy,
             bf16* __restrict__ hs, bf16* __restrict__ dhs, int S, int H,
             int G, int N, int P, int nc, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.y == 0)
    scan<T, T, false>(smem, x, Bg, dt, A, hs, S, H, G, N, P, nc, vec);
  else
    scan<T, float, true>(smem, dy, Cg, dt, A, dhs, S, H, G, N, P, nc, vec);
}

// ---------------------------------------------------------------------------
// 2. the per-group gradients: dB and dC summed over the heads; each head's
// inter-chunk terms of dcum
// ---------------------------------------------------------------------------

// Byte offsets: B and C at the block's columns of N ([64][NW + pad] of T,
// read as [k][n]); two stages of x (T) and dy (fp32), [64][40] (tokens by
// 32 columns of P), the hi and lo planes of h and Dh ([2][NW][40] bf16:
// rows of N), and dt; the head's vectors; the sum of the block's G (or
// G^T) over its heads, each thread's own 32 values (float2 [16][threads]).
// After the walk the stages hold the cluster's partial sums.
struct BCLayout {
  int ldbc, c, st, dy, hh, dh, dt, stage, vec, g, total;
};

template <typename T>
__host__ __device__ inline BCLayout bc_layout() {
  BCLayout L;
  constexpr int es = sizeof(T), NW = kNW;
  L.ldbc = kSplit<T> ? NW + 4 : NW + 8;
  L.c = kChunk * L.ldbc * es;
  L.st = 2 * L.c;
  L.dy = kChunk * kLd32 * es;
  L.hh = L.dy + kChunk * kLd32 * 4;
  L.dh = L.hh + 2 * NW * kLd32 * 2;
  L.dt = L.dh + 2 * NW * kLd32 * 2;
  L.stage = L.dt + kChunk * 4;
  L.vec = L.st + 2 * L.stage;
  L.g = L.vec + 4 * kChunk * 4;
  L.total = L.g + 32 * kBCThreads * 4;
  return L;
}

// One stage's products for a role: dd += a b1^T over the causal tiles
// (LOWER: columns <= the warp's rows, else >=), tt += a z^T over NT tiles
// of z (bf16 hi and lo planes zh, zl) when `two`; a rows of the warp, K =
// the stage's 32 columns of P.
template <typename TA, typename TB, bool LOWER, int NT>
__device__ __forceinline__ void role_products(const TA* sa, const TB* sb1,
                                              const bf16* zh, const bf16* zl,
                                              bool two, int w,
                                              float (&dd)[8][4],
                                              float (&tt)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < kPS / 16; ++kk) {
    uint32_t ah[4], al[4];
    frag_a(sa, kLd32, 16 * w, 16 * kk, ah, al);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (LOWER ? np > w : np < w) continue;
      uint32_t bh[4], bl[4];
      frag_b2(sb1, kLd32, 16 * np, 16 * kk, bh, bl);
      mma_split<kSplit<TA>, kSplit<TB>>(dd[2 * np], ah, al, bh[0], bh[1],
                                        bl[0], bl[1]);
      mma_split<kSplit<TA>, kSplit<TB>>(dd[2 * np + 1], ah, al, bh[2], bh[3],
                                        bl[2], bl[3]);
    }
    if (two)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bh[4], bl[4];
        frag_b2_pl(zh, zl, kLd32, 16 * np, 16 * kk, bh, bl);
        mma_split<kSplit<TA>, true>(tt[2 * np], ah, al, bh[0], bh[1], bl[0],
                                    bl[1]);
        mma_split<kSplit<TA>, true>(tt[2 * np + 1], ah, al, bh[2], bh[3],
                                    bl[2], bl[3]);
      }
  }
}

// The end of a head for a role: acc += scale_r tt_r (when `two`), and the
// head's G (LOWER: rows i, G_ij = D_ij E_ij dt_j, j <= i; else rows j,
// G^T_ji = D^T_ji E_ij dt_j, i >= j), built from the registers of dd, added
// to the block's sum over its heads in the thread's slots sg (set by the
// block's `first` head). The slots hold the causal tiles' values in the
// order of the A fragments that group_product feeds.
template <bool LOWER, int NT>
__device__ __forceinline__ void head_end(float (&acc)[NT][4],
                                         const float (&dd)[8][4],
                                         const float (&tt)[NT][4], bool two,
                                         bool first, const float* scale,
                                         const float* cum, const float* dtv,
                                         float2* sg, int w) {
  const int lane = lane_id(), gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * w + gq, r1 = r0 + 8;
  if (two) {
    const float s0 = scale[r0], s1 = scale[r1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] = fmaf(s0, tt[nt][0], acc[nt][0]);
      acc[nt][1] = fmaf(s0, tt[nt][1], acc[nt][1]);
      acc[nt][2] = fmaf(s1, tt[nt][2], acc[nt][2]);
      acc[nt][3] = fmaf(s1, tt[nt][3], acc[nt][3]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (LOWER ? kk > w : kk < w) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int nt = 2 * kk + half;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = rr ? r1 : r0, col = 8 * nt + 2 * tq + e;
          const int i = LOWER ? row : col, j = LOWER ? col : row;
          v[e] = j <= i ? dd[nt][2 * rr + e] * ex2(cum[i] - cum[j]) * dtv[j]
                        : 0.f;
        }
        float2* p = sg + (4 * kk + 2 * half + rr) * kBCThreads + threadIdx.x;
        const float2 o = first ? make_float2(0.f, 0.f) : *p;
        *p = make_float2(o.x + v[0], o.y + v[1]);
      }
    }
  }
}

// After the block's heads: acc += (sum over the heads of G) b, one product
// a block (K = j <= i for LOWER, i >= j else), the summed G split into the
// A fragments; b the block's columns of B (LOWER) or C.
template <typename TB, bool LOWER, int NT>
__device__ __forceinline__ void group_product(float (&acc)[NT][4],
                                              const float2* sg, const TB* sb,
                                              int ldb, int w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (LOWER ? kk > w : kk < w) continue;
    uint32_t ah[4], al[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {       // q = 2 half + rr, as head_end's
      const float2 v = sg[(4 * kk + q) * kBCThreads + threadIdx.x];
      split2(v.x, v.y, ah[q], al[q]);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bh[4], bl[4];
      frag_bt2(sb, ldb, 16 * np, 16 * kk, bh, bl);
      mma_split<true, kSplit<TB>>(acc[2 * np], ah, al, bh[0], bh[1], bl[0],
                                  bl[1]);
      mma_split<true, kSplit<TB>>(acc[2 * np + 1], ah, al, bh[2], bh[3],
                                  bl[2], bl[3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBCThreads)
ssd_bwd_dbdc(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bg,
             const T* __restrict__ Cg, const float* __restrict__ dy,
             const bf16* __restrict__ hs, const bf16* __restrict__ dhs,
             T* __restrict__ dB, T* __restrict__ dC,
             float* __restrict__ inter_part, float* __restrict__ hd_part,
             int S, int H, int G, int N, int P, int nc, int chunks, int vec) {
  constexpr int NW = kNW, NT = NW / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const BCLayout L = bc_layout<T>();
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int ntiles = (N + NW - 1) / NW;
  const int rest = blockIdx.x / cs;
  const int n0 = NW * (rest % ntiles);
  const int bcg = rest / ntiles;
  const int g = bcg % G, bc = bcg / G;
  const int c = bc % nc, b = bc / nc;
  const int Hg = H / G, hpb = (Hg + cs - 1) / cs;
  const int k0 = rank * hpb;
  const int nh = Hg - k0 < hpb ? (Hg - k0 > 0 ? Hg - k0 : 0) : hpb;
  const int s0 = c * kChunk;
  const int l = S - s0 < kChunk ? S - s0 : kChunk;
  const int nw = N - n0 < NW ? N - n0 : NW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int role = warp >> 2, w = warp & 3;
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const bool has_h = c > 0, has_dh = c < nc - 1;
  const int psl = (P + kPS - 1) / kPS;
  T* sBt = reinterpret_cast<T*>(smem);
  T* sCt = reinterpret_cast<T*>(smem + L.c);
  float* sCum = reinterpret_cast<float*>(smem + L.vec);
  float* sDtv = sCum + kChunk;
  float* sEc = sDtv + kChunk;
  float* sW = sEc + kChunk;
  float2* sG = reinterpret_cast<float2*>(smem + L.g);

  const int stages = nh * psl;
  if (stages > 0) {         // joins the first stage's cp.async group
    const size_t off = (tok0 * G + g) * N + n0;
    stage<T, NW>(sBt, L.ldbc, Bg + off, static_cast<size_t>(G) * N, kChunk, l,
                 nw, vec, tid, kBCThreads);
    stage<T, NW>(sCt, L.ldbc, Cg + off, static_cast<size_t>(G) * N, kChunk, l,
                 nw, vec, tid, kBCThreads);
  }
  // stage k: head k / psl of the block's, columns 32 (k % psl).. of P
  auto fetch = [&](int k, int buf) {
    unsigned char* base = smem + L.st + buf * L.stage;
    const int hh = g * Hg + k0 + k / psl, p0 = kPS * (k % psl);
    const int pw = P - p0 < kPS ? P - p0 : kPS;
    const size_t off = (tok0 * H + hh) * P + p0;
    stage<T, kPS>(reinterpret_cast<T*>(base), kLd32, x + off,
                  static_cast<size_t>(H) * P, kChunk, l, pw, vec, tid,
                  kBCThreads);
    stage<float, kPS>(reinterpret_cast<float*>(base + L.dy), kLd32, dy + off,
                      static_cast<size_t>(H) * P, kChunk, l, pw, vec, tid,
                      kBCThreads);
    const size_t so = ((static_cast<size_t>(b) * nc + c) * H + hh) * 2 * N * P
                      + static_cast<size_t>(n0) * P + p0;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const size_t po = so + static_cast<size_t>(pl) * N * P;
      if (has_h)
        stage<bf16, kPS>(reinterpret_cast<bf16*>(base + L.hh) + pl * NW * kLd32,
                         kLd32, hs + po, static_cast<size_t>(P), NW, nw, pw,
                         true, tid, kBCThreads);
      if (has_dh)
        stage<bf16, kPS>(reinterpret_cast<bf16*>(base + L.dh) + pl * NW * kLd32,
                         kLd32, dhs + po, static_cast<size_t>(P), NW, nw, pw,
                         true, tid, kBCThreads);
    }
    if (k % psl == 0)
      stage_dt(reinterpret_cast<float*>(base + L.dt), dt + tok0 * H + hh, H,
               l, tid);
    cp_commit();
  };

  float acc[NT][4], dd[8][4], tt[NT][4];
  float hd = 0.f;                       // <Dh, h> over this thread's share
  zero(acc);
  const size_t heads = static_cast<size_t>(chunks) * H;
  const size_t part0 = (rest % ntiles) * heads + static_cast<size_t>(bc) * H;
  if (stages > 0)
    ring(stages, fetch, [&](int k, int buf) {
      const unsigned char* base = smem + L.st + buf * L.stage;
      const T* sx = reinterpret_cast<const T*>(base);
      const float* sdy = reinterpret_cast<const float*>(base + L.dy);
      const bf16* zh =
          reinterpret_cast<const bf16*>(base + (role ? L.dh : L.hh));
      const int p = k % psl;
      if (p == 0) {
        zero(dd);
        zero(tt);
        if (warp == 0) {                     // this head's cumsum
          const float* sdt = reinterpret_cast<const float*>(base + L.dt);
          const float d0 = sdt[2 * lane], d1 = sdt[2 * lane + 1];
          float c0, c1;
          const float seg = cumsum2(d0, d1, A[g * Hg + k0 + k / psl] * kLog2e,
                                    lane, c0, c1);
          sCum[2 * lane] = c0;
          sCum[2 * lane + 1] = c1;
          sDtv[2 * lane] = d0;
          sDtv[2 * lane + 1] = d1;
          sEc[2 * lane] = ex2(c0);
          sEc[2 * lane + 1] = ex2(c1);
          sW[2 * lane] = ex2(seg - c0) * d0;
          sW[2 * lane + 1] = ex2(seg - c1) * d1;
        }
      }
      if (role == 0)      // D = dy x^T (rows i, j <= i), dy h^T
        role_products<float, T, true, NT>(sdy, sx, zh, zh + NW * kLd32, has_h,
                                          w, dd, tt);
      else                // D^T = x dy^T (rows j, i >= j), x Dh^T
        role_products<T, float, false, NT>(sx, sdy, zh, zh + NW * kLd32,
                                           has_dh, w, dd, tt);
      if (has_h && has_dh) {
        const bf16* hh_ = reinterpret_cast<const bf16*>(base + L.hh);
        const bf16* dh_ = reinterpret_cast<const bf16*>(base + L.dh);
        for (int e = tid; e < NW * kPS / 2; e += kBCThreads) {
          const int o = (e / (kPS / 2)) * kLd32 + 2 * (e % (kPS / 2));
          const float2 a = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dh_ + o));
          const float2 al = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(dh_ + NW * kLd32 + o));
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(hh_ + o));
          const float2 vl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(hh_ + NW * kLd32 + o));
          hd = fmaf(a.x + al.x, v.x + vl.x, hd);
          hd = fmaf(a.y + al.y, v.y + vl.y, hd);
        }
      }
      if (p == psl - 1) {
        const size_t part = part0 + g * Hg + k0 + k / psl;
        if (psl == 1)     // the head's cumsum (else its first stage's ring
          __syncthreads();  // barriers have passed since)
        if (role == 0 && has_h) {   // dy_i . (C h)_i = C_i . (dy h^T)_i
          const int gq = lane >> 2, tq = lane & 3;
          float in[2] = {0.f, 0.f};
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int row = 16 * w + gq + 8 * (q >> 1);
              in[q >> 1] = fmaf(to_f(sCt[row * L.ldbc + 8 * nt + 2 * tq +
                                         (q & 1)]), tt[nt][q], in[q >> 1]);
            }
          in[0] = quad_sum(in[0]);
          in[1] = quad_sum(in[1]);
          if (tq == 0) {
            inter_part[part * kChunk + 16 * w + gq] = in[0];
            inter_part[part * kChunk + 16 * w + gq + 8] = in[1];
          }
        }
        if (has_h && has_dh) {
          hd = repro::warp_sum(hd);
          if (lane == 0) hd_part[part * kBCWarps + warp] = hd;
          hd = 0.f;
        }
        const bool first = k < psl;
        if (role == 0)
          head_end<true, NT>(acc, dd, tt, has_h, first, sEc, sCum, sDtv, sG,
                             w);
        else
          head_end<false, NT>(acc, dd, tt, has_dh, first, sW, sCum, sDtv, sG,
                              w);
      }
    });
  else
    __syncthreads();
  if (stages > 0) {         // the summed G (G^T) times B (C): the thread's
    if (role == 0)          // own slots, B and C untouched since the start
      group_product<T, true, NT>(acc, sG, sBt, L.ldbc, w);
    else
      group_product<T, false, NT>(acc, sG, sCt, L.ldbc, w);
  }

  // ---- the cluster's sum, in rank order through distributed shared memory
  constexpr int kLdR = NW + 4;
  float* red = reinterpret_cast<float*>(smem + L.st);   // [2][64][kLdR]
  {
    const int gq = lane >> 2, tq = lane & 3;
    float* dst = red + role * kChunk * kLdR;
    const int r0 = 16 * w + gq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * tq;
      *reinterpret_cast<float2*>(dst + r0 * kLdR + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(dst + (r0 + 8) * kLdR + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  cluster.sync();
  {
    const int rows = (kChunk - rank + cs - 1) / cs;  // rank, rank + cs, ..
    for (int e = tid; e < 2 * rows * NW; e += kBCThreads) {
      const int which = e / (rows * NW), rc = e - which * rows * NW;
      const int row = rank + cs * (rc / NW), col = rc % NW;
      float* src = red + (which * kChunk + row) * kLdR + col;
      float s = 0.f;
      for (int q = 0; q < cs; ++q) s += *cluster.map_shared_rank(src, q);
      if (row < l && col < nw)
        (which ? dB : dC)[((tok0 + row) * G + g) * N + n0 + col] = from_f<T>(s);
    }
  }
  cluster.sync();           // no block leaves while another reads its sums
}

// ---------------------------------------------------------------------------
// 3. the per-head gradients: dx, ddt, dA's share
// ---------------------------------------------------------------------------
constexpr int kDxThreads = 128;

// rows of N a slice of the loop over N: 32, 16 on the fp32 path (two
// blocks an SM either way)
template <typename T>
constexpr int kNS = kSplit<T> ? 16 : 32;

// Byte offsets: x ([64][72] of T) and dy ([64][72] fp32) of a 64-column
// tile of P; G^T ([32][128] fp32, each thread's own values); two stages of
// B and C ([64][NS + 8] of T: rows are tokens) and the hi and lo planes of
// Dh ([2][NS][72] bf16: rows of N, the tile's columns of P); vectors.
struct DxLayout {
  int ldbc, dy, g, st, c, dh, stage, vec, total;
};

template <typename T>
__host__ __device__ inline DxLayout dx_layout() {
  DxLayout L;
  constexpr int es = sizeof(T);
  L.ldbc = kNS<T> + 8;
  L.dy = kChunk * kLd64 * es;
  L.g = L.dy + kChunk * kLd64 * 4;
  L.st = L.g + 32 * kDxThreads * 4;
  L.c = kChunk * L.ldbc * es;
  L.dh = 2 * L.c;
  L.stage = L.dh + 2 * kNS<T> * kLd64 * 2;
  L.vec = L.st + 2 * L.stage;
  L.total = L.vec + (12 * kChunk + 4) * 4;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kDxThreads, 2)
ssd_bwd_dx(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bg,
           const T* __restrict__ Cg, const float* __restrict__ dy,
           const bf16* __restrict__ dhs, const float* __restrict__ inter_part,
           const float* __restrict__ hd_part, T* __restrict__ dx,
           float* __restrict__ ddt, float* __restrict__ dA_part, int S, int H,
           int G, int N, int P, int nc, int chunks, int vec) {
  constexpr int NS = kNS<T>;
  constexpr bool SP = kSplit<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const DxLayout L = dx_layout<T>();
  T* sX = reinterpret_cast<T*>(smem);
  float* sDy = reinterpret_cast<float*>(smem + L.dy);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  float* sDt = reinterpret_cast<float*>(smem + L.vec);
  float* sCum = sDt + kChunk;              // cum * log2(e)
  float* sEc = sCum + kChunk;              // exp(cum)
  float* sWp = sEc + kChunk;               // exp(seg - cum)
  float* sRed = sWp + kChunk;              // [4][64]: a warp's column sums
  float* sCol = sRed + 4 * kChunk;         // colsum(G .* S) by j
  float* sBsum = sCol + kChunk;            // x_j . (B Dh)_j
  float* sDsum = sBsum + kChunk;           // x_j . (dx_j / dt_j)
  float* sMisc = sDsum + kChunk;           // [0] seg

  const int h = blockIdx.x % H;
  const int bc = blockIdx.x / H;
  const int c = bc % nc, b = bc / nc;
  const int g = h / (H / G);
  const int s0 = c * kChunk;
  const int l = S - s0 < kChunk ? S - s0 : kChunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int j0 = 16 * warp + gq, j1 = j0 + 8;    // the thread's two rows
  const size_t tok0 = static_cast<size_t>(b) * S + s0;
  const size_t st0 = ((static_cast<size_t>(b) * nc + c) * H + h) * 2 * N * P;
  const bool has_h = c > 0, has_dh = c < nc - 1;
  const int nslices = (N + NS - 1) / NS, ptiles = (P + 63) / 64;

  // x and dy, columns 64t.. of P (and dt with the first)
  auto fetch_xdy = [&](int t) {
    const int p0 = 64 * t, pw = P - p0 < 64 ? P - p0 : 64;
    const size_t off = (tok0 * H + h) * P + p0;
    stage<T, 64>(sX, kLd64, x + off, static_cast<size_t>(H) * P, kChunk, l,
                 pw, vec, tid, kDxThreads);
    stage<float, 64>(sDy, kLd64, dy + off, static_cast<size_t>(H) * P, kChunk,
                     l, pw, vec, tid, kDxThreads);
    if (t == 0) stage_dt(sDt, dt + tok0 * H + h, H, l, tid);
    cp_commit();
  };
  // slice s of N into buffer buf: B and C, and Dh at the columns 64t..
  auto fetch_slice = [&](int s, int buf, int t) {
    unsigned char* base = smem + L.st + buf * L.stage;
    const int n0 = s * NS, nw = N - n0 < NS ? N - n0 : NS;
    const size_t off = (tok0 * G + g) * N + n0;
    stage<T, NS>(reinterpret_cast<T*>(base), L.ldbc, Bg + off,
                 static_cast<size_t>(G) * N, kChunk, l, nw, vec, tid,
                 kDxThreads);
    stage<T, NS>(reinterpret_cast<T*>(base + L.c), L.ldbc, Cg + off,
                 static_cast<size_t>(G) * N, kChunk, l, nw, vec, tid,
                 kDxThreads);
    const int p0 = 64 * t, pw = P - p0 < 64 ? P - p0 : 64;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl) {
      const size_t so = st0 + static_cast<size_t>(pl) * N * P +
                        static_cast<size_t>(n0) * P + p0;
      if (has_dh)
        stage<bf16, 64>(reinterpret_cast<bf16*>(base + L.dh) + pl * NS * kLd64,
                        kLd64, dhs + so, static_cast<size_t>(P), NS, nw, pw,
                        true, tid, kDxThreads);
    }
    cp_commit();
  };

  fetch_xdy(0);
  fetch_slice(0, 0, 0);                     // the first slice, meanwhile
  cp_wait<1>();
  __syncthreads();                          // x, dy, dt

  // the chunk's cumsum
  const float a_h = A[h];
  if (warp == 0) {
    const float d0 = sDt[2 * lane], d1 = sDt[2 * lane + 1];
    float c0, c1;
    const float seg = cumsum2(d0, d1, a_h * kLog2e, lane, c0, c1);
    sCum[2 * lane] = c0;
    sCum[2 * lane + 1] = c1;
    sEc[2 * lane] = ex2(c0);
    sEc[2 * lane + 1] = ex2(c1);
    sWp[2 * lane] = ex2(seg - c0);
    sWp[2 * lane + 1] = ex2(seg - c1);
    if (lane == 0) sMisc[0] = seg;
  }

  // ---- D^T = x dy^T: rows j, columns i >= j (tiles 2 warp..); K = P ----
  float sS[8][4];
  {
    float sD[8][4];
    zero(sD);
    for (int t = 0; t < ptiles; ++t) {
      if (t > 0) {
        __syncthreads();                     // tile t - 1's reads done
        fetch_xdy(t);
        cp_wait<0>();
        __syncthreads();
      }
      const int ks = (P - 64 * t < 64 ? P - 64 * t : 64) / 16;
      for (int kk = 0; kk < ks; ++kk) {
        uint32_t ah[4], al[4];
        frag_a(sX, kLd64, 16 * warp, 16 * kk, ah, al);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np < warp) continue;
          uint32_t bh[4], bl[4];
          frag_b2(sDy, kLd64, 16 * np, 16 * kk, bh, bl);
          mma_split<SP, true>(sD[2 * np], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma_split<SP, true>(sD[2 * np + 1], ah, al, bh[2], bh[3], bl[2],
                              bl[3]);
        }
      }
    }
    __syncthreads();                         // the cumsum
    // G^T_ji = D^T_ji E_ij dt_j (i >= j), kept in this thread's slots
    const float cj0 = sCum[j0], cj1 = sCum[j1];
    const float dj0 = sDt[j0], dj1 = sDt[j1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 8 * nt + 2 * tq + (q & 1), j = q < 2 ? j0 : j1;
        sG[(4 * nt + q) * kDxThreads + tid] =
            i >= j ? sD[nt][q] * ex2(sCum[i] - (q < 2 ? cj0 : cj1)) *
                         (q < 2 ? dj0 : dj1)
                   : 0.f;
      }
  }

  // ---- per 64 columns of P: S^T = B C^T (first tile) and B Dh over the
  // slices of N; then M^T = S^T .* E and the sums of G .* S; M^T dy; dx ----
  zero(sS);
  float bsum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  const float wp0 = sWp[j0], wp1 = sWp[j1], dt0 = sDt[j0], dt1 = sDt[j1];
  for (int t = 0; t < ptiles; ++t) {
    const int p0 = 64 * t;
    if (ptiles > 1) {
      __syncthreads();
      fetch_xdy(t);
      cp_wait<0>();
      __syncthreads();
    }
    float sU[8][4];
    zero(sU);
    ring(nslices, [&](int s, int buf) { fetch_slice(s, buf, t); },
         [&](int, int buf) {
           const unsigned char* base = smem + L.st + buf * L.stage;
           const T* sb = reinterpret_cast<const T*>(base);
           const T* sc = reinterpret_cast<const T*>(base + L.c);
           const bf16* dH = reinterpret_cast<const bf16*>(base + L.dh);
#pragma unroll
           for (int kk = 0; kk < NS / 16; ++kk) {
             uint32_t ah[4], al[4];
             frag_a(sb, L.ldbc, 16 * warp, 16 * kk, ah, al);     // B: rows j
             if (t == 0)              // S^T: rows j, columns i >= j
#pragma unroll
               for (int np = 0; np < 4; ++np) {
                 if (np < warp) continue;
                 uint32_t bh[4], bl[4];
                 frag_b2(sc, L.ldbc, 16 * np, 16 * kk, bh, bl);
                 mma_split<SP, SP>(sS[2 * np], ah, al, bh[0], bh[1], bl[0],
                                   bl[1]);
                 mma_split<SP, SP>(sS[2 * np + 1], ah, al, bh[2], bh[3],
                                   bl[2], bl[3]);
               }
             if (has_dh)              // B Dh: rows j, K = n
#pragma unroll
               for (int pp = 0; pp < 4; ++pp) {
                 uint32_t bh[4], bl[4];
                 frag_bt2_pl(dH, dH + NS * kLd64, kLd64, 16 * pp, 16 * kk, bh,
                             bl);
                 mma_split<SP, true>(sU[2 * pp], ah, al, bh[0], bh[1], bl[0],
                                     bl[1]);
                 mma_split<SP, true>(sU[2 * pp + 1], ah, al, bh[2], bh[3],
                                     bl[2], bl[3]);
               }
           }
         },
         t == 0);
    if (t == 0) {   // M^T = S^T .* E in place; the sums of G .* S
      const float cj0 = sCum[j0], cj1 = sCum[j1];
      float colv[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float rsum[2] = {0.f, 0.f};
        if (nt >= 2 * warp) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = 8 * nt + 2 * tq + (q & 1), j = q < 2 ? j0 : j1;
            float& s = sS[nt][q];
            const float v = sG[(4 * nt + q) * kDxThreads + tid] * s;
            colv[q >> 1] += v;
            rsum[q & 1] += v;
            // exp only on and below the diagonal
            s = i >= j ? s * ex2(sCum[i] - (q < 2 ? cj0 : cj1)) : 0.f;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {        // over the tile's 8 rows of lanes
          float v = rsum[e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gq == 0) sRed[warp * kChunk + 8 * nt + 2 * tq + e] = v;
        }
      }
      colv[0] = quad_sum(colv[0]);
      colv[1] = quad_sum(colv[1]);
      if (tq == 0) {
        sCol[j0] = colv[0];
        sCol[j1] = colv[1];
      }
    }
    // M^T dy (rows j, K = i >= j)
    float sM[8][4];
    zero(sM);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < warp) continue;
      uint32_t ah[4], al[4];
      split2(sS[2 * kk][0], sS[2 * kk][1], ah[0], al[0]);
      split2(sS[2 * kk][2], sS[2 * kk][3], ah[1], al[1]);
      split2(sS[2 * kk + 1][0], sS[2 * kk + 1][1], ah[2], al[2]);
      split2(sS[2 * kk + 1][2], sS[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t bh[4], bl[4];
        frag_bt2(sDy, kLd64, 16 * pp, 16 * kk, bh, bl);
        mma_split<true, true>(sM[2 * pp], ah, al, bh[0], bh[1], bl[0], bl[1]);
        mma_split<true, true>(sM[2 * pp + 1], ah, al, bh[2], bh[3], bl[2],
                              bl[3]);
      }
    }
    // dx_j = dt_j (M^T dy + exp(seg - cum_j) B Dh)_j
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * tq;
      if (p0 + col >= P) continue;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int j = rr ? j1 : j0;
        const float wpj = rr ? wp1 : wp0;
        const float x0 = to_f(sX[j * kLd64 + col]);
        const float x1 = to_f(sX[j * kLd64 + col + 1]);
        const float u0 = sU[nt][2 * rr], u1 = sU[nt][2 * rr + 1];
        const float v0 = fmaf(wpj, u0, sM[nt][2 * rr]);
        const float v1 = fmaf(wpj, u1, sM[nt][2 * rr + 1]);
        bsum[rr] += x0 * u0 + x1 * u1;
        dsum[rr] += x0 * v0 + x1 * v1;
        if (j < l) {
          const float d = rr ? dt1 : dt0;
          store2(dx + (tok0 + j) * H * P + static_cast<size_t>(h) * P + p0 +
                     col, d * v0, d * v1);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    bsum[rr] = quad_sum(bsum[rr]);
    dsum[rr] = quad_sum(dsum[rr]);
  }
  if (tq == 0) {
    sBsum[j0] = bsum[0];
    sBsum[j1] = bsum[1];
    sDsum[j0] = dsum[0];
    sDsum[j1] = dsum[1];
  }
  __syncthreads();

  // ---- dcum, its reverse cumsum dda, ddt and this chunk's share of dA ----
  if (warp == 0) {
    // dy_i . (C h)_i and <Dh, h>, ssd_bwd_dbdc's per 128 columns of N (and
    // per warp), summed in order
    const int ntiles = (N + kNW - 1) / kNW;
    const size_t heads = static_cast<size_t>(chunks) * H, blk = blockIdx.x;
    float hdt = 0.f, inter[2] = {0.f, 0.f};
    for (int t = 0; t < ntiles; ++t) {
      if (has_h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          inter[e] += inter_part[(t * heads + blk) * kChunk + 2 * lane + e];
      if (has_h && has_dh)
        for (int w = 0; w < kBCWarps; ++w)
          hdt += hd_part[(t * heads + blk) * kBCWarps + w];
    }
    float d[2], wb = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      const float row = sRed[j] + sRed[kChunk + j] + sRed[2 * kChunk + j] +
                        sRed[3 * kChunk + j];
      const float wbj = sWp[j] * sDt[j] * sBsum[j];
      d[e] = row - sCol[j] + sEc[j] * inter[e] - wbj;
      wb += wbj;
    }
    wb = repro::warp_sum(wb);
    if (lane == 31) d[1] += ex2(sMisc[0]) * hdt + wb;   // d seg
    float incl = d[0] + d[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    float excl = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) excl = 0.f;
    const float dda[2] = {excl + d[1] + d[0], excl + d[1]};
    float dap = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      if (j < l) {
        ddt[(tok0 + j) * H + h] = fmaf(a_h, dda[e], sDsum[j]);
        dap = fmaf(sDt[j], dda[e], dap);
      }
    }
    dap = repro::warp_sum(dap);
    if (lane == 0) dA_part[static_cast<size_t>(bc) * H + h] = dap;
  }
}

// ---------------------------------------------------------------------------
// 4. dA: the chunks' shares summed in order
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
ssd_bwd_da(const float* __restrict__ dA_part, float* __restrict__ dA, int H,
           int chunks) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < chunks; ++k)
      s += dA_part[static_cast<size_t>(k) * H + h];
    dA[h] = s;
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
                   void* ddt, void* dA, void* dB, void* dC, void* hs,
                   void* dhs, void* dA_part, void* inter_part, void* hd_part,
                   int Bt, int S, int H, int G, int N, int P,
                   cudaStream_t stream) {
  const int nc = (S + kChunk - 1) / kChunk;
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = N % (16 / static_cast<int>(sizeof(T))) == 0 &&
                  aligned(x) && aligned(B) && aligned(C) && aligned(dy);
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* Bt_ = static_cast<const T*>(B);
  const T* Ct = static_cast<const T*>(C);
  const float* dyf = static_cast<const float*>(dy);
  bf16* hsb = static_cast<bf16*>(hs);
  bf16* dhsb = static_cast<bf16*>(dhs);

  const ScanLayout fw = scan_layout<T, T>(N), rv = scan_layout<T, float>(N);
  const int scan_bytes = fw.total > rv.total ? fw.total : rv.total;
  cudaError_t e = smem_opt_in(ssd_bwd_scan<T>, scan_bytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_scan<T><<<dim3(static_cast<unsigned>(Bt) * H *
                             ((P + kScanPT - 1) / kScanPT), 2),
                    kScanThreads, scan_bytes, stream>>>(
      xt, dtf, Af, Bt_, Ct, dyf, hsb, dhsb, S, H, G, N, P, nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int bc_bytes = bc_layout<T>().total;
  e = smem_opt_in(ssd_bwd_dbdc<T>, bc_bytes);
  if (e != cudaSuccess) return e;
  const int cs = H / G < kMaxCluster ? H / G : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cs) * ((N + kNW - 1) / kNW) *
                     Bt * nc * G);
  cfg.blockDim = dim3(kBCThreads);
  cfg.dynamicSmemBytes = bc_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_bwd_dbdc<T>, xt, dtf, Af, Bt_, Ct, dyf,
                         static_cast<const bf16*>(hsb),
                         static_cast<const bf16*>(dhsb), static_cast<T*>(dB),
                         static_cast<T*>(dC), static_cast<float*>(inter_part),
                         static_cast<float*>(hd_part), S, H, G, N, P, nc,
                         Bt * nc, vec);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int dx_bytes = dx_layout<T>().total;
  e = smem_opt_in(ssd_bwd_dx<T>, dx_bytes);
  if (e != cudaSuccess) return e;
  ssd_bwd_dx<T><<<static_cast<unsigned>(Bt) * nc * H, kDxThreads, dx_bytes,
                  stream>>>(xt, dtf, Af, Bt_, Ct, dyf, dhsb,
                            static_cast<const float*>(inter_part),
                            static_cast<const float*>(hd_part),
                            static_cast<T*>(dx), static_cast<float*>(ddt),
                            static_cast<float*>(dA_part), S, H, G, N, P, nc,
                            Bt * nc, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  ssd_bwd_da<<<1, 256, 0, stream>>>(static_cast<const float*>(dA_part),
                                    static_cast<float*>(dA), H, Bt * nc);
  return cudaGetLastError();
}

// The scratch of a call, carved from one buffer: hs and dhs, (Bt, nc, H,
// 2, N, P) bf16 each (the hi and lo planes of each chunk's state and state
// gradient); fp32 dA_part (Bt * nc, H), inter_part (ceil(N/kNW), Bt * nc *
// H, 64) and hd_part (ceil(N/kNW), Bt * nc * H, kBCWarps); nc = ceil(S/64).
// Each piece starts on 256 bytes; offsets in bytes.
struct Scratch {
  size_t hs, dhs, dA_part, inter_part, hd_part, total;
};

Scratch scratch_of(int Bt, int S, int H, int N, int P) {
  const size_t nc = (S + kChunk - 1) / kChunk;
  const size_t heads = static_cast<size_t>(Bt) * nc * H;
  const size_t tiles = (N + kNW - 1) / kNW;
  auto up = [](size_t b) { return (b + 255) / 256 * 256; };
  const size_t planes = up(heads * 2 * N * P * sizeof(bf16));
  Scratch s;
  s.hs = 0;
  s.dhs = planes;
  s.dA_part = 2 * planes;
  s.inter_part = s.dA_part + up(heads * sizeof(float));
  s.hd_part = s.inter_part + up(tiles * heads * kChunk * sizeof(float));
  s.total = s.hd_part + up(tiles * heads * kBCWarps * sizeof(float));
  return s;
}

}  // namespace

// Bytes of the scratch buffer that repro_ssd_bwd takes for these sizes.
extern "C" long long repro_ssd_bwd_scratch_bytes(int Bt, int S, int H, int N,
                                                 int P) {
  return static_cast<long long>(scratch_of(Bt, S, H, N, P).total);
}

// x (Bt,S,H,P), B and C (Bt,S,G,N) of dtype `dtype`, dt (Bt,S,H), A (H,)
// and dy (Bt,S,H,P) fp32, all contiguous. Writes dx (x's shape and dtype),
// ddt (Bt,S,H) and dA (H,) fp32, dB and dC (B's shape and dtype). scratch:
// repro_ssd_bwd_scratch_bytes(Bt, S, H, N, P) bytes on the device, 256-byte
// aligned. The caller checked H % G == 0; P must be a multiple of 16 and 1
// <= N <= 256, or the call returns cudaErrorInvalidValue. Four launches on
// `stream`, in order.
extern "C" int repro_ssd_bwd(const void* x, const void* dt, const void* A,
                             const void* B, const void* C, const void* dy,
                             void* dx, void* ddt, void* dA, void* dB,
                             void* dC, void* scratch, int Bt, int S, int H,
                             int G, int N, int P, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > kMaxN || P < kPTile || P % kPTile || S < 1 || Bt < 1 ||
      G < 1 || H % G || reinterpret_cast<uintptr_t>(scratch) % 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = scratch_of(Bt, S, H, N, P);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  void* hs = base + sc.hs;
  void* dhs = base + sc.dhs;
  void* dA_part = base + sc.dA_part;
  void* inter_part = base + sc.inter_part;
  void* hd_part = base + sc.hd_part;
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    e = launch<float>(x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, hs, dhs,
                      dA_part, inter_part, hd_part, Bt, S, H, G, N, P, s);
  else if (dtype == repro::kBFloat16)
    e = launch<__nv_bfloat16>(x, dt, A, B, C, dy, dx, ddt, dA, dB, dC, hs,
                              dhs, dA_part, inter_part, hd_part, Bt, S, H, G,
                              N, P, s);
  return static_cast<int>(e);
}
