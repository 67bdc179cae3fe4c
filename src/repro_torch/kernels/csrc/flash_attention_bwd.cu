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
// chunk; the ragged S and T edges; a masked pair has P = 0, a row with no
// key lse = +inf and so a zero gradient) and its tanh softcap (cap > 0):
//   s = scale * q k^T,  c = cap * tanh(s / cap) (c = s without a cap)
//   P = exp(c - lse)                    dV = P^T dO
//   dP = dO v^T                         Delta = rowsum(dO * o)
//   dS = P * (dP - Delta) * (1 - (c / cap)^2)   (the last factor: the cap's)
//   dQ = scale * dS k,  dK = scale * dS^T q
//
// Two kernels, each launched once per backward, in this order:
//   dq:   one block per (b * H + h, query tile): Delta of its rows from dO
//         and o (written out for the second kernel), then the key tiles its
//         rows reach, P and dS recomputed per tile, dQ summed in registers;
//   dkdv: one block per (b * KV + kvh, key tile): the G query heads of the
//         kv head and every query tile that reaches the key tile, P and dS
//         recomputed, dK and dV summed in registers over heads and tiles
//         (the tensor-core instance may split the heads over a cluster,
//         below).
// No atomics: every output element is summed in a fixed order (by one
// thread, and over a cluster's blocks in block order), so two calls are
// bitwise equal.
//
// Bound on the H100 at the training shape (llama3.2-3b, B = 4, S = 1024,
// 24/8 heads, D = 128, bf16, causal): operations. The recomputation makes it
// 7 D multiply-adds per attended pair (dq: q k^T, dO v^T, dS k; dkdv: q k^T,
// dO v^T, P^T dO, dS^T q) against the 5 D of one fused pass with atomics,
// 2.5x the forward's 2 D; 50.4 M pairs, 64.5 GFLOP of the 5 D count, 65 us
// at 989 TFLOP/s bf16 (90 GFLOP, 91 us, of the 7 D this design does)
// against 0.96 ms at 67 TFLOP/s fp32. The bytes, q, k, v, o, dO and the
// three gradients, are ~100 MB, 30 us.
//
// A cap adds one tanh a pair in each kernel (~20 fp32 operations beside
// 7 D multiply-adds); the bound stays the products'. gemma2-9b's step
// (4 x 1,024, 16/8 heads of 256, cap 50): 33.6 M pairs, 87 us of the 5 D
// count; h2o-danube-3-4b's (32/8 heads of 120): 67.2 M pairs, 81 us.
//
// Design: two instances, chosen by dtype in the wrapper (ops.py), never
// one for the other: bf16 on the tensor cores at every head dim, fp32 on
// the CUDA cores. The cap is a template flag of each (CAP): the instances
// without it are the code they were before it came; cap > 0 runs the CAP
// instance, which recomputes each pair's tanh with the forward's
// arithmetic (tanhf of s scale / cap), so P comes from the logits whose lse
// the forward wrote.
//
// bf16 at D = 32, 64, 128 (and 120): tensor cores (the redesign of the
// CUDA-core version below, which took 5.64 ms at the training shape). One
// warpgroup (128 threads) a block; every tile is 64 rows (queries or keys)
// x D, in shared memory in the 128-byte swizzle (64-byte at D = 32) that
// the wgmma descriptors read, loaded by TMA over 4-D tensor maps of the
// (B, S|T, H|KV, D) tensors (rows past S or T read as zeros) with mbarrier
// completion (hopper.cuh, shared with the forward). All five products are wgmma
// m64n64k16 (m64n32k16 for the D = 32 outputs) with fp32 accumulators:
//   dq:   Q and dO resident, K and V streamed through two stages; S = Q K^T
//         and dP = dO V^T with both operands in shared memory (K-major);
//         P = exp2(S scale log2e - lse log2e) and dS = P (dP - Delta) in
//         registers on the accumulator layout, which is the A-operand
//         layout of the next product, so dS goes to dQ += dS K as bf16
//         register fragments with K read MN-major from the same stage;
//   dkdv: K and V resident, (Q, dO) of each (q head, query tile) streamed
//         through two stages with the tile's lse and Delta; the transposed
//         products S^T = K Q^T and dP^T = V dO^T put the keys on wgmma's M,
//         so P^T and dS^T are register fragments for dV += P^T dO and
//         dK += dS^T Q (dO and Q MN-major): nothing passes through shared
//         memory between the products. Where the (kv head, key tile)
//         blocks leave SMs idle (one sequence, B = 1: 128 blocks for 132
//         SMs at llama3.2-3b's 1,024 tokens), the kv head's G q heads are
//         split over a thread block cluster (a divisor of G up to 8: all 3
//         of llama's), and at the end the cluster's blocks sum their dK
//         and dV through distributed shared memory in block order.
// P and dS are split into two bf16 fragments, the rounded value and the
// rounded remainder, each multiplied: one bf16 rounding of P and dS missed
// the bf16 tolerance against the fp32 plain backward (atol 1e-3 + rtol
// 1e-2) on ~0.1% of the gradients; the split costs 10 D multiply-adds a
// pair instead of 7 D.
// The masks are one interval of visible keys per query row (dq) or of
// visible queries per key row (dkdv), applied on tiles that cross a mask or
// edge only; a query past S gets lse = +inf, so P = 0. Query tiles run
// causally heaviest first in dq (blockIdx.y reversed), key tile 0 first in
// dkdv. At D = 128 each kernel takes 96 KB of shared memory, two blocks an
// SM. Registers per thread from ptxas (build.log), no spills, at D = 32 /
// 64 / 128 (and the DH = 120 instance as 128): dq 109 / 126 / 154, dkdv
// 142 / 181 / 239; with the cap dq 128 / 127 / 168, dkdv 134 / 182 / 252
// (chip_smoke.py phase 1 prints them and fails if a tensor-core instance
// spills).
//
// What bounds it: each tile is a chain of dependent steps in one warpgroup,
// product, exponentials, product, with no overlap inside the block; two
// blocks an SM overlap each other's chains. At the training shape the pair
// runs at ~315 TFLOP/s of the 7 D count, 0.287 ms against 5.64 ms for the
// CUDA-core version (PERF.md), level with SDPA's backward.
//
// bf16 at D = 256 (gemma2-9b): the same pair with two warpgroups a block
// (256 threads), each owning half of the head dim of every accumulator
// (WB::NW = 2, DW = 128 columns, two of the four 64-column boxes). One
// warpgroup's dK and dV over all 256 columns would take 256 fp32 registers
// a thread, and dQ with S, dP and the fragments would pass 255; a half is
// the D = 128 profile (dq 64 accumulator registers, dkdv 128). The two
// 64 x 64 reductions over D of a tile (S and dP in dq, S^T and dP^T in
// dkdv) are split between the warpgroups, one each over all four boxes
// (16 k-steps), and swapped through a 32 KB buffer in shared memory
// between two barriers (swap_products); both warpgroups then compute the
// same P and dS with the same arithmetic, bitwise equal, and each issues
// its half of dQ, or of dK and dV, over its own two boxes of K, or of Q and
// dO. No product is computed twice; Delta is summed over each warpgroup's
// columns and the halves added in one order. Shared memory: dq 229,912
// bytes (Q and dO resident, two (K, V) stages, the swap, Delta's halves),
// dkdv 230,424 (K and V, two (Q, dO) stages with their statistics, the
// swap), one block an SM: 8 warps, as two D = 128 blocks. So dk/dv's
// cluster rule fills one block an SM here: gemma2 at B = 1 (8 kv heads x
// 16 key tiles = 128 blocks) splits its G = 2 over a cluster of two, whose
// sum takes 128 KB of the freed tiles. Registers per thread from ptxas, no
// spills: dq 188, dkdv 240; with the cap 190 / 254. At gemma2's step
// (4 x 1,024, 16/8 heads, causal, cap 50) the pair takes 0.619 ms (dq
// 0.303, dk/dv 0.322) against 12.44 ms for the CUDA-core version, 0.519
// uncapped against SDPA's 0.430 (NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md): 194 and 232 TFLOP/s of the 7 D count, against the D = 128
// pair's ~315, since the warpgroups meet at the swap and the one block
// an SM leaves no second block to run its products while this one runs
// its exponentials. The swap costs ~10% (flash_bwd_sweep.py: a register
// copy in its place, the gradients wrong, 0.567 ms capped), less than
// each warpgroup computing both reductions would (by count, 16 more
// k-steps a tile, half again its products); the cluster split at B = 1
// takes dk/dv from 0.152 to 0.108 ms.
//
// fp32: CUDA cores (tf32 would not hold the 1e-4 fp32 tolerance). Tiles
// of 64 rows (32 at D = 256) staged in shared memory, rows padded by one
// float so that the strided reads of a product fall on distinct banks; 256
// threads, each holding a 16-strided (rows, columns) sub-tile of every
// product in registers (4 x 4 of a 64 x 64 tile, 4 x D/16 of a 64 x D
// one). Blocks run their tiles in causal order with a uniform reach test
// per tile; masked pairs inside a tile are zeroed.
//
// Head dim 120 (h2o-danube-3-4b) runs in the D = 128 instances, as in the
// forward: the tensor-core pair loads q, k, v and dO through 4-D tensor maps
// (B, S|T, heads, 120) whose 128-column boxes TMA fills with zeros past
// column 120 (every D loads through such maps: a head's tile is one box
// per 64 columns, the same bytes and swizzle as the 3-D maps of (B, S|T,
// heads * D) before); the zero columns add nothing to a product, Delta
// reads o and dO at their row stride of 120, and the stores skip columns
// 120..127. The CUDA-core instance zero-fills those columns in shared
// memory. The head dim is a template argument beside the tile width (DH
// <= D): the D = 128 instances with DH = 128 are the code they were, and
// DH = 120 is an instance of its own (with the head dim a runtime
// argument of the D = 128 pair, the pair took 6% longer at llama's shape,
// its dq 13%; PERF.md). The wrapper passes the true scale
// 120^-0.5.
// flash_bwd_sweep.py builds its variants of the D = 256 pair at the lines
// tagged "sweep:".
#include <cuda.h>
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace repro::sm90;

// ---------------------------------------------------------------------------
// CUDA cores: fp32
// ---------------------------------------------------------------------------
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

// rows [r0, r0 + T) of one head of a (B, L, heads, dh) tensor into a padded
// fp32 tile of D columns, rows past L and columns past dh as zeros
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src, int b,
                                          int L, int heads, int head, int r0,
                                          int dh) {
  using C = BT<D>;
  for (int idx = threadIdx.x; idx < C::T * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, row = r0 + r;
    dst[r * C::DP + c] =
        row < L && c < dh
            ? src[((static_cast<size_t>(b) * L + row) * heads + head) * dh +
                  c]
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
// and sdS, both [T][TP]; CAP: the logits are cap * tanh(s scale / cap), as
// the fp32 forward computes them, and dS takes their derivative
template <int D, bool CAP>
__device__ __forceinline__ void p_and_ds(
    const float (&s)[BT<D>::TM][BT<D>::TM],
    const float (&dp)[BT<D>::TM][BT<D>::TM], const float* __restrict__ sLse,
    const float* __restrict__ sDelta, float* __restrict__ sP,
    float* __restrict__ sdS, int q0, int k0, int S, int T_len, float scale,
    int causal, int window, int chunk, float cap, int ty, int tx) {
  using C = BT<D>;
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < C::TM; ++j) {
      const int c = tx + 16 * j;
      float x = s[i][j] * scale, t = 0.f;
      if constexpr (CAP) {
        t = tanhf(x / cap);
        x = cap * t;
      }
      const float p =
          visible(q0 + r, k0 + c, S, T_len, causal, window, chunk)
              ? expf(x - sLse[r])
              : 0.f;
      if (sP != nullptr) sP[r * C::TP + c] = p;
      float ds = p * (dp[i][j] - sDelta[r]);
      if constexpr (CAP) ds *= 1.f - t * t;
      sdS[r * C::TP + c] = ds;
    }
  }
}

template <int D, int DH, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ delta,
                    float* __restrict__ dq, int S, int T_len, int H, int KV,
                    float scale, int causal, int window, int chunk,
                    float cap) {
  using C = BT<D>;
  constexpr int dh = DH;      // the tensors' head dim, <= D
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

  load_tile<D>(sQ, q, b, S, H, h, q0, dh);
  load_tile<D>(sdO, dout, b, S, H, h, q0, dh);
  for (int r = tid; r < C::T; r += kThreads)
    sLse[r] = q0 + r < S ? lse[static_cast<size_t>(bh) * S + q0 + r]
                         : INFINITY;
  __syncthreads();
  // Delta = rowsum(dO * o), one warp per row
  for (int r = warp; r < C::T; r += kThreads / 32) {
    const int qp = q0 + r;
    float acc = 0.f;
    if (qp < S) {
      const float* orow = o + ((static_cast<size_t>(b) * S + qp) * H + h) * dh;
      for (int c = lane; c < dh; c += 32)
        acc = fmaf(sdO[r * C::DP + c], orow[c], acc);
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
    load_tile<D>(sK, k, b, T_len, KV, kvh, k0, dh);
    load_tile<D>(sV, v, b, T_len, KV, kvh, k0, dh);
    __syncthreads();
    float s[C::TM][C::TM], dp[C::TM][C::TM];
    zero(s);
    zero(dp);
    mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(s, sQ, sK, ty, tx);
    mm<C::TM, C::TM, D, C::DP, 1, C::DP, 1>(dp, sdO, sV, ty, tx);
    p_and_ds<D, CAP>(s, dp, sLse, sDelta, nullptr, sdS, q0, k0, S, T_len,
                     scale, causal, window, chunk, cap, ty, tx);
    __syncthreads();
    // dQ(r, d) += sum_c dS(r, c) K(c, d)
    mm<C::TM, C::DN, C::T, C::TP, 1, 1, C::DP>(acc, sdS, sK, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= S) continue;
    float* out = dq + ((static_cast<size_t>(b) * S + qp) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < C::DN; ++j)
      if (tx + 16 * j < dh) out[tx + 16 * j] = acc[i][j] * scale;
  }
}

template <int D, int DH, bool CAP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, int S, int T_len, int H, int KV,
                      float scale, int causal, int window, int chunk,
                      float cap) {
  using C = BT<D>;
  constexpr int dh = DH;
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

  load_tile<D>(sK, k, b, T_len, KV, kvh, k0, dh);
  load_tile<D>(sV, v, b, T_len, KV, kvh, k0, dh);
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
      load_tile<D>(sQ, q, b, S, H, h, q0, dh);
      load_tile<D>(sdO, dout, b, S, H, h, q0, dh);
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
      p_and_ds<D, CAP>(s, dp, sLse, sDelta, sP, sdS, q0, k0, S, T_len,
                       scale, causal, window, chunk, cap, ty, tx);
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
    const size_t off =
        ((static_cast<size_t>(b) * T_len + kp) * KV + kvh) * dh;
#pragma unroll
    for (int j = 0; j < C::DN; ++j) {
      if (tx + 16 * j >= dh) continue;
      dk[off + tx + 16 * j] = acc_k[i][j] * scale;
      dv[off + tx + 16 * j] = acc_v[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// tensor cores: bf16 at D = 32, 64, 128, 256 (wgmma, TMA)
// ---------------------------------------------------------------------------
constexpr int kT = 64;           // rows of every tile: 64 queries or 64 keys
constexpr int kWS = 2;           // stages of the streamed tiles

template <int D>
struct WB {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle row, bytes
  static constexpr int SWE = SW / 2;              // bf16 per swizzle row
  static constexpr int NB = D / SWE;              // column boxes of a row
  static constexpr int NO = SWE / 2;              // accumulator floats a box
  static constexpr int TILE = kT * D * 2;         // one 64 x D bf16 tile
  // warpgroups a block: two at D = 256, each owning DW = D / NW columns
  // (NBW boxes) of every accumulator
  static constexpr int NW = D > 128 ? 2 : 1;
  static constexpr int NT = 128 * NW;             // threads a block
  static constexpr int DW = D / NW;
  static constexpr int NBW = NB / NW;
  // D = 256: the swap of the two 64 x 64 fp32 products of a tile, and
  // (dq) the two warpgroups' halves of Delta
  static constexpr int XCH = NW == 2 ? 2 * kT * kT * 4 : 0;
  static constexpr int PART = NW == 2 ? 2 * kT * 4 : 0;
  // the blocks an SM that dk/dv's cluster rule fills (shared memory)
  static constexpr int PER_SM = NW == 2 ? 1 : 2;
  // two resident tiles, kWS stages of two streamed tiles, (dkdv) each
  // stage's lse and Delta, the swap and the barriers
  static constexpr int SMEM_DQ =
      2 * TILE + kWS * 2 * TILE + XCH + PART + 8 * (kWS + 1);
  static constexpr int SMEM_DKDV =
      2 * TILE + kWS * 2 * TILE + kWS * 2 * kT * 4 + XCH + 8 * (kWS + 1);
};
static_assert(WB<256>::SMEM_DKDV <= 232448 && WB<256>::SMEM_DQ <= 232448,
              "D = 256 exceeds a block's shared memory");

// acc (64 x 64) = A B^T over D, for A and B two 64-row tiles read K-major
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t sa,
                                          uint32_t sb) {
  using C = WB<D>;
  const uint64_t da = make_desc<C::SW>(sa, 16, 8 * C::SW);
  const uint64_t db = make_desc<C::SW>(sb, 16, 8 * C::SW);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns: box kk*16/SWE, byte offset (kk*16 % SWE)*2 in its row
    const uint32_t col = ((kk * 16) % C::SWE) * 2, box = (kk * 16) / C::SWE;
    const uint32_t off = (box * kT * C::SW + col) >> 4;
    wgmma_ss_n64(acc, da + off, db + off, kk > 0);
  }
}

// acc (64 x D) += A B, for A (64 x 64) in bf16 register fragments and B a
// 64-row tile read MN-major (one swizzle atom across N an instruction)
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[WB<D>::NB][WB<D>::NO],
                                         const uint32_t (&a)[4][4],
                                         uint32_t sb) {
  using C = WB<D>;
  const uint64_t db = make_desc<C::SW>(sb, 8 * C::SW, 8 * C::SW);
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk)
#pragma unroll
    for (int c = 0; c < C::NB; ++c)
      wgmma_rs<C::SWE>(acc[c], a[kk],
                       db + ((c * kT * C::SW + kk * 16 * C::SW) >> 4));
}

template <int NB, int NO>
__device__ __forceinline__ void fence_acc(float (&acc)[NB][NO]) {
#pragma unroll
  for (int c = 0; c < NB; ++c) fence_regs(acc[c]);
}

// D = 256: the two warpgroups meet (named barrier 1; __syncthreads is 0)
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// D = 256: the two 64 x 64 products of a tile, x (in s) in each warpgroup,
// swapped through shared memory: register i of thread wt goes to float4
// (wg * 8 + i / 4) * 128 + wt, so thread wt of the other warpgroup, which
// holds the same positions, reads it back without a bank conflict. Then
// (s, dp) = (x, the other's x) in warpgroup 0 and the reverse in 1: both
// hold the same (S, dP) or (S^T, dP^T). The barrier on the other side of
// the swap is the block's __syncthreads that ends each tile.
__device__ __forceinline__ void swap_products(float (&s)[32], float (&dp)[32],
                                              float* xch, int wg, int wt) {
  float4* mine = reinterpret_cast<float4*>(xch) + wg * 8 * 128 + wt;
  const float4* other =
      reinterpret_cast<const float4*>(xch) + (1 - wg) * 8 * 128 + wt;
#pragma unroll
  for (int j = 0; j < 8; ++j)
    mine[j * 128] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2],
                                s[4 * j + 3]);
  pair_sync();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 y = other[j * 128];
    dp[4 * j] = y.x;
    dp[4 * j + 1] = y.y;
    dp[4 * j + 2] = y.z;
    dp[4 * j + 3] = y.w;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float a = s[i], b = dp[i];
    s[i] = wg ? b : a;
    dp[i] = wg ? a : b;
  }
}

// the key tiles that the query tile at q0 reaches, [lo, hi]
__device__ __forceinline__ void key_tiles(int q0, int T_len, int causal,
                                          int window, int chunk, int& lo,
                                          int& hi) {
  const int q1 = q0 + kT - 1;
  lo = 0;
  hi = (T_len + kT - 1) / kT - 1;
  if (causal) hi = min(hi, q1 / kT);
  if (window) lo = max(lo, max(0, q0 - window + 1) / kT);
  if (chunk) {
    lo = max(lo, (q0 / chunk) * chunk / kT);
    hi = min(hi, ((q1 / chunk + 1) * chunk - 1) / kT);
  }
}

// the query tiles that reach the key tile at k0, [lo, hi]
__device__ __forceinline__ void query_tiles(int k0, int S, int causal,
                                            int window, int chunk, int& lo,
                                            int& hi) {
  const int k1 = k0 + kT - 1;
  lo = 0;
  hi = (S + kT - 1) / kT - 1;
  if (causal) lo = max(lo, k0 / kT);
  if (window) hi = min(hi, (k1 + window - 1) / kT);
  if (chunk) {
    lo = max(lo, (k0 / chunk) * chunk / kT);
    hi = min(hi, ((k1 / chunk + 1) * chunk - 1) / kT);
  }
}

// the queries that see key kp, [lo, hi): visible_keys (hopper.cuh) seen
// from the key
__device__ __forceinline__ void queries_of(int kp, int S, int T_len,
                                           int causal, int window, int chunk,
                                           int& lo, int& hi) {
  lo = 0;
  hi = kp < T_len ? S : 0;
  if (causal) lo = max(lo, kp);
  if (window) hi = min(hi, kp + window);
  if (chunk) {
    lo = max(lo, (kp / chunk) * chunk);
    hi = min(hi, (kp / chunk) * chunk + chunk);
  }
}

// the D columns of one 64-row tile of head `head` of a (B, L, heads, dh)
// map, by box (columns past dh as zeros)
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         int nb, int sw, int swe, int head,
                                         int row0, int b, uint32_t bar) {
  for (int c = 0; c < nb; ++c)
    tma_load_4d(dst + c * kT * sw, map, c * swe, head, row0, b, bar);
}

// the capped log2-domain logit of a raw score x = q . k, cap * log2(e) *
// tanh(x * scale / cap), with the forward's constants (cin = scale / cap,
// cout = cap * log2(e)), and 1 - tanh^2, the cap's factor of dS
__device__ __forceinline__ float capped_logit2(float x, float cin, float cout,
                                               float& dfac) {
  const float t = tanhf(x * cin);
  dfac = 1.f - t * t;
  return t * cout;
}

template <int D, int DH, bool CAP>
__global__ void __launch_bounds__(WB<D>::NT)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int S, int T_len, int H,
                   int KV, float scale, int causal, int window, int chunk,
                   float cap) {
  using C = WB<D>;
  constexpr int dh = DH;      // the tensors' head dim, <= D
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes
  const uint32_t sQ = smem_u32(smem_raw);
  if (sQ & 1023) __trap();
  const uint32_t sdO = sQ + C::TILE;
  const uint32_t sKV = sdO + C::TILE;                  // stage t: K, then V
  // D = 256: the swap, then the halves of Delta
  float* xch =
      reinterpret_cast<float*>(smem_raw + 2 * C::TILE + kWS * 2 * C::TILE);
  float* part = xch + C::XCH / 4;
  // Q and dO, then the stages
  const uint32_t bar_q = sKV + kWS * 2 * C::TILE + C::XCH + C::PART;
  auto stage = [&](int t) { return sKV + t * 2 * C::TILE; };
  auto bar_kv = [&](int t) { return bar_q + 8 * (1 + t); };

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kT;   // heaviest first
  const int tid = threadIdx.x;
  // the warpgroup, its columns [wg * DW, wg * DW + DW) of dQ, and the
  // thread's place in it (both warpgroups hold the same rows)
  const int wg = C::NW == 1 ? 0 : tid >> 7;
  const int wt = C::NW == 1 ? tid : tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + 16 * warp + g;                  // rows r0 and r0 + 8

  int lo, hi;
  key_tiles(q0, T_len, causal, window, chunk, lo, hi);
  const int n = hi - lo + 1;

  if (tid == 0) {
    for (int i = 0; i <= kWS; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // key tile lo + it goes to stage it % kWS
  auto load_kv = [&](int it) {
    const int t = it % kWS;
    mbar_expect_tx(bar_kv(t), 2 * C::TILE);
    tma_tile(stage(t), &tk, C::NB, C::SW, C::SWE, kvh, (lo + it) * kT, b,
             bar_kv(t));
    tma_tile(stage(t) + C::TILE, &tv, C::NB, C::SW, C::SWE, kvh,
             (lo + it) * kT, b, bar_kv(t));
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_q, 2 * C::TILE);
    tma_tile(sQ, &tq, C::NB, C::SW, C::SWE, h, q0, b, bar_q);
    tma_tile(sdO, &tdo, C::NB, C::SW, C::SWE, h, q0, b, bar_q);
    for (int it = 0; it < n && it < kWS; ++it) load_kv(it);
  }

  // Delta = rowsum(dO * o) and lse * log2(e) of rows r0 and r0 + 8: a quad
  // of lanes shares the rows, each summing a quarter of the warpgroup's
  // columns
  float dlt[2], lse2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    float acc = 0.f;
    if (qp < S) {
      const size_t off =
          ((static_cast<size_t>(b) * S + qp) * H + h) * dh + wg * C::DW;
#pragma unroll
      for (int c = 0; c < C::DW; c += 32) {
        if (wg * C::DW + c + 8 * t4 >= dh) continue;  // the zero columns
        float ov[8], dv[8];
        repro::load16_f(o + off + c + 8 * t4, ov);
        repro::load16_f(dout + off + c + 8 * t4, dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(dv[e], ov[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    if (C::NW == 1 && t4 == 0 && qp < S)
      delta[static_cast<size_t>(bh) * S + qp] = acc;
    lse2[r] = qp < S ? lse[static_cast<size_t>(bh) * S + qp] * kLog2e
                     : INFINITY;
  }
  if constexpr (C::NW == 2) {
    // the two halves, added in one order by both warpgroups
    if (t4 == 0) {
      part[wg * kT + 16 * warp + g] = dlt[0];
      part[wg * kT + 16 * warp + g + 8] = dlt[1];
    }
    pair_sync();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r, qp = q0 + row;
      dlt[r] = part[row] + part[kT + row];
      if (wg == 0 && t4 == 0 && qp < S)
        delta[static_cast<size_t>(bh) * S + qp] = dlt[r];
    }
  }

  float acc[C::NBW][C::NO];
#pragma unroll
  for (int c = 0; c < C::NBW; ++c)
#pragma unroll
    for (int i = 0; i < C::NO; ++i) acc[c][i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], pa_lo[4][4];
  int key_lo[2], key_hi[2];
  visible_keys(r0, T_len, causal, window, chunk, key_lo[0], key_hi[0]);
  visible_keys(r0 + 8, T_len, causal, window, chunk, key_lo[1],
               key_hi[1]);
  const float sl2e = scale * kLog2e;
  const float cin = CAP ? scale * __frcp_rn(cap) : 0.f, cout = cap * kLog2e;
  // this warpgroup's boxes of a K tile
  const uint32_t half = wg * C::NBW * kT * C::SW;

  for (int it = 0; it < n; ++it) {
    const int t = it % kWS, k0 = (lo + it) * kT;
    if (it == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_kv(t), (it / kWS) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (C::NW == 1) {
      issue_abt<D>(s, sQ, stage(t));                  // S = Q K^T
      issue_abt<D>(dp, sdO, stage(t) + C::TILE);      // dP = dO V^T
    } else {                  // warpgroup 0 S = Q K^T, 1 dP = dO V^T
      issue_abt<D>(s, wg ? sdO : sQ, stage(t) + wg * C::TILE);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // sweep: swap_dq
    if constexpr (C::NW == 2) swap_products(s, dp, xch, wg, wt);
    // P and dS in place; i indexes the accumulator layout: row (i >> 1) & 1,
    // key 8 * (i >> 2) + 2 * t4 + (i & 1) of the tile
    // queries past S need no mask: their lse is +inf
    const bool masked =
        tile_needs_mask<kT, kT>(q0, k0, T_len, causal, window, chunk);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int kp = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
      float dfac = 1.f;
      float p = CAP ? exp2_ftz(capped_logit2(s[i], cin, cout, dfac) - lse2[r])
                    : exp2_ftz(fmaf(s[i], sl2e, -lse2[r]));
      if (masked && (kp < key_lo[r] || kp >= key_hi[r])) p = 0.f;
      s[i] = p * (dp[i] - dlt[r]);
      if (CAP) s[i] *= dfac;
    }
    pack_a_split(s, pa, pa_lo);
    fence_acc(acc);
    wgmma_fence();
    issue_ab<C::DW>(acc, pa, stage(t) + half);        // dQ += dS K
    issue_ab<C::DW>(acc, pa_lo, stage(t) + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pa(pa);
    fence_pa(pa_lo);
    fence_acc(acc);
    __syncthreads();                                  // stage t is read by all
    if (tid == 0 && it + kWS < n) load_kv(it + kWS);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    if (qp >= S) continue;
    __nv_bfloat16* out = dq + ((static_cast<size_t>(b) * S + qp) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < C::NBW; ++c)
#pragma unroll
      for (int j = 0; j < C::NO / 4; ++j) {
        const int col = wg * C::DW + c * C::SWE + 8 * j + 2 * t4;
        if (col >= dh) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * scale,
                                  acc[c][4 * j + 2 * r + 1] * scale);
      }
  }
}

template <int D, int DH, bool CAP>
__global__ void __launch_bounds__(WB<D>::NT)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int S, int T_len, int H,
                     int KV, float scale, int causal, int window, int chunk,
                     float cap) {
  using C = WB<D>;
  constexpr int dh = DH;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sK = smem_u32(smem_raw);
  if (sK & 1023) __trap();
  const uint32_t sV = sK + C::TILE;
  const uint32_t sQD = sV + C::TILE;                   // stage t: Q, then dO
  // stage t's lse * log2(e) (+inf past S), then its Delta (0 past S)
  float* sStat =
      reinterpret_cast<float*>(smem_raw + 2 * C::TILE + kWS * 2 * C::TILE);
  float* xch = sStat + kWS * 2 * kT;                   // D = 256: the swap
  const uint32_t bar_kv = smem_u32(xch + C::XCH / 4);  // K and V
  auto stage = [&](int t) { return sQD + t * 2 * C::TILE; };
  auto bar_s = [&](int t) { return bar_kv + 8 * (1 + t); };

  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV;
  const int k0 = blockIdx.y * kT;              // key tile 0 is the heaviest
  // the kv head's G q heads are split over the cluster's gridDim.z blocks,
  // hpb of them a block
  const int hpb = H / KV / gridDim.z, h0 = kvh * (H / KV) + blockIdx.z * hpb;
  const int tid = threadIdx.x;
  // the warpgroup, its columns [wg * DW, wg * DW + DW) of dK and dV, and
  // the thread's place in it (both warpgroups hold the same key rows)
  const int wg = C::NW == 1 ? 0 : tid >> 7;
  const int wt = C::NW == 1 ? tid : tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kr = k0 + 16 * warp + g;           // key rows kr and kr + 8

  int qlo, qhi;
  query_tiles(k0, S, causal, window, chunk, qlo, qhi);
  const int nq = qhi - qlo + 1;
  const int n = nq > 0 ? hpb * nq : 0;
  // iteration it: q head h0 + it / nq, query tile qlo + it % nq
  auto head = [&](int it) { return h0 + it / nq; };
  auto qtile = [&](int it) { return (qlo + it % nq) * kT; };
  // one value of iteration it's stage statistics a thread of the first 128
  const bool stat_thread = C::NW == 1 || tid < 2 * kT;
  auto stat = [&](int it) -> float {
    const int q = qtile(it) + (tid & (kT - 1));
    const size_t row = (static_cast<size_t>(b) * H + head(it)) * S + q;
    if (tid < kT) return q < S ? lse[row] * kLog2e : INFINITY;
    return q < S ? delta[row] : 0.f;
  };

  if (tid == 0) {
    for (int i = 0; i <= kWS; ++i) mbar_init(bar_kv + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (stat_thread)
    for (int it = 0; it < n && it < kWS; ++it)
      sStat[it * 2 * kT + tid] = stat(it);
  __syncthreads();

  auto load_qdo = [&](int it) {
    const int t = it % kWS;
    mbar_expect_tx(bar_s(t), 2 * C::TILE);
    tma_tile(stage(t), &tq, C::NB, C::SW, C::SWE, head(it), qtile(it), b,
             bar_s(t));
    tma_tile(stage(t) + C::TILE, &tdo, C::NB, C::SW, C::SWE, head(it),
             qtile(it), b, bar_s(t));
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_kv, 2 * C::TILE);
    tma_tile(sK, &tk, C::NB, C::SW, C::SWE, kvh, k0, b, bar_kv);
    tma_tile(sV, &tv, C::NB, C::SW, C::SWE, kvh, k0, b, bar_kv);
    for (int it = 0; it < n && it < kWS; ++it) load_qdo(it);
  }

  float acc_k[C::NBW][C::NO], acc_v[C::NBW][C::NO];
#pragma unroll
  for (int c = 0; c < C::NBW; ++c)
#pragma unroll
    for (int i = 0; i < C::NO; ++i) acc_k[c][i] = acc_v[c][i] = 0.f;
  float s[32], dp[32];
  uint32_t pa[4][4], pa_lo[4][4], pd[4][4], pd_lo[4][4];
  int vq_lo[2], vq_hi[2];
  queries_of(kr, S, T_len, causal, window, chunk, vq_lo[0], vq_hi[0]);
  queries_of(kr + 8, S, T_len, causal, window, chunk, vq_lo[1], vq_hi[1]);
  const float sl2e = scale * kLog2e;
  const float cin = CAP ? scale * __frcp_rn(cap) : 0.f, cout = cap * kLog2e;
  // this warpgroup's boxes of a Q or dO tile
  const uint32_t half = wg * C::NBW * kT * C::SW;

  for (int it = 0; it < n; ++it) {
    const int t = it % kWS, q0 = qtile(it);
    // the statistics of the tile two ahead, loading across the products
    const float next = it + kWS < n && stat_thread ? stat(it + kWS) : 0.f;
    if (it == 0) mbar_wait(bar_kv, 0);
    mbar_wait(bar_s(t), (it / kWS) & 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    if constexpr (C::NW == 1) {
      issue_abt<D>(s, sK, stage(t));                  // S^T = K Q^T
      issue_abt<D>(dp, sV, stage(t) + C::TILE);       // dP^T = V dO^T
    } else {              // warpgroup 0 S^T = K Q^T, 1 dP^T = V dO^T
      issue_abt<D>(s, wg ? sV : sK, stage(t) + wg * C::TILE);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // sweep: swap_dkdv
    if constexpr (C::NW == 2) swap_products(s, dp, xch, wg, wt);
    // P^T into s and dS^T into dp; i = 4 j + e indexes the accumulator
    // layout: key row e >> 1, query column 8 j + 2 t4 + (e & 1) of the tile
    // queries past S need no mask: their lse is +inf
    const bool masked =
        tile_needs_mask<kT, kT>(q0, k0, T_len, causal, window, chunk);
    const float* st = sStat + t * 2 * kT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 l2 = *reinterpret_cast<const float2*>(st + c);
      const float2 dl = *reinterpret_cast<const float2*>(st + kT + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, qp = q0 + c + (e & 1);
        const float l = (e & 1) ? l2.y : l2.x;
        float dfac = 1.f;
        float p = CAP ? exp2_ftz(capped_logit2(s[i], cin, cout, dfac) - l)
                      : exp2_ftz(fmaf(s[i], sl2e, -l));
        if (masked && (qp < vq_lo[e >> 1] || qp >= vq_hi[e >> 1])) p = 0.f;
        dp[i] = p * (dp[i] - ((e & 1) ? dl.y : dl.x));
        if (CAP) dp[i] *= dfac;
        s[i] = p;
      }
    }
    // dV += P^T dO runs while dS^T is packed; then dK += dS^T Q (over this
    // warpgroup's columns)
    pack_a_split(s, pa, pa_lo);
    fence_acc(acc_v);
    fence_acc(acc_k);
    wgmma_fence();
    issue_ab<C::DW>(acc_v, pa, stage(t) + C::TILE + half);
    issue_ab<C::DW>(acc_v, pa_lo, stage(t) + C::TILE + half);
    pack_a_split(dp, pd, pd_lo);
    wgmma_fence();
    issue_ab<C::DW>(acc_k, pd, stage(t) + half);
    issue_ab<C::DW>(acc_k, pd_lo, stage(t) + half);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pa(pa);
    fence_pa(pa_lo);
    fence_pa(pd);
    fence_pa(pd_lo);
    fence_acc(acc_v);
    fence_acc(acc_k);
    __syncthreads();                                  // stage t is read by all
    if (it + kWS < n) {
      if (stat_thread) sStat[t * 2 * kT + tid] = next;
      if (tid == 0) load_qdo(it + kWS);
    }
  }

  if (gridDim.z == 1) {                 // one block took all G q heads
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kp = kr + 8 * r;
      if (kp >= T_len) continue;
      const size_t off =
          ((static_cast<size_t>(b) * T_len + kp) * KV + kvh) * dh;
#pragma unroll
      for (int c = 0; c < C::NBW; ++c)
#pragma unroll
        for (int j = 0; j < C::NO / 4; ++j) {
          const int col = wg * C::DW + c * C::SWE + 8 * j + 2 * t4;
          if (col >= dh) continue;
          *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
              __floats2bfloat162_rn(acc_k[c][4 * j + 2 * r] * scale,
                                    acc_k[c][4 * j + 2 * r + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
              __floats2bfloat162_rn(acc_v[c][4 * j + 2 * r],
                                    acc_v[c][4 * j + 2 * r + 1]);
        }
    }
    return;
  }
  // the cluster's blocks sum their dK and dV in block order: each puts its
  // accumulators in shared memory (the tiles are free now), register i of
  // thread t at [i][t], and sums every gridDim.z-th pair of registers over
  // the blocks, through distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int NR = C::NBW * C::NO;                // registers a tensor
  float* red = reinterpret_cast<float*>(smem_raw);  // [2][NR][NT]
  static_assert(2 * NR * C::NT * 4 <= C::SMEM_DKDV,
                "dK, dV exceed the tiles");
#pragma unroll
  for (int c = 0; c < C::NBW; ++c)
#pragma unroll
    for (int i = 0; i < C::NO; ++i) {
      red[(c * C::NO + i) * C::NT + tid] = acc_k[c][i];
      red[(NR + c * C::NO + i) * C::NT + tid] = acc_v[c][i];
    }
  cluster.sync();
  const int nz = static_cast<int>(gridDim.z), z = static_cast<int>(blockIdx.z);
#pragma unroll
  for (int c = 0; c < C::NBW; ++c)
#pragma unroll
    for (int j = 0; j < C::NO / 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = 4 * j + 2 * r, pair = (c * C::NO + i) / 2;
        const int kp = kr + 8 * r;
        const int col = wg * C::DW + c * C::SWE + 8 * j + 2 * t4;
        if (pair % nz != z || kp >= T_len || col >= dh) continue;
        float sk[2] = {0.f, 0.f}, sv[2] = {0.f, 0.f};
        for (int q = 0; q < nz; ++q) {
          const float* o = cluster.map_shared_rank(red, q);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sk[e] += o[(c * C::NO + i + e) * C::NT + tid];
            sv[e] += o[(NR + c * C::NO + i + e) * C::NT + tid];
          }
        }
        const size_t off =
            ((static_cast<size_t>(b) * T_len + kp) * KV + kvh) * dh + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(sk[0] * scale, sk[1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(sv[0], sv[1]);
      }
  cluster.sync();                       // the partials stay until read
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *delta, *dq, *dk, *dv;
  int B, S, T_len, H, KV, dh;           // dh: the tensors' head dim
  float scale;
  int causal, window, chunk;
  float cap;
  cudaStream_t stream;
};

template <int D, int DH, bool CAP>
cudaError_t launch(const Args& a, bool dq_pass) {
  using C = BT<D>;
  if (dq_pass) {
    const int smem = C::SMEM_DQ * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D, DH, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.H, (a.S + C::T - 1) / C::T);
    flash_bwd_dq_kernel<D, DH, CAP><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.o),
        static_cast<const float*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.delta), static_cast<float*>(a.dq), a.S, a.T_len,
        a.H, a.KV, a.scale, a.causal, a.window, a.chunk, a.cap);
  } else {
    const int smem = C::SMEM_DKDV * static_cast<int>(sizeof(float));
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<D, DH, CAP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.KV, (a.T_len + C::T - 1) / C::T);
    flash_bwd_dkdv_kernel<D, DH, CAP><<<grid, kThreads, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.S, a.T_len, a.H,
        a.KV, a.scale, a.causal, a.window, a.chunk, a.cap);
  }
  return cudaGetLastError();
}

template <int D, int DH, bool CAP>
cudaError_t launch_wgmma(const Args& a, bool dq_pass) {
  using C = WB<D>;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t e =
      make_map_bf16_heads(&tq, a.q, a.B, a.S, a.H, a.dh, C::SWE, kT, C::SW);
  if (e == cudaSuccess)
    e = make_map_bf16_heads(&tdo, a.dout, a.B, a.S, a.H, a.dh, C::SWE, kT,
                            C::SW);
  if (e == cudaSuccess)
    e = make_map_bf16_heads(&tk, a.k, a.B, a.T_len, a.KV, a.dh, C::SWE, kT,
                            C::SW);
  if (e == cudaSuccess)
    e = make_map_bf16_heads(&tv, a.v, a.B, a.T_len, a.KV, a.dh, C::SWE, kT,
                            C::SW);
  if (dq_pass) {
    static bool opted_in[64] = {};    // the shared-memory opt-in, per device
    if (e == cudaSuccess)
      e = opt_in_smem(flash_bwd_dq_wgmma<D, DH, CAP>, C::SMEM_DQ, opted_in);
    if (e != cudaSuccess) return e;
    const dim3 grid(a.B * a.H, (a.S + kT - 1) / kT);
    flash_bwd_dq_wgmma<D, DH, CAP><<<grid, C::NT, C::SMEM_DQ, a.stream>>>(
        tq, tdo, tk, tv, static_cast<const __nv_bfloat16*>(a.o),
        static_cast<const __nv_bfloat16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<float*>(a.delta),
        static_cast<__nv_bfloat16*>(a.dq), a.S, a.T_len, a.H, a.KV, a.scale,
        a.causal, a.window, a.chunk, a.cap);
  } else {
    static bool opted_in[64] = {};
    if (e == cudaSuccess)
      e = opt_in_smem(flash_bwd_dkdv_wgmma<D, DH, CAP>, C::SMEM_DKDV,
                      opted_in);
    if (e != cudaSuccess) return e;
    // the G q heads of a kv head over a cluster of nz blocks when the
    // (kv head, key tile) blocks alone leave SMs idle: the smallest divisor
    // of G that gives PER_SM blocks an SM (two; one at D = 256, whose
    // shared memory holds one), else the largest up to 8 (the portable
    // cluster size); with enough blocks one block takes all G (splitting
    // then loads each K/V tile nz times for no gain)
    const int G = a.H / a.KV, nk = (a.T_len + kT - 1) / kT;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long long blocks = static_cast<long long>(a.B) * a.KV * nk;
    int nz = 1;
    // sweep: nz
    for (int c = 2; c <= 8 && blocks * nz < C::PER_SM * 1LL * sms; ++c)
      if (G % c == 0) nz = c;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(a.B * a.KV, nk, nz);
    cfg.blockDim = dim3(C::NT);
    cfg.dynamicSmemBytes = C::SMEM_DKDV;
    cfg.stream = a.stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = nz;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_wgmma<D, DH, CAP>, tq, tdo,
                           tk, tv,
                           static_cast<const float*>(a.lse),
                           static_cast<const float*>(a.delta),
                           static_cast<__nv_bfloat16*>(a.dk),
                           static_cast<__nv_bfloat16*>(a.dv), a.S, a.T_len,
                           a.H, a.KV, a.scale, a.causal, a.window, a.chunk,
                           a.cap);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// the instance of (dtype, head dim, cap) on the CUDA cores: fp32 at every
// D (bf16 is the tensor cores' at every D and is refused here); head dim
// 120 runs in a D = 128 instance of its own
template <bool CAP>
cudaError_t cuda_cores(const Args& a, int dtype, bool dq_pass) {
  if (dtype != repro::kFloat32) return cudaErrorInvalidValue;
  switch (a.dh) {
    case 32: return launch<32, 32, CAP>(a, dq_pass);
    case 64: return launch<64, 64, CAP>(a, dq_pass);
    case 120: return launch<128, 120, CAP>(a, dq_pass);
    case 128: return launch<128, 128, CAP>(a, dq_pass);
    case 256: return launch<256, 256, CAP>(a, dq_pass);
    default: return cudaErrorInvalidValue;
  }
}

int run_cuda_cores(const Args& a, int dtype, bool dq_pass) {
  if (a.H % a.KV || a.cap < 0.f) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(a.cap > 0.f ? cuda_cores<true>(a, dtype, dq_pass)
                                      : cuda_cores<false>(a, dtype, dq_pass));
}

template <bool CAP>
cudaError_t tensor_cores(const Args& a, bool dq_pass) {
  switch (a.dh) {
    case 32: return launch_wgmma<32, 32, CAP>(a, dq_pass);
    case 64: return launch_wgmma<64, 64, CAP>(a, dq_pass);
    case 120: return launch_wgmma<128, 120, CAP>(a, dq_pass);
    case 128: return launch_wgmma<128, 128, CAP>(a, dq_pass);
    case 256: return launch_wgmma<256, 256, CAP>(a, dq_pass);
    default: return cudaErrorInvalidValue;
  }
}

int run_wgmma(const Args& a, bool dq_pass) {
  if (a.H % a.KV || a.cap < 0.f) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(a.cap > 0.f ? tensor_cores<true>(a, dq_pass)
                                      : tensor_cores<false>(a, dq_pass));
}

}  // namespace

// q, o, dout, dq (B,S,H,D); k, v (B,T,KV,D); lse, delta (B,H,S) fp32; all
// contiguous, one dtype for the tensors of the attention; cap: the
// forward's tanh softcap (0: none). Writes dq and delta = rowsum(dout * o),
// which the dkdv pass reads: launch this one first, on the same stream.
// The CUDA-core instance: fp32 at D = 32, 64, 120, 128, 256.
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                                  const void* o, const void* dout,
                                  const void* lse, void* delta, void* dq,
                                  int B, int S, int T_len, int H, int KV,
                                  int D, float scale, int causal, int window,
                                  int chunk, float cap, int dtype,
                                  void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               B, S, T_len, H, KV, D, scale, causal, window, chunk, cap,
               static_cast<cudaStream_t>(stream)};
  return run_cuda_cores(a, dtype, true);
}

// dk, dv (B,T,KV,D), from the delta the dq pass wrote
extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int S,
                                    int T_len, int H, int KV, int D,
                                    float scale, int causal, int window,
                                    int chunk, float cap, int dtype,
                                    void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr,
               dk, dv, B, S, T_len, H, KV, D, scale, causal, window, chunk,
               cap, static_cast<cudaStream_t>(stream)};
  return run_cuda_cores(a, dtype, false);
}

// The tensor-core instance of the pair: bf16 at D = 32, 64, 120, 128, 256, with
// q, k, v, o and dout starting on 16 bytes (TMA and 16-byte loads); the
// same arguments and order as above, without the dtype.
extern "C" int repro_flash_bwd_dq_wgmma(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* delta, void* dq, int B, int S,
                                        int T_len, int H, int KV, int D,
                                        float scale, int causal, int window,
                                        int chunk, float cap, void* stream) {
  const Args a{q, k, v, o, dout, lse, delta, dq, nullptr, nullptr,
               B, S, T_len, H, KV, D, scale, causal, window, chunk, cap,
               static_cast<cudaStream_t>(stream)};
  return run_wgmma(a, true);
}

extern "C" int repro_flash_bwd_dkdv_wgmma(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dk, void* dv, int B, int S,
                                          int T_len, int H, int KV, int D,
                                          float scale, int causal, int window,
                                          int chunk, float cap, void* stream) {
  const Args a{q, k, v, nullptr, dout, lse, const_cast<void*>(delta), nullptr,
               dk, dv, B, S, T_len, H, KV, D, scale, causal, window, chunk,
               cap, static_cast<cudaStream_t>(stream)};
  return run_wgmma(a, false);
}
