// Flash attention forward (online softmax) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/flash.py, _flash_kernel
// (called by flash_attention, pallas_call at :121): softmax(q k^T * D^-0.5) v
// per head with fp32 running max m, sum l and accumulator, GQA (q head h
// reads kv head h / G), causal, sliding-window, chunked-local and
// tanh-softcap masks, kv tiles that no query of the tile can reach skipped,
// and rows with l == 0 written as 0. Asked for it (training), each instance
// also writes the row's natural log-sum-exp m + log l, (B, H, S) fp32, +inf
// for a row with no key: the input of the backward in flash_attention_bwd.cu.
//
// Bound on the H100 at the main path's shape (llama3.2-3b prefill, B = 1,
// S = 512, 24 q heads over 8 kv heads, D = 128, bf16, causal): bytes, q and
// o (2 x 3.1 MB) plus k and v (2 x 1.0 MB) = 8.4 MB at 3.35 TB/s = 2.50 us;
// the 4*D flops per attended pair (q.k and p.v), 1.61 GFLOP, take 1.63 us at
// 989 TFLOP/s bf16. From a few hundred keys on the operations win: at
// S = 2048, 25.8 GFLOP = 26 us against 10 us of bytes.
//
// Design: two instances, chosen by dtype in the wrapper (ops.py), never one
// for the other. Registers per thread from ptxas (build.log), with the lse
// epilogue: bf16 D = 32/64/128/256: 95/127/163/255, no spills; fp32:
// 168/168/254/206, D = 64 spilling 4 bytes.
//
// bf16: tensor cores. One block of one warpgroup (128 threads) per (b*H + h,
// 64-row q tile); at D = 128 two blocks fit an SM (112 KB of shared memory,
// 166 registers). Q (64 x D) and a ring of three K/V stages (64 keys x D
// each) live in shared memory in the 128-byte swizzle (64-byte at D = 32)
// that the wgmma descriptors read, loaded by TMA (cp.async.bulk.tensor over
// 4-D tensor maps of the (B, S|T, H|KV, D) tensors, one box per 64 columns,
// rows past S or T read as zeros) with mbarrier completion; thread 0 refills
// a stage as soon as all four warps are past it, two tiles ahead of the one
// being multiplied (the TMA, mbarrier and wgmma pieces are hopper.cuh's,
// shared with the backward in flash_attention_bwd.cu). Per kv
// tile: S = Q K^T is wgmma m64n64k16 with both operands in shared memory
// (K-major), issued together with O += P V of the previous tile (wgmma
// m64n{64,32}k16, P in bf16 from registers, V from shared memory, MN-major,
// transposed by the instruction); the fp32 scores stay in registers, where
// the mask (only on tiles that cross the causal diagonal, a window or chunk
// edge or the ragged T edge; one key interval per row), the softcap and the
// online softmax (the ex2 instruction, log2(e) folded into the scale) run.
// The accumulator layout of S is already the A-operand layout of P V, so P
// never goes through shared memory; m, l and O stay fp32 in registers. Q
// tiles are launched causally heaviest first (blockIdx.y reversed).
//
// What bounds it: neither bytes nor flops. At S = 512 the heaviest q tile
// runs a chain of 8 kv tiles, each a product, a softmax and a product in
// turn (~2,000 cycles of one warpgroup, of which the softmax ~800, by
// clock64 stamps), after a prologue of ~6,500 cycles that mostly waits for
// the first loads from a cold L2. Splitting a q tile's kv range over two
// warpgroups, or over a two-block cluster merged through distributed shared
// memory, 128-key tiles, a producer warp, and issuing the next Q K^T before
// the softmax were each measured no faster (PERF.md). Each q head is its
// own block: packing the G = 3 q heads of a kv head into one block would read
// each K/V tile once but leaves 64 blocks for 132 SMs at S = 512, and the G
// blocks that share a kv head run side by side and meet its tiles in L2.
//
// fp32: CUDA cores (tf32 would not hold the 1e-4 fp32 tolerance). One block
// per (b*H + h, 64-row q tile), 64-key tiles staged in shared memory as
// fp32 (K rows padded by one float against bank conflicts); each warp owns
// 16 query rows (8 at D = 256), lane j scores keys j and j+32, P goes
// through shared memory to the P.V product, where lane j owns output
// columns j, j+32, ... .
//
// Both mask the ragged q and kv edges themselves, so any S and T work.
//
// Head dim 120 (h2o-danube-3-4b) runs in the D = 128 instances: the bf16
// wgmma products need K and N in multiples of 16. Its tensor maps are 4-D
// (B, S|T, heads, 120) with boxes of 64 columns of one head, so the second
// box of a row reads columns 64..127 and TMA fills 120..127 with zeros
// (not the next head's first columns): Q K^T and P V are exact, the store
// skips the 8 zero columns, and no padded copy exists anywhere. The fp32
// instance zero-fills the same columns in shared memory. The scale is the
// true dh^-0.5, passed by the wrapper.
#include <cuda.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::kNegInf;
using namespace repro::sm90;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kBM = 64;            // query rows per block (one warpgroup)
constexpr int kBN = 64;            // keys per kv tile
constexpr int kStages = 3;         // K/V ring

template <int D>
struct WCfg {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle row, bytes
  static constexpr int SWE = SW / 2;              // bf16 per swizzle row
  static constexpr int NB = D / SWE;              // column boxes per row
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = kBN * D * 2;    // K or V, one stage
  static constexpr int SMEM =
      Q_BYTES + kStages * 2 * KV_BYTES + 8 * (kStages + 1);
  static constexpr int NO = SWE / 2;              // O registers per column box
};

// the reachable kv tiles of q tile [q0, q0 + kBM) form one interval,
// [lo, hi], by flash.py's tile rule; empty when lo > hi
__device__ __forceinline__ void kv_range(int q0, int T_len, int causal,
                                         int window, int chunk, int& lo,
                                         int& hi) {
  lo = 0;
  hi = (T_len + kBN - 1) / kBN - 1;
  if (causal) hi = min(hi, (q0 + kBM - 1) / kBN);
  if (window) {
    const int first = q0 - (window - 1);      // first key row q0 may see
    if (first > 0) lo = max(lo, first / kBN);
  }
  if (chunk) {
    lo = max(lo, ((q0 / chunk) * chunk) / kBN);
    hi = min(hi, (q0 + kBM - 1) / kBN);
  }
}

// scores of one tile -> log2-domain logits: scale (or softcap), then the
// mask where the tile needs one; i indexes wgmma's accumulator layout (row
// (i >> 1) & 1, key 8 * (i >> 2) + 2 * t4 + (i & 1) of the tile)
__device__ __forceinline__ void logits(float (&s)[32], int k0, int t4,
                                       const int (&lo)[2], const int (&hi)[2],
                                       float cap, float scale, bool masked) {
  if (cap != 0.f) {
    const float in = scale * __frcp_rn(cap), out = cap * kLog2e;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = out * tanhf(s[i] * in);
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale * kLog2e;
  }
  if (!masked) return;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int kp = k0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
    if (kp < lo[r] || kp >= hi[r]) s[i] = kNegInf;
  }
}

// online softmax of one tile's logits, in place: s becomes p = exp2(s - m);
// alpha is the factor by which the rows' earlier O and l shrink
__device__ __forceinline__ void softmax_step(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (((i >> 1) & 1) == r) mx = fmaxf(mx, s[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    alpha[r] = exp2_ftz(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_ftz(s[i] - m[r]);
    rs[r] += s[i];
  }
  // l is kept per thread (its quarter of the row) and summed at the end
  l[0] = alpha[0] * l[0] + rs[0];
  l[1] = alpha[1] * l[1] + rs[1];
}

template <int D>
__global__ void __launch_bounds__(128)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int S, int T_len, int H, int KV, int dh, float scale,
                   int causal, int window, int chunk, float cap) {
  using C = WCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: tiles start on 1024 bytes,
  // as dynamic shared memory does in a kernel with no static shared memory
  const uint32_t sQ = smem_u32(smem_raw);
  if (sQ & 1023) __trap();
  const uint32_t sK0 = sQ + C::Q_BYTES;                // stage t: K, then V
  const uint32_t bar_q = sK0 + kStages * 2 * C::KV_BYTES;
  // bar_q, then one "tile landed" barrier per stage, 8 bytes each
  auto stage_k = [&](int t) { return sK0 + t * 2 * C::KV_BYTES; };
  auto bar_kv = [&](int t) { return bar_q + 8 * (1 + t); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // heaviest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // row r0 holds the accumulator pairs 0, 2, 4, ..., row r0 + 8 the others
  const int r0 = q0 + 16 * warp + g;

  int lo, hi;
  kv_range(q0, T_len, causal, window, chunk, lo, hi);
  const int n = hi - lo + 1;

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bar_q + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // tile it (kv tile lo + it) goes to stage it % kStages
  auto load_kv = [&](int it) {
    const int t = it % kStages;
    const uint32_t sk = stage_k(t), sv = sk + C::KV_BYTES;
    mbar_expect_tx(bar_kv(t), 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::NB; ++c) {
      tma_load_4d(sk + c * kBN * C::SW, &tk, c * C::SWE, kvh,
                  (lo + it) * kBN, b, bar_kv(t));
      tma_load_4d(sv + c * kBN * C::SW, &tv, c * C::SWE, kvh,
                  (lo + it) * kBN, b, bar_kv(t));
    }
  };
  if (tid == 0 && n > 0) {
    mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::NB; ++c)
      tma_load_4d(sQ + c * kBM * C::SW, &tq, c * C::SWE, h, q0, b, bar_q);
    for (int it = 0; it < n && it < kStages; ++it) load_kv(it);
  }

  float acc[C::NB][C::NO];
#pragma unroll
  for (int c = 0; c < C::NB; ++c)
#pragma unroll
    for (int i = 0; i < C::NO; ++i) acc[c][i] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  uint32_t pa[kBN / 16][4];

  // descriptors: K-major Q and K (leading offset unused, 8-row groups
  // SW * 8 bytes apart); V is MN-major with one swizzle atom across N per
  // instruction, so both offsets are the 8-key group stride
  const uint64_t dq = make_desc<C::SW>(sQ, 16, 8 * C::SW);
  auto issue_qk = [&](int t) {
    const uint64_t dk = make_desc<C::SW>(stage_k(t), 16, 8 * C::SW);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // 16 columns: box kk*16/SWE, byte offset (kk*16 % SWE)*2 in its row
      const uint32_t col = ((kk * 16) % C::SWE) * 2, box = (kk * 16) / C::SWE;
      wgmma_ss_n64(s, dq + ((box * kBM * C::SW + col) >> 4),
                   dk + ((box * kBN * C::SW + col) >> 4), kk > 0);
    }
    wgmma_commit();
  };
  auto issue_pv = [&](int t) {
    const uint64_t dv =
        make_desc<C::SW>(stage_k(t) + C::KV_BYTES, 8 * C::SW, 8 * C::SW);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::NB; ++c)
        wgmma_rs<C::SWE>(acc[c], pa[kk],
                         dv + ((c * kBN * C::SW + kk * 16 * C::SW) >> 4));
    wgmma_commit();
  };
  int key_lo[2], key_hi[2];
  visible_keys(r0, T_len, causal, window, chunk, key_lo[0], key_hi[0]);
  visible_keys(r0 + 8, T_len, causal, window, chunk, key_lo[1], key_hi[1]);

  // iteration it: S_it = Q K_it^T and O += P_{it-1} V_{it-1} are issued
  // together, so the second product runs while the first is waited for
  for (int it = 0; it < n; ++it) {
    const int t = it % kStages, tp = (it + kStages - 1) % kStages;
    const int k0 = (lo + it) * kBN;
    if (it == 0) mbar_wait(bar_q, 0);
    mbar_wait(bar_kv(t), (it / kStages) & 1);
#pragma unroll
    for (int c = 0; c < C::NB; ++c) fence_regs(acc[c]);
    issue_qk(t);                             // (its wgmma_fence covers both)
    if (it > 0) {
      issue_pv(tp);
      wgmma_wait<1>();                       // S_it is in
    } else {
      wgmma_wait<0>();
    }
    fence_regs(s);
    logits(s, k0, t4, key_lo, key_hi, cap, scale,
           tile_needs_mask<kBM, kBN>(q0, k0, T_len, causal, window,
                                     chunk));
    softmax_step(s, m_i, l_i, alpha);
    wgmma_wait<0>();                         // O += P_{it-1} V_{it-1} is in
    fence_pa(pa);
#pragma unroll
    for (int c = 0; c < C::NB; ++c) {
      fence_regs(acc[c]);
#pragma unroll
      for (int i = 0; i < C::NO; ++i) acc[c][i] *= alpha[(i >> 1) & 1];
    }
    pack_a(s, pa);      // P in bf16, the A operand of P V
    __syncthreads();                         // stage tp is read by all
    if (tid == 0 && it > 0 && it - 1 + kStages < n) load_kv(it - 1 + kStages);
  }
  if (n > 0) {
#pragma unroll
    for (int c = 0; c < C::NB; ++c) fence_regs(acc[c]);
    wgmma_fence();
    issue_pv((n - 1) % kStages);
    wgmma_wait<0>();
    fence_pa(pa);
#pragma unroll
    for (int c = 0; c < C::NB; ++c) fence_regs(acc[c]);
  }

  float inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv_l[r] = l == 0.f ? 1.f : __frcp_rn(l);      // fully-masked rows -> 0
    // the row's natural log-sum-exp (m and the logits are log2-scaled); a
    // row with no key gets +inf, so the backward's exp(s - lse) is 0
    const int qp = r0 + 8 * r;
    if (lse != nullptr && t4 == 0 && qp < S)
      lse[(static_cast<size_t>(b) * H + h) * S + qp] =
          l == 0.f ? INFINITY : (m_i[r] + log2f(l)) * kLn2;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r0 + 8 * r;
    if (qp >= S) continue;
    __nv_bfloat16* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * dh;
#pragma unroll
    for (int c = 0; c < C::NB; ++c)
#pragma unroll
      for (int j = 0; j < C::NO / 4; ++j) {
        const int col = c * C::SWE + 8 * j + 2 * t4;
        if (col >= dh) continue;              // the instance's zero columns
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(acc[c][4 * j + 2 * r] * inv_l[r],
                                  acc[c][4 * j + 2 * r + 1] * inv_l[r]);
      }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int S, int T_len, int H, int KV,
                         int dh, float scale, int causal, int window,
                         int chunk, float cap, cudaStream_t stream) {
  using C = WCfg<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t e =
      make_map_bf16_heads(&tq, q, B, S, H, dh, C::SWE, kBM, C::SW);
  if (e == cudaSuccess)
    e = make_map_bf16_heads(&tk, k, B, T_len, KV, dh, C::SWE, kBN, C::SW);
  if (e == cudaSuccess)
    e = make_map_bf16_heads(&tv, v, B, T_len, KV, dh, C::SWE, kBN, C::SW);
  static bool opted_in[64] = {};      // the shared-memory opt-in, per device
  if (e == cudaSuccess)
    e = opt_in_smem(flash_wgmma_kernel<D>, C::SMEM, opted_in);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + kBM - 1) / kBM);
  flash_wgmma_kernel<D><<<grid, 128, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, S, T_len, H, KV, dh,
      scale, causal, window, chunk, cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
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

template <int D>
__global__ void __launch_bounds__(Tile<D>::NT)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int S, int T_len, int H, int KV,
                  int dh_arg, float scale, int causal, int window, int chunk,
                  float cap) {
  using C = Tile<D>;
  // only the D = 128 instance serves another head dim (120); the others
  // fold it to D, so their registers are what they were without it
  const int dh = D == 128 ? dh_arg : D;
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
    sQ[idx] = qs < S && d < dh
                  ? q[((static_cast<size_t>(b) * S + qs) * H + h) * dh + d]
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
      if (ks < T_len && d < dh) {
        const size_t off =
            ((static_cast<size_t>(b) * T_len + ks) * KV + kvh) * dh + d;
        kv_k = k[off];
        kv_v = v[off];
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
    if (lse != nullptr && lane == 0)      // +inf for a row with no key
      lse[(static_cast<size_t>(b) * H + h) * S + qp] =
          l_i[i] == 0.f ? INFINITY : m_i[i] + logf(l_i[i]);
    float* out = o + ((static_cast<size_t>(b) * S + qp) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < C::DL; ++j)
      if (lane + 32 * j < dh) out[lane + 32 * j] = acc[i][j] / l;
  }
}

template <int D>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        float* lse, int B, int S, int T_len, int H, int KV,
                        int dh, float scale, int causal, int window,
                        int chunk, float cap, cudaStream_t stream) {
  using C = Tile<D>;
  const int smem = C::SMEM_FLOATS * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(flash_fp32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * H, (S + C::BQ - 1) / C::BQ);
  flash_fp32_kernel<D><<<grid, C::NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, T_len, H,
      KV, dh, scale, causal, window, chunk, cap);
  return cudaGetLastError();
}

using Launch = cudaError_t (*)(const void*, const void*, const void*, void*,
                               float*, int, int, int, int, int, int, float,
                               int, int, int, float, cudaStream_t);

// the instance of head dim D: D = 120 runs in the D = 128 one
Launch pick(bool bf16, int D) {
  switch (D) {
    case 32: return bf16 ? launch_wgmma<32> : launch_fp32<32>;
    case 64: return bf16 ? launch_wgmma<64> : launch_fp32<64>;
    case 120:
    case 128: return bf16 ? launch_wgmma<128> : launch_fp32<128>;
    case 256: return bf16 ? launch_wgmma<256> : launch_fp32<256>;
    default: return nullptr;
  }
}

int run(bool bf16, const void* q, const void* k, const void* v, void* o,
        void* lse, int B, int S, int T_len, int H, int KV, int D, float scale,
        int causal, int window, int chunk, float cap, void* stream) {
  const Launch fn = pick(bf16, D);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fn(q, k, v, o, static_cast<float*>(lse), B, S,
                             T_len, H, KV, D, scale, causal, window, chunk,
                             cap, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// q (B,S,H,D), k/v (B,T,KV,D), o (B,S,H,D), all contiguous, D one of 32,
// 64, 120, 128, 256; bf16 runs the
// tensor-core instance (q, k, v 16-byte aligned), fp32 the CUDA-core one.
// lse (B,H,S) fp32, the rows' natural log-sum-exp of the scaled scores for
// the backward, is written when it is not null (serving passes null).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int S, int T_len, int H,
                                          int KV, int D,
                                          float scale, int causal, int window,
                                          int chunk, float cap, void* stream) {
  return run(true, q, k, v, o, lse, B, S, T_len, H, KV, D, scale, causal,
             window, chunk, cap, stream);
}

extern "C" int repro_flash_attention_fp32(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int B, int S, int T_len, int H,
                                          int KV, int D,
                                          float scale, int causal, int window,
                                          int chunk, float cap, void* stream) {
  return run(false, q, k, v, o, lse, B, S, T_len, H, KV, D, scale, causal,
             window, chunk, cap, stream);
}
