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
// Bound on the H100: operations. Per chunk of Q tokens and per head it does
// ~Q*Q*N + Q*Q*P/2 + 2*Q*N*P multiply-adds against (Q*P + 2*Q*N/heads per
// group) input values, hundreds of flops per byte at N = 128, P = 64; this
// version runs them as fp32 FMA on the CUDA cores (67 TFLOP/s at most).
//
// Design: one block of 256 threads per (b, h); the TPU's sequential chunk
// axis becomes a loop inside the block, and the N x P state stays in shared
// memory for the whole sequence, as the TPU kernel keeps it in VMEM. The
// block walks the sequence in its own 64-token chunks whatever Q the caller
// used (the chunked scan is exact algebra, so any chunking computes the same
// function up to fp32 rounding); the last chunk is ragged, its missing
// tokens loaded as zeros (dt = 0 leaves cum flat and adds nothing to h), and
// its rows of y are not written. Per chunk the block stages x (64 x P),
// C (64 x N), B transposed (N x 64) and the 64 x 64 score in shared memory
// (N = 128, P = 64: 128 KB with the state, above the 48 KB default, so the
// launch opts in with cudaFuncSetAttribute). exp is taken only for j <= i,
// where cum_i - cum_j <= 0: above the diagonal it could overflow, and an
// inf is never multiplied by 0. Each product is a register-tiled loop over
// shared memory: a thread owns TM rows x TN columns of the output, columns
// strided by 32 so a warp reads consecutive addresses of the right operand
// and one broadcast address of the left. Row strides are padded by one
// float against bank conflicts. Speed (wgmma, TMA, splitting P over blocks
// to fill 132 SMs at Bt*H = 48) is later work.
#include "common.cuh"

namespace {

using repro::to_f;

constexpr int kThreads = 256;
constexpr int kChunk = 64;              // tokens per chunk inside the block
constexpr int kLB = kChunk + 1;         // padded row of B^T (N x 64)
constexpr int kLS = kChunk + 1;         // padded row of the score (64 x 64)

// acc[r][c] += sum_{k<K} A[row_r * sAm + k * sAk] * Bm[k * ldb + col_c] with
// row_r = m0 + tm + RT*r (clamped to M-1: the caller drops rows >= M) and
// col_c = tn + CT*c, for tn = tid % CT, tm = tid / CT, RT = threads / CT.
template <int CT, int TN, int TM>
__device__ __forceinline__ void mm_acc(float (&acc)[TM][TN], int m0, int M,
                                       int K, const float* A, int sAm,
                                       int sAk, const float* Bm, int ldb) {
  constexpr int RT = kThreads / CT;
  const int tn = threadIdx.x % CT, tm = threadIdx.x / CT;
  int aoff[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + tm + RT * r;
    aoff[r] = (m < M ? m : M - 1) * sAm;
  }
  for (int k = 0; k < K; ++k) {
    float b[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) b[c] = Bm[k * ldb + tn + CT * c];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float a = A[aoff[r] + k * sAk];
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a, b[c], acc[r][c]);
    }
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.f;
}

// shared-memory floats of one block
__host__ __device__ constexpr size_t smem_floats(int N, int P) {
  return static_cast<size_t>(N) * P          // state h      N x P
         + kChunk * P                        // x            64 x P
         + kChunk * (N + 1)                  // C            64 x (N+1)
         + static_cast<size_t>(N) * kLB      // B^T          N x 65
         + kChunk * kLS                      // score        64 x 65
         + 3 * kChunk;                       // dt, cum, w
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bg,
               const T* __restrict__ Cg, float* __restrict__ y,
               float* __restrict__ hout, int S, int H, int G, int N) {
  // y and h products: P columns; the score: 64 columns
  constexpr int CT = P < 32 ? P : 32;
  constexpr int TN = P / CT;
  constexpr int TM = kChunk * CT / kThreads;  // RT * TM = 64 rows per pass
  constexpr int RT = kThreads / CT;
  constexpr int SCT = 32, STN = kChunk / SCT, STM = kChunk * SCT / kThreads;
  constexpr int SRT = kThreads / SCT;

  extern __shared__ float smem[];
  const int NS = N + 1;
  float* sh = smem;                          // [N][P]
  float* sx = sh + N * P;                    // [64][P]
  float* sC = sx + kChunk * P;               // [64][NS]
  float* sBt = sC + kChunk * NS;             // [N][kLB]
  float* sS = sBt + N * kLB;                 // [64][kLS]
  float* sdt = sS + kChunk * kLS;            // [64]
  float* scum = sdt + kChunk;                // [64]
  float* sw = scum + kChunk;                 // [64]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int tn = tid % CT, tm = tid / CT;
  const float a_h = A[h];

  for (int i = tid; i < N * P; i += kThreads) sh[i] = 0.f;

  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int l = S - s0 < kChunk ? S - s0 : kChunk;   // tokens this chunk
    // ---- stage the chunk (zeros past the ragged end) ----
    for (int i = tid; i < kChunk * P; i += kThreads) {
      const int j = i / P, p = i % P;
      sx[i] = j < l ? to_f(x[((static_cast<size_t>(b) * S + s0 + j) * H + h)
                             * P + p]) : 0.f;
    }
    for (int i = tid; i < kChunk * N; i += kThreads) {
      const int j = i / N, n = i % N;
      const size_t off = ((static_cast<size_t>(b) * S + s0 + j) * G + g) * N + n;
      sC[j * NS + n] = j < l ? to_f(Cg[off]) : 0.f;
      sBt[n * kLB + j] = j < l ? to_f(Bg[off]) : 0.f;
    }
    if (tid < kChunk)
      sdt[tid] = tid < l ? dt[(static_cast<size_t>(b) * S + s0 + tid) * H + h]
                         : 0.f;
    __syncthreads();
    if (tid == 0) {                          // 64 serial adds: negligible
      float c = 0.f;
      for (int j = 0; j < kChunk; ++j) {
        c += sdt[j] * a_h;
        scum[j] = c;
      }
    }
    __syncthreads();
    const float seg = scum[l - 1];
    if (tid < kChunk)                        // exp(seg - cum_j) <= 1
      sw[tid] = tid < l ? expf(seg - scum[tid]) * sdt[tid] : 0.f;

    // ---- score: sS[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, j <= i ----
    {
      float acc[STM][STN];
      zero(acc);
      mm_acc<SCT, STN, STM>(acc, 0, kChunk, N, sC, NS, 1, sBt, kLB);
      const int stn = tid % SCT, stm = tid / SCT;
#pragma unroll
      for (int r = 0; r < STM; ++r) {
        const int i = stm + SRT * r;
#pragma unroll
        for (int c = 0; c < STN; ++c) {
          const int j = stn + SCT * c;
          sS[i * kLS + j] = (j <= i && i < l)
              ? acc[r][c] * expf(scum[i] - scum[j]) * sdt[j] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = S x + exp(cum_i) (C h) ----
    {
      float yi[TM][TN], yo[TM][TN];
      zero(yi);
      zero(yo);
      mm_acc<CT, TN, TM>(yi, 0, kChunk, l, sS, kLS, 1, sx, P);
      mm_acc<CT, TN, TM>(yo, 0, kChunk, N, sC, NS, 1, sh, P);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = tm + RT * r;
        if (i >= l) continue;
        const float e = expf(scum[i]);
        float* yrow = y + ((static_cast<size_t>(b) * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < TN; ++c) yrow[tn + CT * c] = yi[r][c] + e * yo[r][c];
      }
    }
    __syncthreads();                         // sh and sx are read above

    // ---- h <- exp(seg) h + B^T (w x) ----
    for (int i = tid; i < kChunk * P; i += kThreads) sx[i] *= sw[i / P];
    __syncthreads();
    const float eseg = expf(seg);
    for (int m0 = 0; m0 < N; m0 += RT * TM) {
      float acc[TM][TN];
      zero(acc);
      mm_acc<CT, TN, TM>(acc, m0, N, l, sBt, kLB, 1, sx, P);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int n = m0 + tm + RT * r;
        if (n >= N) continue;
#pragma unroll
        for (int c = 0; c < TN; ++c) {
          float* hp = sh + n * P + tn + CT * c;   // owned by this thread
          *hp = eseg * *hp + acc[r][c];
        }
      }
    }
    __syncthreads();                         // before the next chunk's loads
  }

  float* ho = hout + static_cast<size_t>(bh) * N * P;
  for (int i = tid; i < N * P; i += kThreads) ho[i] = sh[i];
}

template <typename T, int P>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* B, const void* C, void* y, void* h, int Bt,
                   int S, int H, int G, int N, cudaStream_t stream) {
  const size_t bytes = smem_floats(N, P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();          // clear it, or the next launch reports it
    return e;
  }
  ssd_fwd_kernel<T, P>
      <<<dim3(static_cast<unsigned>(Bt) * H), kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<float*>(y),
      static_cast<float*>(h), S, H, G, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const void* x, const void* dt, const void* A,
                       const void* B, const void* C, void* y, void* h, int Bt,
                       int S, int H, int G, int N, int P, cudaStream_t s) {
  switch (P) {        // mamba2-780m and its smoke configuration
    case 16: return launch<T, 16>(x, dt, A, B, C, y, h, Bt, S, H, G, N, s);
    case 64: return launch<T, 64>(x, dt, A, B, C, y, h, Bt, S, H, G, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (Bt,S,H,P), B and C (Bt,S,G,N) of dtype `dtype`; dt (Bt,S,H) and A (H,)
// fp32; y (Bt,S,H,P) and h (Bt,H,N,P) fp32. The caller checked H % G == 0
// and P in {16, 64}; an N whose shared memory a block cannot opt into
// returns the error of cudaFuncSetAttribute.
extern "C" int repro_ssd(const void* x, const void* dt, const void* A,
                         const void* B, const void* C, void* y, void* h,
                         int Bt, int S, int H, int G, int N, int P, int dtype,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (dtype == repro::kFloat32)
    e = dispatch_p<float>(x, dt, A, B, C, y, h, Bt, S, H, G, N, P, s);
  else if (dtype == repro::kBFloat16)
    e = dispatch_p<__nv_bfloat16>(x, dt, A, B, C, y, h, Bt, S, H, G, N, P, s);
  return static_cast<int>(e);
}
