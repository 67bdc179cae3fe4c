// Table-driven allgather on one Hopper card (sm_90a): the p ranks are the
// p rows of one (p, capacity, n) device buffer.
//
// Replaces: src/repro/kernels/dma_allgather/dma_ag.py, _ag_kernel (called by
// dma_allgather): each device writes its shard at slot 0 of its buffer, then
// in round r puts the contiguous slice [send_off*n, +size*n) of its buffer
// into the target device's buffer at recv_off*n (one remote DMA, one
// semaphore per round), and finally reads its buffer in the canonical order
// perm. The round table comes from schedule_compile.py (locality_bruck_raw
// for Algorithm 2).
//
// Bound on the H100: memory. The function reads every shard once and writes
// every rank's gathered output once, (p*n + p*p*n) * itemsize bytes at
// 3.35 TB/s; it does no arithmetic. The round copies and the buffer are
// extra traffic the TPU layout needs and the bound does not count.
//
// Design: one launch per phase. dma_ag_init copies x[i] to row i, slot 0.
// dma_ag_round runs round r: block column i copies rank i's slice into its
// target's row when rank i's send flag is set. Rounds are ordered by the
// stream: round r+1 starts after every copy of round r has landed, which is
// what the TPU kernel's per-round semaphores ensure (dma_ag.py:54-57).
// Within a round no copy writes a range that another copy of the round
// reads (schedule_compile.check_no_overlap), so the copies of a round may
// run in any order. dma_ag_gather writes out[i, j] = buf[i, perm[i, j]].
// Each block copies a share of its segment in vectors of V bytes (16 where
// the block width and the pointers allow it, down to 1 byte otherwise);
// offsets are 64-bit, since the buffer exceeds 2^31 bytes at the FSDP size
// (16 ranks x 16 slots x 12.6 MB). The table and perm live on the device.
#include "common.cuh"

namespace {

struct alignas(2) V2 { unsigned char b[2]; };

// copy nbytes (a multiple of sizeof(V)) from src to dst; this block's share
// is every gridDim.y-th chunk of blockDim.x vectors, starting at blockIdx.y
template <typename V>
__device__ __forceinline__ void copy_span(const char* __restrict__ src,
                                          char* __restrict__ dst,
                                          long long nbytes) {
  const long long nv = nbytes / static_cast<long long>(sizeof(V));
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long stride = static_cast<long long>(gridDim.y) * blockDim.x;
  for (long long k = static_cast<long long>(blockIdx.y) * blockDim.x + threadIdx.x;
       k < nv; k += stride)
    d[k] = s[k];
}

// blockIdx.x = rank i
template <typename V>
__global__ void dma_ag_init(const char* __restrict__ x, char* __restrict__ buf,
                            long long block_bytes, long long row_bytes) {
  const long long i = blockIdx.x;
  copy_span<V>(x + i * block_bytes, buf + i * row_bytes, block_bytes);
}

// blockIdx.x = rank i; table is (p, R, 5) int32:
// [target, send_off, recv_off, send_flag, recv_flag], offsets in blocks
template <typename V>
__global__ void dma_ag_round(char* buf, const int* __restrict__ table, int R,
                             int r, long long size_bytes,
                             long long block_bytes, long long row_bytes) {
  const int* row = table + (static_cast<long long>(blockIdx.x) * R + r) * 5;
  if (row[3] == 0) return;
  const long long tgt = row[0];
  const char* src = buf + blockIdx.x * row_bytes + row[1] * block_bytes;
  char* dst = buf + tgt * row_bytes + row[2] * block_bytes;
  copy_span<V>(src, dst, size_bytes);
}

// blockIdx.x = i * p + j; perm is (p, p) int32
template <typename V>
__global__ void dma_ag_gather(const char* __restrict__ buf,
                              const int* __restrict__ perm,
                              char* __restrict__ out, int p,
                              long long block_bytes, long long row_bytes) {
  const long long ij = blockIdx.x;
  const long long i = ij / p;
  copy_span<V>(buf + i * row_bytes + perm[ij] * block_bytes,
               out + ij * block_bytes, block_bytes);
}

constexpr int kThreads = 256;
constexpr long long kBlocksPerLaunch = 4 * 132;   // 4 blocks per SM

// blocks per segment: enough to spread `segments` segments of `nbytes` over
// the card, never more than the segment has chunks of kThreads vectors
dim3 grid_for(long long segments, long long nbytes, int vec) {
  const long long chunks = (nbytes / vec + kThreads - 1) / kThreads;
  long long per = kBlocksPerLaunch / segments;
  per = per < 1 ? 1 : per;
  per = per > chunks ? chunks : per;
  per = per < 1 ? 1 : (per > 65535 ? 65535 : per);
  return dim3(static_cast<unsigned>(segments), static_cast<unsigned>(per));
}

template <template <typename> class K, typename... Args>
cudaError_t launch_vec(int vec, dim3 grid, cudaStream_t s, Args... args) {
  switch (vec) {
    case 16: K<uint4>::run(grid, s, args...); break;
    case 8: K<uint2>::run(grid, s, args...); break;
    case 4: K<unsigned int>::run(grid, s, args...); break;
    case 2: K<V2>::run(grid, s, args...); break;
    case 1: K<unsigned char>::run(grid, s, args...); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename V> struct Init {
  static void run(dim3 g, cudaStream_t s, const char* x, char* buf,
                  long long bb, long long rb) {
    dma_ag_init<V><<<g, kThreads, 0, s>>>(x, buf, bb, rb);
  }
};
template <typename V> struct RoundK {
  static void run(dim3 g, cudaStream_t s, char* buf, const int* table, int R,
                  int r, long long sb, long long bb, long long rb) {
    dma_ag_round<V><<<g, kThreads, 0, s>>>(buf, table, R, r, sb, bb, rb);
  }
};
template <typename V> struct Gather {
  static void run(dim3 g, cudaStream_t s, const char* buf, const int* perm,
                  char* out, int p, long long bb, long long rb) {
    dma_ag_gather<V><<<g, kThreads, 0, s>>>(buf, perm, out, p, bb, rb);
  }
};

}  // namespace

// vec: bytes per vector access (16, 8, 4, 2 or 1); the caller checked that
// block_bytes and every pointer are multiples of it. row_bytes is
// capacity * block_bytes.
extern "C" int repro_dma_ag_init(const void* x, void* buf, int p,
                                 long long block_bytes, long long row_bytes,
                                 int vec, void* stream) {
  if (p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_vec<Init>(
      vec, grid_for(p, block_bytes, vec), static_cast<cudaStream_t>(stream),
      static_cast<const char*>(x), static_cast<char*>(buf), block_bytes,
      row_bytes));
}

extern "C" int repro_dma_ag_round(void* buf, const void* table, int p, int R,
                                  int r, long long size_bytes,
                                  long long block_bytes, long long row_bytes,
                                  int vec, void* stream) {
  if (p <= 0 || r < 0 || r >= R) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_vec<RoundK>(
      vec, grid_for(p, size_bytes, vec), static_cast<cudaStream_t>(stream),
      static_cast<char*>(buf), static_cast<const int*>(table), R, r,
      size_bytes, block_bytes, row_bytes));
}

extern "C" int repro_dma_ag_gather(const void* buf, const void* perm,
                                   void* out, int p, long long block_bytes,
                                   long long row_bytes, int vec,
                                   void* stream) {
  if (p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_vec<Gather>(
      vec, grid_for(static_cast<long long>(p) * p, block_bytes, vec),
      static_cast<cudaStream_t>(stream), static_cast<const char*>(buf),
      static_cast<const int*>(perm), static_cast<char*>(out), p, block_bytes,
      row_bytes));
}
