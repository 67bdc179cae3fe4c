// Table-driven allgather on one Hopper card (sm_90a), in one launch: the p
// ranks are the p rows of the (p, p, n) output, and every round of the
// paper's schedule runs inside one cooperative kernel.
//
// Replaces: src/repro/kernels/dma_allgather/dma_ag.py, _ag_kernel (called by
// dma_allgather, pallas_call at :102): each device writes its shard at slot
// 0 of its buffer, then in round r puts the contiguous slice
// [send_off*n, +size*n) of its buffer into the target device's buffer at
// recv_off*n (one remote DMA, one semaphore per round), and finally reads
// its buffer in the canonical order perm.
//
// Design: the permutation is folded into the table at compile time
// (schedule_compile.py, DmaSchedule.folded), so each message lands in
// canonical order: rank i's message of round r is `size` block copies, from
// its slot o to the target's slot o (origin o), or to a spill slot where
// the target already holds o. The output is each rank's receive buffer:
// no (p, capacity, n) scratch, no gather pass. The kernel writes x[i] to
// out[i, i], then runs the rounds with a grid-wide barrier
// (cooperative_groups::this_grid().sync()) between them, which is what the
// TPU kernel's per-round DMA semaphores ensure (dma_ag.py:54-57): round r+1
// reads what round r wrote. Within a round no copy writes a slot that
// another copy reads or writes (schedule_compile.check_folded), so its
// copies run in any order. Work units are (rank, block of the message,
// chunk of 32 * kUnroll vectors), one per warp, so a 1 KiB block keeps a
// warp busy and not a whole thread block; consecutive units go to warps on
// different SMs, and each warp reads the table entry of its first unit of a
// round before the barrier that opens the round. Copies go in vectors of V
// bytes (16 where the block width and the pointers allow it, down to 1 byte
// otherwise), with 64-bit offsets (the output exceeds 2^31 bytes at the
// FSDP size). The grid is one block of 1024 threads per SM, fewer when no
// round has that many units: a cooperative launch needs every block
// resident, and each grid barrier costs per block.
//
// Bound on the H100: memory. The function reads every shard once and writes
// every rank's gathered output once, (p*n + p*p*n) * itemsize bytes at
// 3.35 TB/s; it does no arithmetic. The kernel moves 2*p*n for the first
// copy and 2*p*(p-1)*n for the rounds of a Bruck-type schedule (each block
// a rank receives is read from the sender's row and written to its own),
// plus 2*n per spilled block: at p = 16 and 12.6 MB blocks, 0.40 + 6.04 GB
// against the bound's 3.42 GB. The rounds' reads are the algorithm's
// messages: every block but the first of each output row is a copy of a
// block of another row, so on one card the kernel sits at about twice the
// bound, where a broadcast from x (the library call) would read each shard
// once and only write.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

struct alignas(2) V2 { unsigned char b[2]; };

constexpr int kThreads = 1024;            // one block per SM
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // vectors in flight per thread
constexpr int kChunk = 32 * kUnroll;     // vectors per warp work unit

// chunk c of a block copy, by one warp: vectors [c * kChunk, +kChunk) of
// nv; every load is issued before the first store
template <typename V>
__device__ __forceinline__ void copy_chunk(const char* src, char* dst,
                                           long long c, long long nv,
                                           int lane) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long base = c * kChunk + lane;
  V tmp[kUnroll];
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long k = base + 32 * j;
    if (k < nv) tmp[j] = s[k];
  }
#pragma unroll
  for (int j = 0; j < kUnroll; ++j) {
    const long long k = base + 32 * j;
    if (k < nv) d[k] = tmp[j];
  }
}

struct Args {
  const char* x;         // (p, n) shards
  char* out;             // (p, p, n)
  char* spill;           // (p, spill, n), null when spill == 0
  const int* table;      // (R, p, W) folded table
  const int* sizes;      // (R,) blocks per message
  int p, R, W, spill_slots;
  long long block_bytes;
};

// slot s of rank j: its output row for s < p, its spill slots after
__device__ __forceinline__ char* slot(const Args& a, long long j, long long s) {
  return s < a.p ? a.out + (j * a.p + s) * a.block_bytes
                 : a.spill + (j * a.spill_slots + s - a.p) * a.block_bytes;
}

// the copy of work unit u of round r (m = rank * size + block of the
// message, then the chunk): source and destination, or none
struct Copy {
  const char* src;
  char* dst;
};

__device__ __forceinline__ Copy copy_of(const Args& a, const int* rt,
                                        long long size, long long m) {
  const int* row = rt + (m / size) * a.W;
  const int tgt = row[0];
  if (tgt < 0) return {nullptr, nullptr};
  const int* cp = row + 1 + 3 * (m % size);
  return {slot(a, m / size, cp[1]), slot(a, tgt, cp[2])};
}

template <typename V>
__global__ void __launch_bounds__(kThreads, 1) dma_ag_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  // warp w of block b is global warp w * gridDim.x + b: consecutive units
  // land on different SMs, so a round of small copies spreads over the card
  const long long w0 = static_cast<long long>(threadIdx.x / 32) * gridDim.x +
                       blockIdx.x;
  const long long nw = static_cast<long long>(gridDim.x) * kWarps;
  const long long nv = a.block_bytes / static_cast<long long>(sizeof(V));
  const long long chunks = (nv + kChunk - 1) / kChunk;
  for (long long u = w0; u < a.p * chunks; u += nw) {
    const long long i = u / chunks;
    copy_chunk<V>(a.x + i * a.block_bytes, slot(a, i, i), u % chunks, nv,
                  lane);
  }
  for (int r = 0; r < a.R; ++r) {
    // this warp's first copy of round r is read before the barrier: the
    // table does not depend on what the rounds write
    const long long size = a.sizes[r];
    const long long units = a.p * size * chunks;
    const int* rt = a.table + static_cast<long long>(r) * a.p * a.W;
    Copy c = w0 < units ? copy_of(a, rt, size, w0 / chunks) : Copy{};
    grid.sync();                          // round r reads what came before
    for (long long u = w0; u < units; u += nw) {
      if (u != w0) c = copy_of(a, rt, size, u / chunks);
      if (c.src) copy_chunk<V>(c.src, c.dst, u % chunks, nv, lane);
    }
  }
}

template <typename V>
cudaError_t launch(Args a, long long max_units, cudaStream_t stream) {
  static int sms[64] = {};                // per device, found once
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  // one block of kThreads per SM (64 KB of loads in flight each), fewer
  // when a round never has a unit for each: each grid barrier costs per
  // block
  long long blocks = max_units < sms[dev] ? max_units : sms[dev];
  void* params[] = {&a};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dma_ag_kernel<V>),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params, 0, stream);
}

}  // namespace

// x (p, n) -> out (p, p, n) by the folded table (R, p, W) with sizes (R,),
// both on the device; spill (p, spill_slots, n) or null. vec: bytes per
// vector access (16, 8, 4, 2 or 1); the caller checked that block_bytes and
// every pointer are multiples of it. max_size: the largest entry of sizes.
extern "C" int repro_dma_allgather(const void* x, void* out, void* spill,
                                   const void* table, const void* sizes, int p,
                                   int R, int W, int spill_slots, int max_size,
                                   long long block_bytes, int vec,
                                   void* stream) {
  if (p <= 0 || R < 0 || block_bytes <= 0 || (spill_slots > 0 && !spill))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const char*>(x), static_cast<char*>(out),
               static_cast<char*>(spill), static_cast<const int*>(table),
               static_cast<const int*>(sizes), p, R, W, spill_slots,
               block_bytes};
  const long long per_chunk = static_cast<long long>(kChunk) * vec;
  const long long chunks = (block_bytes + per_chunk - 1) / per_chunk;
  const long long units =
      static_cast<long long>(p) * (max_size > 1 ? max_size : 1) * chunks;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return static_cast<int>(launch<uint4>(a, units, s));
    case 8: return static_cast<int>(launch<uint2>(a, units, s));
    case 4: return static_cast<int>(launch<unsigned int>(a, units, s));
    case 2: return static_cast<int>(launch<V2>(a, units, s));
    case 1: return static_cast<int>(launch<unsigned char>(a, units, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
