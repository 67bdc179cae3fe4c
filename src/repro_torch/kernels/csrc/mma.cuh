// Tensor-core pieces shared by the SSD scan's kernels (ssd.cu, ssd_bwd.cu):
// mma.sync m16n8k16 bf16 products with fp32 sums, ldmatrix fragment loads,
// the split of an fp32 value into bf16 hi + lo, cp.async copies, 2^x.
//
// The split: hi = bf16(v), lo = bf16(v - hi), |v - hi - lo| <= 2^-16 |v|. A
// product of an fp32 operand with a bf16 one is hi*b + lo*b; of two fp32
// operands hi*hi + hi*lo + lo*hi (the dropped lo*lo is below 2^-16 |a||b|).
//
// Fragments of an m16n8k16 product from a tile in shared memory (s its
// first element, ld its row stride in elements), for the thread's lane:
// bf16 tiles through ldmatrix (exact: lo is left alone), fp32 tiles read as
// values and split into hi and lo. frag_a: A (16 x 16 at m0, k0) stored
// [m][k]; frag_at: the same A stored [k][m]; frag_b2: B of two n8 tiles
// (n0 and n0 + 8; k0..k0 + 15) stored [n][k]; frag_bt2: the same stored
// [k][n]; b[0], b[1] are the first tile's registers, b[2], b[3] the second's.
// Rows free of bank conflicts: bf16 rows an odd multiple of 16 bytes (ld a
// multiple of 16, plus 8); fp32 tiles read along k in pairs (frag_a,
// frag_b2) ld = 8 mod 16, read across k (frag_at, frag_bt2) ld = 4 mod 8.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro {
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate; a pure
// register operation (not volatile), so the compiler may move it past loads
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b over the split terms: hi*hi, hi*lo when b is split (SB), lo*hi
// when a is (SA); bh, bl the two registers of one n8 tile
template <bool SA, bool SB>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  mma(d, ah, bh0, bh1);
  if (SB) mma(d, ah, bl0, bl1);
  if (SA) mma(d, al, bh0, bh1);
}

// 2^v in one instruction (the special-function unit, relative error below
// 2^-22, results below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (u, v) -> hi = bf16 pair, lo = bf16 pair of the remainders; u in the low
// half, as the mma fragments hold consecutive columns
__device__ __forceinline__ void split2(float u, float v, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(u, v);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(u - hf.x, v - hf.y));
}

// 16 bytes global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// ---- fragments, bf16 tiles (ldmatrix) --------------------------------------
__device__ __forceinline__ void frag_a(const __nv_bfloat16* s, int ld, int m0,
                                       int k0, uint32_t (&hi)[4],
                                       uint32_t (&)[4]) {
  const int l = lane_id();
  ldsm(hi, smem_u32(s + (m0 + (l & 15)) * ld + k0 + (l >> 4) * 8));
}

__device__ __forceinline__ void frag_at(const __nv_bfloat16* s, int ld, int m0,
                                        int k0, uint32_t (&hi)[4],
                                        uint32_t (&)[4]) {
  const int l = lane_id();
  ldsm_t(hi, smem_u32(s + (k0 + (l & 7) + (l >> 4) * 8) * ld + m0 +
                      ((l >> 3) & 1) * 8));
}

__device__ __forceinline__ void frag_b2(const __nv_bfloat16* s, int ld, int n0,
                                        int k0, uint32_t (&hi)[4],
                                        uint32_t (&)[4]) {
  const int l = lane_id();
  ldsm(hi, smem_u32(s + (n0 + (l & 7) + (l >> 4) * 8) * ld + k0 +
                    ((l >> 3) & 1) * 8));
}

__device__ __forceinline__ void frag_bt2(const __nv_bfloat16* s, int ld,
                                         int n0, int k0, uint32_t (&hi)[4],
                                         uint32_t (&)[4]) {
  const int l = lane_id();
  ldsm_t(hi, smem_u32(s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * ld + n0 +
                      (l >> 4) * 8));
}

// ---- fragments, fp32 tiles (values, split) ---------------------------------
__device__ __forceinline__ void split_pair(const float* p, uint32_t& hi,
                                           uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  split2(v.x, v.y, hi, lo);
}

__device__ __forceinline__ void frag_a(const float* s, int ld, int m0, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int l = lane_id();
  const float* p = s + (m0 + (l >> 2)) * ld + k0 + 2 * (l & 3);
  split_pair(p, hi[0], lo[0]);
  split_pair(p + 8 * ld, hi[1], lo[1]);
  split_pair(p + 8, hi[2], lo[2]);
  split_pair(p + 8 * ld + 8, hi[3], lo[3]);
}

__device__ __forceinline__ void frag_at(const float* s, int ld, int m0, int k0,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int l = lane_id();
  const float* p = s + (k0 + 2 * (l & 3)) * ld + m0 + (l >> 2);
  split2(p[0], p[ld], hi[0], lo[0]);
  split2(p[8], p[ld + 8], hi[1], lo[1]);
  split2(p[8 * ld], p[9 * ld], hi[2], lo[2]);
  split2(p[8 * ld + 8], p[9 * ld + 8], hi[3], lo[3]);
}

__device__ __forceinline__ void frag_b2(const float* s, int ld, int n0, int k0,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int l = lane_id();
  const float* p = s + (n0 + (l >> 2)) * ld + k0 + 2 * (l & 3);
  split_pair(p, hi[0], lo[0]);
  split_pair(p + 8, hi[1], lo[1]);
  split_pair(p + 8 * ld, hi[2], lo[2]);
  split_pair(p + 8 * ld + 8, hi[3], lo[3]);
}

__device__ __forceinline__ void frag_bt2(const float* s, int ld, int n0,
                                         int k0, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const int l = lane_id();
  const float* p = s + (k0 + 2 * (l & 3)) * ld + n0 + (l >> 2);
  split2(p[0], p[ld], hi[0], lo[0]);
  split2(p[8 * ld], p[9 * ld], hi[1], lo[1]);
  split2(p[8], p[ld + 8], hi[2], lo[2]);
  split2(p[8 * ld + 8], p[9 * ld + 8], hi[3], lo[3]);
}

}  // namespace tc
}  // namespace repro
