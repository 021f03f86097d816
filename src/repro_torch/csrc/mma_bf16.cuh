// bf16 tensor-core building blocks for the flash kernels (sm_90a):
// 16-byte cp.async copies into XOR-swizzled shared tiles, ldmatrix loads
// of mma.sync fragments, and the m16n8k16 bf16 product with float32 sums.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 g + t): A (16 x 16,
// row-major) holds rows g and g + 8 at columns 2t, 2t + 1 and 2t + 8,
// 2t + 9 in four registers of two bf16; B (16 x 8, k x n) holds k = 2t,
// 2t + 1 and 2t + 8, 2t + 9 at column n = g in two registers; C (16 x 8
// float32) holds rows g and g + 8 at columns 2t, 2t + 1.  So the C
// fragments of two neighbouring 8-column tiles are, element for element,
// the A fragment of one 16-deep step: a score tile in registers feeds the
// next product without passing through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

// exp(x) is computed as exp2f(x * kLog2e): one multiply and the MUFU.EX2
// unit, where expf's accurate range reduction takes several instructions
// per score; the product's rounding moves the result by ~|x| 2^-24.
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of (row, col) in a [rows][D] bf16 tile whose 16-byte
// chunks are XOR-swizzled: the eight rows one ldmatrix reads at one
// logical chunk land on eight distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int kChunks = D / 8;                       // chunks per row
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  constexpr int kMask = (kChunks < 8 ? kChunks : 8) - 1;
  return row * D + ((((col >> 3) ^ ((row / kRowsPerLine) & kMask))) << 3) +
         (col & 7);
}

// Rows [r0, r0 + ROWS) of a contiguous [rows][D] bf16 matrix into a
// swizzled shared tile by 16-byte cp.async copies; rows past `rows` are
// zero-filled.  Commits nothing.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int r0,
    int rows) {
  constexpr int kChunks = D / 8;
  static_assert(ROWS * kChunks % THREADS == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const bool in = r0 + r < rows;
    const __nv_bfloat16* from =
        src + (in ? static_cast<size_t>(r0 + r) * D + c : 0);
    cp_async16(smem_addr(dst + swz<D>(r, c)), from, in ? 16 : 0);
  }
}

// Four 8 x 8 bf16 matrices from shared memory, one row address per lane.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, each matrix transposed on the way.
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// Shared address of this lane's row for an x4 load of the 16 x 16 block
// at (r0, c0) of a swizzled [rows][D] tile, in the order that gives
//  - an A fragment (rows are M, columns K; ldsm_x4), or
//  - the B fragments of two 8-wide n-tiles from a [K][N] tile (rows K,
//    columns N; ldsm_x4_t): registers 0, 1 for columns c0..c0+7 and 2, 3
//    for c0+8..c0+15.
template <int D>
__device__ __forceinline__ uint32_t frag_a_addr(const __nv_bfloat16* tile,
                                                int r0, int c0, int lane) {
  return smem_addr(tile + swz<D>(r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                 c0 + (lane >> 4) * 8));
}

// Shared address of this lane's row for an x4 load (ldsm_x4) of the B
// fragments of two 8-wide n-tiles from an [N][K] tile (rows N, columns
// K) at rows n0..n0+15, columns k0..k0+15: registers 0, 1 for rows
// n0..n0+7 and 2, 3 for n0+8..n0+15.
template <int D>
__device__ __forceinline__ uint32_t frag_bt_addr(const __nv_bfloat16* tile,
                                                 int n0, int k0, int lane) {
  return smem_addr(tile + swz<D>(n0 + (lane & 7) + (lane >> 4) * 8,
                                 k0 + ((lane >> 3) & 1) * 8));
}

// c += a b over one 16 x 8 x 16 step: bf16 operands, float32 sums.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), x0 in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): 16 significant
// bits where one bf16 keeps 8.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Store two floats as neighbouring bf16 values (4-byte aligned).
__device__ __forceinline__ void store_bf16x2(__nv_bfloat16* p, float x0,
                                             float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

}  // namespace mma_bf16
