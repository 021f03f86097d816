// XNOR-popcount binary GEMM: C[m, n] = 2 * popcount(XNOR(a[m], b[n]) & mask)
// - K, exactly, as int32.  a [M, W] and b [N, W] hold little-endian sign
// words; the mask keeps the first K bits of each row, so whatever the pad
// bits of the last word hold, they never reach the count.
//
// Replaces src/repro/kernels/xnor_popcount.py:_xnor_gemm_kernel.  The TPU
// kernel unpacks 8-word chunks to +-1 int8 so that its matrix unit can do
// the product, and subtracts the pad bits afterwards.  Here the product
// stays in the packed domain: every word pair costs one XOR, one NOT, one
// AND and one __popc on the integer pipes, 32 sign products at a time.
// At the main path's shapes the operands are a few MB and the output 6 MB,
// so the integer operations, not device memory, bound it.  The design
// keeps every word reused from shared memory: a 32 x 32 output tile per
// block, 256 threads, each thread owning 4 outputs of one column, with
// 32-word slices of the a and b rows staged through shared memory (the b
// tile padded by one word so a warp's column reads hit 32 banks and the a
// reads are warp-wide broadcasts).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;     // output rows and columns per block
constexpr int kSlice = 32;    // words of K staged per step
constexpr int kRowsPerThread = kTile / 8;

__device__ __forceinline__ uint32_t word_mask(int w, int words, int k) {
  if (w >= words) return 0u;
  const int valid = k - 32 * w;
  if (valid >= 32) return 0xffffffffu;
  if (valid <= 0) return 0u;
  return (1u << valid) - 1u;
}

__global__ void xnor_gemm_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 int32_t* __restrict__ c,
                                 int m_rows, int n_rows, int words, int k) {
  __shared__ uint32_t as[kTile][kSlice + 1];
  __shared__ uint32_t bs[kTile][kSlice + 1];
  const int tx = threadIdx.x;          // 0..31: output column, word in slice
  const int ty = threadIdx.y;          // 0..7
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  int acc[kRowsPerThread] = {0, 0, 0, 0};

  for (int w0 = 0; w0 < words; w0 += kSlice) {
    const int w = w0 + tx;
    for (int r = ty; r < kTile; r += 8) {
      const int m = m0 + r;
      const int n = n0 + r;
      as[r][tx] = (m < m_rows && w < words)
                      ? __ldg(a + static_cast<size_t>(m) * words + w) : 0u;
      bs[r][tx] = (n < n_rows && w < words)
                      ? __ldg(b + static_cast<size_t>(n) * words + w) : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < kSlice; ++s) {
      const uint32_t mask = word_mask(w0 + s, words, k);
      const uint32_t bv = bs[tx][s];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] += __popc(~(as[ty + 8 * i][s] ^ bv) & mask);
    }
    __syncthreads();
  }

  const int n = n0 + tx;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m < m_rows && n < n_rows)
      c[static_cast<size_t>(m) * n_rows + n] = 2 * acc[i] - k;
  }
}

}  // namespace

extern "C" int xnor_gemm(const void* a, const void* b, void* c, int m_rows,
                         int n_rows, int words, int k, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((n_rows + kTile - 1) / kTile, (m_rows + kTile - 1) / kTile);
  xnor_gemm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(c), m_rows, n_rows, words, k);
  return static_cast<int>(cudaGetLastError());
}
