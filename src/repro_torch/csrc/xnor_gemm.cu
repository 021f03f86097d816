// XNOR-popcount binary GEMM: C[m, n] = 2 * popcount(XNOR(a[m], b[n]) & mask)
// - K, exactly, as int32: the dot of the +-1 sign vectors of a[m] and b[n].
// a [M, W] and b [N, W] hold little-endian sign words (bit 1: +1); the mask
// keeps the first K bits of each row, so whatever the pad bits of the last
// word hold, they never reach the sum.
//
// Replaces src/repro/kernels/xnor_popcount.py:_xnor_gemm_kernel.  The TPU
// kernel unpacks 8-word chunks to +-1 int8 so that its matrix unit can do
// the product.  Here too the product runs on the int8 tensor cores
// (mma.sync m16n8k32 s8 x s8 -> s32).  In the packed domain each word pair
// cost an XOR, a NOT, an AND, a __popc and an add on the CUDA cores.  On
// an H100 what bounds this kernel at the main path's shapes is, as far as
// timestamps of its phases showed, the rate of mma.sync IMMA (the card's
// dense int8 rate needs wgmma), one global-memory latency for the operands
// and writing the int32 output (6 MB at [512, 3072]).  The expansion into
// fragments runs on the integer pipes (16 INT32 lanes per sub-partition),
// so it spends few operations per product:
//  - Bits expand to 0/1, not +-1.  With P the 0/1 product over k < K and
//    pa, pb the set bits below K of the rows, dot = 4 P - 2 pa - 2 pb + K;
//    the popcounts are per row, not per output.
//  - Which k an mma slot holds does not matter as long as a and b agree,
//    so lane (g, t)'s fragment register 0 holds bits 8j + t (j = 0..3) of
//    a word and register 2 bits 8j + 4 + t: (x >> t) & 0x01010101 and
//    (x >> (t + 4)) & 0x01010101, two operations per four k.  a's words
//    are masked to K in shared memory first (only the tail words change),
//    so bits past K give 0 and b's pad bits never count; words past W are
//    zero-filled.
//  - One thread (or two) a row counts its set bits below K from shared
//    memory, 8 bytes a load (a warp a row, summed by a warp reduction,
//    was the kernel's slowest phase).
//  - The packed operands are tiny (a few hundred KB): each block copies
//    its 64-row slices of a and b, all of K up to 12,800 bits, in one
//    batch of cp.async (16 bytes a copy where the rows allow it) and waits
//    once: a two-stage ring of 256-k chunks paid a global-memory latency
//    per chunk (0.0219 ms at [512, 96] x [768, 96] on an H100, against
//    0.0156 for the CUDA-core kernel).  Rows are padded to 4 mod 8 words,
//    so a warp's eight row reads hit eight banks.
//  - A block computes a 64 x 64 output tile with 2 x KG warps: each warp
//    64 x 32 outputs (4 x 4 mma tiles, 64 int32 accumulators a thread)
//    over the k steps s with s % KG == q, its K group q; groups 1..KG-1
//    hand their sums to group 0 through shared memory.  KG (1, 2 or 4) is
//    the wrapper's choice: more warps where the output has few tiles
//    (decode, the FFN's down projection).  16-row tiles wholly past M are
//    skipped (decode has 4 rows).  Group 0 stores 8-byte pairs: each
//    row's four threads write one full 32-byte sector.
// Sums of 0/1 products and popcounts are exact in s32, so the result is.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
// words of K a block holds at once (a segment): all of K up to 12,800
// bits, within the 227 KB a block may hold
constexpr int kSegMax = 400;
constexpr uint32_t kLow = 0x01010101u;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the bits of word w that lie below k
__device__ __forceinline__ uint32_t word_mask(int w, int words, int k) {
  if (w >= words) return 0u;
  const int valid = k - 32 * w;
  if (valid >= 32) return 0xffffffffu;
  if (valid <= 0) return 0u;
  return (1u << valid) - 1u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[r, n] and C[r, n + 1], where they exist
__device__ __forceinline__ void store_pair(int32_t* c, int r, int n,
                                           int m_rows, int n_rows, int x,
                                           int y) {
  if (r >= m_rows) return;
  int32_t* p = c + static_cast<size_t>(r) * n_rows + n;
  if ((n_rows & 1) == 0 && n + 1 < n_rows) {
    *reinterpret_cast<int2*>(p) = make_int2(x, y);
  } else {
    if (n < n_rows) p[0] = x;
    if (n + 1 < n_rows) p[1] = y;
  }
}

// The k steps s = q, q + KG, ... < seg of one warp's 64 x 32 outputs over
// the first MI 16-row tiles: lane t's bits of a word are 8j + t (fragment
// registers 0, 1) and 8j + 4 + t (registers 2, 3), as 0/1 int8.
template <int MI, int KG>
__device__ __forceinline__ void mma_steps(const uint32_t* as,
                                          const uint32_t* bs, int stride,
                                          int seg, int q, int wn, int g,
                                          int t, int (&acc)[4][4][4]) {
  const uint32_t* brow = bs + (wn + g) * stride;
  const uint32_t* arow = as + g * stride;
#pragma unroll 4
  for (int s = q; s < seg; s += KG) {
    uint32_t fb[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint32_t y = brow[ni * 8 * stride + s] >> t;
      fb[ni][0] = y & kLow;
      fb[ni][1] = (y >> 4) & kLow;
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const uint32_t x0 = arow[mi * 16 * stride + s] >> t;        // row g
      const uint32_t x1 = arow[(mi * 16 + 8) * stride + s] >> t;  // g + 8
      const uint32_t fa[4] = {x0 & kLow, x1 & kLow, (x0 >> 4) & kLow,
                              (x1 >> 4) & kLow};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], fa, fb[ni]);
    }
  }
}

template <int KG>
__global__ void __launch_bounds__(64 * KG)
    xnor_gemm_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b, int32_t* __restrict__ c,
                     int m_rows, int n_rows, int words, int k, int seg,
                     bool vec) {
  constexpr int kThreads = 64 * KG;
  constexpr int kParts = kThreads > kBM + kBN ? kThreads / (kBM + kBN) : 1;
  extern __shared__ uint32_t rows[];    // [kBM + kBN][seg + 4]: a, then b
  __shared__ int pops[kBM + kBN];       // set bits below K of each row
  __shared__ int4 red[KG > 1 ? 2 : 1][16][32];  // one K group's sums
  const int stride = seg + 4;           // 4 mod 8: eight rows, eight banks
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;      // mma fragment coordinates
  const int wn = (warp & 1) * 32;             // the warp's 32 columns
  const int q = warp >> 1;                    // its K group
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int mi_live = min(4, (m_rows - m0 + 15) / 16);
  const uint32_t* as = rows;
  const uint32_t* bs = rows + kBM * stride;

  // block row r (a's rows 0..63, then b's), word w: its address and
  // whether it exists
  auto row_src = [&](int r, int w, bool& in) {
    const bool is_a = r < kBM;
    const int gr = is_a ? m0 + r : n0 + r - kBM;
    in = gr < (is_a ? m_rows : n_rows) && w < words;
    return (is_a ? a : b) + (in ? static_cast<size_t>(gr) * words + w : 0);
  };

  int acc[4][4][4] = {};
  for (int r = tid; r < kBM + kBN; r += kThreads) pops[r] = 0;
  for (int w0 = 0; w0 < words; w0 += seg) {
    // the segment's words of all 128 rows, one batch of copies
    if (vec) {                  // words % 4 == 0, 16-byte aligned rows
      const int quads = seg / 4;
      for (int e = tid; e < (kBM + kBN) * quads; e += kThreads) {
        const int r = e / quads, w = w0 + 4 * (e % quads);
        bool in;
        const uint32_t* src = row_src(r, w, in);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         smem_u32(rows + r * stride + (w - w0))),
                     "l"(src), "r"(in ? 16 : 0)
                     : "memory");
      }
    } else {
      for (int e = tid; e < (kBM + kBN) * seg; e += kThreads) {
        const int r = e / seg, w = w0 + e % seg;
        bool in;
        const uint32_t* src = row_src(r, w, in);
        cp_async4(smem_u32(rows + r * stride + (w - w0)), src, in ? 4 : 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // the rows' set bits below K, kParts threads a row, two words a load;
    // a's words past K masked in place (a 0 in a zeroes the product,
    // whatever b's pad bits hold)
    const int full = min(seg, max(0, (k - 32 * w0) >> 5));  // below K
    for (int e = tid; e < (kBM + kBN) * kParts; e += kThreads) {
      const int r = e % (kBM + kBN), span = seg / kParts;
      uint32_t* row = rows + r * stride + (e / (kBM + kBN)) * span;
      const int tail = full - (e / (kBM + kBN)) * span;
      int v = 0;
#pragma unroll 4
      for (int s = 0; s < span; s += 2) {
        uint2 x = *reinterpret_cast<const uint2*>(row + s);
        if (s + 2 > tail) {
          const int w = w0 + (row - rows - r * stride) + s;
          x.x &= word_mask(w, words, k);
          x.y &= word_mask(w + 1, words, k);
          if (r < kBM) *reinterpret_cast<uint2*>(row + s) = x;
        }
        v += __popc(x.x) + __popc(x.y);
      }
      if (kParts > 1) atomicAdd(&pops[r], v); else pops[r] += v;
    }
    __syncthreads();

    // the products, over this warp's K group, for the 16-row tiles that
    // hold rows below M (a branch-free loop for each count)
    switch (mi_live) {
      case 1: mma_steps<1, KG>(as, bs, stride, seg, q, wn, g, t, acc); break;
      case 2: mma_steps<2, KG>(as, bs, stride, seg, q, wn, g, t, acc); break;
      case 3: mma_steps<3, KG>(as, bs, stride, seg, q, wn, g, t, acc); break;
      default: mma_steps<4, KG>(as, bs, stride, seg, q, wn, g, t, acc);
    }
    __syncthreads();
  }

  if constexpr (KG > 1) {
    // groups KG-1 .. 1 add their sums into group 0, one group a round
    for (int from = KG - 1; from >= 1; --from) {
      if (q == from) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          red[warp & 1][i][lane] =
              make_int4(acc[i >> 2][i & 3][0], acc[i >> 2][i & 3][1],
                        acc[i >> 2][i & 3][2], acc[i >> 2][i & 3][3]);
        }
      }
      __syncthreads();
      if (q == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int4 v = red[warp & 1][i][lane];
          acc[i >> 2][i & 3][0] += v.x, acc[i >> 2][i & 3][1] += v.y;
          acc[i >> 2][i & 3][2] += v.z, acc[i >> 2][i & 3][3] += v.w;
        }
      }
      __syncthreads();
    }
  }
  if (q != 0) return;

  // accumulator registers 0, 1: row g, columns 2t, 2t + 1; 2, 3: row g + 8
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    if (mi >= mi_live) break;
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int rl = mi * 16 + g, nl = wn + ni * 8 + 2 * t;
      const int pb0 = pops[kBM + nl], pb1 = pops[kBM + nl + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pa = pops[rl + 8 * h];
        store_pair(c, m0 + rl + 8 * h, n0 + nl, m_rows, n_rows,
                   4 * acc[mi][ni][2 * h] - 2 * pa - 2 * pb0 + k,
                   4 * acc[mi][ni][2 * h + 1] - 2 * pa - 2 * pb1 + k);
      }
    }
  }
}

template <int KG>
int launch(const void* a, const void* b, void* c, int m_rows, int n_rows,
           int words, int k, cudaStream_t stream) {
  // one segment of K words a pass: all of K where it fits
  const int seg = min((words + 7) / 8 * 8, kSegMax);
  const int smem = (kBM + kBN) * (seg + 4) * 4;
  static int smem_set = 0;                    // the attribute is per kernel
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        xnor_gemm_kernel<KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const bool vec =
      words % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 ==
          0;
  const dim3 grid((n_rows + kBN - 1) / kBN, (m_rows + kBM - 1) / kBM);
  xnor_gemm_kernel<KG><<<grid, 64 * KG, smem, stream>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<int32_t*>(c), m_rows, n_rows, words, k, seg, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a [m_rows, words], b [n_rows, words] uint32 sign words; c [m_rows, n_rows]
// int32; 0 < k <= 32 * words; k_groups (1, 2 or 4) warps share each
// warp's outputs along K
extern "C" int xnor_gemm(const void* a, const void* b, void* c, int m_rows,
                         int n_rows, int words, int k, int k_groups,
                         void* stream) {
  if (m_rows <= 0 || n_rows <= 0 || words <= 0 || k <= 0 || k > 32 * words)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(c) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k_groups) {
    case 1: return launch<1>(a, b, c, m_rows, n_rows, words, k, s);
    case 2: return launch<2>(a, b, c, m_rows, n_rows, words, k, s);
    case 4: return launch<4>(a, b, c, m_rows, n_rows, words, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
