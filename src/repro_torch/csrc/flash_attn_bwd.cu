// Flash attention backward, GQA-aware, recomputing p from the forward's
// row log-sum-exp: two kernels.
//   dkv: dk[b, g, j] = sum over the n_rep query heads h of kv head g and
//        the queries i of ds[h, i, j] q[h, i];  dv likewise with p and do.
//   dq:  dq[b, h, i] = sum over the keys j of ds[h, i, j] k[g, j].
// with s = q k^T * scale, p = exp(s - lse) (0 where the causal mask hides
// key j from query i), dp = do v^T and ds = p * (dp - delta) * scale,
// delta[b, h, i] = sum_d out * do (computed by the caller, as the
// reference computes it outside its kernels).
// q, do [B, H, Sq, D]; k, v [B, Hkv, Sk, D]; float32 or bfloat16,
// contiguous; lse, delta [B, H, Sq] float32.  dq in q's type, dk and dv in
// k's type, each rounded once from a float32 sum.
//
// Replaces src/repro/kernels/flash_attention.py:_bwd_dkv_kernel (dkv) and
// _bwd_dq_kernel (dq) and computes what they compute: scale 1/sqrt(D),
// p = exp(s * scale - lse), the causal mask on absolute indices (query i
// sees keys j <= i), also when Sq != Sk, the n_rep query heads of a kv
// head summed without a materialised repeat (h / n_rep).  On the TPU the
// (rep, Sq-block) sweep of dkv and the Sk sweep of dq are the grids'
// sequential innermost axes, with the sums in VMEM scratch.  Here each
// output tile has one owner block that loops over the sweep itself and
// keeps its sums in registers: no atomics, so the sums run in a fixed
// order and the backward is deterministic.  Query tiles the causal mask
// hides from a key tile are skipped: their p is exactly 0, so skipping is
// exact, and a key no query sees gets dk = dv = 0.
//
// dkv in bfloat16 (flash_bwd_dkv_bf16_kernel): the products run on the
// tensor cores (mma.sync m16n8k16, bf16 operands, float32 sums), so their
// rate bounds it.  One block per (b, kv head, 64-key tile), 4 warps, each
// owning 16 key rows of dk and dv as float32 register sums.  k and v are
// copied once (16-byte cp.async) into XOR-swizzled shared tiles; q, do, lse
// and delta of each (query head, query tile) step stream through a two-stage
// cp.async ring, the next step's copy in flight during this step's products.
// Query tiles are 64 wide (32 at D = 128, where the 2 x 16 x 128 float32
// sums per warp take 128 registers a lane).  Per step: s^T = k q^T and dp^T
// = v do^T by mma (k, v as A fragments by ldmatrix, q, do as B), then p^T =
// exp(s^T * scale - lse) (as exp2f, mma_bf16.cuh) and ds^T = p^T (dp^T -
// delta) * scale in registers with the float32 kernel's mask rules, tested
// only on tiles that cross the diagonal or a ragged end; their C fragments
// are reused as the A fragments of dv += p^T do and dk += ds^T q, with do
// and q read by ldmatrix.trans.  p and ds are split into bf16 hi + lo halves
// (two mma per product): rounded once to bf16 they put dv and dk up to 2.7
// and 1.4 bf16 ulps from the float32 plain version
// (tests/test_torch_flash_backward.py emulates both), split they stay within
// one.  ptxas (sm_90a) at D = 16 / 32 / 64 / 128: 126 / 156 / 223 / 255
// registers, no spills below D = 128 and 12 bytes of spill (a 16-byte stack
// frame) at D = 128; dynamic shared memory 2 x 64 x D x 2 bytes for k, v
// plus two stages of q, do (and lse, delta): 49 KB at D = 64, 64.5 KB at D =
// 128.
//
// dq in bfloat16 (flash_bwd_dq_bf16_kernel): dkv's design mirrored.  One
// block per (b, h, 64-query tile), 4 warps, each owning 16 query rows of
// dq as float32 register sums.  q and do are copied once into swizzled
// shared tiles and read as A fragments; k and v of kv head h / n_rep
// stream through a two-stage cp.async ring, the next key tile's copy in
// flight during this tile's products.  s = q k^T and dp = do v^T by mma
// (k, v as B fragments), then p = exp2f(s * scale * log2e - lse * log2e)
// and ds = p (dp - delta) * scale in registers, with the same edge-only
// mask tests; key tiles the causal mask hides are skipped.  dq += ds k
// reuses ds's C fragments as A fragments, k read by ldmatrix.trans, with
// ds split into bf16 hi + lo halves: rounded once, ds puts dq up to 1.04
// bf16 ulps from the float32 plain version (512 tokens, 12 heads;
// tests/test_torch_flash_backward.py emulates both), split it stays
// within 0.64.  Dynamic shared memory 6 x 64 x D x 2 bytes (q, do and two
// stages of k, v): 48 KB at D = 64, 96 KB at D = 128.
//
// dq and dkv in float32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel):
// float32 math on the CUDA cores, kept so that the float32 checks (2e-4)
// hold without TF32.  256 threads as 16 x 16 (ty,
// tx), 64 x 64 tiles, every operand widened to float32 in shared memory,
// rows padded by one float so column walks spread over the 32 banks.
//   dkv: one block per (b, kv head, 64-key tile).  A thread owns 4 key rows
//        (ty + 16 a) and D/16 columns (tx + 16 c) of dk and dv, and the
//        transposed score tile's entries (key ty + 16 a, query tx + 16 b).
//   dq:  one block per (b, h, 64-query tile); a thread owns 4 query rows
//        and 4 keys of the score tile, and the same rows' D/16 columns of
//        dq.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kTile = 64;       // queries and keys per tile
constexpr int kThreads = 256;   // 16 x 16

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

// rows [r0, r0 + 64) of a [rows, D] matrix at `src` into a padded float32
// tile; rows past `rows` read as 0
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int r0, int rows) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] =
        r0 + r < rows ? widen(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

constexpr size_t dkv_smem_floats(int d) {
  return 4 * static_cast<size_t>(kTile) * (d + 1)    // k, v, q, do tiles
         + 2 * static_cast<size_t>(kTile) * (kTile + 1)  // p^T, ds^T
         + 2 * kTile;                                // lse, delta
}

constexpr size_t dq_smem_floats(int d) {
  return 4 * static_cast<size_t>(kTile) * (d + 1)    // q, do, k, v tiles
         + static_cast<size_t>(kTile) * (kTile + 1)  // ds
         + 2 * kTile;                                // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int n_heads, int n_rep, int sq,
                     int sk, int causal, float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * (D + 1);
  float* qs = vs + kTile * (D + 1);
  float* dos = qs + kTile * (D + 1);
  float* pt = dos + kTile * (D + 1);      // p^T [key][query]
  float* dst = pt + kTile * (kTile + 1);  // ds^T [key][query]
  float* lse_s = dst + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int n_kv = n_heads / n_rep;
  const int bg = blockIdx.y;              // b * n_kv + g
  const int b = bg / n_kv;
  const int g = bg % n_kv;
  const int k0 = blockIdx.x * kTile;
  const size_t kv_base = static_cast<size_t>(bg) * sk * D;

  load_tile<T, D>(ks, k + kv_base, k0, sk);
  load_tile<T, D>(vs, v + kv_base, k0, sk);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const int n_qt = (sq + kTile - 1) / kTile;
  // causal: query tiles whose last query precedes k0 see none of these keys
  const int t0 = causal ? min(k0 / kTile, n_qt) : 0;

  for (int r = 0; r < n_rep; ++r) {
    const int h = g * n_rep + r;
    const size_t q_base = (static_cast<size_t>(b) * n_heads + h) * sq;
    for (int t = t0; t < n_qt; ++t) {
      const int q0 = t * kTile;
      load_tile<T, D>(qs, q + q_base * D, q0, sq);
      load_tile<T, D>(dos, dout + q_base * D, q0, sq);
      if (threadIdx.x < kTile) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < sq ? lse[q_base + i] : 0.f;
        delta_s[threadIdx.x] = i < sq ? delta[q_base + i] : 0.f;
      }
      __syncthreads();

      // s^T[key][query] = k q^T and dp^T = v do^T, 4 keys x 4 queries each
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dv_[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kv[a] = ks[(ty + 16 * a) * (D + 1) + d];
          vv[a] = vs[(ty + 16 * a) * (D + 1) + d];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qv[c] = qs[(tx + 16 * c) * (D + 1) + d];
          dv_[c] = dos[(tx + 16 * c) * (D + 1) + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(kv[a], qv[c], s[a][c]);
            dp[a][c] = fmaf(vv[a], dv_[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int kj = k0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int il = tx + 16 * c;
          const int qi = q0 + il;
          const bool live = qi < sq && kj < sk && !(causal && qi < kj);
          const float p = live ? expf(s[a][c] * scale - lse_s[il]) : 0.f;
          pt[(ty + 16 * a) * (kTile + 1) + il] = p;
          dst[(ty + 16 * a) * (kTile + 1) + il] =
              p * (dp[a][c] - delta_s[il]) * scale;
        }
      }
      __syncthreads();

      // dv += p^T do, dk += ds^T q over this tile's queries
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        float pv[4], dsv[4], dov[kCols], qv[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = pt[(ty + 16 * a) * (kTile + 1) + i];
          dsv[a] = dst[(ty + 16 * a) * (kTile + 1) + i];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dov[c] = dos[i * (D + 1) + tx + 16 * c];
          qv[c] = qs[i * (D + 1) + tx + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[a][c] = fmaf(pv[a], dov[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qv[c], acc_k[a][c]);
          }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= sk) continue;
    const size_t row = kv_base + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      narrow(dk + row + tx + 16 * c, acc_k[a][c]);
      narrow(dv + row + tx + 16 * c, acc_v[a][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int n_heads, int n_rep, int sq, int sk, int causal,
                    float scale) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * (D + 1);
  float* ks = dos + kTile * (D + 1);
  float* vs = ks + kTile * (D + 1);
  float* dss = vs + kTile * (D + 1);      // ds [query][key]
  float* lse_s = dss + kTile * (kTile + 1);
  float* delta_s = lse_s + kTile;

  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_kv = n_heads / n_rep;
  const int q0 = blockIdx.x * kTile;
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const size_t kv_base =
      (static_cast<size_t>(b) * n_kv + h / n_rep) * static_cast<size_t>(sk) * D;

  load_tile<T, D>(qs, q + q_base * D, q0, sq);
  load_tile<T, D>(dos, dout + q_base * D, q0, sq);
  if (threadIdx.x < kTile) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < sq ? lse[q_base + i] : 0.f;
    delta_s[threadIdx.x] = i < sq ? delta[q_base + i] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;

  int n_tiles = (sk + kTile - 1) / kTile;
  if (causal) {
    const int q_last = min(q0 + kTile, sq) - 1;   // keys past it are masked
    n_tiles = min(n_tiles, q_last / kTile + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    load_tile<T, D>(ks, k + kv_base, k0, sk);
    load_tile<T, D>(vs, v + kv_base, k0, sk);
    __syncthreads();

    // s = q k^T and dp = do v^T, 4 queries x 4 keys each
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qv[a] = qs[(ty + 16 * a) * (D + 1) + d];
        dov[a] = dos[(ty + 16 * a) * (D + 1) + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kv[c] = ks[(tx + 16 * c) * (D + 1) + d];
        vv[c] = vs[(tx + 16 * c) * (D + 1) + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
          dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a;
      const int qi = q0 + il;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        const bool live = qi < sq && kj < sk && !(causal && qi < kj);
        const float p = live ? expf(s[a][c] * scale - lse_s[il]) : 0.f;
        dss[il * (kTile + 1) + tx + 16 * c] =
            p * (dp[a][c] - delta_s[il]) * scale;
      }
    }
    __syncthreads();

    // dq += ds k over this tile's keys
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dss[(ty + 16 * a) * (kTile + 1) + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= sq) continue;
    T* row = dq + (q_base + qi) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) narrow(row + tx + 16 * c, acc[a][c]);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int batch, n_heads, n_rep, sq, sk, causal;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dkv(const Args& a) {
  constexpr size_t smem = dkv_smem_floats(D) * sizeof(float);
  static bool attr_set = false;
  if (int err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem, &attr_set))
    return err;
  const dim3 grid((a.sk + kTile - 1) / kTile,
                  a.batch * (a.n_heads / a.n_rep));
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.n_heads, a.n_rep, a.sq,
      a.sk, a.causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_floats(D) * sizeof(float);
  static bool attr_set = false;
  if (int err = allow_smem(flash_bwd_dq_kernel<T, D>, smem, &attr_set))
    return err;
  const dim3 grid((a.sq + kTile - 1) / kTile, a.batch * a.n_heads);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.n_heads, a.n_rep, a.sq, a.sk, a.causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// instantiates only the kernel asked for (bf16 dkv has its own dispatch)
template <typename T, bool kDkv, int D>
int launch(const Args& a) {
  if constexpr (kDkv) return launch_dkv<T, D>(a);
  else return launch_dq<T, D>(a);
}

template <typename T, bool kDkv>
int dispatch(const Args& a, int d) {
  switch (d) {
    case 16: return launch<T, kDkv, 16>(a);
    case 32: return launch<T, kDkv, 32>(a);
    case 64: return launch<T, kDkv, 64>(a);
    case 128: return launch<T, kDkv, 128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- dkv in bfloat16: tensor cores ------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps x 16 key rows

// queries per streamed tile: 32 at D = 128 keeps the float32 dk and dv
// sums (2 x D per lane) and the score tiles within 255 registers
template <int D>
__host__ __device__ constexpr int dkv_q_tile() { return D == 128 ? 32 : 64; }

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return 2 * static_cast<size_t>(kTile) * D * sizeof(__nv_bfloat16)  // k, v
         + 2 * 2 * static_cast<size_t>(dkv_q_tile<D>()) * D *
               sizeof(__nv_bfloat16)                     // 2 stages of q, do
         + 2 * 2 * static_cast<size_t>(dkv_q_tile<D>()) * sizeof(float);
                                                 // 2 stages of lse, delta
}

// acc [16 x D] += a b over the 16-query step kk: a from the C fragments
// of a [16 x kNq*8] float32 tile, split into bf16 hi + lo, and b the
// step's 16 rows of a swizzled [queries][D] shared tile (ldmatrix.trans)
template <int D, int kNq>
__device__ __forceinline__ void second_product(float (&acc)[D / 8][4],
                                               const float (&c)[kNq][4],
                                               int kk,
                                               const __nv_bfloat16* tile,
                                               int lane) {
  using namespace mma_bf16;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int j = 2 * kk + (x >> 1), e = 2 * (x & 1);
    split_bf16(c[j][e], c[j][e + 1], hi[x], lo[x]);
  }
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(frag_a_addr<D>(tile, kk * 16, np * 16, lane), b);
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np], lo, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    mma(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int n_heads,
                          int n_rep, int sq, int sk, int causal, float scale) {
  using namespace mma_bf16;
  constexpr int kQT = dkv_q_tile<D>();
  constexpr int kNq = kQT / 8;      // 8-query n-tiles of the score tile
  constexpr int kNd = D / 8;        // 8-wide column tiles of dk, dv
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* vs = ks + kTile * D;
  __nv_bfloat16* qs = vs + kTile * D;         // [2][kQT][D]
  __nv_bfloat16* dos = qs + 2 * kQT * D;      // [2][kQT][D]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kQT * D);   // [2][kQT]
  float* delta_s = lse_s + 2 * kQT;                             // [2][kQT]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int n_kv = n_heads / n_rep;
  const int bg = blockIdx.y;              // b * n_kv + g
  const int b = bg / n_kv;
  const int g = bg % n_kv;
  const int k0 = blockIdx.x * kTile;
  const int kr = k0 + warp * 16 + lane / 4;   // key of c[0..1]; +8: c[2..3]
  const size_t kv_base = static_cast<size_t>(bg) * sk * D;

  const int n_qt = (sq + kQT - 1) / kQT;
  // causal: query tiles whose last query precedes k0 see none of these keys
  const int t0 = causal ? min(k0 / kQT, n_qt) : 0;
  const int per_head = n_qt - t0;
  const int n_it = n_rep * per_head;      // (query head, query tile) pairs

  // copies of step `it` (head r = it / per_head, its query tile
  // t0 + it % per_head) into ring stage it & 1
  auto issue = [&](int it) {
    const int h = g * n_rep + it / per_head;
    const int q0 = (t0 + it % per_head) * kQT;
    const size_t row0 = (static_cast<size_t>(b) * n_heads + h) * sq;
    const int st = (it & 1) * kQT;
    load_tile_async<D, kQT, kTcThreads>(qs + st * D, q + row0 * D, q0, sq);
    load_tile_async<D, kQT, kTcThreads>(dos + st * D, dout + row0 * D, q0,
                                        sq);
    if (threadIdx.x < 2 * kQT) {
      const int i = threadIdx.x % kQT;
      const bool in = q0 + i < sq;
      const float* src = (threadIdx.x < kQT ? lse : delta) + row0 +
                         (in ? q0 + i : 0);
      float* dst = (threadIdx.x < kQT ? lse_s : delta_s) + st + i;
      cp_async4(smem_addr(dst), src, in ? 4 : 0);
    }
  };

  load_tile_async<D, kTile, kTcThreads>(ks, k + kv_base, k0, sk);
  load_tile_async<D, kTile, kTcThreads>(vs, v + kv_base, k0, sk);
  if (n_it > 0) issue(0);
  cp_async_commit();

  float acc_k[kNd][4], acc_v[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = (it & 1) * kQT;
    const int q0 = (t0 + it % per_head) * kQT;
    const __nv_bfloat16* qt = qs + st * D;
    const __nv_bfloat16* dot = dos + st * D;
    const float* lt = lse_s + st;
    const float* dlt = delta_s + st;

    // s^T = k q^T and dp^T = v do^T: 16 keys x kQT queries per warp
    float s[kNq][4], dp[kNq][4];
#pragma unroll
    for (int j = 0; j < kNq; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(frag_a_addr<D>(ks, warp * 16, kk * 16, lane), ka);
      ldsm_x4(frag_a_addr<D>(vs, warp * 16, kk * 16, lane), va);
#pragma unroll
      for (int np = 0; np < kNq / 2; ++np) {
        uint32_t bq[4], bd[4];
        ldsm_x4(frag_bt_addr<D>(qt, np * 16, kk * 16, lane), bq);
        ldsm_x4(frag_bt_addr<D>(dot, np * 16, kk * 16, lane), bd);
        mma(s[2 * np], ka, bq[0], bq[1]);
        mma(s[2 * np + 1], ka, bq[2], bq[3]);
        mma(dp[2 * np], va, bd[0], bd[1]);
        mma(dp[2 * np + 1], va, bd[2], bd[3]);
      }
    }

    // p^T and ds^T in place, with the float32 kernel's mask rules, tested
    // only where the tile crosses the diagonal or a ragged end
    const bool edge = (causal && q0 < k0 + kTile - 1) || q0 + kQT > sq ||
                      k0 + kTile > sk;
#pragma unroll
    for (int j = 0; j < kNq; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kr + 8 * (e >> 1);
        const int il = 8 * j + 2 * t4 + (e & 1);
        const int qi = q0 + il;
        const bool live =
            !edge || (qi < sq && kj < sk && !(causal && qi < kj));
        const float p =
            live ? exp2f((s[j][e] * scale - lt[il]) * kLog2e) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dlt[il]) * scale;
      }

    // dv += p^T do and dk += ds^T q: the C fragments of query tiles 2kk,
    // 2kk + 1 are the A fragment of the 16-query step kk, split into bf16
    // hi + lo halves (two products per step); do and q by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kNq / 2; ++kk) {
      second_product<D>(acc_v, s, kk, dot, lane);
      second_product<D>(acc_k, dp, kk, qt, lane);
    }
    __syncthreads();   // the next iteration refills this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = kr + 8 * r;
    if (kj >= sk) continue;
    const size_t row = kv_base + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      store_bf16x2(dk + row + 8 * n + 2 * t4, acc_k[n][2 * r],
                   acc_k[n][2 * r + 1]);
      store_bf16x2(dv + row + 8 * n + 2 * t4, acc_v[n][2 * r],
                   acc_v[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_dkv_bf16(const Args& a) {
  constexpr size_t smem = dkv_bf16_smem_bytes<D>();
  static bool attr_set = false;
  if (int err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem, &attr_set))
    return err;
  const dim3 grid((a.sk + kTile - 1) / kTile,
                  a.batch * (a.n_heads / a.n_rep));
  flash_bwd_dkv_bf16_kernel<D><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.n_heads, a.n_rep, a.sq, a.sk, a.causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies 16-byte chunks of q, k, v and do
bool misaligned(const Args& a) {
  return (reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
          reinterpret_cast<uintptr_t>(a.v) |
          reinterpret_cast<uintptr_t>(a.dout)) & 15;
}

int dispatch_dkv_bf16(const Args& a, int d) {
  if (misaligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 16: return launch_dkv_bf16<16>(a);
    case 32: return launch_dkv_bf16<32>(a);
    case 64: return launch_dkv_bf16<64>(a);
    case 128: return launch_dkv_bf16<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}


// ---- dq in bfloat16: tensor cores -------------------------------------------

template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  // the q and do tiles, then two stages of the k tile and of the v tile
  return 6 * static_cast<size_t>(kTile) * D * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int n_heads,
                         int n_rep, int sq, int sk, int causal, float scale) {
  using namespace mma_bf16;
  constexpr int kNk = kTile / 8;    // 8-key n-tiles of the score tile
  constexpr int kNd = D / 8;        // 8-wide column tiles of dq
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* dos = qs + kTile * D;
  __nv_bfloat16* ks = dos + kTile * D;       // [2][kTile][D]
  __nv_bfloat16* vs = ks + 2 * kTile * D;    // [2][kTile][D]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_kv = n_heads / n_rep;
  const int q0 = blockIdx.x * kTile;
  const int qr = q0 + warp * 16 + lane / 4;   // row of c[0..1]; +8: c[2..3]
  const size_t q_base = static_cast<size_t>(bh) * sq;
  const size_t kv_base =
      (static_cast<size_t>(b) * n_kv + h / n_rep) * static_cast<size_t>(sk) * D;

  int n_tiles = (sk + kTile - 1) / kTile;
  if (causal) {
    const int q_last = min(q0 + kTile, sq) - 1;   // keys past it are masked
    n_tiles = min(n_tiles, q_last / kTile + 1);
  }

  load_tile_async<D, kTile, kTcThreads>(qs, q + q_base * D, q0, sq);
  load_tile_async<D, kTile, kTcThreads>(dos, dout + q_base * D, q0, sq);
  if (n_tiles > 0) {
    load_tile_async<D, kTile, kTcThreads>(ks, k + kv_base, 0, sk);
    load_tile_async<D, kTile, kTcThreads>(vs, v + kv_base, 0, sk);
  }
  cp_async_commit();

  // lse and delta of this lane's two rows (0 past the last query, whose
  // p the mask zeroes)
  const float scale_log2 = scale * kLog2e;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    lse_r[r] = qi < sq ? lse[q_base + qi] * kLog2e : 0.f;
    delta_r[r] = qi < sq ? delta[q_base + qi] : 0.f;
  }

  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * kTile * D;
      load_tile_async<D, kTile, kTcThreads>(ks + nxt, k + kv_base,
                                            (t + 1) * kTile, sk);
      load_tile_async<D, kTile, kTcThreads>(vs + nxt, v + kv_base,
                                            (t + 1) * kTile, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kTile * D;
    const __nv_bfloat16* vt = vs + stage * kTile * D;

    // s = q k^T and dp = do v^T: 16 rows x 64 keys per warp, q and do as
    // A fragments, k and v as B
    float s[kNk][4], dp[kNk][4];
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldsm_x4(frag_a_addr<D>(qs, warp * 16, kk * 16, lane), qa);
      ldsm_x4(frag_a_addr<D>(dos, warp * 16, kk * 16, lane), da);
#pragma unroll
      for (int np = 0; np < kNk / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(frag_bt_addr<D>(kt, np * 16, kk * 16, lane), bk);
        ldsm_x4(frag_bt_addr<D>(vt, np * 16, kk * 16, lane), bv);
        mma(s[2 * np], qa, bk[0], bk[1]);
        mma(s[2 * np + 1], qa, bk[2], bk[3]);
        mma(dp[2 * np], da, bv[0], bv[1]);
        mma(dp[2 * np + 1], da, bv[2], bv[3]);
      }
    }

    // ds = p (dp - delta) scale in place, with the float32 kernel's mask
    // rules, tested only where the tile crosses the diagonal or a ragged
    // end
    const int k0 = t * kTile;
    const bool edge = (causal && k0 + kTile - 1 > q0) || q0 + kTile > sq ||
                      k0 + kTile > sk;
#pragma unroll
    for (int j = 0; j < kNk; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qr + 8 * (e >> 1);
        const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
        const bool live =
            !edge || (qi < sq && kj < sk && !(causal && qi < kj));
        const float p =
            live ? exp2f(s[j][e] * scale_log2 - lse_r[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - delta_r[e >> 1]) * scale;
      }

    // dq += ds k: the C fragments of key tiles 2kk, 2kk + 1 are the A
    // fragment of the 16-key step kk, split into bf16 hi + lo halves; k
    // by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kNk / 2; ++kk) second_product<D>(acc, dp, kk, kt, lane);
    __syncthreads();   // the next iteration refills this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    if (qi >= sq) continue;
    __nv_bfloat16* row = dq + (q_base + qi) * D;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      store_bf16x2(row + 8 * n + 2 * t4, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <int D>
int launch_dq_bf16(const Args& a) {
  constexpr size_t smem = dq_bf16_smem_bytes<D>();
  static bool attr_set = false;
  if (int err = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem, &attr_set))
    return err;
  const dim3 grid((a.sq + kTile - 1) / kTile, a.batch * a.n_heads);
  flash_bwd_dq_bf16_kernel<D><<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), a.n_heads, a.n_rep, a.sq, a.sk,
      a.causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_dq_bf16(const Args& a, int d) {
  if (misaligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 16: return launch_dq_bf16<16>(a);
    case 32: return launch_dq_bf16<32>(a);
    case 64: return launch_dq_bf16<64>(a);
    case 128: return launch_dq_bf16<128>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// is_bf16 selects the element type of q, k, v, do and the gradients (else
// float32); lse and delta are float32.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int batch, int n_heads, int n_rep, int sq,
                                  int sk, int d, int causal, int is_bf16,
                                  void* stream) {
  const Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, batch, n_heads,
               n_rep, sq, sk, causal, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch_dkv_bf16(a, d) : dispatch<float, true>(a, d);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int n_heads, int n_rep, int sq, int sk, int d,
                                 int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch,
               n_heads, n_rep, sq, sk, causal,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch_dq_bf16(a, d) : dispatch<float, false>(a, d);
}
