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
// Replaces src/repro/kernels/flash_attention.py:_bwd_dkv_kernel and
// _bwd_dq_kernel and computes what they compute: float32 math on widened
// operands, scale 1/sqrt(D), the causal mask on absolute indices (query i
// sees keys j <= i), also when Sq != Sk.  On the TPU the (rep, Sq-block)
// sweep of dkv and the Sk sweep of dq are the grids' sequential innermost
// axes, with the sums in VMEM scratch.  Here each output tile has one
// owner block that loops over the sweep itself and keeps its sums in
// registers: no atomics, so the backward is deterministic.
//
// Design (the forward kernel's): 256 threads as 16 x 16 (ty, tx), 64 x 64
// tiles, every operand widened to float32 in shared memory, rows padded by
// one float so column walks spread over the 32 banks.  The work is float32
// multiply-adds on the CUDA cores (4 products of 64 x 64 x D per tile pair
// for dkv, 3 for dq), so operations bound it, not device memory.
//   dkv: one block per (b, kv head, 64-key tile).  A thread owns 4 key rows
//        (ty + 16 a) and D/16 columns (tx + 16 c) of dk and dv, and the
//        transposed score tile's entries (key ty + 16 a, query tx + 16 b).
//   dq:  one block per (b, h, 64-query tile); a thread owns 4 query rows
//        and 4 keys of the score tile, and the same rows' D/16 columns of
//        dq.
// Tiles the causal mask covers entirely are skipped: their p is exactly 0,
// so skipping is exact, and a key no query sees gets dk = dv = 0.
// Tensor cores (wgmma) and TMA loads are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // queries and keys per tile
constexpr int kThreads = 256;   // 16 x 16

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, bool kDkv>
int dispatch(const Args& a, int d) {
  switch (d) {
    case 16: return kDkv ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return kDkv ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return kDkv ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return kDkv ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
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
  return is_bf16 ? dispatch<__nv_bfloat16, true>(a, d)
                 : dispatch<float, true>(a, d);
}

extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int batch,
                                 int n_heads, int n_rep, int sq, int sk, int d,
                                 int causal, int is_bf16, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, batch,
               n_heads, n_rep, sq, sk, causal,
               static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16, false>(a, d)
                 : dispatch<float, false>(a, d);
}
