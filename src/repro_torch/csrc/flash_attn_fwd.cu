// Flash attention forward, GQA-aware: out[b, h, i] = softmax(q k^T * scale)
// v over the keys of kv head h / n_rep, with lse[b, h, i] = m + log(l).
// q [B, H, Sq, D], k and v [B, Hkv, Sk, D], float32 or bfloat16, contiguous;
// out [B, H, Sq, D] in q's type, lse [B, H, Sq] float32.
//
// Replaces src/repro/kernels/flash_attention.py:_fwd_kernel and computes
// what it computes: float32 math on float32-widened q, k and v, scale
// 1/sqrt(D) applied to each dot, masked scores set to -1e30 (not -inf),
// the running max and sum updated once per key tile, l clamped at 1e-30,
// and the repeated kv heads never materialised (h / n_rep indexes them).
// The causal mask compares absolute indices (query i sees keys j <= i),
// as the reference does, also when Sq != Sk.
//
// On the TPU the key tiles are the grid's sequential innermost axis, with
// the running (acc, m, l) state in VMEM scratch.  Here one block owns one
// (b, h, 64-query tile) and loops over the key tiles itself; the state
// stays in registers.  The work is float32 multiply-adds, so the CUDA
// cores' operations bound it, not device memory (q, k, v and out are read
// or written once per block).  The design keeps every operand in shared
// memory as float32: 256 threads, each owning 4 query rows (ty + 16 i) and
// 4 key columns (tx + 16 j) of the 64 x 64 score tile, then the same 4 rows
// and D/16 columns of the output accumulator, so a row's max, sum and
// rescale never leave the thread's half-warp (shuffles over tx).  Rows of
// the q and k tiles are padded by one float so column walks spread over
// the 32 banks.  A key tile that the causal mask covers entirely is
// skipped: its p would underflow to 0 and its alpha be 1, so skipping is
// exact.  Tensor cores (wgmma) and TMA loads are a later change.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx picks columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

constexpr size_t smem_floats(int d) {
  return static_cast<size_t>(kBQ) * (d + 1)      // q tile
         + static_cast<size_t>(kBK) * (d + 1)    // k tile
         + static_cast<size_t>(kBK) * d          // v tile
         + static_cast<size_t>(kBQ) * (kBK + 1); // p tile
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n_heads, int n_rep, int sq,
                 int sk, int causal, float scale) {
  constexpr int kCols = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * (D + 1);
  float* vs = ks + kBK * (D + 1);
  float* ps = vs + kBK * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_kv = n_heads / n_rep;
  const int q0 = blockIdx.x * kBQ;
  const size_t q_base = static_cast<size_t>(bh) * sq * D;
  const size_t kv_base =
      (static_cast<size_t>(b) * n_kv + h / n_rep) * static_cast<size_t>(sk) * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[r * (D + 1) + c] =
        q0 + r < sq ? widen(q[q_base + static_cast<size_t>(q0 + r) * D + c])
                    : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;   // keys past it are masked
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      const size_t at = kv_base + static_cast<size_t>(k0 + r) * D + c;
      ks[r * (D + 1) + c] = in ? widen(k[at]) : 0.f;
      vs[r * D + c] = in ? widen(v[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && qi < kj) x = kNegInf;
        if (kj >= sk) x = -INFINITY;    // no such key: p is exactly 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) narrow(orow + tx + 16 * j, acc[i][j] / li);
    if (tx == 0)
      lse[static_cast<size_t>(bh) * sq + qi] = m[i] + logf(li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int n_heads, int n_rep, int sq, int sk, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_floats(D) * sizeof(float);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n_heads, n_rep, sq, sk, causal, 1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int batch, int n_heads, int n_rep, int sq, int sk, int d,
             int causal, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                           causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                           causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                            causal, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// is_bf16 selects the element type of q, k, v and out (else float32).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int batch, int n_heads,
                              int n_rep, int sq, int sk, int d, int causal,
                              int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, n_heads,
                                           n_rep, sq, sk, d, causal, s)
                 : dispatch<float>(q, k, v, o, lse, batch, n_heads, n_rep, sq,
                                   sk, d, causal, s);
}
