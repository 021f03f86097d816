// Flash attention forward, GQA-aware: out[b, h, i] = softmax(q k^T * scale)
// v over the keys of kv head h / n_rep, with lse[b, h, i] = m + log(l).
// q [B, H, Sq, D], k and v [B, Hkv, Sk, D], float32 or bfloat16, contiguous;
// out [B, H, Sq, D] in q's type, lse [B, H, Sq] float32.
//
// Replaces src/repro/kernels/flash_attention.py:_fwd_kernel and computes
// what it computes: scale 1/sqrt(D) applied to each dot, masked scores set
// to -1e30 (not -inf) and absent keys to -inf, the running max and sum
// updated once per key tile, l clamped at 1e-30, lse = m + log l, out
// rounded once to q's type, and the repeated kv heads never materialised
// (h / n_rep indexes them).  The causal mask compares absolute indices
// (query i sees keys j <= i), as the reference does, also when Sq != Sk.
// On the TPU the key tiles are the grid's sequential innermost axis, with
// the running (acc, m, l) state in VMEM scratch.  Here one block owns one
// (b, h, 64-query tile) and loops over the 64-key tiles itself; the state
// stays in registers.  A key tile that the causal mask covers entirely is
// skipped: its p would underflow to 0 and its alpha be 1, so skipping is
// exact.  Two kernels:
//
// bfloat16 (flash_fwd_bf16_kernel): the products run on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 sums), so their rate bounds
// it.  4 warps, each owning 16 query rows.  The q tile is copied once
// with 16-byte cp.async and held as A fragments (ldmatrix) for the whole
// key loop.  k and v tiles (64 keys of bf16) stream through a two-stage
// shared-memory ring by cp.async.cg commit/wait groups: tile t + 1 is in
// flight while tile t is multiplied.  Tiles are XOR-swizzled by 16-byte
// chunk (mma_bf16.cuh) so ldmatrix reads them without bank conflicts.
// S = q k^T lands in C fragments; the online softmax runs on them in
// registers (row max and sum over the lane quad by shuffles; masks only
// on the diagonal and ragged tiles; exp as exp2f of a scaled argument,
// mma_bf16.cuh).  p is rounded to bf16 once and its C
// fragments become the A fragments of O += p v (the FlashAttention-2
// layout identity), with v read by ldmatrix.trans; l sums the float32 p.
// One rounding of p keeps out within one bf16 ulp of the float32 plain
// version (tests/test_torch_flash_attention.py emulates it), so p needs
// no hi/lo split here.  ptxas (sm_90a) at D = 16 / 32 / 64 / 128: 75 /
// 98 / 130 / 222 registers, no spills; (64 + 4 * 64) * D * 2 bytes of
// dynamic shared memory (40 KB at D = 64, 80 KB at D = 128).
//
// float32 (flash_fwd_kernel): float32 math on the CUDA cores, kept so that
// the float32 checks (2e-5) hold without TF32.  256 threads, each owning 4
// query rows (ty + 16 i) and 4 key columns (tx + 16 j) of the 64 x 64 score
// tile, then the same 4 rows and D/16 columns of the output accumulator,
// so a row's max, sum and rescale never leave the thread's half-warp
// (shuffles over tx).  Operands are widened to float32 in shared memory,
// rows of the q and k tiles padded by one float so column walks spread
// over the 32 banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx picks columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }

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


// ---- bfloat16: tensor cores -------------------------------------------------

constexpr int kTcThreads = 128;   // 4 warps x 16 query rows

template <int D>
constexpr size_t fwd_bf16_smem_bytes() {
  // the q tile, then two stages of the k tile and of the v tile
  return static_cast<size_t>(kBQ + 4 * kBK) * D * sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int n_heads, int n_rep, int sq, int sk, int causal,
                      float scale) {
  using namespace mma_bf16;
  constexpr int kKSteps = D / 16;   // 16-deep steps of q k^T
  constexpr int kNd = D / 8;        // 8-wide column tiles of out
  extern __shared__ uint4 tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* ks = qs + kBQ * D;        // [2][kBK][D]
  __nv_bfloat16* vs = ks + 2 * kBK * D;    // [2][kBK][D]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int n_kv = n_heads / n_rep;
  const int q0 = blockIdx.x * kBQ;
  const int qr = q0 + warp * 16 + lane / 4;   // row of c[0..1]; +8: c[2..3]
  const size_t q_base = static_cast<size_t>(bh) * sq * D;
  const size_t kv_base =
      (static_cast<size_t>(b) * n_kv + h / n_rep) * static_cast<size_t>(sk) * D;

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, sq) - 1;   // keys past it are masked
    n_tiles = min(n_tiles, q_last / kBK + 1);
  }

  load_tile_async<D, kBQ, kTcThreads>(qs, q + q_base, q0, sq);
  if (n_tiles > 0) {
    load_tile_async<D, kBK, kTcThreads>(ks, k + kv_base, 0, sk);
    load_tile_async<D, kBK, kTcThreads>(vs, v + kv_base, 0, sk);
  }
  cp_async_commit();

  uint32_t qf[kKSteps][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};            // this lane's columns; quad-summed last
  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      const int nxt = (stage ^ 1) * kBK * D;
      load_tile_async<D, kBK, kTcThreads>(ks + nxt, k + kv_base,
                                          (t + 1) * kBK, sk);
      load_tile_async<D, kBK, kTcThreads>(vs + nxt, v + kv_base,
                                          (t + 1) * kBK, sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldsm_x4(frag_a_addr<D>(qs, warp * 16, kk * 16, lane), qf[kk]);
    }
    const __nv_bfloat16* kt = ks + stage * kBK * D;
    const __nv_bfloat16* vt = vs + stage * kBK * D;

    // s = q k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 4; ++np)
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t bk[4];
        ldsm_x4(frag_bt_addr<D>(kt, np * 16, kk * 16, lane), bk);
        mma(s[2 * np], qf[kk], bk[0], bk[1]);
        mma(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }

    // online softmax on the C fragments: rows qr (e < 2) and qr + 8
    const int k0 = t * kBK;
    const bool edge = (causal && k0 + kBK - 1 > q0) || k0 + kBK > sk;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (edge) {
          const int kj = k0 + 8 * j + 2 * t4 + (e & 1);
          if (causal && qr + 8 * (e >> 1) < kj) x = kNegInf;
          if (kj >= sk) x = -INFINITY;   // no such key: p is exactly 0
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f((m[r] - m_new) * kLog2e);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // out += p v: p's C fragments of key tiles 2kk, 2kk + 1 are the A
    // fragment of the 16-key step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(frag_a_addr<D>(vt, kk * 16, dp * 16, lane), bv);
        mma(acc[2 * dp], pa, bv[0], bv[1]);
        mma(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // the next iteration refills this stage
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qr + 8 * r;
    if (qi >= sq) continue;
    const float li = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = o + q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int n = 0; n < kNd; ++n)
      store_bf16x2(orow + 8 * n + 2 * t4, acc[n][2 * r] / li,
                   acc[n][2 * r + 1] / li);
    if (t4 == 0) lse[static_cast<size_t>(bh) * sq + qi] = m[r] + logf(li);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int n_heads, int n_rep, int sq, int sk,
                int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem_bytes<D>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * n_heads);
  flash_fwd_bf16_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), n_heads, n_rep, sq, sk, causal,
      1.0f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  void* lse, int batch, int n_heads, int n_rep, int sq,
                  int sk, int d, int causal, cudaStream_t stream) {
  // cp.async copies 16-byte chunks of q, k and v
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 16:
      return launch_bf16<16>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                             causal, stream);
    case 32:
      return launch_bf16<32>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                             causal, stream);
    case 64:
      return launch_bf16<64>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
                             causal, stream);
    case 128:
      return launch_bf16<128>(q, k, v, o, lse, batch, n_heads, n_rep, sq, sk,
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
  return is_bf16 ? dispatch_bf16(q, k, v, o, lse, batch, n_heads, n_rep, sq,
                                 sk, d, causal, s)
                 : dispatch<float>(q, k, v, o, lse, batch, n_heads, n_rep, sq,
                                   sk, d, causal, s);
}
