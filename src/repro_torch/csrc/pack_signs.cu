// Sign packer: [R, K] float32 / bfloat16 -> [R, ceil(K/32)] 32-bit words,
// bit j of word w set where x[r, 32w + j] >= 0 (little-endian; bits past K
// are 0; NaN packs to 0, -0.0 to 1).
//
// Replaces src/repro/kernels/packbits.py:_pack_kernel.  The TPU kernel
// widens a [256, 1024] block to uint32, multiplies by the bit weights and
// sums each 32-lane group.  Here one warp owns one output word: lane j
// loads element 32w + j (one coalesced 128-byte read for f32) and
// __ballot_sync assembles the word in one instruction.  The op reads each
// input once and writes 1/32 of it back, so device-memory bandwidth bounds
// it; the design issues fully coalesced reads and nothing else.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_val(const float* x, size_t i) {
  return __ldg(x + i);
}

__device__ __forceinline__ float load_val(const uint16_t* x, size_t i) {
  // bfloat16 is the high half of a float32 with the same sign and exponent.
  return __uint_as_float(static_cast<uint32_t>(__ldg(x + i)) << 16);
}

template <typename T>
__global__ void pack_signs_kernel(const T* __restrict__ x,
                                  uint32_t* __restrict__ out,
                                  int rows, int k, int words) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  // warp is uniform across the warp, so whole warps leave together and the
  // full-mask ballot below always has all 32 lanes present.
  if (warp >= static_cast<long long>(rows) * words) return;
  const int r = static_cast<int>(warp / words);
  const int w = static_cast<int>(warp % words);
  const int col = w * 32 + lane;
  bool bit = false;
  if (col < k) bit = load_val(x, static_cast<size_t>(r) * k + col) >= 0.0f;
  const uint32_t word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[warp] = word;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const T* x, uint32_t* out, int rows, int k, int words,
           cudaStream_t stream) {
  const long long n_words = static_cast<long long>(rows) * words;
  const long long blocks = (n_words * 32 + kThreads - 1) / kThreads;
  pack_signs_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(x, out, rows, k, words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pack_signs_f32(const void* x, void* out, int rows, int k,
                              int words, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<uint32_t*>(out),
                rows, k, words, static_cast<cudaStream_t>(stream));
}

extern "C" int pack_signs_bf16(const void* x, void* out, int rows, int k,
                               int words, void* stream) {
  return launch(static_cast<const uint16_t*>(x), static_cast<uint32_t*>(out),
                rows, k, words, static_cast<cudaStream_t>(stream));
}
