// Sign unpacker: n packed 32-bit words -> 32 n values in {-1, +1} of
// float32, bfloat16 or int8 (bit j of word g gives value 32 g + j: +1 where
// the bit is set).  A [R, W] word array unpacks to [R, 32 W] with the same
// flat order, so the rows need no handling of their own.
//
// Replaces src/repro/kernels/packbits.py:_unpack_kernel.  The TPU kernel
// broadcasts a [256, 32] word block against 32 shifts and writes the
// [256, 1024] result.  The op reads 4 bytes and writes 32 x 1 to 32 x 4
// bytes per word, so the writes bound it.  Here each thread writes one
// 16-byte chunk of the output (4 float32, 8 bfloat16 or 16 int8 values),
// so a warp's store is 512 contiguous bytes; the 2 to 8 threads that share
// a word read it once each through the cache.  A value is built from bit
// patterns (+1 and -1 differ only in the sign bit for the floats), with no
// conversion instruction.  Stores carry the streaming cache hint.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// VALS values of BITS bits each fill one 16-byte chunk; ONE and NEG are the
// bit patterns of +1 and -1.
template <int BITS, uint32_t ONE, uint32_t NEG>
__global__ void unpack_signs_kernel(const uint32_t* __restrict__ p,
                                    uint4* __restrict__ out,
                                    long long n_chunks) {
  constexpr int VALS = 128 / BITS;          // values per chunk
  constexpr int CPW = 32 / VALS;            // chunks per word
  constexpr int PER_LANE = 32 / BITS;       // values per 32-bit lane
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long ch = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       ch < n_chunks; ch += stride) {
    const uint32_t bits = __ldg(p + ch / CPW) >> ((ch % CPW) * VALS);
    uint32_t lane[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      uint32_t v = 0;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const uint32_t bit = (bits >> (l * PER_LANE + j)) & 1u;
        v |= (bit ? ONE : NEG) << (j * BITS);
      }
      lane[l] = v;
    }
    __stcs(out + ch, make_uint4(lane[0], lane[1], lane[2], lane[3]));
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

template <int BITS, uint32_t ONE, uint32_t NEG>
int launch(const void* p, void* out, long long n_words, void* stream) {
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long n_chunks = n_words * (BITS / 4);  // 32 * BITS / 128
  long long blocks = (n_chunks + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  unpack_signs_kernel<BITS, ONE, NEG>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(p), static_cast<uint4*>(out),
          n_chunks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int unpack_signs_f32(const void* p, void* out, long long n_words,
                                void* stream) {
  return launch<32, 0x3F800000u, 0xBF800000u>(p, out, n_words, stream);
}

extern "C" int unpack_signs_bf16(const void* p, void* out, long long n_words,
                                 void* stream) {
  return launch<16, 0x3F80u, 0xBF80u>(p, out, n_words, stream);
}

extern "C" int unpack_signs_i8(const void* p, void* out, long long n_words,
                               void* stream) {
  return launch<8, 0x01u, 0xFFu>(p, out, n_words, stream);
}
