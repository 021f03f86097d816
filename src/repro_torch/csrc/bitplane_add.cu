// Bit-serial ripple-carry add over packed bit-planes: a, b [nbits, W]
// 32-bit words (plane i holds bit i of 32 W lanes, least significant plane
// first) -> sum planes [nbits, W] and the carry-out row [W].
//
// Replaces src/repro/kernels/bitserial_add.py:_add_kernel.  The TPU kernel
// holds all nbits planes of a 2048-word block in VMEM and unrolls the
// full-adder chain at trace time.  Here one thread owns one word column
// (four adjacent columns when the planes allow 128-bit accesses) and walks
// the planes in a runtime loop with the carry in a register, so the carry
// never touches device memory, as it stays in the sub-array on DRIM.  Each
// plane costs 5 integer instructions per word against 12 bytes of traffic,
// so bandwidth bounds the kernel; neighbouring threads read neighbouring
// words of a plane (coalesced), the loop is unrolled so that several
// planes' loads are in flight, and loads and stores carry the streaming
// cache hint.  The vector path needs W % 4 == 0 and every base address
// 16-byte aligned; otherwise the scalar path runs, one column per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void fa(uint32_t a, uint32_t b, uint32_t& carry,
                                   uint32_t& sum) {
  sum = a ^ b ^ carry;
  carry = (a & b) | (a & carry) | (b & carry);
}

__global__ void bitplane_add_vec(const uint4* __restrict__ a,
                                 const uint4* __restrict__ b,
                                 uint4* __restrict__ s, uint4* __restrict__ c,
                                 int nbits, long long w4) {
  const long long col =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= w4) return;
  uint4 carry = make_uint4(0, 0, 0, 0);
#pragma unroll 4
  for (int i = 0; i < nbits; ++i) {
    const long long at = static_cast<long long>(i) * w4 + col;
    const uint4 x = __ldcs(a + at);
    const uint4 y = __ldcs(b + at);
    uint4 z;
    fa(x.x, y.x, carry.x, z.x);
    fa(x.y, y.y, carry.y, z.y);
    fa(x.z, y.z, carry.z, z.z);
    fa(x.w, y.w, carry.w, z.w);
    __stcs(s + at, z);
  }
  __stcs(c + col, carry);
}

__global__ void bitplane_add_scalar(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ s,
                                    uint32_t* __restrict__ c, int nbits,
                                    long long w) {
  const long long col =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= w) return;
  uint32_t carry = 0;
#pragma unroll 4
  for (int i = 0; i < nbits; ++i) {
    const long long at = static_cast<long long>(i) * w + col;
    uint32_t z;
    fa(__ldcs(a + at), __ldcs(b + at), carry, z);
    __stcs(s + at, z);
  }
  __stcs(c + col, carry);
}

constexpr int kThreads = 256;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int bitplane_add(const void* a, const void* b, void* sum,
                            void* carry, int nbits, long long w,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(sum) &&
      aligned16(carry)) {
    const long long w4 = w / 4;
    const long long blocks = (w4 + kThreads - 1) / kThreads;
    bitplane_add_vec<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint4*>(a), static_cast<const uint4*>(b),
        static_cast<uint4*>(sum), static_cast<uint4*>(carry), nbits, w4);
  } else {
    const long long blocks = (w + kThreads - 1) / kThreads;
    bitplane_add_scalar<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
        static_cast<uint32_t*>(sum), static_cast<uint32_t*>(carry), nbits, w);
  }
  return static_cast<int>(cudaGetLastError());
}
