// Bulk bit-wise ops on packed 32-bit words: NOT, the six two-input ops
// (xnor, xor, and, or, nand, nor) and the three-input ones (maj3, min3 and
// the full adder `fa`, which writes the sum a^b^c and the carry maj3).
// Operands and results are flat word arrays of one length n; any tensor
// shape is flattened by the caller.
//
// Replaces src/repro/kernels/bitwise.py:_not_kernel, _binary_kernel and
// _ternary_kernel.  The TPU kernels pad the operands to 8 x 1024 blocks and
// apply the op to one block per grid step.  Each output word costs a few
// integer instructions against 8 to 20 bytes of device-memory traffic, so
// bandwidth bounds all three; the design streams every word exactly once
// with 128-bit accesses and no padding copy:
//   * alignment is anchored on the output: a scalar head of up to three
//     words brings out[] to a 16-byte boundary, a vector body moves four
//     words per thread and access, a scalar tail finishes the last words;
//   * an input whose address shares the output's 16-byte phase is read
//     with 128-bit loads, any other input with four 32-bit loads (the
//     wrapper allocates the output in the first operand's phase, so a
//     sliced operand still streams with vectors);
//   * loads and stores carry the streaming cache hint (evict first): the
//     data is touched once.
// The op is a template parameter, so each instance is one straight-line
// pass with no branch on the op.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op {
  kNot = 0, kXnor = 1, kXor = 2, kAnd = 3, kOr = 4, kNand = 5, kNor = 6,
  kMaj3 = 7, kMin3 = 8, kFa = 9
};

struct Ptrs {
  const uint32_t* in[3];
  uint32_t* out[2];
};

template <int OP>
__device__ __forceinline__ void apply(uint32_t a, uint32_t b, uint32_t c,
                                      uint32_t& o0, uint32_t& o1) {
  const uint32_t maj = (a & b) | (a & c) | (b & c);
  switch (OP) {
    case kNot: o0 = ~a; break;
    case kXnor: o0 = ~(a ^ b); break;
    case kXor: o0 = a ^ b; break;
    case kAnd: o0 = a & b; break;
    case kOr: o0 = a | b; break;
    case kNand: o0 = ~(a & b); break;
    case kNor: o0 = ~(a | b); break;
    case kMaj3: o0 = maj; break;
    case kMin3: o0 = ~maj; break;
    case kFa: o0 = a ^ b ^ c; o1 = maj; break;
  }
}

__device__ __forceinline__ uint4 load4(const uint32_t* p, bool vec) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  return make_uint4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3));
}

// One word at index i, for the scalar head and tail.
template <int OP, int NIN, int NOUT>
__device__ __forceinline__ void one_word(const Ptrs& p, long long i) {
  const uint32_t a = __ldcs(p.in[0] + i);
  const uint32_t b = NIN > 1 ? __ldcs(p.in[1] + i) : 0u;
  const uint32_t c = NIN > 2 ? __ldcs(p.in[2] + i) : 0u;
  uint32_t o0 = 0, o1 = 0;
  apply<OP>(a, b, c, o0, o1);
  __stcs(p.out[0] + i, o0);
  if (NOUT > 1) __stcs(p.out[1] + i, o1);
}

// The shared streaming pass.  head: scalar words before out[0] reaches a
// 16-byte boundary; vec_mask bit k: input k shares that phase.
template <int OP, int NIN, int NOUT>
__device__ __forceinline__ void stream(const Ptrs& p, long long n, int head,
                                       unsigned vec_mask) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n_vec = (n - head) >> 2;
  const long long body_end = head + (n_vec << 2);
  if (tid < head) one_word<OP, NIN, NOUT>(p, tid);
  if (tid < n - body_end) one_word<OP, NIN, NOUT>(p, body_end + tid);
  const bool v0 = vec_mask & 1u, v1 = vec_mask & 2u, v2 = vec_mask & 4u;
  for (long long v = tid; v < n_vec; v += stride) {
    const long long i = head + (v << 2);
    const uint4 a = load4(p.in[0] + i, v0);
    const uint4 b = NIN > 1 ? load4(p.in[1] + i, v1) : make_uint4(0, 0, 0, 0);
    const uint4 c = NIN > 2 ? load4(p.in[2] + i, v2) : make_uint4(0, 0, 0, 0);
    uint4 o0, o1;
    apply<OP>(a.x, b.x, c.x, o0.x, o1.x);
    apply<OP>(a.y, b.y, c.y, o0.y, o1.y);
    apply<OP>(a.z, b.z, c.z, o0.z, o1.z);
    apply<OP>(a.w, b.w, c.w, o0.w, o1.w);
    __stcs(reinterpret_cast<uint4*>(p.out[0] + i), o0);
    if (NOUT > 1) __stcs(reinterpret_cast<uint4*>(p.out[1] + i), o1);
  }
}

__global__ void bitwise_not_kernel(Ptrs p, long long n, int head,
                                   unsigned vec_mask) {
  stream<kNot, 1, 1>(p, n, head, vec_mask);
}

template <int OP>
__global__ void bitwise_binary_kernel(Ptrs p, long long n, int head,
                                      unsigned vec_mask) {
  stream<OP, 2, 1>(p, n, head, vec_mask);
}

template <int OP>
__global__ void bitwise_ternary_kernel(Ptrs p, long long n, int head,
                                       unsigned vec_mask) {
  stream<OP, 3, OP == kFa ? 2 : 1>(p, n, head, vec_mask);
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 65535;

typedef void (*KernelFn)(Ptrs, long long, int, unsigned);

int launch(KernelFn fn, int n_in, const void* const* in, void* const* out,
           int n_out, long long n, void* stream_ptr) {
  Ptrs p = {};
  for (int k = 0; k < n_in; ++k) p.in[k] = static_cast<const uint32_t*>(in[k]);
  for (int k = 0; k < n_out; ++k) p.out[k] = static_cast<uint32_t*>(out[k]);
  const uintptr_t phase = reinterpret_cast<uintptr_t>(p.out[0]) & 15u;
  if (phase & 3u) return static_cast<int>(cudaErrorMisalignedAddress);
  for (int k = 1; k < n_out; ++k)
    if ((reinterpret_cast<uintptr_t>(p.out[k]) & 15u) != phase)
      return static_cast<int>(cudaErrorMisalignedAddress);
  long long head = static_cast<long long>((16u - phase) & 15u) >> 2;
  if (head > n) head = n;
  unsigned vec_mask = 0;
  for (int k = 0; k < n_in; ++k)
    if ((reinterpret_cast<uintptr_t>(p.in[k]) & 15u) == phase)
      vec_mask |= 1u << k;
  const long long n_vec = (n - head) >> 2;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;  // the head and tail need one block
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fn<<<static_cast<unsigned>(blocks), kThreads, 0,
       static_cast<cudaStream_t>(stream_ptr)>>>(p, n, static_cast<int>(head),
                                                vec_mask);
  return static_cast<int>(cudaGetLastError());
}

KernelFn binary_fn(int op) {
  switch (op) {
    case kXnor: return bitwise_binary_kernel<kXnor>;
    case kXor: return bitwise_binary_kernel<kXor>;
    case kAnd: return bitwise_binary_kernel<kAnd>;
    case kOr: return bitwise_binary_kernel<kOr>;
    case kNand: return bitwise_binary_kernel<kNand>;
    case kNor: return bitwise_binary_kernel<kNor>;
  }
  return nullptr;
}

KernelFn ternary_fn(int op) {
  switch (op) {
    case kMaj3: return bitwise_ternary_kernel<kMaj3>;
    case kMin3: return bitwise_ternary_kernel<kMin3>;
    case kFa: return bitwise_ternary_kernel<kFa>;
  }
  return nullptr;
}

}  // namespace

extern "C" int bitwise_not(const void* a, void* out, long long n,
                           void* stream) {
  const void* in[1] = {a};
  void* outs[1] = {out};
  return launch(bitwise_not_kernel, 1, in, outs, 1, n, stream);
}

extern "C" int bitwise_binary(int op, const void* a, const void* b, void* out,
                              long long n, void* stream) {
  KernelFn fn = binary_fn(op);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[2] = {a, b};
  void* outs[1] = {out};
  return launch(fn, 2, in, outs, 1, n, stream);
}

extern "C" int bitwise_ternary(int op, const void* a, const void* b,
                               const void* c, void* out, void* out2,
                               long long n, void* stream) {
  KernelFn fn = ternary_fn(op);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const void* in[3] = {a, b, c};
  void* outs[2] = {out, out2};
  return launch(fn, 3, in, outs, op == kFa ? 2 : 1, n, stream);
}
