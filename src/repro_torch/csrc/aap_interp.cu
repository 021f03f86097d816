// AAP bit-plane interpreter: replays the [n_ins, 19] micro-op table of
// repro_torch.core.isa.encode_kernel_stream over every word column of every
// wave of a staged payload.
//
// Replaces src/repro/kernels/aap_interpreter.py:_interp_kernel.  The TPU
// kernel keeps a [n_state, 4096] block of row planes in VMEM and steps a
// program counter over it.  The stream is the same for every word column,
// and columns never exchange data, so here one thread owns one column for
// the whole program.  A column's state is n_state words (267 for the K=128
// serving kernel, about 510 at the 500-row budget): too many for
// registers, so it lives in dynamic shared memory, laid out
// state[row * C + t] so that a warp's 32 threads touch 32 banks on every
// access.  C, the columns per block, is chosen by the caller so that
// 4 * n_state * C fits the 227 KB a block may hold.  Every instruction is a
// uniform read of 19 ints through the read-only path (a broadcast to the
// whole block), three state reads and up to four state writes.
//
// What bounds it: device memory sees each staged row once (n_in words in,
// n_out words out per column), but the replay itself costs about 7
// shared-memory accesses per instruction per column, so shared-memory
// bandwidth and latency bound it well before device memory does.  All
// waves run in one launch (blockIdx.y is the wave), each block starting
// from a zeroed state, as a fresh sub-array would.
//
// Semantics kept bit-exact with the reference: reads resolve before
// writes; DCC rows are read and written through the complemented BL-bar
// when the slot's flag says so; the enabled write slots replay in argument
// order, so a later slot to the same row wins; output slots may be
// complemented.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 19;

__device__ __forceinline__ uint32_t negmask(int flag) {
  return flag ? 0xffffffffu : 0u;
}

__global__ void aap_interp_kernel(const int32_t* __restrict__ stream,
                                  int n_ins,
                                  const uint32_t* __restrict__ tiles,
                                  int n_in,
                                  const int32_t* __restrict__ out_slots,
                                  int n_out, uint32_t* __restrict__ out,
                                  int n_state, long long cols) {
  extern __shared__ uint32_t state[];
  const int c = blockDim.x;
  const int t = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * c + t;
  const long long wave = blockIdx.y;
  // Columns are independent and no barrier is used, so a thread past the
  // ragged tail simply leaves.
  if (col >= cols) return;

  const uint32_t* in = tiles + wave * n_in * cols + col;
  for (int r = 0; r < n_in; ++r) state[r * c + t] = in[r * cols];
  for (int r = n_in; r < n_state; ++r) state[r * c + t] = 0u;

  for (int i = 0; i < n_ins; ++i) {
    const int32_t* ins = stream + static_cast<size_t>(i) * kCols;
    const int kind = __ldg(ins);
    const uint32_t a = state[__ldg(ins + 1) * c + t] ^ negmask(__ldg(ins + 2));
    const uint32_t b = state[__ldg(ins + 3) * c + t] ^ negmask(__ldg(ins + 4));
    const uint32_t d = state[__ldg(ins + 5) * c + t] ^ negmask(__ldg(ins + 6));
    uint32_t bl;
    if (kind == 0) {
      bl = a;                                   // COPY / COPY2
    } else if (kind == 1) {
      bl = ~(a ^ b);                            // DRA: BL = XNOR
    } else {
      bl = (a & b) | (a & d) | (b & d);         // TRA: MAJ3
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {               // write slots, in arg order
      const int32_t* slot = ins + 7 + 3 * k;
      if (__ldg(slot + 2)) state[__ldg(slot) * c + t] = bl ^ negmask(__ldg(slot + 1));
    }
  }

  uint32_t* dst = out + wave * n_out * cols + col;
  for (int j = 0; j < n_out; ++j)
    dst[j * cols] = state[__ldg(out_slots + 2 * j) * c + t] ^
                    negmask(__ldg(out_slots + 2 * j + 1));
}

}  // namespace

extern "C" int aap_interp(const void* stream, int n_ins, const void* tiles,
                          int n_in, const void* out_slots, int n_out,
                          void* out, int n_state, long long cols, int waves,
                          int block_cols, void* cuda_stream) {
  const size_t smem = static_cast<size_t>(n_state) * block_cols * 4;
  cudaError_t err = cudaFuncSetAttribute(
      aap_interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((cols + block_cols - 1) / block_cols),
                  static_cast<unsigned>(waves));
  aap_interp_kernel<<<grid, block_cols, smem,
                      static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(stream), n_ins,
      static_cast<const uint32_t*>(tiles), n_in,
      static_cast<const int32_t*>(out_slots), n_out,
      static_cast<uint32_t*>(out), n_state, cols);
  return static_cast<int>(cudaGetLastError());
}
