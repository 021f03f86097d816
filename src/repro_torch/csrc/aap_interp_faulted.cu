// Fault-injecting AAP bit-plane interpreter: the replay of aap_interp.cu
// plus Table-3 fault injection, for repro_torch.kernels.aap_interpreter.
//
// Replaces src/repro/kernels/aap_interpreter.py:_interp_kernel_faulted.
// The TPU kernel is _interp_kernel with three more inputs, all data:
// per-instruction failure thresholds [n_ins] (0 for copies and protected
// ops), per-column metadata [2, cols] (the slot hash mix32(slot ^ seed)
// and the word id within the row) and the stuck rows.  Here, as in
// aap_interp.cu, one thread owns one word column for the whole program,
// with the column's state in dynamic shared memory, state[row * C + t],
// and all waves run in one launch (blockIdx.y is the wave).  On top of
// that replay:
//   - each DRA/TRA whose threshold is nonzero draws the counter-based
//     hash of repro_torch.core.faults.fault_mask: x = mix32(slot_h ^
//     i * 0x9E3779B9); the op fails in this slot when x < thresh, and then
//     bit pos = mix32(x ^ 0x85EBCA6B) % n_positions of the row flips, in
//     the column whose word id is pos / 32.  The flip is XORed into the
//     bit-line value before the write-back, so every word-line the AAP
//     writes sees it.  uint32_t arithmetic wraps as the hash requires.
//   - stuck rows (state row, bit) are pinned after the load and after
//     every instruction.
// The threshold is uniform across the block, so the hash branch never
// diverges; a wave draws the same flips as every other wave, since the
// hash has no wave index.
//
// What bounds it: as aap_interp.cu, the shared-memory replay (about seven
// shared accesses per instruction per column); the hash adds about 12
// integer operations per DRA/TRA per column, all in registers.  Two known
// costs are left for later: the 8 columns of one sub-array compute the
// same hash, and the stream is read per instruction by uniform loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 19;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kPosSalt = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t negmask(int flag) {
  return flag ? 0xffffffffu : 0u;
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ void pin_stuck(uint32_t* state, int c, int t,
                                          const int32_t* __restrict__ stuck,
                                          int n_stuck, int n_state) {
  for (int j = 0; j < n_stuck; ++j) {
    const int row = __ldg(stuck + 2 * j);
    if (row >= 0 && row < n_state)
      state[row * c + t] = negmask(__ldg(stuck + 2 * j + 1));
  }
}

__global__ void aap_interp_faulted_kernel(
    const int32_t* __restrict__ stream, int n_ins,
    const uint32_t* __restrict__ thresh, const uint32_t* __restrict__ meta,
    const uint32_t* __restrict__ tiles, int n_in,
    const int32_t* __restrict__ out_slots, int n_out,
    const int32_t* __restrict__ stuck, int n_stuck, uint32_t n_positions,
    uint32_t* __restrict__ out, int n_state, long long cols) {
  extern __shared__ uint32_t state[];
  const int c = blockDim.x;
  const int t = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * c + t;
  const long long wave = blockIdx.y;
  // Columns are independent and no barrier is used, so a thread past the
  // ragged tail simply leaves.
  if (col >= cols) return;

  const uint32_t slot_h = meta[col];
  const uint32_t word_id = meta[cols + col];
  const uint32_t* in = tiles + wave * n_in * cols + col;
  for (int r = 0; r < n_in; ++r) state[r * c + t] = in[r * cols];
  for (int r = n_in; r < n_state; ++r) state[r * c + t] = 0u;
  pin_stuck(state, c, t, stuck, n_stuck, n_state);

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
    const uint32_t th = __ldg(thresh + i);
    if (th != 0u) {
      const uint32_t x = mix32(slot_h ^ (static_cast<uint32_t>(i) * kGolden));
      if (x < th) {
        const uint32_t pos = mix32(x ^ kPosSalt) % n_positions;
        if ((pos >> 5) == word_id) bl ^= 1u << (pos & 31u);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {               // write slots, in arg order
      const int32_t* slot = ins + 7 + 3 * k;
      if (__ldg(slot + 2)) state[__ldg(slot) * c + t] = bl ^ negmask(__ldg(slot + 1));
    }
    pin_stuck(state, c, t, stuck, n_stuck, n_state);
  }

  uint32_t* dst = out + wave * n_out * cols + col;
  for (int j = 0; j < n_out; ++j)
    dst[j * cols] = state[__ldg(out_slots + 2 * j) * c + t] ^
                    negmask(__ldg(out_slots + 2 * j + 1));
}

}  // namespace

extern "C" int aap_interp_faulted(const void* stream, int n_ins,
                                  const void* thresh, const void* meta,
                                  const void* tiles, int n_in,
                                  const void* out_slots, int n_out,
                                  const void* stuck, int n_stuck,
                                  int n_positions, void* out, int n_state,
                                  long long cols, int waves, int block_cols,
                                  void* cuda_stream) {
  const size_t smem = static_cast<size_t>(n_state) * block_cols * 4;
  cudaError_t err = cudaFuncSetAttribute(
      aap_interp_faulted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((cols + block_cols - 1) / block_cols),
                  static_cast<unsigned>(waves));
  aap_interp_faulted_kernel<<<grid, block_cols, smem,
                              static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<const int32_t*>(stream), n_ins,
      static_cast<const uint32_t*>(thresh),
      static_cast<const uint32_t*>(meta),
      static_cast<const uint32_t*>(tiles), n_in,
      static_cast<const int32_t*>(out_slots), n_out,
      static_cast<const int32_t*>(stuck), n_stuck,
      static_cast<uint32_t>(n_positions), static_cast<uint32_t*>(out),
      n_state, cols);
  return static_cast<int>(cudaGetLastError());
}
