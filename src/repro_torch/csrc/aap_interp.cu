// AAP bit-plane interpreter: replays a packed AAP stream
// (repro_torch.kernels.aap_interpreter.pack_stream of the [n_ins, 19]
// micro-op table of repro_torch.core.isa.encode_kernel_stream) over every
// word column of every wave of a staged payload, fault-free or with the
// Table-3 fault injection.
//
// Replaces src/repro/kernels/aap_interpreter.py:_interp_kernel (the
// instantiation kFaulted = false) and _interp_kernel_faulted (kFaulted =
// true, described at the end of this note).  The TPU
// kernel keeps a [n_state, 4096] block of row planes in VMEM and steps a
// program counter over it.  The stream is the same for every word column,
// and columns never exchange data, so here one thread owns W = 1, 2 or 4
// neighbouring word columns of one wave for the whole program.
//
// What bounds it: device memory sees each staged row once, so the HBM
// bound is far below the replay's cost: a chain of dependent shared-memory
// reads and writes per instruction (state rows are indexed by the stream,
// so they cannot live in registers).  The design cuts what each
// instruction pays and keeps the SMs full:
//  - One 16-byte word per instruction (three read slots, four write slots,
//    their complement bits, the kind, and the number of staged-row copies
//    to issue), read two instructions ahead by one uniform 128-bit load
//    from 256-word chunks double-buffered in shared memory by cp.async.
//    (Read through the read-only path instead, with an earlier loop, the
//    K=128 serving stream over a full DRIM-R wave took 0.209 ms on an
//    H100 against 0.151 from shared memory.)
//  - No branch per instruction: every word reads three slots and writes
//    four, and BL is MAJ3 or XNOR by a mask of the kind.  The pass encodes
//    a COPY as XNOR(a, ~0), points unused reads at slot 0 and unused or
//    dead writes at slot 1, a sink no instruction reads.  The loop is
//    unrolled twice, so the two-ahead words rotate without moves.
//  - Shared memory holds only live rows: the host pass maps each row
//    version (a write, or a staged row's initial value) to a slot for its
//    live range, so the slot count, not n_state, sets the footprint.
//    Slot s of thread t is state[(t * S + s) * W], S the slot count
//    rounded up to odd, W words as one 32-, 64- or 128-bit access: one
//    shift-add from the slot field, and the odd S keeps the threads of a
//    quarter warp on distinct banks.  Slot 0 holds zeros: rows read before
//    any write and not staged read it, as the reference's zeroed state
//    gives.
//  - Staged operand rows are not preloaded: each is copied from the tiles
//    by cp.async kLookahead instructions before its first read (the first
//    ones before the loop).  Every instruction commits one cp.async group
//    (empty or not) and waits for all but the newest kLookahead, so a
//    copy has landed when its row is read.
//  - The decode is paid once per W words, and the caller sizes the block
//    from the slot count and the SM count so the grid fills the card.
// All waves run in one launch (blockIdx.y is the wave), each block starting
// from slot 0 alone: every other slot is written before it is read.  What
// bounds it now (PERF.md): at the decode shape one warp a scheduler
// replays ~1,000 AAPs, each a decode and seven dependent shared-memory
// accesses, a few hundred cycles an AAP; with more warps (more waves, or
// fewer words a thread) the issue slots and the shared-memory pipe fill
// instead.
//
// Semantics kept bit-exact with the reference: reads resolve before
// writes; DCC rows are read and written through the complemented BL-bar
// when the slot's flag says so; the write slots replay in argument order
// (the pass sends a slot that a later one to the same row overwrites to
// the sink); output slots may be complemented, and an output that is a
// staged row never written is read from the tiles.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// LOOKAHEAD and STREAM_CHUNK in kernels/aap_interpreter.py, which packs
// the stream for them (tests/test_torch_kernels.py holds them equal)
constexpr int kLookahead = 16;
constexpr int kChunk = 256;      // words per shared chunk

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (4, 8 or 16) global -> shared; src_bytes 0 writes zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W neighbouring words of one row
template <int W>
struct Row {
  uint32_t w[W];
};

template <int W>
__device__ __forceinline__ Row<W> load_row(const uint32_t* p) {
  Row<W> r;
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
    r.w[0] = *p;
  }
  return r;
}

template <int W>
__device__ __forceinline__ Row<W> ldg_row(const uint32_t* p) {
  Row<W> r;
  if constexpr (W == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = v.x, r.w[1] = v.y, r.w[2] = v.z, r.w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = v.x, r.w[1] = v.y;
  } else {
    r.w[0] = __ldg(p);
  }
  return r;
}

// r ^ neg to p
template <int W>
__device__ __forceinline__ void store_row(uint32_t* p, const Row<W>& r,
                                          uint32_t neg) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(r.w[0] ^ neg, r.w[1] ^ neg, r.w[2] ^ neg, r.w[3] ^ neg);
  } else if constexpr (W == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0] ^ neg, r.w[1] ^ neg);
  } else {
    *p = r.w[0] ^ neg;
  }
}

constexpr uint32_t kPosSalt = 0x85EBCA6Bu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// all ones where bit B of f is set (two shifts)
template <int B>
__device__ __forceinline__ uint32_t negmask(uint32_t f) {
  return static_cast<uint32_t>(static_cast<int32_t>(f << (31 - B)) >> 31);
}


template <int W, bool kFaulted>
__global__ void aap_interp_kernel(const uint4* __restrict__ words, int n_ins,
                                  const uint32_t* __restrict__ loads,
                                  int n_pre,
                                  const uint32_t* __restrict__ tiles,
                                  int n_in,
                                  const int32_t* __restrict__ out_map,
                                  int n_out, uint32_t* __restrict__ out,
                                  int n_slots, long long cols,
                                  const uint2* __restrict__ fault,
                                  const uint32_t* __restrict__ meta,
                                  uint32_t n_positions) {
  extern __shared__ uint4 smem[];
  uint4* chunks = smem;                        // [2][kChunk]
  // kFaulted: [2][kChunk] (threshold, i * golden) beside the words
  uint2* fchunks = reinterpret_cast<uint2*>(smem + 2 * kChunk);
  uint32_t* state = reinterpret_cast<uint32_t*>(
      smem + 2 * kChunk + (kFaulted ? kChunk : 0));
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  // thread t's slots, W words each, an odd number of slots apart
  uint32_t* mine = state + t * (n_slots | 1) * W;
  auto slot = [&](uint32_t s) { return mine + s * W; };
  const long long col = (static_cast<long long>(blockIdx.x) * nt + t) * W;
  // cols % W == 0: whole rows.  A thread past the ragged tail stays for
  // the chunk copies and barriers, its row copies zero-filled.
  const bool live = col < cols;
  const uint32_t* src = tiles +
                        static_cast<long long>(blockIdx.y) * n_in * cols +
                        (live ? col : 0);
  const int row_bytes = live ? 4 * W : 0;

  auto copy_row = [&](uint32_t e) {            // tile row | slot << 16
    cp_async<4 * W>(smem_u32(slot(e >> 16)),
                    src + static_cast<long long>(e & 0xffffu) * cols,
                    row_bytes);
  };
  auto copy_chunk = [&](int c) {               // words of chunk c
    for (int e = t; e < kChunk; e += nt) {
      const int at = c * kChunk + e;
      const bool in = at < n_ins + 2;
      cp_async<16>(smem_u32(chunks + (c & 1) * kChunk + e),
                   words + (in ? at : 0), in ? 16 : 0);
      if constexpr (kFaulted)
        cp_async<8>(smem_u32(fchunks + (c & 1) * kChunk + e),
                    fault + (in ? at : 0), in ? 8 : 0);
    }
  };

  // kFaulted: this thread's slot hash and first word id, and whether its
  // W words share them (one draw per instruction) or straddle sub-arrays
  uint32_t slot_h = 0u, word0 = 0u;
  bool one_draw = true;
  if constexpr (kFaulted) {
    if (live) {
      slot_h = __ldg(meta + col);
      word0 = __ldg(meta + cols + col);
#pragma unroll
      for (int k = 1; k < W; ++k)
        one_draw = one_draw && __ldg(meta + col + k) == slot_h &&
                   __ldg(meta + cols + col + k) == word0 + k;
    }
  }

  const Row<W> zero{};
  store_row<W>(slot(0), zero, 0u);
  copy_chunk(0);
  copy_chunk(1);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint4 cur = chunks[0], nxt = chunks[1];
  uint2 fcur = make_uint2(0u, 0u), fnxt = fcur;
  if constexpr (kFaulted) fcur = fchunks[0], fnxt = fchunks[1];
  for (int p = 0; p < n_pre; ++p) copy_row(__ldg(loads + p));
  cp_async_commit();
#pragma unroll
  for (int g = 1; g < kLookahead; ++g) cp_async_commit();

  const uint32_t* lp = loads + n_pre;
  uint32_t next_load = __ldg(lp);
#pragma unroll 2
  for (int i = 0; i < n_ins; ++i) {
    const uint32_t f = cur.w >> 16;
    for (uint32_t n = (f >> 9) & 3u; n > 0; --n) {
      copy_row(next_load);
      next_load = __ldg(++lp);
    }
    cp_async_commit();
    cp_async_wait<kLookahead>();
    if (i % kChunk == kChunk - 2) {
      // every thread's share of chunk i / kChunk + 1 has landed (its copy
      // is most of a chunk of groups old), and every thread has read the
      // last word of chunk i / kChunk (two instructions ahead): refill
      // that chunk's buffer with chunk i / kChunk + 2
      __syncthreads();
      copy_chunk(i / kChunk + 2);
    }
    const int at = ((i + 2) / kChunk & 1) * kChunk + (i + 2) % kChunk;
    const uint4 after = chunks[at];            // the word of i + 2
    uint2 fafter = make_uint2(0u, 0u);
    if constexpr (kFaulted) fafter = fchunks[at];

    // no branch on the kind: BL = MAJ3(a, b, c) where the kind is 2, else
    // XNOR(a, b) (a COPY reads b as slot 0 complemented)
    const Row<W> a = load_row<W>(slot(cur.x & 0xffffu));
    const Row<W> b = load_row<W>(slot(cur.x >> 16));
    const Row<W> c = load_row<W>(slot(cur.y & 0xffffu));
    const uint32_t na = negmask<2>(f), nb = negmask<3>(f), nc = negmask<4>(f);
    const uint32_t tra = negmask<1>(f);
    Row<W> bl;
#pragma unroll
    for (int k = 0; k < W; ++k) {
      const uint32_t x = a.w[k] ^ na, y = b.w[k] ^ nb, z = c.w[k] ^ nc;
      const uint32_t maj = (x & y) | (x & z) | (y & z);
      bl.w[k] = (maj & tra) | (~(x ^ y) & ~tra);
    }
    if constexpr (kFaulted) {
      // the draw inline, for armed instructions only (drawing it for every
      // instruction two ahead, off the chain of shared-memory accesses, was
      // slower on an H100: 4.13 against 3.77 ms, the TMR stream over 4
      // waves)
      const uint32_t th = fcur.x;
      if (th != 0u) {
        if (one_draw) {
          const uint32_t x = mix32(slot_h ^ fcur.y);
          if (x < th) {
            const uint32_t pos = mix32(x ^ kPosSalt) % n_positions;
            const uint32_t d = (pos >> 5) - word0;
#pragma unroll
            for (int k = 0; k < W; ++k)
              if (d == static_cast<uint32_t>(k)) bl.w[k] ^= 1u << (pos & 31u);
          }
        } else {                              // words straddle sub-arrays
#pragma unroll
          for (int k = 0; k < W; ++k) {
            const uint32_t x = mix32(__ldg(meta + col + k) ^ fcur.y);
            if (x < th) {
              const uint32_t pos = mix32(x ^ kPosSalt) % n_positions;
              if ((pos >> 5) == __ldg(meta + cols + col + k))
                bl.w[k] ^= 1u << (pos & 31u);
            }
          }
        }
      }
    }
    // the four write slots in argument order; an unused one writes slot 1
    store_row<W>(slot(cur.y >> 16), bl, negmask<5>(f));
    store_row<W>(slot(cur.z & 0xffffu), bl, negmask<6>(f));
    store_row<W>(slot(cur.z >> 16), bl, negmask<7>(f));
    store_row<W>(slot(cur.w & 0xffffu), bl, negmask<8>(f));
    cur = nxt;
    nxt = after;
    if constexpr (kFaulted) fcur = fnxt, fnxt = fafter;
  }
  cp_async_wait<0>();
  if (!live) return;

  uint32_t* dst = out + static_cast<long long>(blockIdx.y) * n_out * cols + col;
  for (int j = 0; j < n_out; ++j) {
    const int code = __ldg(out_map + 2 * j);
    const Row<W> v =
        code >= 0 ? load_row<W>(slot(code))
                  : ldg_row<W>(src + static_cast<long long>(-1 - code) * cols);
    store_row<W>(dst + static_cast<long long>(j) * cols, v,
                 0u - static_cast<uint32_t>(__ldg(out_map + 2 * j + 1)));
  }
}

struct Args {
  const void *words, *loads, *tiles, *out_map;
  void* out;
  int n_ins, n_pre, n_in, n_out, n_slots;
  long long cols;
  int waves, threads, smem;
  cudaStream_t stream;
  const void *fault, *meta;                   // kFaulted only
  int n_positions;
};

template <int W, bool kFaulted>
int launch(const Args& a) {
  static int smem_set = 0;                    // the attribute is per kernel
  if (a.smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        aap_interp_kernel<W, kFaulted>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = a.smem;
  }
  const long long threads = a.cols / W;
  const dim3 grid(static_cast<unsigned>((threads + a.threads - 1) / a.threads),
                  static_cast<unsigned>(a.waves));
  aap_interp_kernel<W, kFaulted><<<grid, a.threads, a.smem, a.stream>>>(
      static_cast<const uint4*>(a.words), a.n_ins,
      static_cast<const uint32_t*>(a.loads), a.n_pre,
      static_cast<const uint32_t*>(a.tiles), a.n_in,
      static_cast<const int32_t*>(a.out_map), a.n_out,
      static_cast<uint32_t*>(a.out), a.n_slots, a.cols,
      static_cast<const uint2*>(a.fault),
      static_cast<const uint32_t*>(a.meta),
      static_cast<uint32_t>(a.n_positions));
  return static_cast<int>(cudaGetLastError());
}

// the checks both entry points make; 0 when the launch may go ahead
int check_args(const Args& a, int w, int chunk_bytes) {
  const long long need =
      2LL * kChunk * chunk_bytes +
      static_cast<long long>(a.n_slots | 1) * 4 * w * a.threads;
  if ((w != 1 && w != 2 && w != 4) ||
      a.cols % w != 0 || a.threads <= 0 || a.threads % 32 != 0 ||
      a.smem < need || a.n_slots < 1 || a.n_slots > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a.tiles) |
       reinterpret_cast<uintptr_t>(a.out)) % (4 * w) ||
      reinterpret_cast<uintptr_t>(a.words) % 16 ||
      reinterpret_cast<uintptr_t>(a.fault) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

template <bool kFaulted>
int dispatch(const Args& a, int w) {
  const int err = check_args(a, w, kFaulted ? 16 + 8 : 16);
  if (err) return err;
  switch (w) {
    case 4: return launch<4, kFaulted>(a);
    case 2: return launch<2, kFaulted>(a);
    default: return launch<1, kFaulted>(a);
  }
}

}  // namespace

// words [n_ins + 2, 4], loads [n_loads + 4] and out_map [n_out, 2] as
// pack_stream gives them; tiles [waves, n_in, cols] and out [waves, n_out,
// cols] uint32.  words_per_thread W must divide cols, and tiles and out
// must be 4 W-byte aligned; smem_bytes covers the two chunks and n_slots
// slots (rounded up to odd) of block_threads threads.
extern "C" int aap_interp(const void* words, int n_ins, const void* loads,
                          int n_pre, const void* tiles, int n_in,
                          const void* out_map, int n_out, void* out,
                          int n_slots, long long cols, int waves,
                          int words_per_thread, int block_threads,
                          int smem_bytes, void* cuda_stream) {
  const Args a{words, loads, tiles, out_map, out, n_ins, n_pre, n_in, n_out,
               n_slots, cols, waves, block_threads, smem_bytes,
               static_cast<cudaStream_t>(cuda_stream), nullptr, nullptr, 0};
  return dispatch<false>(a, words_per_thread);
}

// aap_interp with fault injection: the stream packed with the stuck rows
// folded in, fault [n_ins + 2] (threshold, i * 0x9E3779B9) per packed
// word, meta [2, cols] (slot hash, word id) per column, n_positions the
// row width in bits; smem_bytes also covers the two fault chunks.
extern "C" int aap_interp_faulted(const void* words, const void* fault,
                                  int n_ins, const void* loads, int n_pre,
                                  const void* tiles, int n_in,
                                  const void* meta, int n_positions,
                                  const void* out_map, int n_out, void* out,
                                  int n_slots, long long cols, int waves,
                                  int words_per_thread, int block_threads,
                                  int smem_bytes, void* cuda_stream) {
  if (n_positions <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{words, loads, tiles, out_map, out, n_ins, n_pre, n_in, n_out,
               n_slots, cols, waves, block_threads, smem_bytes,
               static_cast<cudaStream_t>(cuda_stream), fault, meta,
               n_positions};
  return dispatch<true>(a, words_per_thread);
}
