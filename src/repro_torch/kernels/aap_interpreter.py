"""AAP bit-plane interpreter: the encoded stream as data (port of
`repro.kernels.aap_interpreter`).

The program is lowered host-side to the int32 [n_ins, 19] micro-op table
of `core.isa.encode_kernel_stream` and replayed over every word column of
every wave: each column owns a fresh zeroed state of
`dcc_state_rows(n_rows)` rows (normal rows plus the two DCC cells) with
the staged operand rows preloaded.  Reads resolve before writes within an
instruction; the up-to-four write slots replay in argument order; output
slots may read back complemented.

Kernel: `csrc/aap_interp.cu`, replacing the TPU kernel
`src/repro/kernels/aap_interpreter.py:_interp_kernel`.  It replays the
stream as `pack_stream` packs it on the host, once per program: one
16-byte word per instruction, its rows renamed to a compact set of
shared-memory slots by a linear scan over each row version's live range
(the instructions first put in demand order where that needs fewer
slots), staged rows copied from the tiles `LOOKAHEAD` instructions
before their first read instead of preloaded.  One thread owns 1, 2 or
4 word columns of one wave; `launch_geometry` picks that and the block
from the slot count and the SM count; all waves run in one
launch.  Device memory sees each staged row once, but the replay's
chain of dependent shared-memory accesses bounds it.  The kernel's
plain twin `aap_interp_packed_plain` replays the packed words.  On a CPU
tensor the wrapper runs that twin when given the packed stream (as the
"cuda" engine gives it) and `aap_interp_plain` otherwise; on a CUDA
tensor it launches the kernel or raises.

Fault injection, replacing
`src/repro/kernels/aap_interpreter.py:_interp_kernel_faulted`, is the
same kernel's other instantiation in `csrc/aap_interp.cu`, over the same
packed stream plus three inputs: per-instruction failure thresholds (0
for copies and protected ops), per-column metadata (the slot hash
`mix32(slot ^ seed)` and the word id) and the stuck rows.  Each DRA/TRA
XORs the flip mask of `core.faults.fault_mask` into its bit-line value
before the write-back.  The reference pins stuck rows after the load and
after every instruction; `pack_stream(..., stuck=)` folds them into the
words instead (a read of a stuck row reads slot 0 complemented by the
stuck bit, a write to it goes to the sink).  The hash is keyed by each
instruction's index in program order, which the packed stream keeps
beside the words (`PackedStream.order`).  Its wrapper is
`aap_interp_faulted`; on a CPU tensor it runs the packed twin with the
flips when given the packed stream, and the unpacked replay
`aap_interp_faulted_plain`, the oracle, otherwise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.faults import as_u32, fault_mask, mix32, slot_ids_grid
from repro_torch.core.isa import (AAP, KSTREAM_COLS, OP_DRA, OP_TRA,
                                  dcc_state_rows, encode_kernel_stream,
                                  kstream_slot)
from repro_torch.core.subarray import wrap_int32
from repro_torch.kernels import _build

# The kernel's launch geometry: shared memory one block may hold on Hopper
# (227 KB) and one SM holds (228 KB, 1 KB of it reserved per resident
# block), threads and blocks one SM holds, the widest block, and the
# instruction chunk that each block double-buffers in shared memory (16
# bytes an instruction, 8 more with fault injection).
MAX_BLOCK_SMEM = 232448
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_SMEM = 1024
SM_THREADS = 2048
SM_BLOCKS = 32
MAX_BLOCK_THREADS = 512
STREAM_CHUNK = 256
FAULT_BYTES = 8
# Instructions between a staged row's copy and its first read (kLookahead
# in csrc/aap_interp.cu), and the widest state the 16-bit row fields of a
# packed instruction address.
LOOKAHEAD = 16
MAX_STATE_ROWS = 0xFFFF


def launch_geometry(n_slots: int, cols: int, waves: int, sm_count: int,
                    words=(4, 2, 1), *,
                    faulted: bool = False) -> Tuple[int, int, int]:
    """(words per thread, threads per block, shared bytes per block) of
    the kernel.  Each thread owns `w` neighbouring word columns of one
    wave, and a block holds two instruction chunks (with `faulted` their
    fault data too) and (n_slots rounded up to odd) * 4 * w bytes a
    thread.  Of the `words` choices and the block widths that fit, the
    one with the fewest rounds of resident blocks over `sm_count` SMs,
    then the most words a thread (one decode for more words), then the
    fewest threads on the busiest SM within a round, then the widest
    block."""
    chunk = 2 * STREAM_CHUNK * (16 + FAULT_BYTES * faulted)
    best = None
    for w in words:
        threads = -(-cols // w)
        for t in range(32, MAX_BLOCK_THREADS + 1, 32):
            smem = (n_slots | 1) * 4 * w * t + chunk
            if smem > MAX_BLOCK_SMEM:
                break
            per_sm = min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_SMEM),
                         SM_THREADS // t, SM_BLOCKS)
            blocks = -(-threads // t) * waves
            rounds = -(-blocks // (per_sm * sm_count))
            busiest = -(-blocks // (sm_count * rounds)) * t
            key = (rounds, -w, busiest, -t)
            if best is None or key < best[0]:
                best = (key, w, t, smem)
    if best is None:
        raise ValueError(f"{n_slots} state slots do not fit one warp's "
                         f"columns in shared memory")
    return best[1:]


class PackedStream:
    """An encoded [n_ins, 19] stream packed for the fault-free kernel.

    `words` [n_ins + 2, 4] int32: one 16-byte word per instruction (two
    zero words pad the kernel's prefetch): the slots of reads a, b, c
    and of writes 0 to 3 as 16-bit fields (x = a | b << 16, y = c | w0 <<
    16, z = w1 | w2 << 16, w = w3 | flags << 16), flags holding the kind
    (bits 0-1: 1 for BL = XNOR(a, b), 2 for MAJ3(a, b, c)), the read
    complements (2-4), the write complements (5-8) and the number of
    staged-row copies issued at this instruction (9-10).  Every word
    reads three slots and writes four, so the kernel has no branch on
    the kind or on a write: a COPY is XNOR(a, ~0) (b is slot 0,
    complemented), an unused read is slot 0, and an unused write (or
    one nobody reads) goes to slot 1, which is never read.  `loads`
    int32 lists those copies as
    tile row | slot << 16: the first `n_pre` before the loop, then in
    instruction order, each issued `LOOKAHEAD` instructions before its
    row's first read (four zero entries pad the prefetch).  `out_map`
    [n_out, 2] int32: each output's slot, or -1 - tile row for a staged
    row never written, and its complement flag.  Slot 0 holds zeros: a
    read of a row that is neither staged nor written yet reads it, and
    so does a read of a stuck row (`stuck`, folded in by the pass),
    complemented by its stuck bit.  `n_slots` counts the slots with
    slots 0 and 1; `peak_live` is the most rows live at once.  `order`
    [n_ins] int64 holds each word's instruction index in program order
    (the key of its fault hash)."""

    def __init__(self, words, loads, n_pre, out_map, n_ins, n_in, n_slots,
                 peak_live, order, stuck):
        self.words, self.loads, self.out_map = words, loads, out_map
        self.n_pre, self.n_ins, self.n_in = n_pre, n_ins, n_in
        self.n_slots, self.peak_live = n_slots, peak_live
        self.order, self.stuck = order, stuck
        self._on: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}

    def tensors(self, device) -> Tuple[torch.Tensor, ...]:
        """(words, loads, out_map) on `device`, copied once."""
        key = ("words", torch.device(device))
        if key not in self._on:
            self._on[key] = tuple(torch.from_numpy(a).to(key[1]) for a in
                                  (self.words, self.loads, self.out_map))
        return self._on[key]

    def fault_tensors(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(order, keys) on `device`, copied once: `order` as an int64
        index, and `keys` [n_ins + 2, 2] int32 holding 0 and each word's
        `order * 0x9E3779B9` (two zero rows pad the kernel's prefetch);
        the faulted wrapper writes the thresholds into column 0."""
        key = ("fault", torch.device(device))
        if key not in self._on:
            keys = np.zeros((self.n_ins + 2, 2), np.uint32)
            keys[:self.n_ins, 1] = (self.order * _GOLDEN) & 0xFFFFFFFF
            self._on[key] = (torch.from_numpy(self.order).to(key[1]),
                             torch.from_numpy(keys.view(np.int32)).to(key[1]))
        return self._on[key]


_READS_OF_KIND = (1, 2, 3)      # COPY reads a; DRA a, b; TRA a, b, c
_GOLDEN = 0x9E3779B9            # the fault hash's op-index multiplier


def _linear_scan(intervals) -> Tuple[Dict[int, int], int]:
    """Slots for (key, start, end) intervals: a slot is free for a new
    interval once its last one ended before the new one starts.  Returns
    ({key: slot}, slots used); slots 0 and 1 are kept back."""
    import heapq
    free, active, slot_of, used = [], [], {}, 1
    for key, start, end in sorted(intervals, key=lambda x: (x[1], x[0])):
        while active and active[0][0] < start:
            heapq.heappush(free, heapq.heappop(active)[1])
        if free:
            slot = heapq.heappop(free)
        else:
            used += 1
            slot = used
        slot_of[key] = slot
        heapq.heappush(active, (end, slot))
    return slot_of, used


def _demand_order(reads, writes, out_rows) -> list:
    """An order of the instructions that keeps every read-after-write,
    write-after-read and write-after-write dependency on a row, emitting
    each instruction only when a later one needs it (depth first from
    the instructions whose writes are read back, the latest predecessor
    first; the rest after them in program order), so that a value is
    made just before its first use and holds its row for less time."""
    n = len(reads)
    preds = [set() for _ in range(n)]
    last_w: Dict[int, int] = {}
    readers: Dict[int, list] = {}
    for i in range(n):
        for r in reads[i]:
            if r in last_w:
                preds[i].add(last_w[r])
        for r in writes[i]:
            if r in last_w:
                preds[i].add(last_w[r])
            preds[i].update(j for j in readers.get(r, ()) if j != i)
        for r in reads[i]:
            readers.setdefault(r, []).append(i)
        for r in writes[i]:
            last_w[r] = i
            readers[r] = []
    order, done = [], [False] * n
    roots = sorted({last_w[r] for r in out_rows if r in last_w},
                   reverse=True)
    for root in roots + list(range(n)):
        stack = [(root, iter(sorted(preds[root], reverse=True)))]
        while stack:
            node, todo = stack[-1]
            nxt = next((p for p in todo if not done[p]), None)
            if nxt is not None:
                stack.append((nxt, iter(sorted(preds[nxt], reverse=True))))
                continue
            stack.pop()
            if not done[node]:
                done[node] = True
                order.append(node)
    return order


def pack_stream(stream: np.ndarray, out_slots, n_state: int,
                n_in: int, stuck=()) -> PackedStream:
    """Pack an encoded [n_ins, 19] stream into one 16-byte word per
    instruction over a compact set of shared-memory slots.

    Each write of a row starts a version of it, live until its last read
    (an output row's last version to the end); a staged row's initial
    version is copied from the tiles `LOOKAHEAD` instructions before its
    first read (all that fall before instruction `LOOKAHEAD` ahead of the
    loop).  Versions nobody reads (and a write slot that a later slot of
    the same instruction overwrites) are dropped: their write slots are
    disabled.  Times order an instruction's copies before its reads
    before its writes, so a write may reuse a slot whose last read is in
    its own instruction, and a copy only one freed earlier.  Slots are
    assigned by a linear scan over the versions' live ranges.

    The stream is packed twice, in program order and in `_demand_order`,
    and the packing with fewer slots is kept (program order on a tie):
    demand order lets the staged XNOR products of a carry-save dot wait
    for their adder instead of all being held at once (the K=128 serving
    stream: 96 slots against 147), while program order needs fewer where
    the adders share the DCC rows (the TMR stream: 138 against 142).

    `stuck` ((state row, bit), ...) lists rows that the fault model
    pins to all ones or all zeros after the load and after every
    instruction (rows outside the state are ignored; a later pin of a
    row wins).  An instruction reads before it writes, so a read of a
    stuck row sees its constant: it reads slot 0 with its complement
    flag XORed with the stuck bit.  A write to it is lost: it goes to
    the sink.  A stuck row is never copied from the tiles, never gets a
    version and orders no instructions, and an output that is one reads
    slot 0 complemented by its bit."""
    return min((_pack(stream, out_slots, n_state, n_in, demand, stuck)
                for demand in (False, True)), key=lambda p: p.n_slots)


def _pack(stream: np.ndarray, out_slots, n_state: int, n_in: int,
          demand: bool, stuck=()) -> PackedStream:
    """`pack_stream` in program order, or in `_demand_order` (the words
    follow that order)."""
    stream = np.asarray(stream, np.int64)
    n_ins = stream.shape[0]
    pins = {int(r): int(v) & 1 for r, v in stuck if 0 <= int(r) < n_state}
    if n_state > MAX_STATE_ROWS:
        raise ValueError(f"{n_state} state rows exceed the packed "
                         f"stream's {MAX_STATE_ROWS} (16-bit row fields)")
    if not 0 <= n_in <= n_state:
        raise ValueError(f"{n_in} operand rows for {n_state} state rows")
    rows = stream[:, [1, 3, 5, 7, 10, 13, 16]] if n_ins else np.zeros((0, 7))
    if rows.size and (rows.min() < 0 or rows.max() >= n_state) or any(
            not 0 <= r < n_state for r, _ in out_slots):
        raise ValueError(f"stream addresses rows outside {n_state}")
    order = np.arange(n_ins, dtype=np.int64)
    if demand and n_ins:
        order = np.asarray(_demand_order(
            [{int(ins[1 + 2 * k]) for k in range(_READS_OF_KIND[ins[0]])}
             - pins.keys() for ins in stream],
            [{int(ins[7 + 3 * k]) for k in range(4) if ins[9 + 3 * k]}
             - pins.keys() for ins in stream],
            [r for r, _ in out_slots if r not in pins]), np.int64)
        stream = stream[order]

    # versions: [kind ("staged" | "written"), row, start, last read]
    versions = []
    cur = {}                            # row -> live version
    reads = []                          # per instruction: version ids
    writes = []                         # per instruction: version or None
    for i in range(n_ins):
        ins = stream[i]
        kind = int(ins[0])
        rd = []
        for k in range(_READS_OF_KIND[kind]):
            row = int(ins[1 + 2 * k])
            if row in pins:             # reads its constant from slot 0
                rd.append(None)
                continue
            v = cur.get(row)
            if v is None and row < n_in:
                v = cur[row] = len(versions)
                versions.append(["staged", row, i, i])
            if v is not None:
                versions[v][3] = i
            rd.append(v)
        reads.append(rd)
        last = {}                       # row -> its last enabled write slot
        for k in range(4):
            if ins[9 + 3 * k] and int(ins[7 + 3 * k]) not in pins:
                last[int(ins[7 + 3 * k])] = k
        wr = [None] * 4
        for row, k in last.items():
            wr[k] = cur[row] = len(versions)
            versions.append(["written", row, i, None])
        writes.append(wr)
    outs = []
    for row, neg in out_slots:
        if row in pins:
            outs.append((None, row, neg))
            continue
        v = cur.get(row)
        if v is not None:
            versions[v][3] = n_ins      # read by the epilogue
        outs.append((v, row, neg))

    # live ranges in times: copies at 3i, reads at 3i + 1, writes at 3i + 2
    def issue_at(v):
        first = versions[v][2]
        return first - LOOKAHEAD if first >= LOOKAHEAD else -1

    live = [v for v, ver in enumerate(versions) if ver[3] is not None]
    intervals = []
    for v in live:
        kind, _, start, end = versions[v]
        begin = 3 * issue_at(v) if kind == "staged" else 3 * start + 2
        intervals.append((v, begin, 3 * end + 1))
    slot_of, used = _linear_scan(intervals)
    if used + 1 > MAX_STATE_ROWS:
        raise ValueError(f"{used + 1} slots exceed the packed stream's "
                         f"{MAX_STATE_ROWS}")
    _, peak = _linear_scan([
        (v, 3 * s + (1 if k == "staged" else 2), 3 * e + 1)
        for v, (k, _, s, e) in ((v, versions[v]) for v in live)])
    peak -= 1

    staged = sorted((issue_at(v), v) for v in live
                    if versions[v][0] == "staged")
    n_pre = sum(1 for at, _ in staged if at < 0)
    n_loads = np.zeros(max(n_ins, 1), np.int64)
    for at, _ in staged:
        if at >= 0:
            n_loads[at] += 1
    loads = np.zeros(len(staged) + 4, np.int64)
    for j, (_, v) in enumerate(staged):
        loads[j] = versions[v][1] | slot_of[v] << 16

    words = np.zeros((n_ins + 2, 4), np.int64)
    for i in range(n_ins):
        ins = stream[i]
        kind = int(ins[0])
        f = max(kind, 1) | int(n_loads[i]) << 9
        if kind == 0:                   # COPY: BL = XNOR(a, ~slot 0) = a
            f |= 1 << 3
        sl = [0, 0, 0, 1, 1, 1, 1]      # unused reads: slot 0; writes: 1
        for k, v in enumerate(reads[i]):
            sl[k] = slot_of[v] if v is not None else 0
            f |= (int(ins[2 + 2 * k])
                  ^ pins.get(int(ins[1 + 2 * k]), 0)) << (2 + k)
        for k, v in enumerate(writes[i]):
            if v is not None and v in slot_of:
                sl[3 + k] = slot_of[v]
                f |= int(ins[8 + 3 * k]) << (5 + k)
        words[i] = (sl[0] | sl[1] << 16, sl[2] | sl[3] << 16,
                    sl[4] | sl[5] << 16, sl[6] | f << 16)
    out_map = np.array(
        [(slot_of[v] if v is not None else
          (-1 - row if row < n_in and row not in pins else 0),
          neg ^ pins.get(row, 0)) for v, row, neg in outs],
        np.int64).reshape(-1, 2)
    as32 = lambda a: a.astype(np.uint32).view(np.int32)  # noqa: E731
    return PackedStream(as32(words), as32(loads), n_pre,
                        out_map.astype(np.int32), n_ins, n_in, used + 1,
                        peak, order, tuple(sorted(pins.items())))


def aap_interp_packed_plain(packed: PackedStream, tiles: torch.Tensor,
                            thresh: torch.Tensor | None = None,
                            meta: torch.Tensor | None = None,
                            n_positions: int = 0) -> torch.Tensor:
    """Plain torch twin of the kernel: replays the packed words over a
    [n_slots, waves, cols] state, issuing the staged-row copies where
    the kernel issues them and reading back `out_map`.  With `thresh`
    [n_ins] (program order), `meta` and `n_positions` as
    `aap_interp_faulted` takes them, the twin of its instantiation with
    fault injection: each word's flip is keyed by its instruction's
    program-order index `packed.order`."""
    flip = None if thresh is None else _flipper(thresh, meta, n_positions)
    waves, n_in, cols = tiles.shape
    if n_in != packed.n_in:
        raise ValueError(f"tiles hold {n_in} operand rows, the packed "
                         f"stream {packed.n_in}")
    state = torch.zeros((packed.n_slots, waves, cols), dtype=torch.int32,
                        device=tiles.device)
    loads = packed.loads.view(np.uint32).tolist()
    pos = 0

    def issue(count: int) -> None:
        nonlocal pos
        for e in loads[pos:pos + count]:
            state[e >> 16] = tiles[:, e & 0xFFFF]
        pos += count

    issue(packed.n_pre)
    words_ = packed.words[:packed.n_ins].view(np.uint32).tolist()
    for j, (x, y, z, w) in enumerate(words_):
        f = w >> 16
        issue(f >> 9 & 3)
        a, b, c = (state[s] ^ -(f >> (2 + k) & 1)
                   for k, s in enumerate((x & 0xFFFF, x >> 16, y & 0xFFFF)))
        if f & 3 == 2:
            bl = (a & b) | (a & c) | (b & c)
        else:
            bl = ~(a ^ b)
        if flip is not None:
            bl = flip(int(packed.order[j]), bl)
        for k, s in enumerate((y >> 16, z & 0xFFFF, z >> 16, w & 0xFFFF)):
            state[s] = bl ^ -(f >> (5 + k) & 1)
    outs = [(state[code] if code >= 0 else tiles[:, -1 - code]) ^ -neg
            for code, neg in packed.out_map.tolist()]
    if not outs:
        return torch.zeros((waves, 0, cols), dtype=torch.int32,
                           device=tiles.device)
    return torch.stack(outs, dim=1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("aap_interp")
    lib.aap_interp.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aap_interp.restype = ctypes.c_int
    lib.aap_interp_faulted.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aap_interp_faulted.restype = ctypes.c_int
    return lib


def _replay(stream: torch.Tensor, tiles: torch.Tensor,
            out_slots: torch.Tensor, n_state: int, flip=None,
            pins=()) -> torch.Tensor:
    """Plain torch replay of the micro-op table over a [n_state, waves,
    cols] state, one instruction at a time.  `flip(i, bl)` may corrupt
    instruction i's bit-line value; `pins` ((row, bit), ...) are pinned
    after the load and after every instruction."""
    waves, n_in, cols = tiles.shape
    state = torch.zeros((n_state, waves, cols), dtype=torch.int32,
                        device=tiles.device)
    state[:n_in] = tiles.transpose(0, 1)

    def force() -> None:
        for row, v in pins:
            state[row] = -v                    # all ones or all zeros

    force()
    for i, ins in enumerate(stream.tolist()):
        a, b, c = (state[ins[1 + 2 * k]] ^ -ins[2 + 2 * k] for k in range(3))
        if ins[0] == 0:
            bl = a
        elif ins[0] == 1:
            bl = ~(a ^ b)
        else:
            bl = (a & b) | (a & c) | (b & c)
        if flip is not None:
            bl = flip(i, bl)
        for k in range(4):                     # write slots, in arg order
            row, neg, en = ins[7 + 3 * k: 10 + 3 * k]
            if en:
                state[row] = bl ^ -neg
        force()
    return torch.stack([state[row] ^ -neg for row, neg in out_slots.tolist()],
                       dim=1)


def aap_interp_plain(stream: torch.Tensor, tiles: torch.Tensor,
                     out_slots: torch.Tensor, n_state: int) -> torch.Tensor:
    """Plain torch replay of the micro-op table, one instruction at a
    time."""
    return _replay(stream, tiles, out_slots, n_state)


def _check_operands(named, device) -> None:
    """Each (name, tensor, dims) must be int32, contiguous, of that rank
    and on `device`."""
    for name, t, dim in named:
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dims, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} lies on {t.device}, tiles on {device}")


def words_choices(cols: int, ptr: int) -> Tuple[int, ...]:
    """Word columns a thread may own: those of 4, 2 and 1 that divide
    `cols` and the tiles' address (so every thread's words are one
    aligned vector)."""
    return tuple(w for w in (4, 2, 1) if cols % w == 0 and ptr % (4 * w) == 0)


def aap_interp(stream: torch.Tensor, tiles: torch.Tensor,
               out_slots: torch.Tensor, n_state: int, *,
               packed: PackedStream | None = None) -> torch.Tensor:
    """Replay `stream` [n_ins, 19] int32 over `tiles` [waves, n_in, cols]
    int32 (operand rows of each wave), reading back `out_slots` [n_out, 2]
    int32 (state row, complement flag).  Returns [waves, n_out, cols]
    int32.  All three tensors contiguous and on one device.

    `packed` is `pack_stream` of the same stream and read-back for these
    tiles' n_in; without it a CUDA call packs it here, reading the stream
    to the host.  With it a CPU call runs the kernel's plain twin
    `aap_interp_packed_plain`, without it `aap_interp_plain`."""
    _check_operands((("stream", stream, 2), ("tiles", tiles, 3),
                     ("out_slots", out_slots, 2)), tiles.device)
    if stream.shape[1] != KSTREAM_COLS or out_slots.shape[1] != 2:
        raise ValueError("stream must be [n_ins, 19] and out_slots [n_out, 2]")
    waves, n_in, cols = tiles.shape
    if n_in > n_state:
        raise ValueError(f"{n_in} operand rows exceed {n_state} state rows")
    if n_state > MAX_STATE_ROWS:
        raise ValueError(f"{n_state} state rows exceed the packed stream's "
                         f"{MAX_STATE_ROWS} (16-bit row fields)")
    if packed is not None and (packed.n_ins != stream.shape[0]
                               or packed.n_in != n_in
                               or len(packed.out_map) != out_slots.shape[0]):
        raise ValueError("packed stream does not match stream, tiles and "
                         "out_slots")
    if tiles.device.type == "cpu":
        if packed is not None:
            return aap_interp_packed_plain(packed, tiles)
        return aap_interp_plain(stream, tiles, out_slots, n_state)
    if tiles.device.type != "cuda":
        raise ValueError(f"aap_interp runs on cpu or cuda, not {tiles.device}")
    if packed is None:
        packed = pack_stream(stream.cpu().numpy(),
                             out_slots.cpu().tolist(), n_state, n_in)
    n_out = out_slots.shape[0]
    out = torch.empty((waves, n_out, cols), dtype=torch.int32,
                      device=tiles.device)
    if out.numel() == 0:
        return out
    w, threads, smem = launch_geometry(
        packed.n_slots, cols, waves, _build.sm_count(tiles.device),
        words_choices(cols, tiles.data_ptr()))
    p_words, p_loads, p_out = packed.tensors(tiles.device)
    with torch.cuda.device(tiles.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().aap_interp(
            p_words.data_ptr(), packed.n_ins, p_loads.data_ptr(),
            packed.n_pre, tiles.data_ptr(), n_in,
            p_out.data_ptr(), n_out, out.data_ptr(), packed.n_slots, cols,
            waves, w, threads, smem, cuda_stream), "aap_interp")
    aap_interp.launches += 1
    return out


aap_interp.launches = 0


def _flipper(thresh: torch.Tensor, meta: torch.Tensor, n_positions: int):
    """flip(i, bl): instruction i's bit-line value with the flip mask of
    `core.faults.fault_mask` XORed in (i in program order).  Every wave
    draws the same flips: the mask depends on the column only."""
    slot_h, word_ids = as_u32(meta[0]), as_u32(meta[1])
    ts = thresh.tolist()

    def flip(i: int, bl: torch.Tensor) -> torch.Tensor:
        if not ts[i]:
            return bl
        return bl ^ fault_mask(ts[i], i, slot_h, word_ids, n_positions)
    return flip


def aap_interp_faulted_plain(stream: torch.Tensor, thresh: torch.Tensor,
                             meta: torch.Tensor, tiles: torch.Tensor,
                             out_slots: torch.Tensor, n_state: int,
                             stuck: torch.Tensor,
                             n_positions: int) -> torch.Tensor:
    """Plain torch replay of the micro-op table with fault injection, the
    reference's semantics: stuck rows pinned after the load and after
    every instruction."""
    return _replay(stream, tiles, out_slots, n_state,
                   _flipper(thresh, meta, n_positions), stuck.tolist())


def aap_interp_faulted(stream: torch.Tensor, thresh: torch.Tensor,
                       meta: torch.Tensor, tiles: torch.Tensor,
                       out_slots: torch.Tensor, n_state: int,
                       stuck: torch.Tensor, n_positions: int, *,
                       packed: PackedStream | None = None) -> torch.Tensor:
    """`aap_interp` with fault injection.  thresh [n_ins] int32 holds each
    instruction's uint32 failure threshold (0: never flips); meta [2,
    cols] int32 holds each column's slot hash `mix32(slot ^ seed)` and
    word id; stuck [n_stuck, 2] int32 lists (state row, bit) pins;
    n_positions is the row width in bits.  Returns [waves, n_out, cols]
    int32.  All tensors contiguous and on one device.

    `packed` is `pack_stream` of the same stream, read-back and n_in
    with these stuck rows; without it a CUDA call packs it here, reading
    stream, out_slots and stuck to the host.  With it a CPU call runs
    the packed twin with the flips, without it
    `aap_interp_faulted_plain`."""
    _check_operands((("stream", stream, 2), ("thresh", thresh, 1),
                     ("meta", meta, 2), ("tiles", tiles, 3),
                     ("out_slots", out_slots, 2), ("stuck", stuck, 2)),
                    tiles.device)
    if stream.shape[1] != KSTREAM_COLS or out_slots.shape[1] != 2 \
            or stuck.shape[1] != 2:
        raise ValueError("stream must be [n_ins, 19], out_slots [n_out, 2] "
                         "and stuck [n_stuck, 2]")
    waves, n_in, cols = tiles.shape
    if thresh.shape[0] != stream.shape[0] or meta.shape != (2, cols):
        raise ValueError(f"thresh must be [{stream.shape[0]}] and meta "
                         f"[2, {cols}]")
    if n_in > n_state:
        raise ValueError(f"{n_in} operand rows exceed {n_state} state rows")
    if n_positions <= 0:
        raise ValueError("n_positions must be positive")
    if n_state > MAX_STATE_ROWS:
        raise ValueError(f"{n_state} state rows exceed the packed stream's "
                         f"{MAX_STATE_ROWS} (16-bit row fields)")
    if packed is not None and (packed.n_ins != stream.shape[0]
                               or packed.n_in != n_in
                               or len(packed.out_map) != out_slots.shape[0]
                               or len(packed.stuck) > stuck.shape[0]):
        raise ValueError("packed stream does not match stream, tiles, "
                         "out_slots and stuck")
    if tiles.device.type == "cpu":
        if packed is not None:
            return aap_interp_packed_plain(packed, tiles, thresh, meta,
                                           n_positions)
        return aap_interp_faulted_plain(stream, thresh, meta, tiles,
                                        out_slots, n_state, stuck,
                                        n_positions)
    if tiles.device.type != "cuda":
        raise ValueError(f"aap_interp_faulted runs on cpu or cuda, not "
                         f"{tiles.device}")
    if packed is None:
        packed = pack_stream(stream.cpu().numpy(), out_slots.cpu().tolist(),
                             n_state, n_in, stuck=stuck.cpu().tolist())
    n_out = out_slots.shape[0]
    out = torch.empty((waves, n_out, cols), dtype=torch.int32,
                      device=tiles.device)
    if out.numel() == 0:
        return out
    w, threads, smem = launch_geometry(
        packed.n_slots, cols, waves, _build.sm_count(tiles.device),
        words_choices(cols, tiles.data_ptr()), faulted=True)
    p_words, p_loads, p_out = packed.tensors(tiles.device)
    order, keys = packed.fault_tensors(tiles.device)
    fault = keys.clone()                       # (threshold, i * golden)
    fault[:packed.n_ins, 0] = thresh[order]
    with torch.cuda.device(tiles.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().aap_interp_faulted(
            p_words.data_ptr(), fault.data_ptr(), packed.n_ins,
            p_loads.data_ptr(), packed.n_pre, tiles.data_ptr(), n_in,
            meta.data_ptr(), n_positions, p_out.data_ptr(), n_out,
            out.data_ptr(), packed.n_slots, cols, waves, w, threads, smem,
            cuda_stream), "aap_interp_faulted")
    aap_interp_faulted.launches += 1
    return out


aap_interp_faulted.launches = 0


def _op_thresholds(program: Tuple[AAP, ...], faults) -> np.ndarray:
    """[n_ins] uint32 per-instruction failure thresholds: zero for copies
    and protected ops."""
    tvec = np.zeros(len(program), np.uint32)
    prot = set(faults.protected_ops)
    for i, ins in enumerate(program):
        if i in prot:
            continue
        if ins.op == OP_DRA:
            tvec[i] = faults.dra_thresh
        elif ins.op == OP_TRA:
            tvec[i] = faults.tra_thresh
    return tvec


def column_meta(c: int, b: int, s: int, w: int, *, seed: int,
                bank_lo: int = 0, banks_total=None,
                device=None) -> torch.Tensor:
    """[2, c*b*s*w] int32 per-column fault metadata of a [c, b, s, w]
    wave, built on `device`: each word column's slot hash `mix32(slot ^
    seed)` and its word id within the row."""
    grid = slot_ids_grid(c, b, s, bank_lo=bank_lo, banks_total=banks_total,
                         device=device)
    slot_h = wrap_int32(mix32(grid ^ seed).reshape(-1))
    word = torch.arange(w, dtype=torch.int32, device=device)
    return torch.stack([slot_h.repeat_interleave(w),
                        word.repeat(c * b * s)]).contiguous()


@functools.lru_cache(maxsize=256)
def cuda_wave_fn(program: Tuple[AAP, ...], result_rows: Tuple[int, ...],
                 n_rows: int, faults=None, bank_geom=None):
    """The wave function behind engine "cuda" (the counterpart of the
    reference's `pallas_wave_fn`).

    Returns `run(staged)` mapping [waves, n_rows_in, chips, banks,
    subarrays, row_words] int32 to the readback block [waves,
    len(result_rows), ...].  The stream is encoded once per (program,
    n_rows), packed once per number of staged rows (with the fault
    model's stuck rows folded in) and copied once to each device it runs
    on; `run.prepare(staged)` does that one-off work for a payload
    without a launch.

    With a `FaultModel` (an active wave model) the faulted kernel runs:
    per-instruction thresholds come from the program, and the column
    metadata is built on the device once per wave geometry; `bank_geom`
    = (bank_lo, banks_total) anchors a bank slice at its physical
    offset."""
    out_slots = [kstream_slot(r, n_rows) for r in result_rows]
    n_out = len(out_slots)
    stuck = () if faults is None else tuple(
        (wl, v) for wl, v in faults.stuck_rows if wl < n_rows)
    bank_lo, banks_total = bank_geom if bank_geom is not None else (0, None)

    if not program:
        # Degenerate stream: readback of an untouched sub-array (its
        # stuck rows pinned), no launch.
        def run_empty(staged: torch.Tensor) -> torch.Tensor:
            zeros = torch.zeros_like(staged[:, 0])

            def pick(row, neg):
                v = staged[:, row] if row < staged.shape[1] else zeros
                for srow, sval in stuck:
                    if srow == row:
                        v = ~zeros if sval else zeros
                return ~v if neg else v
            return torch.stack([pick(r, n) for r, n in out_slots], dim=1)
        run_empty.prepare = lambda staged: None
        return run_empty

    stream_np = encode_kernel_stream(program, n_rows=n_rows)
    n_state = dcc_state_rows(n_rows)
    # The kernel indexes shared memory with these rows unchecked.
    rows = stream_np[:, [1, 3, 5, 7, 10, 13, 16]]
    if rows.min() < 0 or rows.max() >= n_state or any(
            not 0 <= r < n_state for r, _ in out_slots):
        raise ValueError(f"program addresses word-lines outside the "
                         f"{n_rows} rows + 4 DCC word-lines of its template")
    thresh_np = (None if faults is None
                 else _op_thresholds(program, faults).view(np.int32))
    on_device: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
    metas: Dict[Tuple, torch.Tensor] = {}
    packs: Dict[int, PackedStream] = {}        # by operand rows staged

    def prepare(staged: torch.Tensor) -> None:
        """The one-off host work of a payload shape: the stream packed for
        its staged rows, copied to its device, the column metadata built
        and, on the card, the kernel library loaded."""
        n_in = staged.shape[1]
        dev = staged.device
        if dev not in on_device:
            on_device[dev] = (
                torch.from_numpy(stream_np).to(dev),
                torch.tensor(out_slots, dtype=torch.int32,
                             device=dev).reshape(n_out, 2))
            if faults is not None:
                on_device[dev] += (
                    torch.from_numpy(thresh_np).to(dev),
                    torch.tensor(stuck, dtype=torch.int32,
                                 device=dev).reshape(len(stuck), 2))
            if dev.type == "cuda":
                _lib()
        if n_in not in packs:
            packs[n_in] = pack_stream(stream_np, out_slots, n_state, n_in,
                                      stuck=stuck)
        geom = (dev,) + tuple(staged.shape[2:])
        if faults is not None and geom not in metas:
            metas[geom] = column_meta(*staged.shape[2:], seed=faults.seed,
                                      bank_lo=bank_lo,
                                      banks_total=banks_total, device=dev)

    def run(staged: torch.Tensor) -> torch.Tensor:
        prepare(staged)
        waves, n_in = staged.shape[:2]
        tiles = staged.reshape(waves, n_in, -1)
        if faults is None:
            stream, slots = on_device[staged.device]
            out = aap_interp(stream, tiles, slots, n_state,
                             packed=packs[n_in])
        else:
            stream, slots, thresh, pins = on_device[staged.device]
            meta = metas[(staged.device,) + tuple(staged.shape[2:])]
            out = aap_interp_faulted(stream, thresh, meta, tiles, slots,
                                     n_state, pins, staged.shape[-1] * 32,
                                     packed=packs[n_in])
        return out.reshape((waves, n_out) + tuple(staged.shape[2:]))
    run.prepare = prepare
    return run
