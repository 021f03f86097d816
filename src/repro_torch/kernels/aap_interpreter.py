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
`src/repro/kernels/aap_interpreter.py:_interp_kernel`.  One thread owns
one word column for the whole program; the column's state lives in
dynamic shared memory (`state[row * C + t]`, conflict-free per warp),
with C columns per block chosen so the block's state fits 227 KB; all
waves run in one launch.  Device memory sees each staged row once, but
the replay costs about seven shared-memory accesses per instruction per
column, so shared memory bounds it.  On a CPU tensor the wrapper runs
`aap_interp_plain`; on a CUDA tensor it launches the kernel or raises.

Fault injection: `csrc/aap_interp_faulted.cu`, replacing
`src/repro/kernels/aap_interpreter.py:_interp_kernel_faulted`, is the
same replay plus three inputs: per-instruction failure thresholds (0 for
copies and protected ops), per-column metadata (the slot hash
`mix32(slot ^ seed)` and the word id) and the stuck rows.  Each DRA/TRA
XORs the flip mask of `core.faults.fault_mask` into its bit-line value
before the write-back, and stuck rows are pinned after the load and
after every instruction.  Its wrapper is `aap_interp_faulted`, its plain
version `aap_interp_faulted_plain`; the fault-free kernel is untouched.
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

# Shared memory one block may hold on Hopper (227 KB), and the widest
# block the kernel uses.
SMEM_BYTES = 232448
MAX_BLOCK_COLS = 256


def block_cols(n_state: int) -> int:
    """Columns per block: the widest multiple of 32 (at most 256) whose
    state, 4 * n_state * C bytes, fits in one block's shared memory."""
    cols = min(MAX_BLOCK_COLS, SMEM_BYTES // (4 * n_state) // 32 * 32)
    if cols < 32:
        raise ValueError(f"{n_state} state rows do not fit one warp's "
                         "columns in shared memory")
    return cols


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("aap_interp")
    lib.aap_interp.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.aap_interp.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib_faulted() -> ctypes.CDLL:
    lib = _build.load("aap_interp_faulted")
    lib.aap_interp_faulted.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
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


def aap_interp(stream: torch.Tensor, tiles: torch.Tensor,
               out_slots: torch.Tensor, n_state: int) -> torch.Tensor:
    """Replay `stream` [n_ins, 19] int32 over `tiles` [waves, n_in, cols]
    int32 (operand rows of each wave), reading back `out_slots` [n_out, 2]
    int32 (state row, complement flag).  Returns [waves, n_out, cols]
    int32.  All three tensors contiguous and on one device."""
    _check_operands((("stream", stream, 2), ("tiles", tiles, 3),
                     ("out_slots", out_slots, 2)), tiles.device)
    if stream.shape[1] != KSTREAM_COLS or out_slots.shape[1] != 2:
        raise ValueError("stream must be [n_ins, 19] and out_slots [n_out, 2]")
    waves, n_in, cols = tiles.shape
    if n_in > n_state:
        raise ValueError(f"{n_in} operand rows exceed {n_state} state rows")
    if tiles.device.type == "cpu":
        return aap_interp_plain(stream, tiles, out_slots, n_state)
    if tiles.device.type != "cuda":
        raise ValueError(f"aap_interp runs on cpu or cuda, not {tiles.device}")
    n_out = out_slots.shape[0]
    out = torch.empty((waves, n_out, cols), dtype=torch.int32,
                      device=tiles.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tiles.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().aap_interp(
            stream.data_ptr(), stream.shape[0], tiles.data_ptr(), n_in,
            out_slots.data_ptr(), n_out, out.data_ptr(), n_state, cols,
            waves, block_cols(n_state), cuda_stream), "aap_interp")
    aap_interp.launches += 1
    return out


aap_interp.launches = 0


def aap_interp_faulted_plain(stream: torch.Tensor, thresh: torch.Tensor,
                             meta: torch.Tensor, tiles: torch.Tensor,
                             out_slots: torch.Tensor, n_state: int,
                             stuck: torch.Tensor,
                             n_positions: int) -> torch.Tensor:
    """Plain torch replay of the micro-op table with fault injection.
    Every wave draws the same flips: the mask depends on the column
    only."""
    slot_h, word_ids = as_u32(meta[0]), as_u32(meta[1])
    ts = thresh.tolist()

    def flip(i: int, bl: torch.Tensor) -> torch.Tensor:
        if not ts[i]:
            return bl
        return bl ^ fault_mask(ts[i], i, slot_h, word_ids, n_positions)

    return _replay(stream, tiles, out_slots, n_state, flip, stuck.tolist())


def aap_interp_faulted(stream: torch.Tensor, thresh: torch.Tensor,
                       meta: torch.Tensor, tiles: torch.Tensor,
                       out_slots: torch.Tensor, n_state: int,
                       stuck: torch.Tensor, n_positions: int) -> torch.Tensor:
    """`aap_interp` with fault injection.  thresh [n_ins] int32 holds each
    instruction's uint32 failure threshold (0: never flips); meta [2,
    cols] int32 holds each column's slot hash `mix32(slot ^ seed)` and
    word id; stuck [n_stuck, 2] int32 lists (state row, bit) pins;
    n_positions is the row width in bits.  Returns [waves, n_out, cols]
    int32.  All tensors contiguous and on one device."""
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
    if tiles.device.type == "cpu":
        return aap_interp_faulted_plain(stream, thresh, meta, tiles,
                                        out_slots, n_state, stuck,
                                        n_positions)
    if tiles.device.type != "cuda":
        raise ValueError(f"aap_interp_faulted runs on cpu or cuda, not "
                         f"{tiles.device}")
    n_out = out_slots.shape[0]
    out = torch.empty((waves, n_out, cols), dtype=torch.int32,
                      device=tiles.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(tiles.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib_faulted().aap_interp_faulted(
            stream.data_ptr(), stream.shape[0], thresh.data_ptr(),
            meta.data_ptr(), tiles.data_ptr(), n_in, out_slots.data_ptr(),
            n_out, stuck.data_ptr(), stuck.shape[0], n_positions,
            out.data_ptr(), n_state, cols, waves, block_cols(n_state),
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


@functools.lru_cache(maxsize=64)
def cuda_wave_fn(program: Tuple[AAP, ...], result_rows: Tuple[int, ...],
                 n_rows: int, faults=None, bank_geom=None):
    """The wave function behind engine "cuda" (the counterpart of the
    reference's `pallas_wave_fn`).

    Returns `run(staged)` mapping [waves, n_rows_in, chips, banks,
    subarrays, row_words] int32 to the readback block [waves,
    len(result_rows), ...].  The stream is encoded once per (program,
    n_rows) and copied once to each device it runs on.

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

    def run(staged: torch.Tensor) -> torch.Tensor:
        waves, n_in = staged.shape[:2]
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
        tiles = staged.reshape(waves, n_in, -1)
        if faults is None:
            stream, slots = on_device[dev]
            out = aap_interp(stream, tiles, slots, n_state)
        else:
            stream, slots, thresh, pins = on_device[dev]
            geom = (dev,) + tuple(staged.shape[2:])
            if geom not in metas:
                metas[geom] = column_meta(*staged.shape[2:], seed=faults.seed,
                                          bank_lo=bank_lo,
                                          banks_total=banks_total,
                                          device=dev)
            out = aap_interp_faulted(stream, thresh, metas[geom], tiles,
                                     slots, n_state, pins,
                                     staged.shape[-1] * 32)
        return out.reshape((waves, n_out) + tuple(staged.shape[2:]))
    return run
