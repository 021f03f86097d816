"""AAP bit-plane interpreter: the encoded stream as data (port of
`repro.kernels.aap_interpreter`, fault-free).

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
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core.isa import (AAP, KSTREAM_COLS, dcc_state_rows,
                                  encode_kernel_stream, kstream_slot)
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


def aap_interp_plain(stream: torch.Tensor, tiles: torch.Tensor,
                     out_slots: torch.Tensor, n_state: int) -> torch.Tensor:
    """Plain torch replay of the micro-op table over a [n_state, waves,
    cols] state, one instruction at a time."""
    waves, n_in, cols = tiles.shape
    state = torch.zeros((n_state, waves, cols), dtype=torch.int32,
                        device=tiles.device)
    state[:n_in] = tiles.transpose(0, 1)
    for ins in stream.tolist():
        a, b, c = (state[ins[1 + 2 * k]] ^ -ins[2 + 2 * k] for k in range(3))
        if ins[0] == 0:
            bl = a
        elif ins[0] == 1:
            bl = ~(a ^ b)
        else:
            bl = (a & b) | (a & c) | (b & c)
        for k in range(4):                     # write slots, in arg order
            row, neg, en = ins[7 + 3 * k: 10 + 3 * k]
            if en:
                state[row] = bl ^ -neg
    return torch.stack([state[row] ^ -neg for row, neg in out_slots.tolist()],
                       dim=1)


def aap_interp(stream: torch.Tensor, tiles: torch.Tensor,
               out_slots: torch.Tensor, n_state: int) -> torch.Tensor:
    """Replay `stream` [n_ins, 19] int32 over `tiles` [waves, n_in, cols]
    int32 (operand rows of each wave), reading back `out_slots` [n_out, 2]
    int32 (state row, complement flag).  Returns [waves, n_out, cols]
    int32.  All three tensors contiguous and on one device."""
    for name, t, dim in (("stream", stream, 2), ("tiles", tiles, 3),
                         ("out_slots", out_slots, 2)):
        if t.dim() != dim:
            raise ValueError(f"{name} must have {dim} dims, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tiles.device:
            raise ValueError(f"{name} lies on {t.device}, tiles on "
                             f"{tiles.device}")
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


@functools.lru_cache(maxsize=64)
def cuda_wave_fn(program: Tuple[AAP, ...], result_rows: Tuple[int, ...],
                 n_rows: int):
    """The wave function behind engine "cuda" (the counterpart of the
    reference's `pallas_wave_fn`).

    Returns `run(staged)` mapping [waves, n_rows_in, chips, banks,
    subarrays, row_words] int32 to the readback block [waves,
    len(result_rows), ...].  The stream is encoded once per (program,
    n_rows) and copied once to each device it runs on."""
    out_slots = [kstream_slot(r, n_rows) for r in result_rows]
    n_out = len(out_slots)

    if not program:
        # Degenerate stream: readback of an untouched sub-array, no launch.
        def run_empty(staged: torch.Tensor) -> torch.Tensor:
            zeros = torch.zeros_like(staged[:, 0])

            def pick(row, neg):
                v = staged[:, row] if row < staged.shape[1] else zeros
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
    on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def run(staged: torch.Tensor) -> torch.Tensor:
        waves, n_in = staged.shape[:2]
        if staged.device not in on_device:
            on_device[staged.device] = (
                torch.from_numpy(stream_np).to(staged.device),
                torch.tensor(out_slots, dtype=torch.int32,
                             device=staged.device).reshape(n_out, 2))
        stream, slots = on_device[staged.device]
        out = aap_interp(stream, staged.reshape(waves, n_in, -1), slots,
                         n_state)
        return out.reshape((waves, n_out) + tuple(staged.shape[2:]))
    return run
