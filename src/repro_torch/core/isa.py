"""DRIM AAP instruction set, Table-2 microprograms and the interpreters
(port of `repro.core.isa`).

Four AAP (ACTIVATE-ACTIVATE-PRECHARGE) instruction types:

  type-1  AAP(src, des)              copy / NOT (via DCC word-lines)
  type-2  AAP(src, des1, des2)       double-copy
  type-3  AAP(src1, src2, des)       DRA  -> X(N)OR
  type-4  AAP(src1, src2, src3, des) TRA  -> MAJ3

Every instruction costs one AAP cycle whatever its type (paper §3.2).

Two interpreters, held bit-identical by the tests, fault injection
included: `run_program` steps an encoded [n, 5] stream over a full
(batched) `SubArray` state, the reference's `lax.scan` as a Python loop;
`run_program_unrolled` replays the program over per-row tensors and
touches only the rows it names.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .faults import as_u32, fault_mask, mix32
from .subarray import (WORD_BITS, SubArray, _dra_bl, _tra_bl, _write_all,
                       aap_copy, aap_copy2, aap_dra, aap_tra)

OP_COPY, OP_COPY2, OP_DRA, OP_TRA = 0, 1, 2, 3
_ARITY = {OP_COPY: 2, OP_COPY2: 3, OP_DRA: 3, OP_TRA: 4}

# Paper Table 1: the enable bits of the sense-amplification state.
# W/R-Copy-NOT-TRA -> (En_M=1, En_x=1, En_C=0); DRA -> (0, 1, 1).
ENABLE_BITS = {
    OP_COPY: dict(En_M=1, En_x=1, En_C=0),
    OP_COPY2: dict(En_M=1, En_x=1, En_C=0),
    OP_DRA: dict(En_M=0, En_x=1, En_C=1),
    OP_TRA: dict(En_M=1, En_x=1, En_C=0),
}


@dataclasses.dataclass(frozen=True)
class AAP:
    op: int
    args: Tuple[int, ...]

    def __post_init__(self):
        n = _ARITY[self.op]
        if len(self.args) != n:
            raise ValueError(f"op {self.op} takes {n} addresses")


def encode(program: Sequence[AAP]) -> torch.Tensor:
    """[n, 5] int32: op code then the word-line addresses, zero-padded."""
    rows = [[ins.op] + list(ins.args) + [0] * (4 - len(ins.args))
            for ins in program]
    return torch.tensor(rows, dtype=torch.int32).reshape(len(rows), 5)


def cost(program: Sequence[AAP]) -> Tuple[int, Counter]:
    return len(program), Counter(ins.op for ins in program)


# ---------------------------------------------------------------------------
# Shared command-bus issue model (per-bank queues, pim/queue.py)
# ---------------------------------------------------------------------------

# One AAP needs three command-bus slots: ACTIVATE, ACTIVATE, PRECHARGE.
CMDS_PER_AAP = 3


def simulate_bus_issue(lengths: Sequence[int], *, slots_per_aap: int,
                       cmds_per_aap: int = CMDS_PER_AAP,
                       ) -> Tuple[int, Tuple[int, ...]]:
    """Interleave N per-bank AAP streams onto ONE shared command bus.

    `lengths[q]` is the number of AAPs queue q must issue.  Each AAP
    occupies its bank for `slots_per_aap` command-bus slots (the
    ACT-ACT-PRE envelope, `timing.CMD_SLOTS_PER_AAP` at DDR4 rates) but
    takes only `cmds_per_aap` bus slots to issue; the controller grants
    the bus to ready queues in (ready-time, queue-id) order.  Once
    `n_queues x cmds_per_aap` approaches `slots_per_aap` the bus saturates
    and banks stall waiting for issue slots.

    Returns (makespan_slots, per-queue finish slots).  Stall cycles are
    `makespan - max(lengths) * slots_per_aap`.
    """
    if cmds_per_aap > slots_per_aap:
        raise ValueError("an AAP cannot need more issue slots than its "
                         "own envelope provides")
    heap = [(0, q) for q, n in enumerate(lengths) if n > 0]
    heapq.heapify(heap)
    remaining = list(lengths)
    finish = [0] * len(lengths)
    bus_free = 0
    while heap:
        ready, q = heapq.heappop(heap)
        start = max(ready, bus_free)
        bus_free = start + cmds_per_aap
        done = start + slots_per_aap
        finish[q] = done
        remaining[q] -= 1
        if remaining[q]:
            heapq.heappush(heap, (done, q))
    return (max(finish) if finish else 0), tuple(finish)


# ---------------------------------------------------------------------------
# Kernel stream: the [n, 19] micro-op table the AAP interpreter replays
# ---------------------------------------------------------------------------
#
#   col 0        kind: 0 = pass-through (COPY/COPY2), 1 = DRA, 2 = TRA
#   cols 1..6    three read slots as (state_row, BL-bar) pairs
#   cols 7..18   four write slots as (state_row, BL-bar, enable) triples
#
# DCC word-lines (>= n_rows) resolve statically: cell A/B are the two state
# rows past the normal rows, odd offsets flag the complemented bit-line.
# Write slots follow instruction-arg order: DRA/TRA end their sources at
# the BL level too (Fig. 6), and a later slot to the same row wins.

KSTREAM_COLS = 19
KSTREAM_KIND_COPY, KSTREAM_KIND_DRA, KSTREAM_KIND_TRA = 0, 1, 2

_KSTREAM_READS = {OP_COPY: (0,), OP_COPY2: (0,),
                  OP_DRA: (0, 1), OP_TRA: (0, 1, 2)}
_KSTREAM_WRITES = {OP_COPY: (1,), OP_COPY2: (1, 2),
                   OP_DRA: (0, 1, 2), OP_TRA: (0, 1, 2, 3)}
_KSTREAM_KIND = {OP_COPY: KSTREAM_KIND_COPY, OP_COPY2: KSTREAM_KIND_COPY,
                 OP_DRA: KSTREAM_KIND_DRA, OP_TRA: KSTREAM_KIND_TRA}


def dcc_state_rows(n_rows: int) -> int:
    """State rows behind a template with `n_rows` normal word-lines: the
    normal rows plus the two DCC cells (A, B)."""
    return n_rows + 2


def kstream_slot(wl: int, n_rows: int) -> Tuple[int, int]:
    """Word-line address -> (state row, BL-bar flag)."""
    if wl < n_rows:
        return wl, 0
    off = wl - n_rows
    return n_rows + off // 2, off % 2


def encode_kernel_stream(program: Sequence[AAP], *,
                         n_rows: int) -> np.ndarray:
    """Lower an AAP program to the int32 [n, 19] micro-op table."""
    out = np.zeros((len(program), KSTREAM_COLS), np.int32)
    for i, ins in enumerate(program):
        out[i, 0] = _KSTREAM_KIND[ins.op]
        for k, pos in enumerate(_KSTREAM_READS[ins.op]):
            row, neg = kstream_slot(ins.args[pos], n_rows)
            out[i, 1 + 2 * k] = row
            out[i, 2 + 2 * k] = neg
        for k, pos in enumerate(_KSTREAM_WRITES[ins.op]):
            row, neg = kstream_slot(ins.args[pos], n_rows)
            out[i, 7 + 3 * k] = row
            out[i, 8 + 3 * k] = neg
            out[i, 9 + 3 * k] = 1
    return out


# ---------------------------------------------------------------------------
# Interpreters
# ---------------------------------------------------------------------------

def _step(sa: SubArray, ins: Sequence[int]) -> SubArray:
    """One encoded instruction [op, a0, a1, a2, a3], in place."""
    op, a = ins[0], ins[1:]
    if op == OP_COPY:
        return aap_copy(sa, a[0], a[1])
    if op == OP_COPY2:
        return aap_copy2(sa, a[0], a[1], a[2])
    if op == OP_DRA:
        return aap_dra(sa, a[0], a[1], a[2])
    return aap_tra(sa, a[0], a[1], a[2], a[3])


def _step_flipped(sa: SubArray, ins: Sequence[int],
                  mask: torch.Tensor) -> SubArray:
    """A DRA or TRA whose charge-shared BL value carries an injected flip:
    every word-line the AAP touches sees the same wrong level."""
    op, a = ins[0], ins[1:]
    if op == OP_DRA:
        return _write_all(sa, a[:3], _dra_bl(sa, a[0], a[1]) ^ mask)
    return _write_all(sa, a[:4], _tra_bl(sa, a[0], a[1], a[2]) ^ mask)


def _force_stuck(sa: SubArray, stuck) -> SubArray:
    """Pin stuck-at word-lines to their constant (normal rows only), in
    place."""
    for wl, v in stuck:
        sa.data[..., wl, :] = -1 if v else 0
    return sa


def run_program(sa: SubArray, encoded, *, faults=None, slot_id=None,
                copy: bool = True) -> SubArray:
    """Step an encoded [n, 5] command stream over `sa` (the reference's
    `lax.scan`, here a Python loop over the host copy of the stream).
    `sa` may batch slots in leading dimensions.  It is copied once and
    the copy is updated in place, so the caller's state is untouched;
    `copy=False` updates `sa` itself.

    With a `FaultModel`, every DRA/TRA draws a counter-based flip mask
    from (seed, op index, slot_id) before its write-back, identical to
    the flips the unrolled and kernel interpreters draw for the same
    slot.  `slot_id` (default 0) broadcasts against the leading
    dimensions of `sa`.
    """
    program = (encoded.tolist() if isinstance(encoded, torch.Tensor)
               else [list(ins) for ins in encoded])
    state = (SubArray(data=sa.data.clone(), dcc=sa.dcc.clone()) if copy
             else sa)
    if faults is not None:
        faults = faults.wave_model()
    if faults is None:
        for ins in program:
            _step(state, ins)
        return state

    dev = state.data.device
    slot_h = mix32(as_u32(0 if slot_id is None else slot_id, dev)
                   ^ faults.seed)[..., None]
    word_ids = torch.arange(state.words, dtype=torch.int64, device=dev)
    n_pos = state.words * WORD_BITS
    prot = set(faults.protected_ops)
    thresholds = {OP_DRA: faults.dra_thresh, OP_TRA: faults.tra_thresh}
    stuck = tuple((wl, v) for wl, v in faults.stuck_rows
                  if wl < state.n_rows)
    _force_stuck(state, stuck)
    for i, ins in enumerate(program):
        t = 0 if i in prot else thresholds.get(ins[0], 0)
        if t:
            _step_flipped(state, ins,
                          fault_mask(t, i, slot_h, word_ids, n_pos))
        else:
            _step(state, ins)
        _force_stuck(state, stuck)
    return state


def run_program_py(sa: SubArray, program: Sequence[AAP]) -> SubArray:
    """Eager interpreter over `AAP` records; updates `sa` in place."""
    for ins in program:
        _step(sa, (ins.op,) + tuple(ins.args))
    return sa


def run_program_unrolled(program: Sequence[AAP], rows: Dict[int, torch.Tensor],
                         dcc: Dict[int, torch.Tensor], *, n_rows: int,
                         zeros: torch.Tensor, faults=None, slot_hash=None):
    """Replay a program over per-row int32 tensors (the "resident" engine).

    rows: {word_line: [..., words]} data + x rows present so far; dcc:
    {cell: [...]} DCC cells A (0) and B (1).  A word-line never written
    reads as `zeros` (a fresh sub-array).  Addresses >= n_rows are the
    dcc1..dcc4 word-lines.  Only the rows an instruction names are
    touched.  Mutates and returns (rows, dcc).

    faults / slot_hash: an optional `FaultModel` plus the precomputed
    `mix32(slot_id ^ seed)` (int64, broadcastable against the row word
    axis).  Op indices are known here, so protected ops and zero
    thresholds cost nothing.
    """
    def read(wl: int) -> torch.Tensor:
        if wl < n_rows:
            return rows.get(wl, zeros)
        off = wl - n_rows
        v = dcc.get(off // 2, zeros)
        return ~v if off % 2 else v

    def write(wl: int, bl: torch.Tensor) -> None:
        if wl < n_rows:
            rows[wl] = bl
        else:
            off = wl - n_rows
            dcc[off // 2] = ~bl if off % 2 else bl

    if faults is not None:
        faults = faults.wave_model()
    flip = None
    stuck = ()
    if faults is not None:
        words = zeros.shape[-1]
        n_pos = words * WORD_BITS
        word_ids = torch.arange(words, dtype=torch.int64,
                                device=zeros.device)
        slot_h = (slot_hash if slot_hash is not None
                  else mix32(faults.seed))
        prot = set(faults.protected_ops)
        thresholds = {OP_DRA: faults.dra_thresh, OP_TRA: faults.tra_thresh}
        stuck = tuple((wl, v) for wl, v in faults.stuck_rows
                      if wl < n_rows)
        ones = ~zeros

        def flip(i: int, op: int, bl: torch.Tensor) -> torch.Tensor:
            t = thresholds[op]
            if t == 0 or i in prot:
                return bl
            return bl ^ fault_mask(t, i, slot_h, word_ids, n_pos)

        for wl, v in stuck:
            rows[wl] = ones if v else zeros

    for i, ins in enumerate(program):
        a = ins.args
        if ins.op == OP_COPY:
            write(a[1], read(a[0]))
        elif ins.op == OP_COPY2:
            bl = read(a[0])
            write(a[1], bl)
            write(a[2], bl)
        else:
            if ins.op == OP_DRA:
                bl = ~(read(a[0]) ^ read(a[1]))
            else:
                x, y, z = read(a[0]), read(a[1]), read(a[2])
                bl = (x & y) | (x & z) | (y & z)
            if flip is not None:
                bl = flip(i, ins.op, bl)
            for wl in a:            # sources end at the BL level (Fig. 6)
                write(wl, bl)
        for wl, v in stuck:
            rows[wl] = ones if v else zeros
    return rows, dcc


# ---------------------------------------------------------------------------
# Table-2 microprograms.  Addresses are word-line numbers; the template
# resolves the x1..x8 / dcc1..dcc4 aliases.
# ---------------------------------------------------------------------------

def microprogram_copy(sa: SubArray, d_i: int, d_r: int) -> List[AAP]:
    return [AAP(OP_COPY, (d_i, d_r))]


def microprogram_not(sa: SubArray, d_i: int, d_r: int) -> List[AAP]:
    # AAP(D_i, dcc2): cell A <- NOT(D_i) via BL-bar; AAP(dcc1, D_r): read back.
    return [AAP(OP_COPY, (d_i, sa.wl_dcc(2))),
            AAP(OP_COPY, (sa.wl_dcc(1), d_r))]


def microprogram_maj3(sa: SubArray, d_i: int, d_j: int, d_k: int,
                      d_r: int) -> List[AAP]:
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_COPY, (d_k, sa.wl_x(3))),
            AAP(OP_TRA, (sa.wl_x(1), sa.wl_x(2), sa.wl_x(3), d_r))]


def microprogram_min3(sa: SubArray, d_i: int, d_j: int, d_k: int,
                      d_r: int) -> List[AAP]:
    """MIN3 = NOT(MAJ3) using a DCC destination (Table 2 footnote)."""
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_COPY, (d_k, sa.wl_x(3))),
            AAP(OP_TRA, (sa.wl_x(1), sa.wl_x(2), sa.wl_x(3), sa.wl_dcc(2))),
            AAP(OP_COPY, (sa.wl_dcc(1), d_r))]


def microprogram_xnor2(sa: SubArray, d_i: int, d_j: int,
                       d_r: int) -> List[AAP]:
    """3 AAPs: the paper's single-cycle DRA, no initialization."""
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_DRA, (sa.wl_x(1), sa.wl_x(2), d_r))]


def microprogram_xor2(sa: SubArray, d_i: int, d_j: int,
                      d_r: int) -> List[AAP]:
    """XOR2 = DRA with the result taken from BL-bar through a DCC cell."""
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_DRA, (sa.wl_x(1), sa.wl_x(2), sa.wl_dcc(2))),
            AAP(OP_COPY, (sa.wl_dcc(1), d_r))]


def microprogram_add(sa: SubArray, d_i: int, d_j: int, d_k: int,
                     sum_r: int, cout_r: int) -> List[AAP]:
    """Full-adder bit-slice, exactly Table 2 (7 AAPs): Sum by two
    back-to-back DRA-XOR2 through the DCC cells, Cout = MAJ3 by TRA."""
    return [
        AAP(OP_COPY2, (d_i, sa.wl_x(1), sa.wl_x(2))),
        AAP(OP_COPY2, (d_j, sa.wl_x(3), sa.wl_x(4))),
        AAP(OP_COPY2, (d_k, sa.wl_x(5), sa.wl_x(6))),
        AAP(OP_DRA, (sa.wl_x(2), sa.wl_x(4), sa.wl_dcc(2))),
        AAP(OP_DRA, (sa.wl_x(6), sa.wl_dcc(1), sa.wl_dcc(4))),
        AAP(OP_COPY, (sa.wl_dcc(3), sum_r)),
        AAP(OP_TRA, (sa.wl_x(1), sa.wl_x(3), sa.wl_x(5), cout_r)),
    ]


def multibit_add_program(sa: SubArray, a_rows: Sequence[int],
                         b_rows: Sequence[int], cin_row: int,
                         sum_rows: Sequence[int], carry_rows: Sequence[int],
                         ) -> List[AAP]:
    """Ripple-carry N-bit adder over bit-plane rows (LSB first).

    a_rows[i], b_rows[i] hold bit i of every element in the row;
    carry_rows[i] receives the carry out of slice i and feeds slice i+1.
    7 AAPs per bit-slice (Table 2 full adder)."""
    if not (len(a_rows) == len(b_rows) == len(sum_rows) == len(carry_rows)):
        raise ValueError("bit-plane row lists must have equal length")
    prog: List[AAP] = []
    carry = cin_row
    for a, b, s, c in zip(a_rows, b_rows, sum_rows, carry_rows):
        prog += microprogram_add(sa, a, b, carry, s, c)
        carry = c
    return prog


def microprogram_and2(sa: SubArray, d_i: int, d_j: int, zero_row: int,
                      d_r: int) -> List[AAP]:
    """AND2 on TRA with an initialized control row (Ambit-style)."""
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_COPY, (zero_row, sa.wl_x(3))),
            AAP(OP_TRA, (sa.wl_x(1), sa.wl_x(2), sa.wl_x(3), d_r))]


def microprogram_or2(sa: SubArray, d_i: int, d_j: int, one_row: int,
                     d_r: int) -> List[AAP]:
    return [AAP(OP_COPY, (d_i, sa.wl_x(1))),
            AAP(OP_COPY, (d_j, sa.wl_x(2))),
            AAP(OP_COPY, (one_row, sa.wl_x(3))),
            AAP(OP_TRA, (sa.wl_x(1), sa.wl_x(2), sa.wl_x(3), d_r))]


# Canonical AAP counts used by the timing/energy models (paper Table 2).
AAP_COUNTS = {
    "copy": 1,
    "not": 2,
    "maj3": 4,
    "xnor2": 3,
    "xor2": 4,      # +1 AAP to read the BL-bar result back out of the DCC
    "add": 7,
}
