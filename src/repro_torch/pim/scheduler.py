"""Bulk-op scheduler: tile word operands onto the simulated DRIM fleet and
replay an AAP stream wave by wave (port of `repro.pim.scheduler`,
fault-free and unsharded).

Operands are tiled into `row_bits`-wide rows, assigned to (chip, bank,
subarray) slots, and every active sub-array runs the same program in
lock-step.  Two wave engines share the staging and the cost model:

  * "resident" (default): plain torch.  `isa.run_program_unrolled`
    replays the stream over per-row tensors that span every wave at once,
    touching only the rows the program names; readback gathers only the
    result rows.
  * "cuda": the stream stays data.  `isa.encode_kernel_stream` lowers it
    once and the AAP interpreter kernel (`kernels.aap_interpreter`)
    replays it over every word column of every wave in one launch; on CPU
    tensors the kernel's plain replay runs instead.

Cost accounting is measured from the executed stream: `aaps_per_tile` is
the program length, latency is `waves x aaps_per_tile x t_AAP`.

Semantics per op (results read back from the Table-2 destination rows):
    copy  (a)       -> a
    not   (a)       -> ~a
    xnor2 (a, b)    -> ~(a ^ b)
    xor2  (a, b)    -> a ^ b
    maj3  (a, b, c) -> majority
    add   (a, b, c) -> (a ^ b ^ c, majority)   # full-adder bit-slice
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (AAP, DRIM_R, DrimGeometry, encode,
                              make_subarray, microprogram_add,
                              microprogram_copy, microprogram_maj3,
                              microprogram_not, microprogram_xnor2,
                              microprogram_xor2, run_program_unrolled)
from repro_torch.core.energy import E_AAP_NJ_PER_KB
from repro_torch.core.subarray import WORD_BITS, as_words

# Per-slot row layout: operands at word-lines [0, arity), results at the
# word-lines listed here.  8 data rows are plenty for every Table-2 op.
N_DATA_ROWS = 8

OP_ARITY: Dict[str, int] = {
    "copy": 1, "not": 1, "xnor2": 2, "xor2": 2, "maj3": 3, "add": 3,
}
RESULT_ROWS: Dict[str, Tuple[int, ...]] = {
    "copy": (1,), "not": (1,), "xnor2": (2,), "xor2": (2,),
    "maj3": (3,), "add": (3, 4),
}
# `kernels/ref.py` oracle name per bulk op (None -> identity).
REF_OP: Dict[str, str | None] = {
    "copy": None, "not": "not", "xnor2": "xnor", "xor2": "xor",
    "maj3": "maj3", "add": "fa",
}

ENGINES = ("resident", "cuda")


def random_operands(op: str, n_words: int, seed: int = 0) -> List[np.ndarray]:
    """Seeded uint32 word arrays with the right arity for `op`."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
            for _ in range(OP_ARITY[op])]


def expected_results(op: str, args: Sequence) -> Tuple[torch.Tensor, ...]:
    """Oracle results for `op` via `kernels/ref.py` as int32 tensors,
    aligned with RESULT_ROWS[op]."""
    from repro_torch.kernels.ref import bitwise_ref
    words = [as_words(a, "cpu") for a in args]
    if REF_OP[op] is None:
        return (words[0],)
    padded = tuple(words) + (None,) * (3 - len(words))
    out = bitwise_ref(REF_OP[op], *padded)
    return out if isinstance(out, tuple) else (out,)


_PROGRAM_CACHE: Dict[str, List[AAP]] = {}


def build_program(op: str) -> List[AAP]:
    """Table-2 microprogram for `op` over the scheduler's row layout
    (operands at rows 0..arity-1, results at RESULT_ROWS[op])."""
    if op not in OP_ARITY:
        raise ValueError(f"unknown bulk op {op!r}")
    if op not in _PROGRAM_CACHE:
        t = make_subarray(n_data=N_DATA_ROWS, row_bits=WORD_BITS)
        _PROGRAM_CACHE[op] = {
            "copy": lambda: microprogram_copy(t, 0, 1),
            "not": lambda: microprogram_not(t, 0, 1),
            "xnor2": lambda: microprogram_xnor2(t, 0, 1, 2),
            "xor2": lambda: microprogram_xor2(t, 0, 1, 2),
            "maj3": lambda: microprogram_maj3(t, 0, 1, 2, 3),
            "add": lambda: microprogram_add(t, 0, 1, 2, 3, 4),
        }[op]()
    return _PROGRAM_CACHE[op]


# Encoded-program memo.  Op-name keys are bounded by the Table-2 op count;
# program-tuple keys (fused graphs) are open-ended, so that side is a
# bounded LRU.  The stats counter lets tests see the hit path taken.
ENCODE_CACHE_STATS: collections.Counter = collections.Counter()
_ENCODED_CACHE: Dict = {}
_ENCODED_TUPLE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_ENCODED_TUPLE_CACHE_MAX = 512


def encoded_program(op, *, materialize: bool = True,
                    ) -> Tuple[torch.Tensor | None, Tuple[AAP, ...], int]:
    """Cached (encoded [n, 5] stream, program tuple, n_aaps).

    `op` is an op name or a sequence of `AAP`s.  `materialize=False`
    skips building the encoded tensor; a later materializing call fills
    it in place."""
    key = op if isinstance(op, str) else tuple(op)
    cache = _ENCODED_CACHE if isinstance(key, str) else _ENCODED_TUPLE_CACHE
    hit = cache.get(key)
    ENCODE_CACHE_STATS["hits" if hit is not None else "misses"] += 1
    if hit is not None:
        if cache is _ENCODED_TUPLE_CACHE:
            _ENCODED_TUPLE_CACHE.move_to_end(key)
        if hit[0] is None and materialize:
            hit = (encode(hit[1]), hit[1], hit[2])
            cache[key] = hit
        return hit
    prog = key if isinstance(key, tuple) else tuple(build_program(key))
    out = (encode(prog) if materialize else None, prog, len(prog))
    cache[key] = out
    if cache is _ENCODED_TUPLE_CACHE:
        while len(_ENCODED_TUPLE_CACHE) > _ENCODED_TUPLE_CACHE_MAX:
            _ENCODED_TUPLE_CACHE.popitem(last=False)
    return out


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Tiling + wave plan for one bulk op, with measured cost model.

    `tiles` counts only assigned tiles (idle slots in the last wave are
    never activated)."""

    op: str
    n_bits: int
    row_bits: int
    tiles: int
    slots: int             # concurrent (chip, bank, subarray) lanes
    waves: int
    aaps_per_tile: int     # length of the executed AAP stream per slot
    chips: int
    banks: int
    subarrays_per_bank: int
    t_aap_s: float

    @property
    def aaps_sequential(self) -> int:
        """Serialized AAP cycles on the command bus (waves back-to-back)."""
        return self.waves * self.aaps_per_tile

    @property
    def aaps_issued(self) -> int:
        """Total AAPs executed across all active sub-arrays."""
        return self.tiles * self.aaps_per_tile

    @property
    def latency_s(self) -> float:
        return self.aaps_sequential * self.t_aap_s

    @property
    def energy_j(self) -> float:
        row_kb = self.row_bits / 8.0 / 1024.0
        return self.aaps_issued * row_kb * E_AAP_NJ_PER_KB * 1e-9

    @property
    def active_subarrays(self) -> int:
        """Slots busy in the fullest wave."""
        return min(self.tiles, self.slots)

    @property
    def occupancy(self) -> float:
        """Fraction of wave x slot capacity holding real tiles."""
        return self.tiles / float(self.waves * self.slots)

    @property
    def throughput_bits_s(self) -> float:
        return self.n_bits / self.latency_s

    def parallelism_breakdown(self) -> Dict[str, float]:
        return {
            "chips": self.chips,
            "banks": self.banks,
            "subarrays_per_bank": self.subarrays_per_bank,
            "slots": self.slots,
            "tiles": self.tiles,
            "waves": self.waves,
            "active_subarrays": self.active_subarrays,
            "occupancy": self.occupancy,
        }


def plan_schedule(op: str, n_bits: int, *,
                  geom: DrimGeometry = DRIM_R) -> Schedule:
    """Closed-form schedule for an `n_bits` bulk op."""
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    _, _, n_aaps = encoded_program(op, materialize=False)
    tiles = _ceil_div(n_bits, geom.row_bits)
    slots = geom.n_subarrays
    return Schedule(
        op=op, n_bits=n_bits, row_bits=geom.row_bits, tiles=tiles,
        slots=slots, waves=_ceil_div(tiles, slots),
        aaps_per_tile=n_aaps, chips=geom.chips, banks=geom.banks,
        subarrays_per_bank=geom.subarrays_per_bank, t_aap_s=geom.t_aap_s,
    )


def wave_fn(engine: str, program: Tuple[AAP, ...],
            result_rows: Tuple[int, ...], n_rows: int):
    """The wave function of one engine for one program.

    Returns `run(staged)` mapping a staged payload [waves, n_rows_in,
    chips, banks, subarrays, row_words] to the readback block [waves,
    len(result_rows), ...].  Torch runs eagerly, so unlike the reference's
    per-wave body under `lax.map` this covers the wave axis at once:
    waves are independent (each starts from a fresh sub-array).
    """
    if engine == "cuda":
        from repro_torch.kernels.aap_interpreter import cuda_wave_fn
        return cuda_wave_fn(tuple(program), tuple(result_rows), n_rows)
    if engine != "resident":
        raise ValueError(f"unknown wave engine {engine!r} "
                         f"(registered: {', '.join(ENGINES)})")

    def run(staged: torch.Tensor) -> torch.Tensor:
        zeros = torch.zeros_like(staged[:, 0])
        rows = {wl: staged[:, wl] for wl in range(staged.shape[1])}
        rows, _ = run_program_unrolled(program, rows, {}, n_rows=n_rows,
                                       zeros=zeros)
        return torch.stack([rows.get(r, zeros) for r in result_rows], dim=1)
    return run


def run_waves(staged: torch.Tensor, program: Sequence[AAP],
              result_rows: Tuple[int, ...], *, n_rows: int,
              engine: str = "resident") -> torch.Tensor:
    """Execute every wave of a staged payload.

    staged: [waves, n_rows_in, chips, banks, subarrays, row_words] int32;
    wave w holds its tile block in word-lines [0, n_rows_in).  `program`
    addresses were resolved against a template with `n_rows` normal rows
    (addresses >= n_rows are DCC word-lines).

    Returns [waves, len(result_rows), chips, banks, subarrays, row_words].
    """
    return wave_fn(engine, tuple(program), tuple(result_rows), n_rows)(staged)


def stage_rows(arrays: Sequence[torch.Tensor], *, geom: DrimGeometry,
               ) -> Tuple[torch.Tensor, int, int]:
    """Tile flat int32 word arrays onto the fleet: pad to a whole number of
    waves and reshape to [waves, n_arrays, chips, banks, subarrays,
    row_words] on the arrays' device.  Returns (staged, tiles, waves)."""
    n_words = arrays[0].shape[0]
    row_w = geom.row_bits // WORD_BITS
    tiles = _ceil_div(n_words, row_w)
    waves = _ceil_div(tiles, geom.n_subarrays)
    per_wave = geom.n_subarrays * row_w
    flat = torch.zeros((len(arrays), waves * per_wave), dtype=torch.int32,
                       device=arrays[0].device)
    flat[:, :n_words] = torch.stack(list(arrays))
    staged = flat.view(len(arrays), waves, geom.chips, geom.banks,
                       geom.subarrays_per_bank, row_w)
    return staged.transpose(0, 1).contiguous(), tiles, waves
