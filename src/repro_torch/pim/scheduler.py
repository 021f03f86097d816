"""Bulk-op scheduler: tile word operands onto the simulated DRIM fleet and
replay an AAP stream wave by wave (port of `repro.pim.scheduler`).

Operands are tiled into `row_bits`-wide rows, assigned to (chip, bank,
subarray) slots, and every active sub-array runs the same program in
lock-step.  Four wave engines share the staging and the cost model:

  * "resident" (default): plain torch.  `isa.run_program_unrolled`
    replays the stream over per-row tensors that span every wave at once,
    touching only the rows the program names; readback gathers only the
    result rows.
  * "queued": the resident body, run by `pim.queue` once per bank queue
    over that queue's block of banks, one program per queue.
  * "baseline": the reference's first wave loop -- per wave a fresh full
    device state (`core.device`), the encoded [n, 5] stream stepped over
    it by `isa.run_program`, `device_read_rows` readback.  Slow, and kept
    as the engine the other two are held against.
  * "cuda": the stream stays data.  `isa.encode_kernel_stream` lowers it
    once and the AAP interpreter kernel (`kernels.aap_interpreter`)
    replays it over every word column of every wave in one launch; on CPU
    tensors the kernel's plain replay runs instead.

With a fleet mesh (`pim.mesh.fleet_mesh`), "resident" runs each (chips,
banks) block of the staged payload on its mesh device and concatenates the
readbacks in order (`core.mesh.map_blocks`): the unsharded words by
construction.  "baseline" drops the mesh, as the reference does.

With a `core.faults.FaultModel` every engine draws the same flips for the
same (seed, op index, global slot): the slot hash has no wave index, so
every wave draws the same flips, and the all-waves-at-once bodies
broadcast it over the wave axis.

Cost accounting is measured from the executed stream: `aaps_per_tile` is
the program length, latency is `waves x aaps_per_tile x t_AAP`.

Telemetry (`runtime.telemetry`): the encode memo's stats are the
registry's "encode_cache" namespace, and a faulted `run_waves` books its
armed fault sites under "faults" once per wave-runner signature, as the
reference does.  The reference's ``TRACE_COUNTS`` ("wave_trace", the jit
traces of its wave body) is left out: torch runs the body eagerly, and
nothing here is traced or compiled per signature ("cuda" memoizes its
packed stream, a host-side build, which is not a trace).

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
import contextlib
import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import (AAP, DRIM_R, DrimGeometry, encode,
                              make_subarray, microprogram_add,
                              microprogram_copy, microprogram_maj3,
                              microprogram_not, microprogram_xnor2,
                              microprogram_xor2, run_program_unrolled)
from repro_torch.core.device import (_device_run_program, device_load_rows,
                                     device_read_rows, make_device)
from repro_torch.core.energy import E_AAP_NJ_PER_KB
from repro_torch.core.faults import mix32, slot_ids_grid
from repro_torch.core.mesh import map_blocks
from repro_torch.core.subarray import N_XROWS, WORD_BITS, as_words
from repro_torch.pim.mesh import STAGED_SPEC, shard_staged
from repro_torch.runtime import telemetry

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

ENGINES = ("resident", "baseline", "queued", "cuda")


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
# bounded LRU.  The stats counter lets tests see the hit path taken.  It
# IS the telemetry registry's "encode_cache" namespace (the same Counter
# object), so one `telemetry.snapshot()` sees it and `telemetry.fresh()`
# scopes it.
ENCODE_CACHE_STATS: collections.Counter = \
    telemetry.REGISTRY.counters("encode_cache")
_ENCODED_CACHE: Dict = {}
_ENCODED_TUPLE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_ENCODED_TUPLE_CACHE_MAX = 512


def encoded_program(op, *, queue: int | None = None,
                    materialize: bool = True,
                    ) -> Tuple[torch.Tensor | None, Tuple[AAP, ...], int]:
    """Cached (encoded [n, 5] stream, program tuple, n_aaps).

    `op` is an op name or a sequence of `AAP`s (fused graph streams and
    per-bank queue programs memoize through the same stats).  `queue`
    additionally books the hit or miss under ``q{queue}:hits`` /
    ``q{queue}:misses``.  `materialize=False` skips building the encoded
    tensor; a later materializing call fills it in place."""
    key = op if isinstance(op, str) else tuple(op)
    cache = _ENCODED_CACHE if isinstance(key, str) else _ENCODED_TUPLE_CACHE
    hit = cache.get(key)
    kind = "hits" if hit is not None else "misses"
    ENCODE_CACHE_STATS[kind] += 1
    if queue is not None:
        ENCODE_CACHE_STATS[f"q{queue}:{kind}"] += 1
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


@contextlib.contextmanager
def fresh_encode_cache():
    """Run a block against an EMPTY encode memo and stats counter, then
    restore the process-wide state untouched: inside it the first issue
    of any program is a miss and repeats are hits, in any test order.
    Yields the (cleared) stats counter.

    The stats side is the registry's "encode_cache" namespace, restored
    in place, so this context composes with an enclosing
    `telemetry.fresh()`."""
    saved_ops = dict(_ENCODED_CACHE)
    saved_tuples = collections.OrderedDict(_ENCODED_TUPLE_CACHE)
    _ENCODED_CACHE.clear()
    _ENCODED_TUPLE_CACHE.clear()
    try:
        with telemetry.REGISTRY.fresh_namespace("encode_cache") as stats:
            yield stats
    finally:
        _ENCODED_CACHE.clear()
        _ENCODED_CACHE.update(saved_ops)
        _ENCODED_TUPLE_CACHE.clear()
        _ENCODED_TUPLE_CACHE.update(saved_tuples)


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
            result_rows: Tuple[int, ...], n_rows: int, faults=None,
            bank_geom=None):
    """The wave function of one engine for one program.

    Returns `run(staged)` mapping a staged payload [waves, n_rows_in,
    chips, banks, subarrays, row_words] to the readback block [waves,
    len(result_rows), ...].  Torch runs eagerly, so unlike the reference's
    per-wave body under `lax.map` the resident and cuda bodies cover the
    wave axis at once: waves are independent (each starts from a fresh
    sub-array).  The baseline body loops over the waves, a fresh device
    state each.  "queued" is the resident body (`pim.queue` maps it over
    per-bank payloads, one program per queue).

    faults: an optional `FaultModel` (its `wave_model()` is what runs; an
    inactive model is the fault-free path).  `bank_geom` = (bank_lo,
    banks_total) anchors a payload that holds a slice of the banks at its
    physical bank offset, so it draws the full fleet's flips.
    """
    if faults is not None:
        faults = faults.wave_model()
    if faults is None:
        bank_geom = None
    bank_lo, banks_total = bank_geom if bank_geom is not None else (0, None)
    if engine == "cuda":
        from repro_torch.kernels.aap_interpreter import cuda_wave_fn
        return cuda_wave_fn(tuple(program), tuple(result_rows), n_rows,
                            faults=faults, bank_geom=bank_geom)
    if engine == "baseline":
        encoded = encode(program)

        def run_baseline(staged: torch.Tensor) -> torch.Tensor:
            _, _, c, b, s, w = staged.shape
            outs = []
            for tiles in staged:
                dev = make_device(chips=c, banks=b, subarrays=s,
                                  n_data=n_rows - N_XROWS, row_bits=w * 32,
                                  device=staged.device)
                dev = device_load_rows(dev, 0, tiles.movedim(0, 3))
                out = _device_run_program(dev, encoded, faults,
                                          bank_lo=bank_lo,
                                          banks_total=banks_total,
                                          donate=True)
                outs.append(device_read_rows(out, result_rows))
            return torch.stack(outs)
        return run_baseline
    if engine not in ("resident", "queued"):
        raise ValueError(f"unknown wave engine {engine!r} "
                         f"(registered: {', '.join(ENGINES)})")

    def run(staged: torch.Tensor) -> torch.Tensor:
        zeros = torch.zeros_like(staged[:, 0])
        rows = {wl: staged[:, wl] for wl in range(staged.shape[1])}
        slot_hash = None
        if faults is not None:
            _, _, c, b, s, _ = staged.shape
            grid = slot_ids_grid(c, b, s, bank_lo=bank_lo,
                                 banks_total=banks_total,
                                 device=staged.device)
            slot_hash = mix32(grid ^ faults.seed)[..., None]
        rows, _ = run_program_unrolled(program, rows, {}, n_rows=n_rows,
                                       zeros=zeros, faults=faults,
                                       slot_hash=slot_hash)
        return torch.stack([rows.get(r, zeros) for r in result_rows], dim=1)
    return run


def run_waves(staged: torch.Tensor, program: Sequence[AAP],
              result_rows: Tuple[int, ...], *, n_rows: int, mesh=None,
              engine: str = "resident", faults=None,
              bank_geom=None) -> torch.Tensor:
    """Execute every wave of a staged payload.

    staged: [waves, n_rows_in, chips, banks, subarrays, row_words] int32;
    wave w holds its tile block in word-lines [0, n_rows_in).  `program`
    addresses were resolved against a template with `n_rows` normal rows
    (addresses >= n_rows are DCC word-lines).  `faults` and `bank_geom`
    as in `wave_fn`.  `mesh` (from `pim.mesh.fleet_mesh`) runs the wave
    function on each (chips, banks) block on its mesh device; a mesh
    with active faults raises the verifier's V020 diagnostic, and
    "baseline" drops the mesh.

    Returns [waves, len(result_rows), chips, banks, subarrays, row_words].
    """
    program, result_rows = tuple(program), tuple(result_rows)
    wave_faults = faults.wave_model() if faults is not None else None
    if wave_faults is not None:
        if mesh is not None:
            # V020_FAULTS_UNSUPPORTED_ON_MESH, the diagnostic the verify
            # pass also raises at lower time (verify sits above the
            # scheduler in the module graph).
            from repro_torch.pim.verify import faults_on_mesh_error
            raise faults_on_mesh_error()
        _book_fault_census(engine, program, result_rows, n_rows,
                           wave_faults, bank_geom)
    fn = wave_fn(engine, program, result_rows, n_rows, faults, bank_geom)
    if mesh is None or engine == "baseline":
        return fn(staged)
    return map_blocks(mesh, fn, (staged,), STAGED_SPEC)


def run_waves_baseline(staged: torch.Tensor, program: Sequence[AAP],
                       result_rows: Tuple[int, ...], *,
                       n_rows: int) -> torch.Tensor:
    """The reference's first wave loop (per wave a full device state, the
    encoded stream stepped over it), kept as the engine the others are
    held against: `run_waves(..., engine="baseline")`."""
    return run_waves(staged, program, result_rows, n_rows=n_rows,
                     engine="baseline")


@functools.lru_cache(maxsize=512)
def _book_fault_census(engine: str, program: Tuple[AAP, ...],
                       result_rows: Tuple[int, ...], n_rows: int,
                       faults, bank_geom) -> None:
    """Book the armed fault-site census of a faulted wave runner once per
    build: how many DRA/TRA instances of this program can draw flips on
    this engine (registry namespace "faults", ``{engine}:armed_{kind}``).
    The reference books it where it builds its compiled runner, memoized
    in an LRU of 512 per (engine, program, readback, rows, faults, bank
    offset) and its mesh and buffer donation, which the port does not
    have; so the same sequence of runs books the same counts.  This memo
    holds faulted signatures only (a fault-free run books nothing and
    skips the key's hash), so the two part only past 512 live
    signatures."""
    for kind, n in faults.count_faultable(program).items():
        if n:
            telemetry.REGISTRY.counters("faults")[
                f"{engine}:armed_{kind}"] += n


def stage_rows(arrays: Sequence[torch.Tensor], *, geom: DrimGeometry,
               mesh=None) -> Tuple[torch.Tensor, int, int]:
    """Tile flat int32 word arrays onto the fleet: pad to a whole number of
    waves and reshape to [waves, n_arrays, chips, banks, subarrays,
    row_words] on the arrays' device, shard-aligned over `mesh` when given
    (a mesh that does not divide (chips, banks) raises ValueError).
    Returns (staged, tiles, waves)."""
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
    staged = staged.transpose(0, 1).contiguous()
    if mesh is not None:
        shard_staged(staged, mesh)
    return staged, tiles, waves


def dispatch_waves(engine: str, arrays: Sequence[torch.Tensor],
                   program: Sequence[AAP], result_rows: Tuple[int, ...], *,
                   n_rows: int, geom: DrimGeometry, mesh=None,
                   n_queues: int | None = None, faults=None,
                   ) -> Tuple[torch.Tensor, int, int]:
    """One dispatch point for every device wave engine: the engine's own
    staging (`pim.compiler.ENGINE_REGISTRY`) and the shared wave body
    (`wave_fn`).  Returns (outs, tiles, waves) with outs [waves,
    len(result_rows), chips, banks, subarrays, row_words] on the arrays'
    device.  A comparator engine ("gpu") has no waves and raises."""
    from repro_torch.pim.compiler import get_engine
    eng = get_engine(engine)
    if not eng.device:
        raise ValueError(f"engine {engine!r} is a comparator, not a "
                         "device wave engine")
    return eng.dispatch(arrays, program, result_rows, n_rows=n_rows,
                        geom=geom, mesh=mesh, n_queues=n_queues,
                        faults=faults)


def execute(op: str, *operands, geom: DrimGeometry = DRIM_R,
            n_bits: int | None = None, mesh=None, engine: str = "resident",
            n_queues: int | None = None, device=None,
            ) -> Tuple[Tuple[torch.Tensor, ...], Schedule]:
    """DEPRECATED shim over the staged pipeline.

    Use ``compile(op, geom=geom).lower(engine=..., mesh=...,
    n_queues=...).run(*operands, n_bits=..., device=...)``: the lowering
    is reusable across payloads and its measured schedule lands on
    ``lowered.schedule``.  This wrapper lowers per call and returns
    (results, schedule) on `device` (None: the card)."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated(
        "scheduler.execute",
        "compile(op).lower(engine=..., mesh=..., n_queues=...).run(...)")
    low = _compile(op, geom=geom).lower(engine=engine, mesh=mesh,
                                        n_queues=n_queues)
    results = low.run(*operands, n_bits=n_bits, device=device)
    return results, low.schedule


def execute_oplist(ops: Sequence[Tuple[str, Tuple]], *,
                   geom: DrimGeometry = DRIM_R, mesh=None,
                   engine: str = "resident", n_queues: int | None = None,
                   device=None,
                   ) -> List[Tuple[Tuple[torch.Tensor, ...], Schedule]]:
    """DEPRECATED shim over the staged pipeline: the unfused baseline,
    every op reloading its operands and reading its results back.  Lower
    each op (or trace the whole chain with `jit`, so it fuses); this
    wrapper keeps the [(results, schedule), ...] contract."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated("scheduler.execute_oplist",
                     "compile(op).lower(...).run(...) per op, or "
                     "drim.jit over the whole chain")
    out = []
    for op, args in ops:
        low = _compile(op, geom=geom).lower(engine=engine, mesh=mesh,
                                            n_queues=n_queues)
        res = low.run(*args, device=device)
        out.append((res, low.schedule))
    return out
