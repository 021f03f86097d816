"""Asynchronous per-bank command queues: MIMD execution on the fleet (port
of `repro.pim.queue`).

Every other engine is lock-step SIMD: all (chip, bank, subarray) slots run
the SAME AAP stream behind one program counter.  This module gives each
bank block its own command queue:

  * the bank axis is split into `n_queues` contiguous blocks, each with
    its OWN AAP stream, program counter and issue-cycle clock;
  * `run_waves_queued` runs every queue's stream over its block's payload
    through the shared `scheduler.wave_fn` body: "queued" (plain torch,
    the resident body) or "cuda" (one AAP interpreter launch per queue);
  * `QueueSchedule` extends the fused cost model with what independent
    clocks expose: per-queue busy cycles, shared command-bus contention
    (`isa.simulate_bus_issue`: a channel issues `CMDS_PER_AAP` commands
    per AAP out of the `CMD_SLOTS_PER_AAP` slots of its envelope, so ~36
    queues saturate a DDR4 channel), and host DMA double-buffered behind
    compute instead of serialized after it.

With every queue running the same program this is exactly the SIMD
engines (`dispatch_uniform_queued`, held bit-identical to "resident").
The point of independent counters is `_execute_partitioned`:
`graph.partition_graph` splits ONE BulkGraph across queues into per-bank
sub-programs separated by cross-bank fences, so different bank blocks run
DIFFERENT programs, and latency is the fence-staged critical path (the
sum over stages of the slowest queue) instead of the whole node list.
Dead queues (`FaultModel.dead_queues`) are found at the fence and their
segments requeued on survivor bank blocks, exactly.

With a fleet mesh, every queue's payload runs block by block over
`queue_mesh`'s devices (`core.mesh.map_blocks`), the unsharded words by
construction; faults with a mesh raise, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import (AAP, CMDS_PER_AAP, DRIM_R, DrimGeometry,
                              FaultModel, simulate_bus_issue)
from repro_torch.core.mesh import map_blocks
from repro_torch.core.subarray import WORD_BITS
from repro_torch.core.timing import CMD_SLOTS_PER_AAP, ddr_rows_s
from repro_torch.pim.graph import (DEFAULT_ROW_BUDGET, BulkGraph,
                                   FusedSchedule, GraphPartition,
                                   QueueSegment, partition_graph)
from repro_torch.pim.mesh import STAGED_SPEC, fleet_mesh, shard_staged
from repro_torch.pim.scheduler import (N_DATA_ROWS, OP_ARITY, RESULT_ROWS,
                                       _ceil_div, encoded_program,
                                       stage_rows, wave_fn)
from repro_torch.runtime import telemetry

# A queue per bank is the hardware concept, but blocks of banks behind one
# controller clock are indistinguishable from single banks.  Default: one
# queue per bank, capped at this many queue blocks.
DEFAULT_MAX_QUEUES = 8


def default_n_queues(geom: DrimGeometry) -> int:
    """Largest divisor of the bank count <= DEFAULT_MAX_QUEUES."""
    return max(d for d in range(1, min(geom.banks, DEFAULT_MAX_QUEUES) + 1)
               if geom.banks % d == 0)


def resolve_n_queues(geom: DrimGeometry, n_queues: Optional[int]) -> int:
    if n_queues is None:
        return default_n_queues(geom)
    if not 1 <= n_queues <= geom.banks or geom.banks % n_queues:
        raise ValueError(
            f"n_queues={n_queues} must divide the bank count {geom.banks}")
    return n_queues


def bank_blocks(banks: int, n_queues: int) -> Tuple[Tuple[int, int], ...]:
    """Contiguous [lo, hi) bank block per queue."""
    if banks % n_queues:
        raise ValueError(f"{n_queues} queues do not divide {banks} banks")
    w = banks // n_queues
    return tuple((q * w, (q + 1) * w) for q in range(n_queues))


def queue_mesh(geom: DrimGeometry, n_queues: int, mesh=None):
    """A fleet mesh compatible with per-queue payloads.

    Queue payloads carry `banks / n_queues` banks, so a caller's fleet mesh
    (built for the whole bank axis) generally cannot cut them.  Rebuild it
    over the same devices for the queue-block geometry: the largest
    (chips, banks) split that divides every queue's block.  `None` stays
    `None`.  One mesh cuts every queue's payload, so the queue blocks
    share the mesh's first devices, as in the reference."""
    if mesh is None:
        return None
    geom_q = dataclasses.replace(geom, banks=geom.banks // n_queues)
    return fleet_mesh(geom_q, devices=list(mesh.devices.flat))


def stage_rows_queued(arrays: Sequence[torch.Tensor], *,
                      geom: DrimGeometry, n_queues: int, mesh=None,
                      ) -> Tuple[Tuple[torch.Tensor, ...], int, int]:
    """Tile flat int32 word arrays onto the fleet's bank queues in one pad,
    tile and split pass: the per-queue payloads [waves, n_arrays, chips,
    banks_q, subarrays, row_words] are written directly, never the full
    staged array, in the same tile -> slot order as
    `scheduler.stage_rows`, each shard-aligned over `mesh` (a queue mesh,
    `queue_mesh`) when given.  Returns (staged_per_queue, tiles, waves)."""
    n_words = arrays[0].shape[0]
    row_w = geom.row_bits // WORD_BITS
    tiles = _ceil_div(n_words, row_w)
    waves = _ceil_div(tiles, geom.n_subarrays)
    per_wave = geom.n_subarrays * row_w
    flat = torch.zeros((len(arrays), waves * per_wave), dtype=torch.int32,
                       device=arrays[0].device)
    flat[:, :n_words] = torch.stack(list(arrays))
    tiled = flat.view(len(arrays), waves, geom.chips, geom.banks,
                      geom.subarrays_per_bank, row_w)
    staged_qs = tuple(tiled[:, :, :, lo:hi].transpose(0, 1).contiguous()
                      for lo, hi in bank_blocks(geom.banks, n_queues))
    if mesh is not None:                  # every queue's block is alike
        shard_staged(staged_qs[0], mesh)
    return staged_qs, tiles, waves


# ---------------------------------------------------------------------------
# The MIMD wave runner
# ---------------------------------------------------------------------------

def run_waves_queued(staged_qs: Sequence[torch.Tensor],
                     programs: Sequence[Sequence[AAP]],
                     result_rows: Sequence[Tuple[int, ...]],
                     n_rows: Sequence[int], *, mesh=None,
                     body_engine: str = "queued", faults=None,
                     bank_geoms=None, timings=None,
                     ) -> Tuple[torch.Tensor, ...]:
    """Execute one wave payload per bank queue, each under its own program
    stream and program counter.

    staged_qs[q]: [waves_q, n_rows_in_q, chips, banks_q, subarrays,
    row_words], queue q's tile block; `programs[q]` is its AAP stream,
    resolved against a template with `n_rows[q]` normal rows.  Queues need
    not agree on program length, staged rows or readback rows.  Every
    queue's stream goes through the `encoded_program` memo tagged with its
    queue id (``ENCODE_CACHE_STATS["q{q}:hits"]``).  `body_engine` picks
    each queue's wave body: "queued" (plain torch, no kernel) or "cuda"
    (one AAP interpreter launch per queue; its plain twin on CPU tensors).

    faults: None, one `FaultModel` for every queue, or one per queue
    (hardening may protect different op ranges per queue); `bank_geoms[q]`
    = (bank_lo, banks_total) anchors queue q's payload at its physical
    banks, so its flips match the SIMD engines'.  `mesh` (a queue-block
    mesh, `queue_mesh`) runs each queue's wave function block by block on
    the mesh's devices; faults with a mesh raise ValueError.

    timings: optional dict.  There is no compile step here, so what lands
    in ``timings["compile_s"]`` (accumulated) is the one-off host work of
    the dispatch: building each queue's wave function (for "cuda", the
    stream encoded), and its `prepare` (the stream packed, the column
    metadata built, the kernel library loaded on first use), so callers
    timing a dispatch can report the steady-state time without it.

    Returns one [waves_q, len(result_rows[q]), ...] readback per queue.
    """
    if not (len(staged_qs) == len(programs) == len(result_rows)
            == len(n_rows)):
        raise ValueError("one staged payload, program, readback row "
                         "tuple and template size per queue required")
    progs = tuple(tuple(p) for p in programs)
    for qid, p in enumerate(progs):
        encoded_program(p, queue=qid, materialize=False)
    if faults is not None:
        if isinstance(faults, FaultModel):
            faults = (faults,) * len(progs)
        faults = tuple(fm.wave_model() if fm is not None else None
                       for fm in faults)
        if not any(faults):
            faults = None
    if faults is None:
        faults = (None,) * len(progs)
        bank_geoms = None
    elif mesh is not None:
        raise ValueError(
            "fault injection is not supported under a shard_map mesh "
            "(see scheduler.run_waves); run faulted queues with "
            "mesh=None")
    bank_geoms = (tuple(bank_geoms) if bank_geoms is not None
                  else (None,) * len(progs))
    t0 = time.perf_counter()
    fns = []
    for prog, rr, nr, fm, bg, st in zip(progs, result_rows, n_rows, faults,
                                        bank_geoms, staged_qs):
        fn = wave_fn(body_engine, prog, tuple(rr), nr, fm, bg)
        if mesh is not None:
            fn = _on_mesh(mesh, fn)
        if timings is not None and hasattr(fn, "prepare"):
            fn.prepare(st)
        fns.append(fn)
    if timings is not None:
        timings["compile_s"] = (timings.get("compile_s", 0.0)
                                + time.perf_counter() - t0)
    return tuple(fn(st) for fn, st in zip(fns, staged_qs))


def _on_mesh(mesh, fn):
    """`fn` over a staged payload, run block by block over the mesh."""
    return lambda staged: map_blocks(mesh, fn, (staged,), STAGED_SPEC)


def dispatch_uniform_queued(arrays: Sequence[torch.Tensor],
                            program: Sequence[AAP],
                            result_rows: Tuple[int, ...], *, n_rows: int,
                            geom: DrimGeometry, mesh=None,
                            n_queues: Optional[int] = None, faults=None,
                            ) -> Tuple[torch.Tensor, int, int]:
    """The engine="queued" dispatch: stage the payload once into queue
    blocks, run every queue's (here identical) stream through the MIMD
    runner and merge the readbacks bank-wise: the SIMD engines' tile order
    by construction.  Under a `FaultModel` every queue anchors its flips
    at its physical bank offset, so the merged readback is bit-identical
    to the faulted SIMD engines' too (dead-queue entries only apply to
    partitioned graphs and are ignored here)."""
    nq = resolve_n_queues(geom, n_queues)
    qmesh = queue_mesh(geom, nq, mesh)
    staged_qs, tiles, waves = stage_rows_queued(arrays, geom=geom,
                                                n_queues=nq, mesh=qmesh)
    bank_geoms = None
    if faults is not None and faults.wave_model() is not None:
        bank_geoms = tuple((lo, geom.banks)
                           for lo, hi in bank_blocks(geom.banks, nq))
    outs = run_waves_queued(staged_qs, (tuple(program),) * nq,
                            (result_rows,) * nq, (n_rows,) * nq,
                            mesh=qmesh, faults=faults,
                            bank_geoms=bank_geoms)
    return torch.cat(outs, dim=3), tiles, waves


# ---------------------------------------------------------------------------
# Queue-aware cost model
# ---------------------------------------------------------------------------

def _stall_aaps(queue_lengths: Sequence[int], waves: int) -> int:
    """Shared command-bus contention, in whole AAP cycles over `waves`
    repetitions of the per-queue streams (per channel: every chip has its
    own command bus, and all chips carry the same queue blocks).

    A ONE-TIME pipeline ramp (queue q starts `q * cmds_per_aap` slots
    late and keeps that offset) plus a steady-state saturation stall that
    every wave pays once the queues demand more issue slots than an AAP
    envelope provides.  Below saturation this is 0 (DRIM-R's 8 banks
    never stall)."""
    lengths = tuple(int(n) for n in queue_lengths if n > 0)
    if not lengths:
        return 0
    makespan, _ = simulate_bus_issue(lengths,
                                     slots_per_aap=CMD_SLOTS_PER_AAP)
    ideal = max(lengths) * CMD_SLOTS_PER_AAP
    ramp = (len(lengths) - 1) * CMDS_PER_AAP
    steady = max(0, makespan - ideal - ramp)
    return (waves * steady + ramp) // CMD_SLOTS_PER_AAP


@dataclasses.dataclass(frozen=True)
class QueueSchedule(FusedSchedule):
    """Cost of a workload issued through per-bank command queues.

    Inherits the fused accounting and re-reads the serialization axis:
    `aaps_per_tile` is the CRITICAL-PATH stream length (for a fence-staged
    partition, the sum over stages of the slowest queue's segment; for a
    uniform program, its length), while `issued_aaps_per_tile` keeps the
    total work for energy.  On top of the AAP clock:

      * contention -- every queue issues through ONE per-channel command
        bus; `contention_stall_aaps` interleaves the per-queue streams
        through `isa.simulate_bus_issue`;
      * DMA overlap -- per-bank queues stream wave w+1's tiles (and wave
        w-1's readback) while wave w computes, so `overlapped_latency_s`
        pays max(compute, DMA) plus a one-wave fill instead of their sum
        (`serialized_latency_s`, what the SIMD engines pay).

    Cross-bank fence rows (`cross_rows_per_tile`, partitions only) ride
    the internal bus at the fences and are not overlapped.
    """

    n_queues: int = 1
    banks_per_queue: int = 0
    fence_stages: int = 1
    queue_aaps_per_tile: Tuple[int, ...] = ()
    issued_aaps_per_tile: int = 0
    contention_stall_aaps: int = 0
    dma_rows_per_tile: int = 0        # host DDR: input loads + readbacks
    cross_rows_per_tile: int = 0      # inter-bank fence transfers

    # -- AAP clock ---------------------------------------------------------
    @property
    def aaps_issued(self) -> int:
        """Total AAPs across all queues (a fence-staged partition runs
        every tile through EVERY queue's segment chain)."""
        return self.tiles * self.issued_aaps_per_tile

    @property
    def critical_path_aaps(self) -> int:
        """Serialized AAP cycles on the slowest queue, stalls included."""
        return self.aaps_sequential + self.contention_stall_aaps

    @property
    def latency_s(self) -> float:
        return self.critical_path_aaps * self.t_aap_s

    @property
    def queue_busy_aaps(self) -> Tuple[int, ...]:
        """Per-queue busy cycles over the whole payload."""
        return tuple(self.waves * a for a in self.queue_aaps_per_tile)

    # -- host DMA (shared clock: `core.timing.ddr_rows_s`) -----------------
    def _rows_s(self, rows: int) -> float:
        return ddr_rows_s(rows, self.row_bits)

    @property
    def dma_s(self) -> float:
        """Host DDR time to move every tile's loads + readbacks."""
        return self._rows_s(self.tiles * self.dma_rows_per_tile)

    @property
    def fence_dma_s(self) -> float:
        return self._rows_s(self.tiles * self.cross_rows_per_tile)

    @property
    def serialized_latency_s(self) -> float:
        """Compute then DMA back-to-back: the SIMD engines' model."""
        return self.latency_s + self.dma_s + self.fence_dma_s

    @property
    def overlapped_latency_s(self) -> float:
        """Double-buffered queues: DMA hides behind compute (or compute
        behind DMA), plus a one-wave pipeline fill of the shorter side and
        the non-overlappable fence traffic."""
        fill = min(self.latency_s, self.dma_s) / max(self.waves, 1)
        return (max(self.latency_s, self.dma_s) + fill
                + self.fence_dma_s)

    @property
    def dma_overlap_speedup(self) -> float:
        if self.overlapped_latency_s == 0.0:
            return 1.0
        return self.serialized_latency_s / self.overlapped_latency_s


def uniform_queue_schedule(op: str, *, n_bits: int, geom: DrimGeometry,
                           tiles: Optional[int] = None,
                           waves: Optional[int] = None,
                           n_queues: Optional[int] = None) -> QueueSchedule:
    """Queue-aware schedule for one Table-2 bulk op (every queue runs the
    same stream; tiles split bank-wise).  With tiles/waves omitted this is
    the closed form: the numbers `lower("queued").run` measures."""
    nq = resolve_n_queues(geom, n_queues)
    _, _, n_aaps = encoded_program(op, materialize=False)
    if tiles is None:
        tiles = _ceil_div(n_bits, geom.row_bits)
    if waves is None:
        waves = _ceil_div(tiles, geom.n_subarrays)
    arity, n_res = OP_ARITY[op], len(RESULT_ROWS[op])
    queue_aaps = (n_aaps,) * nq
    return QueueSchedule(
        op=op, n_bits=n_bits, row_bits=geom.row_bits, tiles=tiles,
        slots=geom.n_subarrays, waves=waves, aaps_per_tile=n_aaps,
        chips=geom.chips, banks=geom.banks,
        subarrays_per_bank=geom.subarrays_per_bank, t_aap_s=geom.t_aap_s,
        n_nodes=1, rows_used=N_DATA_ROWS, n_inputs=arity, n_outputs=n_res,
        unfused_aaps_per_tile=n_aaps,
        ddr_rows_per_tile=arity + n_res,
        unfused_ddr_rows_per_tile=arity + n_res,
        n_queues=nq, banks_per_queue=geom.banks // nq, fence_stages=1,
        queue_aaps_per_tile=queue_aaps, issued_aaps_per_tile=n_aaps,
        contention_stall_aaps=_stall_aaps(queue_aaps, waves),
        dma_rows_per_tile=arity + n_res, cross_rows_per_tile=0)


plan_queued_schedule = uniform_queue_schedule


def fused_queue_schedule(sched: FusedSchedule, *, geom: DrimGeometry,
                         n_queues: Optional[int] = None) -> QueueSchedule:
    """Lift a fused (SIMD) schedule into the queue cost model: the same
    stream on every queue, contention and DMA overlap added."""
    nq = resolve_n_queues(geom, n_queues)
    queue_aaps = (sched.aaps_per_tile,) * nq
    return QueueSchedule(
        **dataclasses.asdict(sched),
        n_queues=nq, banks_per_queue=geom.banks // nq, fence_stages=1,
        queue_aaps_per_tile=queue_aaps,
        issued_aaps_per_tile=sched.aaps_per_tile,
        contention_stall_aaps=_stall_aaps(queue_aaps, sched.waves),
        dma_rows_per_tile=sched.ddr_rows_per_tile, cross_rows_per_tile=0)


def partitioned_queue_schedule(gp: GraphPartition, *, n_bits: int,
                               geom: DrimGeometry,
                               tiles: Optional[int] = None,
                               waves: Optional[int] = None,
                               ) -> QueueSchedule:
    """Queue-aware schedule of a fence-staged MIMD graph partition.

    Every queue (a block of `banks / n_parts` banks) runs ALL tiles of its
    segments, so `slots`/`waves` describe ONE queue's block; the
    serialization axis is the fence-staged critical path
    (`gp.critical_path_aaps_per_tile`), contention is measured per stage
    from the concurrent segment streams, and cross-bank fence rows ride
    the bus between stages."""
    nq = gp.n_parts
    if geom.banks % nq:
        raise ValueError(
            f"{nq}-part partition does not divide {geom.banks} banks")
    geom_q = dataclasses.replace(geom, banks=geom.banks // nq)
    if tiles is None:
        tiles = _ceil_div(n_bits, geom.row_bits)
    if waves is None:
        waves = _ceil_div(tiles, geom_q.n_subarrays)
    stalls = sum(_stall_aaps(stage, waves) for stage in gp.stage_aaps)
    return QueueSchedule(
        op=f"partitioned[{gp.n_nodes}@{nq}]", n_bits=n_bits,
        row_bits=geom.row_bits, tiles=tiles, slots=geom_q.n_subarrays,
        waves=waves, aaps_per_tile=gp.critical_path_aaps_per_tile,
        chips=geom.chips, banks=geom.banks,
        subarrays_per_bank=geom.subarrays_per_bank, t_aap_s=geom.t_aap_s,
        n_nodes=gp.n_nodes, rows_used=gp.rows_used,
        n_inputs=gp.loaded_input_rows, n_outputs=gp.readback_rows_count,
        unfused_aaps_per_tile=gp.unfused_aaps_per_tile,
        ddr_rows_per_tile=gp.loaded_input_rows + gp.readback_rows_count,
        unfused_ddr_rows_per_tile=gp.unfused_ddr_rows_per_tile,
        n_queues=nq, banks_per_queue=geom.banks // nq,
        fence_stages=gp.n_stages,
        queue_aaps_per_tile=gp.queue_aaps_per_tile,
        issued_aaps_per_tile=gp.issued_aaps_per_tile,
        contention_stall_aaps=stalls,
        dma_rows_per_tile=gp.loaded_input_rows + gp.readback_rows_count,
        cross_rows_per_tile=gp.cross_fence_rows)


def plan_partitioned_schedule(graph: BulkGraph, n_bits: int, *,
                              geom: DrimGeometry = DRIM_R,
                              n_queues: Optional[int] = None,
                              row_budget: Optional[int]
                              = DEFAULT_ROW_BUDGET) -> QueueSchedule:
    """Closed-form MIMD schedule: the numbers a partitioned run measures,
    without touching the simulator."""
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    nq = resolve_n_queues(geom, n_queues)
    gp = partition_graph(graph, nq, row_budget=row_budget)
    return partitioned_queue_schedule(gp, n_bits=n_bits, geom=geom)


# ---------------------------------------------------------------------------
# MIMD graph execution
# ---------------------------------------------------------------------------

def execute_partitioned(graph: BulkGraph, feeds, *,
                        geom: DrimGeometry = DRIM_R,
                        n_bits: Optional[int] = None,
                        n_queues: Optional[int] = None,
                        row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
                        mesh=None, device=None,
                        ) -> Tuple[Dict[str, torch.Tensor], QueueSchedule]:
    """DEPRECATED shim over the staged pipeline.

    Use ``compile(graph, geom=geom).lower(partition=True, n_queues=...,
    mesh=...).run(feeds, n_bits=..., device=...)``: partitioning is a
    lowering choice (`compiler.PARTITIONERS`), not a separate entry point.
    This wrapper lowers per call and returns ({output: tensor},
    QueueSchedule) on `device` (None: the card)."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated(
        "queue.execute_partitioned",
        "compile(graph).lower(partition=True, n_queues=..., mesh=...)"
        ".run(feeds, n_bits=...)")
    low = _compile(graph, geom=geom, row_budget=row_budget).lower(
        partition=True, n_queues=n_queues, mesh=mesh)
    results = low.run(feeds, n_bits=n_bits, device=device)
    return results, low.schedule


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """What one partitioned run survived: which queues died, which fence
    stages detected it, what was requeued where, and how long recovery
    (detect -> replan -> dispatch) took on the host clock.

    `recovery_s` is the steady-state cost of that path; it EXCLUDES the
    one-off host work of the requeue dispatch (building the requeued
    segments' wave functions: their streams encoded and packed, and the
    kernel library loaded on first use), which lands on `compile_s`.
    `death_stages` maps each dead queue to its first dead fence stage."""

    dead_queues: Tuple[int, ...]
    survivors: Tuple[int, ...]
    detected_stages: Tuple[int, ...]   # fence stages that found a gap
    requeued_segments: int
    recovery_s: float                  # detect -> replan -> dispatch
    data_parallel: int                 # survivor fleet's elastic_plan
    compile_s: float = 0.0             # one-off set-up of the requeue
    death_stages: Tuple[Tuple[int, int], ...] = ()  # (queue, stage)

    @property
    def degraded(self) -> bool:
        return bool(self.dead_queues)


class QueueProgressTable:
    """Per-queue fence-stage progress, the in-process analogue of
    `runtime.ft.HeartbeatMonitor`'s host table.  Every queue that retires
    a segment beats (part, stage); the fence then asks which expected
    queues went silent.  A dead queue never beats, so detection is
    structural, not timeout-based: the fence IS the deadline."""

    def __init__(self, n_queues: int) -> None:
        self.n_queues = n_queues
        self._beats: Dict[int, set] = {}

    def beat(self, part: int, stage: int) -> None:
        self._beats.setdefault(stage, set()).add(part)

    def missing(self, stage: int, expected) -> Tuple[int, ...]:
        return tuple(sorted(set(expected)
                            - self._beats.get(stage, set())))


def _execute_partitioned(graph: BulkGraph, env: Dict[str, torch.Tensor], *,
                         gp: GraphPartition, geom: DrimGeometry,
                         n_bits: int, mesh=None,
                         body_engine: str = "queued", faults=None,
                         protected_nodes: FrozenSet[int] = frozenset(),
                         ) -> Tuple[Dict[str, torch.Tensor], QueueSchedule,
                                    Optional[ChaosReport]]:
    """Run ONE BulkGraph split ACROSS the bank queues (MIMD): the pipeline
    backend behind `lower(partition=...)`.

    The partition (`gp`) assigns every node to a queue and a fence stage;
    within a stage every queue runs its segment over its own block of
    banks through `run_waves_queued`, and fences order cross-bank
    dependencies between stages.  Each queue processes EVERY tile of the
    payload for its own nodes.  The executor is functional over `env` (one
    flat int32 word tensor per graph input, already validated), which it
    fills as stages retire; the cost model charges only what the hardware
    moves.  `body_engine`: "queued" (plain torch) or "cuda" (one AAP
    interpreter launch per segment).

    faults: optional `core.FaultModel`.  Flips anchor each segment at its
    queue's physical bank block (hardened voter / parity spans mapped per
    segment through `protected_nodes`, indices into `graph.nodes`);
    `faults.dead_queues` kills those queues from a fence stage on: their
    segments never run or beat, the fence's progress table detects the
    gap, the survivor fleet is validated through `runtime.ft.elastic_plan`
    and the orphaned segments are requeued round-robin on survivor bank
    blocks, with a per-epoch flip salt.  A requeued segment is exact.  The
    recovery lands on the telemetry registry (``chaos.recovery_s`` and
    ``chaos.compile_s`` gauges, the ``chaos.requeued_segments`` counter,
    a ``chaos:requeue`` instant per detecting fence when armed).

    Returns ({output_name: tensor}, QueueSchedule, ChaosReport | None).
    """
    from repro_torch.runtime.ft import elastic_plan

    nq = gp.n_parts
    n_words = next(iter(env.values())).shape[0] if env else 0
    geom_q = dataclasses.replace(geom, banks=geom.banks // nq)
    qmesh = queue_mesh(geom, nq, mesh)
    tiles = _ceil_div(n_bits, geom.row_bits)
    waves = _ceil_div(tiles, geom_q.n_subarrays)
    blocks = bank_blocks(geom.banks, nq)

    flips = faults.wave_model() if faults is not None else None
    # queue -> first fence stage it is dead at: earlier stages completed
    # normally, this one and everything after are lost
    death_stage: Dict[int, int] = {}
    if faults is not None:
        for q, s in faults.dead_queues:
            if 0 <= q < nq:
                death_stage[q] = min(s, death_stage.get(q, s))
    dead = tuple(sorted(death_stage))
    survivors = tuple(q for q in range(nq) if q not in death_stage)
    if dead and not survivors:
        raise RuntimeError(f"all {nq} queues are dead; no survivor can "
                           "adopt the orphaned segments")

    def seg_faults(s: QueueSegment, epoch: int):
        fm = flips
        if epoch:
            # A recovery dispatch is a LATER command window on the adopting
            # queue's banks: without this salt a requeued segment would
            # replay the survivor's (op index, slot) flips verbatim.
            fm = dataclasses.replace(
                fm, seed=(fm.seed ^ (epoch * 0x9E3779B9)) & 0xFFFFFFFF)
        # Subgraphs contain no copies, so subgraph node k IS original
        # node s.node_ids[k]; protected spans follow that mapping.
        prot = [k for i, lo, hi in s.fp.node_spans
                if s.node_ids[i] in protected_nodes
                for k in range(lo, hi)]
        return fm.with_protected(prot) if prot else fm

    def run_segs(segs: List[QueueSegment], parts: Sequence[int],
                 epoch: int = 0, timings=None) -> None:
        staged_qs = [stage_rows([env[n] for n in s.fp.loaded_inputs],
                                geom=geom_q, mesh=qmesh)[0] for s in segs]
        per_faults = (tuple(seg_faults(s, epoch) for s in segs)
                      if flips is not None else None)
        geoms = (tuple((blocks[p][0], geom.banks) for p in parts)
                 if flips is not None else None)
        outs = run_waves_queued(
            staged_qs, [s.fp.program for s in segs],
            [s.fp.readback_rows for s in segs],
            [s.fp.template_rows for s in segs], mesh=qmesh,
            body_engine=body_engine, faults=per_faults, bank_geoms=geoms,
            timings=timings)
        for s, out in zip(segs, outs):
            col = {row: i for i, row in enumerate(s.fp.readback_rows)}
            for name, row in s.fp.device_outputs:
                env[name] = out[:, col[row]].reshape(-1)[:n_words]
            for name, src in s.fp.alias_outputs:
                env[name] = env[src]

    progress = QueueProgressTable(nq)
    detected: List[int] = []
    requeued = 0
    recovery_s = 0.0
    compile_s = 0.0
    plan_data = len(survivors) if survivors else nq

    for stage in range(gp.n_stages):
        segs = [s for s in gp.segments if s.stage == stage]
        healthy = [s for s in segs
                   if death_stage.get(s.part, gp.n_stages) > stage]
        orphans = [s for s in segs
                   if death_stage.get(s.part, gp.n_stages) <= stage]
        if healthy:
            run_segs(healthy, [s.part for s in healthy])
            for s in healthy:
                progress.beat(s.part, stage)
        missing = progress.missing(stage, {s.part for s in segs})
        if missing:
            # The fence found silent queues: replan on the survivor fleet
            # and adopt their segments.  Orphans are padded up to a
            # survivor multiple so the validated elastic split is exact.
            t0 = time.perf_counter()
            detected.append(stage)
            padded = -(-len(orphans) // len(survivors)) * len(survivors)
            plan = elastic_plan(len(survivors), 1, padded,
                                model_parallel=1)
            plan_data = plan["data"]
            rec_t: Dict[str, float] = {}
            run_segs(orphans, [survivors[i % len(survivors)]
                               for i in range(len(orphans))],
                     epoch=stage + 1, timings=rec_t)
            requeued += len(orphans)
            compile_s += rec_t.get("compile_s", 0.0)
            recovery_s += (time.perf_counter() - t0
                           - rec_t.get("compile_s", 0.0))
            telemetry.event("chaos:requeue", cat="chaos", tid="chaos",
                            stage=stage, orphans=len(orphans),
                            survivors=list(survivors))

    results = {name: env[src] for name, src in gp.output_sources}
    sched = partitioned_queue_schedule(gp, n_bits=n_bits, geom=geom,
                                       tiles=tiles, waves=waves)
    chaos = None
    if dead:
        chaos = ChaosReport(dead_queues=dead, survivors=survivors,
                            detected_stages=tuple(detected),
                            requeued_segments=requeued,
                            recovery_s=recovery_s,
                            data_parallel=plan_data,
                            compile_s=compile_s,
                            death_stages=tuple(sorted(
                                death_stage.items())))
        telemetry.gauge("chaos.recovery_s", recovery_s)
        telemetry.gauge("chaos.compile_s", compile_s)
        telemetry.REGISTRY.counters("chaos")["requeued_segments"] \
            += requeued
    return results, sched, chaos
