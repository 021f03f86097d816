"""PIM offload pricing: the DRIM-vs-GPU placement `Verdict` (port of
`repro.pim.offload`).

Given any lowered program (`pim.compiler.Lowered`: a Table-2 op, a fused
BulkGraph, or a fence-staged MIMD partition), `build_verdict` prices
every contender with the same row fields -- compute seconds, DDR traffic
seconds, energy, AAP cycles, rows moved -- and picks the winner by
end-to-end latency:

    DRIM-<engine>  a Table-2 op on the fleet (operands resident in DRAM)
    DRIM-fused     one resident AAP stream per slot, DMA serialized
    DRIM-queued    per-bank queues: contention stalls + DMA overlapped
    DRIM-unfused   the op-at-a-time chain (host round trip per node)
    GPU            the "gpu" comparator's roofline of the card

The DRIM rows are the reference's, field for field.  The comparator row
is the card's, never the reference's TPU model: it prices the boundary
planes (every loaded input and every read-back output, `n_bits` bits
each) over device memory, and one bit-op per node per bit over the
integer rate.  The constants are those of an NVIDIA H100 SXM 80GB HBM3 at
its 700 W limit, from NVIDIA's data sheet:

  * HBM3 bandwidth 3.35e12 B/s;
  * bit-ops at 32 per int32 operation, the int32 rate being 64 lanes per
    SM against the 128 behind the 67 TFLOP/s float32 peak (which counts an
    FMA as two): 67e12 / 4 * 32 = 5.36e14 bit-ops/s.

Energy is the card's 700 W limit over the latency: an upper bound, since
the data sheet gives no energy per HBM3 byte.

The reference's per-path reports (`plan`, `plan_fused`, `plan_queued`
and their `OffloadReport`, `FusedOffloadReport`, `QueuedOffloadReport`)
remain as deprecated shims with the reference's field layouts and winner
rules; their DRIM fields are the reference's, their comparator fields the
GPU row's (`gpu_latency_s`, `gpu_energy_j`, `speedup_vs_gpu`, winner
"GPU").  `plan(operands_in_dram=False)` stages the operands at the
comparator's memory rate, as the reference stages them at its TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import DRIM_R, DrimGeometry
from repro_torch.core.energy import E_ACCESS_NJ_PER_KB, E_IO_NJ_PER_KB
from repro_torch.core.subarray import WORD_BITS
from repro_torch.pim.graph import (BulkGraph, FusedSchedule,
                                   _make_fused_schedule, plan_graph_schedule)
from repro_torch.pim.scheduler import (OP_ARITY, RESULT_ROWS, _ceil_div,
                                       random_operands)

GPU_NAME = "NVIDIA H100 80GB HBM3, 700 W"
GPU_HBM_BW = 3.35e12                  # bytes/s
GPU_BITOPS = 67e12 / 4 * 32           # bit-ops/s: int32 rate x 32 bits
GPU_POWER_W = 700.0

# Payloads above this are priced from the closed-form schedule even when
# simulation is requested: the schedule math is exactly what execution
# measures.
SIMULATE_MAX_BITS = 1 << 21

_BYTES_MOVED = {"not": 2, "xnor2": 3, "xor2": 3, "maj3": 4, "add": 5,
                "copy": 2}


@dataclasses.dataclass(frozen=True)
class VerdictRow:
    """One contender, priced with the same fields as every other."""

    contender: str          # "DRIM-fused" | "DRIM-queued" | ... | "GPU"
    latency_s: float        # end-to-end (compute and DMA composed per
                            # the contender's own overlap model)
    compute_s: float
    dma_s: float            # boundary traffic
    energy_j: float
    aaps: int               # serialized AAP cycles (0 for the GPU)
    ddr_rows_moved: int


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Placement verdict for one lowered program at one payload size."""

    workload: str
    n_bits: int
    n_nodes: int
    rows: Tuple[VerdictRow, ...]
    simulated: bool = False

    @property
    def winner(self) -> str:
        return min(self.rows, key=lambda r: r.latency_s).contender

    def row(self, contender: str) -> VerdictRow:
        for r in self.rows:
            if r.contender == contender:
                return r
        raise KeyError(f"no {contender!r} row (have: "
                       f"{', '.join(r.contender for r in self.rows)})")

    def speedup(self, contender: str, over: str) -> float:
        return (self.row(over).latency_s
                / max(self.row(contender).latency_s, 1e-30))

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class GpuCost:
    """Roofline cost of the "gpu" comparator engine: boundary planes over
    HBM, a bit-op floor at the int32 rate, energy at the power limit."""

    n_bits: int
    boundary_bytes: float
    compute_s: float
    dma_s: float
    energy_j: float

    @property
    def latency_s(self) -> float:
        return max(self.compute_s, self.dma_s)


def _gpu_row(n_io_planes: int, n_node_bitops: int,
             n_bits: int) -> VerdictRow:
    """The GPU contender's row."""
    boundary = n_io_planes * n_bits / 8.0
    compute = n_node_bitops * n_bits / GPU_BITOPS
    dma = boundary / GPU_HBM_BW
    latency = max(compute, dma)
    return VerdictRow(
        contender="GPU", latency_s=latency, compute_s=compute, dma_s=dma,
        energy_j=latency * GPU_POWER_W, aaps=0, ddr_rows_moved=0)


def _boundary_planes(lowered) -> Tuple[int, int]:
    """(io planes, node bit-ops) of a lowering, for the GPU row."""
    if lowered.kind == "op":
        return OP_ARITY[lowered.op] + len(RESULT_ROWS[lowered.op]), 1
    fp = lowered.fp
    return len(fp.loaded_inputs) + len(fp.readback_rows), fp.n_nodes


def gpu_cost(lowered, n_bits: int) -> GpuCost:
    """Closed-form cost of the "gpu" engine for `Lowered.cost()`."""
    n_io, n_ops = _boundary_planes(lowered)
    row = _gpu_row(n_io, n_ops, n_bits)
    return GpuCost(n_bits=n_bits, boundary_bytes=n_io * n_bits / 8.0,
                   compute_s=row.compute_s, dma_s=row.dma_s,
                   energy_j=row.energy_j)


def _fused_rows(sched: FusedSchedule) -> Tuple[VerdictRow, VerdictRow]:
    """(DRIM-fused, DRIM-unfused) rows from one fused schedule: DMA
    serialized after compute, both sides on the shared DDR clock."""
    fused = VerdictRow(
        contender="DRIM-fused",
        latency_s=sched.latency_s + sched.dma_s,
        compute_s=sched.latency_s, dma_s=sched.dma_s,
        energy_j=sched.total_energy_j, aaps=sched.aaps_sequential,
        ddr_rows_moved=sched.ddr_rows_moved)
    unfused = VerdictRow(
        contender="DRIM-unfused",
        latency_s=sched.unfused_latency_s + sched.unfused_dma_s,
        compute_s=sched.unfused_latency_s, dma_s=sched.unfused_dma_s,
        energy_j=sched.unfused_total_energy_j,
        aaps=sched.unfused_aaps_sequential,
        ddr_rows_moved=sched.unfused_ddr_rows_moved)
    return fused, unfused


def _queued_row(qsched) -> VerdictRow:
    """The DRIM-queued contender: fence-staged critical path plus
    contention stalls, host DMA double-buffered behind compute
    (`overlapped_latency_s`)."""
    return VerdictRow(
        contender="DRIM-queued", latency_s=qsched.overlapped_latency_s,
        compute_s=qsched.latency_s,
        dma_s=qsched.dma_s + qsched.fence_dma_s,
        energy_j=qsched.total_energy_j, aaps=qsched.critical_path_aaps,
        ddr_rows_moved=qsched.ddr_rows_moved)


def _measured_schedule(lowered, n_bits: int, device):
    """Execute the lowering on `device` with the reference's seeded
    random operands (numpy uint32 words, handed to `run` as they are) and
    return the measured schedule."""
    n_words = -(-n_bits // WORD_BITS)
    if lowered.kind == "op":
        args = random_operands(lowered.op, n_words, seed=n_bits & 0xFFFF)
        lowered.run(*args, n_bits=n_bits, device=device)
    else:
        rng = np.random.default_rng(n_bits & 0xFFFF)
        # Reserved constant planes keep their contract (all-zero words)
        # even under random feeds: a traced `a & b` is maj3(a, b, 0).
        consts = set(lowered.traced.const_names) \
            if lowered.traced is not None else set()
        feeds = {name: (np.zeros(n_words, np.uint32) if name in consts
                        else rng.integers(0, 1 << 32, n_words,
                                          dtype=np.uint32))
                 for name in lowered.graph.input_names}
        lowered.run(feeds, n_bits=n_bits, device=device)
    return lowered.schedule


def build_verdict(lowered, n_bits: int, *, simulate: bool = False,
                  device=None) -> Verdict:
    """Price a lowered program against every contender.

    With `simulate=True` (payloads up to SIMULATE_MAX_BITS, device
    engines) the program runs on `device` (None: the card) and the DRIM
    rows carry the measured schedule; the closed form prices identical
    numbers otherwise.  A Table-2 op lowered on the comparator has no
    DRIM schedule to price and raises ValueError."""
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    if lowered.kind == "op" and not lowered.engine.device:
        raise ValueError(
            f"a verdict prices DRIM against the {lowered.engine.name!r} "
            f"comparator, so it needs a DRIM schedule: lower the op "
            f"{lowered.op!r} on a device engine (\"resident\", "
            f"\"baseline\", \"queued\" or \"cuda\")")
    simulated = (simulate and n_bits <= SIMULATE_MAX_BITS
                 and lowered.engine.device)
    sched = (_measured_schedule(lowered, n_bits, device) if simulated
             else lowered.cost(n_bits))
    n_io, n_ops = _boundary_planes(lowered)
    gpu = _gpu_row(n_io, n_ops, n_bits)

    if lowered.kind == "op":
        arity = OP_ARITY[lowered.op]
        n_res = len(RESULT_ROWS[lowered.op])
        ddr_rows = sched.tiles * (arity + n_res)
        if hasattr(sched, "overlapped_latency_s"):
            drim = dataclasses.replace(_queued_row(sched),
                                       ddr_rows_moved=ddr_rows)
        else:
            # Operands already resident in DRAM, result stays (the
            # paper's premise), so the op row pays no boundary DMA.
            drim = VerdictRow(
                contender=f"DRIM-{lowered.engine.name}",
                latency_s=sched.latency_s, compute_s=sched.latency_s,
                dma_s=0.0, energy_j=sched.energy_j,
                aaps=sched.aaps_sequential, ddr_rows_moved=ddr_rows)
        rows = (drim, gpu)
        name = lowered.op
    else:
        if hasattr(sched, "overlapped_latency_s") or not simulated:
            # The SIMD fused contender did not run (queued or partitioned
            # lowering, or closed-form pricing): rebuild it in closed form.
            geom = lowered.geom
            tiles = _ceil_div(n_bits, geom.row_bits)
            waves = _ceil_div(tiles, geom.n_subarrays)
            base = _make_fused_schedule(lowered.fp, n_bits, tiles, waves,
                                        geom)
        else:
            base = sched                  # the measured fused schedule
        fused, unfused = _fused_rows(base)
        rows = (fused, unfused, gpu)
        if hasattr(sched, "overlapped_latency_s"):
            rows = (_queued_row(sched),) + rows
        name = (lowered.traced.name if lowered.traced is not None
                else f"graph[{base.n_nodes}]")
        if lowered.harden:
            # The redundancy AAPs are in every row above: the workload
            # says so, or hardened and bare verdicts look like one program
            # priced two ways.
            name = f"{name}+{lowered.harden}"
        n_ops = base.n_nodes
    return Verdict(workload=name, n_bits=n_bits, n_nodes=n_ops,
                   rows=rows, simulated=simulated)


# ---------------------------------------------------------------------------
# Legacy reports (deprecated shims over the pipeline)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OffloadReport:
    op: str
    n_bits: int
    drim_latency_s: float
    drim_energy_j: float
    drim_aaps: int              # serialized AAP cycles (waves x per-tile)
    gpu_latency_s: float
    gpu_energy_j: float
    winner: str
    speedup: float
    # parallelism breakdown (measured from the schedule)
    tiles: int = 0
    waves: int = 0
    active_subarrays: int = 0   # slots busy in the fullest wave
    occupancy: float = 0.0      # tiles / (waves x slots)
    aaps_issued: int = 0        # total AAPs across active sub-arrays
    simulated: bool = False     # True when the streams actually ran

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def plan(op: str, n_bits: int, *, geom: DrimGeometry = DRIM_R,
         operands_in_dram: bool = True, simulate: bool = False, mesh=None,
         device=None) -> OffloadReport:
    """DEPRECATED shim: use `compile(op).lower(...).verdict(n_bits)`.

    Keeps the reference's OffloadReport layout and winner rule (DRIM
    compute latency against the GPU row, with a host-staging penalty at
    the card's memory rate when operands are not already in DRAM).
    `simulate` runs the op on `device` (None: the card)."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated("offload.plan",
                     "compile(op).lower(...).verdict(n_bits)")
    if op not in OP_ARITY or op not in _BYTES_MOVED:
        raise ValueError(f"unknown bulk op {op!r}")
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    low = _compile(op, geom=geom).lower(mesh=mesh)
    simulated = simulate and n_bits <= SIMULATE_MAX_BITS
    sched = (_measured_schedule(low, n_bits, device) if simulated
             else low.cost(n_bits))
    drim_lat = sched.latency_s
    drim_e = sched.energy_j
    kb = n_bits / 8.0 / 1024.0

    gpu = _gpu_row(_BYTES_MOVED[op], 1, n_bits)
    moved_bytes = _BYTES_MOVED[op] * n_bits / 8.0
    if not operands_in_dram:
        # host->DRAM round trip to stage operands for PIM
        drim_e += 2 * (E_ACCESS_NJ_PER_KB + E_IO_NJ_PER_KB) * kb * 1e-9
        drim_lat += moved_bytes / GPU_HBM_BW

    winner = "DRIM" if drim_lat < gpu.latency_s else "GPU"
    return OffloadReport(op=op, n_bits=n_bits, drim_latency_s=drim_lat,
                         drim_energy_j=drim_e,
                         drim_aaps=sched.aaps_sequential,
                         gpu_latency_s=gpu.latency_s,
                         gpu_energy_j=gpu.energy_j, winner=winner,
                         speedup=gpu.latency_s / max(drim_lat, 1e-30),
                         tiles=sched.tiles, waves=sched.waves,
                         active_subarrays=sched.active_subarrays,
                         occupancy=sched.occupancy,
                         aaps_issued=sched.aaps_issued,
                         simulated=simulated)


@dataclasses.dataclass(frozen=True)
class FusedOffloadReport:
    """Placement verdict for a whole fused dataflow graph (the reference's
    layout; the winner compares DRIM compute latencies against the GPU)."""

    n_nodes: int
    n_bits: int
    fused_latency_s: float
    fused_energy_j: float
    fused_aaps: int                 # serialized cycles, waves x per-tile
    unfused_latency_s: float
    unfused_energy_j: float
    unfused_aaps: int
    ddr_rows_moved: int
    unfused_ddr_rows_moved: int
    gpu_latency_s: float
    gpu_energy_j: float
    winner: str
    speedup_vs_unfused: float
    speedup_vs_gpu: float
    rows_used: int
    waves: int
    simulated: bool = False

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def plan_fused(graph: BulkGraph, n_bits: int, *,
               geom: DrimGeometry = DRIM_R, simulate: bool = False,
               mesh=None, device=None) -> FusedOffloadReport:
    """DEPRECATED shim: use `compile(graph).lower(...).verdict(n_bits)`.

    The GPU row prices the graph boundary (inputs + outputs x n_bits) over
    HBM, with a bit-op floor of one per node per bit."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated("offload.plan_fused",
                     "compile(graph).lower(...).verdict(n_bits)")
    low = _compile(graph, geom=geom).lower(mesh=mesh)
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    simulated = simulate and n_bits <= SIMULATE_MAX_BITS
    sched = (_measured_schedule(low, n_bits, device) if simulated
             else low.cost(n_bits))
    gpu = _gpu_row(sched.n_inputs + sched.n_outputs, sched.n_nodes, n_bits)

    fused_lat = sched.latency_s
    unfused_lat = sched.unfused_latency_s
    lats = {"DRIM-fused": fused_lat, "DRIM-unfused": unfused_lat,
            "GPU": gpu.latency_s}
    return FusedOffloadReport(
        n_nodes=sched.n_nodes, n_bits=n_bits,
        fused_latency_s=fused_lat, fused_energy_j=sched.total_energy_j,
        fused_aaps=sched.aaps_sequential,
        unfused_latency_s=unfused_lat,
        unfused_energy_j=sched.unfused_total_energy_j,
        unfused_aaps=sched.unfused_aaps_sequential,
        ddr_rows_moved=sched.ddr_rows_moved,
        unfused_ddr_rows_moved=sched.unfused_ddr_rows_moved,
        gpu_latency_s=gpu.latency_s, gpu_energy_j=gpu.energy_j,
        winner=min(lats, key=lats.get),
        speedup_vs_unfused=unfused_lat / max(fused_lat, 1e-30),
        speedup_vs_gpu=gpu.latency_s / max(fused_lat, 1e-30),
        rows_used=sched.rows_used, waves=sched.waves,
        simulated=simulated)


@dataclasses.dataclass(frozen=True)
class QueuedOffloadReport:
    """Placement verdict for a graph run through per-bank MIMD queues (the
    reference's layout).  Queued latency is the overlapped model; the
    serialized figure and the stall count are reported beside it."""

    n_nodes: int
    n_bits: int
    n_queues: int
    fence_stages: int
    critical_path_aaps: int
    issued_aaps: int
    contention_stall_aaps: int
    queued_latency_s: float
    queued_serialized_latency_s: float
    dma_overlap_speedup: float
    cross_fence_rows: int
    fused_latency_s: float          # SIMD fused compute + serialized DMA
    fused_aaps: int
    gpu_latency_s: float
    gpu_energy_j: float
    winner: str
    speedup_vs_fused: float
    speedup_vs_gpu: float
    rows_used: int
    waves: int
    simulated: bool = False

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def plan_queued(graph: BulkGraph, n_bits: int, *,
                n_queues: Optional[int] = None,
                geom: DrimGeometry = DRIM_R, simulate: bool = False,
                mesh=None, device=None) -> QueuedOffloadReport:
    """DEPRECATED shim: use `compile(graph).lower(partition=True,
    n_queues=...).verdict(n_bits)`.

    The queued side pays the fence-staged critical path plus command-bus
    stalls with host DMA overlapped; the SIMD fused side its shorter wave
    count with the same DMA serialized after compute."""
    from repro_torch.pim.compiler import _warn_deprecated, compile as _compile
    _warn_deprecated(
        "offload.plan_queued",
        "compile(graph).lower(partition=True, n_queues=...)"
        ".verdict(n_bits)")
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    low = _compile(graph, geom=geom).lower(partition=True,
                                           n_queues=n_queues, mesh=mesh)
    simulated = simulate and n_bits <= SIMULATE_MAX_BITS
    qsched = (_measured_schedule(low, n_bits, device) if simulated
              else low.cost(n_bits))
    fsched = plan_graph_schedule(graph, n_bits, geom=geom)
    fused_lat = fsched.latency_s + fsched.dma_s

    gpu = _gpu_row(fsched.n_inputs + fsched.n_outputs, fsched.n_nodes,
                   n_bits)
    queued_lat = qsched.overlapped_latency_s
    lats = {"DRIM-queued": queued_lat, "DRIM-fused": fused_lat,
            "GPU": gpu.latency_s}
    return QueuedOffloadReport(
        n_nodes=qsched.n_nodes, n_bits=n_bits, n_queues=qsched.n_queues,
        fence_stages=qsched.fence_stages,
        critical_path_aaps=qsched.critical_path_aaps,
        issued_aaps=qsched.aaps_issued,
        contention_stall_aaps=qsched.contention_stall_aaps,
        queued_latency_s=queued_lat,
        queued_serialized_latency_s=qsched.serialized_latency_s,
        dma_overlap_speedup=qsched.dma_overlap_speedup,
        cross_fence_rows=qsched.cross_rows_per_tile * qsched.tiles,
        fused_latency_s=fused_lat, fused_aaps=fsched.aaps_sequential,
        gpu_latency_s=gpu.latency_s, gpu_energy_j=gpu.energy_j,
        winner=min(lats, key=lats.get),
        speedup_vs_fused=fused_lat / max(queued_lat, 1e-30),
        speedup_vs_gpu=gpu.latency_s / max(queued_lat, 1e-30),
        rows_used=qsched.rows_used, waves=qsched.waves,
        simulated=simulated)


def serving_verdict(m: int, n: int, k_bits: int, *, geom=None,
                    engine: str = "resident", n_queues=None,
                    k_tile=None) -> Verdict:
    """Price one served BitLinear decode GEMM ([m, K] x [K, n]).

    Uses the same cached lowerings `pim.bnn.serve_bnn_matmul` executes
    (`compiler.lower_cached`), priced by `build_verdict` at n_bits = m*n
    lanes per K chunk, every row field summed across the serialized chunks
    as the serving path runs them.  The GPU row sums the same way."""
    from repro_torch.pim.bnn import k_chunks, serving_lowering
    counts: Dict[int, int] = {}
    for kc in k_chunks(k_bits, k_tile):
        counts[kc] = counts.get(kc, 0) + 1
    n_nodes = 0
    acc: Dict[str, VerdictRow] = {}
    for kc, count in counts.items():
        low = serving_lowering(kc, engine=engine, geom=geom,
                               n_queues=n_queues)
        v = build_verdict(low, m * n)
        n_nodes += v.n_nodes * count
        for r in v.rows:
            prev = acc.get(r.contender, VerdictRow(
                contender=r.contender, latency_s=0.0, compute_s=0.0,
                dma_s=0.0, energy_j=0.0, aaps=0, ddr_rows_moved=0))
            acc[r.contender] = VerdictRow(
                contender=r.contender,
                latency_s=prev.latency_s + r.latency_s * count,
                compute_s=prev.compute_s + r.compute_s * count,
                dma_s=prev.dma_s + r.dma_s * count,
                energy_j=prev.energy_j + r.energy_j * count,
                aaps=prev.aaps + r.aaps * count,
                ddr_rows_moved=prev.ddr_rows_moved
                + r.ddr_rows_moved * count)
    return Verdict(workload=f"bitlinear[{m}x{n}x{k_bits}]",
                   n_bits=m * n, n_nodes=n_nodes, rows=tuple(acc.values()))


def plan_model_payloads(cfg) -> Dict[str, Verdict]:
    """Price the framework's own bulk bit-wise payloads for an arch config
    (1-bit EF gradient all-reduce planes, BitLinear sign planes) through
    the pipeline: one Verdict per payload, n_bits = the parameter count."""
    from repro_torch.pim.compiler import compile as _compile
    n_params = cfg.param_count()
    payloads = (("grad_sign_reduce(add)", "add"),
                ("bitlinear_weight_xnor", "xnor2"),
                ("weight_sign_copy", "copy"))
    return {name: _compile(op).lower().verdict(n_params)
            for name, op in payloads}
