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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.subarray import WORD_BITS
from repro_torch.pim.graph import FusedSchedule, _make_fused_schedule
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
