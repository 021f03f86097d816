"""The staged DRIM pipeline: ONE `compile -> lower -> run` path (port of
`repro.pim.compiler`).

    low = compile(src, geom=...)        # src: op name | BulkGraph |
          .lower(engine=..., mesh=...,  #      TracedProgram | jit function
                 n_queues=..., partition=...)
    out = low.run(..., device=...)      # measured low.schedule
    low.cost(n_bits)                    # closed-form schedule
    low.verdict(n_bits)                 # DRIM-vs-GPU placement Verdict

`lower()` runs a registered pass pipeline -- canonicalize -> harden ->
fuse -> optional partition -> encode -> verify (`PASS_PIPELINE`) -- and
engines live in one `EngineRegistry`: "resident" (plain torch, the
default), "baseline" (the full device state stepped by the encoded-stream
interpreter), "queued" (per-bank command queues, `pim.queue`), "cuda"
(the AAP interpreter kernels; their plain replays on CPU tensors), and
the comparator "gpu" (the reference's "tpu"): no fleet, the op or graph
evaluated natively by the bulk bit-wise kernels, one `ops.bitwise` call
per node, and priced by the card's roofline (`pim.offload.gpu_cost`).
Each device engine owns its dispatch and how it lifts tiling into its
schedule (`lift_op` / `lift_graph`).

`lower(partition=True | "greedy" | <int>, n_queues=q)` splits a graph
across q bank queues (`PARTITIONERS`, `graph.partition_graph`) and runs
each fence stage's per-queue segments on the "queued" engine's plain
torch body or, with `engine="cuda"`, one AAP interpreter launch per
segment; dead queues of the fault model are requeued
(`Lowered.chaos_report`).

Fault injection and hardening are ported: `lower(harden="tmr" | "ecc" |
"tmr+ecc")` rewrites the graph before fusing (`pim.harden`), `lower(faults=
FaultModel(...))` sets a default fault model and `run(..., faults=...)`
overrides it per run; an ``ecc`` run leaves its parity verdict on
`Lowered.last_ecc`.  The static verifier (`pim.verify`) runs on every
lowering by default and raises `verify.VerifyError` before a miscompiled
stream can run.  `lower(mesh=fleet_mesh(...))` (`pim.mesh`) runs the
"resident" engine's waves, the "queued" engine's queues and a partition's
segments block by block over the mesh's devices, the unsharded words by
construction; "baseline" drops the mesh, "cuda" and the comparator refuse
it, and so do active faults (the verifier's V020), as in the reference.

The legacy entry points (`scheduler.execute`/`execute_oplist`,
`graph.execute_graph`, `queue.execute_partitioned`, `offload.plan`/
`plan_fused`/`plan_queued`) are deprecated shims over this pipeline; each
warns through `_warn_deprecated`, naming its caller.

Armed telemetry (`runtime.telemetry`) records the reference's host spans:
"lower" with one "pass:{name}" span per pass, and "Lowered.run" with its
"stage", "dispatch" and "readback" spans.  They read the host's clock
and never synchronize the device: on the card a "dispatch" span closes
when its kernel launches are queued, not when they finish.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

import repro_torch.pim.verify as verify_mod
from repro_torch.core import AAP, DRIM_R, DrimGeometry, FaultModel
from repro_torch.core.subarray import N_XROWS, WORD_BITS, as_words
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.pim.frontend import JittedFunction, TracedProgram, jit
from repro_torch.pim.graph import (DEFAULT_ROW_BUDGET, BulkGraph,
                                   FusedProgram, GraphPartition,
                                   _make_fused_schedule, compile_graph,
                                   partition_graph)
from repro_torch.pim.offload import gpu_cost
from repro_torch.pim.scheduler import (N_DATA_ROWS, OP_ARITY, RESULT_ROWS,
                                       Schedule, _ceil_div, encoded_program,
                                       run_waves, stage_rows)
from repro_torch.runtime import telemetry


def _warn_deprecated(old: str, new: str, *, stacklevel: int = 3) -> None:
    """One shared deprecation channel for the legacy execute*/plan* shims;
    `-W error::DeprecationWarning` turns any lingering caller into a hard
    failure.

    `stacklevel` counts from `warnings.warn` inside this helper: 3 is right
    for the direct shims (caller -> shim -> here), so the warning names the
    CALLER's file and line.  A shim that interposes another wrapper must
    pass `stacklevel=4`."""
    warnings.warn(
        f"{old} is deprecated; use the staged pipeline instead: {new}",
        DeprecationWarning, stacklevel=stacklevel)


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """One execution backend.  A device engine's `dispatch(arrays,
    program, result_rows, n_rows=, geom=, mesh=, n_queues=, faults=) ->
    (outs, tiles, waves)` stages the payload on the simulated fleet and
    runs one uniform program over it; `lift_op` / `lift_graph` wrap
    measured (or closed-form) tiling into the engine's schedule flavour.
    A comparator (`device=False`) has no fleet: the pipeline evaluates
    the op or graph natively and prices it with `pim.offload.gpu_cost`."""

    name: str
    description: str
    dispatch: Optional[Callable] = None
    device: bool = True
    lift_op: Optional[Callable] = None
    lift_graph: Optional[Callable] = None


class EngineRegistry:
    """Single home for every engine the pipeline can lower onto."""

    def __init__(self) -> None:
        self._engines: Dict[str, Engine] = {}

    def register(self, engine: Engine) -> Engine:
        if engine.name in self._engines:
            raise ValueError(f"engine {engine.name!r} already registered")
        self._engines[engine.name] = engine
        return engine

    def get(self, name: str) -> Engine:
        eng = self._engines.get(name)
        if eng is None:
            raise ValueError(f"unknown engine {name!r} (registered: "
                             f"{', '.join(sorted(self._engines))})")
        return eng

    def names(self) -> Tuple[str, ...]:
        return tuple(self._engines)

    def device_names(self) -> Tuple[str, ...]:
        return tuple(n for n, e in self._engines.items() if e.device)


ENGINE_REGISTRY = EngineRegistry()


def get_engine(name: str) -> Engine:
    return ENGINE_REGISTRY.get(name)


def engines() -> Tuple[str, ...]:
    return ENGINE_REGISTRY.names()


def _simd_dispatch(engine_name: str) -> Callable:
    def dispatch(arrays, program, result_rows, *, n_rows, geom,
                 mesh=None, n_queues=None, faults=None):
        with telemetry.span("stage", cat="run", tid="run",
                            engine=engine_name):
            staged, tiles, waves = stage_rows(
                arrays, geom=geom,
                mesh=mesh if engine_name == "resident" else None)
        with telemetry.span("dispatch", cat="run", tid="run",
                            engine=engine_name, waves=waves, tiles=tiles,
                            aaps=len(program)):
            outs = run_waves(staged, program, result_rows, n_rows=n_rows,
                             mesh=mesh, engine=engine_name, faults=faults)
        return outs, tiles, waves
    return dispatch


def _queued_dispatch(arrays, program, result_rows, *, n_rows, geom,
                     mesh=None, n_queues=None, faults=None):
    from repro_torch.pim.queue import dispatch_uniform_queued
    return dispatch_uniform_queued(arrays, program, result_rows,
                                   n_rows=n_rows, geom=geom, mesh=mesh,
                                   n_queues=n_queues, faults=faults)


_CUDA_MESH_ERROR = ("engine 'cuda' runs unsharded — use engine='resident' "
                    "for shard_map fleet meshes")


def _cuda_dispatch(arrays, program, result_rows, *, n_rows, geom,
                   mesh=None, n_queues=None, faults=None):
    if mesh is not None:
        raise ValueError(_CUDA_MESH_ERROR)
    return _simd_dispatch("cuda")(arrays, program, result_rows,
                                  n_rows=n_rows, geom=geom, faults=faults)


def _lift_op_plain(low: "Lowered", n_bits: int,
                   tiles: Optional[int] = None,
                   waves: Optional[int] = None) -> Schedule:
    geom = low.geom
    if tiles is None:
        tiles = _ceil_div(n_bits, geom.row_bits)
    if waves is None:
        waves = _ceil_div(tiles, geom.n_subarrays)
    return Schedule(
        op=low.op, n_bits=n_bits, row_bits=geom.row_bits, tiles=tiles,
        slots=geom.n_subarrays, waves=waves, aaps_per_tile=low.aaps,
        chips=geom.chips, banks=geom.banks,
        subarrays_per_bank=geom.subarrays_per_bank, t_aap_s=geom.t_aap_s)


def _lift_op_queued(low: "Lowered", n_bits: int,
                    tiles: Optional[int] = None,
                    waves: Optional[int] = None):
    from repro_torch.pim.queue import uniform_queue_schedule
    return uniform_queue_schedule(low.op, n_bits=n_bits, geom=low.geom,
                                  tiles=tiles, waves=waves,
                                  n_queues=low.n_queues)


def _lift_graph_plain(low: "Lowered", sched):
    return sched


def _lift_graph_queued(low: "Lowered", sched):
    from repro_torch.pim.queue import fused_queue_schedule
    return fused_queue_schedule(sched, geom=low.geom,
                                n_queues=low.n_queues)


ENGINE_REGISTRY.register(Engine(
    "resident", "plain torch: the program unrolled over per-row tensors "
    "spanning every wave, only the named rows touched",
    dispatch=_simd_dispatch("resident"), lift_op=_lift_op_plain,
    lift_graph=_lift_graph_plain))
ENGINE_REGISTRY.register(Engine(
    "baseline", "the reference's first wave loop: per wave a fresh full "
    "device state, the encoded stream stepped over it one instruction at "
    "a time",
    dispatch=_simd_dispatch("baseline"), lift_op=_lift_op_plain,
    lift_graph=_lift_graph_plain))
ENGINE_REGISTRY.register(Engine(
    "queued", "per-bank command queues with independent program counters "
    "(the resident body per bank block, plain torch), contention + "
    "DMA-overlap cost model",
    dispatch=_queued_dispatch, lift_op=_lift_op_queued,
    lift_graph=_lift_graph_queued))
ENGINE_REGISTRY.register(Engine(
    "cuda", "AAP interpreter kernel: the encoded stream as data, replayed "
    "by one thread per word column over shared-memory row state (its "
    "plain replay on CPU tensors)",
    dispatch=_cuda_dispatch, lift_op=_lift_op_plain,
    lift_graph=_lift_graph_plain))
ENGINE_REGISTRY.register(Engine(
    "gpu", "native comparator: the op or graph evaluated on the run's "
    "device by the bulk bit-wise kernels, one ops.bitwise call per node "
    "(their plain versions on CPU tensors), priced by the H100 roofline",
    device=False))

# The bulk bit-wise op that evaluates each Table-2 node on the comparator
# ("copy" is an alias and launches nothing).
NATIVE_OP = {"not": "not", "xnor2": "xnor", "xor2": "xor", "maj3": "maj3",
              "add": "fa"}

# Partition strategies `lower(partition=...)` can pick.
PARTITIONERS: Dict[str, Callable[..., GraphPartition]] = {
    "greedy": partition_graph,
}


def _native_node(op: str, operands):
    """One Table-2 node on the comparator: a tuple of result tensors,
    aligned with RESULT_ROWS[op]."""
    if op == "copy":
        return (operands[0],)
    out = kops.bitwise(NATIVE_OP[op], *operands)
    return out if isinstance(out, tuple) else (out,)


def _native_graph(graph: BulkGraph, arrays: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Evaluate a graph node by node with the native kernels: the
    comparator's counterpart of `graph.graph_ref_results`, on the arrays'
    device.  A value is dropped after its last use, so the live planes are
    the graph's width, not its length (a hardened K=32 dot at 2**29 bits
    would otherwise hold ~900 planes of 64 MiB)."""
    vals = {vid: arrays[name]
            for name, vid in zip(graph.input_names, graph.input_vids)}
    keep = set(graph.outputs.values())
    last = {v: i for i, (_, opnds, _) in enumerate(graph.nodes)
            for v in opnds}
    for i, (op, opnds, res) in enumerate(graph.nodes):
        outs = _native_node(op, [vals[v] for v in opnds])
        for v, r in zip(res, outs):
            vals[v] = r
        for v in (*opnds, *res):
            if last.get(v, -1) <= i and v not in keep:
                vals.pop(v, None)
    return {name: vals[vid] for name, vid in graph.outputs.items()}


# ---------------------------------------------------------------------------
# compile(): source normalization
# ---------------------------------------------------------------------------

class Compiled:
    """A compilation unit: normalized source (Table-2 op name, BulkGraph,
    or traced program) bound to a geometry and row budget."""

    def __init__(self, *, kind: str, geom: DrimGeometry,
                 row_budget: Optional[int], op: Optional[str] = None,
                 graph: Optional[BulkGraph] = None,
                 traced: Optional[TracedProgram] = None) -> None:
        self.kind = kind                  # "op" | "graph"
        self.geom = geom
        self.row_budget = row_budget
        self.op = op
        self.graph = graph
        self.traced = traced

    def lower(self, engine: Optional[str] = None, *, mesh=None,
              n_queues: Optional[int] = None, partition=None,
              harden: Optional[str] = None,
              faults: Optional[FaultModel] = None,
              verify: Optional[bool] = None) -> "Lowered":
        """Run the pass pipeline and bind an engine: "resident" by
        default, "queued" when `partition` is set.

        partition: None, True (the "greedy" strategy), a `PARTITIONERS`
        key, or an int (the queue count, greedy): split the graph ACROSS
        `n_queues` bank queues into fence-staged per-queue segments
        (MIMD), run on engine "queued" (plain torch) or "cuda" (the AAP
        interpreter kernel).  n_queues: the queue count of the "queued"
        engine and of a partition (default `queue.default_n_queues`).

        harden: None | "tmr" | "ecc" | "tmr+ecc" -- rewrite the graph for
        fault tolerance before fusing (`pim.harden.harden_graph`); the
        extra AAPs are real program text, so `cost()` prices them.
        faults: the default `core.FaultModel` of every `run()` of this
        lowering (a per-run `run(..., faults=...)` overrides it).

        verify: run the static verifier (`pim.verify`) over the lowered
        program -- AAP-stream hazards, MIMD fence races, harden
        invariants.  Defaults on (``DRIM_VERIFY=0`` opts the process out;
        ``DRIM_VERIFY=1`` forces it on even over an explicit
        ``verify=False``).  The report lands on `Lowered.verify_report`;
        a diagnostic raises `verify.VerifyError` at lower time.

        mesh: a (chips, banks) fleet mesh (`pim.mesh.fleet_mesh`) the
        "resident" and "queued" engines and partitions shard their runs
        over; "baseline" ignores it, "cuda" and the comparator refuse it,
        and active faults with a mesh raise V020."""
        st = _LoweringState(compiled=self, engine_name=engine, mesh=mesh,
                            n_queues=n_queues, partition=partition,
                            harden=harden, faults=faults,
                            verify=verify_mod.resolve_enabled(verify))
        with telemetry.span("lower", cat="compiler", tid="compiler",
                            kind=self.kind, engine=engine or ""):
            for p in PASS_PIPELINE:
                with telemetry.span(f"pass:{p.name}", cat="compiler",
                                    tid="compiler") as sp:
                    p.fn(st)
                    sp.set(nodes=(len(st.graph.nodes)
                                  if st.graph is not None else 1),
                           aaps=st.aaps)
        return Lowered(
            kind=st.kind, engine=st.engine, geom=self.geom, mesh=st.mesh,
            n_queues=st.n_queues, partition=st.partition,
            row_budget=self.row_budget, op=self.op, graph=st.graph,
            traced=self.traced, fp=st.fp, gp=st.gp, program=st.program,
            result_rows=st.result_rows, n_rows=st.n_rows, aaps=st.aaps,
            harden=st.harden, default_faults=st.faults,
            protected_nodes=st.protected_nodes,
            verify_report=st.verify_report)


def compile(src, *, geom: Optional[DrimGeometry] = None,
            row_budget: Optional[int] = DEFAULT_ROW_BUDGET) -> Compiled:
    """ONE front door for every program source: a Table-2 op name
    ("xnor2", ...), a hand-built `BulkGraph`, a `TracedProgram` /
    `JittedFunction` from `jit`, or a plain Python function (traced on
    the spot)."""
    geom = geom if geom is not None else DRIM_R
    if isinstance(src, str):
        return Compiled(kind="op", geom=geom, row_budget=row_budget,
                        op=src)
    if isinstance(src, BulkGraph):
        return Compiled(kind="graph", geom=geom, row_budget=row_budget,
                        graph=src)
    if callable(src) and not isinstance(src, (JittedFunction,
                                              TracedProgram)):
        src = jit(src)
    if isinstance(src, JittedFunction):
        src = src.trace()
    if isinstance(src, TracedProgram):
        return Compiled(kind="graph", geom=geom, row_budget=row_budget,
                        graph=src.graph, traced=src)
    raise TypeError(
        f"cannot compile {type(src).__name__}: expected an op name, "
        "BulkGraph, TracedProgram, jit function, or callable")


# ---------------------------------------------------------------------------
# The pass pipeline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _LoweringState:
    """Mutable scratch the passes fill in order."""

    compiled: Compiled
    engine_name: Optional[str]
    mesh: Any = None
    n_queues: Optional[int] = None
    partition: Any = None
    harden: Optional[str] = None
    faults: Optional[FaultModel] = None
    kind: str = ""
    engine: Optional[Engine] = None
    graph: Optional[BulkGraph] = None     # working graph (post-harden)
    protected_nodes: frozenset = frozenset()
    fp: Optional[FusedProgram] = None
    gp: Optional[GraphPartition] = None
    program: Tuple[AAP, ...] = ()
    result_rows: Tuple[int, ...] = ()
    n_rows: int = 0
    aaps: int = 0
    verify: bool = True
    verify_report: Optional["verify_mod.VerifyReport"] = None


def _pass_canonicalize(st: _LoweringState) -> None:
    """Validate the source, resolve the engine, partition and queue
    defaults."""
    c = st.compiled
    if c.kind == "op" and c.op not in OP_ARITY:
        raise ValueError(f"unknown bulk op {c.op!r}")
    if st.partition is not None and st.partition is not False:
        if c.kind != "graph":
            raise ValueError("partition= needs a graph source; a single "
                             "Table-2 op has nothing to split")
        if isinstance(st.partition, bool):
            st.partition = "greedy"
        elif isinstance(st.partition, int):
            if st.n_queues not in (None, st.partition):
                raise ValueError("partition=<int> conflicts with n_queues")
            st.n_queues = st.partition
            st.partition = "greedy"
        if st.partition not in PARTITIONERS:
            raise ValueError(
                f"unknown partitioner {st.partition!r} (registered: "
                f"{', '.join(sorted(PARTITIONERS))})")
        if st.engine_name is None:
            st.engine_name = "queued"
        elif st.engine_name not in ("queued", "cuda"):
            raise ValueError("a partitioned graph runs on the queued "
                             f"(or cuda) engine, not {st.engine_name!r}")
    else:
        st.partition = None
    st.engine = ENGINE_REGISTRY.get(st.engine_name or "resident")
    if st.engine.name == "cuda" and st.mesh is not None:
        raise ValueError(_CUDA_MESH_ERROR)
    if not st.engine.device:
        if st.mesh is not None or st.n_queues is not None:
            raise ValueError(f"engine {st.engine.name!r} is a comparator"
                             " — mesh/n_queues do not apply")
    elif st.engine.name == "queued" or st.partition is not None:
        from repro_torch.pim.queue import resolve_n_queues
        st.n_queues = resolve_n_queues(c.geom, st.n_queues)
    elif st.n_queues is not None:
        raise ValueError(
            f"n_queues only applies to the queued engine, not "
            f"{st.engine.name!r}")
    if st.harden is not None and c.kind != "graph":
        raise ValueError("harden= needs a graph source; a single "
                         "Table-2 op has no redundancy to compile in")
    if st.faults is not None:
        if not isinstance(st.faults, FaultModel):
            raise TypeError("faults= expects a core.FaultModel")
        if st.faults.active and st.mesh is not None:
            raise verify_mod.faults_on_mesh_error()
    st.graph = c.graph
    st.kind = c.kind


def _pass_harden(st: _LoweringState) -> None:
    """Optionally rewrite the graph for fault tolerance (TMR voting
    and/or parity ECC) before fusion, so the redundancy is ordinary
    program text every engine executes and every cost model prices."""
    if st.harden is None:
        return
    from repro_torch.pim.harden import harden_graph
    st.graph, st.protected_nodes = harden_graph(st.graph, st.harden)


def _pass_fuse(st: _LoweringState) -> None:
    """Op sources pull their memoized Table-2 microprogram; graph sources
    compile to one fused AAP stream (`graph.compile_graph`)."""
    c = st.compiled
    if c.kind == "op":
        _, prog, n_aaps = encoded_program(c.op, materialize=False)
        st.program, st.aaps = prog, n_aaps
        st.result_rows = tuple(RESULT_ROWS[c.op])
        st.n_rows = N_DATA_ROWS + N_XROWS
    else:
        st.fp = compile_graph(st.graph, row_budget=c.row_budget)
        st.program = st.fp.program
        st.result_rows = st.fp.readback_rows
        st.n_rows = st.fp.template_rows
        st.aaps = st.fp.aaps_per_tile


def _pass_partition(st: _LoweringState) -> None:
    """Optionally split the graph across bank queues (MIMD)."""
    if st.partition is None:
        return
    st.gp = PARTITIONERS[st.partition](
        st.graph, st.n_queues, row_budget=st.compiled.row_budget)
    st.kind = "partition"
    st.aaps = st.gp.critical_path_aaps_per_tile


def _pass_encode(st: _LoweringState) -> None:
    """Freeze program streams to hashable AAP tuples, the form the wave
    engines key their memos on."""
    st.program = tuple(st.program)
    st.result_rows = tuple(st.result_rows)


def _pass_verify(st: _LoweringState) -> None:
    """Static verification of the lowered program (`pim.verify`):
    AAP-stream hazard analysis over the fused stream, fence
    happens-before over MIMD partitions, harden structural invariants.
    It checks the AAP program, not the "cuda" engine's packed stream,
    as the reference checks the program its interpreter replays.  Raises
    `verify.VerifyError` on the first diagnostic; the clean report lands
    on `Lowered.verify_report`."""
    if not st.verify:
        return
    st.verify_report = verify_mod.verify_state(st)


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    fn: Callable[[_LoweringState], None]


PASS_PIPELINE: Tuple[Pass, ...] = (
    Pass("canonicalize", _pass_canonicalize),
    Pass("harden", _pass_harden),
    Pass("fuse", _pass_fuse),
    Pass("partition", _pass_partition),
    Pass("encode", _pass_encode),
    Pass("verify", _pass_verify),
)


# ---------------------------------------------------------------------------
# Lowered: run / cost
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EccReport:
    """Host-side parity verdict of one `harden="ecc"` run: the primary
    outputs xor-reduced against the device parity row."""

    mismatch_bits: int                 # popcount of the parity diff
    words: int                         # parity row width compared

    @property
    def corrupted(self) -> bool:
        return self.mismatch_bits > 0


def _popcount(words: torch.Tensor) -> int:
    """Set bits of an int32 word tensor, on its device."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


class Lowered:
    """A program bound to an engine, a geometry, a fleet mesh, a queue
    count and a partition.

    `run(...)` executes on the simulated fleet and records the measured
    schedule on `self.schedule` (and, for partitioned runs, what dead
    queues it survived on `self.chaos_report`); `cost(n_bits)` prices a
    payload in closed form without touching the simulator."""

    def __init__(self, *, kind, engine, geom, row_budget, op, graph, traced,
                 fp, program, result_rows, n_rows, aaps, mesh=None,
                 n_queues=None, partition=None, gp=None, harden=None,
                 default_faults=None,
                 protected_nodes=frozenset(), verify_report=None) -> None:
        self.kind = kind
        self.engine = engine
        self.geom = geom
        self.mesh = mesh
        self.n_queues = n_queues
        self.partition = partition
        self.row_budget = row_budget
        self.op = op
        self.graph = graph
        self.traced = traced
        self.fp = fp
        self.gp = gp
        self.program = program
        self.result_rows = result_rows
        self.n_rows = n_rows
        self.aaps = aaps
        self.harden = harden
        self.default_faults = default_faults
        self.protected_nodes = frozenset(protected_nodes)
        self.verify_report = verify_report   # pim.verify, when enabled
        self.schedule = None          # measured by the last run()
        self.last_ecc = None          # EccReport of the last ecc run()
        self.chaos_report = None      # ChaosReport of the last run()

    def _resolve_faults(self, faults):
        """Per-run faults override the lowering default; hardened
        lowerings add their protected op spans (voter/parity AAPs run on
        guard-banded sense amplifiers and never flip); the comparator
        ignores faults (the clean native answer is the fallback)."""
        if faults is None:
            faults = self.default_faults
        if faults is None or not self.engine.device:
            return None
        if not isinstance(faults, FaultModel):
            raise TypeError("faults= expects a core.FaultModel")
        if not faults.active:
            return None
        if self.mesh is not None:
            raise verify_mod.faults_on_mesh_error()
        if self.protected_nodes and self.fp is not None:
            spans = {i: (lo, hi) for i, lo, hi in self.fp.node_spans}
            ops = [k for i in self.protected_nodes
                   for k in range(*spans[i])]
            faults = faults.with_protected(ops)
        return faults

    def _check_ecc(self, results):
        """Host side of the parity scheme: xor-reduce the primary outputs
        and diff against the device parity row."""
        parity = results.pop("__ecc__")
        expect = torch.zeros_like(parity)
        for arr in results.values():
            expect = expect ^ arr
        self.last_ecc = EccReport(mismatch_bits=_popcount(parity ^ expect),
                                  words=int(parity.numel()))
        return results

    def run(self, *args, n_bits: Optional[int] = None, device=None,
            faults: Optional[FaultModel] = None):
        """Execute on `device` (None: the CUDA card; there is no fallback).

        Op sources take positional word arrays (one per operand) and
        return a tuple of int32 word tensors; graph sources take a
        {input_name: array} dict or -- for traced programs -- positional
        arrays in the traced argument order, and return outputs shaped
        like the traced function's own return value (a dict for
        hand-built graphs).  Inputs may be numpy arrays or tensors of
        32-bit words; they are moved to `device`.

        faults: a `core.FaultModel` for THIS run only (overrides the
        lowering-time default).  With `harden="ecc"` lowerings the
        detection evidence of each run lands on `self.last_ecc`.

        Armed telemetry wraps the run in a "Lowered.run" span, and a
        partitioned run also records its simulated-clock queue timeline
        (`telemetry.record_queue_timeline`)."""
        dev = resolve_device(device)
        with telemetry.span("Lowered.run", cat="run", tid="run",
                            kind=self.kind, engine=self.engine.name,
                            op=self.op or "", aaps=self.aaps):
            out = self._run(args, n_bits, dev, faults)
        if telemetry.enabled() and self.kind == "partition":
            telemetry.record_queue_timeline(self)
        return out

    def _run(self, args, n_bits, dev, faults):
        faults = self._resolve_faults(faults)
        if self.kind == "op":
            return self._run_op(args, n_bits, dev, faults)
        if self.traced is not None and not (
                len(args) == 1 and isinstance(args[0], dict)):
            feeds = self.traced.feeds_for(args)
        elif len(args) == 1 and isinstance(args[0], dict):
            feeds = dict(args[0])
            if self.traced is not None:
                for cname in self.traced.const_names:
                    if cname not in feeds:
                        n_words = int(np.prod(tuple(
                            next(iter(feeds.values())).shape)))
                        feeds[cname] = np.zeros(n_words, np.uint32)
        else:
            raise ValueError("graph lowering expects a feeds dict (or "
                             "positional planes for traced programs)")
        outs = (self._run_partitioned(feeds, n_bits, dev, faults)
                if self.kind == "partition"
                else self._run_graph(feeds, n_bits, dev, faults))
        if self.harden is not None and "ecc" in self.harden:
            outs = self._check_ecc(dict(outs))
        if self.traced is not None:
            return self.traced.restructure(outs)
        return outs

    def _run_op(self, operands, n_bits, dev, faults=None):
        arity = OP_ARITY[self.op]
        if len(operands) != arity:
            raise ValueError(f"{self.op} takes {arity} operands, got "
                             f"{len(operands)}")
        ops = [as_words(x, dev).reshape(-1) for x in operands]
        n_words = ops[0].shape[0]
        if any(o.shape[0] != n_words for o in ops):
            raise ValueError("operands must have equal length")
        if n_bits is None:
            n_bits = n_words * WORD_BITS
        if not 0 < n_bits <= n_words * WORD_BITS:
            raise ValueError("n_bits out of range for the given operands")
        if not self.engine.device:
            self.schedule = self.cost(n_bits)
            return _native_node(self.op, ops)
        outs, tiles, waves = self.engine.dispatch(
            ops, self.program, self.result_rows, n_rows=self.n_rows,
            geom=self.geom, mesh=self.mesh, n_queues=self.n_queues,
            faults=faults)
        with telemetry.span("readback", cat="run", tid="run", op=self.op):
            results = tuple(outs[:, i].reshape(-1)[:n_words]
                            for i in range(len(self.result_rows)))
        self.schedule = self.engine.lift_op(self, n_bits, tiles, waves)
        return results

    def _check_feeds(self, feeds, dev) -> Tuple[Dict[str, torch.Tensor], int]:
        names = self.graph.input_names
        missing = set(names) - set(feeds)
        extra = set(feeds) - set(names)
        if missing or extra:
            raise ValueError(f"feed mismatch: missing {sorted(missing)}, "
                             f"unexpected {sorted(extra)}")
        arrays = {n: as_words(feeds[n], dev).reshape(-1) for n in names}
        n_words = next(iter(arrays.values())).shape[0]
        if any(a.shape[0] != n_words for a in arrays.values()):
            raise ValueError("graph inputs must have equal length")
        return arrays, n_words

    def _resolve_n_bits(self, n_bits, n_words):
        if n_bits is None:
            return n_words * WORD_BITS
        # n_bits marks a ragged tail INSIDE the last word only; oversized
        # feeds would make the executed wave count silently disagree with
        # the closed-form cost, so reject them.
        if not (n_words - 1) * WORD_BITS < n_bits <= n_words * WORD_BITS:
            raise ValueError(
                f"n_bits={n_bits} does not match feeds of {n_words} "
                f"words; expected a value in "
                f"({(n_words - 1) * WORD_BITS}, {n_words * WORD_BITS}]")
        return n_bits

    def _run_graph(self, feeds, n_bits, dev, faults=None):
        arrays, n_words = self._check_feeds(feeds, dev)
        n_bits = self._resolve_n_bits(n_bits, n_words)
        if not self.engine.device:
            self.schedule = self.cost(n_bits)
            return _native_graph(self.graph, arrays)
        fp, geom = self.fp, self.geom
        tiles = _ceil_div(n_bits, geom.row_bits)
        waves = _ceil_div(tiles, geom.n_subarrays)
        results = {name: arrays[src] for name, src in fp.alias_outputs}
        if fp.device_outputs:
            outs, tiles, waves = self.engine.dispatch(
                [arrays[n] for n in fp.loaded_inputs], fp.program,
                fp.readback_rows, n_rows=fp.template_rows, geom=geom,
                mesh=self.mesh, n_queues=self.n_queues, faults=faults)
            col = {row: i for i, row in enumerate(fp.readback_rows)}
            with telemetry.span("readback", cat="run", tid="run",
                                outputs=len(fp.device_outputs)):
                for name, row in fp.device_outputs:
                    results[name] = outs[:, col[row]].reshape(-1)[:n_words]
        sched = _make_fused_schedule(fp, n_bits, tiles, waves, geom)
        self.schedule = self.engine.lift_graph(self, sched)
        return results

    def _run_partitioned(self, feeds, n_bits, dev, faults=None):
        from repro_torch.pim.queue import _execute_partitioned
        arrays, n_words = self._check_feeds(feeds, dev)
        n_bits = self._resolve_n_bits(n_bits, n_words)
        results, sched, chaos = _execute_partitioned(
            self.graph, arrays, gp=self.gp, geom=self.geom, n_bits=n_bits,
            mesh=self.mesh, body_engine=self.engine.name, faults=faults,
            protected_nodes=self.protected_nodes)
        self.schedule = sched
        self.chaos_report = chaos
        return results

    def cost(self, n_bits: int):
        """Closed-form schedule for an `n_bits` payload: identical numbers
        to what `run()` measures on the same payload."""
        if n_bits <= 0:
            raise ValueError("n_bits must be positive")
        if not self.engine.device:
            return gpu_cost(self, n_bits)
        if self.kind == "op":
            return self.engine.lift_op(self, n_bits)
        if self.kind == "partition":
            from repro_torch.pim.queue import partitioned_queue_schedule
            return partitioned_queue_schedule(self.gp, n_bits=n_bits,
                                              geom=self.geom)
        geom = self.geom
        tiles = _ceil_div(n_bits, geom.row_bits)
        waves = _ceil_div(tiles, geom.n_subarrays)
        sched = _make_fused_schedule(self.fp, n_bits, tiles, waves, geom)
        return self.engine.lift_graph(self, sched)

    def verdict(self, n_bits: int, *, simulate: bool = False, device=None):
        """The DRIM-vs-GPU placement verdict (`offload.Verdict`): every
        contender priced with the same row fields, the winner by latency.
        `simulate=True` runs the program on `device` (None: the card)
        with seeded operands and prices the measured schedule."""
        from repro_torch.pim.offload import build_verdict
        return build_verdict(self, n_bits, simulate=simulate, device=device)

    def __repr__(self) -> str:
        src = self.op if self.kind == "op" else (
            self.traced.name if self.traced is not None
            else f"graph[{len(self.graph.nodes)}]")
        extra = f", partition={self.partition!r}" if self.partition else ""
        return (f"Lowered({src}, engine={self.engine.name!r}, "
                f"geom={self.geom.chips}x{self.geom.banks}x"
                f"{self.geom.subarrays_per_bank}{extra})")


def lower(src, *, geom: Optional[DrimGeometry] = None,
          engine: Optional[str] = None, mesh=None,
          n_queues: Optional[int] = None, partition=None,
          harden: Optional[str] = None,
          faults: Optional[FaultModel] = None,
          row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
          verify: Optional[bool] = None) -> Lowered:
    """Convenience: `compile(src).lower(...)` in one call."""
    return compile(src, geom=geom, row_budget=row_budget).lower(
        engine=engine, mesh=mesh, n_queues=n_queues, partition=partition,
        harden=harden, faults=faults, verify=verify)


# ---------------------------------------------------------------------------
# Process-wide lowering memo: the serving hot path
# ---------------------------------------------------------------------------

_LOWER_CACHE: Dict[Tuple, Lowered] = {}

# A serving loop must pay trace + compile + lower once per kernel shape,
# never once per call; tests read the hit/miss counts.  It IS the
# telemetry registry's "lower_cache" namespace (the same Counter object),
# so `telemetry.snapshot()` and `telemetry.fresh()` see it.
LOWER_CACHE_STATS: collections.Counter = \
    telemetry.REGISTRY.counters("lower_cache")


def clear_lower_cache() -> None:
    _LOWER_CACHE.clear()
    LOWER_CACHE_STATS.clear()


def lower_cached(src, *, key: Optional[Tuple] = None,
                 geom: Optional[DrimGeometry] = None,
                 engine: Optional[str] = None, mesh=None,
                 n_queues: Optional[int] = None, partition=None,
                 harden: Optional[str] = None,
                 faults: Optional[FaultModel] = None,
                 row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
                 verify: Optional[bool] = None) -> Lowered:
    """`compile(src).lower(...)` memoized for the life of the process.

    `src` itself keys the memo when hashable; pass an explicit `key`
    identifying the program for unhashable sources or when the source
    object is rebuilt per call.  The mesh is part of the key (a `Mesh` is
    a hashable value)."""
    ident: Any = key if key is not None else src
    try:
        hash(ident)
    except TypeError:
        raise TypeError(
            "lower_cached needs a hashable src or an explicit key= "
            "identifying the program") from None
    # The resolved verify flag keys the memo, not the raw argument:
    # DRIM_VERIFY may differ between calls, and a caller who pinned
    # verification on must not get an unverified lowering.
    verify_on = verify_mod.resolve_enabled(verify)
    full_key = (ident, geom, engine, mesh, n_queues, partition, harden,
                faults, row_budget, verify_on)
    low = _LOWER_CACHE.get(full_key)
    if low is None:
        LOWER_CACHE_STATS["misses"] += 1
        low = compile(src, geom=geom, row_budget=row_budget).lower(
            engine=engine, mesh=mesh, n_queues=n_queues,
            partition=partition, harden=harden, faults=faults,
            verify=verify_on)
        _LOWER_CACHE[full_key] = low
    else:
        LOWER_CACHE_STATS["hits"] += 1
    return low
