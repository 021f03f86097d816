"""The staged DRIM pipeline: ONE `compile -> lower -> run` path (port of
`repro.pim.compiler`).

    low = compile(src, geom=...)        # src: op name | BulkGraph |
          .lower(engine=...)            #      TracedProgram | jit function
    out = low.run(..., device=...)      # measured low.schedule
    low.cost(n_bits)                    # closed-form schedule

`lower()` runs a registered pass pipeline -- canonicalize -> fuse ->
encode (`PASS_PIPELINE`) -- and engines live in one `EngineRegistry`:
"resident" (plain torch, the default) and "cuda" (the AAP interpreter
kernel; its plain replay on CPU tensors).  The reference's hardening,
MIMD partitioning, fault injection, fleet meshes and static verifier are
later slices of the port: their arguments raise NotImplementedError
naming the ROADMAP item, and are never silently ignored.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import AAP, DRIM_R, DrimGeometry
from repro_torch.core.subarray import N_XROWS, WORD_BITS, as_words
from repro_torch.device import resolve_device
from repro_torch.pim.frontend import JittedFunction, TracedProgram, jit
from repro_torch.pim.graph import (DEFAULT_ROW_BUDGET, BulkGraph,
                                   FusedProgram, _make_fused_schedule,
                                   compile_graph)
from repro_torch.pim.scheduler import (N_DATA_ROWS, OP_ARITY, RESULT_ROWS,
                                       Schedule, _ceil_div, encoded_program,
                                       run_waves, stage_rows)

# Lowering arguments of the reference that later slices port, with the
# ROADMAP Queue-1 item that brings each.
_NOT_PORTED = {
    "harden": "Queue 1 item 7 (core/faults.py + pim/harden.py)",
    "faults": "Queue 1 item 7 (core/faults.py + pim/harden.py)",
    "partition": "Queue 1 item 9 (partition_graph + pim/queue.py)",
    "n_queues": "Queue 1 item 9 (the queued engine)",
    "mesh": "Queue 1 item 9 (pim/mesh.py fleet meshes)",
    "verify": "Queue 1 item 10 (pim/verify.py)",
}


def _reject_not_ported(**given) -> None:
    """Raise for any later-slice lowering argument that was actually set
    (None and False mean unset; `verify=False` asks for no verifier)."""
    for arg, value in given.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{arg}= is not ported to repro_torch yet: ROADMAP "
                f"{_NOT_PORTED[arg]}")


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """One execution backend.  `dispatch(arrays, program, result_rows,
    n_rows=, geom=) -> (outs, tiles, waves)` stages the payload and runs
    one uniform program over it."""

    name: str
    description: str
    dispatch: Callable


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


ENGINE_REGISTRY = EngineRegistry()


def get_engine(name: str) -> Engine:
    return ENGINE_REGISTRY.get(name)


def engines() -> Tuple[str, ...]:
    return ENGINE_REGISTRY.names()


def _simd_dispatch(engine_name: str) -> Callable:
    def dispatch(arrays, program, result_rows, *, n_rows, geom):
        staged, tiles, waves = stage_rows(arrays, geom=geom)
        outs = run_waves(staged, program, result_rows, n_rows=n_rows,
                         engine=engine_name)
        return outs, tiles, waves
    return dispatch


ENGINE_REGISTRY.register(Engine(
    "resident", "plain torch: the program unrolled over per-row tensors "
    "spanning every wave, only the named rows touched",
    dispatch=_simd_dispatch("resident")))
ENGINE_REGISTRY.register(Engine(
    "cuda", "AAP interpreter kernel: the encoded stream as data, replayed "
    "by one thread per word column over shared-memory row state (its "
    "plain replay on CPU tensors)",
    dispatch=_simd_dispatch("cuda")))


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
              harden: Optional[str] = None, faults=None,
              verify: Optional[bool] = None) -> "Lowered":
        """Run the pass pipeline and bind an engine ("resident" by
        default).  `mesh`, `n_queues`, `partition`, `harden`, `faults` and
        `verify=True` belong to later slices and raise
        NotImplementedError."""
        _reject_not_ported(mesh=mesh, n_queues=n_queues,
                           partition=partition, harden=harden,
                           faults=faults, verify=verify)
        st = _LoweringState(compiled=self, engine_name=engine)
        for p in PASS_PIPELINE:
            p.fn(st)
        return Lowered(
            kind=st.kind, engine=st.engine, geom=self.geom,
            row_budget=self.row_budget, op=self.op, graph=st.graph,
            traced=self.traced, fp=st.fp, program=st.program,
            result_rows=st.result_rows, n_rows=st.n_rows, aaps=st.aaps)


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
    kind: str = ""
    engine: Optional[Engine] = None
    graph: Optional[BulkGraph] = None
    fp: Optional[FusedProgram] = None
    program: Tuple[AAP, ...] = ()
    result_rows: Tuple[int, ...] = ()
    n_rows: int = 0
    aaps: int = 0


def _pass_canonicalize(st: _LoweringState) -> None:
    """Validate the source and resolve the engine."""
    c = st.compiled
    if c.kind == "op" and c.op not in OP_ARITY:
        raise ValueError(f"unknown bulk op {c.op!r}")
    st.engine = ENGINE_REGISTRY.get(st.engine_name or "resident")
    st.graph = c.graph
    st.kind = c.kind


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


def _pass_encode(st: _LoweringState) -> None:
    """Freeze program streams to hashable AAP tuples, the form the wave
    engines key their memos on."""
    st.program = tuple(st.program)
    st.result_rows = tuple(st.result_rows)


@dataclasses.dataclass(frozen=True)
class Pass:
    name: str
    fn: Callable[[_LoweringState], None]


PASS_PIPELINE: Tuple[Pass, ...] = (
    Pass("canonicalize", _pass_canonicalize),
    Pass("fuse", _pass_fuse),
    Pass("encode", _pass_encode),
)


# ---------------------------------------------------------------------------
# Lowered: run / cost
# ---------------------------------------------------------------------------

class Lowered:
    """A program bound to an engine and a geometry.

    `run(...)` executes on the simulated fleet and records the measured
    schedule on `self.schedule`; `cost(n_bits)` prices a payload in closed
    form without touching the simulator."""

    def __init__(self, *, kind, engine, geom, row_budget, op, graph, traced,
                 fp, program, result_rows, n_rows, aaps) -> None:
        self.kind = kind
        self.engine = engine
        self.geom = geom
        self.row_budget = row_budget
        self.op = op
        self.graph = graph
        self.traced = traced
        self.fp = fp
        self.program = program
        self.result_rows = result_rows
        self.n_rows = n_rows
        self.aaps = aaps
        self.schedule = None          # measured by the last run()

    def run(self, *args, n_bits: Optional[int] = None, device=None):
        """Execute on `device` (None: the CUDA card; there is no fallback).

        Op sources take positional word arrays (one per operand) and
        return a tuple of int32 word tensors; graph sources take a
        {input_name: array} dict or -- for traced programs -- positional
        arrays in the traced argument order, and return outputs shaped
        like the traced function's own return value (a dict for
        hand-built graphs).  Inputs may be numpy arrays or tensors of
        32-bit words; they are moved to `device`."""
        dev = resolve_device(device)
        if self.kind == "op":
            return self._run_op(args, n_bits, dev)
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
        outs = self._run_graph(feeds, n_bits, dev)
        if self.traced is not None:
            return self.traced.restructure(outs)
        return outs

    def _run_op(self, operands, n_bits, dev):
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
        outs, tiles, waves = self.engine.dispatch(
            ops, self.program, self.result_rows, n_rows=self.n_rows,
            geom=self.geom)
        results = tuple(outs[:, i].reshape(-1)[:n_words]
                        for i in range(len(self.result_rows)))
        self.schedule = self._op_schedule(n_bits, tiles, waves)
        return results

    def _op_schedule(self, n_bits: int, tiles: int, waves: int) -> Schedule:
        geom = self.geom
        return Schedule(
            op=self.op, n_bits=n_bits, row_bits=geom.row_bits, tiles=tiles,
            slots=geom.n_subarrays, waves=waves, aaps_per_tile=self.aaps,
            chips=geom.chips, banks=geom.banks,
            subarrays_per_bank=geom.subarrays_per_bank,
            t_aap_s=geom.t_aap_s)

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

    def _run_graph(self, feeds, n_bits, dev):
        arrays, n_words = self._check_feeds(feeds, dev)
        n_bits = self._resolve_n_bits(n_bits, n_words)
        fp, geom = self.fp, self.geom
        tiles = _ceil_div(n_bits, geom.row_bits)
        waves = _ceil_div(tiles, geom.n_subarrays)
        results = {name: arrays[src] for name, src in fp.alias_outputs}
        if fp.device_outputs:
            outs, tiles, waves = self.engine.dispatch(
                [arrays[n] for n in fp.loaded_inputs], fp.program,
                fp.readback_rows, n_rows=fp.template_rows, geom=geom)
            col = {row: i for i, row in enumerate(fp.readback_rows)}
            for name, row in fp.device_outputs:
                results[name] = outs[:, col[row]].reshape(-1)[:n_words]
        self.schedule = _make_fused_schedule(fp, n_bits, tiles, waves, geom)
        return results

    def cost(self, n_bits: int):
        """Closed-form schedule for an `n_bits` payload: identical numbers
        to what `run()` measures on the same payload."""
        if n_bits <= 0:
            raise ValueError("n_bits must be positive")
        geom = self.geom
        tiles = _ceil_div(n_bits, geom.row_bits)
        waves = _ceil_div(tiles, geom.n_subarrays)
        if self.kind == "op":
            return self._op_schedule(n_bits, tiles, waves)
        return _make_fused_schedule(self.fp, n_bits, tiles, waves, geom)

    def __repr__(self) -> str:
        src = self.op if self.kind == "op" else (
            self.traced.name if self.traced is not None
            else f"graph[{len(self.graph.nodes)}]")
        return (f"Lowered({src}, engine={self.engine.name!r}, "
                f"geom={self.geom.chips}x{self.geom.banks}x"
                f"{self.geom.subarrays_per_bank})")


# ---------------------------------------------------------------------------
# Process-wide lowering memo: the serving hot path
# ---------------------------------------------------------------------------

_LOWER_CACHE: Dict[Tuple, Lowered] = {}

# A serving loop must pay trace + compile + lower once per kernel shape,
# never once per call; tests read the hit/miss counts.
LOWER_CACHE_STATS: collections.Counter = collections.Counter()


def clear_lower_cache() -> None:
    _LOWER_CACHE.clear()
    LOWER_CACHE_STATS.clear()


def lower_cached(src, *, key: Optional[Tuple] = None,
                 geom: Optional[DrimGeometry] = None,
                 engine: Optional[str] = None,
                 row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
                 **later_slices) -> Lowered:
    """`compile(src).lower(...)` memoized for the life of the process.

    `src` itself keys the memo when hashable; pass an explicit `key`
    identifying the program for unhashable sources or when the source
    object is rebuilt per call."""
    _reject_not_ported(**later_slices)
    ident: Any = key if key is not None else src
    try:
        hash(ident)
    except TypeError:
        raise TypeError(
            "lower_cached needs a hashable src or an explicit key= "
            "identifying the program") from None
    full_key = (ident, geom, engine, row_budget)
    low = _LOWER_CACHE.get(full_key)
    if low is None:
        LOWER_CACHE_STATS["misses"] += 1
        low = compile(src, geom=geom, row_budget=row_budget).lower(
            engine=engine)
        _LOWER_CACHE[full_key] = low
    else:
        LOWER_CACHE_STATS["hits"] += 1
    return low
