"""Fused bulk-op dataflow graphs: whole DAGs as ONE in-DRAM program
(port of `repro.pim.graph`, without MIMD partitioning).

A DAG of dependent bulk ops over named tensors is compiled -- data rows
allocated per slot, operands loaded once, intermediates resident, dead
rows recycled -- into ONE concatenated AAP stream that every (chip, bank,
subarray) slot executes per wave.  Two fusion-only optimizations follow
from the hardware model:

  * copy elision -- `copy` nodes become row aliases (0 AAPs);
  * destructive-read elision -- DRA/TRA charge sharing overwrites its
    source rows (paper Fig. 6), so an operand whose row dies at this op
    is read in place: `xnor2` collapses from 3 AAPs to the single-cycle
    DRA, `xor2` 4 -> 2, `maj3` 4 -> 1.

`FusedSchedule` extends the measured cost model with the unfused
comparison (per-tile AAPs and DDR row movements of the op-by-op chain).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import AAP, DRIM_R, OP_COPY, OP_DRA, OP_TRA, \
    DrimGeometry, cost, make_subarray, microprogram_add, microprogram_not
from repro_torch.core.energy import (E_ACCESS_NJ_PER_KB, E_AAP_NJ_PER_KB,
                                     E_IO_NJ_PER_KB)
from repro_torch.core.subarray import N_XROWS, SubArray, WORD_BITS
from repro_torch.core.timing import ddr_rows_s
from repro_torch.pim.scheduler import (OP_ARITY, RESULT_ROWS, Schedule,
                                       _ceil_div, build_program)

# Ops whose charge-sharing read may consume a dying operand row directly.
_CONSUMING_OPS = frozenset({"xnor2", "xor2", "maj3"})
_N_RESULTS = {op: len(rows) for op, rows in RESULT_ROWS.items()}

# Default per-slot row budget: a 512-row paper sub-array keeps ~500 data
# rows after the compute/DCC region, so a graph that needs more
# simultaneously-live values than that cannot run on real hardware.
DEFAULT_ROW_BUDGET = 500


@dataclasses.dataclass(frozen=True)
class ValueRef:
    """Handle to one SSA value (an input or a node result) of a graph."""

    graph_id: int
    vid: int


class BulkGraph:
    """A DAG of bulk bit-wise ops over named tensors.

    Build with `input()` / `op()` / `output()`; every `op()` returns
    ValueRef handles (a tuple for `add`, which produces sum and carry).
    Nodes are recorded in construction order, which is a topological
    order by construction — an operand must already exist to be passed.
    """

    _next_id = 0

    def __init__(self) -> None:
        BulkGraph._next_id += 1
        self._gid = BulkGraph._next_id
        self.input_names: List[str] = []
        self.input_vids: List[int] = []
        self.nodes: List[Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = []
        self.outputs: Dict[str, int] = {}
        self._n_values = 0

    # -- construction ------------------------------------------------------
    def _new_value(self) -> int:
        self._n_values += 1
        return self._n_values - 1

    def input(self, name: str) -> ValueRef:
        if name in self.input_names:
            raise ValueError(f"duplicate input name {name!r}")
        vid = self._new_value()
        self.input_names.append(name)
        self.input_vids.append(vid)
        return ValueRef(self._gid, vid)

    def op(self, opname: str, *operands: ValueRef):
        if opname not in OP_ARITY:
            raise ValueError(f"unknown bulk op {opname!r}")
        if len(operands) != OP_ARITY[opname]:
            raise ValueError(f"{opname} takes {OP_ARITY[opname]} operands, "
                             f"got {len(operands)}")
        for o in operands:
            if not isinstance(o, ValueRef) or o.graph_id != self._gid:
                raise ValueError("operand is not a value of this graph")
        res = tuple(self._new_value() for _ in range(_N_RESULTS[opname]))
        self.nodes.append((opname, tuple(o.vid for o in operands), res))
        refs = tuple(ValueRef(self._gid, v) for v in res)
        return refs if len(refs) > 1 else refs[0]

    def output(self, name: str, value: ValueRef) -> None:
        if name in self.outputs:
            raise ValueError(f"duplicate output name {name!r}")
        if not isinstance(value, ValueRef) or value.graph_id != self._gid:
            raise ValueError("output is not a value of this graph")
        self.outputs[name] = value.vid

    # -- bookkeeping used by the compiler / oracles ------------------------
    @property
    def n_inputs(self) -> int:
        return len(self.input_vids)

    @property
    def n_outputs(self) -> int:
        return len(self.outputs)


def graph_ref_results(graph: BulkGraph, feeds: Dict[str, np.ndarray],
                      ) -> Dict[str, np.ndarray]:
    """Pure-numpy oracle: evaluate the DAG with uint32 bitwise semantics,
    no device involved."""
    vals: Dict[int, np.ndarray] = {}
    for name, vid in zip(graph.input_names, graph.input_vids):
        vals[vid] = np.asarray(feeds[name], dtype=np.uint32)
    for opname, opnds, res in graph.nodes:
        a = [vals[v] for v in opnds]
        if opname == "copy":
            out = (a[0],)
        elif opname == "not":
            out = (~a[0],)
        elif opname == "xnor2":
            out = (~(a[0] ^ a[1]),)
        elif opname == "xor2":
            out = (a[0] ^ a[1],)
        elif opname == "maj3":
            out = ((a[0] & a[1]) | (a[0] & a[2]) | (a[1] & a[2]),)
        else:  # add
            out = (a[0] ^ a[1] ^ a[2],
                   (a[0] & a[1]) | (a[0] & a[2]) | (a[1] & a[2]))
        for v, r in zip(res, out):
            vals[v] = r
    return {name: vals[vid] for name, vid in graph.outputs.items()}


# ---------------------------------------------------------------------------
# Compilation: row allocation + fused AAP emission
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedProgram:
    """A compiled graph: one AAP stream + the row map to drive it.

    Only inputs some emitted AAP actually reads are loaded (an input
    used purely by `copy` aliases or not at all never crosses the bus),
    and outputs whose value IS a graph input are satisfied host-side
    from the feed — the device reads back only `readback_rows`, the
    distinct rows holding genuine node results.
    """

    program: Tuple[AAP, ...]
    n_data_rows: int                    # peak data rows any slot needs
    loaded_inputs: Tuple[str, ...]      # staged into rows 0.., feed order
    alias_outputs: Tuple[Tuple[str, str], ...]   # (output, input) pairs
    device_outputs: Tuple[Tuple[str, int], ...]  # (output, row) pairs
    readback_rows: Tuple[int, ...]      # distinct device-output rows
    n_nodes: int
    unfused_aaps_per_tile: int      # Table-2 sum of the op-by-op chain
    unfused_ddr_rows_per_tile: int  # per-op loads + readbacks of that chain
    # (node index, first AAP, one-past-last AAP) per emitting node —
    # how graph-level properties (a hardened voter's protected status)
    # map onto positions in the fused stream.  Copies emit nothing and
    # have no span.
    node_spans: Tuple[Tuple[int, int, int], ...] = ()

    @property
    def aaps_per_tile(self) -> int:
        return len(self.program)

    @property
    def ddr_rows_per_tile(self) -> int:
        """Fused DDR traffic: operand rows in once, result rows out once."""
        return len(self.loaded_inputs) + len(self.readback_rows)

    @property
    def template_rows(self) -> int:
        """Total normal rows of the emission template (data + x rows);
        program addresses >= this are DCC word-lines.  The unrolled wave
        engine needs it to resolve addresses statically."""
        return max(self.n_data_rows, 1) + N_XROWS


def compile_graph(graph: BulkGraph, *,
                  row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
                  ) -> FusedProgram:
    """Allocate data rows and emit the fused AAP stream.

    Allocation is linear-scan over the topological node order: loaded
    inputs take the leading rows in feed order (so one contiguous DDR
    window write stages a wave), each result takes the lowest free row,
    and a row is recycled the moment the last ROW reader of its value
    retires.  `copy` aliases its operand's storage (values sharing
    storage share liveness; copies themselves never touch a row), and
    device-output storages are pinned to the end.
    """
    if not graph.outputs:
        raise ValueError("graph has no outputs")

    # -- storage assignment (copy -> alias) and liveness -------------------
    storage_of: Dict[int, int] = {}
    n_storage = 0
    for vid in graph.input_vids:
        storage_of[vid] = n_storage
        n_storage += 1
    for opname, opnds, res in graph.nodes:
        if opname == "copy":
            storage_of[res[0]] = storage_of[opnds[0]]
        else:
            for v in res:
                storage_of[v] = n_storage
                n_storage += 1

    # Liveness counts ROW readers only: emitting nodes (copies are pure
    # renames) and host readback of device outputs.
    n_nodes = len(graph.nodes)
    last_use = [-1] * n_storage                      # -1: row never read
    for i, (opname, opnds, _) in enumerate(graph.nodes):
        if opname == "copy":
            continue
        for v in opnds:
            last_use[storage_of[v]] = i

    input_name_of = {storage_of[vid]: name for name, vid
                     in zip(graph.input_names, graph.input_vids)}
    alias_outputs: List[Tuple[str, str]] = []
    device_output_storages: List[Tuple[str, int]] = []
    for name, vid in graph.outputs.items():
        s = storage_of[vid]
        if s in input_name_of:
            # The value IS a graph input — hand the feed straight back,
            # no load, no readback.
            alias_outputs.append((name, input_name_of[s]))
        else:
            last_use[s] = n_nodes                    # pinned to the end
            device_output_storages.append((name, s))

    # -- linear-scan row allocation ----------------------------------------
    row_of = [-1] * n_storage
    loaded_inputs = [input_name_of[s] for s in sorted(input_name_of)
                     if last_use[s] >= 0]
    free_rows: List[int] = []
    n_rows = 0
    for s in sorted(input_name_of):
        if last_use[s] >= 0:
            row_of[s] = n_rows
            n_rows += 1

    def alloc() -> int:
        nonlocal n_rows
        if free_rows:
            free_rows.sort()
            return free_rows.pop(0)
        n_rows += 1
        return n_rows - 1

    plan = []   # (node idx, opname, operand_rows, consumed_flags, res_rows)
    for i, (opname, opnds, res) in enumerate(graph.nodes):
        if opname == "copy":
            continue
        storages = [storage_of[v] for v in opnds]
        rows = tuple(row_of[s] for s in storages)

        # Destructive-read elision: a charge-sharing op may read a data
        # row in place when that row dies here and no other operand slot
        # of this op still needs its pre-op value.
        consumed: List[bool] = []
        taken: set = set()
        for s in storages:
            ok = (opname in _CONSUMING_OPS and last_use[s] == i
                  and s not in taken)
            if ok:
                taken.add(s)
            consumed.append(ok)

        # Recycle dying operand rows before allocating results: every op
        # either consumes the row with its final charge-share or has
        # copied the operand into x/DCC scratch before any result write,
        # so a result may safely reuse an operand's row in place.
        for s in set(storages):
            if last_use[s] == i:
                free_rows.append(row_of[s])
        res_rows = tuple(alloc() for _ in res)
        plan.append((i, opname, rows, tuple(consumed), res_rows))
        for v, r in zip(res, res_rows):
            row_of[storage_of[v]] = r
            if last_use[storage_of[v]] < 0:          # dead on arrival
                free_rows.append(r)

    if row_budget is not None and n_rows > row_budget:
        raise ValueError(
            f"graph needs {n_rows} simultaneously-live data rows per "
            f"slot, over the {row_budget}-row sub-array budget")

    # -- emission ----------------------------------------------------------
    sa = make_subarray(n_data=max(n_rows, 1), row_bits=WORD_BITS)
    program: List[AAP] = []
    node_spans: List[Tuple[int, int, int]] = []
    for i, opname, rows, consumed, res_rows in plan:
        start = len(program)
        program.extend(_emit_node(sa, opname, rows, consumed, res_rows))
        node_spans.append((i, start, len(program)))

    device_outputs = tuple((name, row_of[s])
                           for name, s in device_output_storages)
    unfused_aaps = sum(cost(build_program(op))[0]
                       for op, _, _ in graph.nodes)
    unfused_ddr = sum(OP_ARITY[op] + _N_RESULTS[op]
                      for op, _, _ in graph.nodes)
    return FusedProgram(
        program=tuple(program), n_data_rows=n_rows,
        loaded_inputs=tuple(loaded_inputs),
        alias_outputs=tuple(alias_outputs),
        device_outputs=device_outputs,
        readback_rows=tuple(dict.fromkeys(r for _, r in device_outputs)),
        n_nodes=n_nodes, unfused_aaps_per_tile=unfused_aaps,
        unfused_ddr_rows_per_tile=unfused_ddr,
        node_spans=tuple(node_spans))


def _emit_node(sa: SubArray, opname: str, rows: Tuple[int, ...],
               consumed: Tuple[bool, ...], res: Tuple[int, ...],
               ) -> List[AAP]:
    """Table-2 microprogram for one node, re-addressed to the allocated
    rows, with consumed operands charge-shared in place."""
    if opname == "copy":
        return []                                    # pure row alias
    if opname == "not":
        return microprogram_not(sa, rows[0], res[0])
    if opname == "add":
        # Operands are double-copied into x-rows (each is read twice,
        # destructively) — nothing to elide, exactly Table 2's 7 AAPs.
        return microprogram_add(sa, rows[0], rows[1], rows[2],
                                res[0], res[1])
    # xnor2 / xor2 / maj3: stage only the non-consumed operands.
    prog: List[AAP] = []
    srcs: List[int] = []
    for k, (r, c) in enumerate(zip(rows, consumed)):
        if c:
            srcs.append(r)
        else:
            prog.append(AAP(OP_COPY, (r, sa.wl_x(k + 1))))
            srcs.append(sa.wl_x(k + 1))
    if opname == "xnor2":
        prog.append(AAP(OP_DRA, (srcs[0], srcs[1], res[0])))
    elif opname == "xor2":
        prog.append(AAP(OP_DRA, (srcs[0], srcs[1], sa.wl_dcc(2))))
        prog.append(AAP(OP_COPY, (sa.wl_dcc(1), res[0])))
    else:  # maj3
        prog.append(AAP(OP_TRA, (srcs[0], srcs[1], srcs[2], res[0])))
    return prog


# ---------------------------------------------------------------------------
# Cost model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusedSchedule(Schedule):
    """Measured cost of a fused graph next to its unfused oplist chain.

    Inherits the per-wave accounting of `Schedule` (aaps_per_tile is the
    length of the ONE concatenated stream) and adds the DDR row-movement
    model: moving one row over the bus costs `E_access + E_io` per KB
    (`core/energy.py`) — the fused path moves inputs + outputs once,
    the unfused chain moves every op's operands and results.
    """

    n_nodes: int = 0
    rows_used: int = 0
    n_inputs: int = 0
    n_outputs: int = 0
    unfused_aaps_per_tile: int = 0
    ddr_rows_per_tile: int = 0
    unfused_ddr_rows_per_tile: int = 0

    # -- AAP savings -------------------------------------------------------
    @property
    def aaps_saved_per_tile(self) -> int:
        return self.unfused_aaps_per_tile - self.aaps_per_tile

    @property
    def unfused_aaps_sequential(self) -> int:
        return self.waves * self.unfused_aaps_per_tile

    @property
    def unfused_latency_s(self) -> float:
        return self.unfused_aaps_sequential * self.t_aap_s

    @property
    def speedup_vs_unfused(self) -> float:
        # An alias-only graph (all copies) fuses to ZERO device work;
        # report inf rather than dividing by a 0-second latency.
        if self.latency_s == 0.0:
            return 1.0 if self.unfused_latency_s == 0.0 else float("inf")
        return self.unfused_latency_s / self.latency_s

    # -- DDR row movement --------------------------------------------------
    @property
    def ddr_rows_moved(self) -> int:
        return self.tiles * self.ddr_rows_per_tile

    @property
    def unfused_ddr_rows_moved(self) -> int:
        return self.tiles * self.unfused_ddr_rows_per_tile

    @property
    def ddr_rows_saved(self) -> int:
        return self.unfused_ddr_rows_moved - self.ddr_rows_moved

    @property
    def dma_s(self) -> float:
        """Host DDR bus time for the fused graph's boundary traffic
        (operand rows in once, result rows out once) — THE shared
        DDR-traffic clock (`core.timing.ddr_rows_s`) the queue model
        and the offload verdicts also price with, so the fused and
        queued contenders can never disagree on what a moved row
        costs."""
        return ddr_rows_s(self.ddr_rows_moved, self.row_bits)

    @property
    def unfused_dma_s(self) -> float:
        return ddr_rows_s(self.unfused_ddr_rows_moved, self.row_bits)

    def _ddr_energy(self, rows_moved: int) -> float:
        row_kb = self.row_bits / 8.0 / 1024.0
        per_kb = E_ACCESS_NJ_PER_KB + E_IO_NJ_PER_KB
        return rows_moved * row_kb * per_kb * 1e-9

    @property
    def ddr_energy_j(self) -> float:
        return self._ddr_energy(self.ddr_rows_moved)

    @property
    def total_energy_j(self) -> float:
        """AAP energy + DDR movement energy of the fused execution."""
        return self.energy_j + self.ddr_energy_j

    @property
    def unfused_total_energy_j(self) -> float:
        row_kb = self.row_bits / 8.0 / 1024.0
        aap_e = (self.tiles * self.unfused_aaps_per_tile * row_kb
                 * E_AAP_NJ_PER_KB * 1e-9)
        return aap_e + self._ddr_energy(self.unfused_ddr_rows_moved)

    @property
    def energy_saved_j(self) -> float:
        return self.unfused_total_energy_j - self.total_energy_j


def _make_fused_schedule(fp: FusedProgram, n_bits: int, tiles: int,
                         waves: int, geom: DrimGeometry) -> FusedSchedule:
    return FusedSchedule(
        op=f"fused[{fp.n_nodes}]", n_bits=n_bits, row_bits=geom.row_bits,
        tiles=tiles, slots=geom.n_subarrays, waves=waves,
        aaps_per_tile=fp.aaps_per_tile, chips=geom.chips, banks=geom.banks,
        subarrays_per_bank=geom.subarrays_per_bank, t_aap_s=geom.t_aap_s,
        n_nodes=fp.n_nodes, rows_used=fp.n_data_rows,
        n_inputs=len(fp.loaded_inputs), n_outputs=len(fp.readback_rows),
        unfused_aaps_per_tile=fp.unfused_aaps_per_tile,
        ddr_rows_per_tile=fp.ddr_rows_per_tile,
        unfused_ddr_rows_per_tile=fp.unfused_ddr_rows_per_tile)


def plan_graph_schedule(graph: BulkGraph, n_bits: int, *,
                        geom: DrimGeometry = DRIM_R,
                        row_budget: Optional[int] = DEFAULT_ROW_BUDGET,
                        ) -> FusedSchedule:
    """Closed-form fused schedule — identical numbers to what
    `Lowered.run` measures, without touching the simulator."""
    if n_bits <= 0:
        raise ValueError("n_bits must be positive")
    fp = compile_graph(graph, row_budget=row_budget)
    tiles = _ceil_div(n_bits, geom.row_bits)
    waves = _ceil_div(tiles, geom.n_subarrays)
    return _make_fused_schedule(fp, n_bits, tiles, waves, geom)
