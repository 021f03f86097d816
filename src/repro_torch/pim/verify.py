"""Static verification of compiled DRIM programs -- the `verify` pass
(port of `repro.pim.verify`).

The compiler CONSTRUCTS a stack of invariants it never re-checks:
destructive dual/triple-row activation clobbers its operand rows
(charge-sharing is a destructive read, paper Fig. 6), `compile_graph`
recycles rows the moment liveness says they die, `partition_graph`'s
fence stages assume every cross-queue edge lands one stage past its
producer, and the harden pass assumes its voters really read three
independent replicas.  A bug in any of them surfaces only as a wrong
bit in a differential test.  This module proves each compiled program
safe BEFORE it runs, across the three representations the pipeline
produces:

  * **Layer 1 — AAP-stream hazard analysis** (`verify_fused`,
    `verify_op`): the encoded stream is walked with an abstract
    row-state lattice (UNWRITTEN / LIVE / CONSUMED-BY-DRA / RECYCLED)
    *and* a hash-consed symbolic value per word-line, seeded from the
    staged inputs.  Every read is checked against the owning node's
    operand values (`node_spans` maps AAP indices back to BulkGraph
    nodes), every DRA/TRA marks its surviving source rows consumed,
    and the final state must place each node result and device output
    in exactly the row the `FusedProgram` claims.  Hazards: use after
    recycle, read after destructive read, out-of-bounds or
    over-budget word-lines, copy-elision aliasing violations.

  * **Layer 2 — MIMD race detection** (`verify_partition`): the
    happens-before relation of a `GraphPartition` is rebuilt from its
    (queue, stage) segments and fence barriers; any cross-queue read
    not ordered strictly after its producer's fence stage is a data
    race on a bank row.  Segment membership, row budgets,
    `cross_edges` and `cross_fence_rows` accounting are re-derived
    and compared.  Every segment's own fused program passes Layer 1.

  * **Layer 3 — harden structural invariants** (`verify_harden`):
    each protected TMR voter must read three results from three
    DISTINCT, structurally identical replica nodes; the ECC parity
    value must equal the xor-fold of the primary outputs (replica
    chains compute structurally identical expressions, so the check
    is exact) and the fold must run on protected word-lines.

Diagnostics are structured `VerifyError` objects (a `ValueError`
subclass, so legacy ``except ValueError`` callers keep working) with
stable machine-readable codes (`V001_USE_AFTER_RECYCLE`, ...) plus the
node / AAP / queue / stage they anchor to, collected into a
`VerifyReport`.  Counts land in `VERIFY_STATS`, the ``drim.verify``
telemetry namespace.  The pass registers in
`compiler.PASS_PIPELINE` after `encode`, runs by default (skippable
per-lowering via ``lower(verify=False)``; ``DRIM_VERIFY=1`` forces it
back on for CI, ``DRIM_VERIFY=0`` disables the default), and is runnable
standalone::

    PYTHONPATH=src python -m repro_torch.pim.verify --k 8 --seeds 5 \\
        --partition 4 --harden tmr+ecc
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.isa import OP_COPY, OP_COPY2, OP_DRA, OP_TRA
from repro_torch.core.subarray import N_DCC_WL
from repro_torch.pim.graph import BulkGraph, FusedProgram, GraphPartition
from repro_torch.pim.scheduler import OP_ARITY
from repro_torch.runtime import telemetry

# ---------------------------------------------------------------------------
# Diagnostic codes — stable, machine-readable, one per hazard class
# ---------------------------------------------------------------------------

# Layer 1: AAP-stream hazards over a FusedProgram.
V001_USE_AFTER_RECYCLE = "V001_USE_AFTER_RECYCLE"
V002_READ_AFTER_DESTRUCTIVE_READ = "V002_READ_AFTER_DESTRUCTIVE_READ"
V003_WL_OUT_OF_BOUNDS = "V003_WL_OUT_OF_BOUNDS"
V004_ROW_BUDGET_EXCEEDED = "V004_ROW_BUDGET_EXCEEDED"
V005_UNWRITTEN_READ = "V005_UNWRITTEN_READ"
V006_ALIAS_OUTPUT_VIOLATION = "V006_ALIAS_OUTPUT_VIOLATION"
V007_OUTPUT_MISMATCH = "V007_OUTPUT_MISMATCH"
V008_NODE_SPAN_MALFORMED = "V008_NODE_SPAN_MALFORMED"
V009_NODE_RESULT_MISMATCH = "V009_NODE_RESULT_MISMATCH"

# Layer 2: MIMD fence races over a GraphPartition.
V010_UNFENCED_CROSS_QUEUE_READ = "V010_UNFENCED_CROSS_QUEUE_READ"
V011_PARTITION_STRUCTURE = "V011_PARTITION_STRUCTURE"
V012_CROSS_FENCE_ACCOUNTING = "V012_CROSS_FENCE_ACCOUNTING"
V013_SEGMENT_ROW_BUDGET = "V013_SEGMENT_ROW_BUDGET"

# Lower-time configuration diagnostics.
V020_FAULTS_UNSUPPORTED_ON_MESH = "V020_FAULTS_UNSUPPORTED_ON_MESH"

# Layer 3: harden-pass structural invariants.
V030_TMR_REPLICA_NOT_INDEPENDENT = "V030_TMR_REPLICA_NOT_INDEPENDENT"
V031_TMR_REPLICA_DIVERGENT = "V031_TMR_REPLICA_DIVERGENT"
V032_ECC_PARITY_INCOMPLETE = "V032_ECC_PARITY_INCOMPLETE"
V033_ECC_FOLD_UNPROTECTED = "V033_ECC_FOLD_UNPROTECTED"

ALL_CODES = tuple(v for k, v in sorted(globals().items())
                  if k.startswith("V0") and isinstance(v, str))

# Everything the verifier touches counts here ("programs", "clean",
# "failed", plus one key per code).  It IS the telemetry registry's
# "drim.verify" namespace (the same Counter object), so `telemetry.fresh()`
# scopes it too.
VERIFY_STATS: collections.Counter = telemetry.REGISTRY.counters("drim.verify")


class VerifyError(ValueError):
    """One structured diagnostic.

    A `ValueError` subclass so call sites that guarded the legacy
    unchecked errors (``pytest.raises(ValueError)``) keep working; the
    stable `code` is what tools and the mutation suite key on.
    """

    def __init__(self, code: str, message: str, *,
                 node: Optional[int] = None, aap: Optional[int] = None,
                 part: Optional[int] = None, stage: Optional[int] = None,
                 layer: Optional[str] = None) -> None:
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message
        self.node = node
        self.aap = aap
        self.part = part
        self.stage = stage
        self.layer = layer


@dataclasses.dataclass(frozen=True)
class VerifyReport:
    """Everything one verification run learned about one lowering."""

    errors: Tuple[VerifyError, ...]
    layers: Tuple[str, ...]
    aaps_checked: int = 0
    nodes_checked: int = 0
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def codes(self) -> Tuple[str, ...]:
        return tuple(e.code for e in self.errors)

    def raise_if_failed(self) -> "VerifyReport":
        if self.errors:
            err = self.errors[0]
            err.report = self
            raise err
        return self


def faults_on_mesh_error() -> VerifyError:
    """The named diagnostic for the faults + fleet-mesh rejection:
    global slot ids are not visible inside a shard, so injected flips
    could not stay identical to the unsharded engines."""
    return VerifyError(
        V020_FAULTS_UNSUPPORTED_ON_MESH,
        "fault injection runs unsharded (mesh=None): global slot ids "
        "are not visible inside a fleet-mesh shard, so flips cannot stay "
        "identical across engines; run faulted programs on the "
        "unsharded engines — resident/baseline/queued/cuda with "
        "mesh=None", layer="lower")


# ---------------------------------------------------------------------------
# Enable/disable resolution (the `lower(verify=...)` default + DRIM_VERIFY)
# ---------------------------------------------------------------------------

def default_enabled() -> bool:
    """The pass default when `lower()` is not given `verify=`:
    on, unless ``DRIM_VERIFY=0`` opts the process out."""
    return os.environ.get("DRIM_VERIFY", "") != "0"


def resolve_enabled(flag) -> bool:
    """Resolve an explicit `lower(verify=...)` argument against the
    environment: ``DRIM_VERIFY=1`` forces the pass on even over an
    explicit ``verify=False`` (how CI pins the whole suite verified)."""
    if os.environ.get("DRIM_VERIFY", "") == "1":
        return True
    if flag is None:
        return default_enabled()
    return bool(flag)


# ---------------------------------------------------------------------------
# Hash-consed symbolic values (the algebra both sides share)
# ---------------------------------------------------------------------------

class _Alg:
    """Hash-consed expressions over the DRIM charge-sharing algebra.

    DRA puts XNOR on the bit-line, TRA puts MAJ3, a BL̄-side DCC
    word-line negates on the way in and out.  Commutative operands are
    sorted and double negation cancels, so the expression the stream
    interpreter builds for a correct program is STRUCTURALLY IDENTICAL
    to the one built from the graph semantics — value equality becomes
    integer equality."""

    def __init__(self) -> None:
        self._memo: Dict[tuple, int] = {}
        self._nodes: List[tuple] = []

    def _intern(self, t: tuple) -> int:
        i = self._memo.get(t)
        if i is None:
            i = self._memo[t] = len(self._nodes)
            self._nodes.append(t)
        return i

    def describe(self, e: int) -> str:
        t = self._nodes[e]
        if t[0] == "in":
            return t[1]
        if t[0] == "zero":
            return "0"
        return f"{t[0]}({', '.join(self.describe(a) for a in t[1:])})"

    def inp(self, name: str) -> int:
        return self._intern(("in", name))

    def zero(self) -> int:
        return self._intern(("zero",))

    def not_(self, e: int) -> int:
        t = self._nodes[e]
        if t[0] == "not":
            return t[1]
        return self._intern(("not", e))

    def xnor(self, a: int, b: int) -> int:
        return self._intern(("xnor",) + tuple(sorted((a, b))))

    def xor(self, a: int, b: int) -> int:
        return self.not_(self.xnor(a, b))

    def maj(self, a: int, b: int, c: int) -> int:
        return self._intern(("maj",) + tuple(sorted((a, b, c))))

    def node_results(self, opname: str, args: Sequence[int],
                     ) -> Tuple[int, ...]:
        """Graph semantics of one bulk op, phrased exactly as the
        Table-2 microprograms compute it (so structural equality
        holds)."""
        if opname == "copy":
            return (args[0],)
        if opname == "not":
            return (self.not_(args[0]),)
        if opname == "xnor2":
            return (self.xnor(args[0], args[1]),)
        if opname == "xor2":
            return (self.xor(args[0], args[1]),)
        if opname == "maj3":
            return (self.maj(args[0], args[1], args[2]),)
        # add: Sum via two chained DRA-XORs, Cout via TRA (Table 2).
        s = self.xor(args[2], self.xor(args[0], args[1]))
        return (s, self.maj(args[0], args[1], args[2]))


def _origins(graph: BulkGraph):
    """(origin map value->origin value, producer map origin->node idx,
    node result origin tuples).  Copies collapse onto their source."""
    origin: Dict[int, int] = {v: v for v in graph.input_vids}
    producer: Dict[int, int] = {}
    for i, (opname, opnds, res) in enumerate(graph.nodes):
        if opname == "copy":
            origin[res[0]] = origin[opnds[0]]
        else:
            for v in res:
                origin[v] = v
                producer[v] = i
    return origin, producer


def _expected_exprs(graph: BulkGraph, alg: _Alg) -> Dict[int, int]:
    """Symbolic value of every origin value id, from graph semantics."""
    expr: Dict[int, int] = {}
    for name, vid in zip(graph.input_names, graph.input_vids):
        expr[vid] = alg.inp(name)
    origin, _ = _origins(graph)
    for opname, opnds, res in graph.nodes:
        if opname == "copy":
            continue
        args = [expr[origin[v]] for v in opnds]
        for v, e in zip(res, alg.node_results(opname, args)):
            expr[v] = e
    return expr


# ---------------------------------------------------------------------------
# Layer 1: AAP-stream hazard analysis (row-state lattice + symbolics)
# ---------------------------------------------------------------------------

# Row states.  RECYCLED is an event, not a resting state: a recycled
# row is simply rewritten by a later value, and reading the NEW value
# where the OLD one was expected is exactly what V001 reports.
_UNWRITTEN, _LIVE, _CONSUMED = 0, 1, 2

_DEST_ARG = {OP_COPY: (1,), OP_COPY2: (1, 2), OP_DRA: (2,), OP_TRA: (3,)}
_READ_ARG = {OP_COPY: (0,), OP_COPY2: (0,), OP_DRA: (0, 1),
             OP_TRA: (0, 1, 2)}


class _StreamState:
    """Abstract machine over one sub-array template: per normal row a
    (state, symbolic value) pair, per DCC cell a symbolic value."""

    def __init__(self, alg: _Alg, n_rows: int) -> None:
        self.alg = alg
        self.n_rows = n_rows                      # normal rows (data + x)
        self.state = [_UNWRITTEN] * n_rows
        self.val: List[Optional[int]] = [None] * n_rows
        self.cell: List[Optional[int]] = [None, None]   # DCC cells A, B

    def seed(self, row: int, expr: int) -> None:
        self.state[row] = _LIVE
        self.val[row] = expr

    def read(self, wl: int):
        """-> (expr | None, hazard | None); hazard in {V002, V005}."""
        if wl < self.n_rows:
            if self.state[wl] == _UNWRITTEN:
                return None, V005_UNWRITTEN_READ
            if self.state[wl] == _CONSUMED:
                return self.val[wl], V002_READ_AFTER_DESTRUCTIVE_READ
            return self.val[wl], None
        off = wl - self.n_rows
        c = self.cell[off // 2]
        if c is None:
            return None, V005_UNWRITTEN_READ
        return (self.alg.not_(c) if off % 2 else c), None

    def write(self, wl: int, expr: int) -> None:
        if wl < self.n_rows:
            self.state[wl] = _LIVE
            self.val[wl] = expr
        else:
            off = wl - self.n_rows
            # BL̄-side word-lines store the complement of the BL level.
            self.cell[off // 2] = (self.alg.not_(expr) if off % 2
                                   else expr)

    def consume(self, wl: int, expr: int) -> None:
        """A DRA/TRA source row: its pre-op value is destroyed; the
        physical row now holds the result, but nothing is allowed to
        read it until rewritten."""
        if wl < self.n_rows:
            self.state[wl] = _CONSUMED
            self.val[wl] = expr
        else:
            # DCC cells are scratch — sources at the BL level simply
            # take the result (exactly what the add microprogram's
            # second DRA relies on when it writes back through dcc1).
            self.write(wl, expr)


def _check_spans(fp: FusedProgram, graph: BulkGraph,
                 errors: List[VerifyError]) -> bool:
    """V008: node_spans must cover [0, len(program)) contiguously, one
    span per non-copy node, in node order."""
    emitting = [i for i, (op, _, _) in enumerate(graph.nodes)
                if op != "copy"]
    spans = fp.node_spans
    if [s[0] for s in spans] != emitting:
        errors.append(VerifyError(
            V008_NODE_SPAN_MALFORMED,
            f"node_spans name nodes {[s[0] for s in spans]} but the "
            f"graph's emitting nodes are {emitting}", layer="aap"))
        return False
    pos = 0
    for i, lo, hi in spans:
        if lo != pos or hi < lo:
            errors.append(VerifyError(
                V008_NODE_SPAN_MALFORMED,
                f"span of node {i} is [{lo}, {hi}) but the stream "
                f"cursor is at {pos} — spans must tile the program",
                node=i, aap=lo, layer="aap"))
            return False
        pos = hi
    if pos != len(fp.program):
        errors.append(VerifyError(
            V008_NODE_SPAN_MALFORMED,
            f"spans cover [0, {pos}) of a {len(fp.program)}-AAP stream",
            aap=pos, layer="aap"))
        return False
    return True


def verify_fused(graph: BulkGraph, fp: FusedProgram, *,
                 row_budget: Optional[int] = None,
                 part: Optional[int] = None, stage: Optional[int] = None,
                 ) -> List[VerifyError]:
    """Layer 1 over one compiled graph.  Returns diagnostics (empty
    means certified clean)."""
    errors: List[VerifyError] = []
    alg = _Alg()
    origin, producer = _origins(graph)
    expected = _expected_exprs(graph, alg)
    n_rows = fp.template_rows                     # data + x rows
    n_wl = n_rows + N_DCC_WL
    data_top = max(fp.n_data_rows, 1)             # data region [0, data_top)

    if row_budget is not None and fp.n_data_rows > row_budget:
        errors.append(VerifyError(
            V004_ROW_BUDGET_EXCEEDED,
            f"program claims {fp.n_data_rows} simultaneously-live data "
            f"rows per slot, over the {row_budget}-row budget",
            layer="aap", part=part, stage=stage))

    # Bounds are checked even when spans are broken (the walk is not).
    for k, ins in enumerate(fp.program):
        for a in ins.args:
            if not 0 <= a < n_wl:
                errors.append(VerifyError(
                    V003_WL_OUT_OF_BOUNDS,
                    f"AAP {k} addresses word-line {a}; the template has "
                    f"{n_rows} normal rows + {N_DCC_WL} DCC word-lines",
                    aap=k, layer="aap", part=part, stage=stage))

    name_of_vid = dict(zip(graph.input_vids, graph.input_names))

    # V006: an alias output must BE its claimed input through copies.
    out_vids = dict(graph.outputs)
    for out_name, in_name in fp.alias_outputs:
        vid = out_vids.get(out_name)
        ok = (vid is not None and in_name in graph.input_names
              and origin.get(vid) is not None
              and name_of_vid.get(origin[vid]) == in_name)
        if not ok:
            errors.append(VerifyError(
                V006_ALIAS_OUTPUT_VIOLATION,
                f"alias output {out_name!r} claims to be input "
                f"{in_name!r}, but the value does not reduce to it "
                f"through copy elision", layer="aap", part=part,
                stage=stage))

    if errors and any(e.code == V003_WL_OUT_OF_BOUNDS for e in errors):
        return errors                              # state walk unsafe
    if not _check_spans(fp, graph, errors):
        return errors

    # -- the walk ----------------------------------------------------------
    st = _StreamState(alg, n_rows)
    for row, name in enumerate(fp.loaded_inputs):
        st.seed(row, alg.inp(name))

    spans = fp.node_spans
    by_node = {i: (lo, hi) for i, lo, hi in spans}
    for i, (opname, opnds, res) in enumerate(graph.nodes):
        if opname == "copy":
            continue
        lo, hi = by_node[i]
        op_exprs = {expected[origin[v]] for v in opnds}
        res_exprs = [expected[v] for v in res]
        bound_rows: List[int] = []
        for k in range(lo, hi):
            ins = fp.program[k]
            if any(not 0 <= a < n_wl for a in ins.args):
                continue
            # reads first: every normal-row read must observe one of
            # THIS node's operand values (x-rows hold staged copies).
            read_vals: List[int] = []
            for pos in _READ_ARG[ins.op]:
                wl = ins.args[pos]
                expr, hazard = st.read(wl)
                if hazard == V005_UNWRITTEN_READ:
                    errors.append(VerifyError(
                        V005_UNWRITTEN_READ,
                        f"AAP {k} (node {i}, {opname}) reads word-line "
                        f"{wl}, which no load or AAP has written",
                        node=i, aap=k, layer="aap", part=part,
                        stage=stage))
                    expr = alg.zero()
                elif hazard == V002_READ_AFTER_DESTRUCTIVE_READ:
                    errors.append(VerifyError(
                        V002_READ_AFTER_DESTRUCTIVE_READ,
                        f"AAP {k} (node {i}, {opname}) reads row {wl} "
                        f"after a DRA/TRA charge-share destroyed its "
                        f"value", node=i, aap=k, layer="aap", part=part,
                        stage=stage))
                elif (wl < n_rows and expr not in op_exprs
                      and expr not in res_exprs):
                    errors.append(VerifyError(
                        V001_USE_AFTER_RECYCLE,
                        f"AAP {k} (node {i}, {opname}) reads row {wl} "
                        f"expecting an operand of this node, but the "
                        f"row now holds {alg.describe(expr)} — the "
                        f"operand's row was recycled", node=i, aap=k,
                        layer="aap", part=part, stage=stage))
                read_vals.append(expr if expr is not None else alg.zero())
            # compute the bit-line level and write it back
            if ins.op == OP_COPY:
                st.write(ins.args[1], read_vals[0])
            elif ins.op == OP_COPY2:
                st.write(ins.args[1], read_vals[0])
                st.write(ins.args[2], read_vals[0])
            else:
                bl = (alg.xnor(read_vals[0], read_vals[1])
                      if ins.op == OP_DRA
                      else alg.maj(read_vals[0], read_vals[1],
                                   read_vals[2]))
                dest = ins.args[_DEST_ARG[ins.op][0]]
                for pos in _READ_ARG[ins.op]:
                    if ins.args[pos] != dest:
                        st.consume(ins.args[pos], bl)
                st.write(dest, bl)
            # result binding: destination writes landing in the DATA
            # region are, in order, this node's results.
            for pos in _DEST_ARG[ins.op]:
                if ins.args[pos] < data_top:
                    bound_rows.append(ins.args[pos])
        if len(bound_rows) != len(res):
            errors.append(VerifyError(
                V008_NODE_SPAN_MALFORMED,
                f"node {i} ({opname}) produces {len(res)} result(s) "
                f"but its span writes {len(bound_rows)} data row(s)",
                node=i, aap=lo, layer="aap", part=part, stage=stage))
            continue
        for r_expr, row in zip(res_exprs, bound_rows):
            got, _ = st.read(row)
            if got != r_expr:
                errors.append(VerifyError(
                    V009_NODE_RESULT_MISMATCH,
                    f"node {i} ({opname}) should leave "
                    f"{alg.describe(r_expr)} in row {row}, but the "
                    f"stream leaves "
                    f"{alg.describe(got) if got is not None else '?'}",
                    node=i, aap=hi - 1, layer="aap", part=part,
                    stage=stage))

    # -- final state: device outputs + readback rows ------------------------
    rows_claimed = dict(fp.device_outputs)
    if tuple(dict.fromkeys(rows_claimed.values())) != fp.readback_rows:
        errors.append(VerifyError(
            V007_OUTPUT_MISMATCH,
            f"readback_rows {fp.readback_rows} disagree with the "
            f"distinct device_output rows "
            f"{tuple(dict.fromkeys(rows_claimed.values()))}",
            layer="aap", part=part, stage=stage))
    for name, row in fp.device_outputs:
        vid = out_vids.get(name)
        if vid is None:
            errors.append(VerifyError(
                V007_OUTPUT_MISMATCH,
                f"device output {name!r} is not an output of the graph",
                layer="aap", part=part, stage=stage))
            continue
        if not 0 <= row < n_rows:
            errors.append(VerifyError(
                V007_OUTPUT_MISMATCH,
                f"device output {name!r} reads back word-line {row}, "
                f"outside the {n_rows} normal rows", layer="aap",
                part=part, stage=stage))
            continue
        want = expected[origin[vid]]
        got, hazard = st.read(row)
        if hazard is not None or got != want:
            errors.append(VerifyError(
                V007_OUTPUT_MISMATCH,
                f"device output {name!r} expects "
                f"{alg.describe(want)} in row {row} at end of stream, "
                f"found {alg.describe(got) if got is not None else '?'}"
                f"{' (row consumed)' if hazard else ''}",
                layer="aap", part=part, stage=stage))
    return errors


def verify_op(op: str, program: Sequence, result_rows: Sequence[int],
              *, n_rows: int) -> List[VerifyError]:
    """Layer 1 for a single Table-2 op lowering: bounds + a symbolic
    replay against the op's reference semantics, operands staged in
    rows 0..arity-1 (the `stage_rows` convention)."""
    errors: List[VerifyError] = []
    if op not in OP_ARITY:
        errors.append(VerifyError(
            V007_OUTPUT_MISMATCH, f"unknown bulk op {op!r}", layer="aap"))
        return errors
    alg = _Alg()
    st = _StreamState(alg, n_rows)
    args = [alg.inp(f"in{k}") for k in range(OP_ARITY[op])]
    for k, e in enumerate(args):
        st.seed(k, e)
    want = alg.node_results(op, args)
    n_wl = n_rows + N_DCC_WL
    for k, ins in enumerate(program):
        if any(not 0 <= a < n_wl for a in ins.args):
            errors.append(VerifyError(
                V003_WL_OUT_OF_BOUNDS,
                f"AAP {k} addresses word-lines {ins.args}; the op "
                f"template has {n_rows} normal rows + {N_DCC_WL} DCC "
                f"word-lines", aap=k, layer="aap"))
            continue
        reads: List[int] = []
        for pos in _READ_ARG[ins.op]:
            expr, hazard = st.read(ins.args[pos])
            if hazard == V005_UNWRITTEN_READ:
                errors.append(VerifyError(
                    V005_UNWRITTEN_READ,
                    f"AAP {k} ({op}) reads unwritten word-line "
                    f"{ins.args[pos]}", aap=k, layer="aap"))
                expr = alg.zero()
            elif hazard == V002_READ_AFTER_DESTRUCTIVE_READ:
                errors.append(VerifyError(
                    V002_READ_AFTER_DESTRUCTIVE_READ,
                    f"AAP {k} ({op}) reads row {ins.args[pos]} after a "
                    f"DRA/TRA charge-share destroyed its value", aap=k,
                    layer="aap"))
            reads.append(expr if expr is not None else alg.zero())
        if ins.op == OP_COPY:
            st.write(ins.args[1], reads[0])
        elif ins.op == OP_COPY2:
            st.write(ins.args[1], reads[0])
            st.write(ins.args[2], reads[0])
        else:
            bl = (alg.xnor(reads[0], reads[1]) if ins.op == OP_DRA
                  else alg.maj(reads[0], reads[1], reads[2]))
            dest = ins.args[_DEST_ARG[ins.op][0]]
            for pos in _READ_ARG[ins.op]:
                if ins.args[pos] != dest:
                    st.consume(ins.args[pos], bl)
            st.write(dest, bl)
    for j, row in enumerate(result_rows):
        got, hazard = st.read(row)
        if hazard is not None or got != want[j]:
            errors.append(VerifyError(
                V007_OUTPUT_MISMATCH,
                f"op {op!r} result {j} should leave "
                f"{alg.describe(want[j])} in row {row}, found "
                f"{alg.describe(got) if got is not None else '?'}"
                f"{' (hazard)' if hazard else ''}", layer="aap"))
    return errors


# ---------------------------------------------------------------------------
# Layer 2: MIMD race detection over a GraphPartition
# ---------------------------------------------------------------------------

def _partition_prefix(graph: BulkGraph) -> str:
    prefix = "v"
    while any(name.startswith(prefix) for name in graph.input_names):
        prefix += "#"
    return prefix


def verify_partition(graph: BulkGraph, gp: GraphPartition, *,
                     row_budget: Optional[int] = None,
                     ) -> List[VerifyError]:
    """Layer 2: fence happens-before + accounting, plus Layer 1 over
    every segment's own fused program."""
    errors: List[VerifyError] = []
    origin, producer = _origins(graph)
    prefix = _partition_prefix(graph)
    name_of_vid = dict(zip(graph.input_vids, graph.input_names))

    def env_name(vid: int) -> str:
        return name_of_vid.get(vid, f"{prefix}{vid}")

    n = len(graph.nodes)
    if len(gp.part_of) != n or len(gp.stage_of) != n or gp.n_nodes != n:
        errors.append(VerifyError(
            V011_PARTITION_STRUCTURE,
            f"partition covers {gp.n_nodes} nodes "
            f"(part_of: {len(gp.part_of)}, stage_of: {len(gp.stage_of)})"
            f" but the graph has {n}", layer="mimd"))
        return errors

    # -- segment membership ------------------------------------------------
    emitting = {i for i, (op, _, _) in enumerate(graph.nodes)
                if op != "copy"}
    seen: Dict[int, Tuple[int, int]] = {}
    for seg in gp.segments:
        if not (0 <= seg.part < gp.n_parts and 0 <= seg.stage < gp.n_stages):
            errors.append(VerifyError(
                V011_PARTITION_STRUCTURE,
                f"segment (part {seg.part}, stage {seg.stage}) is "
                f"outside the {gp.n_parts}x{gp.n_stages} grid",
                part=seg.part, stage=seg.stage, layer="mimd"))
        for i in seg.node_ids:
            if i in seen:
                errors.append(VerifyError(
                    V011_PARTITION_STRUCTURE,
                    f"node {i} appears in two segments {seen[i]} and "
                    f"{(seg.part, seg.stage)}", node=i, part=seg.part,
                    stage=seg.stage, layer="mimd"))
            seen[i] = (seg.part, seg.stage)
            if i >= n or (gp.part_of[i], gp.stage_of[i]) != (seg.part,
                                                            seg.stage):
                errors.append(VerifyError(
                    V011_PARTITION_STRUCTURE,
                    f"node {i} sits in segment (part {seg.part}, stage "
                    f"{seg.stage}) but part_of/stage_of place it at "
                    f"({gp.part_of[i] if i < n else '?'}, "
                    f"{gp.stage_of[i] if i < n else '?'})", node=i,
                    part=seg.part, stage=seg.stage, layer="mimd"))
    missing = emitting - set(seen)
    if missing:
        errors.append(VerifyError(
            V011_PARTITION_STRUCTURE,
            f"emitting nodes {sorted(missing)} appear in no segment",
            layer="mimd"))

    # -- happens-before: every cross-queue edge must cross a fence ----------
    for i, (opname, opnds, _) in enumerate(graph.nodes):
        if opname == "copy":
            continue
        for v in opnds:
            j = producer.get(origin[v])
            if j is None:
                continue                   # graph input: staged host-side
            if gp.part_of[j] != gp.part_of[i]:
                if gp.stage_of[i] <= gp.stage_of[j]:
                    errors.append(VerifyError(
                        V010_UNFENCED_CROSS_QUEUE_READ,
                        f"node {i} on queue {gp.part_of[i]} stage "
                        f"{gp.stage_of[i]} reads {env_name(origin[v])!r}"
                        f" produced by node {j} on queue {gp.part_of[j]}"
                        f" stage {gp.stage_of[j]} — the read is not "
                        f"ordered after the producer's fence", node=i,
                        part=gp.part_of[i], stage=gp.stage_of[i],
                        layer="mimd"))
            elif gp.stage_of[i] < gp.stage_of[j]:
                errors.append(VerifyError(
                    V010_UNFENCED_CROSS_QUEUE_READ,
                    f"node {i} runs at stage {gp.stage_of[i]}, before "
                    f"its same-queue producer node {j} at stage "
                    f"{gp.stage_of[j]}", node=i, part=gp.part_of[i],
                    stage=gp.stage_of[i], layer="mimd"))

    # A consumer segment must find every non-local value published by
    # its producer segment (the fence row a deleted export would lose).
    published: Dict[Tuple[int, int], set] = {}
    for seg in gp.segments:
        published[(seg.part, seg.stage)] = set(seg.subgraph.outputs)
    for seg in gp.segments:
        local_nodes = set(seg.node_ids)
        for name in seg.subgraph.input_names:
            if name in graph.input_names:
                continue
            vid = None
            if name.startswith(prefix):
                try:
                    vid = int(name[len(prefix):])
                except ValueError:
                    vid = None
            j = producer.get(vid) if vid is not None else None
            if j is None:
                errors.append(VerifyError(
                    V011_PARTITION_STRUCTURE,
                    f"segment (part {seg.part}, stage {seg.stage}) "
                    f"reads {name!r}, which no node produces",
                    part=seg.part, stage=seg.stage, layer="mimd"))
                continue
            if j in local_nodes:
                continue
            key = (gp.part_of[j], gp.stage_of[j])
            if name not in published.get(key, set()):
                errors.append(VerifyError(
                    V010_UNFENCED_CROSS_QUEUE_READ,
                    f"segment (part {seg.part}, stage {seg.stage}) "
                    f"reads {name!r} but its producer segment {key} "
                    f"never exports it across the fence",
                    part=seg.part, stage=seg.stage, layer="mimd"))

    # -- cross-edge + fence-row accounting ----------------------------------
    def seg_key(i: int) -> Tuple[int, int]:
        return (gp.stage_of[i], gp.part_of[i])

    cross_pairs = set()
    for i, (opname, opnds, _) in enumerate(graph.nodes):
        if opname == "copy":
            continue
        for v in opnds:
            j = producer.get(origin[v])
            if j is not None and gp.part_of[j] != gp.part_of[i]:
                cross_pairs.add((origin[v], gp.part_of[i]))
    want_edges = tuple(sorted(
        (env_name(v), gp.part_of[producer[v]], dst)
        for v, dst in cross_pairs))
    if gp.cross_edges != want_edges:
        errors.append(VerifyError(
            V012_CROSS_FENCE_ACCOUNTING,
            f"cross_edges {gp.cross_edges} != recomputed {want_edges}",
            layer="mimd"))
    if gp.cross_fence_rows != len(cross_pairs):
        errors.append(VerifyError(
            V012_CROSS_FENCE_ACCOUNTING,
            f"cross_fence_rows={gp.cross_fence_rows} but the partition "
            f"moves {len(cross_pairs)} (value, queue) rows at fences",
            layer="mimd"))

    # -- output sources ------------------------------------------------------
    want_sources = tuple((name, env_name(origin[vid]))
                         for name, vid in graph.outputs.items())
    if tuple(gp.output_sources) != want_sources:
        errors.append(VerifyError(
            V011_PARTITION_STRUCTURE,
            f"output_sources {gp.output_sources} != recomputed "
            f"{want_sources}", layer="mimd"))

    # -- per-segment budgets + Layer 1 ---------------------------------------
    rows_seen = 0
    for seg in gp.segments:
        rows_seen = max(rows_seen, seg.fp.n_data_rows)
        if row_budget is not None and seg.fp.n_data_rows > row_budget:
            errors.append(VerifyError(
                V013_SEGMENT_ROW_BUDGET,
                f"segment (part {seg.part}, stage {seg.stage}) needs "
                f"{seg.fp.n_data_rows} rows, over the {row_budget}-row "
                f"budget", part=seg.part, stage=seg.stage, layer="mimd"))
        errors.extend(verify_fused(seg.subgraph, seg.fp,
                                   row_budget=row_budget,
                                   part=seg.part, stage=seg.stage))
    if gp.segments and gp.rows_used != rows_seen:
        errors.append(VerifyError(
            V013_SEGMENT_ROW_BUDGET,
            f"partition claims rows_used={gp.rows_used} but its widest "
            f"segment allocates {rows_seen}", layer="mimd"))
    return errors


# ---------------------------------------------------------------------------
# Layer 3: harden-pass structural invariants
# ---------------------------------------------------------------------------

def verify_harden(graph: BulkGraph, protected_nodes, scheme: str,
                  ) -> List[VerifyError]:
    """TMR voters must vote over three independent, structurally
    identical replicas; the ECC parity must fold every primary output
    (replica chains compute identical expressions) on protected ops."""
    from repro_torch.pim.harden import ECC_OUTPUT
    errors: List[VerifyError] = []
    protected = frozenset(protected_nodes)
    origin, producer = _origins(graph)

    def signature(j: int):
        op, opnds, _ = graph.nodes[j]
        return (op, tuple(origin[v] for v in opnds))

    if "tmr" in scheme:
        for i in sorted(protected):
            op, opnds, _ = graph.nodes[i]
            if op != "maj3":
                continue                          # ECC parity folds etc.
            prods = []
            slots = []
            for v in opnds:
                j = producer.get(origin[v])
                if j is None:
                    errors.append(VerifyError(
                        V031_TMR_REPLICA_DIVERGENT,
                        f"voter node {i} reads a graph input instead of "
                        f"a replica result", node=i, layer="harden"))
                    continue
                prods.append(j)
                slots.append(graph.nodes[j][2].index(origin[v]))
            if len(prods) == 3 and len(set(prods)) != 3:
                errors.append(VerifyError(
                    V030_TMR_REPLICA_NOT_INDEPENDENT,
                    f"voter node {i} reads replica nodes {prods} — a "
                    f"single fault in a shared replica outvotes the "
                    f"others", node=i, layer="harden"))
                continue
            if len(prods) == 3:
                sigs = {signature(j) for j in prods}
                if len(sigs) != 1 or len(set(slots)) != 1:
                    errors.append(VerifyError(
                        V031_TMR_REPLICA_DIVERGENT,
                        f"voter node {i} votes over non-equivalent "
                        f"replicas {prods} (signatures {sigs}, result "
                        f"slots {slots})", node=i, layer="harden"))

    if "ecc" in scheme:
        if ECC_OUTPUT not in graph.outputs:
            errors.append(VerifyError(
                V032_ECC_PARITY_INCOMPLETE,
                f"hardened graph exposes no {ECC_OUTPUT!r} parity "
                f"output", layer="harden"))
            return errors
        alg = _Alg()
        expr = _expected_exprs(graph, alg)
        primary = [vid for name, vid in graph.outputs.items()
                   if name != ECC_OUTPUT]
        want = expr[origin[primary[0]]]
        for vid in primary[1:]:
            want = alg.xor(want, expr[origin[vid]])
        got = expr[origin[graph.outputs[ECC_OUTPUT]]]
        if got != want:
            errors.append(VerifyError(
                V032_ECC_PARITY_INCOMPLETE,
                f"parity row computes {alg.describe(got)} but the "
                f"xor-fold of the primary outputs is "
                f"{alg.describe(want)} — a replica output is missing "
                f"from the chain", layer="harden"))
        if len(primary) > 1:
            j = producer.get(origin[graph.outputs[ECC_OUTPUT]])
            if j is None or graph.nodes[j][0] != "xor2" or j not in protected:
                errors.append(VerifyError(
                    V033_ECC_FOLD_UNPROTECTED,
                    f"the parity fold terminates in node {j} "
                    f"({graph.nodes[j][0] if j is not None else '?'}), "
                    f"which is not a protected xor2 — the detector "
                    f"could corrupt its own evidence", node=j,
                    layer="harden"))
    return errors


# ---------------------------------------------------------------------------
# Entry points: the compiler pass, Lowered objects, and the CLI
# ---------------------------------------------------------------------------

def _finish(errors: List[VerifyError], layers: Tuple[str, ...],
            aaps: int, nodes: int, t0: float) -> VerifyReport:
    report = VerifyReport(errors=tuple(errors), layers=layers,
                          aaps_checked=aaps, nodes_checked=nodes,
                          wall_s=time.perf_counter() - t0)
    VERIFY_STATS["programs"] += 1
    VERIFY_STATS["clean" if report.ok else "failed"] += 1
    for e in report.errors:
        VERIFY_STATS[e.code] += 1
    return report


def verify_state(st) -> VerifyReport:
    """The compiler pass body: verify a `_LoweringState` after encode.
    Raises the first `VerifyError` (report attached as `.report`)."""
    t0 = time.perf_counter()
    errors: List[VerifyError] = []
    layers: List[str] = []
    aaps = nodes = 0
    if st.kind == "op":
        layers.append("aap")
        aaps = len(st.program)
        nodes = 1
        errors += verify_op(st.compiled.op, st.program, st.result_rows,
                            n_rows=st.n_rows)
    else:
        budget = st.compiled.row_budget
        if st.fp is not None:
            layers.append("aap")
            aaps += len(st.fp.program)
            nodes = len(st.graph.nodes)
            errors += verify_fused(st.graph, st.fp, row_budget=budget)
        if st.gp is not None:
            layers.append("mimd")
            aaps += sum(len(s.fp.program) for s in st.gp.segments)
            errors += verify_partition(st.graph, st.gp, row_budget=budget)
        if st.harden is not None:
            layers.append("harden")
            errors += verify_harden(st.graph, st.protected_nodes,
                                    st.harden)
    return _finish(errors, tuple(layers), aaps, nodes,
                   t0).raise_if_failed()


def verify_lowered(low) -> VerifyReport:
    """Standalone verification of an already-built `Lowered` (does NOT
    raise — returns the report; `report.raise_if_failed()` to escalate)."""
    t0 = time.perf_counter()
    errors: List[VerifyError] = []
    layers: List[str] = []
    aaps = nodes = 0
    if low.kind == "op":
        layers.append("aap")
        aaps = len(low.program)
        nodes = 1
        errors += verify_op(low.op, low.program, low.result_rows,
                            n_rows=low.n_rows)
    else:
        if low.fp is not None:
            layers.append("aap")
            aaps += len(low.fp.program)
            nodes = len(low.graph.nodes)
            errors += verify_fused(low.graph, low.fp,
                                   row_budget=low.row_budget)
        if low.gp is not None:
            layers.append("mimd")
            aaps += sum(len(s.fp.program) for s in low.gp.segments)
            errors += verify_partition(low.graph, low.gp,
                                       row_budget=low.row_budget)
        if low.harden is not None:
            layers.append("harden")
            errors += verify_harden(low.graph, low.protected_nodes,
                                    low.harden)
    return _finish(errors, tuple(layers), aaps, nodes, t0)


def main(argv=None) -> int:
    """CLI: certify compiled benchmark graphs (BNN dots + the random-DAG
    corpus) across lowering configurations; exit 1 on any diagnostic."""
    import argparse

    import numpy as np

    from repro_torch.core import DrimGeometry
    from repro_torch.pim import compiler as _compiler
    from repro_torch.pim.bnn import bnn_dot_graph, bnn_dot_graph_carrysave

    ap = argparse.ArgumentParser(
        description="statically verify compiled DRIM benchmark graphs")
    ap.add_argument("--k", type=int, default=8,
                    help="BNN dot width K (default 8)")
    ap.add_argument("--seeds", type=int, default=5,
                    help="random-DAG corpus size (default 5)")
    ap.add_argument("--partition", type=int, default=4,
                    help="also verify an N-queue MIMD partition")
    ap.add_argument("--harden", default="tmr,ecc,tmr+ecc",
                    help="comma list of harden schemes to verify "
                    "(default: all; '' to skip)")
    args = ap.parse_args(argv)

    geom = DrimGeometry(chips=1, banks=4, subarrays_per_bank=4,
                        row_bits=64)
    cases = [(f"bnn_dot[K={args.k}]", bnn_dot_graph(args.k)),
             (f"bnn_dot_carrysave[K={args.k}]",
              bnn_dot_graph_carrysave(args.k)[0])]
    cases += [(f"random[{s}]", _random_graph(np.random.default_rng(s)))
              for s in range(args.seeds)]

    failures = 0
    schemes = [h for h in args.harden.split(",") if h]
    for name, g in cases:
        lowerings = [("fused", dict(engine="resident"))]
        if args.partition:
            lowerings.append((f"mimd[{args.partition}q]",
                              dict(partition=args.partition)))
        for h in schemes:
            lowerings.append((f"harden[{h}]",
                              dict(engine="resident", harden=h)))
        for label, kw in lowerings:
            low = _compiler.compile(g, geom=geom).lower(verify=False, **kw)
            report = verify_lowered(low)
            status = "ok" if report.ok else ",".join(report.codes)
            print(f"{name:28s} {label:16s} nodes={report.nodes_checked:4d} "
                  f"aaps={report.aaps_checked:5d} "
                  f"wall={report.wall_s * 1e3:7.2f}ms  {status}")
            failures += 0 if report.ok else 1
    if failures:
        print(f"{failures} lowering(s) FAILED verification")
        return 1
    print("all lowerings verified clean")
    return 0


def _random_graph(rng, max_nodes: int = 8) -> BulkGraph:
    """The tests' random-DAG corpus builder, inlined for the CLI."""
    ops = ("copy", "not", "xnor2", "xor2", "maj3", "add")
    g = BulkGraph()
    values = [g.input(f"in{i}") for i in range(int(rng.integers(1, 5)))]
    for _ in range(int(rng.integers(1, max_nodes + 1))):
        op = ops[int(rng.integers(0, len(ops)))]
        opnds = [values[int(rng.integers(0, len(values)))]
                 for _ in range(OP_ARITY[op])]
        out = g.op(op, *opnds)
        values.extend(out if isinstance(out, tuple) else (out,))
    picks = {len(values) - 1} | {int(rng.integers(0, len(values)))
                                 for _ in range(int(rng.integers(1, 4)))}
    for j, vi in enumerate(sorted(picks)):
        g.output(f"out{j}", values[vi])
    return g


if __name__ == "__main__":           # pragma: no cover
    raise SystemExit(main())
