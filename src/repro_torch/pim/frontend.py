"""`jit`: trace plain Python bit-plane functions into BulkGraphs (port of
`repro.pim.frontend`).

SIMDRAM's end-to-end framework argument (Hajinazar et al., 2021) is that
a PIM platform earns adoption only when the programmer writes ordinary
code and a transparent pipeline does the mapping.  Here a plain Python
function over symbolic bit-plane tensors IS the program:

    @jit
    def kernel(a, b, c):
        x = xnor(a, b)          # paper's single-cycle DRA
        s, carry = full_add(x, c, b)
        return {"s": s, "carry": carry}

    out = kernel(A, B, C)            # trace -> compile -> lower -> run

`BitTensor` operands record `^ & | ~` (and the stdlib below) straight
into a `BulkGraph`; `jit(fn)` traces once, caches the `TracedProgram`,
and `pim.compiler.compile(...)` lowers it onto any engine.  Every
operator maps to real DRIM hardware: `^` is the DRA XOR2, `~` the DCC
row NOT, `&`/`|` are TRA MAJ3 against a constant all-zeros/all-ones
plane (`x & y == maj3(x, y, 0)`, `x | y == maj3(x, y, 1)`), so traced
programs cost exactly what the equivalent hand-built graph costs.

Constant planes are synthesized lazily as one reserved graph input
(`ZERO_INPUT`, auto-fed with zero words at run time) plus a single
`not` node for the all-ones plane — the tracer memoizes both, so a
graph pays at most one extra input row and 2 AAPs however many `&`/`|`
nodes it holds.

The stdlib covers the paper's workload idioms: `xnor`, `maj`, `select`,
`full_add`, a one-level carry-save compression (`csa_reduce`) and the
full 3:2-compressor `popcount` tree (node-for-node the dataflow of
`pim.bnn.bnn_dot_graph_carrysave`).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.subarray import as_words
from repro_torch.pim.graph import BulkGraph, ValueRef, graph_ref_results

# Reserved input name for the auto-fed all-zeros constant plane.  User
# argument / output names must not enter this namespace.
ZERO_INPUT = "__drim_zero__"
_RESERVED_PREFIX = "__drim"


class TraceError(TypeError):
    """An operation the DRIM tracer cannot record (Python control flow
    on a symbolic plane, mixing planes with host scalars, planes from
    two different traces, non-integer feeds, ...)."""


class _Tracer:
    """One in-flight trace: owns the BulkGraph under construction and
    the memoized constant planes."""

    def __init__(self) -> None:
        self.graph = BulkGraph()
        self.input_names: List[str] = []
        self._zero: Optional[BitTensor] = None
        self._ones: Optional[BitTensor] = None

    def input(self, name: str) -> "BitTensor":
        self.input_names.append(name)
        return BitTensor(self, self.graph.input(name))

    def apply(self, opname: str, *tensors: "BitTensor"):
        for t in tensors:
            if not isinstance(t, BitTensor):
                raise TraceError(
                    f"bulk op {opname!r} takes BitTensor operands, got "
                    f"{type(t).__name__}; only symbolic bit-planes can "
                    f"be traced")
            if t.tracer is not self:
                raise TraceError(
                    "operand belongs to a different trace — BitTensors "
                    "cannot cross jit boundaries")
        out = self.graph.op(opname, *(t.ref for t in tensors))
        if isinstance(out, tuple):
            return tuple(BitTensor(self, r) for r in out)
        return BitTensor(self, out)

    @property
    def const_names(self) -> Tuple[str, ...]:
        return (ZERO_INPUT,) if self._zero is not None else ()

    def zero(self) -> "BitTensor":
        if self._zero is None:
            self._zero = BitTensor(self, self.graph.input(ZERO_INPUT))
        return self._zero

    def ones(self) -> "BitTensor":
        if self._ones is None:
            self._ones = self.apply("not", self.zero())
        return self._ones


class BitTensor:
    """A symbolic bit-plane: one DRAM row's worth of lanes per tile.

    Supports the Python bitwise operators (`^ & | ~`) plus the module
    stdlib; anything else — branching, iteration, arithmetic against
    host scalars — raises `TraceError`, because the hardware has no such
    instruction and the trace would silently diverge otherwise.
    """

    __slots__ = ("tracer", "ref")

    def __init__(self, tracer: _Tracer, ref: ValueRef) -> None:
        self.tracer = tracer
        self.ref = ref

    # -- traced operators --------------------------------------------------
    def _binary(self, other: Any, opname: str) -> "BitTensor":
        if not isinstance(other, BitTensor):
            raise TraceError(
                f"cannot {opname} a BitTensor with {type(other).__name__}"
                " — wrap constants as bit-plane inputs, or use the "
                "tracer's zero()/ones() constant planes via & and |")
        return self.tracer.apply(opname, self, other)

    def __xor__(self, other: Any) -> "BitTensor":
        return self._binary(other, "xor2")

    __rxor__ = __xor__

    def __and__(self, other: Any) -> "BitTensor":
        if not isinstance(other, BitTensor):
            raise TraceError(
                "cannot & a BitTensor with " + type(other).__name__)
        return self.tracer.apply("maj3", self, other, self.tracer.zero())

    __rand__ = __and__

    def __or__(self, other: Any) -> "BitTensor":
        if not isinstance(other, BitTensor):
            raise TraceError(
                "cannot | a BitTensor with " + type(other).__name__)
        return self.tracer.apply("maj3", self, other, self.tracer.ones())

    __ror__ = __or__

    def __invert__(self) -> "BitTensor":
        return self.tracer.apply("not", self)

    # -- untraceable surfaces ---------------------------------------------
    def __bool__(self) -> bool:
        raise TraceError(
            "BitTensor has no Python truth value — `if plane:` branches "
            "on symbolic data the hardware decides lane-wise; use "
            "select(cond, a, b) instead")

    def __iter__(self):
        raise TraceError("BitTensor is not iterable under trace")

    def _no_arith(self, *_a, **_k):
        raise TraceError(
            "BitTensor supports only bit-wise ops (^ & | ~ and the drim "
            "stdlib); integer arithmetic must be built from full_add / "
            "popcount bit-plane dataflows")

    __add__ = __radd__ = __sub__ = __rsub__ = _no_arith
    __mul__ = __rmul__ = __lshift__ = __rshift__ = _no_arith
    __index__ = __int__ = __float__ = _no_arith


# ---------------------------------------------------------------------------
# stdlib: the bulk-op vocabulary as traced functions
# ---------------------------------------------------------------------------

def _tracer_of(*tensors: BitTensor) -> _Tracer:
    for t in tensors:
        if not isinstance(t, BitTensor):
            raise TraceError(
                f"expected BitTensor operands, got {type(t).__name__}")
    tr = tensors[0].tracer
    if any(t.tracer is not tr for t in tensors):
        raise TraceError("operands belong to different traces")
    return tr


def xnor(a: BitTensor, b: BitTensor) -> BitTensor:
    """The paper's headline op: single-cycle DRA X(N)OR."""
    return _tracer_of(a, b).apply("xnor2", a, b)


def maj(a: BitTensor, b: BitTensor, c: BitTensor) -> BitTensor:
    """TRA 3-input majority."""
    return _tracer_of(a, b, c).apply("maj3", a, b, c)


def copy(a: BitTensor) -> BitTensor:
    """Row alias (0 AAPs after fusion's copy elision)."""
    return _tracer_of(a).apply("copy", a)


def full_add(a: BitTensor, b: BitTensor,
             c: BitTensor) -> Tuple[BitTensor, BitTensor]:
    """Table-2 full-adder bit slice: (sum, carry)."""
    return _tracer_of(a, b, c).apply("add", a, b, c)


def select(cond: BitTensor, a: BitTensor, b: BitTensor) -> BitTensor:
    """Lane-wise mux: cond ? a : b == (a & cond) | (b & ~cond)."""
    _tracer_of(cond, a, b)
    return (a & cond) | (b & ~cond)


def csa_reduce(planes: Sequence[BitTensor],
               ) -> Tuple[List[BitTensor], List[BitTensor]]:
    """One carry-save 3:2 compression pass over same-weight planes.

    Returns (sums, carries): every three planes collapse to one sum
    (same weight) + one carry (next weight); a leftover pair is settled
    with a half adder (full_add against the zero plane); a single
    leftover plane passes through.  `popcount` iterates this to a
    single plane per weight.
    """
    planes = list(planes)
    if not planes:
        raise TraceError("csa_reduce needs at least one plane")
    tr = _tracer_of(*planes)
    sums: List[BitTensor] = []
    carries: List[BitTensor] = []
    while len(planes) >= 3:
        s, c = full_add(planes[0], planes[1], planes[2])
        planes = planes[3:] + [s]
        carries.append(c)
    if len(planes) == 2:
        s, c = full_add(planes[0], planes[1], tr.zero())
        planes = [s]
        carries.append(c)
    sums.extend(planes)
    return sums, carries


def popcount(planes: Sequence[BitTensor]) -> List[BitTensor]:
    """Carry-save 3:2-compressor popcount tree over K weight-0 planes.

    Node-for-node the dataflow of `pim.bnn.bnn_dot_graph_carrysave`:
    every weight level compresses until one plane remains; the result
    list is the binary count, LSB first (len == ceil(log2(K+1)))."""
    planes = list(planes)
    if not planes:
        raise TraceError("popcount needs at least one plane")
    _tracer_of(*planes)
    levels: List[List[BitTensor]] = [planes]
    w = 0
    while w < len(levels):
        sums, carries = csa_reduce(levels[w])
        levels[w] = sums
        if carries:
            if w + 1 < len(levels):
                levels[w + 1].extend(carries)
            else:
                levels.append(carries)
        w += 1
    return [vals[0] for vals in levels]


# ---------------------------------------------------------------------------
# Tracing: Python function -> TracedProgram
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TracedProgram:
    """An immutable trace: the recorded BulkGraph plus the calling
    convention (positional arg names, auto-fed constant inputs, and how
    to restructure the named outputs into the function's return shape).
    """

    name: str
    graph: BulkGraph
    arg_names: Tuple[str, ...]
    const_names: Tuple[str, ...]
    out_kind: str                    # "single" | "tuple" | "dict"
    out_names: Tuple[str, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.graph.nodes)

    def feeds_for(self, arrays: Sequence[Any]) -> Dict[str, Any]:
        """Map positional word arrays onto the graph's named inputs and
        append the constant planes.  Raises TraceError on non-integer
        dtypes (a float feed silently truncating would be a silent
        wrong answer) and ValueError on arity mismatch; per-feed length
        agreement is enforced downstream by the executor."""
        if len(arrays) != len(self.arg_names):
            raise ValueError(
                f"{self.name} takes {len(self.arg_names)} input planes "
                f"({', '.join(self.arg_names)}), got {len(arrays)}")
        feeds: Dict[str, Any] = {}
        n_words = None
        for name, a in zip(self.arg_names, arrays):
            if isinstance(a, torch.Tensor):
                ok = not (a.dtype.is_floating_point or a.dtype.is_complex
                          or a.dtype == torch.bool)
                dt = a.dtype
            else:
                a = np.asarray(a)
                ok, dt = np.issubdtype(a.dtype, np.integer), a.dtype
            if not ok:
                raise TraceError(
                    f"input {name!r} has dtype {dt}, expected packed "
                    f"integer words (32-bit bit-planes)")
            feeds[name] = a
            if n_words is None:
                n_words = int(np.prod(tuple(a.shape)))
        for cname in self.const_names:
            feeds[cname] = np.zeros(n_words or 1, np.uint32)
        return feeds

    def restructure(self, outs: Dict[str, Any]):
        """Named output dict -> the traced function's return shape."""
        if self.out_kind == "single":
            return outs[self.out_names[0]]
        if self.out_kind == "tuple":
            return tuple(outs[n] for n in self.out_names)
        return {n: outs[n] for n in self.out_names}

    def oracle(self, *arrays):
        """Pure-numpy reference semantics of the traced program."""
        feeds = {n: as_words(a, "cpu").reshape(-1).numpy().view(np.uint32)
                 for n, a in self.feeds_for(arrays).items()}
        return self.restructure(graph_ref_results(self.graph, feeds))


def _signature_arg_names(fn: Callable) -> Tuple[str, ...]:
    sig = inspect.signature(fn)
    names = []
    for p in sig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD, p.KEYWORD_ONLY):
            raise TraceError(
                f"cannot infer input planes from {fn.__name__}'s "
                f"signature (found {p.kind.description} parameter "
                f"{p.name!r}); pass jit(fn, arg_names=[...])")
        names.append(p.name)
    return tuple(names)


def _trace(fn: Callable, arg_names: Tuple[str, ...],
           name: str) -> TracedProgram:
    if not arg_names:
        raise TraceError(f"{name} takes no input planes; a traced "
                         "program needs at least one operand")
    for n in arg_names:
        if n.startswith(_RESERVED_PREFIX):
            raise TraceError(
                f"input name {n!r} collides with the reserved "
                f"{_RESERVED_PREFIX}* constant namespace")
    tracer = _Tracer()
    args = [tracer.input(n) for n in arg_names]
    result = fn(*args)

    if isinstance(result, BitTensor):
        out_kind, items = "single", [("out", result)]
    elif isinstance(result, (tuple, list)):
        out_kind = "tuple"
        items = [(f"out{i}", t) for i, t in enumerate(result)]
    elif isinstance(result, dict):
        out_kind, items = "dict", list(result.items())
    else:
        raise TraceError(
            f"{name} returned {type(result).__name__}; traced programs "
            "must return a BitTensor, a tuple/list of them, or a "
            "{name: BitTensor} dict")
    if not items:
        raise TraceError(f"{name} returned no output planes")
    for oname, t in items:
        if not isinstance(oname, str) or oname.startswith(_RESERVED_PREFIX):
            raise TraceError(f"bad output name {oname!r}")
        if not isinstance(t, BitTensor) or t.tracer is not tracer:
            raise TraceError(
                f"output {oname!r} is not a BitTensor of this trace")
        tracer.graph.output(oname, t.ref)
    return TracedProgram(
        name=name, graph=tracer.graph, arg_names=tuple(arg_names),
        const_names=tracer.const_names, out_kind=out_kind,
        out_names=tuple(n for n, _ in items))


class JittedFunction:
    """A Python bit-wise function staged for the DRIM pipeline.

    `trace()` records the BulkGraph once and caches it (re-tracing a
    pure function is pure waste, and the cache is what makes repeated
    `kernel(...)` calls cheap).  `lower(...)` memoizes one `Lowered`
    per (geometry, engine, mesh, n_queues, partition) signature, so
    direct calls reuse compiled artifacts; `__call__` is the
    convenience path: trace -> compile -> lower -> run in one line,
    returning outputs in the traced function's own shape.
    """

    def __init__(self, fn: Callable, *,
                 arg_names: Optional[Sequence[str]] = None,
                 name: Optional[str] = None) -> None:
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "traced")
        self._arg_names = tuple(arg_names) if arg_names is not None \
            else None
        self._traced: Optional[TracedProgram] = None
        self._lowerings: Dict[Tuple, Any] = {}
        self._last_run: Any = None

    def trace(self) -> TracedProgram:
        if self._traced is None:
            names = self._arg_names
            if names is None:
                names = _signature_arg_names(self.fn)
            self._traced = _trace(self.fn, names, self.name)
        return self._traced

    # `compile()` accepts JittedFunction via this hook.
    @property
    def traced(self) -> TracedProgram:
        return self.trace()

    def lower(self, *, geom=None, engine: Optional[str] = None,
              mesh=None, n_queues: Optional[int] = None,
              partition=None, row_budget: Optional[int] = -1):
        from repro_torch.pim import compiler
        key = (geom, engine, mesh, n_queues, partition, row_budget)
        low = self._lowerings.get(key)
        if low is None:
            kwargs = {} if row_budget == -1 else {"row_budget": row_budget}
            low = compiler.compile(self.trace(), geom=geom, **kwargs) \
                .lower(engine=engine, mesh=mesh, n_queues=n_queues,
                       partition=partition)
            self._lowerings[key] = low
        return low

    def __call__(self, *arrays, geom=None, engine: Optional[str] = None,
                 mesh=None, n_queues: Optional[int] = None,
                 partition=None, n_bits: Optional[int] = None,
                 device=None):
        low = self.lower(geom=geom, engine=engine, mesh=mesh,
                         n_queues=n_queues, partition=partition)
        out = low.run(*arrays, n_bits=n_bits, device=device)
        self._last_run = low
        return out

    @property
    def last_schedule(self):
        """Measured schedule of the most recent `__call__` run."""
        return self._last_run.schedule if self._last_run else None


def jit(fn: Optional[Callable] = None, *,
        arg_names: Optional[Sequence[str]] = None,
        name: Optional[str] = None):
    """Stage a plain Python bit-wise function for the DRIM pipeline.

    Usable bare (`@jit`) or parameterized
    (`jit(fn, arg_names=[...])` for *args-style functions whose
    input planes cannot be read off the signature)."""
    if fn is None:
        return lambda f: JittedFunction(f, arg_names=arg_names, name=name)
    return JittedFunction(fn, arg_names=arg_names, name=name)
