"""Fault-tolerance graph rewrites: redundancy as ordinary program text
(port of `repro.pim.harden`).

DRA/TRA charge sharing is analog: Table 3 of the paper reports the share
of triple-row (and, past +-10% process variation, dual-row) activations
whose bit-line settles on the wrong side of the sense-amp threshold.  In a
bulk bit-wise ISA both classic fixes are bulk bit-wise programs, so they
compile in as graph rewrites:

  * ``tmr`` -- triple modular redundancy with per-node voting: every
    emitting node is cloned three times and each result passes through a
    ``maj3`` voter before anything downstream reads it, so at most one
    independent fault stands in front of each voter.
  * ``ecc`` -- dual modular redundancy with parity compression: the whole
    compute is duplicated and the REPLICA chain's outputs are xor-folded
    into one parity row, read back as ``"__ecc__"``.  The host
    xor-reduces the primary outputs and diffs them against that row
    (`compiler.Lowered._check_ecc`): detection, not correction.
  * ``tmr+ecc`` -- the parity detector wrapped around the voted graph.

Voter and parity nodes are returned as a *protected* node-index set: they
model guard-banded sense amplifiers, so the fault injector skips their
AAP spans.  Replicated compute stays unprotected.  The rewrite runs before
`graph.compile_graph`, so row allocation and every cost model see the
hardened program.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Tuple

from repro_torch.pim.graph import BulkGraph, ValueRef

# The parity row's reserved output name.
ECC_OUTPUT = "__ecc__"

HARDEN_SCHEMES = ("tmr", "ecc", "tmr+ecc")


def harden_graph(graph: BulkGraph, scheme: str,
                 protected: FrozenSet[int] = frozenset(),
                 ) -> Tuple[BulkGraph, FrozenSet[int]]:
    """Rewrite `graph` per `scheme`; returns (hardened graph, indices of
    protected nodes in the NEW graph's node list).

    `protected` marks nodes of the INPUT graph already running on
    guarded hardware (used internally to compose ``tmr+ecc``: the ECC
    stage must keep the TMR stage's voters protected in both chains).
    """
    if scheme not in HARDEN_SCHEMES:
        raise ValueError(f"unknown harden scheme {scheme!r} (expected "
                         f"one of {', '.join(HARDEN_SCHEMES)})")
    if ECC_OUTPUT in graph.outputs or ECC_OUTPUT in graph.input_names:
        raise ValueError(f"{ECC_OUTPUT!r} is reserved for the parity row")
    if scheme == "tmr+ecc":
        voted, prot = harden_graph(graph, "tmr", protected)
        return harden_graph(voted, "ecc", prot)
    if scheme == "tmr":
        return _tmr(graph, protected)
    return _ecc(graph, protected)


def _replay(g2: BulkGraph, env: Dict[int, ValueRef], opname: str,
            operands) -> Tuple[int, Tuple[ValueRef, ...]]:
    """Emit one node into `g2`; returns (its index, result refs)."""
    idx = len(g2.nodes)
    out = g2.op(opname, *operands)
    return idx, (out if isinstance(out, tuple) else (out,))


def _tmr(graph: BulkGraph,
         protected: FrozenSet[int]) -> Tuple[BulkGraph, FrozenSet[int]]:
    g2 = BulkGraph()
    env: Dict[int, ValueRef] = {}
    new_protected = set()
    for name, vid in zip(graph.input_names, graph.input_vids):
        env[vid] = g2.input(name)
    for i, (opname, opnds, res) in enumerate(graph.nodes):
        if opname == "copy":
            # Pure rename — nothing executes, nothing to replicate.
            env[res[0]] = env[opnds[0]]
            continue
        args = [env[v] for v in opnds]
        replicas = []
        for _ in range(3):
            idx, outs = _replay(g2, env, opname, args)
            if i in protected:
                new_protected.add(idx)
            replicas.append(outs)
        for k, v in enumerate(res):
            idx, (voted,) = _replay(g2, env, "maj3",
                                    [rep[k] for rep in replicas])
            new_protected.add(idx)
            env[v] = voted
    for name, vid in graph.outputs.items():
        g2.output(name, env[vid])
    return g2, frozenset(new_protected)


def _ecc(graph: BulkGraph,
         protected: FrozenSet[int]) -> Tuple[BulkGraph, FrozenSet[int]]:
    g2 = BulkGraph()
    primary: Dict[int, ValueRef] = {}
    replica: Dict[int, ValueRef] = {}
    new_protected = set()
    for name, vid in zip(graph.input_names, graph.input_vids):
        ref = g2.input(name)
        primary[vid] = ref          # inputs arrive over the DDR write
        replica[vid] = ref          # path, which never flips — shared
    for i, (opname, opnds, res) in enumerate(graph.nodes):
        if opname == "copy":
            primary[res[0]] = primary[opnds[0]]
            replica[res[0]] = replica[opnds[0]]
            continue
        for env in (primary, replica):
            idx, outs = _replay(g2, env, opname, [env[v] for v in opnds])
            if i in protected:
                new_protected.add(idx)
            for v, r in zip(res, outs):
                env[v] = r
    for name, vid in graph.outputs.items():
        g2.output(name, primary[vid])
    # Parity = xor-fold of the REPLICA outputs.  The fold runs on
    # protected (guard-banded) ops so the detector cannot corrupt its
    # own evidence; a single output needs no fold — the replica row
    # itself is the parity (plain DMR row compare).
    refs = [replica[vid] for vid in graph.outputs.values()]
    acc = refs[0]
    for ref in refs[1:]:
        idx, (acc,) = _replay(g2, replica, "xor2", [acc, ref])
        new_protected.add(idx)
    g2.output(ECC_OUTPUT, acc)
    return g2, frozenset(new_protected)
