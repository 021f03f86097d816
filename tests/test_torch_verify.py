"""The port's static verifier (`repro_torch.pim.verify`, the default-on
`verify` pass) held against the JAX reference's `repro.pim.verify`: a
twin of `tests/test_verify.py`.

Two halves, as in the reference suite:

  1. **Soundness on the real compiler**: every lowering the pipeline
     produces (op, fused, partitioned, hardened, on "resident",
     "baseline", "queued" and "cuda", and the random-DAG corpus) certifies
     clean with the pass on by default, and its `VerifyReport` (codes,
     layers, AAPs and nodes checked) equals the reference's for the same
     lowering.
  2. **Sensitivity via mutation**: each mutant of the reference suite is
     built the same way in both packages, and the port reports the same
     diagnostics in the same order, with the same code, message and
     node / AAP / queue / stage anchors.

Every check is exact.  The "cuda" engine runs nothing here: the verifier
reads the lowered program, not a kernel.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import drim
from repro.core import DrimGeometry as RefGeometry
from repro.core import isa as ref_isa
from repro.core import subarray as ref_subarray
from repro.pim import bnn as ref_bnn
from repro.pim import graph as ref_graph
from repro.pim import harden as ref_harden
from repro.pim import verify as ref_verify
from repro_torch.core import DrimGeometry, FaultModel, isa, subarray
from repro_torch.pim import bnn, compiler, graph, harden
from repro_torch.pim import compile as tcompile
from repro_torch.pim import verify as V

from test_graph import GEOMS, random_graph
from test_torch_graph import port_graph

SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
# the port's engine name for each of the reference's
REF_ENGINE = {"resident": "resident", "baseline": "baseline",
              "queued": "queued", "cuda": "pallas"}

# The two packages' pieces a mutant is built from.
PORT = types.SimpleNamespace(
    BulkGraph=graph.BulkGraph, compile_graph=graph.compile_graph,
    partition_graph=graph.partition_graph, harden_graph=harden.harden_graph,
    ECC_OUTPUT=harden.ECC_OUTPUT, bnn_dot_graph=bnn.bnn_dot_graph,
    V=V, OP_DRA=isa.OP_DRA, OP_TRA=isa.OP_TRA, N_DCC_WL=subarray.N_DCC_WL)
REF = types.SimpleNamespace(
    BulkGraph=ref_graph.BulkGraph, compile_graph=ref_graph.compile_graph,
    partition_graph=ref_graph.partition_graph,
    harden_graph=ref_harden.harden_graph, ECC_OUTPUT=ref_harden.ECC_OUTPUT,
    bnn_dot_graph=ref_bnn.bnn_dot_graph, V=ref_verify,
    OP_DRA=ref_isa.OP_DRA, OP_TRA=ref_isa.OP_TRA,
    N_DCC_WL=ref_subarray.N_DCC_WL)


@pytest.fixture(autouse=True)
def default_verify(monkeypatch):
    """The pass's default: on, whatever DRIM_VERIFY the caller set."""
    monkeypatch.delenv("DRIM_VERIFY", raising=False)


def report_key(rep):
    return (rep.codes, rep.layers, rep.aaps_checked, rep.nodes_checked)


def diagnostics(errors):
    """Everything a diagnostic says but its wall time."""
    return [(e.code, str(e), e.node, e.aap, e.part, e.stage, e.layer)
            for e in errors]


def codes_of(errors):
    return {e.code for e in errors}


def lower_both(src_port, src_ref, engine=None, **kw):
    ref_engine = REF_ENGINE[engine] if engine else None
    low = tcompile(src_port, geom=GEOM).lower(engine, **kw)
    low_ref = drim.compile(src_ref, geom=REF_GEOM).lower(ref_engine, **kw)
    return low, low_ref


# ---------------------------------------------------------------------------
# Clean graphs used as mutation substrates, built with either package
# ---------------------------------------------------------------------------

def two_independent_xnors(P):
    """x = a xnor b, y = c xnor d: two live result rows at the end."""
    g = P.BulkGraph()
    a, b, c, d = (g.input(n) for n in "abcd")
    g.output("x", g.op("xnor2", a, b))
    g.output("y", g.op("xnor2", c, d))
    return g


def chained_xnors(P):
    """x = a xnor b (consumes a, b), z = x xnor c."""
    g = P.BulkGraph()
    a, b, c = (g.input(n) for n in "abc")
    g.output("z", g.op("xnor2", g.op("xnor2", a, b), c))
    return g


def shared_operand_xnors(P):
    """x and y both read a, b: forces staged x-row copies for node 0."""
    g = P.BulkGraph()
    a, b = g.input("a"), g.input("b")
    g.output("x", g.op("xnor2", a, b))
    g.output("y", g.op("xnor2", a, b))
    return g


# ---------------------------------------------------------------------------
# Half 1: the unmutated world verifies clean, as the reference's does
# ---------------------------------------------------------------------------

LOWERINGS = {
    "op": ("xnor2", {}),
    "fused": ("bnn4", {}),
    "partition": ("bnn4", dict(partition=GEOM.banks)),
    "tmr": ("bnn4", dict(harden="tmr")),
    "ecc": ("bnn4", dict(harden="ecc")),
    "tmr+ecc": ("bnn4", dict(harden="tmr+ecc")),
    "partition+tmr+ecc": ("bnn4", dict(partition=GEOM.banks,
                                       harden="tmr+ecc")),
    "carry-save K=32": ("cs32", {}),
}


@pytest.mark.parametrize("case", LOWERINGS)
def test_existing_lowerings_clean_and_reported(case):
    """The pass is on by default and stamps `Lowered.verify_report` on op,
    graph, partition and harden lowerings; the report equals the
    reference's, and `verify_lowered` certifies the lowering again."""
    src, kw = LOWERINGS[case]
    if src == "bnn4":
        srcs = (bnn.bnn_dot_graph(4), ref_bnn.bnn_dot_graph(4))
    elif src == "cs32":
        srcs = (bnn.bnn_dot_graph_carrysave(32)[0],
                ref_bnn.bnn_dot_graph_carrysave(32)[0])
    else:
        srcs = (src, src)
    low, low_ref = lower_both(*srcs, **kw)
    rep = low.verify_report
    assert rep is not None and rep.ok and rep.aaps_checked > 0
    assert report_key(rep) == report_key(low_ref.verify_report)
    again = V.verify_lowered(low)
    assert again.ok and report_key(again) == report_key(rep)


@pytest.mark.parametrize("engine", REF_ENGINE)
def test_all_engines_certify_clean(engine):
    low, low_ref = lower_both(bnn.bnn_dot_graph(3), ref_bnn.bnn_dot_graph(3),
                              engine)
    assert low.verify_report is not None and low.verify_report.ok
    assert report_key(low.verify_report) == \
        report_key(low_ref.verify_report)


def test_comparator_lowerings_are_verified():
    """The "gpu" comparator's lowerings (the reference's "tpu") carry the
    same report: the pass reads the program, not the engine."""
    for src, ref_src in (("add", "add"), (bnn.bnn_dot_graph(3),
                                          ref_bnn.bnn_dot_graph(3))):
        low = tcompile(src, geom=GEOM).lower("gpu")
        low_ref = drim.compile(ref_src, geom=REF_GEOM).lower("tpu")
        assert report_key(low.verify_report) == \
            report_key(low_ref.verify_report)


@pytest.mark.parametrize("seed", range(10))
def test_random_corpus_clean(seed):
    """Random DAGs x {fused, raw partitions, every harden scheme}: clean
    in the port wherever the reference is."""
    g_ref = random_graph(np.random.default_rng(seed))
    g = port_graph(g_ref)
    assert V.verify_fused(g, graph.compile_graph(g)) == [] == \
        ref_verify.verify_fused(g_ref, ref_graph.compile_graph(g_ref))
    for n_parts in (2, 3):
        assert V.verify_partition(g, graph.partition_graph(g, n_parts)) \
            == [] == ref_verify.verify_partition(
                g_ref, ref_graph.partition_graph(g_ref, n_parts))
    for scheme in ("tmr", "ecc", "tmr+ecc"):
        hg, prot = harden.harden_graph(g, scheme)
        assert V.verify_harden(hg, prot, scheme) == []
        assert V.verify_fused(hg, graph.compile_graph(hg)) == []


@pytest.mark.parametrize("seed", range(4))
def test_random_corpus_reports_equal_reference(seed):
    """Lowering by lowering, the port's report equals the reference's:
    fused, partitioned over each geometry's banks with tmr+ecc, and each
    harden scheme."""
    g_ref = random_graph(np.random.default_rng(100 + seed))
    g = port_graph(g_ref)
    for geom_ref in GEOMS:
        geom = DrimGeometry(**dataclasses.asdict(geom_ref))
        for kw in ({}, dict(partition=geom.banks, harden="tmr+ecc"),
                   dict(harden="tmr"), dict(harden="ecc")):
            low = tcompile(g, geom=geom).lower(**kw)
            low_ref = drim.compile(g_ref, geom=geom_ref).lower(**kw)
            assert low.verify_report.ok, kw
            assert report_key(low.verify_report) == \
                report_key(low_ref.verify_report), kw


# ---------------------------------------------------------------------------
# Enable/disable resolution: lower(verify=...) x DRIM_VERIFY
# ---------------------------------------------------------------------------

def test_verify_flag_resolution(monkeypatch):
    c = tcompile("xnor2", geom=GEOM)
    assert c.lower().verify_report is not None          # on by default
    assert c.lower(verify=False).verify_report is None  # explicit off
    monkeypatch.setenv("DRIM_VERIFY", "0")
    assert c.lower().verify_report is None              # env default off
    assert c.lower(verify=True).verify_report is not None
    monkeypatch.setenv("DRIM_VERIFY", "1")
    assert c.lower(verify=False).verify_report is not None   # forced on
    for env in ("", "0", "1", "yes"):
        monkeypatch.setenv("DRIM_VERIFY", env)
        for flag in (None, False, True):
            assert V.resolve_enabled(flag) == \
                ref_verify.resolve_enabled(flag), (env, flag)
        assert V.default_enabled() == ref_verify.default_enabled()


def test_lower_cached_keys_on_the_resolved_flag(monkeypatch):
    """A verified lowering is never handed to a caller whose flag resolves
    off, nor the reverse; DRIM_VERIFY=1 makes verify=False a verified
    call, so it shares the verified entry."""
    compiler.clear_lower_cache()
    try:
        on = compiler.lower_cached("xnor2", geom=GEOM)
        assert on.verify_report is not None
        off = compiler.lower_cached("xnor2", geom=GEOM, verify=False)
        assert off is not on and off.verify_report is None
        assert compiler.lower_cached("xnor2", geom=GEOM, verify=True) is on
        monkeypatch.setenv("DRIM_VERIFY", "1")
        assert compiler.lower_cached("xnor2", geom=GEOM,
                                     verify=False) is on
        monkeypatch.setenv("DRIM_VERIFY", "0")
        assert compiler.lower_cached("xnor2", geom=GEOM) is off
        assert dict(compiler.LOWER_CACHE_STATS) == {"misses": 2, "hits": 3}
    finally:
        compiler.clear_lower_cache()


def test_verify_stats_count_programs_and_codes():
    before = dict(V.VERIFY_STATS)
    tcompile("xnor2", geom=GEOM).lower(verify=True)
    g, fp, code = mutant_v008_dropped_span(PORT)
    low = tcompile(g, geom=GEOM).lower(verify=False)
    low.fp = fp
    rep = V.verify_lowered(low)
    assert not rep.ok and code in rep.codes
    got = {k: V.VERIFY_STATS[k] - before.get(k, 0) for k in V.VERIFY_STATS}
    want = {"programs": 2, "clean": 1, "failed": 1}
    for c in rep.codes:
        want[c] = want.get(c, 0) + 1
    assert {k: n for k, n in got.items() if n} == want


def test_the_pass_refuses_a_miscompiled_stream(monkeypatch):
    """A use-after-recycle compiled in by a broken `compile_graph` raises
    `VerifyError` (a ValueError) at lower time, before any run; with the
    pass off the same stream lowers."""
    g, fp, code = mutant_v001_use_after_recycle(PORT)
    monkeypatch.setattr(compiler, "compile_graph", lambda *a, **k: fp)
    with pytest.raises(V.VerifyError) as ei:
        tcompile(g, geom=GEOM).lower("cuda")
    assert ei.value.code == code and isinstance(ei.value, ValueError)
    assert ei.value.report.codes[0] == code
    assert tcompile(g, geom=GEOM).lower("cuda", verify=False) \
        .verify_report is None


# ---------------------------------------------------------------------------
# Half 2: mutation differentials -- each hazard class must be caught, with
# the reference's diagnostics
# ---------------------------------------------------------------------------
# Layer 1: AAP-stream mutants ------------------------------------------------

def mutant_v001_use_after_recycle(P):
    """Redirect node y's read at a row holding node x's (unrelated)
    result: the row-recycling aliasing hazard."""
    g = two_independent_xnors(P)
    fp = P.compile_graph(g)
    x_row = dict(fp.device_outputs)["x"]
    (_, lo, _) = fp.node_spans[-1]             # node y's span
    prog = list(fp.program)
    ins = prog[lo]
    args = list(ins.args)
    args[P.V._READ_ARG[ins.op][0]] = x_row
    prog[lo] = dataclasses.replace(ins, args=tuple(args))
    return g, dataclasses.replace(fp, program=tuple(prog)), \
        P.V.V001_USE_AFTER_RECYCLE


def mutant_v002_read_after_destructive_read(P):
    """Make the AAP after a DRA/TRA re-read one of its charge-shared
    source rows."""
    g = chained_xnors(P)
    fp = P.compile_graph(g)
    prog = list(fp.program)
    for k, ins in enumerate(prog[:-1]):
        if ins.op not in (P.OP_DRA, P.OP_TRA):
            continue
        dest = ins.args[P.V._DEST_ARG[ins.op][0]]
        consumed = [ins.args[p] for p in P.V._READ_ARG[ins.op]
                    if ins.args[p] != dest
                    and ins.args[p] < fp.template_rows]
        if not consumed:
            continue
        nxt = prog[k + 1]
        args = list(nxt.args)
        args[P.V._READ_ARG[nxt.op][0]] = consumed[0]
        prog[k + 1] = dataclasses.replace(nxt, args=tuple(args))
        return g, dataclasses.replace(fp, program=tuple(prog)), \
            P.V.V002_READ_AFTER_DESTRUCTIVE_READ
    raise AssertionError("substrate has no DRA with a consumed source")


def mutant_v003_out_of_bounds(P):
    g = chained_xnors(P)
    fp = P.compile_graph(g)
    ins = fp.program[0]
    args = (fp.template_rows + P.N_DCC_WL + 10,) + ins.args[1:]
    prog = (dataclasses.replace(ins, args=args),) + fp.program[1:]
    return g, dataclasses.replace(fp, program=prog), \
        P.V.V003_WL_OUT_OF_BOUNDS


def mutant_v005_unwritten_read(P):
    """Point the first AAP's read at the top x-row, which nothing has
    staged or written at stream position 0."""
    g = chained_xnors(P)
    fp = P.compile_graph(g)
    ins = fp.program[0]
    args = list(ins.args)
    args[P.V._READ_ARG[ins.op][0]] = fp.template_rows - 1
    prog = (dataclasses.replace(ins, args=tuple(args)),) + fp.program[1:]
    return g, dataclasses.replace(fp, program=prog), P.V.V005_UNWRITTEN_READ


def mutant_v006_bogus_alias(P):
    g = two_independent_xnors(P)
    fp = dataclasses.replace(P.compile_graph(g), alias_outputs=(("x", "a"),))
    return g, fp, P.V.V006_ALIAS_OUTPUT_VIOLATION


def mutant_v007_swapped_outputs(P):
    g = two_independent_xnors(P)
    fp = P.compile_graph(g)
    rows = dict(fp.device_outputs)
    assert rows["x"] != rows["y"]
    outs = (("x", rows["y"]), ("y", rows["x"]))
    fp2 = dataclasses.replace(
        fp, device_outputs=outs,
        readback_rows=tuple(dict.fromkeys(r for _, r in outs)))
    return g, fp2, P.V.V007_OUTPUT_MISMATCH


def mutant_v008_dropped_span(P):
    g = two_independent_xnors(P)
    fp = P.compile_graph(g)
    return g, dataclasses.replace(fp, node_spans=fp.node_spans[:-1]), \
        P.V.V008_NODE_SPAN_MALFORMED


def mutant_v009_wrong_operand_wiring(P):
    """Re-wire node x's DRA to read the same staged copy twice: every
    read is still a legal operand row, but the stream computes
    xnor(a, a) where the graph says xnor(a, b)."""
    g = shared_operand_xnors(P)
    fp = P.compile_graph(g)
    (_, lo, hi) = fp.node_spans[0]
    prog = list(fp.program)
    for k in range(lo, hi):
        if prog[k].op == P.OP_DRA:
            a0, _, dest = prog[k].args
            prog[k] = dataclasses.replace(prog[k], args=(a0, a0, dest))
            return g, dataclasses.replace(fp, program=tuple(prog)), \
                P.V.V009_NODE_RESULT_MISMATCH
    raise AssertionError("node 0 emitted no DRA")


FUSED_MUTANTS = [
    mutant_v001_use_after_recycle,
    mutant_v002_read_after_destructive_read,
    mutant_v003_out_of_bounds,
    mutant_v005_unwritten_read,
    mutant_v006_bogus_alias,
    mutant_v007_swapped_outputs,
    mutant_v008_dropped_span,
    mutant_v009_wrong_operand_wiring,
]


def fused_errors(make, P):
    g, fp, expected = make(P)
    assert P.V.verify_fused(g, P.compile_graph(g)) == []   # clean substrate
    return P.V.verify_fused(g, fp), expected


@pytest.mark.parametrize("make", FUSED_MUTANTS,
                         ids=lambda m: m.__name__.replace("mutant_", ""))
def test_fused_mutant_dies(make):
    errors, expected = fused_errors(make, PORT)
    errors_ref, expected_ref = fused_errors(make, REF)
    assert expected == expected_ref
    assert expected in codes_of(errors), [str(e) for e in errors]
    assert diagnostics(errors) == diagnostics(errors_ref)


def v004_errors(P):
    g = P.bnn_dot_graph(4)
    fp = P.compile_graph(g)
    assert fp.n_data_rows > 1
    return P.V.verify_fused(g, fp, row_budget=fp.n_data_rows - 1)


def test_v004_row_budget():
    errors = v004_errors(PORT)
    assert codes_of(errors) == {V.V004_ROW_BUDGET_EXCEEDED}
    assert diagnostics(errors) == diagnostics(v004_errors(REF))


# Layer 2: MIMD partition mutants -------------------------------------------

def clean_partition(P, n_parts=2):
    g = P.bnn_dot_graph(4)
    gp = P.partition_graph(g, n_parts)
    assert P.V.verify_partition(g, gp) == []
    assert gp.cross_fence_rows > 0        # a real merge exists to race
    return g, gp


def unfenced(P):
    """Move a merge node's whole segment one fence stage earlier: the
    partition stays structurally consistent, but the cross-queue read
    now runs concurrently with its producer."""
    g, gp = clean_partition(P)
    origin, producer = P.V._origins(g)
    victim = next(
        i for i, (opname, opnds, _) in enumerate(g.nodes)
        if opname != "copy" and any(
            (j := producer.get(origin[v])) is not None
            and gp.part_of[j] != gp.part_of[i]
            and gp.stage_of[i] == gp.stage_of[j] + 1 for v in opnds))
    key = (gp.part_of[victim], gp.stage_of[victim])
    stage_of = list(gp.stage_of)
    segments = []
    for seg in gp.segments:
        if (seg.part, seg.stage) == key:
            for nid in seg.node_ids:
                stage_of[nid] = seg.stage - 1
            seg = dataclasses.replace(seg, stage=seg.stage - 1)
        segments.append(seg)
    return g, dataclasses.replace(gp, stage_of=tuple(stage_of),
                                  segments=tuple(segments))


PARTITION_MUTANTS = {
    "v010_unfenced_cross_queue_read":
        (unfenced, "V010_UNFENCED_CROSS_QUEUE_READ", False),
    "v011_partition_structure": (
        lambda P: (lambda g, gp: (g, dataclasses.replace(
            gp, output_sources=gp.output_sources + (("ghost", "v999"),))))(
            *clean_partition(P)), "V011_PARTITION_STRUCTURE", True),
    "v012_cross_fence_accounting": (
        lambda P: (lambda g, gp: (g, dataclasses.replace(
            gp, cross_fence_rows=gp.cross_fence_rows + 1)))(
            *clean_partition(P)), "V012_CROSS_FENCE_ACCOUNTING", True),
    "v013_segment_row_budget": (
        lambda P: (lambda g, gp: (g, dataclasses.replace(
            gp, rows_used=gp.rows_used + 1)))(*clean_partition(P)),
        "V013_SEGMENT_ROW_BUDGET", True),
}


@pytest.mark.parametrize("name", PARTITION_MUTANTS)
def test_partition_mutant_dies(name):
    make, code, only = PARTITION_MUTANTS[name]
    errors = V.verify_partition(*make(PORT))
    assert getattr(V, code) == code
    if only:
        assert codes_of(errors) == {code}
    else:
        assert code in codes_of(errors), [str(e) for e in errors]
    assert diagnostics(errors) == diagnostics(
        ref_verify.verify_partition(*make(REF)))


# Layer 3: harden-invariant mutants -----------------------------------------

def first_voter(hg, protected):
    return next(i for i in sorted(protected) if hg.nodes[i][0] == "maj3")


def shared_replica(P):
    hg, prot = P.harden_graph(P.bnn_dot_graph(3), "tmr")
    assert P.V.verify_harden(hg, prot, "tmr") == []
    i = first_voter(hg, prot)
    op, opnds, res = hg.nodes[i]
    hg.nodes[i] = (op, (opnds[0], opnds[0], opnds[2]), res)
    return hg, prot, "tmr"


def divergent_replica(P):
    hg, prot = P.harden_graph(P.bnn_dot_graph(3), "tmr")
    i = first_voter(hg, prot)
    op, opnds, res = hg.nodes[i]
    hg.nodes[i] = (op, (hg.input_vids[0],) + opnds[1:], res)
    return hg, prot, "tmr"


def missing_parity(P):
    hg, prot = P.harden_graph(P.bnn_dot_graph(3), "ecc")
    assert P.V.verify_harden(hg, prot, "ecc") == []
    del hg.outputs[P.ECC_OUTPUT]
    return hg, prot, "ecc"


def incomplete_fold(P):
    hg, prot = P.harden_graph(P.bnn_dot_graph(3), "ecc")
    primary = [n for n in hg.outputs if n != P.ECC_OUTPUT]
    assert len(primary) > 1
    hg.outputs[P.ECC_OUTPUT] = hg.outputs[primary[0]]
    return hg, prot, "ecc"


def unprotected_fold(P):
    hg, prot = P.harden_graph(P.bnn_dot_graph(3), "ecc")
    origin, producer = P.V._origins(hg)
    j = producer[origin[hg.outputs[P.ECC_OUTPUT]]]
    return hg, prot - {j}, "ecc"


HARDEN_MUTANTS = {
    "v030_shared_replica":
        (shared_replica, "V030_TMR_REPLICA_NOT_INDEPENDENT", False),
    "v031_divergent_replica":
        (divergent_replica, "V031_TMR_REPLICA_DIVERGENT", False),
    "v032_missing_parity_output":
        (missing_parity, "V032_ECC_PARITY_INCOMPLETE", True),
    "v032_incomplete_fold":
        (incomplete_fold, "V032_ECC_PARITY_INCOMPLETE", False),
    "v033_unprotected_fold":
        (unprotected_fold, "V033_ECC_FOLD_UNPROTECTED", True),
}


@pytest.mark.parametrize("name", HARDEN_MUTANTS)
def test_harden_mutant_dies(name):
    make, code, only = HARDEN_MUTANTS[name]
    errors = V.verify_harden(*make(PORT))
    if only:
        assert codes_of(errors) == {code}
    else:
        assert code in codes_of(errors), [str(e) for e in errors]
    assert diagnostics(errors) == diagnostics(
        ref_verify.verify_harden(*make(REF)))


# V020: faults + mesh is a named lower-time diagnostic -----------------------

def test_v020_faults_on_mesh_is_verify_error():
    """Active faults with a fleet mesh raise the V020 diagnostic at lower
    time and at run time, as the reference's do."""
    err = V.faults_on_mesh_error()
    assert err.code == V.V020_FAULTS_UNSUPPORTED_ON_MESH == \
        ref_verify.faults_on_mesh_error().code
    assert isinstance(err, ValueError) and "unsharded" in str(err)
    assert err.layer == "lower"
    from repro_torch.pim import fleet_mesh
    mesh = fleet_mesh(GEOM, devices=[torch.device("cpu")] * 8)
    hot = FaultModel(p_dra=0.25, seed=3)
    with pytest.raises(V.VerifyError, match="V020") as ei:
        tcompile("xnor2", geom=GEOM).lower("resident", mesh=mesh,
                                           faults=hot)
    assert ei.value.code == V.V020_FAULTS_UNSUPPORTED_ON_MESH
    low = tcompile("xnor2", geom=GEOM).lower("resident", mesh=mesh)
    w = np.zeros(GEOM.n_subarrays * GEOM.row_bits // 32, np.uint32)
    with pytest.raises(V.VerifyError, match="V020"):
        low.run(w, w, device="cpu", faults=hot)


# ---------------------------------------------------------------------------
# Coverage floor and the CLI
# ---------------------------------------------------------------------------

def test_mutation_coverage_floor():
    """Every code but V020 (no mesh in the port) is killed by a mutant
    of this suite, and the codes are the reference's."""
    assert V.ALL_CODES == ref_verify.ALL_CODES
    killed = set()
    for make in FUSED_MUTANTS:
        killed |= codes_of(fused_errors(make, PORT)[0])
    killed |= codes_of(v004_errors(PORT))
    for make, _, _ in PARTITION_MUTANTS.values():
        killed |= codes_of(V.verify_partition(*make(PORT)))
    for make, _, _ in HARDEN_MUTANTS.values():
        killed |= codes_of(V.verify_harden(*make(PORT)))
    assert killed == set(V.ALL_CODES) - {V.V020_FAULTS_UNSUPPORTED_ON_MESH}


def strip_wall(text):
    return [" ".join(w for w in line.split()
                     if not w.startswith("wall=") and not w.endswith("ms"))
            for line in text.splitlines()]


def test_cli_lines_equal_reference(capsys):
    """The CLI prints the reference's lines (but the wall times) and
    exits 0: two BNN dots and two random DAGs, each fused, over two
    queues and under each harden scheme."""
    argv = ["--k", "3", "--seeds", "2", "--partition", "2"]
    assert V.main(argv) == 0
    out = capsys.readouterr().out
    assert ref_verify.main(argv) == 0
    out_ref = capsys.readouterr().out
    assert len(out.splitlines()) == 4 * 5 + 1
    assert out.splitlines()[-1] == "all lowerings verified clean"
    assert strip_wall(out) == strip_wall(out_ref)
