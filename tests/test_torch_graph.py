"""The port's scheduler, fused-graph compiler, `jit` front end and
pipeline held against the JAX reference: fused streams tuple-identical
over the random-DAG corpus of `tests/test_graph.py`, traced programs
node-identical, the golden AAP counts (carry-save K=32: 249 fused,
ripple K=32: 1376) reproduced, and executed words equal to the
reference pipeline's.  Integer results must be exactly equal."""
import dataclasses

import numpy as np
import pytest
import torch

import drim
from repro.pim import bnn as ref_bnn
from repro.pim import frontend as ref_frontend
from repro.pim import graph as ref_graph
from repro.pim import scheduler as ref_scheduler
from repro_torch.core import DRIM_R, DrimGeometry
from repro_torch.pim import bnn, compiler, frontend, graph, scheduler

from test_graph import GEOMS, random_graph


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def geom_of(ref_geom):
    return DrimGeometry(**dataclasses.asdict(ref_geom))


def port_graph(g_ref) -> graph.BulkGraph:
    """Rebuild a reference BulkGraph node for node with the port's API
    (value ids come out identical: both number values in creation order)."""
    g = graph.BulkGraph()
    refs = {}
    for name, vid in zip(g_ref.input_names, g_ref.input_vids):
        refs[vid] = g.input(name)
    for opname, opnds, res in g_ref.nodes:
        out = g.op(opname, *(refs[v] for v in opnds))
        for v, r in zip(res, out if isinstance(out, tuple) else (out,)):
            refs[v] = r
    for name, vid in g_ref.outputs.items():
        g.output(name, refs[vid])
    return g


SCHEDULE_PROPS = ("aaps_sequential", "aaps_issued", "latency_s", "energy_j",
                  "active_subarrays", "occupancy", "throughput_bits_s")
FUSED_PROPS = SCHEDULE_PROPS + (
    "aaps_saved_per_tile", "unfused_latency_s", "speedup_vs_unfused",
    "ddr_rows_moved", "ddr_rows_saved", "dma_s", "unfused_dma_s",
    "ddr_energy_j", "total_energy_j", "unfused_total_energy_j",
    "energy_saved_j")


def assert_schedules_equal(sched, sched_ref, props=SCHEDULE_PROPS):
    """Same fields, same derived cost numbers (exactly: one formula)."""
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)
    for prop in props:
        assert getattr(sched, prop) == getattr(sched_ref, prop), prop
    assert sched.parallelism_breakdown() == sched_ref.parallelism_breakdown()


def assert_fused_identical(fp, fp_ref):
    assert [(i.op, i.args) for i in fp.program] == \
        [(i.op, i.args) for i in fp_ref.program]
    for field in ("n_data_rows", "loaded_inputs", "alias_outputs",
                  "device_outputs", "readback_rows", "n_nodes",
                  "unfused_aaps_per_tile", "unfused_ddr_rows_per_tile",
                  "node_spans", "template_rows", "ddr_rows_per_tile"):
        assert getattr(fp, field) == getattr(fp_ref, field), field


@pytest.mark.parametrize("seed", range(8))
def test_fused_streams_tuple_identical(seed):
    rng = np.random.default_rng(1000 + seed)
    for _ in range(6):
        g_ref = random_graph(rng, max_nodes=12)
        assert_fused_identical(graph.compile_graph(port_graph(g_ref)),
                               ref_graph.compile_graph(g_ref))


def test_row_budget_error_matches_reference():
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(256)
    g, _ = bnn.bnn_dot_graph_carrysave(256)
    with pytest.raises(ValueError) as want:
        ref_graph.compile_graph(g_ref)
    with pytest.raises(ValueError) as got:
        graph.compile_graph(g)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 32])
def test_bnn_graphs_and_golden_counts(k):
    """Carry-save K=32 fuses to 249 AAPs and ripple K=32 to 1376
    (README / BENCH_queue.json); the port's streams are the reference's
    streams, tuple for tuple, at every K."""
    fp_cs = graph.compile_graph(bnn.bnn_dot_graph_carrysave(k)[0])
    ref_cs = ref_graph.compile_graph(ref_bnn.bnn_dot_graph_carrysave(k)[0])
    fp_rp = graph.compile_graph(bnn.bnn_dot_graph(k))
    ref_rp = ref_graph.compile_graph(ref_bnn.bnn_dot_graph(k))
    assert_fused_identical(fp_cs, ref_cs)
    assert_fused_identical(fp_rp, ref_rp)
    assert bnn.counter_bits(k) == ref_bnn.counter_bits(k)
    if k == 32:
        assert fp_cs.aaps_per_tile == ref_cs.aaps_per_tile == 249
        assert fp_rp.aaps_per_tile == ref_rp.aaps_per_tile == 1376


def _traced_pairs():
    """The same Python bit-plane functions traced by each front end."""
    def programs(fe):
        def mix(a, b, c):
            x = fe.xnor(a, b)
            s, carry = fe.full_add(x, c, b)
            return {"s": s, "carry": carry, "sel": fe.select(a, b, c)}

        def ops(a, b, c):
            return (a ^ b) | (~c & a), fe.maj(a, b, c), fe.copy(a)

        def count(*planes):
            return fe.popcount(list(planes))
        return [fe.jit(mix), fe.jit(ops),
                fe.jit(count, arg_names=[f"p{i}" for i in range(11)])]
    return zip(programs(frontend), programs(ref_frontend))


def test_jit_traces_node_identical():
    pairs = list(_traced_pairs())
    for k in (1, 5, 16, 128):
        pairs.append((bnn.bitlinear_kernel(k), ref_bnn.bitlinear_kernel(k)))
    for jf, jf_ref in pairs:
        t, t_ref = jf.trace(), jf_ref.trace()
        assert t.graph.nodes == t_ref.graph.nodes
        assert t.graph.input_names == t_ref.graph.input_names
        assert t.graph.outputs == t_ref.graph.outputs
        assert (t.arg_names, t.const_names, t.out_kind, t.out_names) == \
            (t_ref.arg_names, t_ref.const_names, t_ref.out_kind,
             t_ref.out_names)
        assert_fused_identical(graph.compile_graph(t.graph),
                               ref_graph.compile_graph(t_ref.graph))


def test_trace_errors_match_reference():
    for fe in (frontend, ref_frontend):
        with pytest.raises(fe.TraceError):
            fe.jit(lambda a: a + 1).trace()
        with pytest.raises(fe.TraceError):
            fe.jit(lambda a: a if a else a).trace()


@pytest.mark.parametrize("engine", ["resident", "cuda"])
def test_ops_run_equal_reference(engine, small_geom):
    """Every Table-2 op on a ragged multi-wave payload: the port's words
    equal the reference pipeline's and the oracle's, schedules equal."""
    geom = geom_of(small_geom)
    row_w = geom.row_bits // 32
    n_words = 2 * geom.n_subarrays * row_w + 5
    for op in sorted(scheduler.OP_ARITY):
        args = scheduler.random_operands(op, n_words, seed=len(op))
        n_bits = n_words * 32 - 7
        low = compiler.compile(op, geom=geom).lower(engine=engine)
        got = low.run(*args, n_bits=n_bits, device="cpu")
        low_ref = drim.compile(op, geom=small_geom).lower()
        want = low_ref.run(*args, n_bits=n_bits)
        assert_schedules_equal(low.schedule, low_ref.schedule)
        assert_schedules_equal(low.cost(n_bits), ref_scheduler.plan_schedule(
            op, n_bits, geom=small_geom))
        assert_schedules_equal(scheduler.plan_schedule(op, n_bits, geom=geom),
                               low_ref.schedule)
        oracle = scheduler.expected_results(op, args)
        for g, w, o in zip(got, want, oracle):
            np.testing.assert_array_equal(u32(g), np.asarray(w))
            np.testing.assert_array_equal(u32(g), u32(o))


def test_xnor2_over_a_full_drim_r_wave():
    """One full DRIM-R wave (65,536 word columns) staged by the port."""
    n_words = DRIM_R.n_subarrays * DRIM_R.row_bits // 32 - 3
    a, b = scheduler.random_operands("xnor2", n_words, seed=9)
    staged, tiles, waves = scheduler.stage_rows(
        [torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))],
        geom=DRIM_R)
    assert staged.shape == (1, 2, 1, 8, 1024, 8) and (tiles, waves) == \
        (8192, 1)
    for engine in ("resident", "cuda"):
        out = compiler.compile("xnor2").lower(engine=engine).run(
            a, b, device="cpu")[0]
        np.testing.assert_array_equal(u32(out), ~(a ^ b))


@pytest.mark.parametrize("geom_ref", GEOMS, ids=lambda g: (
    f"{g.chips}x{g.banks}x{g.subarrays_per_bank}x{g.row_bits}"))
def test_random_dag_runs_equal_reference(geom_ref):
    """Random fused DAGs across geometries and ragged tails: the port on
    both engines, the reference pipeline and the numpy oracle agree bit
    for bit, and the measured schedules match."""
    geom = geom_of(geom_ref)
    rng = np.random.default_rng(geom.banks * 1000 + geom.row_bits)
    row_w = geom.row_bits // 32
    for _ in range(3):
        g_ref = random_graph(rng)
        g = port_graph(g_ref)
        n_words = int(rng.integers(1, 3 * geom.n_subarrays * row_w + 2))
        n_bits = int(rng.integers((n_words - 1) * 32 + 1, n_words * 32 + 1))
        feeds = {n: rng.integers(0, 2 ** 32, n_words, dtype=np.uint32)
                 for n in g.input_names}
        want = ref_graph.graph_ref_results(g_ref, feeds)
        assert graph.graph_ref_results(g, feeds).keys() == want.keys()
        low_ref = drim.compile(g_ref, geom=geom_ref).lower()
        got_ref = low_ref.run(feeds, n_bits=n_bits)
        for engine in ("resident", "cuda"):
            low = compiler.compile(g, geom=geom).lower(engine=engine)
            got = low.run(feeds, n_bits=n_bits, device="cpu")
            assert_schedules_equal(low.schedule, low_ref.schedule,
                                   FUSED_PROPS)
            assert_schedules_equal(low.cost(n_bits),
                                   ref_graph.plan_graph_schedule(
                                       g_ref, n_bits, geom=geom_ref),
                                   FUSED_PROPS)
            assert_schedules_equal(
                graph.plan_graph_schedule(g, n_bits, geom=geom),
                low_ref.schedule, FUSED_PROPS)
            for name, w in want.items():
                np.testing.assert_array_equal(u32(got[name]), w)
                np.testing.assert_array_equal(np.asarray(got_ref[name]), w)


def test_traced_call_and_lower_cache():
    @frontend.jit
    def kernel(a, b):
        return frontend.xnor(a, b) & a
    a, b = scheduler.random_operands("xnor2", 10, seed=2)
    out = kernel(a, b, engine="cuda", device="cpu")
    np.testing.assert_array_equal(u32(out), (~(a ^ b)) & a)
    assert kernel.last_schedule.aaps_per_tile == kernel.lower().aaps
    compiler.clear_lower_cache()
    for _ in range(3):
        compiler.lower_cached(kernel.trace(), key=("k",), engine="cuda")
    assert dict(compiler.LOWER_CACHE_STATS) == {"misses": 1, "hits": 2}
    compiler.clear_lower_cache()


def test_encoded_program_memo():
    scheduler.ENCODE_CACHE_STATS.clear()
    _, prog, n = scheduler.encoded_program("add")
    _, prog2, _ = scheduler.encoded_program("add")
    assert prog is prog2 and n == 7
    assert scheduler.ENCODE_CACHE_STATS["hits"] >= 1
    enc, _, _ = scheduler.encoded_program(tuple(prog))
    np.testing.assert_array_equal(
        enc.numpy(),
        np.asarray(ref_scheduler.encoded_program(
            tuple(ref_scheduler.build_program("add")))[0]))


def test_run_errors_match_reference():
    """Malformed payloads raise the reference's error types on both sides:
    feed mismatch, ragged feeds, n_bits outside the last word, a wrong
    operand count, an unknown op, float feeds, an uncompilable source."""
    g_ref = ref_graph.BulkGraph()
    a, b = g_ref.input("a"), g_ref.input("b")
    g_ref.output("x", g_ref.op("xnor2", a, b))
    g = port_graph(g_ref)
    four = np.arange(4, dtype=np.uint32)
    bad = [({"a": four}, None),                         # missing feed
           ({"a": four, "b": four, "c": four}, None),     # unexpected feed
           ({"a": four, "b": four[:3]}, None),            # ragged feeds
           ({"a": four, "b": four}, 96)]                  # n_bits too small
    for feeds, n_bits in bad:
        with pytest.raises(ValueError):
            drim.compile(g_ref).lower().run(feeds, n_bits=n_bits)
        with pytest.raises(ValueError):
            compiler.compile(g).lower().run(feeds, n_bits=n_bits,
                                            device="cpu")
    with pytest.raises(ValueError):
        drim.compile("xnor2").lower().run(four)
    with pytest.raises(ValueError):
        compiler.compile("xnor2").lower().run(four, device="cpu")
    for compile_fn in (drim.compile, compiler.compile):
        with pytest.raises(ValueError):
            compile_fn("nand9").lower()
        with pytest.raises(TypeError):
            compile_fn(3.5)
    with pytest.raises(frontend.TraceError):
        bnn.bitlinear_kernel(1)(np.zeros(2, np.float32),
                                np.zeros(2, np.uint32), device="cpu")
    with pytest.raises(ref_frontend.TraceError):
        ref_bnn.bitlinear_kernel(1)(np.zeros(2, np.float32),
                                    np.zeros(2, np.uint32))
