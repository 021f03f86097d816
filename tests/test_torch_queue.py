"""The port's per-bank command queues (`pim.queue`, `graph.partition_graph`,
the "queued" engine, `core.isa.simulate_bus_issue`,
`core.device.device_run_program_banked`) held against the JAX reference.

Structure must be identical: every `GraphPartition` field and every
segment's subgraph and fused program over the random-DAG corpus of
`tests/test_graph.py` and the carry-save trees, every `QueueSchedule`
field and derived number (goldens: carry-save K=32 takes 113 AAPs on the
4-queue critical path, 249 fused, ripple 1376), the bus-issue makespans
and the per-queue encode-memo accounting.  Executed words must equal the
reference's partitioned (`lower(partition=True)`) and uniform queued
(`lower(engine="queued")`) runs and `xnor_gemm_ref`, clean and at the
+-15 % corner, bare and TMR, on the port's "queued" body and on "cuda"
(the interpreter kernel's plain twin on the CPU).  Tolerance: exact
equality everywhere (all values are integers)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import drim
from repro.core import DrimGeometry as RefGeometry
from repro.core import device as ref_dev
from repro.core import isa as ref_isa
from repro.core.timing import CMD_SLOTS_PER_AAP
from repro.kernels import ops as ref_ops
from repro.kernels.ref import xnor_gemm_ref
from repro.pim import bnn as ref_bnn
from repro.pim import graph as ref_graph
from repro.pim import queue as ref_queue
from repro.pim import scheduler as ref_scheduler
from repro_torch.core import DrimGeometry, FaultModel, encode, isa
from repro_torch.core import device as tdev
from repro_torch.pim import bnn, graph, queue, scheduler
from repro_torch.pim import compile as tcompile

from test_graph import random_graph
from test_torch_graph import (FUSED_PROPS, assert_fused_identical, port_graph,
                              u32)

SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
QUEUE_PROPS = FUSED_PROPS + (
    "critical_path_aaps", "queue_busy_aaps", "fence_dma_s",
    "serialized_latency_s", "overlapped_latency_s", "dma_overlap_speedup")
PARTITION_FIELDS = (
    "n_parts", "n_stages", "n_nodes", "part_of", "stage_of", "cross_edges",
    "output_sources", "queue_aaps_per_tile", "stage_aaps",
    "critical_path_aaps_per_tile", "issued_aaps_per_tile", "rows_used",
    "loaded_input_rows", "readback_rows_count", "cross_fence_rows",
    "unfused_aaps_per_tile", "unfused_ddr_rows_per_tile")
HOT = dict(p_dra=0.25, p_tra=0.35, seed=5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def structure(g):
    return (tuple(g.input_names), tuple(g.nodes), tuple(g.outputs.items()))


def assert_partition_equal(gp, gp_ref):
    for field in PARTITION_FIELDS:
        assert getattr(gp, field) == getattr(gp_ref, field), field
    assert len(gp.segments) == len(gp_ref.segments)
    for s, r in zip(gp.segments, gp_ref.segments):
        assert (s.part, s.stage, s.node_ids) == (r.part, r.stage, r.node_ids)
        assert structure(s.subgraph) == structure(r.subgraph)
        assert_fused_identical(s.fp, r.fp)


def assert_queue_schedules_equal(sched, sched_ref):
    assert type(sched).__name__ == type(sched_ref).__name__ == \
        "QueueSchedule"
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)
    for prop in QUEUE_PROPS:
        assert prop_or_error(sched, prop) == prop_or_error(sched_ref, prop), \
            prop


def prop_or_error(sched, prop):
    """A derived number, or the error type computing it raises (an
    alias-only graph has no device time to divide by)."""
    try:
        return getattr(sched, prop)
    except ArithmeticError as err:
        return type(err)


def assert_outputs_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(u32(got[name]), np.asarray(want[name]),
                                      err_msg=name)


def feeds_for(g, n_words, seed):
    rng = np.random.default_rng(seed)
    return {n: (np.zeros(n_words, np.uint32) if n == "zero"
                else rng.integers(0, 1 << 32, n_words, dtype=np.uint32))
            for n in g.input_names}


# ---------------------------------------------------------------------------
# Bus issue model, queue counts, bank blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_bus_issue_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(8):
        lengths = [int(x) for x in rng.integers(0, 30, int(rng.integers(
            0, 70)))]
        slots = int(rng.choice([3, 7, 20, CMD_SLOTS_PER_AAP]))
        assert isa.simulate_bus_issue(lengths, slots_per_aap=slots) == \
            ref_isa.simulate_bus_issue(lengths, slots_per_aap=slots)
    assert isa.CMDS_PER_AAP == ref_isa.CMDS_PER_AAP
    with pytest.raises(ValueError):
        isa.simulate_bus_issue([1], slots_per_aap=2, cmds_per_aap=3)


def test_queue_counts_and_blocks():
    for banks in (1, 2, 4, 6, 8, 12, 64, 256):
        geom = DrimGeometry(banks=banks, subarrays_per_bank=2)
        ref = RefGeometry(banks=banks, subarrays_per_bank=2)
        assert queue.default_n_queues(geom) == ref_queue.default_n_queues(ref)
        for nq in (None, 1, 2, 3, 4, 8):
            try:
                want = ref_queue.resolve_n_queues(ref, nq)
            except ValueError:
                with pytest.raises(ValueError):
                    queue.resolve_n_queues(geom, nq)
                continue
            assert queue.resolve_n_queues(geom, nq) == want
            assert queue.bank_blocks(banks, want) == \
                ref_queue.bank_blocks(banks, want)
    assert queue.DEFAULT_MAX_QUEUES == ref_queue.DEFAULT_MAX_QUEUES
    # the queue mesh: the largest split of a queue's bank block over the
    # mesh's devices (the reference's rule), None for no mesh
    from repro.pim.mesh import fleet_shape as ref_fleet_shape
    from repro_torch.pim import fleet_mesh
    mesh = fleet_mesh(GEOM, devices=[torch.device("cpu")] * 8)
    assert queue.queue_mesh(GEOM, 2) is None
    for nq in (1, 2, 4):
        qm = queue.queue_mesh(GEOM, nq, mesh=mesh)
        assert tuple(qm.shape.values()) == ref_fleet_shape(
            dataclasses.replace(REF_GEOM, banks=REF_GEOM.banks // nq), 8)


def test_stage_rows_queued_splits_the_simd_staging():
    """Each queue's payload is its bank block of `stage_rows`' tiles."""
    rng = np.random.default_rng(4)
    n_words = 2 * GEOM.n_subarrays * 2 + 5
    arrays = [torch.from_numpy(rng.integers(-2**31, 2**31, n_words,
                                            dtype=np.int32))
              for _ in range(3)]
    full, tiles, waves = scheduler.stage_rows(arrays, geom=GEOM)
    for nq in (1, 2, 4):
        qs, t, w = queue.stage_rows_queued(arrays, geom=GEOM, n_queues=nq)
        assert (t, w) == (tiles, waves)
        assert torch.equal(torch.cat(qs, dim=3), full)
        for (lo, hi), st in zip(queue.bank_blocks(GEOM.banks, nq), qs):
            assert st.is_contiguous() and st.shape[3] == hi - lo


# ---------------------------------------------------------------------------
# partition_graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_partition_random_dags_identical(seed):
    rng = np.random.default_rng(2000 + seed)
    for _ in range(4):
        g_ref = random_graph(rng, max_nodes=12)
        g = port_graph(g_ref)
        for nq in (1, 2, 3, 4):
            assert_partition_equal(graph.partition_graph(g, nq),
                                   ref_graph.partition_graph(g_ref, nq))


@pytest.mark.parametrize("k", [5, 8, 32])
def test_partition_carrysave_trees_identical(k):
    g, _ = bnn.bnn_dot_graph_carrysave(k)
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(k)
    for nq in (1, 2, 4, 8):
        gp = graph.partition_graph(g, nq)
        assert_partition_equal(gp, ref_graph.partition_graph(g_ref, nq))
    if k == 32:
        assert graph.partition_graph(g, 4).critical_path_aaps_per_tile \
            == 113
        assert graph.compile_graph(g).aaps_per_tile == 249
        assert graph.compile_graph(bnn.bnn_dot_graph(32)).aaps_per_tile \
            == 1376


def test_partition_prefix_forced_export_and_errors():
    """Input names that start with the internal prefix grow it ("v#");
    a segment whose values are all dead still exports its last one."""
    def build(mod):
        g = mod.BulkGraph()
        a, b = g.input("v4"), g.input("v#1")
        g.op("not", a)                      # dead: a forced export row
        x = g.op("xnor2", a, b)
        y = g.op("maj3", x, a, b)
        g.output("s", g.op("add", y, x, a)[0])
        g.output("a_out", a)
        return g
    g, g_ref = build(graph), build(ref_graph)
    for nq in (1, 2, 4):
        gp = graph.partition_graph(g, nq)
        assert_partition_equal(gp, ref_graph.partition_graph(g_ref, nq))
    gp = graph.partition_graph(g, 2)
    assert any(name.startswith("v##") for s in gp.segments
               for name in s.subgraph.outputs)
    dead_seg = [s for s in gp.segments if s.node_ids == (0,)]
    assert dead_seg and dead_seg[0].subgraph.outputs
    with pytest.raises(ValueError, match="positive"):
        graph.partition_graph(g, 0)
    with pytest.raises(ValueError, match="no outputs"):
        graph.partition_graph(graph.BulkGraph(), 2)


# ---------------------------------------------------------------------------
# QueueSchedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(scheduler.OP_ARITY))
def test_uniform_queue_schedules_identical(op):
    for shape in (SHAPE, dict(chips=1, banks=8, subarrays_per_bank=4),
                  dict(chips=1, banks=64, subarrays_per_bank=4)):
        geom, ref = DrimGeometry(**shape), RefGeometry(**shape)
        for nq in (None, 1, shape["banks"]):
            for n_bits in (1, 4097, 1 << 20):
                assert_queue_schedules_equal(
                    queue.uniform_queue_schedule(op, n_bits=n_bits,
                                                 geom=geom, n_queues=nq),
                    ref_queue.uniform_queue_schedule(op, n_bits=n_bits,
                                                     geom=ref, n_queues=nq))
    assert queue.plan_queued_schedule is queue.uniform_queue_schedule


def test_contention_case_stalls():
    """The 64-bank, 64-queue fleet saturates the command bus."""
    geom = DrimGeometry(chips=1, banks=64, subarrays_per_bank=4)
    ref = RefGeometry(chips=1, banks=64, subarrays_per_bank=4)
    s = queue.plan_queued_schedule("xnor2", n_bits=1 << 20, geom=geom,
                                   n_queues=64)
    assert s.contention_stall_aaps > 0
    assert_queue_schedules_equal(s, ref_queue.plan_queued_schedule(
        "xnor2", n_bits=1 << 20, geom=ref, n_queues=64))
    g, _ = bnn.bnn_dot_graph_carrysave(32)
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(32)
    for nq in (16, 64):
        sp = queue.plan_partitioned_schedule(g, 1 << 22, geom=geom,
                                             n_queues=nq)
        assert_queue_schedules_equal(sp, ref_queue.plan_partitioned_schedule(
            g_ref, 1 << 22, geom=ref, n_queues=nq))


@pytest.mark.parametrize("seed", range(4))
def test_fused_and_partitioned_schedules_identical(seed):
    rng = np.random.default_rng(3000 + seed)
    for _ in range(3):
        g_ref = random_graph(rng, max_nodes=10)
        g = port_graph(g_ref)
        for n_bits in (1, 999, 1 << 16):
            fused = graph.plan_graph_schedule(g, n_bits, geom=GEOM)
            fused_ref = ref_graph.plan_graph_schedule(g_ref, n_bits,
                                                      geom=REF_GEOM)
            for nq in (1, 2, 4):
                assert_queue_schedules_equal(
                    queue.fused_queue_schedule(fused, geom=GEOM,
                                               n_queues=nq),
                    ref_queue.fused_queue_schedule(fused_ref, geom=REF_GEOM,
                                                   n_queues=nq))
                assert_queue_schedules_equal(
                    queue.plan_partitioned_schedule(g, n_bits, geom=GEOM,
                                                    n_queues=nq),
                    ref_queue.plan_partitioned_schedule(
                        g_ref, n_bits, geom=REF_GEOM, n_queues=nq))


def test_golden_carrysave_schedules():
    """113 AAPs on the 4-queue critical path, 249 fused, 1376 ripple
    (BENCH_queue.json), through `lower().cost()` as the reference."""
    g, _ = bnn.bnn_dot_graph_carrysave(32)
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(32)
    n_bits = 1 << 20
    part = tcompile(g, geom=GEOM).lower(partition=True, n_queues=4)
    part_ref = drim.compile(g_ref, geom=REF_GEOM).lower(
        partition=True, n_queues=4, verify=False)
    assert part.kind == "partition" and part.aaps == 113
    assert_queue_schedules_equal(part.cost(n_bits), part_ref.cost(n_bits))
    fused = tcompile(g, geom=GEOM).lower("queued", n_queues=4)
    fused_ref = drim.compile(g_ref, geom=REF_GEOM).lower(
        "queued", n_queues=4, verify=False)
    assert fused.cost(n_bits).aaps_per_tile == 249
    assert_queue_schedules_equal(fused.cost(n_bits), fused_ref.cost(n_bits))
    ripple = tcompile(bnn.bnn_dot_graph(32), geom=GEOM).lower("queued")
    assert ripple.cost(n_bits).aaps_per_tile == 1376
    for op in ("xnor2", "add"):
        assert_queue_schedules_equal(
            tcompile(op, geom=GEOM).lower("queued").cost(n_bits),
            drim.compile(op, geom=REF_GEOM).lower(
                "queued", verify=False).cost(n_bits))


# ---------------------------------------------------------------------------
# Full-state MIMD reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", [None, HOT])
def test_device_run_program_banked_matches_reference(faults):
    rng = np.random.default_rng(0xBA)
    ref = ref_dev.make_device(REF_GEOM, n_data=8)
    data = rng.integers(0, 1 << 32, ref.data.shape, dtype=np.uint32)
    dcc = rng.integers(0, 1 << 32, ref.dcc.shape, dtype=np.uint32)
    ref = ref_dev.DrimDevice(data=jnp.asarray(data), dcc=jnp.asarray(dcc))
    port = tdev.DrimDevice(data=torch.from_numpy(data.view(np.int32)),
                           dcc=torch.from_numpy(dcc.view(np.int32)))
    for nq in (2, 4):
        blocks = queue.bank_blocks(GEOM.banks, nq)
        ops = ("xnor2", "add", "maj3", "xor2")[:nq]
        progs = [scheduler.build_program(op) for op in ops]
        fm = FaultModel(**faults) if faults else None
        rfm = drim.FaultModel(**faults) if faults else None
        out = tdev.device_run_program_banked(
            port, [encode(p) for p in progs], blocks, faults=fm)
        want = ref_dev.device_run_program_banked(
            ref, [ref_isa.encode(ref_scheduler.build_program(op))
                  for op in ops], blocks, faults=rfm)
        np.testing.assert_array_equal(u32(out.data), np.asarray(want.data))
        np.testing.assert_array_equal(u32(out.dcc), np.asarray(want.dcc))
    with pytest.raises(ValueError):
        tdev.device_run_program_banked(port, [encode(progs[0])] * 2,
                                       [(0, 1), (2, 4)])
    with pytest.raises(ValueError):
        tdev.device_run_program_banked(port, [encode(progs[0])],
                                       queue.bank_blocks(4, 2))


# ---------------------------------------------------------------------------
# Executed words: uniform queued and partitioned runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", sorted(scheduler.OP_ARITY))
def test_uniform_queued_ops_equal_reference(op):
    row_w = GEOM.row_bits // 32
    n_words = 2 * GEOM.n_subarrays * row_w + 3
    args = scheduler.random_operands(op, n_words, seed=sum(map(ord, op)))
    for nq in (1, 2, 4):
        ref_low = drim.compile(op, geom=REF_GEOM).lower(
            "queued", n_queues=nq, verify=False)
        want = ref_low.run(*args)
        low = tcompile(op, geom=GEOM).lower("queued", n_queues=nq)
        got = low.run(*args, device="cpu")
        res = tcompile(op, geom=GEOM).lower("resident").run(*args,
                                                            device="cpu")
        for g_, r_, w_ in zip(got, res, want):
            np.testing.assert_array_equal(u32(g_), np.asarray(w_))
            assert torch.equal(g_, r_)
        assert_queue_schedules_equal(low.schedule, ref_low.schedule)
        assert low.schedule == low.cost(n_words * 32)


@pytest.mark.parametrize("harden", [None, "tmr"])
@pytest.mark.parametrize("faults", [None, HOT])
def test_uniform_queued_graph_equals_reference(faults, harden):
    """The fused K=4 dot on every queue, faulted runs included: the
    reference's queued words, and the port's resident words."""
    g, _ = bnn.bnn_dot_graph_carrysave(4)
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(4)
    feeds = feeds_for(g, 3 * GEOM.n_subarrays + 1, 7)
    fm = FaultModel(**faults) if faults else None
    rfm = drim.FaultModel(**faults) if faults else None
    ref_low = drim.compile(g_ref, geom=REF_GEOM).lower(
        "queued", n_queues=4, harden=harden, verify=False)
    want = ref_low.run(feeds, faults=rfm)
    low = tcompile(g, geom=GEOM).lower("queued", n_queues=4, harden=harden)
    got = low.run(feeds, device="cpu", faults=fm)
    assert_outputs_equal(got, want)
    res = tcompile(g, geom=GEOM).lower("resident", harden=harden).run(
        feeds, device="cpu", faults=fm)
    assert all(torch.equal(got[k], res[k]) for k in res)
    assert_queue_schedules_equal(low.schedule, ref_low.schedule)


@pytest.fixture(scope="module")
def partitioned_case():
    """The K=5 carry-save dot (ragged, 2 waves of 2 queue blocks), and the
    reference's partitioned outputs per (queues, harden, faults)."""
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(5)
    feeds = feeds_for(g_ref, 2 * GEOM.n_subarrays + 3, 11)
    corner = drim.FaultModel.from_corner(0.15, source="paper", seed=0)
    want = {}
    for nq in (2, 4):
        for harden in (None, "tmr"):
            for name, fm in (("clean", None), ("corner", corner),
                             ("hot", drim.FaultModel(**HOT))):
                low = drim.compile(g_ref, geom=REF_GEOM).lower(
                    partition=True, n_queues=nq, harden=harden,
                    verify=False)
                out = {k: np.asarray(v)
                       for k, v in low.run(feeds, faults=fm).items()}
                want[nq, harden, name] = (out, low.schedule)
    return feeds, ref_graph.graph_ref_results(g_ref, feeds), want


@pytest.mark.parametrize("engine", ["queued", "cuda"])
@pytest.mark.parametrize("nq", [2, 4])
@pytest.mark.parametrize("harden", [None, "tmr"])
def test_partitioned_runs_equal_reference(engine, nq, harden,
                                          partitioned_case):
    feeds, oracle, want = partitioned_case
    g, _ = bnn.bnn_dot_graph_carrysave(5)
    corner = FaultModel.from_corner(0.15, source="paper", seed=0)
    low = tcompile(g, geom=GEOM).lower(engine, partition=True, n_queues=nq,
                                       harden=harden)
    assert low.kind == "partition" and low.n_queues == nq
    for name, fm in (("clean", None), ("corner", corner),
                     ("hot", FaultModel(**HOT))):
        got = low.run(feeds, device="cpu", faults=fm)
        ref_out, ref_sched = want[nq, harden, name]
        assert_outputs_equal(got, ref_out)
        assert_queue_schedules_equal(low.schedule, ref_sched)
        assert low.chaos_report is None
        if name == "clean" or (harden == "tmr" and name == "corner"):
            assert_outputs_equal(got, oracle)
    assert low.schedule == low.cost(feeds["zero"].size * 32)


@pytest.mark.parametrize("seed", range(4))
def test_partitioned_random_dags_equal_reference(seed):
    rng = np.random.default_rng(0xFACE + seed)
    g_ref = random_graph(rng)
    g = port_graph(g_ref)
    n_words = int(rng.integers(1, 40))
    feeds = {name: rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
             for name in g.input_names}
    oracle = ref_graph.graph_ref_results(g_ref, feeds)
    for nq in (1, 2, 4):
        ref_low = drim.compile(g_ref, geom=REF_GEOM).lower(
            partition=True, n_queues=nq, verify=False)
        want = ref_low.run(feeds)
        for engine in ("queued", "cuda"):
            low = tcompile(g, geom=GEOM).lower(engine, partition=nq)
            got = low.run(feeds, device="cpu")
            assert_outputs_equal(got, want)
            assert_outputs_equal(got, oracle)
            assert_queue_schedules_equal(low.schedule, ref_low.schedule)


@pytest.mark.parametrize("engine", ["queued", "cuda"])
def test_bnn_dot_partitioned_equals_xnor_gemm_ref(engine):
    rng = np.random.default_rng(3)
    for k in (1, 2, 3, 5, 8, 9):
        a = rng.integers(0, 2, (4, k)).astype(np.uint8)
        b = rng.integers(0, 2, (5, k)).astype(np.uint8)
        want = np.asarray(xnor_gemm_ref(
            ref_ops.pack_signs(jnp.asarray(a, jnp.float32) - 0.5),
            ref_ops.pack_signs(jnp.asarray(b, jnp.float32) - 0.5), k))
        got, sched = bnn.bnn_dot_partitioned(a, b, geom=GEOM, n_queues=4,
                                             engine=engine, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        c_ref, s_ref = ref_bnn.bnn_dot_partitioned(a, b, geom=REF_GEOM,
                                                   n_queues=4)
        np.testing.assert_array_equal(got.numpy(), np.asarray(c_ref))
        assert_queue_schedules_equal(sched, s_ref)
        fused = bnn.bnn_dot_drim(a, b, geom=GEOM, accumulate="carrysave",
                                 device="cpu")[1]
        assert sched.aaps_per_tile <= fused.aaps_per_tile


# ---------------------------------------------------------------------------
# Lowering surface and encode-memo accounting
# ---------------------------------------------------------------------------

def test_lowering_arguments_resolve_as_the_reference():
    g, _ = bnn.bnn_dot_graph_carrysave(3)
    low = tcompile(g, geom=GEOM).lower(partition=2)
    assert (low.engine.name, low.partition, low.n_queues) == \
        ("queued", "greedy", 2)
    assert "partition='greedy'" in repr(low)
    assert tcompile(g, geom=GEOM).lower("queued").n_queues == 4
    assert tcompile(g, geom=GEOM).lower("resident").n_queues is None
    with pytest.raises(ValueError, match="conflicts"):
        tcompile(g, geom=GEOM).lower(partition=2, n_queues=4)
    with pytest.raises(ValueError, match="unknown partitioner"):
        tcompile(g, geom=GEOM).lower(partition="metis")
    with pytest.raises(ValueError, match="queued"):
        tcompile(g, geom=GEOM).lower("resident", partition=True)
    with pytest.raises(ValueError, match="graph source"):
        tcompile("xnor2", geom=GEOM).lower(partition=True)
    with pytest.raises(ValueError, match="only applies"):
        tcompile("xnor2", geom=GEOM).lower("cuda", n_queues=2)
    with pytest.raises(ValueError, match="comparator"):
        tcompile("xnor2", geom=GEOM).lower("gpu", n_queues=2)
    with pytest.raises(ValueError, match="divide"):
        tcompile("xnor2", geom=GEOM).lower("queued", n_queues=3)


@pytest.fixture
def port_encode_cache():
    """An empty port encode memo and stats for one test, restored after."""
    saved = (dict(scheduler._ENCODED_CACHE),
             scheduler._ENCODED_TUPLE_CACHE.copy(),
             scheduler.ENCODE_CACHE_STATS.copy())
    scheduler._ENCODED_CACHE.clear()
    scheduler._ENCODED_TUPLE_CACHE.clear()
    scheduler.ENCODE_CACHE_STATS.clear()
    yield scheduler.ENCODE_CACHE_STATS
    scheduler._ENCODED_CACHE.clear()
    scheduler._ENCODED_CACHE.update(saved[0])
    scheduler._ENCODED_TUPLE_CACHE.clear()
    scheduler._ENCODED_TUPLE_CACHE.update(saved[1])
    scheduler.ENCODE_CACHE_STATS.clear()
    scheduler.ENCODE_CACHE_STATS.update(saved[2])


def test_encoded_program_per_queue_accounting(port_encode_cache,
                                              encode_cache):
    """Mixed per-queue segment streams: the port books the reference's
    hits and misses, per queue, on a cold memo and on a repeat."""
    g, _ = bnn.bnn_dot_graph_carrysave(5)
    g_ref, _ = ref_bnn.bnn_dot_graph_carrysave(5)
    feeds = feeds_for(g, 4, 11)
    low = tcompile(g, geom=GEOM).lower(partition=True, n_queues=2)
    ref_low = drim.compile(g_ref, geom=REF_GEOM).lower(
        partition=True, n_queues=2, verify=False)
    assert len({s.fp.program for s in low.gp.segments}) > 1
    steps = []
    for _ in range(2):
        low.run(feeds, device="cpu")
        ref_low.run(feeds)
        steps.append((dict(port_encode_cache), dict(encode_cache)))
    for got, want in steps:
        assert {k: v for k, v in got.items() if v} == \
            {k: v for k, v in want.items() if v}
    n_segs = len(low.gp.segments)
    first, second = steps[0][0], steps[1][0]
    assert first["misses"] == len({s.fp.program for s in low.gp.segments})
    assert second["hits"] - first.get("hits", 0) == n_segs


def test_uniform_queued_cache_accounting(port_encode_cache, encode_cache):
    a, b, c = scheduler.random_operands("maj3", 8, seed=2)
    for _ in range(2):
        tcompile("maj3", geom=GEOM).lower("queued", n_queues=2).run(
            a, b, c, device="cpu")
        drim.compile("maj3", geom=REF_GEOM).lower(
            "queued", n_queues=2, verify=False).run(a, b, c)
        assert {k: v for k, v in port_encode_cache.items() if v} == \
            {k: v for k, v in encode_cache.items() if v}
    assert port_encode_cache["q0:misses"] == 1
    assert port_encode_cache["q1:hits"] == 2
