"""The port's elastic queue fleet (`pim.queue._execute_partitioned` with
`FaultModel.dead_queues`) held against the JAX reference's chaos suite.

A partitioned K=4 carry-save dot runs across 4 bank queues with queues
killed at a fence stage: the fence's progress table must detect the same
silent queues at the same stages, the survivors must adopt the same
number of orphaned segments, and every `ChaosReport` field but the two
host times (`recovery_s`, `compile_s`) must equal the reference's.  The
outputs must be bit-identical to the reference's on the port's "queued"
body and on "cuda" (the interpreter kernel's plain twin on the CPU),
exact against the numpy oracle without flips and under TMR at the +-15 %
corner.  Tolerance: exact equality."""
import dataclasses

import numpy as np
import pytest
import torch

import drim
from repro.core import DrimGeometry as RefGeometry
from repro.pim import graph_ref_results
from repro.pim.bnn import bnn_dot_graph_carrysave as ref_carrysave
from repro.pim.queue import QueueProgressTable as RefProgressTable
from repro_torch.core import DrimGeometry, FaultModel
from repro_torch.pim import compile as tcompile
from repro_torch.pim.bnn import bnn_dot_graph_carrysave
from repro_torch.pim.queue import QueueProgressTable

N_WORDS = 24
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
ENGINES = ("queued", "cuda")
TIMES = ("recovery_s", "compile_s")

# name -> (FaultModel kwargs, harden); "corner" takes the paper's +-15 %
# Table-3 corner
CASES = {
    "stage0_kill": (dict(dead_queues=(2,)), None),
    "mid_graph_kill": (dict(dead_queues=((0, 1),)), None),
    "two_dead": (dict(dead_queues=(1, 3)), None),
    "late_kill": (dict(dead_queues=((3, 2),)), None),
    "out_of_range": (dict(dead_queues=(9,)), None),
    "kill_plus_flips": (dict(p_dra=0.25, p_tra=0.35, seed=5,
                             dead_queues=(2,)), None),
    "kill_corner_tmr": ("corner", "tmr"),
    "two_dead_corner_tmr": ("corner2", "tmr"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def models(spec):
    """(port, reference) fault models for a CASES entry."""
    if spec in ("corner", "corner2"):
        dead = (1,) if spec == "corner" else ((0, 1), 2)
        return (FaultModel.from_corner(0.15, source="paper", seed=0,
                                       dead_queues=dead),
                drim.FaultModel.from_corner(0.15, source="paper", seed=0,
                                            dead_queues=dead))
    return FaultModel(**spec), drim.FaultModel(**spec)


@pytest.fixture(scope="module")
def bnn_case():
    """Feeds of the K=4 dot, its oracle, and the reference's partitioned
    outputs and ChaosReport per case."""
    graph, _ = ref_carrysave(4)
    rng = np.random.default_rng(3)
    feeds = {n: (np.zeros(N_WORDS, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, N_WORDS, dtype=np.uint32))
             for n in graph.input_names}
    want = {}
    for name, (spec, harden) in CASES.items():
        low = drim.compile(graph, geom=REF_GEOM).lower(
            partition=True, n_queues=4, harden=harden, verify=False)
        out = low.run(feeds, faults=models(spec)[1])
        want[name] = ({k: np.asarray(v) for k, v in out.items()},
                      low.chaos_report, low.gp.n_stages)
    return feeds, graph_ref_results(graph, feeds), want


def lower(engine, harden=None):
    graph, _ = bnn_dot_graph_carrysave(4)
    return tcompile(graph, geom=GEOM).lower(engine, partition=True,
                                            n_queues=4, harden=harden)


def assert_words(outs, want):
    assert set(outs) == set(want)
    for name in want:
        np.testing.assert_array_equal(
            outs[name].numpy().view(np.uint32), want[name], err_msg=name)


def assert_report_matches(rep, rep_ref):
    if rep_ref is None:
        assert rep is None
        return
    got, want = dataclasses.asdict(rep), dataclasses.asdict(rep_ref)
    for key in TIMES:
        assert got.pop(key) >= 0.0
        want.pop(key)
    assert got == want
    assert rep.degraded == rep_ref.degraded
    assert rep.recovery_s > 0.0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_chaos_case_equals_reference(case, engine, bnn_case):
    feeds, oracle, want = bnn_case
    spec, harden = CASES[case]
    low = lower(engine, harden)
    outs = low.run(feeds, device="cpu", faults=models(spec)[0])
    ref_out, ref_rep, n_stages = want[case]
    assert low.gp.n_stages == n_stages
    assert_words(outs, ref_out)
    assert_report_matches(low.chaos_report, ref_rep)
    if "flips" not in case:
        assert_words(outs, oracle)


@pytest.mark.parametrize("engine", ENGINES)
def test_clean_partitioned_run_has_no_report(engine, bnn_case):
    feeds, oracle, _ = bnn_case
    low = lower(engine)
    assert_words(low.run(feeds, device="cpu"), oracle)
    assert low.chaos_report is None


@pytest.mark.parametrize("engine", ENGINES)
def test_stage0_and_mid_graph_reports(engine, bnn_case):
    """The reference suite's structural claims, on the port's reports."""
    feeds, _, _ = bnn_case
    low = lower(engine)
    low.run(feeds, device="cpu", faults=FaultModel(dead_queues=(2,)))
    rep = low.chaos_report
    assert rep.degraded and rep.dead_queues == (2,)
    assert rep.survivors == (0, 1, 3) and rep.detected_stages[0] == 0
    assert rep.requeued_segments >= 1
    assert rep.data_parallel == len(rep.survivors)
    assert low.gp.n_stages > 1
    low.run(feeds, device="cpu", faults=FaultModel(dead_queues=((0, 1),)))
    rep = low.chaos_report
    assert rep.dead_queues == (0,) and rep.survivors == (1, 2, 3)
    assert all(s >= 1 for s in rep.detected_stages)
    assert rep.requeued_segments == len(
        [s for s in low.gp.segments if s.part == 0 and s.stage >= 1])
    assert rep.death_stages == ((0, 1),)


@pytest.mark.parametrize("engine", ENGINES)
def test_all_queues_dead_raises(engine, bnn_case):
    feeds, _, _ = bnn_case
    with pytest.raises(RuntimeError, match="no survivor"):
        lower(engine).run(feeds, device="cpu",
                          faults=FaultModel(dead_queues=(0, 1, 2, 3)))


@pytest.mark.parametrize("engine", ENGINES)
def test_kill_plus_flips_deterministic(engine, bnn_case):
    """Dead queues and flips stack: the run repeats word for word, and
    the requeued segments' epoch salt keeps them off the survivor's
    flips (the outputs differ from the oracle)."""
    feeds, oracle, _ = bnn_case
    fm = FaultModel(p_dra=0.25, p_tra=0.35, seed=5, dead_queues=(2,))
    low = lower(engine)
    o1 = {k: v.clone() for k, v in low.run(feeds, device="cpu",
                                           faults=fm).items()}
    o2 = low.run(feeds, device="cpu", faults=fm)
    assert all(torch.equal(o1[k], o2[k]) for k in o1)
    corrupted = sum(int(np.unpackbits(
        (o1[n].numpy().view(np.uint32) ^ oracle[n]).view(np.uint8)).sum())
        for n in oracle)
    assert corrupted > 0


def test_progress_table_detects_silent_queues():
    for cls in (QueueProgressTable, RefProgressTable):
        t = cls(4)
        t.beat(0, 0)
        t.beat(3, 0)
        assert t.missing(0, {0, 1, 3}) == (1,)
        assert t.missing(0, {0, 3}) == ()
        assert t.missing(1, {2}) == (2,)
        t.beat(2, 1)
        assert t.missing(1, {2}) == ()
