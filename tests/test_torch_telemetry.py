"""The port's observability layer (`repro_torch.runtime.telemetry`) held
to the four contracts of the reference's `tests/test_telemetry.py` and
against the reference itself.

  * **Registry** -- the port's stats globals (`ENCODE_CACHE_STATS`,
    `LOWER_CACHE_STATS`, `VERIFY_STATS`) ARE registry namespaces,
    `snapshot()` / `delta()` are exact, and `fresh()` composes with the
    port's `fresh_encode_cache()`.
  * **Disarmed costs nothing** -- a disarmed lowering and run emit no
    event, and a process armed from birth (`DRIM_TELEMETRY=1`, no JAX
    imported) computes the words a disarmed one does.  Torch traces
    nothing, so this stands in for the reference's jaxpr-identity test.
  * **Armed runs are exact** -- partitioned and dead-queue runs give the
    oracle's words, and the ``chaos.*`` gauges and counter equal the
    `ChaosReport`.
  * **Perfetto schema** -- `export_trace` writes the reference's schema.

The differential core: `queue_timeline_events` of the port's and the
reference's lowerings of the same graph are equal event for event
(simulated-clock times to 1e-9 us, everything else exactly), and the
same sequence of lowerings and runs books the same registry counters in
both packages.  The reference's "wave_trace" namespace (jit traces of its
wave body) has no counterpart in the port, which traces nothing; it is
the one namespace left out of the comparison (ROADMAP Queue 3)."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import uuid

import numpy as np
import pytest
import torch

import drim
from repro.core import DrimGeometry as RefGeometry
from repro.pim import graph_ref_results
from repro.pim import compiler as ref_compiler
from repro.pim import scheduler as ref_scheduler
from repro.pim.bnn import bnn_dot_graph_carrysave as ref_carrysave
from repro.runtime import telemetry as ref_telemetry
from repro_torch.core import DrimGeometry, FaultModel
from repro_torch.pim import PASS_PIPELINE, compiler, scheduler, verify
from repro_torch.pim import compile as tcompile
from repro_torch.pim.bnn import bnn_dot_graph_carrysave
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import MetricsRegistry

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
N_WORDS = 32
# the namespaces both packages book; "wave_trace" is the reference's alone
COMPARED = ("encode_cache", "lower_cache", "drim.verify", "faults", "chaos")
LEFT_OUT = ("wave_trace",)
DEAD = {"bare": None, "stage0": (2,), "mid_graph": ((0, 1),)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def port_encode_cache():
    """The port's own empty encode memo and stats for one test, restored
    after (`tests/conftest.py`'s `encode_cache` wraps the reference's)."""
    with scheduler.fresh_encode_cache() as stats:
        yield stats


@pytest.fixture(autouse=True)
def disarmed_and_clear():
    """Every test starts disarmed with empty trace buffers in both
    packages, and leaves them so."""
    with telemetry.armed(False), ref_telemetry.armed(False):
        telemetry.clear_trace()
        ref_telemetry.clear_trace()
        yield
        telemetry.clear_trace()
        ref_telemetry.clear_trace()


def bnn_case(seed=7, k=4):
    """The K-input carry-save dot's graph in both packages, seeded feeds
    and the numpy oracle."""
    graph, _ = bnn_dot_graph_carrysave(k)
    ref_graph, _ = ref_carrysave(k)
    rng = np.random.default_rng(seed)
    feeds = {n: (np.zeros(N_WORDS, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, N_WORDS, dtype=np.uint32))
             for n in ref_graph.input_names}
    return graph, ref_graph, feeds, graph_ref_results(ref_graph, feeds)


def assert_exact(outs, ref):
    assert set(outs) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(
            outs[name].numpy().view(np.uint32),
            np.asarray(ref[name], np.uint32), err_msg=name)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_stats_globals_are_registry_namespaces():
    assert scheduler.ENCODE_CACHE_STATS is \
        telemetry.REGISTRY.counters("encode_cache")
    assert compiler.LOWER_CACHE_STATS is \
        telemetry.REGISTRY.counters("lower_cache")
    assert verify.VERIFY_STATS is telemetry.REGISTRY.counters("drim.verify")
    # the port's registry is its own, not the reference's
    assert telemetry.REGISTRY is not ref_telemetry.REGISTRY


def test_registry_snapshot_and_delta():
    r = MetricsRegistry()
    r.inc("cache.hits")
    r.gauge("fleet.alive", 8)
    r.observe("lat_s", 0.25)
    s0 = r.snapshot()
    assert s0["counters"] == {"cache.hits": 1}
    assert s0["gauges"] == {"fleet.alive": 8.0}
    assert s0["histograms"]["lat_s"] == {
        "count": 1, "min": 0.25, "max": 0.25, "mean": 0.25, "p50": 0.25,
        "p99": 0.25}
    r.inc("cache.hits", 2)
    r.inc("cache.misses")
    r.observe("lat_s", 0.75)
    d = r.delta(s0)
    assert d["counters"] == {"cache.hits": 2, "cache.misses": 1}
    assert d["gauges"] == {"fleet.alive": 8.0}
    assert d["histograms"] == {"lat_s": {"count": 1}}
    r.inc("plain")
    assert r.snapshot()["counters"]["default.plain"] == 1


def test_registry_matches_the_reference_registry():
    """The same mutations give the same snapshot and delta in both."""
    got, want = MetricsRegistry(), ref_telemetry.MetricsRegistry()
    snaps = []
    for r in (got, want):
        r.inc("a.x", 3)
        r.inc("b")
        r.gauge("g.h", 2.5)
        for v in (0.3, 0.1, 0.2, 0.9):
            r.observe("lat", v)
        s0 = r.snapshot()
        r.inc("a.x")
        r.observe("lat", 0.4)
        snaps.append((s0, r.snapshot(), r.delta(s0)))
    assert snaps[0] == snaps[1]


def test_registry_fresh_restores_in_place():
    r = MetricsRegistry()
    c = r.counters("ns")
    c["k"] = 2
    r.gauge("g", 1.5)
    r.observe("h", 0.1)
    before = r.snapshot()
    with r.fresh() as rr:
        assert rr is r
        assert r.counters("ns") is c
        assert not c
        c["k"] += 5
        r.gauge("g", 9.0)
        assert r.snapshot()["counters"] == {"ns.k": 5}
    assert r.counters("ns") is c
    assert r.snapshot() == before
    with r.fresh_namespace("ns") as cc:
        assert cc is c and not cc
        cc["other"] = 1
    assert r.snapshot() == before


def test_fresh_composes_with_fresh_encode_cache():
    stats = scheduler.ENCODE_CACHE_STATS
    pre = stats["hits"]
    stats["hits"] += 3
    try:
        with telemetry.fresh():
            assert stats["hits"] == 0
            with scheduler.fresh_encode_cache() as inner:
                assert inner is stats
                scheduler.encoded_program("xnor2")
                scheduler.encoded_program("xnor2")
                assert inner["misses"] == 1 and inner["hits"] == 1
            assert stats["hits"] == 0
        assert stats["hits"] == pre + 3
    finally:
        stats["hits"] -= 3


def test_port_fixture_gives_exact_cache_accounting(port_encode_cache):
    scheduler.encoded_program("maj3")
    scheduler.encoded_program("maj3", queue=1)
    assert dict(port_encode_cache) == {"misses": 1, "hits": 1, "q1:hits": 1}


def test_module_snapshot_carries_tracer_status():
    snap = telemetry.snapshot()
    assert snap["armed"] is False and snap["trace_events"] == 0
    assert {"counters", "gauges", "histograms"} <= set(snap)
    with telemetry.armed():
        with telemetry.span("x"):
            pass
        snap = telemetry.snapshot()
    assert snap["armed"] is True and snap["trace_events"] == 2


def test_heartbeat_report_sets_ft_gauges(tmp_path):
    from repro_torch.runtime.ft import HeartbeatMonitor
    hb = HeartbeatMonitor(str(tmp_path / "hb.jsonl"), 0, dead_after_s=10.0)
    hb.beat(0)
    hb.beat(1)
    with telemetry.fresh():
        stragglers, dead = hb.report(now=hb.table()[0].last_seen + 60.0)
        g = telemetry.REGISTRY.snapshot()["gauges"]
    assert (stragglers, dead) == ([], [0])
    assert g == {"ft.alive": 0.0, "ft.stragglers": 0.0, "ft.dead": 1.0}


# ---------------------------------------------------------------------------
# Disarmed: no event, the same words
# ---------------------------------------------------------------------------

def test_disarmed_span_is_the_shared_null_span():
    assert telemetry.span("a") is telemetry.span("b", cat="x", k=1)
    assert telemetry.span("a") is telemetry._NULL_SPAN
    telemetry.event("e")
    assert telemetry.trace_events() == []


def test_disarmed_pipeline_emits_no_events():
    graph, _, feeds, ref = bnn_case()
    low = tcompile("xnor2", geom=GEOM).lower("resident")
    a, b = scheduler.random_operands("xnor2", 64, seed=5)
    low.run(a, b, device="cpu")
    low = tcompile(graph, geom=GEOM).lower(partition=True, n_queues=4)
    assert_exact(low.run(feeds, device="cpu",
                         faults=FaultModel(dead_queues=(2,))), ref)
    assert telemetry.trace_events() == []


_SUBPROC = r"""
import json, os, sys
import numpy as np
from repro_torch.core import DrimGeometry
from repro_torch.pim import compile
from repro_torch.pim.bnn import bnn_dot_graph_carrysave
from repro_torch.runtime import telemetry

graph, _ = bnn_dot_graph_carrysave(4)
feeds = {n: np.asarray(v, np.uint32) for n, v in
         json.loads(os.environ["FEEDS"]).items()}
low = compile(graph, geom=DrimGeometry(chips=2, banks=4,
                                       subarrays_per_bank=8,
                                       row_bits=64)).lower(
    partition=True, n_queues=4)
outs = low.run(feeds, device="cpu")
names = sorted({e["name"] for e in telemetry.trace_events()
                if e["ph"] == "X"})
print(json.dumps({
    "armed": telemetry.enabled(),
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro", "drim")),
    "spans": names,
    "words": {k: v.numpy().view(np.uint32).tolist()
              for k, v in outs.items()}}))
"""


def test_import_armed_subprocess_gives_the_same_words():
    """A process armed from birth (`DRIM_TELEMETRY=1` before any import)
    and holding no JAX computes the words of a disarmed run here."""
    graph, _, feeds, _ = bnn_case(seed=3)
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": str(ROOT / "src"), "DRIM_TELEMETRY": "1",
           "FEEDS": json.dumps({k: v.tolist() for k, v in feeds.items()})}
    out = subprocess.run([sys.executable, "-c", _SUBPROC], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=str(ROOT))
    got = json.loads(out.stdout)
    assert got["armed"] is True and got["jax"] == []
    assert "Lowered.run" in got["spans"] and "lower" in got["spans"]
    low = tcompile(graph, geom=GEOM).lower(partition=True, n_queues=4)
    local = low.run(feeds, device="cpu")
    assert got["words"] == {k: v.numpy().view(np.uint32).tolist()
                            for k, v in local.items()}


# ---------------------------------------------------------------------------
# Armed runs are exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["queued", "cuda"])
def test_partitioned_run_bit_exact_armed(engine):
    graph, _, feeds, ref = bnn_case()
    low = tcompile(graph, geom=GEOM).lower(engine, partition=True,
                                           n_queues=4)
    assert_exact(low.run(feeds, device="cpu"), ref)
    with telemetry.armed(True):
        assert_exact(low.run(feeds, device="cpu"), ref)
        assert_exact(low.run(feeds, device="cpu",
                             faults=FaultModel(seed=0, dead_queues=(2,))),
                     ref)


@pytest.mark.parametrize("armed", [False, True])
def test_chaos_gauges_equal_the_report(armed):
    graph, _, feeds, ref = bnn_case(seed=11)
    low = tcompile(graph, geom=GEOM).lower(partition=True, n_queues=4)
    with telemetry.fresh(), telemetry.armed(armed):
        assert_exact(low.run(feeds, device="cpu",
                             faults=FaultModel(seed=0,
                                               dead_queues=((0, 1),))), ref)
        rep = low.chaos_report
        snap = telemetry.REGISTRY.snapshot()
    assert rep is not None and rep.compile_s > 0.0 and rep.recovery_s >= 0
    assert dict(rep.death_stages) == {0: 1}
    assert snap["gauges"] == {"chaos.compile_s": rep.compile_s,
                              "chaos.recovery_s": rep.recovery_s}
    assert snap["counters"]["chaos.requeued_segments"] == \
        rep.requeued_segments > 0
    requeues = [e for e in telemetry.trace_events()
                if e["name"] == "chaos:requeue"]
    assert len(requeues) == (len(rep.detected_stages) if armed else 0)


# ---------------------------------------------------------------------------
# Perfetto trace schema
# ---------------------------------------------------------------------------

def test_perfetto_trace_schema(tmp_path):
    graph, _, feeds, ref = bnn_case(seed=13)
    n_queues = 4
    with telemetry.armed(True):
        low = tcompile(graph, geom=GEOM).lower(partition=True,
                                               n_queues=n_queues)
        assert_exact(low.run(feeds, device="cpu"), ref)
        assert_exact(low.run(feeds, device="cpu",
                             faults=FaultModel(seed=0, dead_queues=(2,))),
                     ref)
        path = telemetry.export_trace(str(tmp_path / "trace.json"))

    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    assert doc["otherData"]["exporter"] == "repro_torch.runtime.telemetry"
    assert "counters" in doc["otherData"]["registry"]
    for e in evs:
        assert e["ph"] in ("X", "i", "M"), e
        if e["ph"] == "X":
            assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
            assert e["dur"] >= 0.0
        if e["ph"] == "i":
            assert e["s"] in ("t", "p")

    names = [e["name"] for e in evs if e["ph"] == "X"]
    cats = {e.get("cat") for e in evs if e["ph"] != "M"}
    passes = [n for n in names if n.startswith("pass:")]
    assert passes == [f"pass:{p.name}" for p in PASS_PIPELINE]
    lower = next(e for e in evs if e["ph"] == "X" and e["name"] == "lower")
    for e in evs:
        if e["ph"] == "X" and e["name"].startswith("pass:"):
            assert e["pid"] == lower["pid"] and e["tid"] == lower["tid"]
            assert e["ts"] >= lower["ts"] - 1e-6
            assert e["ts"] + e["dur"] <= lower["ts"] + lower["dur"] + 1e-6
    assert names.count("Lowered.run") == 2

    sim_pids = {e["pid"] for e in evs
                if e["ph"] == "M" and e["name"] == "process_name"
                and e["args"]["name"].startswith("drim-sim")}
    assert len(sim_pids) == 2          # clean run + chaos run
    for pid in sim_pids:
        tracks = [e for e in evs if e["ph"] == "M"
                  and e["name"] == "thread_name" and e["pid"] == pid]
        assert len(tracks) == n_queues
        assert all(e["args"]["name"].startswith("queue ") for e in tracks)
        assert any(e.get("cat") == "fence" and e["pid"] == pid for e in evs)
        assert any(e.get("cat") == "aap-stream" and e["pid"] == pid
                   for e in evs)
    assert "bus-contention" in cats
    dead = [e for e in evs if e.get("cat") == "chaos"
            and e["name"].endswith("DEAD")]
    assert len(dead) == 1 and dead[0]["args"]["queue"] == 2
    assert any(e.get("cat") == "chaos-requeue" for e in evs)
    assert any(e["name"] == "chaos:requeue" for e in evs)


def test_export_trace_with_explicit_timeline(tmp_path):
    low = tcompile("maj3", geom=GEOM).lower("queued", n_queues=2)
    sched = low.cost(GEOM.row_bits * GEOM.n_subarrays)
    evs = telemetry.queue_timeline_events(sched, label="maj3")
    tracks = [e for e in evs if e["ph"] == "M" and e["name"] == "thread_name"]
    assert len(tracks) == sched.n_queues
    assert any(e["ph"] == "X" and e.get("cat") == "aap-stream" for e in evs)
    assert any(e.get("cat") == "fence" for e in evs)
    path = telemetry.export_trace(str(tmp_path / "queued.json"),
                                  extra_events=evs)
    with open(path) as f:
        doc = json.load(f)
    assert any(e.get("args", {}).get("name", "").startswith("drim-sim")
               for e in doc["traceEvents"] if e["ph"] == "M")


def test_record_queue_timeline_skips_schedules_without_queues():
    low = tcompile("xnor2", geom=GEOM).lower("resident")
    a, b = scheduler.random_operands("xnor2", 64, seed=1)
    low.run(a, b, device="cpu")
    assert telemetry.record_queue_timeline(low) == 0
    assert telemetry.trace_events() == []


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def assert_events_equal(got, want):
    """Event for event: simulated-clock ts/dur to 1e-9 us, the rest
    exactly."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = dict(g), dict(w)
        for key in ("ts", "dur"):
            assert (key in g) == (key in w), (i, g, w)
            if key in w:
                assert abs(g.pop(key) - w.pop(key)) <= 1e-9, (i, key)
        assert g == w, i


@pytest.mark.parametrize("dead", sorted(DEAD))
@pytest.mark.parametrize("k", [4, 8])
def test_queue_timeline_equals_reference(k, dead):
    graph, ref_graph, feeds, ref = bnn_case(seed=17, k=k)
    kill = DEAD[dead]
    fm = FaultModel(dead_queues=kill) if kill else None
    ref_fm = drim.FaultModel(dead_queues=kill) if kill else None
    low = tcompile(graph, geom=GEOM).lower(partition=True, n_queues=4)
    assert_exact(low.run(feeds, device="cpu", faults=fm), ref)
    ref_low = drim.compile(ref_graph, geom=REF_GEOM).lower(
        partition=True, n_queues=4, verify=False)
    ref_low.run(feeds, faults=ref_fm)
    assert (low.chaos_report is None) == (kill is None)
    label = f"K={k} {dead}"
    got = telemetry.queue_timeline_events(
        low.schedule, gp=low.gp, chaos=low.chaos_report, label=label)
    want = ref_telemetry.queue_timeline_events(
        ref_low.schedule, gp=ref_low.gp, chaos=ref_low.chaos_report,
        label=label)
    assert_events_equal(got, want)
    if kill:
        assert any(e["name"].endswith("DEAD") for e in got)
        assert any(e.get("cat") == "chaos-requeue" for e in got)


def test_uniform_queued_timeline_equals_reference():
    n_bits = GEOM.row_bits * GEOM.n_subarrays
    sched = tcompile("maj3", geom=GEOM).lower("queued",
                                              n_queues=2).cost(n_bits)
    ref_sched = drim.compile("maj3", geom=REF_GEOM).lower(
        "queued", n_queues=2, verify=False).cost(n_bits)
    assert_events_equal(
        telemetry.queue_timeline_events(sched, label="maj3", origin_us=5.0),
        ref_telemetry.queue_timeline_events(ref_sched, label="maj3",
                                            origin_us=5.0))


def run_sequence(pkg, compile_fn, lower_cached, graph, feeds, fm_of, tag):
    """One sequence of lowerings and runs on a package's engines ("cuda"
    is the port's counterpart of the reference's "pallas"; the reference
    runs on its default device, the port on the CPU)."""
    kw = {"device": "cpu"} if pkg == "port" else {}
    kernel_engine = "cuda" if pkg == "port" else "pallas"
    a, b, c = ref_scheduler.random_operands("maj3", 48, seed=9)
    hot = fm_of(p_dra=0.25, p_tra=0.35, seed=tag)
    for _ in range(2):
        compile_fn("xnor2", geom=GEOM if pkg == "port" else REF_GEOM) \
            .lower("resident").run(a, b, **kw)
        for engine in ("resident", "baseline", kernel_engine):
            low = lower_cached(graph, key=("telemetry", tag, engine),
                               geom=GEOM if pkg == "port" else REF_GEOM,
                               engine=engine)
            low.run(feeds, faults=hot, **kw)
            low.run(feeds, **kw)
        lower_cached("maj3", key=("telemetry", tag, "maj3"),
                     geom=GEOM if pkg == "port" else REF_GEOM,
                     engine="queued", n_queues=2).run(a, b, c, **kw)
    geom = GEOM if pkg == "port" else REF_GEOM
    low = compile_fn(graph, geom=geom).lower(partition=True, n_queues=4,
                                             harden="tmr")
    low.run(feeds, faults=fm_of(p_dra=0.25, p_tra=0.35, seed=tag,
                                dead_queues=(2,)), **kw)
    low = compile_fn(graph, geom=geom).lower(partition=True, n_queues=4)
    low.run(feeds, faults=fm_of(dead_queues=((0, 1),)), **kw)
    return low


def test_registry_counters_equal_reference():
    """The same lowerings and runs, each package inside its own `fresh()`
    and a fresh encode memo, book the same counters in every compared
    namespace (the reference's "pallas" engine named "cuda"); the faults
    census is booked once per faulted wave-runner build, and the chaos
    counter sums both kills' requeues."""
    graph, ref_graph, feeds, _ = bnn_case(seed=19)
    tag = uuid.uuid4().int & 0xFFFFFFFF      # a build key no run has used
    with telemetry.fresh(), scheduler.fresh_encode_cache():
        run_sequence("port", tcompile, compiler.lower_cached, graph, feeds,
                     FaultModel, tag)
        got = telemetry.REGISTRY.snapshot()
    with ref_telemetry.fresh(), ref_scheduler.fresh_encode_cache():
        run_sequence("ref", drim.compile, ref_compiler.lower_cached,
                     ref_graph, feeds, drim.FaultModel, tag)
        want = ref_telemetry.REGISTRY.snapshot()

    def part(snap, ns):
        return {k.replace(".pallas:", ".cuda:"): v
                for k, v in snap["counters"].items()
                if k.rsplit(".", 1)[0] == ns}

    for ns in COMPARED:
        assert part(got, ns) == part(want, ns), ns
    assert {k.split(":")[0] for k in part(got, "faults")} == {
        "faults.resident", "faults.baseline", "faults.cuda"}
    assert part(got, "chaos")
    assert part(got, "lower_cache") == {"lower_cache.hits": 4,
                                        "lower_cache.misses": 4}
    assert set(got["gauges"]) == set(want["gauges"]) == {
        "chaos.compile_s", "chaos.recovery_s"}
    for ns in LEFT_OUT:
        assert part(want, ns) and not part(got, ns)
    assert {k.rsplit(".", 1)[0] for k in got["counters"]} <= set(COMPARED)


def test_fault_census_booked_once_per_build():
    graph, _, feeds, _ = bnn_case()
    fm = FaultModel(p_dra=0.25, p_tra=0.35,
                    seed=uuid.uuid4().int & 0xFFFFFFFF)
    low = tcompile(graph, geom=GEOM).lower("resident")
    with telemetry.fresh():
        low.run(feeds, device="cpu", faults=fm)
        once = dict(telemetry.REGISTRY.counters("faults"))
        low.run(feeds, device="cpu", faults=fm)
        assert dict(telemetry.REGISTRY.counters("faults")) == once
    census = fm.count_faultable(low.fp.program)
    assert once == {f"resident:armed_{k}": n for k, n in census.items()
                    if n}


def test_port_telemetry_imports_no_jax():
    code = ("import sys, repro_torch.runtime.telemetry as t; "
            "t.queue_timeline_events; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'drim')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_armed_dataclass_report_fields_unchanged():
    """Arming changes no ChaosReport field but the two host times."""
    graph, _, feeds, ref = bnn_case(seed=23)
    low = tcompile(graph, geom=GEOM).lower("cuda", partition=True,
                                           n_queues=4)
    reps = []
    for on in (False, True):
        with telemetry.armed(on):
            assert_exact(low.run(feeds, device="cpu",
                                 faults=FaultModel(dead_queues=(1, 3))), ref)
        rep = dataclasses.asdict(low.chaos_report)
        rep.pop("recovery_s"), rep.pop("compile_s")
        reps.append(rep)
    assert reps[0] == reps[1]
