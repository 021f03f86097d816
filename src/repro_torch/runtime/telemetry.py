"""Unified DRIM observability: metrics registry, span tracing, and
simulated-clock Perfetto timelines (port of `repro.runtime.telemetry`:
host-only Python, the reference's logic as it is).

Three parts:

  * **Metrics registry** -- namespaced counters / gauges / histograms
    with ``snapshot()`` / ``delta()`` and an in-place ``fresh()``
    context.  The pipeline's stats globals are aliases of registry
    namespaces (the very same ``collections.Counter`` objects):
    ``ENCODE_CACHE_STATS`` in `pim.scheduler` is "encode_cache",
    ``LOWER_CACHE_STATS`` in `pim.compiler` is "lower_cache" and
    ``VERIFY_STATS`` in `pim.verify` is "drim.verify"; beside them the
    armed fault sites per engine ("faults"), chaos recovery ("chaos"
    counter, ``chaos.*`` gauges), heartbeat liveness (``ft.*`` gauges)
    and serving incidents ("serve").  One ``snapshot()`` sees all of it.

  * **Span tracing** -- wall-clock spans over the HOST-side pipeline
    (compiler passes, ``Lowered.run`` stage/dispatch/readback, the
    serve decode loop and batcher waves), exported as Chrome-trace /
    Perfetto JSON via ``export_trace(path)``.  Spans read the host's
    clock and never wait for the device: on a CUDA card a span closes
    when its launches are queued, not when they finish.  Tracing is
    DISARMED by default: a disarmed call site costs one branch and
    touches no tensor, so a run computes the same words, and launches
    the same kernels, armed or not.

  * **Simulated-clock timelines** -- ``queue_timeline_events`` renders
    a ``QueueSchedule`` (+ ``GraphPartition`` + ``ChaosReport``) onto
    per-bank-queue Perfetto tracks on the shared DDR command clock:
    AAP segment spans, fence-stage barriers, bus-contention stall
    slices measured by `core.isa.simulate_bus_issue`, and dead-queue /
    requeue chaos events.

Nothing here imports torch or the pim layer at module scope, so the
registry is safe to import from anywhere in the port (the timeline
renderer pulls `repro_torch.core` lazily).

Arming: ``telemetry.arm()`` / ``disarm()`` / the ``armed()`` context,
or set ``DRIM_TELEMETRY=1`` in the environment before import.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "MetricsRegistry", "REGISTRY", "arm", "disarm", "enabled", "armed",
    "counters", "inc", "gauge", "observe", "snapshot", "delta", "fresh",
    "span", "event", "clear_trace", "trace_events", "export_trace",
    "queue_timeline_events", "record_queue_timeline",
    "HOST_PID", "SIM_PID",
]


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def _hist_summary(values: List[float]) -> Dict[str, float]:
    n = len(values)
    if not n:
        return {"count": 0}
    s = sorted(values)

    def pct(p: float) -> float:
        return s[min(n - 1, int(p * n))]

    return {"count": n, "min": s[0], "max": s[-1],
            "mean": sum(s) / n, "p50": pct(0.50), "p99": pct(0.99)}


class MetricsRegistry:
    """Namespaced counters, gauges and histograms with exact
    save/restore semantics.

    ``counters(ns)`` returns THE ``collections.Counter`` backing a
    namespace -- identity-stable for the life of the registry, so a
    module can hold it as a global alias (`scheduler.ENCODE_CACHE_STATS`
    does exactly this) and every mutation is immediately visible to
    ``snapshot()``.  ``fresh()`` / ``fresh_namespace()`` clear and
    restore IN PLACE, never swapping objects, so aliases stay live
    across the context -- which is what lets `fresh_encode_cache` and a
    surrounding ``telemetry.fresh()`` compose instead of fighting over
    two separate save/restore stacks.
    """

    def __init__(self) -> None:
        self._counters: Dict[str, collections.Counter] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    # -- mutation ----------------------------------------------------------
    def counters(self, namespace: str) -> collections.Counter:
        """Create-or-get the Counter backing `namespace` (identity-
        stable; safe to alias as a module global)."""
        c = self._counters.get(namespace)
        if c is None:
            c = self._counters[namespace] = collections.Counter()
        return c

    def inc(self, name: str, n: int = 1) -> None:
        """Increment ``"namespace.key"`` by `n`."""
        ns, _, key = name.rpartition(".")
        self.counters(ns or "default")[key or name] += n

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._hists.setdefault(name, []).append(float(value))

    # -- read-out ----------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Flat JSON-safe view: ``counters["ns.key"]``, ``gauges`` and
        histogram summaries (count/min/max/mean/p50/p99)."""
        return {
            "counters": {f"{ns}.{k}": int(v)
                         for ns, c in sorted(self._counters.items())
                         for k, v in sorted(c.items())},
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {k: _hist_summary(v)
                           for k, v in sorted(self._hists.items())},
        }

    def delta(self, prev: Dict[str, Any]) -> Dict[str, Any]:
        """What changed since a prior ``snapshot()``: counters are
        diffed (zero-diff keys dropped), gauges report their current
        value, histograms the observation-count delta."""
        cur = self.snapshot()
        prev_c = prev.get("counters", {})
        prev_h = prev.get("histograms", {})
        return {
            "counters": {k: v - prev_c.get(k, 0)
                         for k, v in cur["counters"].items()
                         if v - prev_c.get(k, 0)},
            "gauges": cur["gauges"],
            "histograms": {
                k: {"count": s["count"]
                    - prev_h.get(k, {}).get("count", 0)}
                for k, s in cur["histograms"].items()
                if s["count"] - prev_h.get(k, {}).get("count", 0)},
        }

    # -- scoped state ------------------------------------------------------
    @contextlib.contextmanager
    def fresh(self):
        """Run a block against an EMPTY registry, then restore every
        namespace in place (object identities preserved).  Yields the
        registry."""
        saved_c = {ns: dict(c) for ns, c in self._counters.items()}
        saved_g = dict(self._gauges)
        saved_h = {k: list(v) for k, v in self._hists.items()}
        for c in self._counters.values():
            c.clear()
        self._gauges.clear()
        self._hists.clear()
        try:
            yield self
        finally:
            for ns, c in self._counters.items():
                c.clear()
                c.update(saved_c.get(ns, {}))
            self._gauges.clear()
            self._gauges.update(saved_g)
            self._hists.clear()
            self._hists.update(saved_h)

    @contextlib.contextmanager
    def fresh_namespace(self, namespace: str):
        """``fresh()`` scoped to one counter namespace; yields its
        (cleared, identity-stable) Counter."""
        c = self.counters(namespace)
        saved = dict(c)
        c.clear()
        try:
            yield c
        finally:
            c.clear()
            c.update(saved)


REGISTRY = MetricsRegistry()

# Module-level conveniences over the process registry.
counters = REGISTRY.counters
inc = REGISTRY.inc
gauge = REGISTRY.gauge
observe = REGISTRY.observe
delta = REGISTRY.delta
fresh = REGISTRY.fresh


def snapshot() -> Dict[str, Any]:
    """Registry snapshot plus tracer status: the ``"telemetry"`` blob
    `launch.serve` folds into its stats record."""
    out = REGISTRY.snapshot()
    out["armed"] = enabled()
    out["trace_events"] = len(_EVENTS)
    return out


# ---------------------------------------------------------------------------
# Span tracing (host wall-clock, Chrome trace format)
# ---------------------------------------------------------------------------

HOST_PID = 1          # wall-clock spans (compiler, runs, serving)
SIM_PID = 2           # simulated-DDR-clock queue timelines

_ARMED = os.environ.get("DRIM_TELEMETRY", "0") not in ("", "0")
_EPOCH = time.perf_counter()
_EVENTS: List[dict] = []
_TIDS: Dict[Tuple[int, str], int] = {}


def enabled() -> bool:
    """True when span tracing is armed.  Call sites on hot paths gate
    on this single branch; everything else (metrics counters) is
    always on."""
    return _ARMED


def arm() -> None:
    global _ARMED
    _ARMED = True


def disarm() -> None:
    global _ARMED
    _ARMED = False


@contextlib.contextmanager
def armed(on: bool = True):
    """Scoped arm/disarm (tests and examples)."""
    global _ARMED
    prev, _ARMED = _ARMED, bool(on)
    try:
        yield
    finally:
        _ARMED = prev


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def _tid(pid: int, name: str) -> int:
    """Stable small tid per (pid, track name), emitting the Perfetto
    thread_name metadata record on first use."""
    key = (pid, name)
    t = _TIDS.get(key)
    if t is None:
        t = _TIDS[key] = len([k for k in _TIDS if k[0] == pid]) + 1
        _EVENTS.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": t, "args": {"name": name}})
    return t


class _Span:
    __slots__ = ("_name", "_cat", "_tid", "_args", "_t0")

    def __init__(self, name, cat, tid, args):
        self._name, self._cat, self._tid, self._args = name, cat, tid, args

    def set(self, **args):
        """Attach args discovered mid-span (visible in the trace)."""
        self._args.update(args)
        return self

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        _EVENTS.append({"name": self._name, "cat": self._cat, "ph": "X",
                        "ts": self._t0, "dur": _now_us() - self._t0,
                        "pid": HOST_PID, "tid": _tid(HOST_PID, self._tid),
                        "args": self._args})
        return False


class _NullSpan:
    __slots__ = ()

    def set(self, **args):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def span(name: str, *, cat: str = "host", tid: str = "main",
         **args: Any):
    """Wall-clock span context on the host's clock (it never waits for
    the device).  Disarmed: returns the shared no-op context (one
    branch, no allocation beyond the call itself)."""
    if not _ARMED:
        return _NULL_SPAN
    return _Span(name, cat, tid, args)


def event(name: str, *, cat: str = "host", tid: str = "main",
          pid: int = HOST_PID, ts: Optional[float] = None,
          scope: str = "t", **args: Any) -> None:
    """Instant event (armed only)."""
    if not _ARMED:
        return
    _EVENTS.append({"name": name, "cat": cat, "ph": "i", "s": scope,
                    "ts": _now_us() if ts is None else ts, "pid": pid,
                    "tid": _tid(pid, tid), "args": args})


def clear_trace() -> None:
    _EVENTS.clear()
    _TIDS.clear()
    _SIM_SEQ[0] = 0


def trace_events() -> List[dict]:
    """The live event buffer (read-only by convention)."""
    return _EVENTS


def export_trace(path: str, *, extra_events: Iterable[dict] = ()) -> str:
    """Write the buffered spans/timelines as Chrome-trace JSON, openable
    in Perfetto (https://ui.perfetto.dev) or chrome://tracing.  Returns
    `path`."""
    events = ([{"ph": "M", "name": "process_name", "pid": HOST_PID,
                "args": {"name": "drim-host"}}]
              + list(_EVENTS) + list(extra_events))
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"exporter": "repro_torch.runtime.telemetry",
                         "registry": REGISTRY.snapshot()}}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# Simulated-clock queue timelines (QueueSchedule -> Perfetto tracks)
# ---------------------------------------------------------------------------

def _queue_track(q: int, banks_per_queue: int) -> str:
    lo = q * banks_per_queue
    return f"queue {q} [banks {lo}-{lo + banks_per_queue - 1}]"


def queue_timeline_events(sched, *, gp=None, chaos=None,
                          origin_us: float = 0.0,
                          label: str = "",
                          pid: int = SIM_PID) -> List[dict]:
    """Render one tile's pass through a ``QueueSchedule`` onto per-bank-
    queue Perfetto tracks on the simulated DDR command clock.

    Every queue gets its own track (``sched.n_queues`` tracks total).
    Per fence stage: an AAP span per active queue (its segment stream,
    back-to-back on the bank), a ``stall`` slice where the shared
    command bus made the queue wait for issue slots (measured by
    re-running `isa.simulate_bus_issue` on the stage's concurrent
    streams -- the same model `QueueSchedule.contention_stall_aaps`
    prices), and a process-scoped ``fence`` instant where the stage
    barrier retires.  With a ``GraphPartition`` the spans carry segment
    node ids; with a ``ChaosReport`` dead queues get a ``DEAD`` instant
    at their death stage and their orphaned segments re-render on the
    adopting survivor's track as ``requeue:*`` spans after the fence
    (matching the executor's recovery dispatch order).

    Timestamps are µs of SIMULATED time: one command-bus slot is
    ``t_aap_s / CMD_SLOTS_PER_AAP`` seconds.  Returns plain Chrome-
    trace event dicts under `pid` (default ``SIM_PID``; the auto-record
    path gives every recorded run its own pid so repeated runs do not
    overlap on shared tracks); the caller appends them to a trace
    buffer or hands them to ``export_trace(extra_events=...)``.
    """
    from repro_torch.core.isa import simulate_bus_issue
    from repro_torch.core.timing import CMD_SLOTS_PER_AAP

    nq = int(getattr(sched, "n_queues", 1))
    slot_us = sched.t_aap_s / CMD_SLOTS_PER_AAP * 1e6
    pfx = f"{label}:" if label else ""
    events: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": f"drim-sim {label}".strip()}}]
    tids: Dict[int, int] = {}

    def tid_of(q: int) -> int:
        t = tids.get(q)
        if t is None:
            t = tids[q] = q + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": t,
                "args": {"name": _queue_track(
                    q, getattr(sched, "banks_per_queue", 0) or 1)}})
        return t

    for q in range(nq):
        tid_of(q)

    def emit(q: int, name: str, start_slots: float, dur_slots: float,
             cat: str, **args) -> None:
        events.append({
            "name": name, "cat": cat, "ph": "X",
            "ts": origin_us + start_slots * slot_us,
            "dur": max(dur_slots * slot_us, 0.0),
            "pid": pid, "tid": tid_of(q), "args": args})

    def run_stage(stage: int, lens: Dict[int, int], names: Dict[int, str],
                  t0_slots: float, cat: str) -> float:
        """One concurrent issue round: AAP spans + stall slices; returns
        the barrier time (slots)."""
        active = [(q, n) for q, n in sorted(lens.items()) if n > 0]
        if not active:
            return t0_slots
        makespan, finish = simulate_bus_issue(
            [n for _, n in active], slots_per_aap=CMD_SLOTS_PER_AAP)
        for (q, n), fin in zip(active, finish):
            busy = n * CMD_SLOTS_PER_AAP
            emit(q, names[q], t0_slots, busy, cat,
                 stage=stage, aaps=n)
            if fin > busy:
                emit(q, f"{pfx}stall", t0_slots + busy, fin - busy,
                     "bus-contention", stage=stage,
                     stall_slots=fin - busy)
        return t0_slots + makespan

    # death_stages: queue -> first dead fence stage (chaos only)
    death: Dict[int, int] = {}
    if chaos is not None:
        death = {q: s for q, s in getattr(chaos, "death_stages", ())}
        for q in getattr(chaos, "dead_queues", ()):
            death.setdefault(q, 0)

    t = 0.0
    if gp is not None:
        survivors = [q for q in range(nq) if q not in death]
        for stage in range(gp.n_stages):
            segs = [s for s in gp.segments if s.stage == stage]
            healthy = {s.part: s for s in segs
                       if death.get(s.part, gp.n_stages) > stage}
            orphans = [s for s in segs
                       if death.get(s.part, gp.n_stages) <= stage]
            for q, s in sorted(death.items()):
                if s == stage:
                    events.append({
                        "name": f"{pfx}DEAD", "cat": "chaos", "ph": "i",
                        "s": "t", "ts": origin_us + t * slot_us,
                        "pid": pid, "tid": tid_of(q),
                        "args": {"queue": q, "stage": stage}})
            t = run_stage(
                stage,
                {q: s.fp.aaps_per_tile for q, s in healthy.items()},
                {q: f"{pfx}seg[s{stage}] nodes={list(s.node_ids)}"
                 for q, s in healthy.items()},
                t, "aap-stream")
            if orphans and survivors:
                # recovery dispatch: orphans adopted round-robin on the
                # survivor fleet AFTER the fence found the gap
                lens: Dict[int, int] = {}
                names: Dict[int, str] = {}
                for i, s in enumerate(orphans):
                    q = survivors[i % len(survivors)]
                    lens[q] = lens.get(q, 0) + s.fp.aaps_per_tile
                    names[q] = (f"{pfx}requeue:q{s.part}"
                                f"[s{stage}] nodes={list(s.node_ids)}")
                t = run_stage(stage, lens, names, t, "chaos-requeue")
            events.append({
                "name": f"{pfx}fence {stage}", "cat": "fence",
                "ph": "i", "s": "p", "ts": origin_us + t * slot_us,
                "pid": pid, "tid": tid_of(0),
                "args": {"stage": stage}})
    else:
        lens = {q: a for q, a in
                enumerate(getattr(sched, "queue_aaps_per_tile",
                                  (sched.aaps_per_tile,) * nq))}
        t = run_stage(0, lens,
                      {q: f"{pfx}{sched.op}" for q in lens}, t,
                      "aap-stream")
        events.append({
            "name": f"{pfx}fence 0", "cat": "fence", "ph": "i",
            "s": "p", "ts": origin_us + t * slot_us, "pid": pid,
            "tid": tid_of(0), "args": {"stage": 0}})
    return events


_SIM_SEQ = [0]


def record_queue_timeline(lowered, *, label: str = "") -> int:
    """Append a lowering's last measured ``QueueSchedule`` timeline
    (plus its partition and chaos report, if any) to the trace buffer;
    returns the number of events added.  Each recorded run gets its own
    Perfetto process (``SIM_PID + seq``) so repeated runs sit side by
    side instead of overlapping on shared tracks.  A lowering without a
    queue schedule records nothing."""
    sched = getattr(lowered, "schedule", None) or lowered
    if not hasattr(sched, "queue_aaps_per_tile"):
        return 0
    _SIM_SEQ[0] += 1
    run_label = label or getattr(sched, "op", "")
    evs = queue_timeline_events(
        sched, gp=getattr(lowered, "gp", None),
        chaos=getattr(lowered, "chaos_report", None),
        label=f"{run_label}#{_SIM_SEQ[0]}",
        pid=SIM_PID + _SIM_SEQ[0] - 1)
    _EVENTS.extend(evs)
    return len(evs)
