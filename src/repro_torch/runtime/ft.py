"""Fault tolerance, straggler mitigation, elastic scaling (port of
`repro.runtime.ft`: host-only Python, the reference's logic as it is).

Designed for 1000+-node fleets; here the mechanisms are exercised by
unit tests and the trainer, which beats the heartbeat every step: in one
process as host 0, under torchrun each rank as host = its rank, all into
one file, so that `table()` sees every rank.  `HeartbeatMonitor.report`
publishes liveness as telemetry gauges (`ft.alive`, `ft.stragglers`,
`ft.dead`).

  * Heartbeats  : every host appends (host, step, t) to a shared file/KV;
                  the coordinator flags hosts > `straggler_factor` x median
                  step latency (straggler) or silent past `dead_after_s`
                  (failed).
  * Restart     : `run_with_restarts` reruns a training loop that
                  restores the latest atomic checkpoint after any crash
                  (checkpoint/checkpoint.py); checkpoint-restart is the
                  baseline failure model.
  * Elastic     : `elastic_plan` recomputes (mesh, per-host batch) for the
                  surviving host set; because checkpoints are host-gathered
                  and data order is (seed, step)-deterministic, a resize is
                  a restore onto a new mesh, not a new run.
  * Stragglers  : gradient-accumulation microbatching (steps.py accum>1)
                  smooths per-step variance; the monitor only *reports*
                  hosts — eviction is the scheduler's call.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.runtime import telemetry


@dataclasses.dataclass
class HostStatus:
    host_id: int
    last_step: int
    last_seen: float
    step_latency: float


class HeartbeatMonitor:
    """File-backed heartbeat table (stands in for the fleet KV store)."""

    def __init__(self, path: str, host_id: int,
                 straggler_factor: float = 2.0, dead_after_s: float = 60.0):
        self.path = path
        self.host_id = host_id
        self.straggler_factor = straggler_factor
        self.dead_after_s = dead_after_s
        # None until the first beat: construction time is NOT a step
        # boundary, so the first record must not report the (arbitrary)
        # construct-to-beat gap as a step latency — a slow-to-start
        # host would look like a straggler before running a step.
        self._last_beat: Optional[float] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int) -> None:
        now = time.time()
        lat = 0.0 if self._last_beat is None else now - self._last_beat
        rec = {"host": self.host_id, "step": step, "t": now, "lat": lat}
        self._last_beat = now
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def table(self) -> Dict[int, HostStatus]:
        out: Dict[int, HostStatus] = {}
        if not os.path.exists(self.path):
            return out
        for line in open(self.path):
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write from a dying host
            out[r["host"]] = HostStatus(r["host"], r["step"], r["t"],
                                        r.get("lat", 0.0))
        return out

    def report(self, now: Optional[float] = None
               ) -> Tuple[List[int], List[int]]:
        """-> (straggler host ids, dead host ids).  Liveness also lands
        as telemetry gauges (``ft.alive`` / ``ft.stragglers`` /
        ``ft.dead``), so fleet health rides every registry snapshot."""
        now = now or time.time()
        tab = self.table()
        if not tab:
            return [], []
        lats = sorted(h.step_latency for h in tab.values()
                      if h.step_latency > 0)
        med = lats[len(lats) // 2] if lats else 0.0
        stragglers = [h.host_id for h in tab.values()
                      if med and h.step_latency > self.straggler_factor * med]
        dead = [h.host_id for h in tab.values()
                if now - h.last_seen > self.dead_after_s]
        telemetry.gauge("ft.alive", len(tab) - len(dead))
        telemetry.gauge("ft.stragglers", len(stragglers))
        telemetry.gauge("ft.dead", len(dead))
        return stragglers, dead

    def prune(self, now: Optional[float] = None) -> List[int]:
        """Drop dead hosts' records from the table file (atomic rewrite,
        same tmp+rename discipline as checkpoint.py) so a long-running
        coordinator is not forever re-reading beats of evicted hosts.
        Returns the pruned host ids."""
        _, dead = self.report(now)
        if not dead or not os.path.exists(self.path):
            return []
        gone = set(dead)
        kept = []
        for line in open(self.path):
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write — drop it with the dead
            if r["host"] not in gone:
                kept.append(line)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(kept)
        os.replace(tmp, self.path)
        return sorted(gone)


def elastic_plan(n_alive_hosts: int, devices_per_host: int,
                 global_batch: int, model_parallel: int = 16
                 ) -> Dict[str, int]:
    """Largest (data, model) mesh the surviving fleet supports.

    model_parallel is held fixed (param shards must fit); the data axis
    shrinks to the largest divisor of the alive device count, and the
    per-host batch grows to keep the global batch constant.

    The global batch must split evenly over the survivors: silently
    flooring `global_batch / n_alive_hosts` (the old behavior) would
    shrink the effective batch and quietly change training semantics
    after every resize — exactly the class of bug an elastic restore
    must never introduce.
    """
    if n_alive_hosts < 1 or devices_per_host < 1:
        raise ValueError("need at least one alive host with one device")
    n_dev = n_alive_hosts * devices_per_host
    if n_dev % model_parallel:
        raise ValueError(f"{n_dev} devices not divisible by TP="
                         f"{model_parallel}")
    if global_batch % n_alive_hosts:
        fit = max(d for d in range(1, n_alive_hosts + 1)
                  if global_batch % d == 0)
        raise ValueError(
            f"global batch {global_batch} does not split over "
            f"{n_alive_hosts} hosts; flooring would drop "
            f"{global_batch % n_alive_hosts} samples per step — resize "
            f"the fleet to {fit} hosts or repad the batch")
    data = n_dev // model_parallel
    while global_batch % data:
        data -= 1  # shrink until the batch divides (keeps step semantics)
    return {"data": data, "model": model_parallel,
            "per_host_batch": global_batch // n_alive_hosts}


def run_with_restarts(train_once: Callable[[Optional[int]], int],
                      max_restarts: int = 3) -> int:
    """Checkpoint-restart driver: train_once(start_step) runs until crash
    or completion, returning the last completed step."""
    restarts, last = 0, None
    while True:
        try:
            return train_once(last)
        except Exception:  # noqa: BLE001 — any host failure
            restarts += 1
            if restarts > max_restarts:
                raise
            last = None  # force restore-from-latest inside train_once
