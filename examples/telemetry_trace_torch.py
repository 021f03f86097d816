"""Observability walkthrough on PyTorch and one CUDA card (the torch twin
of `examples/telemetry_trace.py`): trace the K=4 carry-save BNN dot.

    PYTHONPATH=src python examples/telemetry_trace_torch.py   # on the card
    PYTHONPATH=src python examples/telemetry_trace_torch.py --device cpu

Arms `drim.obs` (the telemetry layer), runs the paper's carry-save BNN
dot-product graph through three engines -- SIMD resident, MIMD
partitioned over 4 bank queues, and the same partition with queue 2
killed mid-graph -- then dumps everything the platform saw:

  * the metrics registry (encode/lower cache hit rates, verifier counts,
    chaos recovery gauges) as one `snapshot()`;
  * host wall-clock spans (compiler passes, `Lowered.run`,
    stage/dispatch/readback) plus per-bank-queue timelines on the
    SIMULATED DDR command clock (AAP streams, fence barriers,
    bus-contention stalls, DEAD/requeue chaos events);
  * a Chrome-trace JSON (`drim_trace.json` by default) -- open it at
    https://ui.perfetto.dev or chrome://tracing: the `drim-host`
    process is wall clock, each `drim-sim <run>` process is one
    recorded MIMD run with a track per bank queue.

Spans read the host's clock and never wait for the card: a "dispatch"
span closes when its launches are queued.
"""
import argparse

import numpy as np

import drim_torch as drim
from drim_torch import DrimGeometry, FaultModel, obs
from repro_torch.device import resolve_device
from repro_torch.pim import graph_ref_results
from repro_torch.pim.bnn import bnn_dot_graph_carrysave

GEOM = DrimGeometry(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
K_BITS = 4
N_WORDS = 32


def equal(outs, ref) -> bool:
    return all(np.array_equal(outs[n].cpu().numpy().view(np.uint32), ref[n])
               for n in ref)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-out", default="drim_trace.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    obs.arm()
    obs.clear_trace()

    graph, _ = bnn_dot_graph_carrysave(K_BITS)
    rng = np.random.default_rng(0)
    feeds = {n: (np.zeros(N_WORDS, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, N_WORDS, dtype=np.uint32))
             for n in graph.input_names}
    ref = graph_ref_results(graph, feeds)
    before = obs.snapshot()

    # 1. SIMD resident engine: compiler-pass + run spans, no sim tracks.
    outs = drim.compile(graph, geom=GEOM).lower("resident").run(
        feeds, device=dev)
    assert equal(outs, ref)

    # 2. MIMD partition over 4 bank queues: the run records a
    #    simulated-clock timeline (one Perfetto track per queue).
    low = drim.compile(graph, geom=GEOM).lower(partition=True, n_queues=4)
    outs = low.run(feeds, device=dev)
    assert equal(outs, ref)

    # 3. Chaos: queue 2 dead from stage 0 -- fences detect the gap, the
    #    orphans requeue on survivors; the timeline shows DEAD + the
    #    requeue spans, the registry the recovery/set-up split.
    outs = low.run(feeds, device=dev,
                   faults=FaultModel(seed=0, dead_queues=(2,)))
    assert equal(outs, ref)
    rep = low.chaos_report
    print(f"chaos: requeued {rep.requeued_segments} segments on "
          f"survivors {rep.survivors}; recovery "
          f"{rep.recovery_s * 1e3:.2f} ms dispatch + "
          f"{rep.compile_s * 1e3:.2f} ms set-up")

    print("\n-- registry delta for this run --")
    d = obs.delta(before)
    for key, val in sorted(d["counters"].items()):
        print(f"  {key:<40}{val:>8}")
    for key, val in sorted(d["gauges"].items()):
        print(f"  {key:<40}{val:>12.6f}")

    path = obs.export_trace(args.trace_out)
    n = len(obs.trace_events())
    print(f"\nwrote {n} trace events to {path}")
    print("open it at https://ui.perfetto.dev (or chrome://tracing)")


if __name__ == "__main__":
    main()
