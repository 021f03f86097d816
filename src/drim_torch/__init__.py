"""`drim_torch`: the SIMDRAM-style end-to-end front end for the DRIM stack,
on PyTorch and one CUDA card (port of `drim`).

Write a kernel as a plain Python function over symbolic bit-planes,
trace it with `drim.jit`, and run one staged pipeline over every
engine, mesh, queue count, and partition strategy:

    import drim_torch as drim

    @drim.jit
    def kernel(a, b, c):
        x = drim.xnor(a, b)                 # single-cycle DRA
        s, carry = drim.full_add(x, c, b)   # Table-2 adder slice
        return {"s": s, "carry": carry}

    out = kernel(A, B, C)                   # trace->compile->lower->run
    low = drim.compile(kernel).lower(engine="queued", n_queues=4)
    print(low.cost(1 << 20).latency_s, low.verdict(1 << 20).winner)

Runs go to the CUDA card unless the caller passes `device="cpu"` (as
`kernel(A, B, C, device="cpu")` or `low.run(..., device="cpu")`); there
is no fallback.  A fleet mesh is an explicit device list:
`drim.fleet_mesh(drim.DRIM_R)` takes every visible card (one card: 1x1),
`drim.fleet_mesh(geom, devices=[torch.device("cpu")] * 8)` a 2x4 split
on the CPU.

This package is the stable import surface; the implementation lives in
`repro_torch.pim.frontend` (tracing), `repro_torch.pim.compiler`
(pipeline + engine registry) and `repro_torch.pim.offload` (the unified
placement Verdict).  The comparator is the card, not a TPU, so the one
name that differs from `drim`'s is the comparator's cost:
`GpuCost`/`gpu_cost` in place of `TpuCost`/`tpu_cost` (the "gpu" engine
in place of "tpu", as "cuda" takes the place of "pallas").

Observability rides along as `drim.obs` (= `repro_torch.runtime.
telemetry`): `drim.obs.armed()` turns on span tracing + per-queue
Perfetto timelines, `drim.obs.snapshot()` reads the metrics registry, and
`drim.obs.export_trace(path)` dumps a chrome://tracing-compatible file.
"""
from repro_torch.core import DRIM_R, DRIM_S, DrimGeometry, FaultModel
from repro_torch.pim.compiler import (ENGINE_REGISTRY, PARTITIONERS,
                                      PASS_PIPELINE, Compiled, EccReport,
                                      Engine, EngineRegistry, Lowered,
                                      compile, engines, get_engine, lower)
from repro_torch.pim.frontend import (BitTensor, JittedFunction, TraceError,
                                      TracedProgram, copy, csa_reduce,
                                      full_add, jit, maj, popcount, select,
                                      xnor)
from repro_torch.pim.graph import BulkGraph
from repro_torch.pim.harden import HARDEN_SCHEMES, harden_graph
from repro_torch.pim.mesh import fleet_mesh
from repro_torch.pim.offload import (GpuCost, Verdict, VerdictRow,
                                     build_verdict, gpu_cost)
from repro_torch.pim.queue import ChaosReport
from repro_torch.pim import verify
from repro_torch.pim.verify import VerifyError, VerifyReport, verify_lowered
from repro_torch.runtime import telemetry as obs

__all__ = [
    "BitTensor", "BulkGraph", "ChaosReport", "Compiled", "DRIM_R",
    "DRIM_S", "DrimGeometry", "ENGINE_REGISTRY", "EccReport", "Engine",
    "EngineRegistry", "FaultModel", "GpuCost", "HARDEN_SCHEMES",
    "JittedFunction", "Lowered", "PARTITIONERS", "PASS_PIPELINE",
    "TraceError", "TracedProgram", "Verdict", "VerdictRow", "VerifyError",
    "VerifyReport", "build_verdict", "compile", "copy", "csa_reduce",
    "engines", "fleet_mesh", "full_add", "get_engine", "gpu_cost",
    "harden_graph", "jit", "lower", "maj", "obs", "popcount", "select",
    "verify", "verify_lowered", "xnor",
]
