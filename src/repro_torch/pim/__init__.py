"""Scheduler, fused graphs, the `jit` front end, the compile -> lower ->
run pipeline, fault-tolerance hardening, the BNN dot product and the
"gpu" comparator's cost."""
from repro_torch.core.faults import FaultModel
from repro_torch.pim.compiler import (ENGINE_REGISTRY, Compiled, EccReport,
                                      Lowered, compile, engines, get_engine,
                                      lower_cached)
from repro_torch.pim.frontend import (BitTensor, TraceError, TracedProgram,
                                      csa_reduce, full_add, jit, maj,
                                      popcount, select, xnor)
from repro_torch.pim.graph import (BulkGraph, FusedProgram, FusedSchedule,
                                   ValueRef, compile_graph, graph_ref_results,
                                   plan_graph_schedule)
from repro_torch.pim.harden import ECC_OUTPUT, HARDEN_SCHEMES, harden_graph
from repro_torch.pim.offload import GpuCost, VerdictRow, gpu_cost
from repro_torch.pim.scheduler import (ENGINES, OP_ARITY, RESULT_ROWS,
                                       Schedule, expected_results,
                                       plan_schedule, random_operands,
                                       run_waves, stage_rows, wave_fn)
