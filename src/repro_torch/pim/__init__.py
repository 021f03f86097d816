"""Scheduler, fused graphs, the `jit` front end, the compile -> lower ->
run pipeline and the BNN dot product."""
from repro_torch.pim.compiler import (ENGINE_REGISTRY, Compiled, Lowered,
                                      compile, engines, get_engine,
                                      lower_cached)
from repro_torch.pim.frontend import (BitTensor, TraceError, TracedProgram,
                                      csa_reduce, full_add, jit, maj,
                                      popcount, select, xnor)
from repro_torch.pim.graph import (BulkGraph, FusedProgram, FusedSchedule,
                                   ValueRef, compile_graph, graph_ref_results,
                                   plan_graph_schedule)
from repro_torch.pim.scheduler import (OP_ARITY, RESULT_ROWS, Schedule,
                                       expected_results, plan_schedule,
                                       random_operands)
