"""Scheduler, fused graphs, MIMD graph partitions and per-bank command
queues, the `jit` front end, the compile -> lower -> run pipeline,
fault-tolerance hardening, the static verifier, the BNN dot product and
the DRIM-vs-GPU placement Verdict with the "gpu" comparator's cost."""
from repro_torch.core.faults import FaultModel
from repro_torch.pim.compiler import (ENGINE_REGISTRY, PARTITIONERS,
                                      PASS_PIPELINE, Compiled, EccReport,
                                      Lowered, compile, engines, get_engine,
                                      lower_cached)
from repro_torch.pim.frontend import (BitTensor, TraceError, TracedProgram,
                                      csa_reduce, full_add, jit, maj,
                                      popcount, select, xnor)
from repro_torch.pim.graph import (BulkGraph, FusedProgram, FusedSchedule,
                                   GraphPartition, QueueSegment, ValueRef,
                                   compile_graph, graph_ref_results,
                                   partition_graph, plan_graph_schedule)
from repro_torch.pim.harden import ECC_OUTPUT, HARDEN_SCHEMES, harden_graph
from repro_torch.pim.offload import (SIMULATE_MAX_BITS, GpuCost, Verdict,
                                     VerdictRow, build_verdict, gpu_cost,
                                     plan_model_payloads, serving_verdict)
from repro_torch.pim.queue import (ChaosReport, QueueProgressTable,
                                   QueueSchedule, bank_blocks,
                                   default_n_queues, fused_queue_schedule,
                                   plan_partitioned_schedule,
                                   plan_queued_schedule, queue_mesh,
                                   run_waves_queued, stage_rows_queued,
                                   uniform_queue_schedule)
from repro_torch.pim.scheduler import (ENGINES, OP_ARITY, RESULT_ROWS,
                                       Schedule, encoded_program,
                                       expected_results, fresh_encode_cache,
                                       plan_schedule, random_operands,
                                       run_waves, stage_rows, wave_fn)
from repro_torch.pim import verify
from repro_torch.pim.verify import (VerifyError, VerifyReport, verify_fused,
                                    verify_lowered, verify_partition)
from repro_torch.pim.bnn import bnn_dot_partitioned
