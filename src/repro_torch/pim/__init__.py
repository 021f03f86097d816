"""Processing-in-memory layer (port of `repro.pim`): the `jit` tracing
front end (`frontend`), the staged compile -> lower -> run pipeline with
one engine registry (`compiler`), bulk-op scheduling over the simulated
DRIM fleet (`scheduler`), the (chips, banks) fleet mesh for sharded
simulation (`mesh`), fused dataflow graphs with resident intermediates
(`graph`, `bnn`), per-bank command queues with MIMD graph partitioning
(`queue`), fault-tolerance hardening (`harden`), the static verifier
(`verify`) and the DRIM-vs-GPU placement Verdict with the "gpu"
comparator's cost (`offload`).  The legacy `execute*`/`plan*` entry
points remain as deprecated shims over the pipeline."""
from repro_torch.core.faults import FaultModel
from repro_torch.pim.scheduler import (ENGINES, OP_ARITY, REF_OP,
                                       RESULT_ROWS, Schedule, build_program,
                                       dispatch_waves, encoded_program,
                                       execute, execute_oplist,
                                       expected_results, fresh_encode_cache,
                                       plan_schedule, random_operands,
                                       run_waves, run_waves_baseline,
                                       stage_rows, wave_fn)
from repro_torch.pim.mesh import (DEVICE_SPEC, STAGED_SPEC, fleet_mesh,
                                  fleet_shape, shard_device, shard_staged)
from repro_torch.pim.graph import (BulkGraph, FusedProgram, FusedSchedule,
                                   GraphPartition, QueueSegment, ValueRef,
                                   compile_graph, execute_graph,
                                   graph_ref_results, partition_graph,
                                   plan_graph_schedule)
from repro_torch.pim.queue import (ChaosReport, QueueProgressTable,
                                   QueueSchedule, bank_blocks,
                                   default_n_queues, execute_partitioned,
                                   fused_queue_schedule,
                                   plan_partitioned_schedule,
                                   plan_queued_schedule, queue_mesh,
                                   run_waves_queued, stage_rows_queued,
                                   uniform_queue_schedule)
from repro_torch.pim.frontend import (BitTensor, JittedFunction, TraceError,
                                      TracedProgram, copy, csa_reduce,
                                      full_add, jit, maj, popcount, select,
                                      xnor)
from repro_torch.pim.compiler import (ENGINE_REGISTRY, PARTITIONERS,
                                      PASS_PIPELINE, Compiled, EccReport,
                                      Engine, EngineRegistry, Lowered,
                                      compile, engines, get_engine, lower,
                                      lower_cached)
from repro_torch.pim.harden import ECC_OUTPUT, HARDEN_SCHEMES, harden_graph
from repro_torch.pim import verify
from repro_torch.pim.verify import (VerifyError, VerifyReport, verify_fused,
                                    verify_lowered, verify_partition)
from repro_torch.pim.bnn import (bnn_dot_drim, bnn_dot_graph,
                                 bnn_dot_graph_carrysave,
                                 bnn_dot_partitioned, counter_bits,
                                 decode_counts, stage_bnn_planes)
from repro_torch.pim.offload import (SIMULATE_MAX_BITS, FusedOffloadReport,
                                     GpuCost, OffloadReport,
                                     QueuedOffloadReport, Verdict,
                                     VerdictRow, build_verdict, gpu_cost,
                                     plan, plan_fused, plan_model_payloads,
                                     plan_queued, serving_verdict)
