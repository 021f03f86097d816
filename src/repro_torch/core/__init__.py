"""Sub-array, AAP instruction set, device stack, fault model, geometry,
timing, the analog sense-amplifier model and its Table-3 Monte-Carlo,
the Fig. 9 energy model and the paper's platform models."""
from .analog import (PAPER_TABLE3, AnalogParams, dra_analog,
                     monte_carlo_error_rates, tra_analog)
from .device import (DrimDevice, device_broadcast_rows, device_load_rows,
                     device_read_row, device_read_row_window,
                     device_read_rows, device_run_program,
                     device_run_program_banked, device_run_program_sharded,
                     device_template, make_device)
from .energy import (E_AAP_NJ_PER_KB, E_ACCESS_NJ_PER_KB, E_IO_NJ_PER_KB,
                     PAPER_ENERGY_CLAIMS, cpu_energy_nj_per_kb,
                     ddr4_copy_energy_nj_per_kb, energy_table,
                     pim_energy_nj_per_kb)
from .faults import FaultModel, fault_mask, mix32, slot_ids_grid
from .isa import (AAP, AAP_COUNTS, ENABLE_BITS, KSTREAM_COLS, OP_COPY,
                  OP_COPY2, OP_DRA, OP_TRA, cost, dcc_state_rows, encode,
                  encode_kernel_stream, kstream_slot, microprogram_add,
                  microprogram_and2, microprogram_copy, microprogram_maj3,
                  microprogram_min3, microprogram_not, microprogram_or2,
                  microprogram_xnor2, microprogram_xor2,
                  multibit_add_program, run_program, run_program_py,
                  run_program_unrolled)
from .subarray import (N_DCC_WL, N_XROWS, WORD_BITS, SubArray, aap_copy,
                       aap_copy2, aap_dra, aap_tra, activate_read, load_rows,
                       make_subarray, pack_bits, row_words, unpack_bits)
from .platforms import (CONTEXT_CLAIMS, PAPER_CLAIMS, PIM_CYCLES, Platform,
                        all_platforms)
from .timing import (CMD_SLOTS_PER_AAP, DRIM_R, DRIM_S, T_AAP_S, T_CMD_S,
                     DrimGeometry, area_report, ddr_rows_s,
                     drim_latency_s, drim_throughput_bits)
