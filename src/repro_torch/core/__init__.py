"""Sub-array, AAP instruction set, geometry and energy constants."""
from .energy import E_AAP_NJ_PER_KB, E_ACCESS_NJ_PER_KB, E_IO_NJ_PER_KB
from .isa import (AAP, AAP_COUNTS, KSTREAM_COLS, OP_COPY, OP_COPY2, OP_DRA,
                  OP_TRA, cost, dcc_state_rows, encode, encode_kernel_stream,
                  kstream_slot, microprogram_add, microprogram_and2,
                  microprogram_copy, microprogram_maj3, microprogram_min3,
                  microprogram_not, microprogram_or2, microprogram_xnor2,
                  microprogram_xor2, run_program_unrolled)
from .subarray import (N_DCC_WL, N_XROWS, WORD_BITS, SubArray, make_subarray,
                       pack_bits, row_words, unpack_bits)
from .timing import DRIM_R, DRIM_S, T_AAP_S, DrimGeometry, ddr_rows_s
