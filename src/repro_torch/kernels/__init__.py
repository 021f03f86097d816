"""The port's hand-written CUDA kernels (`csrc/`), each beside its plain
torch version, plus the torch oracles (`ref`) and dispatch (`ops`).
Nothing is built at import: a kernel is compiled at its first launch."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import (binary_matmul, bitplane_add, bitwise,
                                     full_adder, maj3, pack_signs, popcount,
                                     unpack_signs, xnor, xnor_gemm_packed)
