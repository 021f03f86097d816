"""XNOR-popcount binary GEMM (port of `repro.kernels.xnor_popcount`).

    C[m, n] = dot(sign(A[m]), sign(B[n])) = 2*popcount(XNOR(a[m], b[n])) - K

Kernel: `csrc/xnor_gemm.cu`, replacing the TPU kernel
`src/repro/kernels/xnor_popcount.py:_xnor_gemm_kernel`.  Like the TPU
kernel, which decodes packed words to ±1 int8 for its matrix unit, it
runs the product on the int8 tensor cores (`mma.sync` m16n8k32).  Bits
expand in registers to 0/1 int8 of the mma fragments, two integer
operations per four k (lane t of a quad takes bits 8j + t and 8j + 4 + t
of each word, the same on both sides), bits past K to 0 on the `a` side,
so the pad bits of the last word never count, whatever they hold; the
row popcounts below K turn the 0/1 product P into the ±1 dot, 4 P - 2
pa - 2 pb + K.  The packed operands arrive by `cp.async`, all of K (up
to 12,800 bits) at once; a block computes a 64 x 64 int32 output tile with
2 x `k_groups` warps that split the k steps (`k_groups` picks more where
the output has few tiles).  On a CPU tensor the wrapper runs
`xnor_gemm_plain`; on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import xnor_gemm_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("xnor_gemm")
    lib.xnor_gemm.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p]
    lib.xnor_gemm.restype = ctypes.c_int
    return lib


# The kernel's launch: a block's output tile, the K words it holds at once
# (kSegMax), its registers a thread (ptxas, sm_90a), and an SM's registers
# and shared memory (1 KB of it reserved per block).
TILE = 64
SEG_MAX = 400
REGS = 128
SM_REGS = 65536
SM_SMEM_BYTES = 233472


def k_groups(m: int, n: int, words: int, sm_count: int) -> int:
    """Warps sharing each warp's outputs along K (1, 2 or 4): the most
    that leave every warp 12 or more k steps and keep every 64 x 64 tile's
    block resident in one wave over `sm_count` SMs: more groups hide the
    latency of few tiles, fewer pay less for handing sums to group 0."""
    tiles = -(-m // TILE) * -(-n // TILE)
    seg = min(-(-words // 8) * 8, SEG_MAX)
    for kg in (4, 2):
        if words < 12 * kg:
            continue
        smem = (2 * TILE) * (seg + 4) * 4 + 512 + 16384 + 1024
        per_sm = min(SM_REGS // (64 * kg * REGS), SM_SMEM_BYTES // smem)
        if tiles <= per_sm * sm_count:
            return kg
    return 1


def xnor_gemm_plain(a_packed: torch.Tensor, b_packed: torch.Tensor,
                    k_bits: int) -> torch.Tensor:
    """Plain torch version: `ref.xnor_gemm_ref`."""
    return xnor_gemm_ref(a_packed, b_packed, k_bits)


def xnor_gemm_packed(a_packed: torch.Tensor, b_packed: torch.Tensor,
                     k_bits: int) -> torch.Tensor:
    """a_packed [M, W], b_packed [N, W] int32 contiguous sign words ->
    C [M, N] int32, exactly; 0 < k_bits <= 32*W."""
    for name, t in (("a_packed", a_packed), ("b_packed", b_packed)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be [rows, words], got shape "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must hold int32 words, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, words = a_packed.shape
    n, words_b = b_packed.shape
    if words != words_b:
        raise ValueError(f"word counts differ: {words} vs {words_b}")
    if not 0 < k_bits <= 32 * words:
        raise ValueError(f"k_bits={k_bits} does not fit {words} words")
    if a_packed.device != b_packed.device:
        raise ValueError("operands lie on different devices")
    if a_packed.device.type == "cpu":
        return xnor_gemm_plain(a_packed, b_packed, k_bits)
    if a_packed.device.type != "cuda":
        raise ValueError(f"xnor_gemm_packed runs on cpu or cuda, not "
                         f"{a_packed.device}")
    out = torch.empty((m, n), dtype=torch.int32, device=a_packed.device)
    if out.numel() == 0:
        return out
    kg = k_groups(m, n, words, _build.sm_count(a_packed.device))
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().xnor_gemm(a_packed.data_ptr(), b_packed.data_ptr(),
                                      out.data_ptr(), m, n, words, k_bits, kg,
                                      stream), "xnor_gemm")
    xnor_gemm_packed.launches += 1
    return out


xnor_gemm_packed.launches = 0
