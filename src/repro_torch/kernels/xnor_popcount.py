"""XNOR-popcount binary GEMM (port of `repro.kernels.xnor_popcount`).

    C[m, n] = dot(sign(A[m]), sign(B[n])) = 2*popcount(XNOR(a[m], b[n])) - K

Kernel: `csrc/xnor_gemm.cu`, replacing the TPU kernel
`src/repro/kernels/xnor_popcount.py:_xnor_gemm_kernel`.  The TPU kernel
decodes packed words to ±1 int8 for its matrix unit; the port keeps the
product in the packed domain (XOR, NOT, AND with the K mask, `__popc`,
32 sign products per word pair).  At the main path's shapes the integer
operations bound it, not device memory; the kernel stages 32-word
slices of a 32 x 32 output tile's rows in shared memory so each loaded
word is reused 32 times.  Bits past K are masked as `ref.xnor_gemm_ref`
masks them, so the pad bits of the last word never count.  On a CPU
tensor the wrapper runs `xnor_gemm_plain`; on a CUDA tensor it launches
the kernel or raises.
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
                              ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.xnor_gemm.restype = ctypes.c_int
    return lib


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
    with torch.cuda.device(a_packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().xnor_gemm(a_packed.data_ptr(), b_packed.data_ptr(),
                                      out.data_ptr(), m, n, words, k_bits,
                                      stream), "xnor_gemm")
    xnor_gemm_packed.launches += 1
    return out


xnor_gemm_packed.launches = 0
