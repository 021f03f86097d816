"""Dispatch for the packed sign kernels (port of `repro.kernels.ops`).

Every op follows its input's device: the kernels on a CUDA tensor, their
plain torch versions on a CPU tensor.  Words are int32 bit patterns.
"""
from __future__ import annotations

import torch

from repro_torch.core.subarray import WORD_BITS
from repro_torch.kernels import packbits, xnor_popcount


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """[..., K] -> [..., ceil(K/32)] int32 sign words (flattens leading
    dims for the kernel; pad bits are 0)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.to(torch.float32)
    out = packbits.pack_signs(x2.contiguous())
    return out.reshape(*lead, out.shape[-1])


def sign_bits(x: torch.Tensor) -> torch.Tensor:
    """[..., K] values -> {0, 1} uint8 sign bits (1 where x >= 0): the
    convention every packed and DRIM path shares."""
    return (x >= 0).to(torch.uint8)


def unpack_sign_bits(packed: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Inverse of the `pack_signs` word layout: [..., W] int32 sign words
    -> [..., k_bits] {0, 1} uint8 bits (pad bits beyond k_bits dropped),
    on the words' device."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :k_bits] \
        .to(torch.uint8)


def xnor_gemm_packed(a_packed: torch.Tensor, b_packed: torch.Tensor,
                     k_bits: int) -> torch.Tensor:
    """C[M, N] int32 = ±1 dot of packed sign rows."""
    return xnor_popcount.xnor_gemm_packed(a_packed.contiguous(),
                                          b_packed.contiguous(), k_bits)


def binary_matmul(x: torch.Tensor, w_packed: torch.Tensor, k_bits: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Dense activations x [..., K] vs bit-packed weights [N, W].

    Binarizes x on the fly (sign), runs the XNOR-popcount GEMM, returns
    [..., N] in `dtype` (unscaled ±1 dot; layers apply XNOR-Net scaling).
    """
    lead = x.shape[:-1]
    xp = pack_signs(x.reshape(-1, x.shape[-1]))
    out = xnor_gemm_packed(xp, w_packed, k_bits)
    return out.to(dtype).reshape(*lead, w_packed.shape[0])
