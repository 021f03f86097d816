"""Dispatch for the port's kernels (port of `repro.kernels.ops`): the bulk
bit-wise ops, the sign packer and unpacker, the binary GEMM and the
bit-plane adder.

Every op follows its input's device: the kernels on a CUDA tensor, their
plain torch versions on a CPU tensor.  Words are int32 bit patterns (a
uint32 tensor is viewed as int32).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.subarray import WORD_BITS
from repro_torch.kernels import bitserial_add, packbits, xnor_popcount
from repro_torch.kernels.bitwise import bitwise as _bitwise_words
from repro_torch.kernels.ref import popcount_u32_ref


def _words(x: torch.Tensor) -> torch.Tensor:
    """A word tensor as contiguous int32 bit patterns (a view where the
    input already is)."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.contiguous()


# --- bulk bit-wise ops ---------------------------------------------------------

def bitwise(op: str, a: torch.Tensor, b: torch.Tensor | None = None,
            c: torch.Tensor | None = None):
    """Bulk bit-wise `op` ("not", "xnor", "xor", "and", "or", "nand",
    "nor", "maj3", "min3", "fa") on word tensors of one shape; returns that
    shape, or (sum, carry) for "fa"."""
    return _bitwise_words(op, *(None if t is None else _words(t)
                                  for t in (a, b, c)))


def xnor(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return bitwise("xnor", a, b)


def maj3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return bitwise("maj3", a, b, c)


def full_adder(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """(sum, carry) of three word tensors."""
    return bitwise("fa", a, b, c)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """[..., K] -> [..., ceil(K/32)] int32 sign words (flattens leading
    dims for the kernel; pad bits are 0)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.dtype not in (torch.float32, torch.bfloat16):
        x2 = x2.to(torch.float32)
    out = packbits.pack_signs(x2.contiguous())
    return out.reshape(*lead, out.shape[-1])


def unpack_signs(p: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., W] words -> [..., 32 W] values in {-1, +1} of `dtype`
    (float32, bfloat16 or int8; flattens leading dims for the kernel)."""
    lead = p.shape[:-1]
    out = packbits.unpack_signs(
        _words(p).reshape(math.prod(lead), p.shape[-1]), dtype)
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


# --- bit-plane adder -------------------------------------------------------------

def bitplane_add(a_planes: torch.Tensor, b_planes: torch.Tensor):
    """(sum planes [nbits, W], carry-out [W]) of packed bit-planes."""
    return bitserial_add.bitplane_add(_words(a_planes), _words(b_planes))


# --- popcount -----------------------------------------------------------------------

def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32), on the words' device: plain
    torch on every device, as the reference's is its jnp oracle."""
    return popcount_u32_ref(x)
