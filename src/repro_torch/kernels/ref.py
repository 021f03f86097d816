"""Plain torch oracles for the port's kernels (port of `repro.kernels.ref`).

Words are int32 bit patterns; every shift is masked, since `>>` on int32
is arithmetic.
"""
from __future__ import annotations

import torch

from repro_torch.core.subarray import WORD_BITS, pack_bits, unpack_bits


def bitwise_ref(op: str, a, b=None, c=None):
    if op == "not":
        return ~a
    if op == "xnor":
        return ~(a ^ b)
    if op == "xor":
        return a ^ b
    if op == "and":
        return a & b
    if op == "or":
        return a | b
    if op == "nand":
        return ~(a & b)
    if op == "nor":
        return ~(a | b)
    maj = (a & b) | (a & c) | (b & c)
    if op == "maj3":
        return maj
    if op == "min3":
        return ~maj
    if op == "fa":
        return a ^ b ^ c, maj
    raise ValueError(op)


def pack_signs_ref(x: torch.Tensor) -> torch.Tensor:
    """[..., K] float -> [..., K/32] int32 words; bit 1 where x >= 0."""
    return pack_bits(x >= 0)


def unpack_signs_ref(p: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[..., W] int32 words -> [..., W*32] in {-1, +1}."""
    return (unpack_bits(p).to(torch.float32) * 2.0 - 1.0).to(dtype)


def popcount_u32_ref(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of each 32-bit word (returns int32)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def xnor_gemm_ref(a_packed: torch.Tensor, b_packed: torch.Tensor,
                  k_bits: int) -> torch.Tensor:
    """Binary GEMM oracle via the XNOR-popcount identity.

    a_packed [M, W], b_packed [N, W] int32 sign words; returns C[M, N] =
    dot(±1(a), ±1(b)) = 2*popcount(XNOR) - K as int32.  Bits past k_bits
    are masked off, whatever they hold."""
    xnor = ~(a_packed[:, None, :] ^ b_packed[None, :, :])
    w = a_packed.shape[-1]
    valid = torch.arange(w * WORD_BITS, device=a_packed.device) < k_bits
    mask = pack_bits(valid)
    pc = popcount_u32_ref(xnor & mask).sum(-1)
    return (2 * pc - k_bits).to(torch.int32)


def xnor_gemm_dense_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """xnor_gemm_ref from dense float inputs: sign-binarize, then an exact
    float32 product (every partial sum is an integer below 2**24)."""
    sa = torch.where(a >= 0, 1.0, -1.0).to(torch.float32)
    sb = torch.where(b >= 0, 1.0, -1.0).to(torch.float32)
    return (sa @ sb.T).to(torch.int32)


# --- bitserial_add.py oracle ------------------------------------------------

def bitplane_add_ref(a_planes: torch.Tensor, b_planes: torch.Tensor):
    """Ripple-carry add of bit-plane-packed integers (DRIM adder oracle).

    a_planes, b_planes: [nbits, W] int32 packed bit-planes (LSB first).
    Returns (sum_planes [nbits, W], carry_out [W])."""
    carry = torch.zeros(a_planes.shape[1:], dtype=a_planes.dtype,
                        device=a_planes.device)
    sums = []
    for a, b in zip(a_planes, b_planes):
        sums.append(a ^ b ^ carry)
        carry = (a & b) | (a & carry) | (b & carry)
    if not sums:
        return torch.empty_like(a_planes), carry
    return torch.stack(sums), carry


# --- flash_attention.py oracle ------------------------------------------------

def sdpa_ref(q, k, v, causal: bool = True, n_rep: int = 1, *,
             with_lse: bool = False):
    """Dense scaled-dot-product attention oracle (float32 math).

    q [B,H,Sq,D]; k, v [B,Hkv,Sk,D]; GQA repeat via n_rep; the causal mask
    compares absolute indices (query i keeps keys j <= i).  Returns out in
    q's dtype, and with `with_lse` also the row log-sum-exp [B,H,Sq] of
    the masked scores in float32."""
    d = q.shape[-1]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=1)
        v = v.repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / (d ** 0.5)
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w,
                       v.to(torch.float32)).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out
