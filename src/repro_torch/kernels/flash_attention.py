"""Flash attention, GQA-aware, forward and backward (port of
`repro.kernels.flash_attention`).

Layout as in the reference: q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] with
H = Hkv * n_rep (query head h reads kv head h // n_rep, never a
materialised repeat).  The forward returns out [B, H, Sq, D] in q's dtype
and the per-row log-sum-exp [B, H, Sq] in float32; the backward
recomputes p = exp(s - lse) from it (flash-attn v2 style), so nothing
[Sq, Sk]-shaped reaches device memory.  `Sq % bq == 0` and `Sk % bk == 0`
are required, as in the reference (pad upstream).  Here `bq` and `bk`
only validate that alignment: they are the reference's tile sizes, but
the kernels always tile 64 queries by 64 keys and mask ragged ends
themselves, whatever they are.

Kernels: `csrc/flash_attn_fwd.cu` replaces the TPU kernel
`src/repro/kernels/flash_attention.py:_fwd_kernel`, and
`csrc/flash_attn_bwd.cu` its `_bwd_dkv_kernel` (`flash_bwd_dkv`: dk, dv)
and `_bwd_dq_kernel` (`flash_bwd_dq`: dq).  Each output tile has one
owner block that loops over the reduction itself, keeping its sums in
registers, so operations bound all three.  In bfloat16 all three run
their products on the tensor cores (`mma.sync`, bf16 operands, float32
sums; dkv splits p and ds, dq splits ds, into bf16 hi + lo halves); in
float32 the work is float32 multiply-adds on the CUDA cores (see the
sources for the designs).
`flash_attention` is the reference's custom VJP as a
`torch.autograd.Function`: the forward kernel, then both backward
kernels.  On CPU tensors every wrapper runs its plain version; on CUDA
tensors it launches its kernel or raises.

On meta tensors (the dry-run, which models the card) every wrapper gives
what its kernel gives, shapes and dtypes with no storage and no launch:
the forward out in q's dtype and lse float32 [B, H, Sq], the backward
delta float32 [B, H, Sq] (the same torch op as on the card), then dk, dv
and dq.  Each is an operator of its own (`repro_torch::flash_fwd`,
`flash_bwd_dkv`, `flash_bwd_dq`, a Meta kernel only) whose FLOP formula
for `torch.utils.flop_counter` is the dense products the CPU's `_sdpa`
runs for the same attention, so that a meta step counts what a CPU step
counts: the forward 4*B*H*Sq*Sk*D (scores and values, unhalved), the
backward 8*B*H*Sq*Sk*D, dkv the 6 of them that give dv, the scores'
gradient and dk, dq the 2 that give dq.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sdpa_ref

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (16, 32, 64, 128)        # the kernels' compiled head widths
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    lib.flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attn_fwd.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_bwd")
    lib.flash_attn_bwd_dkv.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attn_bwd_dq.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attn_bwd_dkv.restype = ctypes.c_int
    lib.flash_attn_bwd_dq.restype = ctypes.c_int
    return lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, n_rep: int = 1
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: the dense oracle `ref.sdpa_ref` in float32
    math, with the row log-sum-exp of its masked scores."""
    return sdpa_ref(q, k, v, causal=causal, n_rep=n_rep, with_lse=True)


def _check(q, k, v, n_rep: int, bq: int, bk: int) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, heads, S, D], got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash attention takes float32 or bfloat16, "
                            f"got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if n_rep < 1 or h != k.shape[1] * n_rep:
        raise ValueError(f"{h} query heads != {k.shape[1]} kv heads x "
                         f"n_rep {n_rep}")
    if bq < 1 or bk < 1 or sq % bq or k.shape[2] % bk:
        raise ValueError(f"Sq={sq} and Sk={k.shape[2]} must be multiples of "
                         f"bq={bq} and bk={bk} (pad upstream)")


def _check_kernel(q) -> None:
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, not "
                         f"{q.shape[3]}")


# --- the meta device's operators ---------------------------------------------

_META_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_META_LIB.define("flash_fwd(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)")
_META_LIB.define("flash_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor do, "
                 "Tensor lse, Tensor delta) -> (Tensor, Tensor)")
_META_LIB.define("flash_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor do, "
                 "Tensor lse, Tensor delta) -> Tensor")


def _fwd_meta(q, k, v):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _dkv_meta(q, k, v, do, lse, delta):
    return torch.empty_like(k), torch.empty_like(v)


def _dq_meta(q, k, v, do, lse, delta):
    return torch.empty_like(q)


_META_LIB.impl("flash_fwd", _fwd_meta, "Meta")
_META_LIB.impl("flash_bwd_dkv", _dkv_meta, "Meta")
_META_LIB.impl("flash_bwd_dq", _dq_meta, "Meta")


def _dense_products(q_shape, k_shape) -> int:
    """B*H*Sq*Sk*D: the multiply-adds of one dense [Sq, Sk] product."""
    b, h, sq, d = q_shape
    return b * h * sq * k_shape[2] * d


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _fwd_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 4 * _dense_products(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dkv)
def _dkv_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 6 * _dense_products(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_bwd_dq)
def _dq_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * _dense_products(q_shape, k_shape)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, n_rep: int = 1, bq: int = DEFAULT_BQ,
              bk: int = DEFAULT_BK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, Sq, D] in q's dtype, lse [B, H, Sq] float32).  `bq`
    and `bk` are checked to divide Sq and Sk and set no tile size."""
    _check(q, k, v, n_rep, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, n_rep)
    _check_kernel(q)
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_fwd(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().flash_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, n_rep, sq, k.shape[2], d, int(causal),
            int(q.dtype == torch.bfloat16), stream), "flash_attn_fwd")
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# --- backward ---------------------------------------------------------------

def _bwd_plain(q, k, v, do, lse, delta, causal: bool, n_rep: int):
    """(dq, dk, dv) of the reference's `_flash_bwd` in float32 math over
    the whole score matrix, given delta."""
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(n_rep, dim=1)
    vf = v.to(torch.float32).repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)

    def fold(t):          # sum the n_rep query heads of each kv head
        return t.reshape(b, hkv, n_rep, sk, d).sum(2)
    return (dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype))


def _delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """rowsum(out * do) [B, H, Sq] in float32, as the reference computes
    it outside its kernels."""
    return (out.to(torch.float32) * do.to(torch.float32)).sum(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal: bool = True,
                              n_rep: int = 1):
    """Plain torch version of the backward: the reference's math step by
    step (delta = sum(out * do), p = exp(s * scale - lse) with masked
    scores at -1e30, ds = p * (dp - delta) * scale).  Returns (dq, dk, dv)
    in q's, k's and v's dtypes."""
    return _bwd_plain(q, k, v, do, lse, _delta(out, do), causal, n_rep)


def _check_bwd(q, k, v, do, lse, delta, n_rep: int) -> None:
    _check(q, k, v, n_rep, 1, 1)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"do {tuple(do.shape)} {do.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != q.shape[:3] or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {tuple(q.shape[:3])}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    for name, t in (("do", do), ("lse", lse), ("delta", delta)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")


def _bwd_args(q, k, v, do, lse, delta):
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_dims(q, k, n_rep: int, causal: bool):
    b, h, sq, d = q.shape
    return (b, h, n_rep, sq, k.shape[2], d, int(causal),
            int(q.dtype == torch.bfloat16))


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                  n_rep: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B, Hkv, Sk, D] in k's dtype, summed over the n_rep query
    heads of each kv head; `delta` is rowsum(out * do) [B, H, Sq]."""
    _check_bwd(q, k, v, do, lse, delta, n_rep)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal, n_rep)[1:]
    _check_kernel(q)
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_bwd_dkv(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_bwd_lib().flash_attn_bwd_dkv(
            *_bwd_args(q, k, v, do, lse, delta), dk.data_ptr(),
            dv.data_ptr(), *_bwd_dims(q, k, n_rep, causal), stream),
            "flash_attn_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                 n_rep: int = 1) -> torch.Tensor:
    """dq [B, H, Sq, D] in q's dtype; `delta` is rowsum(out * do)."""
    _check_bwd(q, k, v, do, lse, delta, n_rep)
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal, n_rep)[0]
    _check_kernel(q)
    if q.device.type == "meta":
        return torch.ops.repro_torch.flash_bwd_dq(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_bwd_lib().flash_attn_bwd_dq(
            *_bwd_args(q, k, v, do, lse, delta), dq.data_ptr(),
            *_bwd_dims(q, k, n_rep, causal), stream), "flash_attn_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd(q, k, v, out, lse, do, *, causal: bool = True, n_rep: int = 1
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the plain version on CPU tensors, else delta as one
    torch op and the two kernels (on meta tensors, their operators)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal, n_rep)
    delta = _delta(out, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                           n_rep=n_rep)
    return flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                        n_rep=n_rep), dk, dv


class FlashAttention(torch.autograd.Function):
    """The reference's custom VJP: the forward kernel saves (q, k, v, out,
    lse); the backward runs the dkv and dq kernels on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, n_rep, bq, bk):
        out, lse = flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=bq,
                             bk=bk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.n_rep = causal, n_rep
        return out

    @staticmethod
    def backward(ctx, do):
        # `do` may arrive as a strided view (gqa_attend transposes the
        # output after the call)
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(),
                               causal=ctx.causal, n_rep=ctx.n_rep)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, n_rep: int = 1,
                    bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK
                    ) -> torch.Tensor:
    """q [B,H,Sq,D]; k, v [B,Hkv,Sk,D]; H = Hkv * n_rep.  Returns
    [B,H,Sq,D], differentiable in q, k and v (the reference's signature,
    without `interpret`)."""
    return FlashAttention.apply(q, k, v, causal, n_rep, bq, bk)
