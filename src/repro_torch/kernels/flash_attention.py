"""Flash attention forward, GQA-aware (port of the forward half of
`repro.kernels.flash_attention`).

Layout as in the reference: q [B, H, Sq, D]; k, v [B, Hkv, Sk, D] with
H = Hkv * n_rep (query head h reads kv head h // n_rep, never a
materialised repeat).  Returns out [B, H, Sq, D] in q's dtype and the
per-row log-sum-exp [B, H, Sq] in float32.  `Sq % bq == 0` and
`Sk % bk == 0` are required, as in the reference (pad upstream).  Here
`bq` and `bk` only validate that alignment: they are the reference's
tile sizes, but the kernel always tiles 64 queries by 64 keys and masks
ragged ends itself, whatever they are.

Kernel: `csrc/flash_attn_fwd.cu`, replacing the TPU kernel
`src/repro/kernels/flash_attention.py:_fwd_kernel`.  One block owns one
(b, h, 64-query tile) and loops over the key tiles itself, keeping the
online-softmax state in registers; the work is float32 multiply-adds on
the CUDA cores, so operations bound it (see the source for the design).
On a CPU tensor the wrapper runs `flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.  The backward kernels of the
reference (`_bwd_dkv_kernel`, `_bwd_dq_kernel`) belong to training and
are not ported yet (ROADMAP Queue 2 item 5): the kernel path refuses
inputs that require a gradient.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sdpa_ref

DEFAULT_BQ = 128
DEFAULT_BK = 128
HEAD_DIMS = (16, 32, 64, 128)        # the kernel's compiled head widths
_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attn_fwd")
    lib.flash_attn_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.flash_attn_fwd.restype = ctypes.c_int
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


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, n_rep: int = 1, bq: int = DEFAULT_BQ,
              bk: int = DEFAULT_BK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, Sq, D] in q's dtype, lse [B, H, Sq] float32).  `bq`
    and `bk` are checked to divide Sq and Sk and set no tile size."""
    _check(q, k, v, n_rep, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, h, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head widths {HEAD_DIMS}, not {d}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention backward kernels are not ported yet: "
            "ROADMAP Queue 2 item 5")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, n_rep: int = 1,
                    bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK
                    ) -> torch.Tensor:
    """q [B,H,Sq,D]; k, v [B,Hkv,Sk,D]; H = Hkv * n_rep.  Returns
    [B,H,Sq,D] (the reference's signature, without `interpret`)."""
    return flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=bq, bk=bk)[0]
