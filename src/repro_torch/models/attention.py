"""GQA attention (port of the GQA part of `repro.models.attention`).

Two entry modes share one set of params:
  * prefill : full-sequence causal attention, returns (out, cache)
  * decode  : one new token against a KV cache of length S_ctx

Cache: {"k": [B, S, Hkv, Dh], "v": [B, S, Hkv, Dh]}.  Windowed attention
masks keys older than `window`.  MLA and cross-attention come with the
families that use them (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Params, apply_rope, linear,
                                       linear_init, rmsnorm, rmsnorm_init)

NEG_INF = -1e30


def gqa_init(gen: torch.Generator, cfg, *, dtype=torch.float32) -> Params:
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bl = cfg.bitlinear in ("attn", "all")
    p = {
        "wq": linear_init(gen, d, h * dh, bias=cfg.qkv_bias, dtype=dtype,
                          bitlinear_on=bl),
        "wk": linear_init(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype,
                          bitlinear_on=bl),
        "wv": linear_init(gen, d, hkv * dh, bias=cfg.qkv_bias, dtype=dtype,
                          bitlinear_on=bl),
        "wo": linear_init(gen, h * dh, d, dtype=dtype, bitlinear_on=bl),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(dh)
        p["k_norm"] = rmsnorm_init(dh)
    return p


def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(p["wq"], x).reshape(b, s, h, dh)
    k = linear(p["wk"], x).reshape(b, s, hkv, dh)
    v = linear(p["wv"], x).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, n_rep: int):
    """q [B,Sq,H,Dh]; k,v [B,Sk,Hkv,Dh]; mask [B?,Sq,Sk] bool (True=keep).

    The reference's mixed precision: products of the working-dtype
    operands summed in float32, a float32 softmax, and the weights
    rounded to v's dtype before the value product."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, hkv, n_rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(b, sq, h, dh).to(q.dtype)


def causal_mask(sq: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sq, device=device)[None, :]
    m = j <= i
    if window:
        m &= (i - j) < window
    return m


def _use_flash(cfg, s: int, window: int, device) -> bool:
    """The flash kernel applies on the card, unwindowed, block-aligned:
    the reference's rule with the card in place of the TPU.  On the CPU
    the dense-scores `_sdpa` runs, as the reference runs it off the TPU."""
    return (getattr(cfg, "attention_impl", "flash") == "flash"
            and torch.device(device).type == "cuda"
            and window == 0 and s % 128 == 0)


def gqa_attend(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
               window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence causal attention (prefill)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    if _use_flash(cfg, s, window, x.device):
        out = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), True,
            cfg.n_heads // cfg.n_kv_heads).transpose(1, 2)
    else:
        mask = causal_mask(s, window, x.device)[None]
        out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return linear(p["wo"], out.reshape(b, s, -1)), {"k": k, "v": v}


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor, window: int = 0
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x [B,1,D]; pos [B] current index into the cache.

    The new key and value are added at `pos` as the reference adds them
    (a one-hot update onto the zeroed slot), into new cache tensors; a
    position past the cache writes nothing."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, cfg, x, pos[:, None])
    s_max = cache["k"].shape[1]
    j = torch.arange(s_max, device=x.device)
    onehot = (j[None, :] == pos[:, None]).to(cache["k"].dtype)[:, :, None,
                                                               None]
    k = cache["k"] + onehot * k_new.to(cache["k"].dtype)
    v = cache["v"] + onehot * v_new.to(cache["v"].dtype)
    mask = j[None, None, :] <= pos[:, None, None]
    if window:
        mask &= (pos[:, None, None] - j[None, None, :]) < window
    out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    return linear(p["wo"], out.reshape(b, 1, -1)), {"k": k, "v": v}


def gqa_empty_cache(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                    device=None) -> Dict:
    shp = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}
