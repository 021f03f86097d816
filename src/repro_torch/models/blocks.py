"""Decoder and encoder blocks with pre-norm residuals (port of
`repro.models.blocks`).

A block is (init, apply_full, apply_decode): apply_full runs prefill over
the full sequence and returns (x, cache, aux), apply_decode consumes the
cache for one-token serving and returns (x, cache).  Families:

  dense / audio encoder : GQA attention (causal, or bidirectional in the
                          encoder) + SwiGLU MLP
  moe                   : GQA or MLA attention (cfg.mla) + MoE FFN
  ssm                   : the Mamba2 mixer only
  audio decoder (xdec)  : causal self-attention + cross-attention over
                          the encoder's output + SwiGLU MLP

The zamba2 hybrid's shared block is a dense block applied at every site,
assembled in `transformer.py`.  Under a `model` axis over ranks
(`core.mesh.model_ranks`) the dense block is Megatron's: each sublayer's
normed input passes `copy_to_model` before its column-parallel products,
and its row-parallel product (`wo`, `down`) ends in the sum over the
model group.  The moe block runs its attention on the rank's heads (GQA
as the dense block's, MLA with its latent whole on every rank) and its
FFN expert-parallel over the group (`moe.moe_ffn`).

`seq_cut` is the reference's `_sp` (Megatron's sequence parallelism,
`cfg.seq_parallel`): x is this rank's block of a residual cut over the
sequence, and so is the block's result.  The dense and moe blocks run
inside `core.mesh.sequence_cut`: each sublayer's rmsnorm and residual add
run on the block, the normed block is gathered in place of
`copy_to_model` (`gather_from_sequence`, whose backward reduce-scatters
the ranks' partial gradients; MLA's and the MoE FFN's with
`gather_from_model`, since their whole-on-every-rank down-projections
and router already complete the gradient), and each row-parallel
product ends in a reduce-scatter to the block (`layers.row_sum`).  The
trunk cuts the dense, vlm and moe residuals and the audio encoder's
(`transformer._seq_block`); the hybrid's shared block and the audio
decoder block (xdec) keep the residual whole, as in the reference.  The
ssm block of the ssm family takes the rank's block too, its params
replicated; the hybrid's keeps the residual whole and runs its mixer on
cut params (`ssm.ssm_mix`).  The audio blocks are the dense block's
pieces on the same cut: the encoder's bidirectional attention on the
rank's heads, and in the decoder block (xdec) the self-attention, the
cross-attention over the rank's heads of every frame and the MLP, each
behind `_normed`.
`aux` holds the auxiliary losses a block adds to the training loss;
only the MoE block sets them (routing), the others return `ZERO_AUX`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

import contextlib

from repro_torch.core.mesh import (copy_to_model, gather_from_model,
                                   gather_from_sequence, model_ranks,
                                   sequence_cut, sequence_ranks)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import SEQ_DIM, Params, mlp, mlp_init, \
    rmsnorm, rmsnorm_init

# the auxiliary losses a block may add to the training loss (MoE routing)
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


# --- dense -------------------------------------------------------------------

def dense_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                     ) -> Params:
    bl = cfg.bitlinear in ("ffn", "all")
    return {"attn_norm": rmsnorm_init(cfg.d_model),
            "attn": attn.gqa_init(gen, cfg, dtype=dtype),
            "mlp_norm": rmsnorm_init(cfg.d_model),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            bitlinear_on=bl)}


def _normed(norm: Params, x):
    """rmsnorm(x), through `copy_to_model` under a model axis over ranks
    (the input of the sublayer's column-parallel products); inside a
    `sequence_cut`, the normed block gathered whole
    (`gather_from_sequence`)."""
    h = rmsnorm(norm, x)
    mesh = model_ranks()
    if mesh is None:
        return h
    if sequence_ranks() is not None:
        return gather_from_sequence(h, mesh, SEQ_DIM)
    return copy_to_model(h, mesh)


def _cut(seq_cut: bool):
    """`sequence_cut` over the model axis of ranks where `seq_cut`."""
    return sequence_cut(model_ranks()) if seq_cut \
        else contextlib.nullcontext()


def dense_block(p: Params, cfg, x, positions, *, window: int = 0,
                causal: bool = True, seq_cut: bool = False
                ) -> Tuple[torch.Tensor, Dict, Dict]:
    """`seq_cut`: x is this rank's block of a residual cut over the
    sequence (`positions` stay the whole sequence's)."""
    with _cut(seq_cut):
        if causal:
            a, cache = attn.gqa_attend(p["attn"], cfg,
                                       _normed(p["attn_norm"], x),
                                       positions, window)
        else:               # the encoder: full bidirectional attention
            a, cache = _bidir_attend(p["attn"], cfg,
                                     _normed(p["attn_norm"], x), positions)
        x = x + a
        x = x + mlp(p["mlp"], _normed(p["mlp_norm"], x), cfg.d_ff)
    return x, cache, ZERO_AUX


def _bidir_attend(p: Params, cfg, x, positions):
    """The encoder's attention over every position, on dense scores (the
    reference's: the encoder calls no Pallas kernel), on the rank's heads
    under a model axis over ranks."""
    b, s, _ = x.shape
    q, k, v = attn._qkv(p, cfg, x, positions)
    ks, vs, n_rep = attn._site_kv(cfg, k, v,
                                  attn._rank_heads(cfg, model_ranks()))
    mask = torch.ones(1, s, s, dtype=torch.bool, device=x.device)
    out = attn._sdpa(q, ks, vs, mask, n_rep)
    return attn._out(p, cfg, out.reshape(b, s, -1)), {"k": k, "v": v}


def dense_block_decode(p: Params, cfg, x, cache, pos, *, window: int = 0,
                       ctx_len: int = 0) -> Tuple[torch.Tensor, Dict]:
    """`ctx_len`: the cache's whole length, which a model axis over ranks
    needs to tell a sequence-cut cache from a whole one."""
    a, cache = attn.gqa_decode(p["attn"], cfg, _normed(p["attn_norm"], x),
                               cache, pos, window, ctx_len)
    x = x + a
    x = x + mlp(p["mlp"], _normed(p["mlp_norm"], x), cfg.d_ff)
    return x, cache


# --- moe ---------------------------------------------------------------------

def moe_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                   ) -> Params:
    a = (attn.mla_init(gen, cfg, dtype=dtype) if cfg.mla
         else attn.gqa_init(gen, cfg, dtype=dtype))
    return {"attn_norm": rmsnorm_init(cfg.d_model), "attn": a,
            "mlp_norm": rmsnorm_init(cfg.d_model),
            "moe": moe_mod.moe_init(gen, cfg, dtype=dtype)}


def _moe_attn_in(p: Params, cfg, x):
    """The attention's normed input: GQA's through `copy_to_model` under
    a model axis over ranks (`_normed`); MLA's as it is, since its
    down-projections are whole on every rank and the copy comes after
    them (`attention._mla_q`, `_mla_scores`), and so inside a
    `sequence_cut` gathered by `gather_from_model`: the gradient of the
    whole is complete on every rank, and the rank keeps its block's."""
    if not cfg.mla:
        return _normed(p["attn_norm"], x)
    h = rmsnorm(p["attn_norm"], x)
    mesh = sequence_ranks()
    return h if mesh is None else gather_from_model(h, mesh, SEQ_DIM)


def moe_block(p: Params, cfg, x, positions, *, window: int = 0,
              seq_cut: bool = False) -> Tuple[torch.Tensor, Dict, Dict]:
    """`seq_cut`: as `dense_block`'s; the MoE FFN gathers its normed
    block itself (`moe.moe_ffn`)."""
    at = attn.mla_attend if cfg.mla else attn.gqa_attend
    with _cut(seq_cut):
        a, cache = at(p["attn"], cfg, _moe_attn_in(p, cfg, x), positions,
                      window)
        x = x + a
        y, aux = moe_mod.moe_ffn(p["moe"], cfg, rmsnorm(p["mlp_norm"], x))
    return x + y, cache, aux


def moe_block_decode(p: Params, cfg, x, cache, pos, *, window: int = 0,
                     ctx_len: int = 0) -> Tuple[torch.Tensor, Dict]:
    """`ctx_len`: the cache's whole length (`dense_block_decode`)."""
    at = attn.mla_decode if cfg.mla else attn.gqa_decode
    a, cache = at(p["attn"], cfg, _moe_attn_in(p, cfg, x), cache, pos,
                  window, ctx_len)
    x = x + a
    y, _ = moe_mod.moe_ffn(p["moe"], cfg, rmsnorm(p["mlp_norm"], x))
    return x + y, cache


# --- ssm ---------------------------------------------------------------------

def ssm_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                   ) -> Params:
    return {"norm": rmsnorm_init(cfg.d_model),
            "mixer": ssm_mod.ssm_init(gen, cfg, dtype=dtype)}


def ssm_block(p: Params, cfg, x, positions=None, *, window: int = 0,
              seq_cut: bool = False) -> Tuple[torch.Tensor, Dict, Dict]:
    """`seq_cut`: x is this rank's block of a residual cut over the
    sequence (the ssm family under a model axis over ranks)."""
    y, cache = ssm_mod.ssm_mix(p["mixer"], cfg, rmsnorm(p["norm"], x),
                               seq_cut=seq_cut)
    return x + y, cache, ZERO_AUX


def ssm_block_decode(p: Params, cfg, x, cache, pos=None, *, window: int = 0,
                     ctx_len: int = 0) -> Tuple[torch.Tensor, Dict]:
    y, cache = ssm_mod.ssm_decode(p["mixer"], cfg, rmsnorm(p["norm"], x),
                                  cache)
    return x + y, cache


# --- the whisper decoder block (self + cross) --------------------------------

def xdec_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                    ) -> Params:
    return {"self_norm": rmsnorm_init(cfg.d_model),
            "self": attn.gqa_init(gen, cfg, dtype=dtype),
            "cross_norm": rmsnorm_init(cfg.d_model),
            "cross": attn.cross_init(gen, cfg, dtype=dtype),
            "mlp_norm": rmsnorm_init(cfg.d_model),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype)}


def xdec_block(p: Params, cfg, x, positions, enc, *, window: int = 0
               ) -> Tuple[torch.Tensor, Dict, Dict]:
    a, self_cache = attn.gqa_attend(p["self"], cfg,
                                    _normed(p["self_norm"], x), positions,
                                    window)
    x = x + a
    xkv = attn.cross_kv(p["cross"], cfg, enc)
    x = x + attn.cross_attend(p["cross"], cfg, _normed(p["cross_norm"], x),
                              xkv)
    x = x + mlp(p["mlp"], _normed(p["mlp_norm"], x), cfg.d_ff)
    return x, {"self": self_cache, "cross": xkv}, ZERO_AUX


def xdec_block_decode(p: Params, cfg, x, cache, pos, *, window: int = 0,
                      ctx_len: int = 0) -> Tuple[torch.Tensor, Dict]:
    """`ctx_len`: the self cache's whole length (`dense_block_decode`);
    the cross cache is the rank's heads of every frame."""
    a, self_cache = attn.gqa_decode(p["self"], cfg,
                                    _normed(p["self_norm"], x),
                                    cache["self"], pos, window, ctx_len)
    x = x + a
    x = x + attn.cross_attend(p["cross"], cfg, _normed(p["cross_norm"], x),
                              cache["cross"])
    x = x + mlp(p["mlp"], _normed(p["mlp_norm"], x), cfg.d_ff)
    return x, {"self": self_cache, "cross": cache["cross"]}
