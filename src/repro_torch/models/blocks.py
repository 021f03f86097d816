"""Decoder blocks with pre-norm residuals (port of the dense and SSM
blocks of `repro.models.blocks`).

A block is (init, apply_full, apply_decode): apply_full runs prefill over
the full sequence and returns its cache, apply_decode consumes the cache
for one-token serving.  Families: dense (GQA attention + SwiGLU MLP) and
ssm (the Mamba2 mixer only); the zamba2 hybrid's shared block is a dense
block applied at every site, assembled in `transformer.py`.  The
reference's `_sp` (a sequence-parallel sharding constraint on the
residual stream) is the identity on one card and has no counterpart; its
MoE and cross-attention blocks come with those families (ROADMAP Queue 1
item 12).  The reference's blocks return an auxiliary loss beside the
cache, which only its MoE block sets; the ported blocks return none, so
their trunks' auxiliary loss is `ZERO_AUX`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import Params, mlp, mlp_init, rmsnorm, \
    rmsnorm_init

# the auxiliary losses a block may add to the training loss (MoE routing)
ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}


def dense_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                     ) -> Params:
    bl = cfg.bitlinear in ("ffn", "all")
    return {"attn_norm": rmsnorm_init(cfg.d_model),
            "attn": attn.gqa_init(gen, cfg, dtype=dtype),
            "mlp_norm": rmsnorm_init(cfg.d_model),
            "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype,
                            bitlinear_on=bl)}


def dense_block(p: Params, cfg, x, positions, *, window: int = 0
                ) -> Tuple[torch.Tensor, Dict]:
    a, cache = attn.gqa_attend(p["attn"], cfg, rmsnorm(p["attn_norm"], x),
                               positions, window)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x))
    return x, cache


def dense_block_decode(p: Params, cfg, x, cache, pos, *, window: int = 0
                       ) -> Tuple[torch.Tensor, Dict]:
    a, cache = attn.gqa_decode(p["attn"], cfg, rmsnorm(p["attn_norm"], x),
                               cache, pos, window)
    x = x + a
    x = x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x))
    return x, cache


def ssm_block_init(gen: torch.Generator, cfg, *, dtype=torch.float32
                   ) -> Params:
    return {"norm": rmsnorm_init(cfg.d_model),
            "mixer": ssm_mod.ssm_init(gen, cfg, dtype=dtype)}


def ssm_block(p: Params, cfg, x, positions=None, *, window: int = 0
              ) -> Tuple[torch.Tensor, Dict]:
    y, cache = ssm_mod.ssm_mix(p["mixer"], cfg, rmsnorm(p["norm"], x))
    return x + y, cache


def ssm_block_decode(p: Params, cfg, x, cache, pos=None, *, window: int = 0
                     ) -> Tuple[torch.Tensor, Dict]:
    y, cache = ssm_mod.ssm_decode(p["mixer"], cfg, rmsnorm(p["norm"], x),
                                  cache)
    return x + y, cache
