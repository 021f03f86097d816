"""Model trunk for the dense family (port of `repro.models.transformer`).

Public interface (functions of (params, cfg, ...)):

  init_params(seed, cfg, device=)              -> params
  train_loss(params, cfg, batch)               -> (loss, metrics)
  prefill(params, cfg, batch)                  -> (logits_last, caches)
  decode_step(params, cfg, tokens, caches, pos) -> (logits, caches)
  empty_caches(cfg, batch, s_max, device=)     -> caches
  lm_from_jax(params, cfg, device=)            -> params

Layers are stacked ([L, ...] leaves, as the reference stacks them for
`lax.scan`) and driven by a Python loop over layers.  Nothing is traced,
so one decode loop serves every route: `decode_step_eager`, the
reference's untraced twin of its scanned `decode_step` for the DRIM
engines, is the same function here.  For training, `cfg.remat` wraps
each layer in `torch.utils.checkpoint` (the reference wraps its scan
body in `jax.checkpoint`): the backward runs each layer's forward again,
so a step runs the flash forward kernel twice per layer.  The
reference's other families (MoE, SSM, hybrid, audio, vlm) come later
(ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models.layers import Params, rmsnorm, rmsnorm_init
from repro_torch.tree import tree_map, tree_slice, tree_stack, tree_unstack

LB_COEF, Z_COEF = 0.01, 1e-3


def _dense_only(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: "
            "ROADMAP Queue 1 item 12")


def padded_vocab(cfg) -> int:
    """Embedding/head vocab dim rounded up to cfg.vocab_pad_multiple; the
    logical vocab stays cfg.vocab_size and `_logits` masks the pad."""
    m = getattr(cfg, "vocab_pad_multiple", 1) or 1
    return -(-cfg.vocab_size // m) * m


# --- init --------------------------------------------------------------------

def init_params(seed, cfg, *, device=None) -> Params:
    """Seeded parameters (an int seed or a `torch.Generator`), drawn on
    the CPU so a seed gives the same weights on every machine, then moved
    to `device` (None: the card)."""
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    dtype = getattr(torch, cfg.param_dtype)
    v, d = padded_vocab(cfg), cfg.d_model
    p: Params = {
        "embed": (torch.randn(v, d, generator=gen) * 0.01).to(dtype),
        "final_norm": rmsnorm_init(d),
        "head": (torch.randn(d, v, generator=gen) * 0.01).to(dtype),
        "layers": tree_stack([B.dense_block_init(gen, cfg, dtype=dtype)
                              for _ in range(cfg.n_layers)]),
    }
    return tree_map(lambda t: t.to(dev), p)


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    """A numpy leaf of the reference as a tensor of the same dtype:
    bfloat16 keeps its bits, uint32 words become int32 bit patterns."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def lm_from_jax(params, cfg, *, device=None) -> Params:
    """The reference's stacked [L, ...] parameter tree (numpy arrays, as
    `jax.tree.map(np.asarray, params)` gives them) as the port's, each
    leaf keeping its dtype."""
    _dense_only(cfg)
    dev = resolve_device(device)
    out = tree_map(lambda a: _to_torch(np.asarray(a), dev), params)
    embed = tuple(out["embed"].shape)
    if embed != (padded_vocab(cfg), cfg.d_model):
        raise ValueError(f"embed {embed} does not match the config's "
                         f"({padded_vocab(cfg)}, {cfg.d_model})")
    depth = out["layers"]["attn_norm"]["scale"].shape[0]
    if depth != cfg.n_layers:
        raise ValueError(f"{depth} stacked layers, the config has "
                         f"{cfg.n_layers}")
    return out


# --- embedding / head --------------------------------------------------------

def _embed(p, cfg, tokens: torch.Tensor) -> torch.Tensor:
    return p["embed"][tokens.long()].to(cfg.activation_dtype)


def _logits(p, cfg, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(p["final_norm"], x)
    logits = (x @ p["head"].to(x.dtype)).to(torch.float32)
    v_pad = p["head"].shape[-1]
    if v_pad != cfg.vocab_size:          # mask the pad columns
        col = torch.arange(v_pad, device=x.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits


# --- full-sequence forward (train / prefill) ---------------------------------

def _layer(layer_p, cfg, x, positions):
    return B.dense_block(layer_p, cfg, x, positions)[0]


def _forward_full(p, cfg, batch: Dict[str, Any], *, with_cache: bool):
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :] \
        .expand(bsz, s)
    x = _embed(p, cfg, tokens)
    aux = {k: torch.tensor(v, device=x.device)
           for k, v in B.ZERO_AUX.items()}
    remat = cfg.remat and not with_cache and torch.is_grad_enabled()
    caches = []
    for layer_p in tree_unstack(p["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer, layer_p, cfg, x, positions,
                           use_reentrant=False)
        else:
            x, cache = B.dense_block(layer_p, cfg, x, positions)
            caches.append(cache)
    return x, aux, (tree_stack(caches) if with_cache else None)


# --- train loss --------------------------------------------------------------

def train_loss(params, cfg, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch {"tokens", "labels": [B, S]} -> (loss, metrics): the mean
    cross-entropy over labels >= 0 plus the auxiliary losses, with the
    reference's metrics (ce, aux_lb, aux_z, ntokens)."""
    x, aux, _ = _forward_full(params, cfg, batch, with_cache=False)
    logits = _logits(params, cfg, x)                       # [B,S,V] f32
    labels = batch["labels"].long()
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp_min(0)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    ce = ((lse - ll) * mask).sum() / mask.sum().clamp_min(1.0)
    loss = ce + LB_COEF * aux["load_balance"] + Z_COEF * aux["router_z"]
    return loss, {"ce": ce, "aux_lb": aux["load_balance"],
                  "aux_z": aux["router_z"], "ntokens": mask.sum()}


# --- prefill -----------------------------------------------------------------

def prefill(params, cfg, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
    """batch {"tokens": [B, S]} -> (logits of the last position [B, 1, V]
    float32, caches stacked [L, B, S, Hkv, Dh])."""
    x, _, caches = _forward_full(params, cfg, batch, with_cache=True)
    return _logits(params, cfg, x[:, -1:, :]), caches


# --- decode ------------------------------------------------------------------

def decode_step(params, cfg, tokens: torch.Tensor, caches, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Any]:
    """tokens [B, 1]; pos [B] write index -> (logits [B, 1, V] float32,
    new caches).  Inside a `layers.serving_engine` scope the BitLinear
    GEMMs run on the DRIM fleet."""
    x = _embed(params, cfg, tokens)
    new_caches = []
    for i in range(cfg.n_layers):
        x, nc = B.dense_block_decode(tree_slice(params["layers"], i), cfg, x,
                                     tree_slice(caches, i), pos)
        new_caches.append(nc)
    return _logits(params, cfg, x), tree_stack(new_caches)


decode_step_eager = decode_step


# --- cache constructors ------------------------------------------------------

def empty_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                 device=None):
    """Zeroed decode caches stacked [L, batch, s_max, Hkv, Dh] (prefill
    produces the same layout)."""
    dev = resolve_device(device)
    one = attn_mod.gqa_empty_cache(cfg, batch, s_max, dtype, dev)
    return tree_map(lambda t: t[None].expand(cfg.n_layers, *t.shape)
                    .contiguous(), one)
