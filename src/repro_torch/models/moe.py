"""Mixture-of-Experts FFN with capacity-based sort dispatch (port of
`repro.models.moe`).

Static-shape routing in the Megablocks/MaxText style:

  1. router logits [T, E] -> top-k (weights renormalised over the k)
  2. flatten the (token, expert) assignments, sort them by expert id
  3. rank in expert = position - the expert's start in the sorted order
  4. assignments ranked at or past the capacity are DROPPED
  5. scatter the tokens into [E, C, D] buffers, run the E expert SwiGLUs
     as batched products over every slot of every buffer, and combine
     back with the routing weights.

Dispatches (cfg.moe_dispatch), each over G groups of T tokens:

  * "grouped": a group per batch row (G = B, T = S), the reference's
    GShard-style dispatch.  It runs only when S > 1.
  * "global": one group of all B*S tokens; every decode step (S == 1)
    takes it, as in the reference.
  * "ep": the reference's `_ep_shard_map`, expert parallelism over the
    mesh's `model` axis.  The port has no mesh yet (ROADMAP Queue 1
    item 12, the sharding bullet), so "ep" resolves to "grouped", as the
    reference resolves it off a mesh.

Numerics that the reference fixes and the port keeps: top-k is k passes
of argmax (first index on ties, not `torch.topk`); the expert sort is
stable; the router's kernel stays float32 and is cast to the
activations' dtype for its product; each token's k expert outputs are
added in the reference's order (ascending expert id, from the sorted
order), one at a time, so the combine is deterministic on the card
(no atomics).  Every expert runs over its whole capacity buffer, empty
slots included, as in the reference: a batch-4 decode step reads every
expert's weights.

Initialisation: each routed expert's [d, f] matrix is drawn from its own
CPU generator whose seed comes from the layer's generator in expert
order (`ExpertBank`), so the draws can run in threads and give the same
weights on every machine and at every thread count.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import Params, dense, dense_init, linear, \
    linear_init, silu


@dataclasses.dataclass(frozen=True)
class ExpertBank:
    """A routed-expert weight bank [E, d_in, d_out] still to be drawn:
    expert e is `randn(d_in, d_out) / sqrt(d_in)` from a CPU generator
    seeded with seeds[e], in `dtype` (the reference's He-scaled bank)."""

    seeds: Tuple[int, ...]
    d_in: int
    d_out: int
    dtype: torch.dtype

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.seeds), self.d_in, self.d_out)

    def expert(self, e: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(self.seeds[e])
        w = torch.randn(self.d_in, self.d_out, generator=gen)
        return w.div_(math.sqrt(self.d_in)).to(self.dtype)

    def draw_into(self, out: torch.Tensor,
                  threads: Optional[int] = None) -> torch.Tensor:
        """Every expert drawn straight into `out` [E, d_in, d_out] (on any
        device), `threads` at a time (default: one per core this process
        may run on)."""
        if tuple(out.shape) != self.shape or out.dtype != self.dtype:
            raise ValueError(f"bank {self.shape} {self.dtype} into "
                             f"{tuple(out.shape)} {out.dtype}")
        n = max(1, min(threads or len(os.sched_getaffinity(0)),
                       len(self.seeds)))

        def one(e: int) -> None:
            out[e].copy_(self.expert(e))
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            for f in [pool.submit(one, e) for e in range(len(self.seeds))]:
                f.result()
        return out


def _bank(gen: torch.Generator, e: int, d_in: int, d_out: int,
          dtype) -> ExpertBank:
    seeds = torch.randint(0, 2 ** 62, (e,), generator=gen).tolist()
    return ExpertBank(tuple(seeds), d_in, d_out, dtype)


def moe_init(gen: torch.Generator, cfg, *, dtype=torch.float32) -> Params:
    """Router (float32, whatever `dtype`), expert banks `gate`/`up`
    [E, d, f] and `down` [E, f, d] as `ExpertBank`s, and the shared
    experts' SwiGLU."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    bl = cfg.bitlinear in ("ffn", "all")
    p: Params = {
        "router": dense_init(gen, d, e, dtype=torch.float32),
        "gate": _bank(gen, e, d, f, dtype),
        "up": _bank(gen, e, d, f, dtype),
        "down": _bank(gen, e, f, d, dtype),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = {
            "gate": linear_init(gen, d, fs, dtype=dtype, bitlinear_on=bl),
            "up": linear_init(gen, d, fs, dtype=dtype, bitlinear_on=bl),
            "down": linear_init(gen, fs, d, dtype=dtype, bitlinear_on=bl),
        }
    return p


def _capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor of 8


def _topk_local(probs: torch.Tensor, k: int):
    """top-k as k passes of argmax, each masking its pick to -inf: the
    reference's tie-breaking (first index) and gradient flow."""
    ws, idxs = [], []
    pcur = probs
    for _ in range(k):
        i = pcur.argmax(-1, keepdim=True)
        ws.append(pcur.gather(-1, i)[..., 0])
        idxs.append(i[..., 0])
        pcur = pcur.scatter(-1, i, float("-inf"))
    return torch.stack(ws, -1), torch.stack(idxs, -1)


def _route(p: Params, cfg, x: torch.Tensor):
    """x [..., D] -> (top_w, top_e [..., k], aux losses)."""
    e, k = cfg.n_experts, cfg.top_k
    t = x[..., 0].numel()
    logits = dense(p["router"], x).to(torch.float32)          # [..., E]
    probs = torch.softmax(logits, -1)
    top_w, top_e = _topk_local(probs, k)                      # [..., k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load balance and the router z-loss
    me = probs.mean(tuple(range(logits.dim() - 1)))           # [E]
    ce = torch.bincount(top_e.reshape(-1), minlength=e).to(
        torch.float32) / (t * k)
    aux_lb = e * (me * ce).sum()
    aux_z = torch.logsumexp(logits, -1).square().mean()
    return top_w, top_e, {"load_balance": aux_lb, "router_z": aux_z}


def _sort_dispatch(cfg, xt: torch.Tensor, top_e: torch.Tensor,
                   top_w: torch.Tensor, cap: int):
    """Sort and scatter each group's T tokens into [E, cap, D] buffers.

    xt [G, T, D]; top_e, top_w [G, T, k] -> (expert_in [G, E, cap, D],
    ctx = (slot, st_, sw, keep, order), each [G, T*k]).  A kept
    assignment writes its own slot; the dropped ones all go to a last
    bucket, which is cut off."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dev = xt.device
    flat_e = top_e.reshape(g, t * k)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k).expand(g, -1)
    flat_w = top_w.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)
    st_ = flat_t.gather(1, order)
    sw = flat_w.gather(1, order)
    experts = torch.arange(e, device=dev).expand(g, -1).contiguous()
    starts = torch.searchsorted(se.contiguous(), experts)     # [G, E]
    rank = torch.arange(t * k, device=dev) - starts.gather(1, se)
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)
    rows = torch.arange(g, device=dev)[:, None]
    buf = xt.new_zeros(g, e * cap + 1, d)
    buf[rows, slot] = xt[rows, st_]
    return (buf[:, :-1].reshape(g, e, cap, d),
            (slot, st_, sw, keep, order))


def _combine(cfg, expert_out: torch.Tensor, ctx, t: int) -> torch.Tensor:
    """The inverse of `_sort_dispatch`: [G, E, cap, D] -> [G, T, D].

    Each token's k weighted outputs are added one at a time in the
    order the reference's scatter-add visits them (their places in the
    expert-sorted order), so the sum rounds as the reference's does and
    the same on every run."""
    slot, st_, sw, keep, order = ctx
    g, e, cap, d = expert_out.shape
    rows = torch.arange(g, device=expert_out.device)[:, None]
    flat = expert_out.reshape(g, e * cap, d)
    gathered = torch.where(keep[..., None],
                           flat[rows, slot.clamp_max(e * cap - 1)],
                           expert_out.new_zeros(()))
    contrib = gathered * sw[..., None].to(expert_out.dtype)   # sorted order
    # where each (token, j) assignment sits in the sorted order, each
    # token's k places ascending
    place = torch.argsort(order, dim=-1).reshape(g, t, -1).sort(-1).values
    y = contrib[rows, place[..., 0]]
    for j in range(1, place.shape[-1]):
        y = y + contrib[rows, place[..., j]]
    return y


def _expert_mlps(p: Params, x_dtype, expert_in: torch.Tensor
                 ) -> torch.Tensor:
    """[..., E, C, D] -> [..., E, C, D] through the E expert SwiGLUs."""
    g = torch.einsum("...ecd,edf->...ecf", expert_in, p["gate"].to(x_dtype))
    u = torch.einsum("...ecd,edf->...ecf", expert_in, p["up"].to(x_dtype))
    h = silu(g) * u
    return torch.einsum("...ecf,efd->...ecd", h, p["down"].to(x_dtype))


def dispatch_mode(cfg, s: int) -> str:
    """"grouped" or "global" for a sequence of s tokens: "ep" needs a
    mesh, which the port does not have, so it resolves to "grouped"; a
    grouped dispatch needs s > 1."""
    mode = getattr(cfg, "moe_dispatch", "ep")
    if mode == "ep":
        mode = "grouped"
    return "grouped" if mode == "grouped" and s > 1 else "global"


def moe_ffn(p: Params, cfg, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], aux losses)."""
    b, s, d = x.shape
    if dispatch_mode(cfg, s) == "grouped":
        xg = x                                  # a group per batch row
        top_w, top_e, aux = _route(p, cfg, x)
    else:
        xg = x.reshape(1, b * s, d)             # one group of B*S tokens
        top_w, top_e, aux = _route(p, cfg, x.reshape(b * s, d))
        top_w, top_e = top_w[None], top_e[None]
    t = xg.shape[1]
    expert_in, ctx = _sort_dispatch(cfg, xg, top_e, top_w,
                                    _capacity(t, cfg))
    expert_out = _expert_mlps(p, x.dtype, expert_in)
    y = _combine(cfg, expert_out, ctx, t).reshape(b, s, d)
    if "shared" in p:
        sh = p["shared"]
        y = y + linear(sh["down"],
                       silu(linear(sh["gate"], x)) * linear(sh["up"], x))
    return y, aux
