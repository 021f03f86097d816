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
    ambient mesh's `model` axis (`with mesh:`).  It applies where the
    reference's `_ep_applicable` does: a mesh with a `model` axis that
    divides the experts, DP axes that divide the batch, and S > 1.
    Otherwise it falls back to "grouped" (and S == 1 to "global"), as in
    the reference.  Model shard i holds experts [i*E_loc, (i+1)*E_loc)
    and builds only its own dispatch slab; each (data, model) block runs
    in turn on its mesh device, and the partial outputs are summed in
    model-index order.  With one model shard it is the grouped dispatch
    bit for bit.  Over a model axis of ranks (a process each) the
    banks are cut by the specs and each rank runs only its own block
    (`_rank_ep`), at every dispatch, decode included (`moe_ffn`).

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

import numpy as np
import torch

from repro_torch.core.mesh import ambient_mesh, ambient_ranks, axis_size, \
    copy_to_model, dp_axes, gather_from_model, mesh_sum, model_coord, \
    model_ranks, scatter_to_model, sequence_ranks
from repro_torch.models.layers import SEQ_DIM, Params, dense, dense_init, \
    linear_init, mlp, row_sum, silu


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

    def draw_into(self, out: torch.Tensor, threads: Optional[int] = None,
                  block: Optional[Tuple[slice, slice, slice]] = None
                  ) -> torch.Tensor:
        """Every expert drawn straight into `out` [E, d_in, d_out] (on any
        device), `threads` at a time (default: one per core this process
        may run on).  `block` (slices of [E, d_in, d_out]) draws only the
        experts of its first slice, each cut to the other two, into `out`
        of the block's shape: a rank's block of the bank, whose weights
        are the whole bank's."""
        es, rows, cols = block or (slice(None),) * 3
        experts = range(len(self.seeds))[es]
        shape = (len(experts), len(range(self.d_in)[rows]),
                 len(range(self.d_out)[cols]))
        if tuple(out.shape) != shape or out.dtype != self.dtype:
            raise ValueError(f"bank {self.shape} {self.dtype} block "
                             f"{shape} into {tuple(out.shape)} {out.dtype}")
        n = max(1, min(threads or len(os.sched_getaffinity(0)),
                       len(experts)))

        def one(j: int, e: int) -> None:
            out[j].copy_(self.expert(e)[rows, cols])
        with concurrent.futures.ThreadPoolExecutor(n) as pool:
            for f in [pool.submit(one, j, e)
                      for j, e in enumerate(experts)]:
                f.result()
        return out


def _bank(gen: torch.Generator, e: int, d_in: int, d_out: int,
          dtype) -> ExpertBank:
    seeds = torch.randint(0, 2 ** 62, (e,), generator=gen)
    # an abstract init (on the meta device) draws no seed: only the
    # bank's shape is read
    return ExpertBank(tuple([0] * e if seeds.is_meta else seeds.tolist()),
                      d_in, d_out, dtype)


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


def _expert_counts(top_e: torch.Tensor, e: int) -> torch.Tensor:
    """Assignments per expert [E] (int64), from the sorted choices: exact,
    so equal to the reference's float32 scatter-add of ones below 2**24,
    deterministic on the card, and shape-only on the meta device, where
    `torch.bincount`'s data-dependent length cannot run."""
    flat = top_e.reshape(-1).sort().values
    experts = torch.arange(e, device=top_e.device)
    return (torch.searchsorted(flat, experts, right=True)
            - torch.searchsorted(flat, experts))


def _route(p: Params, cfg, x: torch.Tensor):
    """x [..., D] -> (top_w, top_e [..., k], aux losses).

    Inside a data-parallel step over ranks (`core.mesh.ambient_ranks`)
    the aux losses are this rank's share of the global batch's: the
    expert counts are summed over the data ranks (they carry no
    gradient), and the mean router probability and the z-loss's mean are
    over the global batch's tokens.  The load balance is linear in the
    mean probability once the counts are global, so the ranks' shares sum
    to the global value and their gradients to its gradient, each rank's
    tokens counted once."""
    e, k = cfg.n_experts, cfg.top_k
    t = x[..., 0].numel()
    logits = dense(p["router"], x).to(torch.float32)          # [..., E]
    probs = torch.softmax(logits, -1)
    top_w, top_e = _topk_local(probs, k)                      # [..., k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch load balance and the router z-loss
    me = probs.mean(tuple(range(logits.dim() - 1)))           # [E]
    counts = _expert_counts(top_e, e)
    aux_z = torch.logsumexp(logits, -1).square().mean()
    ranks = ambient_ranks()
    if ranks is not None:
        n = axis_size(ranks, dp_axes(ranks))
        counts = mesh_sum([counts], ranks)[0]
        me, aux_z, t = me / n, aux_z / n, t * n
    ce = counts.to(torch.float32) / (t * k)
    aux_lb = e * (me * ce).sum()
    return top_w, top_e, {"load_balance": aux_lb, "router_z": aux_z}


def _sort_dispatch(cfg, xt: torch.Tensor, top_e: torch.Tensor,
                   top_w: torch.Tensor, cap: int, lo: int = 0,
                   e_loc: Optional[int] = None):
    """Sort and scatter each group's T tokens into [E_loc, cap, D]
    buffers, for the experts [lo, lo + E_loc) (default: all E).

    xt [G, T, D]; top_e, top_w [G, T, k] -> (expert_in [G, E_loc, cap,
    D], ctx = (slot, st_, sw, keep, order), each [G, T*k]).  Ranks are
    taken over all E experts' sorted order; an assignment is kept when
    its rank is under the capacity and its expert in the range (the
    reference's expert-parallel `keep`), and writes its own slot; the
    others all go to a last bucket, which is cut off."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e if e_loc is None else e_loc
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
    if e_loc != e:
        keep = keep & (se >= lo) & (se < lo + e_loc)
    slot = torch.where(keep, (se - lo) * cap + rank, e_loc * cap)
    rows = torch.arange(g, device=dev)[:, None]
    buf = xt.new_zeros(g, e_loc * cap + 1, d)
    buf[rows, slot] = xt[rows, st_]
    return (buf[:, :-1].reshape(g, e_loc, cap, d),
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


def _ep_applicable(cfg, mesh, b: int, s: int) -> bool:
    if mesh is None or s <= 1 or "model" not in mesh.axis_names:
        return False
    return (cfg.n_experts % mesh.shape["model"] == 0) \
        and (b % axis_size(mesh, dp_axes(mesh)) == 0)


def _ep_shard_map(p: Params, cfg, x: torch.Tensor, top_e: torch.Tensor,
                  top_w: torch.Tensor, mesh) -> torch.Tensor:
    """Expert parallelism over `mesh` (the reference's shard_map block).

    Model shard i holds E_loc = E / |model| experts, [i*E_loc,
    (i+1)*E_loc), as views of the banks (no copy).  The DP axes cut the
    batch into |dp| row blocks.  Each (data, model) block runs in turn on
    its mesh device: it builds only its own [B_loc, E_loc, C, D] dispatch
    slab (the grouped sort, kept where the rank is under the capacity and
    the expert is the shard's), runs its expert SwiGLUs and combines a
    partial [B_loc, S, D] in which tokens routed elsewhere add zero.  The
    reference's psum over `model` is the partials summed in model-index
    order, so the sum is the same on every run.  Its sequence-parallel
    entry (an all-gather of x over `model`) and exit (a psum_scatter
    along S) are identities on the whole tensor in one process.  With
    one model shard the slab, the expert products and the combine are
    the grouped dispatch's, bit for bit."""
    b, s, d = x.shape
    n_model = mesh.shape["model"]
    e_loc = cfg.n_experts // n_model
    cap = _capacity(s, cfg)
    n_dp = axis_size(mesh, dp_axes(mesh))
    b_loc = b // n_dp
    # mesh devices as [data position, model index], the DP axes in mesh
    # order; an axis that is neither replicates the block (its first
    # position runs it)
    axes = ("pod", "data", "model")
    grid = mesh.devices[tuple(slice(None) if a in axes else 0
                              for a in mesh.axis_names)]
    names = [a for a in mesh.axis_names if a in axes]
    devices = np.moveaxis(grid, names.index("model"), -1).reshape(
        n_dp, n_model)
    home = x.device
    rows = []
    for j in range(n_dp):
        blk = slice(j * b_loc, (j + 1) * b_loc)
        y = None
        for i in range(n_model):
            dev = devices[j, i]
            lo = i * e_loc
            banks = {name: p[name][lo:lo + e_loc].to(dev)
                     for name in ("gate", "up", "down")}
            x_l = x[blk].to(dev)
            expert_in, ctx = _sort_dispatch(
                cfg, x_l, top_e[blk].to(dev), top_w[blk].to(dev), cap,
                lo=lo, e_loc=e_loc)
            out = _expert_mlps(banks, x.dtype, expert_in)
            part = _combine(cfg, out, ctx, s).to(home)
            y = part if y is None else y + part
        rows.append(y)
    return rows[0] if n_dp == 1 else torch.cat(rows, 0)


def _rank_ep(p: Params, cfg, xg: torch.Tensor, top_e: torch.Tensor,
             top_w: torch.Tensor, cap: int, mesh, shape) -> torch.Tensor:
    """Expert parallelism over the model group of ranks (the reference's
    `_ep_shard_map` body on this rank alone).  `p`'s banks are this
    rank's block, experts [i*E_loc, (i+1)*E_loc) of model index i; xg
    [G, T, D] and top_w come through `copy_to_model`.  The rank builds
    only its own [G, E_loc, cap, D] slab (`_sort_dispatch` with its
    range), runs its expert SwiGLUs and combines a partial [G, T, D] in
    which tokens routed elsewhere add zero; the partials, as [B, S, D]
    (`shape`), are summed over the model group in float32 and rounded
    once to x's dtype (`layers.row_sum`: at two ranks the one-process sum
    of two float32 partials, bit for bit; inside a sequence cut the
    rank's block of S)."""
    index, m = model_coord(mesh)
    e_loc = p["gate"].shape[0]
    if e_loc * m != cfg.n_experts:
        raise ValueError(f"a bank block of {e_loc} experts is not a cut "
                         f"of {cfg.n_experts} over {m} ranks")
    expert_in, ctx = _sort_dispatch(cfg, xg, top_e, top_w, cap,
                                    lo=index * e_loc, e_loc=e_loc)
    part = _combine(cfg, _expert_mlps(p, xg.dtype, expert_in), ctx,
                    xg.shape[1])
    return row_sum(part.reshape(shape), mesh, part.dtype)


def dispatch_mode(cfg, s: int, b: int = 1) -> str:
    """"ep", "grouped" or "global" for a batch of b sequences of s tokens
    (over ranks: this rank's b rows): "ep" needs the ambient mesh to pass
    `_ep_applicable` (over ranks with a model axis of several, for the
    global batch), else it falls back to "grouped", and a grouped
    dispatch needs s > 1.  Over data ranks alone each process holds its
    own rows and the model axis is 1: "grouped", EP with one model shard
    bit for bit."""
    mode = getattr(cfg, "moe_dispatch", "ep")
    if mode == "ep":
        mesh = ambient_mesh()
        if mesh is not None and mesh.ranks is None \
                and _ep_applicable(cfg, mesh, b, s):
            return "ep"
        if mesh is not None and mesh.ranks is not None \
                and mesh.shape.get("model", 1) > 1 and _ep_applicable(
                    cfg, mesh, b * axis_size(mesh, dp_axes(mesh)), s):
            return "ep"
        mode = "grouped"
    return "grouped" if mode == "grouped" and s > 1 else "global"


def moe_ffn(p: Params, cfg, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, D] -> (y [B, S, D], aux losses).

    Under a model axis over ranks (`core.mesh.model_ranks`) whose specs
    cut the expert banks (E divisible by |model|), every dispatch runs
    expert-parallel over the model group (`_rank_ep`): "ep" and
    "grouped" a group per row, "global" (every decode step) one group of
    the rank's B*S tokens, each rank keeping its experts' assignments.
    The router, `_route` and the aux losses run whole on every rank, on
    x as it comes: their gradients are whole there already.  x (the
    dispatch's input) and top_w (the combine's weights) pass
    `copy_to_model`, so the ranks' parts of their gradients are summed.
    A bank the specs leave whole runs the plain dispatch on every rank,
    with no sum.  The shared experts are column- (gate, up) and
    row-parallel (down).  The partials are summed over the group in
    float32 (`layers.row_sum`), the experts' and the shared experts' in
    two calls.

    Inside a `core.mesh.sequence_cut` (the reference's sequence-parallel
    entry) x is this rank's block of the sequence [B, S / |model|, D]:
    it is gathered whole first (`gather_from_model`: the gradient of the
    whole is complete on every rank, as above, and the rank keeps its
    block), routed and dispatched on the whole, and y is the rank's
    block: each sum a reduce-scatter (the reference's psum_scatter), a
    whole y that every rank computes alike cut to the block.  The
    reference routes each rank's block; the values are the same."""
    tp = model_ranks()
    cut = tp is not None and sequence_ranks() is not None
    if cut:
        x = gather_from_model(x, tp, SEQ_DIM)
    b, s, d = x.shape
    mode = dispatch_mode(cfg, s, b)
    split = tp is not None and p["gate"].shape[0] != cfg.n_experts
    xc = x if tp is None else copy_to_model(x, tp)
    xd = xc if split else x                     # the dispatch's input
    if mode == "global":
        xg = xd.reshape(1, b * s, d)            # one group of B*S tokens
        top_w, top_e, aux = _route(p, cfg, x.reshape(b * s, d))
        top_w, top_e = top_w[None], top_e[None]
    else:
        xg = xd                                 # a group per batch row
        top_w, top_e, aux = _route(p, cfg, x)
    t = xg.shape[1]
    if split:
        y = _rank_ep(p, cfg, xg, top_e, copy_to_model(top_w, tp),
                     _capacity(t, cfg), tp, (b, s, d))
    elif mode == "ep":
        y = _ep_shard_map(p, cfg, x, top_e, top_w, ambient_mesh())
    else:
        expert_in, ctx = _sort_dispatch(cfg, xg, top_e, top_w,
                                        _capacity(t, cfg))
        expert_out = _expert_mlps(p, x.dtype, expert_in)
        y = _combine(cfg, expert_out, ctx, t).reshape(b, s, d)
    if cut and not split:
        y = scatter_to_model(y, tp, SEQ_DIM)
    if "shared" in p:
        y = y + mlp(p["shared"], xc, cfg.moe_d_ff * cfg.n_shared_experts)
    return y, aux
