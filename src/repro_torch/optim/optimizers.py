"""Optimizers built from scratch (port of `repro.optim.optimizers`):
AdamW, Adafactor, int8-Adam.

Each is an (init(params) -> state, update(grads, state, params, lr) ->
(new_params, state)) pair over the port's nested-dict trees
(`repro_torch.tree`), with the reference's state keys, so checkpoints and
tests line up:

  * adamw      : float32 moments {"m", "v", "step"}.
  * adafactor  : factored second moment {"f": {"vr", "vc"} per >=2-D
                 param (row and column statistics), else {"v"}, "step"};
                 `update_blocks` is the same update on a rank's blocks
                 of the leaves, its sums over the ranks the caller's.
  * adam8bit   : block-wise int8 moments with float32 per-block scales
                 {"q": {"mq", "ms", "vq", "vs"}, "step"}, over the
                 [n_blocks, 256] view of the zero-padded flattened leaf;
                 `update_blocks` is the same update on a rank's blocks of
                 that view, its maxima over the ranks the caller's, and
                 `init_blocks` its state at their shapes.

`update` runs under `torch.no_grad()` and returns new tensors; it
changes none of its arguments.  AdamW's `update(..., donate=True)` is
the reference trainer's donated state (`jax.jit(step_fn,
donate_argnums=(0,))`): the moments and params it is given are updated
in place, a leaf at a time (its clipped gradient made as it is used),
by the same operations in the same order (so to the same bits), and
returned, so an update holds one state, not two.  The
state's ZeRO-1 specs are `runtime.steps.train_state_pspecs`'s.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (new_params, state)
    # Adafactor's and adam8bit's update on blocks of the whole leaves (a
    # rank's)
    update_blocks: Optional[Callable] = None
    # adam8bit's init at a rank's block shapes
    init_blocks: Optional[Callable] = None


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


# --- AdamW -------------------------------------------------------------------

def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          grad_clip=1.0) -> Optimizer:
    def init(params):
        step = tree_leaves(params)[0].new_zeros((), dtype=torch.int32)
        return {"m": _zeros_f32(params), "v": _zeros_f32(params),
                "step": step}

    @torch.no_grad()
    def update(grads, state, params, lr, norm=None, donate=False):
        """`norm`: the whole gradient's global norm where `grads`,
        `state` and `params` are blocks of the whole leaves (a ZeRO-1
        rank's, `runtime.steps`): the update is elementwise given the
        clip's scale, which comes from `norm`.  `donate`: update the
        moments and params in place (one leaf at a time)."""
        step = state["step"] + 1
        bc1 = 1 - b1 ** _f32(step)
        bc2 = 1 - b2 ** _f32(step)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            u = u + weight_decay * _f32(p)
            return (_f32(p) - lr * u).to(p.dtype)
        if donate:
            # each leaf's clipped gradient made as it is used
            scale = _clip_scale(grads, grad_clip, norm)

            def in_place(p, m_, v_, g):
                if scale is not None:
                    g = _clipped(g, scale)
                m_.mul_(b1).add_((1 - b1) * _f32(g))
                v_.mul_(b2).add_((1 - b2) * torch.square(_f32(g)))
                return p.copy_(upd(p, m_, v_))
            new = tree_map(in_place, params, state["m"], state["v"], grads)
            return new, {"m": state["m"], "v": state["v"], "step": step}
        grads = clip_by_global_norm(grads, grad_clip, norm)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * _f32(g),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(_f32(g)),
                     state["v"], grads)
        return tree_map(upd, params, m, v), {"m": m, "v": v, "step": step}

    return Optimizer(init, update)


# --- Adafactor ---------------------------------------------------------------

def adafactor(eps=1e-30, clip_threshold=1.0, decay=0.8,
              weight_decay=0.0, min_dim_factored=128) -> Optimizer:
    """Factored second moments for >=2-D params (row and column float32
    vectors)."""

    def _factored(p):
        return p.dim() >= 2 and min(p.shape[-2:]) >= min_dim_factored

    def init(params):
        def one(p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        step = tree_leaves(params)[0].new_zeros((), dtype=torch.int32)
        return {"f": tree_map(one, params), "step": step}

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        beta = 1.0 - _f32(step) ** -decay

        def one(p, g, s):
            g = _f32(g)
            g2 = torch.square(g) + eps
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / vr.mean(-1, keepdim=True).clamp_min(eps)[..., None])
                u = g * torch.rsqrt(denom + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * _f32(p)
            return (_f32(p) - lr * u).to(p.dtype), ns

        out = _map_with_state(one, params, grads, state["f"])
        return out[0], {"f": out[1], "step": step}

    @torch.no_grad()
    def update_blocks(grads, state, params, lr, *, shapes, groups, psum):
        """`update` on blocks of the whole leaves (a rank's: `runtime.
        steps.rank_adafactor_update`): one process's values, in another
        float order.  `grads` and `params` hold each leaf's block, the
        state each block's entries ("vr" its rows, "vc" its columns, "v"
        the block), `shapes` the whole leaves (whose shapes decide
        `_factored` and the means' counts), `groups` each leaf's {"rows",
        "cols", "leaf"}: the keys of the groups of blocks that together
        hold its axis -2, its axis -1 and the whole leaf.  `psum(tensors,
        keys)` gives each tensor summed over its key's group, so the row
        and column means, the rows' mean in the denominator and the
        clip's RMS are the whole leaf's.  A leaf's `u` is made twice
        (for the RMS, then for the update), so that one block's is held
        at a time."""
        step = state["step"] + 1
        beta = 1.0 - _f32(step) ** -decay
        leaves = _leaf_rows(params, grads, state["f"], shapes, groups)
        fac = [_factored(w) for _, _, _, w, _ in leaves]
        parts, keys = [], []
        for (_, g, _, _, grp), f in zip(leaves, fac):
            if f:
                g2 = torch.square(_f32(g)) + eps
                parts += [g2.sum(-1), g2.sum(-2)]
                keys += [grp["cols"], grp["rows"]]
        sums = iter(psum(parts, keys))
        new = []
        for (_, g, s, w, _), f in zip(leaves, fac):
            if f:
                vr = beta * s["vr"] + (1 - beta) * (next(sums) / w.shape[-1])
                vc = beta * s["vc"] + (1 - beta) * (next(sums) / w.shape[-2])
                new.append({"vr": vr, "vc": vc})
            else:
                g2 = torch.square(_f32(g)) + eps
                new.append({"v": beta * s["v"] + (1 - beta) * g2})
        rows = iter(psum([ns["vr"].sum(-1, keepdim=True)
                          for ns, f in zip(new, fac) if f],
                         [leaf[4]["rows"]
                          for leaf, f in zip(leaves, fac) if f]))
        rmean = [(next(rows) / w.shape[-2]).clamp_min(eps)[..., None]
                 if f else None for (_, _, _, w, _), f in zip(leaves, fac)]

        def direction(g, ns, rm):
            g = _f32(g)
            if rm is None:
                return g * torch.rsqrt(ns["v"] + eps)
            denom = ns["vr"][..., None] * ns["vc"][..., None, :] / rm
            return g * torch.rsqrt(denom + eps)
        squares = psum([torch.sum(torch.square(direction(g, ns, rm)))
                        for (_, g, _, _, _), ns, rm in
                        zip(leaves, new, rmean)],
                       [leaf[4]["leaf"] for leaf in leaves])
        out = []
        for (p, g, _, w, _), ns, rm, sq in zip(leaves, new, rmean, squares):
            u = direction(g, ns, rm)
            rms = torch.sqrt(sq / math.prod(w.shape) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            if weight_decay:
                u = u + weight_decay * _f32(p)
            out.append(((_f32(p) - lr * u).to(p.dtype), ns))
        it = iter(out)
        new_p, new_f = _map_with_state(lambda *_: next(it), params, grads,
                                       state["f"])
        return new_p, {"f": new_f, "step": step}

    return Optimizer(init, update, update_blocks)


def _leaf_rows(params, *trees):
    """[(param, the matching entry of each tree)] over the param tree's
    leaves, in `_map_with_state`'s order; an entry may be a subtree (a
    leaf's state dict)."""
    if isinstance(params, dict):
        return [row for k in params
                for row in _leaf_rows(params[k], *(t[k] for t in trees))]
    return [(params, *trees)]


def _map_with_state(fn, params, grads, states):
    """fn(p, g, s) -> (new_p, new_s) over the param tree, where each
    param's state `s` is a dict of tensors; returns (new params, new
    states) as two trees."""
    if isinstance(params, dict):
        pairs = {k: _map_with_state(fn, params[k], grads[k], states[k])
                 for k in params}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return fn(params, grads, states)


# --- int8 block-quantized Adam -----------------------------------------------

_BLOCK = 256


def _quantize_i8(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, _BLOCK)
    return _code_i8(blocks, blocks.abs().amax(dim=1, keepdim=True))


def _code_i8(blocks: torch.Tensor, amax: torch.Tensor):
    """(int8 codes, float32 scales) of `blocks` [rows, cols] whose rows'
    largest |x| over the whole 256-wide block is `amax` [rows, 1]."""
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _blank_i8(shapes, device=None):
    """adam8bit's state of zero moments at `shapes` (each leaf's {"mq":
    shape, "ms": shape, ...}): the codes 0 and the scale 1e-12 that
    `_quantize_i8` gives a zero block, made at once."""
    if "mq" in shapes:
        return {k: (torch.zeros(s, dtype=torch.int8, device=device)
                    if k.endswith("q") else
                    torch.full(s, 1e-12, dtype=torch.float32, device=device))
                for k, s in shapes.items()}
    return {k: _blank_i8(v, device) for k, v in shapes.items()}


def _dequantize_i8(q, scale, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape)


def adam8bit(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
             grad_clip=1.0) -> Optimizer:
    def init(params):
        def one(p):
            rows = -(-math.prod(p.shape) // _BLOCK)
            return {"mq": (rows, _BLOCK), "ms": (rows, 1),
                    "vq": (rows, _BLOCK), "vs": (rows, 1)}
        return init_blocks(tree_map(one, params),
                           device=tree_leaves(params)[0].device)

    def init_blocks(shapes, device=None):
        """`init`'s state at the blocks' shapes (`shapes`: each leaf's
        {"mq": shape, "ms": shape, "vq": shape, "vs": shape}, a rank's
        blocks under the state's specs: `runtime.steps`), bit for bit the
        cut of `init`'s: no whole leaf is made."""
        return {"q": _blank_i8(shapes, device),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def moments(p, g, s, lr, bc1, bc2):
        """(the new m, v and param) of one leaf, the moments not yet
        coded: `g` clipped, `s` the codes and scales of the blocks that
        the flattened `p` fills."""
        g = _f32(g)
        m = b1 * _dequantize_i8(s["mq"], s["ms"], p.shape) + (1 - b1) * g
        v = b2 * _dequantize_i8(s["vq"], s["vs"], p.shape) \
            + (1 - b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * _f32(p)
        return m, v, (_f32(p) - lr * u).to(p.dtype)

    @torch.no_grad()
    def update(grads, state, params, lr):
        step = state["step"] + 1
        grads = clip_by_global_norm(grads, grad_clip)
        bc1 = 1 - b1 ** _f32(step)
        bc2 = 1 - b2 ** _f32(step)

        def one(p, g, s):
            m, v, new_p = moments(p, g, s, lr, bc1, bc2)
            mq, ms = _quantize_i8(m)
            vq, vs = _quantize_i8(v)
            return new_p, {"mq": mq, "ms": ms, "vq": vq, "vs": vs}

        out = _map_with_state(one, params, grads, state["q"])
        return out[0], {"q": out[1], "step": step}

    @torch.no_grad()
    def update_blocks(grads, state, params, lr, *, norm, groups, pmax):
        """`update` on blocks of the [n_blocks, 256] views of the
        zero-padded flattened leaves (a rank's under the state's specs:
        `runtime.steps.rank_adam8bit_update`).  `grads` and `params` hold
        each leaf's [rows, cols] block, zero in the padding; `state["q"]`
        the block's codes [rows, cols] and scales [rows, 1]; `norm` the
        whole gradient's global norm (the clip's, as `adamw.update`'s);
        `groups` each leaf's key of the group of ranks that hold the
        other columns of its rows; `pmax(tensors, keys)` gives each
        tensor's maximum over its key's group, so each scale is its whole
        block's.  A maximum is exact in any order, so given the same
        gradients and clip scale the codes, scales and params are
        `update`'s to the bit; the padding's codes stay 0."""
        step = state["step"] + 1
        scale = _clip_scale(grads, grad_clip, norm)
        bc1 = 1 - b1 ** _f32(step)
        bc2 = 1 - b2 ** _f32(step)
        leaves = _leaf_rows(params, grads, state["q"], groups)
        new, peaks, keys = [], [], []
        for p, g, s, key in leaves:
            if scale is not None:
                g = _clipped(g, scale)
            m, v, new_p = moments(p, g, s, lr, bc1, bc2)
            new.append((m, v, new_p))
            peaks += [m.abs().amax(dim=1, keepdim=True),
                      v.abs().amax(dim=1, keepdim=True)]
            keys += [key, key]
        peaks = iter(pmax(peaks, keys))
        out = []
        for m, v, new_p in new:
            mq, ms = _code_i8(m, next(peaks))
            vq, vs = _code_i8(v, next(peaks))
            out.append((new_p, {"mq": mq, "ms": ms, "vq": vq, "vs": vs}))
        it = iter(out)
        new_p, new_q = _map_with_state(lambda *_: next(it), params, grads,
                                       state["q"])
        return new_p, {"q": new_q, "step": step}

    return Optimizer(init, update, update_blocks, init_blocks)


# --- shared utils ------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed in the
    reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(_f32(g)))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def _clip_scale(grads, max_norm: float, norm=None):
    """The factor `clip_by_global_norm` scales by (None: no clip)."""
    if not max_norm:
        return None
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp_max(max_norm / (norm + 1e-9), 1.0)


def _clipped(g: torch.Tensor, scale) -> torch.Tensor:
    return (_f32(g) * scale).to(g.dtype)


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """`grads` scaled to a global norm of at most `max_norm`; `norm` is
    their global norm where known (default: computed from `grads`)."""
    scale = _clip_scale(grads, max_norm, norm)
    if scale is None:
        return grads
    return tree_map(lambda g: _clipped(g, scale), grads)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor,
            "adam8bit": adam8bit}[name](**kw)
