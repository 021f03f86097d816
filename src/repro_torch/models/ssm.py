"""Mamba2 (SSD, state-space duality) mixer, chunked-scan formulation (port
of `repro.models.ssm`).

The sequence is split into chunks of `CHUNK` tokens: within a chunk the
dual (attention-like) quadratic form, across chunks a linear recurrence
of [H, P, N] states, written as a masked [nc, nc] decay product (no
sequential loop).  Decode is the O(1) recurrent step over a constant-size
state.  Shapes: d_inner = H * P (P = ssm_head_dim), N = ssm_state, one
B/C group shared across heads.

Mixed precision as the reference has it: decay and log tensors stay
float32, and the batched products take bfloat16-rounded operands summed
in float32.  The products of two bfloat16 values are exact in float32,
so each operand is rounded with `_bf` and the einsum runs in float32
(TF32 off on the card); a bfloat16 einsum would round its output too.
The reference computes all of this in `jnp`, outside any Pallas kernel,
so the port is plain torch.

Under a `model` axis over ranks (`core.mesh.model_ranks`) the mixer runs
as the reference lays it out:
  * the ssm family (`seq_cut`): params replicated, the sequence cut over
    the model group (the reference's "sequence-parallel end-to-end"
    path).  Each rank runs the causal conv on its block after the
    previous rank's last K-1 frames (`sequence_halo`) and the chunked scan
    over its own chunks of the one-process chunk grid; the chunks' states
    and log decays are gathered over the group (`gather_sequence`), and
    the states entering the rank's chunks and the final state come from
    the one-process triangular product over the global chunk index.  A
    block that does not hold whole chunks of that grid runs the
    one-process mixer on the gathered sequence and keeps its block.
  * the hybrid: the residual whole, the params cut by the reference's
    specs, whose column cuts of in_proj and the conv do not fall on head
    boundaries.  in_proj is column-parallel and its output gathered,
    conv_w, conv_b and dt_bias are gathered whole, every rank runs the
    whole mixer, and the rank's rows of y (`scatter_to_model`) go through
    the row-parallel out_proj, its partials summed in float32.
  * decode on the rank's cache blocks: the SSM state cut over heads (the
    reference's spec) and the conv window whole
    (`runtime.sharding.rank_cache_pspecs`); each rank updates its heads'
    state and the heads' outputs are gathered before the gated norm.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.mesh import (copy_to_model, gather_from_model,
                                   gather_sequence, mesh_all_gather,
                                   model_coord, model_ranks, scatter_to_model,
                                   sequence_halo)
from repro_torch.models.layers import (Params, dense, dense_init, linear_col,
                                       linear_row, rmsnorm, rmsnorm_init,
                                       silu)
from repro_torch.runtime.sharding import param_ranks

CHUNK = 256


def _bf(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to bfloat16 and held in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


def ssm_init(gen: torch.Generator, cfg, *, dtype=torch.float32) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, kc = cfg.ssm_heads, cfg.ssm_conv
    conv_dim = di + 2 * n           # x, B and C go through the causal conv
    return {
        # in_proj -> [z, x, B, C, dt]
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, dtype=dtype),
        "conv_w": (torch.randn(kc, conv_dim, generator=gen)
                   / math.sqrt(kc)).to(dtype),
        "conv_b": torch.zeros(conv_dim, dtype=dtype),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h)),
        "d_skip": torch.ones(h),
        "dt_bias": torch.zeros(h),
        "norm": rmsnorm_init(di),
        "out_proj": dense_init(gen, di, d, dtype=dtype),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU: xbc [B,S,C], w [K,C],
    b [C], all in the activation dtype.  A cross-correlation with K-1
    frames of left padding, as the reference's `conv_general_dilated`;
    `halo` [B,K-1,C] (the frames before a sequence block) in place of the
    padding's zeros."""
    k, c = w.shape
    if halo is None:
        x = F.pad(xbc.transpose(1, 2), (k - 1, 0))           # [B,C,S+K-1]
    else:
        x = torch.cat([halo, xbc], 1).transpose(1, 2)
    out = F.conv1d(x, w.t().unsqueeze(1), groups=c)          # w [C,1,K]
    return silu(out.transpose(1, 2) + b)


def ssd_chunk(s: int) -> int:
    """The SSD chunk of an S-token sequence; ValueError where S is not a
    multiple of it."""
    chunk = min(CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
    return chunk


def _ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan.

    x [B,S,H,P]; dt [B,S,H] (post-softplus); a_log [H]; b_mat, c_mat
    [B,S,N] (one group, shared across heads); all float32.  Returns y
    [B,S,H,P] and the final state [B,H,P,N].  With `mesh` (a model axis
    over ranks) the S tokens are this rank's block of a sequence cut over
    the group, holding whole chunks of the one-process chunk grid: the
    chunks' states and log decays are gathered, and the final state is
    the whole sequence's on every rank."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    index, m = model_coord(mesh) if mesh is not None else (0, 1)
    chunk = ssd_chunk(s * m)
    nc = s // chunk
    a = -torch.exp(a_log)                                   # [H], negative
    dev = x.device

    xc = x.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    bc = b_mat.reshape(bsz, nc, chunk, n)
    cc = c_mat.reshape(bsz, nc, chunk, n)

    da_cum = torch.cumsum(dtc * a, dim=2)                   # [B,nc,L,H] logs
    xc16, bc16, cc16 = _bf(xc), _bf(bc), _bf(cc)

    # intra-chunk (dual quadratic form, causal within the chunk).  The mask
    # goes on in log space: for j > i the exponent is positive and would
    # overflow to inf before a mask after exp could zero it.
    li = da_cum[:, :, :, None, :]                           # target i
    lj = da_cum[:, :, None, :, :]                           # source j
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=dev).tril()
    decay = torch.exp((li - lj).masked_fill(
        ~causal[None, None, :, :, None], -math.inf))        # [B,nc,Li,Lj,H]
    cb = torch.einsum("bcin,bcjn->bcij", cc16, bc16)        # [B,nc,L,L]
    w = _bf(cb[..., None] * decay * dtc[:, :, None, :, :])
    del decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc16)
    del w

    # chunk states: S_c = sum_j B_j (x_j dt_j) decay(j -> end)
    decay_end = torch.exp(da_cum[:, :, -1:, :] - da_cum)    # [B,nc,L,H]
    xw = _bf(xc * (dtc * decay_end)[..., None])             # [B,nc,L,H,P]
    s_chunk = torch.einsum("bcjn,bcjhp->bchpn", bc16, xw)

    # inter-chunk recurrence as a triangular decay product: the state
    # entering chunk c is sum_{j<c} exp(L[c-1] - L[j]) S_j, L the
    # inclusive cumsum of the per-chunk log decays
    seg = da_cum[:, :, -1, :]                               # [B,nc,H]
    c_lo = 0
    if mesh is not None:
        # every rank's chunk states and log decays, in one all-gather
        both = gather_sequence(torch.cat([s_chunk.reshape(bsz, nc, -1),
                                          seg], -1), mesh, 1)
        s_chunk = both[..., :-h].reshape(bsz, nc * m, h, p, n)
        seg, c_lo = both[..., -h:], index * nc
    lcum = torch.cumsum(seg, dim=1)
    lc = lcum[:, c_lo:c_lo + nc, None, :] \
        - seg[:, c_lo:c_lo + nc, None, :]                   # L[c-1]
    idx = torch.arange(nc * m, device=dev)
    tri = (idx[c_lo:c_lo + nc, None] > idx[None, :])[None, :, :, None]
    t_mat = torch.exp((lc - lcum[:, None, :, :]).masked_fill(
        ~tri, -math.inf))                                   # [B,c,j,H]
    prev_states = torch.einsum("bcjh,bjhpn->bchpn", t_mat, s_chunk)
    t_fin = torch.exp(lcum[:, -1:, :] - lcum)               # [B,nc,H]
    final = torch.einsum("bjh,bjhpn->bhpn", t_fin, s_chunk)

    # inter-chunk contribution: y_i += C_i . prev_state * decay(start -> i)
    y_inter = torch.einsum("bcin,bchpn->bcihp", cc16, _bf(prev_states)) \
        * torch.exp(da_cum)[..., None]

    y = (y_intra + y_inter).reshape(bsz, s, h, p) \
        + x * d_skip[None, None, :, None]
    return y, final


def _whole_leaves(leaves, shapes, mesh):
    """The whole leaves of `shapes` from this rank's blocks (each cut over
    "model" on at most one dim, or whole), for a use that every rank
    computes alike: the cut blocks travel as one float32 vector (exact for
    the float32 and bfloat16 leaves) in one all-gather whose gradient
    keeps the rank's block (`gather_from_model`); whole leaves stay as
    they are."""
    out = list(leaves)
    cut = [i for i, (t, shape) in enumerate(zip(leaves, shapes))
           if tuple(t.shape) != tuple(shape)]
    if not cut:
        return out
    rows = gather_from_model(torch.cat([
        leaves[i].to(torch.float32).reshape(-1) for i in cut])[None], mesh, 0)
    at = 0
    for i in cut:
        t = leaves[i]
        dim = next(d for d, (a, b) in enumerate(zip(t.shape, shapes[i]))
                   if a != b)
        blocks = rows[:, at:at + t.numel()].reshape(-1, *t.shape)
        out[i] = torch.cat(blocks.unbind(0), dim).to(t.dtype)
        at += t.numel()
    return out


def _in_proj(p: Params, cfg, x: torch.Tensor, mesh) -> torch.Tensor:
    """The fused [z | x | B | C | dt] projection, whole: under a model
    axis over ranks with cut params (`mesh`) column-parallel and gathered
    (x through `copy_to_model`), or the whole kernel where the width does
    not divide the axis."""
    if mesh is None:
        return dense(p["in_proj"], x)
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    if width % model_coord(mesh)[1]:
        return dense({"kernel": _whole_leaves(
            [p["in_proj"]["kernel"]], [(x.shape[-1], width)], mesh)[0]}, x)
    return gather_from_model(linear_col(p["in_proj"], copy_to_model(x, mesh),
                                        width), mesh, -1)


def _out_proj(p: Params, cfg, y: torch.Tensor, mesh) -> torch.Tensor:
    """out_proj of the whole y [..., d_inner]: under a model axis over
    ranks with cut params (`mesh`) the rank's rows of y through the
    row-parallel product (the partials summed in float32), or the whole
    kernel where d_inner does not divide the axis."""
    if mesh is None:
        return dense(p["out_proj"], y)
    di, d = cfg.d_inner, cfg.d_model
    if di % model_coord(mesh)[1]:
        return dense({"kernel": _whole_leaves(
            [p["out_proj"]["kernel"]], [(di, d)], mesh)[0]}, y)
    return linear_row(p["out_proj"], scatter_to_model(y, mesh, -1), di, d)


def _conv_dt(p: Params, cfg, mesh):
    """(conv_w, conv_b, dt_bias) whole: under cut params gathered in one
    all-gather."""
    leaves = [p["conv_w"], p["conv_b"], p["dt_bias"]]
    if mesh is None:
        return leaves
    c = cfg.d_inner + 2 * cfg.ssm_state
    return _whole_leaves(leaves, [(cfg.ssm_conv, c), (c,), (cfg.ssm_heads,)],
                         mesh)


def ssm_mix(p: Params, cfg, x: torch.Tensor, *, seq_cut: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba2 mixer (train / prefill).  x [B,S,D] ->
    (out [B,S,D], cache {"state" [B,H,P,N], "conv" [B,K-1,C]} float32).
    `seq_cut`: x is this rank's block of a sequence cut over the model
    axis over ranks (the ssm family); the cache is the whole sequence's
    on every rank."""
    mesh = model_ranks() if seq_cut else None
    if mesh is not None:
        index, m = model_coord(mesh)
        s = x.shape[1]
        if s % ssd_chunk(s * m):
            # the block holds no whole chunks: the gathered sequence
            out, cache = ssm_mix(p, cfg, gather_sequence(x, mesh, 1))
            return out[:, index * s:(index + 1) * s], cache
    bsz, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    cut = param_ranks(cfg)
    conv_w, conv_b, dt_bias = _conv_dt(p, cfg, cut)
    z, xbc_raw, dt = _split_proj(cfg, _in_proj(p, cfg, x, cut))
    k = cfg.ssm_conv
    halo = last = None
    if mesh is not None:
        halo, last = sequence_halo(xbc_raw[:, -(k - 1):, :], mesh)
    xbc = _causal_conv(xbc_raw, conv_w.to(x.dtype), conv_b.to(x.dtype), halo)
    xin = xbc[..., :di].reshape(bsz, s, h, hd)
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + dt_bias[None, None, :])
    y, state = _ssd_chunked(xin.to(torch.float32), dt, p["a_log"],
                            b_mat.to(torch.float32),
                            c_mat.to(torch.float32), p["d_skip"], mesh)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    tail = xbc_raw[:, -(k - 1):, :] if last is None else last
    cache = {"state": state.to(torch.float32),
             "conv": tail.to(torch.float32)}
    return _out_proj(p, cfg, y, cut), cache


def ssm_empty_cache(cfg, batch: int, dtype=torch.float32, device=None
                    ) -> Dict:
    h, hd, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * n
    return {"state": torch.zeros((batch, h, hd, n), dtype=dtype,
                                 device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def ssm_decode(p: Params, cfg, x: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step.  x [B,1,D]; O(1) state update.  Under a
    model axis over ranks `cache` is the rank's block: the state of its
    heads (all of them where the heads do not divide the axis) and the
    whole conv window."""
    bsz = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    f32 = torch.float32
    cut = param_ranks(cfg)
    conv_w, conv_b, dt_bias = _conv_dt(p, cfg, cut)
    z, xbc_new, dt = _split_proj(cfg, _in_proj(p, cfg, x, cut))

    # rolling conv state: [B, K-1, C] + the current input
    hist = torch.cat([cache["conv"].to(x.dtype), xbc_new], dim=1)
    w = conv_w.to(x.dtype)
    conv_out = (hist * w[None, :, :]).sum(1, keepdim=True) \
        + conv_b.to(x.dtype)[None, None, :]
    xbc = silu(conv_out)
    new_conv = hist[:, 1:, :]

    xin = xbc[..., :di].reshape(bsz, h, hd)
    b_mat = xbc[:, 0, di:di + n]
    c_mat = xbc[:, 0, di + n:]
    dt = F.softplus(dt[:, 0].to(f32) + dt_bias[None, :])          # [B,H]
    a = -torch.exp(p["a_log"])                                     # [H]
    d_skip = p["d_skip"]
    state = cache["state"]                                         # [B,H,P,N]
    mesh = model_ranks()
    heads = state.shape[1]
    if heads != h:                      # the rank's heads of the state
        lo = model_coord(mesh)[0] * heads
        xin, dt = xin[:, lo:lo + heads], dt[:, lo:lo + heads]
        a, d_skip = a[lo:lo + heads], d_skip[lo:lo + heads]
    da = torch.exp(dt * a[None, :])                                # [B,H]

    upd = torch.einsum("bn,bhp->bhpn", b_mat.to(f32),
                       xin.to(f32) * dt[..., None])
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_mat.to(f32), state) \
        + xin.to(f32) * d_skip[None, :, None]
    if heads != h:
        y = mesh_all_gather(y, mesh, ("model",), 1)
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    return _out_proj(p, cfg, y, cut), {"state": state, "conv": new_conv}
