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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Params, dense, dense_init, rmsnorm,
                                       rmsnorm_init, silu)

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


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU: xbc [B,S,C], w [K,C],
    b [C], all in the activation dtype.  A cross-correlation with K-1
    frames of left padding, as the reference's `conv_general_dilated`."""
    k, c = w.shape
    x = F.pad(xbc.transpose(1, 2), (k - 1, 0))               # [B,C,S+K-1]
    out = F.conv1d(x, w.t().unsqueeze(1), groups=c)          # w [C,1,K]
    return silu(out.transpose(1, 2) + b)


def _ssd_chunked(x, dt, a_log, b_mat, c_mat, d_skip
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan.

    x [B,S,H,P]; dt [B,S,H] (post-softplus); a_log [H]; b_mat, c_mat
    [B,S,N] (one group, shared across heads); all float32.  Returns y
    [B,S,H,P] and the final state [B,H,P,N]."""
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    chunk = min(CHUNK, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {chunk}")
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
    lcum = torch.cumsum(seg, dim=1)
    lc = lcum[:, :, None, :] - seg[:, :, None, :]           # L[c-1]
    idx = torch.arange(nc, device=dev)
    tri = (idx[:, None] > idx[None, :])[None, :, :, None]
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


def ssm_mix(p: Params, cfg, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba2 mixer (train / prefill).  x [B,S,D] ->
    (out [B,S,D], cache {"state" [B,H,P,N], "conv" [B,K-1,C]} float32)."""
    bsz, s, _ = x.shape
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc_raw, dt = _split_proj(cfg, dense(p["in_proj"], x))
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    xin = xbc[..., :di].reshape(bsz, s, h, hd)
    b_mat = xbc[..., di:di + n]
    c_mat = xbc[..., di + n:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])
    y, state = _ssd_chunked(xin.to(torch.float32), dt, p["a_log"],
                            b_mat.to(torch.float32),
                            c_mat.to(torch.float32), p["d_skip"])
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    cache = {"state": state.to(torch.float32),
             "conv": xbc_raw[:, -(cfg.ssm_conv - 1):, :].to(torch.float32)}
    return dense(p["out_proj"], y), cache


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
    """One-token recurrent step.  x [B,1,D]; O(1) state update."""
    bsz = x.shape[0]
    di, n, h, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    f32 = torch.float32
    z, xbc_new, dt = _split_proj(cfg, dense(p["in_proj"], x))

    # rolling conv state: [B, K-1, C] + the current input
    hist = torch.cat([cache["conv"].to(x.dtype), xbc_new], dim=1)
    w = p["conv_w"].to(x.dtype)
    conv_out = (hist * w[None, :, :]).sum(1, keepdim=True) \
        + p["conv_b"].to(x.dtype)[None, None, :]
    xbc = silu(conv_out)
    new_conv = hist[:, 1:, :]

    xin = xbc[..., :di].reshape(bsz, h, hd)
    b_mat = xbc[:, 0, di:di + n]
    c_mat = xbc[:, 0, di + n:]
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"][None, :])     # [B,H]
    a = -torch.exp(p["a_log"])                                     # [H]
    da = torch.exp(dt * a[None, :])                                # [B,H]

    state = cache["state"]                                         # [B,H,P,N]
    upd = torch.einsum("bn,bhp->bhpn", b_mat.to(f32),
                       xin.to(f32) * dt[..., None])
    state = state * da[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", c_mat.to(f32), state) \
        + xin.to(f32) * p["d_skip"][None, :, None]
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rmsnorm(p["norm"], y * silu(z))
    return dense(p["out_proj"], y), {"state": state, "conv": new_conv}
