"""Attention mixers: GQA (RoPE, qk-norm, bias, windowed), DeepSeek's MLA
and the whisper decoder's cross-attention (port of
`repro.models.attention`).

Two entry modes share one set of params:
  * prefill : full-sequence causal attention, returns (out, cache)
  * decode  : one new token against a KV cache of length S_ctx

Caches:
  GQA   : {"k": [B, S, Hkv, Dh], "v": [B, S, Hkv, Dh]}
  MLA   : {"ckv": [B, S, kv_lora], "k_rope": [B, S, rope_dim]}, the
          compressed latent and the one rope key all heads share
  cross : {"k", "v": [B, S_enc, H, Dh]}, computed once from the encoder

Windowed attention masks keys older than `window`.  Only GQA's prefill
takes the flash kernel; MLA and cross-attention take dense scores, as in
the reference.

Under a `model` axis over ranks (`core.mesh.model_ranks`) GQA runs on the
rank's heads: its H / |model| query heads and the KV heads they read
(`head_split`), from column-parallel wq/wk/wv (a leaf whose cut does not
fall on those heads is gathered and sliced), with `wo` row-parallel.
Where |model| does not divide the heads (40 over 16), the specs still cut
wq's H * Dh columns and wo's rows into |model| blocks: the rank computes
whole every head its block overlaps (a head two blocks share is computed
on both, from wq gathered whole) and hands exactly its block of columns
to `wo`; a rank whose heads read their KV heads unevenly reads them one
KV head a query head (`kv_index`).  The decode cache is cut over the
sequence (`cache_pspecs`), so decode is flash-decoding: each rank's block
of q's columns (before its norm and rope, which act on whole heads) and
its new K/V are gathered over the model group, the rank that holds
position `pos` writes it, each rank scores every head over its own
positions, the softmax's max and sum and the weighted values are merged
over the group, and the rank keeps its block of columns for `wo`.  A
cache whose length the axis does not divide is whole on every rank,
which then attends with its own heads.  MLA runs on the rank's heads
too: `wq_b`, `wk_b` and `wv_b` column-parallel over heads, `wo`
row-parallel, the low-rank down-projections and their norms whole on
every rank; its decode gathers the sequence-cut latent (`mla_decode`).
So does the cross-attention (`cross_kv`, `cross_attend`): `wq`, `wk` and
`wv` column-parallel, `wo` row-parallel, and the cross cache holds the
rank's heads of every frame, so its decode adds no collective but `wo`'s
sum.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core.mesh import (copy_to_model, mesh_all_gather,
                                   mesh_max, mesh_sum, model_coord,
                                   model_ranks)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (Params, apply_rope, dense, dense_init,
                                       linear, linear_col, linear_init,
                                       linear_row, rmsnorm, rmsnorm_init)

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


def head_split(cfg, index: int, m: int) -> Tuple[int, int, int, int]:
    """(q_lo, q_hi, kv_lo, kv_hi): the query heads of position `index` of
    a model axis of `m`, and the KV heads they read.  Where `m` divides
    the heads, the position's H / m of them; where it does not, every
    head that the position's block of H * Dh / m columns overlaps (its
    first and last may be shared with its neighbours).  ValueError where
    `m` does not divide H * Dh."""
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    n_rep = h // hkv
    col_lo, col_hi = head_columns(cfg, index, m)
    q_lo, q_hi = col_lo // dh, -(-col_hi // dh)
    return q_lo, q_hi, q_lo // n_rep, (q_hi - 1) // n_rep + 1


def head_columns(cfg, index: int, m: int) -> Tuple[int, int]:
    """[lo, hi): position `index`'s block of the H * Dh attention columns
    (of wq's output and wo's input) over a model axis of `m`; ValueError
    where `m` does not divide them."""
    width = cfg.n_heads * cfg.d_head
    if width % m:
        raise ValueError(f"{cfg.n_heads} heads of {cfg.d_head} do not divide "
                         f"a model axis of {m}")
    return index * width // m, (index + 1) * width // m


def kv_index(cfg, q_lo: int, q_hi: int, kv_lo: int, kv_hi: int):
    """None where every KV head of [kv_lo, kv_hi) is read by equally many
    of the query heads [q_lo, q_hi) (the site's n_rep is then their
    ratio); else, for each query head, the KV head it reads counted from
    kv_lo (40 heads over 8 KV heads on a model axis of 16 never need it;
    9 heads over 3 on 4 do)."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    reads = [hd // n_rep - kv_lo for hd in range(q_lo, q_hi)]
    counts = {reads.count(j) for j in range(kv_hi - kv_lo)}
    return None if len(counts) == 1 else reads


def _rank_heads(cfg, mesh) -> Tuple[int, int, int, int]:
    """`head_split` of this rank, or every head without a model axis over
    ranks (`mesh` None)."""
    if mesh is None:
        return 0, cfg.n_heads, 0, cfg.n_kv_heads
    return head_split(cfg, *model_coord(mesh))


def _site_kv(cfg, k: torch.Tensor, v: torch.Tensor, heads):
    """(k, v, n_rep) as this rank's query heads `heads` (`head_split`'s
    four numbers) read them: the KV heads as they are, or one a query head
    where they are read unevenly (`kv_index`)."""
    q_lo, q_hi, kv_lo, kv_hi = heads
    reads = kv_index(cfg, *heads)
    if reads is None:
        return k, v, (q_hi - q_lo) // (kv_hi - kv_lo)
    at = torch.tensor(reads, device=k.device)
    return k.index_select(2, at), v.index_select(2, at), 1


def _q_heads(p: Params, cfg, q: torch.Tensor, positions: torch.Tensor,
             mesh) -> torch.Tensor:
    """q [B, S, H', Dh] normed (qk-norm) and rotated."""
    if cfg.qk_norm:
        qn = p["q_norm"]
        if mesh is not None:
            # the rank's heads: each rank's share of the norm's gradient
            qn = {"scale": copy_to_model(qn["scale"], mesh)}
        q = rmsnorm(qn, q)
    return apply_rope(q, positions, cfg.rope_theta)


def _kv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor, mesh,
        kv_lo: int, kv_hi: int):
    """k, v [B, S, Hkv', Dh] of the KV heads [kv_lo, kv_hi)."""
    b, s, _ = x.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    if mesh is None:
        k = linear(p["wk"], x).reshape(b, s, hkv, dh)
        v = linear(p["wv"], x).reshape(b, s, hkv, dh)
    else:
        k, v = (linear_col(p[n], x, hkv * dh, kv_lo * dh, kv_hi * dh)
                .reshape(b, s, kv_hi - kv_lo, dh) for n in ("wk", "wv"))
    if cfg.qk_norm:
        kn = p["k_norm"]
        if mesh is not None:
            kn = {"scale": copy_to_model(kn["scale"], mesh)}
        k = rmsnorm(kn, k)
    return apply_rope(k, positions, cfg.rope_theta), v


def _qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """q [B, S, H', Dh], k and v [B, S, Hkv', Dh]: every head, or under a
    model axis over ranks the rank's (`head_split`; `_site_kv` gives the
    site's n_rep)."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    mesh = model_ranks()
    q_lo, q_hi, kv_lo, kv_hi = _rank_heads(cfg, mesh)
    if mesh is None:
        q = linear(p["wq"], x)
    else:
        q = linear_col(p["wq"], x, h * dh, q_lo * dh, q_hi * dh)
    q = _q_heads(p, cfg, q.reshape(b, s, q_hi - q_lo, dh), positions, mesh)
    k, v = _kv(p, cfg, x, positions, mesh, kv_lo, kv_hi)
    return q, k, v


def _out(p: Params, cfg, out: torch.Tensor) -> torch.Tensor:
    """wo over the heads' outputs [B, S, H' * Dh] (row-parallel under a
    model axis over ranks, on the rank's block of the columns: all of its
    heads' where |model| divides the heads)."""
    mesh = model_ranks()
    if mesh is not None:
        index, m = model_coord(mesh)
        col_lo, col_hi = head_columns(cfg, index, m)
        at = col_lo - _rank_heads(cfg, mesh)[0] * cfg.d_head
        if (at, col_hi - col_lo) != (0, out.shape[-1]):
            out = out[..., at:at + col_hi - col_lo]
    return linear_row(p["wo"], out, cfg.n_heads * cfg.d_head, cfg.d_model)


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
    the dense-scores `_sdpa` runs, as the reference runs it off the TPU.
    The meta device models the card (the dry-run's traces): there the
    flash wrappers give the kernels' outputs without storage."""
    return (getattr(cfg, "attention_impl", "flash") == "flash"
            and torch.device(device).type in ("cuda", "meta")
            and window == 0 and s % 128 == 0)


def gqa_attend(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
               window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence causal attention (prefill); the cache holds the
    site's heads (under a model axis over ranks, the rank's KV heads)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x, positions)
    ks, vs, n_rep = _site_kv(cfg, k, v, _rank_heads(cfg, model_ranks()))
    if _use_flash(cfg, s, window, x.device):
        out = flash_attention(
            q.transpose(1, 2).contiguous(), ks.transpose(1, 2).contiguous(),
            vs.transpose(1, 2).contiguous(), True, n_rep).transpose(1, 2)
    else:
        mask = causal_mask(s, window, x.device)[None]
        out = _sdpa(q, ks, vs, mask, n_rep)
    return _out(p, cfg, out.reshape(b, s, -1)), {"k": k, "v": v}


def gqa_decode(p: Params, cfg, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor, window: int = 0, ctx_len: int = 0
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode. x [B,1,D]; pos [B] current index into the cache.

    The new key and value are added at `pos` as the reference adds them
    (a one-hot update onto the zeroed slot), into new cache tensors; a
    position past the cache writes nothing.  Under a model axis over
    ranks `cache` is the rank's block of a cache of `ctx_len` positions
    (flash-decoding; see the module docstring)."""
    mesh = model_ranks()
    if mesh is not None:
        return _gqa_decode_ranks(p, cfg, x, cache, pos, window, ctx_len,
                                 mesh)
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


def kv_slots(cfg, m: int) -> int:
    """The most KV heads a position of a model axis of `m` holds: the
    width every position's KV block is padded to for an all-gather."""
    return max(kv_hi - kv_lo for _, _, kv_lo, kv_hi in
               (head_split(cfg, i, m) for i in range(m)))


def pad_kv(t: torch.Tensor, cfg, m: int, dim: int = 2) -> torch.Tensor:
    """A rank's KV heads along `dim` padded with zeros to `kv_slots`."""
    extra = kv_slots(cfg, m) - t.shape[dim]
    if not extra:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim)


def all_heads(cfg, blocks: torch.Tensor, m: int, dim: int = 2
              ) -> torch.Tensor:
    """Each KV head once, from the first model position that holds it,
    out of every position's KV heads (`head_split`'s, padded to
    `kv_slots`: `pad_kv`) concatenated along `dim` in mesh order."""
    picks, width = [], kv_slots(cfg, m)
    for index in range(m):
        _, _, lo, hi = head_split(cfg, index, m)
        for head in range(lo, hi):
            if head == len(picks):
                picks.append(index * width + head - lo)
    return blocks.index_select(dim, torch.tensor(picks,
                                                 device=blocks.device))


def _gqa_decode_ranks(p, cfg, x, cache, pos, window, ctx_len, mesh):
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.d_head
    index, m = model_coord(mesh)
    heads = head_split(cfg, index, m)
    q_lo, q_hi, kv_lo, kv_hi = heads
    q = linear_col(p["wq"], x, h * dh)       # the rank's block of columns
    k_new, v_new = (pad_kv(t, cfg, m) for t in _kv(
        p, cfg, x, pos[:, None], mesh, kv_lo, kv_hi))
    # every rank's q columns and new K/V, in one all-gather
    width = [q.shape[-1], k_new.shape[2] * dh, v_new.shape[2] * dh]
    got = mesh_all_gather(torch.cat([t.reshape(b, -1) for t in
                                     (q, k_new, v_new)], -1)[None],
                          mesh, ("model",), 0)
    q_got, k_got, v_got = got.split(width, -1)
    q_all = _q_heads(p, cfg, q_got.permute(1, 0, 2).reshape(b, 1, h, dh),
                     pos[:, None], mesh)
    k_all, v_all = (all_heads(cfg, t.reshape(m, b, 1, -1, dh)
                              .permute(1, 2, 0, 3, 4).reshape(b, 1, -1, dh),
                              m) for t in (k_got, v_got))
    s_loc = cache["k"].shape[1]
    cut = s_loc != ctx_len
    lo = index * s_loc if cut else 0
    j = lo + torch.arange(s_loc, device=x.device)
    onehot = (j[None, :] == pos[:, None]).to(cache["k"].dtype)[:, :, None,
                                                               None]
    k = cache["k"] + onehot * k_all.to(cache["k"].dtype)
    v = cache["v"] + onehot * v_all.to(cache["v"].dtype)
    mask = j[None, None, :] <= pos[:, None, None]
    if window:
        mask &= (pos[:, None, None] - j[None, None, :]) < window
    if not cut:                          # a whole cache: the rank's heads
        ks, vs, n_rep = _site_kv(cfg, k[:, :, kv_lo:kv_hi],
                                 v[:, :, kv_lo:kv_hi], heads)
        out = _sdpa(q_all[:, :, q_lo:q_hi], ks, vs, mask, n_rep)
    else:
        out = _merged_sdpa(q_all, k, v, mask, cfg, mesh)[:, :, q_lo:q_hi]
    return _out(p, cfg, out.reshape(b, 1, -1)), {"k": k, "v": v}


def _merged_sdpa(q, k, v, mask, cfg, mesh):
    """`_sdpa` of every head over a cache cut over the model group's
    positions: the softmax's max and sum over all positions from the
    ranks' (a MAX and a SUM all-reduce), each rank's weights rounded to
    v's dtype as `_sdpa` rounds them, the weighted values summed over the
    group in float32 and rounded once."""
    b, sq, h, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, h // hkv, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(dh))
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    top = mesh_max([logits.amax(-1, keepdim=True)], mesh)[0]
    e = torch.exp(logits - top)
    w = e / mesh_sum([e.sum(-1, keepdim=True)], mesh, ("model",))[0]
    out = torch.einsum("bgrqk,bkgd->bqgrd", w.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = mesh_sum([out.contiguous()], mesh, ("model",))[0]
    return out.reshape(b, sq, h, dh).to(q.dtype)


def gqa_empty_cache(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                    device=None) -> Dict:
    shp = (batch, s_max, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


# --- MLA (DeepSeek-V3): low-rank joint KV compression + decoupled RoPE -------

def mla_init(gen: torch.Generator, cfg, *, dtype=torch.float32) -> Params:
    d, h = cfg.d_model, cfg.n_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": dense_init(gen, d, r_q, dtype=dtype),
        "q_a_norm": rmsnorm_init(r_q),
        "wq_b": dense_init(gen, r_q, h * (dn + dr), dtype=dtype),
        "wkv_a": dense_init(gen, d, r_kv + dr, dtype=dtype),
        "kv_a_norm": rmsnorm_init(r_kv),
        "wk_b": dense_init(gen, r_kv, h * dn, dtype=dtype),
        "wv_b": dense_init(gen, r_kv, h * dv, dtype=dtype),
        "wo": dense_init(gen, h * dv, d, dtype=dtype),
    }


def _mla_heads(cfg, mesh) -> int:
    """The query heads a rank scores: all of them, or under a model axis
    over ranks its H / |model| (ValueError where they do not divide)."""
    if mesh is None:
        return cfg.n_heads
    m = model_coord(mesh)[1]
    if cfg.n_heads % m:
        raise ValueError(f"{cfg.n_heads} heads do not divide a model axis "
                         f"of {m}")
    return cfg.n_heads // m


def _mla_q(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope, q_rope) of every head, or under a model axis over ranks of
    the rank's (`wq_b` column-parallel over heads, its normed latent
    input through `copy_to_model`; `wq_a` and `q_a_norm` whole)."""
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    mesh = model_ranks()
    lat = rmsnorm(p["q_a_norm"], dense(p["wq_a"], x))
    if mesh is not None:
        lat = copy_to_model(lat, mesh)
    q = linear_col(p["wq_b"], lat, h * (dn + dr))
    q = q.reshape(b, s, _mla_heads(cfg, mesh), dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """Compressed latent ckv [B,S,r_kv] + shared rope key [B,S,dr]."""
    r_kv = cfg.kv_lora_rank
    kv = dense(p["wkv_a"], x)
    ckv = rmsnorm(p["kv_a_norm"], kv[..., :r_kv])
    k_rope = apply_rope(kv[..., r_kv:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return ckv, k_rope


def _mla_core_multihead(p: Params, cfg, q_nope, q_rope, ckv, k_rope, mask):
    """Scores of each head's q_nope against its decompressed keys plus its
    q_rope against the one shared rope key, scaled by 1/sqrt(dn + dr);
    both products and the value product summed in float32, the output
    cast to ckv's dtype.  The heads are q's (under a model axis over
    ranks the rank's: `wk_b` and `wv_b` column-parallel over them, ckv
    and k_rope through `copy_to_model`)."""
    b, sq, h = q_nope.shape[:3]
    dn, dv = cfg.qk_nope_dim, cfg.v_head_dim
    sk = ckv.shape[1]
    f32 = torch.float32
    k_nope = linear_col(p["wk_b"], ckv, cfg.n_heads * dn).reshape(b, sk, h,
                                                                  dn)
    v = linear_col(p["wv_b"], ckv, cfg.n_heads * dv).reshape(b, sk, h, dv)
    scale = 1.0 / math.sqrt(dn + cfg.qk_rope_dim)
    logits = (torch.einsum("bqhd,bkhd->bhqk", q_nope.to(f32),
                           k_nope.to(f32))
              + torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32),
                             k_rope.to(f32))) * scale
    logits = logits.masked_fill(~mask[:, None, :, :], NEG_INF)
    w = torch.softmax(logits, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype).to(f32), v.to(f32))
    return out.reshape(b, sq, h * dv).to(ckv.dtype)


def _mla_scores(p: Params, cfg, q_nope, q_rope, ckv, k_rope, mask):
    """The heads' attention over the latent and `wo` (row-parallel under
    a model axis over ranks, the latent through `copy_to_model`: every
    head reads it)."""
    mesh = model_ranks()
    if mesh is not None:
        ckv, k_rope = copy_to_model(ckv, mesh), copy_to_model(k_rope, mesh)
    out = _mla_core_multihead(p, cfg, q_nope, q_rope, ckv, k_rope, mask)
    return linear_row(p["wo"], out, cfg.n_heads * cfg.v_head_dim,
                      cfg.d_model)


def mla_attend(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
               window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence causal MLA (prefill); the cache is the latent (whole
    on every rank under a model axis over ranks)."""
    s = x.shape[1]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    ckv, k_rope = _mla_latent(p, cfg, x, positions)
    mask = causal_mask(s, window, x.device)[None]
    return (_mla_scores(p, cfg, q_nope, q_rope, ckv, k_rope, mask),
            {"ckv": ckv, "k_rope": k_rope})


def mla_decode(p: Params, cfg, x: torch.Tensor, cache: Dict,
               pos: torch.Tensor, window: int = 0, ctx_len: int = 0
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token MLA decode: the new latent and rope key added at `pos`
    (a one-hot update, as `gqa_decode`).

    Under a model axis over ranks `cache` is the rank's block of a cache
    of `ctx_len` positions, cut over the sequence (`cache_pspecs`).  The
    latent is shared by every head, so the rank that holds `pos` writes
    it, the ranks' blocks of the latent and rope key are gathered over
    the group (one all-gather of [B, S_ctx / |model|, r_kv + dr] a
    layer), and the rank scores its own heads over every position as one
    process does: no softmax merge, and the scores are one process's
    heads'.  A cache whose length the axis does not divide is whole on
    every rank."""
    q_nope, q_rope = _mla_q(p, cfg, x, pos[:, None])
    ckv_new, k_rope_new = _mla_latent(p, cfg, x, pos[:, None])
    mesh = model_ranks()
    s_loc = cache["ckv"].shape[1]
    cut = mesh is not None and s_loc != ctx_len
    lo = model_coord(mesh)[0] * s_loc if cut else 0
    j = lo + torch.arange(s_loc, device=x.device)
    onehot = (j[None, :] == pos[:, None]).to(cache["ckv"].dtype)[:, :, None]
    ckv = cache["ckv"] + onehot * ckv_new.to(cache["ckv"].dtype)
    k_rope = cache["k_rope"] + onehot * k_rope_new.to(cache["k_rope"].dtype)
    ckv_all, k_rope_all = ckv, k_rope
    if cut:
        got = mesh_all_gather(torch.cat([ckv, k_rope], -1), mesh,
                              ("model",), 1)
        ckv_all, k_rope_all = got.split([ckv.shape[-1], k_rope.shape[-1]],
                                        -1)
    j = torch.arange(ckv_all.shape[1], device=x.device)
    mask = j[None, None, :] <= pos[:, None, None]
    if window:
        mask &= (pos[:, None, None] - j[None, None, :]) < window
    return (_mla_scores(p, cfg, q_nope, q_rope, ckv_all, k_rope_all, mask),
            {"ckv": ckv, "k_rope": k_rope})


def mla_empty_cache(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                    device=None) -> Dict:
    return {"ckv": torch.zeros(batch, s_max, cfg.kv_lora_rank, dtype=dtype,
                               device=device),
            "k_rope": torch.zeros(batch, s_max, cfg.qk_rope_dim,
                                  dtype=dtype, device=device)}


# --- cross-attention (the whisper decoder) -----------------------------------

def cross_init(gen: torch.Generator, cfg, *, dtype=torch.float32) -> Params:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {"wq": dense_init(gen, d, h * dh, dtype=dtype),
            "wk": dense_init(gen, d, h * dh, dtype=dtype),
            "wv": dense_init(gen, d, h * dh, dtype=dtype),
            "wo": dense_init(gen, h * dh, d, dtype=dtype)}


def cross_heads(cfg, mesh) -> Tuple[int, int]:
    """(lo, hi): the heads a rank's cross-attention runs, all of them
    without a model axis over ranks (`mesh` None), else the rank's H /
    |model| (ValueError where they do not divide)."""
    if mesh is None:
        return 0, cfg.n_heads
    index, m = model_coord(mesh)
    if cfg.n_heads % m:
        raise ValueError(f"{cfg.n_heads} heads do not divide a model axis "
                         f"of {m}")
    return index * cfg.n_heads // m, (index + 1) * cfg.n_heads // m


def cross_kv(p: Params, cfg, enc: torch.Tensor) -> Dict:
    """The cross cache {"k", "v": [B, S_enc, H', Dh]} of the encoder's
    output: every head, or under a model axis over ranks the rank's
    (`wk`, `wv` column-parallel over every frame, `enc` through
    `copy_to_model`: each rank reads all of it for its heads)."""
    b, se, _ = enc.shape
    dh = cfg.d_head
    mesh = model_ranks()
    lo, hi = cross_heads(cfg, mesh)
    if mesh is not None:
        enc = copy_to_model(enc, mesh)
    width = cfg.n_heads * dh
    return {n: linear_col(p[w], enc, width, lo * dh, hi * dh)
            .reshape(b, se, hi - lo, dh) for n, w in (("k", "wk"),
                                                       ("v", "wv"))}


def cross_attend(p: Params, cfg, x: torch.Tensor, kv: Dict) -> torch.Tensor:
    """x [B,Sq,D] against every encoder position (no mask, no rope); under
    a model axis over ranks on the rank's heads of `kv` (`wq`
    column-parallel, the caller's x through `copy_to_model`, `wo`
    row-parallel: the one collective, at prefill and decode alike)."""
    b, sq, _ = x.shape
    dh = cfg.d_head
    lo, hi = cross_heads(cfg, model_ranks())
    q = linear_col(p["wq"], x, cfg.n_heads * dh, lo * dh, hi * dh) \
        .reshape(b, sq, hi - lo, dh)
    mask = torch.ones(1, sq, kv["k"].shape[1], dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, kv["k"], kv["v"], mask, 1)
    return _out(p, cfg, out.reshape(b, sq, -1))
