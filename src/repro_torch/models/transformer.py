"""Model trunk for the dense, vlm, MoE, SSM, hybrid and audio families
(port of `repro.models.transformer`).

Public interface (functions of (params, cfg, ...)):

  init_params(seed, cfg, device=)              -> params
  abstract_params(cfg)                         -> params on the meta device
  train_loss(params, cfg, batch)               -> (loss, metrics)
  prefill(params, cfg, batch)                  -> (logits_last, caches)
  decode_step(params, cfg, tokens, caches, pos, ctx_len) -> (logits, caches)
  empty_caches(cfg, batch, s_max, device=)     -> caches
  abstract_caches(cfg, batch, s_max)           -> caches on the meta device
  lm_from_jax(params, cfg, device=)            -> params

Family assembly:
  dense | vlm     : N x dense_block; vlm's batch may carry the stub
                    frontend's patch embeddings (`batch["patch_embeds"]`
                    [B, n_patches, D]), which replace the first n_patches
                    token embeddings (decode embeds tokens only)
  moe             : N x moe_block (GQA or MLA attention, MoE FFN)
  ssm             : N x ssm_block (Mamba2 SSD)
  hybrid (zamba2) : G groups of [attn_every x ssm_block], each followed by
                    the one shared dense_block (weights SHARED across
                    sites, a cache per site), then the tail ssm_blocks
  audio (whisper) : an encoder of bidirectional dense blocks over the
                    batch's frame embeddings (`batch["frames"]`, the stub
                    frontend's output), then N x xdec_block (self- and
                    cross-attention); the cross caches hold the encoder's
                    keys and values

Layers are stacked ([L, ...] leaves, as the reference stacks them for
`lax.scan`; the hybrid's groups [G, per, ...]) and driven by Python
loops.  Nothing is traced, so one decode loop serves every route:
`decode_step_eager`, the reference's untraced twin of its scanned
`decode_step` for the DRIM engines, is the same function here.
`ctx_len`, the decode cache length, sets the hybrid's attention window
(`_window_for`); a prefill's window comes from its own length.  For
training, `cfg.remat` wraps each layer (the hybrid: each group) in
`torch.utils.checkpoint`, as the reference wraps its scan bodies in
`jax.checkpoint`: the backward runs that forward again, so a dense step
runs the flash forward kernel twice per layer.  The blocks' auxiliary
losses (MoE routing) are summed over the layers into `train_loss`.

Under a `model` axis over ranks (`core.mesh.model_ranks`; every family)
the embedding is a vocab-parallel lookup, the head's logits are the rank's
vocabulary block (the pad mask at the global column), and `train_loss` is
the vocab-parallel cross-entropy: the row max by a MAX all-reduce, the
sum of exps and the target logit (from the rank that holds it) by sums
over the model group, never a [B, S, V] gather.  Under `cfg.seq_parallel`
(the reference's `_sp`, its default) the residual is cut over the
sequence where the axis divides an S > 1 (`_seq_block`): the dense, vlm
and moe trunks' (the vocab-parallel embedding's sum reduce-scattered to
the rank's block, the vlm's patches of its positions, the blocks'
`seq_cut`, training's final norm on the block and the normed block
gathered into the vocab-parallel head; the replicated norm scales' and
the final norm's gradients are then the rank's partials, summed in the
step: `cuts_sequence`, `runtime.sharding.sequence_partial`), the audio
encoder's over its frames (its output gathered before `enc_norm`), and
the ssm family's.  The hybrid's and the audio decoder's stay whole.  The
ssm family's params are replicated (`runtime.sharding.param_pspecs`):
its ranks embed their own tokens, each takes the whole vocabulary's
logits and cross-entropy on its own positions, and the cross-entropy's
sum and token count are summed over the model group as well as the data
group.  The audio family's encoder and decoder run on the rank's heads
(the dense cut; the cross-attention's `wq`, `wk`, `wv` column-parallel
and `wo` row-parallel).  Over ranks
`prefill` and `decode_step` take the global batch (its every tensor, the
audio frames too), run the rank's rows (cut over the data axes, or every
row where the data axes do not divide the batch, as `sanitize_spec`
leaves it: a batch-1 prefill) and return the whole [B, 1, V] logits on
every rank (the last position gathered), so every rank samples the same
token (a sequence-cut prefill gathers only its last position); their
caches are the rank's blocks of
`runtime.sharding.rank_cache_pspecs` (K/V and latents cut over the
sequence: prefill re-lays its head-cut K/V, and cuts the MLA latent that
every rank holds whole, into them; SSM states cut over heads, conv
windows whole; the cross cache the rank's heads of every frame), and
`empty_caches` gives those blocks.  `init_params` there draws only the
rank's blocks of the params.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.mesh import (PartitionSpec, ambient_mesh,
                                   ambient_ranks, copy_to_model, dp_axes,
                                   gather_from_model, gather_from_sequence,
                                   local_block, local_shape, mesh_all_gather,
                                   mesh_max, mesh_sum, model_coord,
                                   model_ranks, reduce_from_model,
                                   sanitize_spec, scatter_to_model,
                                   vocab_lookup)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.moe import ExpertBank
from repro_torch.models.layers import (SEQ_DIM, Params, part_of, rmsnorm,
                                       rmsnorm_init)
from repro_torch.runtime.sharding import (_path_str, is_cross_cache,
                                         param_ranks, sequence_parallel)
from repro_torch.tree import (tree_leaves, tree_map, tree_map_with_path,
                             tree_slice, tree_stack, tree_unstack)

LB_COEF, Z_COEF = 0.01, 1e-3
LONG_CTX_THRESHOLD = 131072


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio"):
        raise ValueError(f"unknown family {cfg.family!r}")


def _window_for(cfg, ctx_len: int) -> int:
    """The hybrid's shared attention is windowed at long context."""
    if cfg.family == "hybrid" and ctx_len >= LONG_CTX_THRESHOLD:
        return cfg.long_context_window
    return 0


def _block_fns(cfg):
    _check_family(cfg)
    if cfg.family in ("dense", "vlm"):
        return B.dense_block_init, B.dense_block, B.dense_block_decode
    if cfg.family == "moe":
        return B.moe_block_init, B.moe_block, B.moe_block_decode
    if cfg.family == "ssm":
        return B.ssm_block_init, B.ssm_block, B.ssm_block_decode
    raise ValueError(cfg.family)


def _hybrid_layout(cfg) -> Tuple[int, int, int]:
    """(n_groups, per_group, tail) for the zamba2 layout."""
    per = cfg.attn_every
    groups = cfg.n_layers // per
    return groups, per, cfg.n_layers - groups * per


def padded_vocab(cfg) -> int:
    """Embedding/head vocab dim rounded up to cfg.vocab_pad_multiple; the
    logical vocab stays cfg.vocab_size and `_logits` masks the pad."""
    m = getattr(cfg, "vocab_pad_multiple", 1) or 1
    return -(-cfg.vocab_size // m) * m


# --- init --------------------------------------------------------------------

def _whole_slices(shape) -> Tuple[slice, ...]:
    return tuple(slice(0, n) for n in shape)


def _rank_slices(mesh, path: str, shape, family: str
                 ) -> Tuple[slice, ...]:
    """The slices of the whole leaf at `path` (the port's "['a']['b']"
    form) of `shape` that this rank keeps: its `local_block` under the
    reference's spec (`runtime.sharding.param_pspecs`: the ssm family's
    replicated); all of it without `mesh`."""
    if mesh is None or sequence_parallel(family):
        return _whole_slices(shape)
    from repro_torch.runtime.sharding import param_spec
    return local_block(tuple(shape), param_spec(
        path, torch.empty(tuple(shape), device="meta"), mesh), mesh)


def _sizes(sl) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in sl)


def _place(leaf, dst: torch.Tensor, sl: Tuple[slice, ...]) -> None:
    """The block `sl` of a drawn leaf copied into its slot of a stacked
    leaf; an expert bank draws only the block's experts, straight into
    it, several at a time."""
    if isinstance(leaf, ExpertBank):
        leaf.draw_into(dst, block=sl)
    else:
        dst.copy_(leaf[sl])


def _draw_stacked(draw_layer, n: int, dev, mesh=None, path: str = "",
                  family: str = "") -> Params:
    """n layers drawn in turn, each moved into the stacked [n, ...] leaves
    preallocated on `dev` as soon as it is drawn, so the host holds one
    layer at a time (and no expert bank whole).  Under a mesh of ranks
    (`mesh`; the stack at `path`) the stacked leaves are this rank's
    blocks (`_rank_slices`): every layer is still drawn, in order, so the
    generator's stream is one process's.  On the meta device one layer's
    shapes give the stack's: nothing is drawn."""
    if dev.type == "meta":
        return tree_map(lambda leaf: torch.empty(
            (n, *leaf.shape), dtype=leaf.dtype, device=dev), draw_layer())
    out = cuts = None
    for i in range(n):
        layer = draw_layer()
        if out is None:
            cuts = tree_map_with_path(lambda p, leaf: _rank_slices(
                mesh, path + p, (n, *leaf.shape), family), layer)
            out = tree_map(lambda leaf, sl: torch.empty(
                _sizes(sl), dtype=leaf.dtype, device=dev), layer, cuts)

        def put(dst, leaf, sl, i=i):
            if sl[0].start <= i < sl[0].stop:
                _place(leaf, dst[i - sl[0].start], sl[1:])
        tree_map(put, out, layer, cuts)
    return out


def init_params(seed, cfg, *, device=None) -> Params:
    """Seeded parameters (an int seed or a `torch.Generator`), drawn on
    the CPU so a seed gives the same weights on every machine, each leaf
    moved to `device` (None: the card) as it is drawn.  The MoE expert
    banks are drawn by several threads (`ExpertBank.draw_into`); the
    weights do not depend on how many.

    Inside a mesh of ranks whose model axis holds several ranks
    (`core.mesh.model_ranks`) each leaf is this rank's block of it under
    the reference's specs, and only the blocks reach the device: every
    other leaf is still drawn whole on the host, in one process's order,
    and cut there; an expert bank draws only its block's experts (each
    has its own seed).  The result is `init_params` then the cut, leaf
    for leaf, without a whole layer on the device (one full-width
    kimi-k2 layer is 38.9 GB)."""
    _check_family(cfg)
    gen = (seed if isinstance(seed, torch.Generator)
           else torch.Generator().manual_seed(int(seed)))
    return _init_params(gen, cfg, resolve_device(device), model_ranks())


def abstract_params(cfg) -> Params:
    """The parameter tree as meta tensors: the shapes and dtypes
    `init_params` gives, with no storage and no draw (the reference's
    `jax.eval_shape(init_params, key, cfg)`), so a 671 B-parameter tree
    costs no memory.  For specs and dry runs; nothing can run on it."""
    _check_family(cfg)
    meta = torch.device("meta")
    with meta:
        return _init_params(torch.Generator(), cfg, meta)


def _init_params(gen: torch.Generator, cfg, dev: torch.device,
                 mesh=None) -> Params:
    dtype = getattr(torch, cfg.param_dtype)
    v, d = padded_vocab(cfg), cfg.d_model

    def keep(path: str, t: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return t.to(dev)
        return t[_rank_slices(mesh, path, t.shape, cfg.family)].clone() \
            .to(dev)

    def kept(path: str, tree) -> Params:
        return tree_map_with_path(lambda p, t: keep(path + p, t), tree)

    p: Params = {
        "embed": keep("['embed']", torch.randn(v, d, generator=gen)
                      .mul_(0.01).to(dtype)),
        "final_norm": kept("['final_norm']", rmsnorm_init(d)),
        "head": keep("['head']", torch.randn(d, v, generator=gen)
                     .mul_(0.01).to(dtype)),
    }

    def stacked(init_fn, n: int, name: str):
        return _draw_stacked(lambda: init_fn(gen, cfg, dtype=dtype), n, dev,
                             mesh, f"[{name!r}]", cfg.family)

    if cfg.family == "audio":
        p["enc_layers"] = stacked(B.dense_block_init, cfg.encoder_layers,
                                  "enc_layers")
        p["enc_norm"] = kept("['enc_norm']", rmsnorm_init(d))
        p["layers"] = stacked(B.xdec_block_init, cfg.n_layers, "layers")
    elif cfg.family == "hybrid":
        groups, per, tail = _hybrid_layout(cfg)
        p["mamba_groups"] = tree_map(
            lambda t: t.reshape(groups, per, *t.shape[1:]),
            stacked(B.ssm_block_init, groups * per, "mamba_groups"))
        if tail:
            p["mamba_tail"] = stacked(B.ssm_block_init, tail, "mamba_tail")
        p["shared"] = kept("['shared']", B.dense_block_init(
            gen, cfg, dtype=dtype))
    else:
        p["layers"] = stacked(_block_fns(cfg)[0], cfg.n_layers, "layers")
    return p


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


def _depth(p: Params) -> int:
    """Stacked layers in a parameter tree: `layers`, or the hybrid's
    `mamba_groups` [G, per, ...] plus `mamba_tail`."""
    if "layers" in p:
        return tree_leaves(p["layers"])[0].shape[0]
    g = tree_leaves(p["mamba_groups"])[0]
    tail = tree_leaves(p.get("mamba_tail"))
    return g.shape[0] * g.shape[1] + (tail[0].shape[0] if tail else 0)


def lm_from_jax(params, cfg, *, device=None) -> Params:
    """The reference's stacked parameter tree (numpy arrays, as
    `jax.tree.map(np.asarray, params)` gives them) as the port's, each
    leaf keeping its dtype."""
    _check_family(cfg)
    dev = resolve_device(device)
    out = tree_map(lambda a: _to_torch(np.asarray(a), dev), params)
    embed = tuple(out["embed"].shape)
    if embed != (padded_vocab(cfg), cfg.d_model):
        raise ValueError(f"embed {embed} does not match the config's "
                         f"({padded_vocab(cfg)}, {cfg.d_model})")
    depth = _depth(out)
    if depth != cfg.n_layers:
        raise ValueError(f"{depth} stacked layers, the config has "
                         f"{cfg.n_layers}")
    if cfg.family == "audio":
        enc = tree_leaves(out["enc_layers"])[0].shape[0]
        if enc != cfg.encoder_layers:
            raise ValueError(f"{enc} stacked encoder layers, the config "
                             f"has {cfg.encoder_layers}")
    return out


# --- embedding / head --------------------------------------------------------

def _embed(p, cfg, tokens: torch.Tensor, batch: Dict[str, Any],
           block=None) -> torch.Tensor:
    """Token embeddings; for vlm with `patch_embeds` in the batch, the
    patches then the token embeddings past them, as the reference
    concatenates them (a prompt shorter than the patches gives a
    patch-long sequence there too).  Under a model axis over ranks: the
    vocab-parallel lookup (a table cut over d_model by the specs'
    fallback: the rank's columns, gathered).  `block` (lo, hi): the
    rank's positions of a sequence-cut residual, the vocab-parallel sum
    reduce-scattered to them (a whole table's or a gathered lookup cut to
    them, its gradient gathered) and the patches of those positions."""
    table = p["embed"]
    mesh = model_ranks()
    cut = block is not None
    if mesh is None or table.shape == (padded_vocab(cfg), cfg.d_model):
        x = table[tokens.long()]
    elif table.shape[1] == cfg.d_model:
        x = vocab_lookup(table, tokens, model_coord(mesh)[0]
                         * table.shape[0], mesh, SEQ_DIM if cut else None)
        cut = False                     # the block already
    else:
        x = gather_from_model(table[tokens.long()], mesh, -1)
    x = x.to(cfg.activation_dtype)
    if cut:
        x = scatter_to_model(x, mesh, SEQ_DIM)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"].to(x.dtype)
        lo, hi = (0, pe.shape[1]) if block is None else block
        n = min(max(pe.shape[1] - lo, 0), hi - lo)  # patches in the block
        x = torch.cat([pe[:, lo:lo + n], x[:, n:, :]], dim=1)
    return x


def _span(s: int):
    """(lo, hi) of this rank's block of S positions cut over the model
    axis of ranks, or None: no such axis, S == 1, or S the axis does not
    divide."""
    mesh = model_ranks()
    if mesh is None or s < 2:
        return None
    index, m = model_coord(mesh)
    if s % m:
        return None
    return index * s // m, (index + 1) * s // m


def _seq_block(cfg, s: int):
    """(lo, hi) of the sequence positions this rank's trunk residual
    holds, or None where it is whole: under `cfg.seq_parallel` the dense,
    vlm, moe and ssm families cut an S > 1 the model axis of ranks
    divides (the reference's `_sp`).  The hybrid's residual stays whole,
    and so does the audio decoder's (its encoder's: `_enc_block`)."""
    if not cfg.seq_parallel or cfg.family not in ("dense", "vlm", "moe",
                                                  "ssm"):
        return None
    return _span(s)


def _enc_block(cfg, n_frames: int):
    """`_seq_block` of the audio encoder's residual of `n_frames`."""
    if not cfg.seq_parallel or cfg.family != "audio":
        return None
    return _span(n_frames)


def _residual_block(cfg, batch: Dict[str, Any]):
    """`_seq_block` of a full-sequence batch's trunk residual: whole for
    a vlm prompt shorter than its patches (the residual is the patches'
    length)."""
    s = batch["tokens"].shape[1]
    pe = batch.get("patch_embeds")
    if cfg.family == "vlm" and pe is not None and pe.shape[1] > s:
        return None
    return _seq_block(cfg, s)


def cuts_sequence(cfg, batch: Dict[str, Any]) -> bool:
    """Whether a full-sequence step on `batch` (the rank's rows) inside
    the ambient mesh holds a sequence-cut residual whose replicated norm
    scales take each rank's partial gradient (`runtime.sharding.
    sequence_partial`): the dense, vlm and moe trunks', the audio
    encoder's."""
    if cfg.family == "audio":
        return _enc_block(cfg, batch["frames"].shape[1]) is not None
    return cfg.family != "ssm" and _residual_block(cfg, batch) is not None


def grad_axes(cfg, mesh) -> Tuple[str, ...]:
    """The axes of a mesh of ranks over which the ranks' shares of the
    loss and of its gradients are summed: the data axes, and "model" for
    the ssm family under `cfg.seq_parallel`, whose ranks of a model group
    each hold a block of the sequence and the whole params."""
    return dp_axes(mesh) + (("model",) if sequence_parallel(cfg.family)
                            and cfg.seq_parallel else ())


def _logits(p, cfg, x: torch.Tensor) -> torch.Tensor:
    """The logits [..., V] float32, the pad columns masked; under a model
    axis over ranks gathered from the ranks' vocabulary blocks."""
    mesh = param_ranks(cfg)
    if mesh is not None:
        return gather_from_model(_vocab_logits(p, cfg, x, mesh)[0], mesh, -1)
    x = rmsnorm(p["final_norm"], x)
    logits = (x @ p["head"].to(x.dtype)).to(torch.float32)
    v_pad = p["head"].shape[-1]
    if v_pad != cfg.vocab_size:          # mask the pad columns
        col = torch.arange(v_pad, device=x.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits


def _vocab_logits(p, cfg, x: torch.Tensor, mesh, seq_cut: bool = False
                  ) -> Tuple[torch.Tensor, int]:
    """(this rank's block of the logits [..., V / |model|] float32, the
    block's first column): the column-parallel head, its pad columns
    masked at their global index.  `seq_cut`: x is the rank's block of a
    sequence-cut residual [B, S / |model|, D], normed there and gathered
    (`gather_from_sequence`), so the logits cover every position."""
    index, m = model_coord(mesh)
    v = padded_vocab(cfg)
    if v % m:
        raise ValueError(f"a vocabulary of {v} does not divide a model "
                         f"axis of {m}")
    lo, hi = index * v // m, (index + 1) * v // m
    x = rmsnorm(p["final_norm"], x)
    x = gather_from_sequence(x, mesh, SEQ_DIM) if seq_cut \
        else copy_to_model(x, mesh)
    head = part_of(p["head"], (cfg.d_model, v), 1, lo, hi, mesh)
    logits = (x @ head.to(x.dtype)).to(torch.float32)
    if v != cfg.vocab_size:
        col = torch.arange(lo, hi, device=x.device)
        logits = logits.masked_fill(col >= cfg.vocab_size, -1e30)
    return logits, lo


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                       mesh) -> torch.Tensor:
    """logsumexp(logits) - logits[label] per token from this rank's
    vocabulary block [lo, lo + V_loc): the max by a MAX all-reduce (no
    gradient: the result does not depend on it), the sum of exps and the
    target logit (zero on the ranks that do not hold it) by sums over
    the model group."""
    top = mesh_max([logits.detach().amax(-1)], mesh)[0]
    sumexp = reduce_from_model(torch.exp(logits - top[..., None]).sum(-1),
                               mesh)
    local = labels - lo
    inside = (local >= 0) & (local < logits.shape[-1])
    picked = logits.gather(-1, local.clamp(0, logits.shape[-1] - 1)[..., None]
                           )[..., 0] * inside.to(logits.dtype)
    return top + torch.log(sumexp) - reduce_from_model(picked, mesh)


def _row_spec(n: int, mesh) -> PartitionSpec:
    """The spec of a global batch of `n` rows: cut over the data axes, or
    replicated where they do not divide it (`sanitize_spec`)."""
    return sanitize_spec(PartitionSpec(dp_axes(mesh)), (n,), mesh)


def _rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch tensor (cut over the data
    axes, contiguous in rank order; all of them where the axes do not
    divide the batch)."""
    return t[local_block((t.shape[0],), _row_spec(t.shape[0], mesh),
                         mesh)[0]]


def _whole_rows(t: torch.Tensor, n: int, mesh) -> torch.Tensor:
    """The global batch's `n` rows from every data rank's (`_rows`'
    inverse)."""
    if _row_spec(n, mesh) == PartitionSpec():
        return t
    return mesh_all_gather(t, mesh, dp_axes(mesh), 0)


# --- full-sequence forward (train / prefill) ---------------------------------

def _zero_aux(device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, device=device) for k, v in B.ZERO_AUX.items()}


def _layer(mesh, block_fn, layer_p, cfg, x, positions, window, *extra):
    """A remat layer, inside the forward's ambient `mesh` (None: none):
    the backward recomputes it on the autograd engine's thread, where the
    forward's `with mesh:` is not in effect (on the card)."""
    with (mesh if mesh is not None else contextlib.nullcontext()):
        x, _, aux = block_fn(layer_p, cfg, x, positions, *extra,
                             window=window)
    return x, aux


def _run_layers(p_layers, n: int, cfg, block_fn, x, positions, window, *,
                remat: bool, with_cache: bool, extra=()):
    """n stacked layers in turn: (x, the layers' auxiliary losses summed
    in layer order, stacked caches or None)."""
    aux = _zero_aux(x.device)
    caches = []
    for layer_p in tree_unstack(p_layers, n):
        if remat:
            x, aux_l = checkpoint(_layer, ambient_mesh(), block_fn, layer_p,
                                  cfg, x, positions, window, *extra,
                                  use_reentrant=False)
        else:
            x, cache, aux_l = block_fn(layer_p, cfg, x, positions, *extra,
                                       window=window)
            caches.append(cache)
        aux = {k: aux[k] + aux_l[k] for k in aux}
    return x, aux, (tree_stack(caches) if with_cache else None)


def _forward_full(p, cfg, batch: Dict[str, Any], *, with_cache: bool):
    tokens = batch["tokens"]
    bsz, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :] \
        .expand(bsz, s)
    window = _window_for(cfg, s)
    block = _residual_block(cfg, batch)
    if block is not None and cfg.family == "ssm":
        # the ssm family's replicated table: each rank its own tokens
        x = _embed(p, cfg, tokens[:, block[0]:block[1]], batch)
    else:
        x = _embed(p, cfg, tokens, batch, block)
    remat = cfg.remat and not with_cache and torch.is_grad_enabled()
    if cfg.family == "hybrid":
        x, caches = _hybrid_full(p, cfg, x, positions, window, remat=remat,
                                 with_cache=with_cache)
        return x, _zero_aux(x.device), caches
    if cfg.family == "audio":
        enc = batch["frames"].to(cfg.activation_dtype)
        enc_pos = torch.arange(enc.shape[1], device=enc.device)[None, :] \
            .expand(bsz, enc.shape[1])
        frames = _enc_block(cfg, enc.shape[1])
        if frames is not None:      # the encoder's sequence-cut residual
            enc = enc[:, frames[0]:frames[1]]
        enc, _, _ = _run_layers(
            p["enc_layers"], cfg.encoder_layers, cfg,
            functools.partial(B.dense_block, causal=False,
                              seq_cut=frames is not None),
            enc, enc_pos, 0, remat=remat, with_cache=False)
        if frames is not None:
            # every decoder layer's cross_kv completes the gradient of
            # the whole: the rank keeps its block's
            enc = gather_from_model(enc, model_ranks(), SEQ_DIM)
        enc = rmsnorm(p["enc_norm"], enc)
        return _run_layers(p["layers"], cfg.n_layers, cfg, B.xdec_block, x,
                           positions, window, remat=remat,
                           with_cache=with_cache, extra=(enc,))
    _, block_fn, _ = _block_fns(cfg)
    if block is not None:
        block_fn = functools.partial(block_fn, seq_cut=True)
    return _run_layers(p["layers"], cfg.n_layers, cfg, block_fn, x,
                       positions, window, remat=remat, with_cache=with_cache)


def _hybrid_full(p, cfg, x, positions, window, *, remat: bool,
                 with_cache: bool):
    """The zamba2 trunk: each group's ssm blocks, then the shared dense
    block at that group's site; then the tail blocks.  Caches
    {"groups" [G, per, ...], "shared" [G, ...], "tail" [T, ...] or None}."""
    groups, per, tail = _hybrid_layout(cfg)

    def group(group_p, h):
        m_caches = []
        for layer_p in tree_unstack(group_p, per):
            h, cache, _ = B.ssm_block(layer_p, cfg, h)
            m_caches.append(cache)
        h, a_cache, _ = B.dense_block(p["shared"], cfg, h, positions,
                                      window=window)
        return h, tree_stack(m_caches), a_cache

    g_caches, s_caches = [], []
    mesh = ambient_mesh()

    def remat_group(gp, h):
        with (mesh if mesh is not None else contextlib.nullcontext()):
            return group(gp, h)[0]

    for group_p in tree_unstack(p["mamba_groups"], groups):
        if remat:
            x = checkpoint(remat_group, group_p, x, use_reentrant=False)
        else:
            x, m_cache, a_cache = group(group_p, x)
            g_caches.append(m_cache)
            s_caches.append(a_cache)
    t_caches = []
    for layer_p in tree_unstack(p.get("mamba_tail"), tail):
        x, cache, _ = B.ssm_block(layer_p, cfg, x)
        t_caches.append(cache)
    if not with_cache:
        return x, None
    return x, {"groups": tree_stack(g_caches),
               "shared": tree_stack(s_caches),
               "tail": tree_stack(t_caches) if tail else None}


# --- train loss --------------------------------------------------------------

def train_loss(params, cfg, batch: Dict[str, Any]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch {"tokens", "labels": [B, S]} -> (loss, metrics): the mean
    cross-entropy over labels >= 0 plus the auxiliary losses, with the
    reference's metrics (ce, aux_lb, aux_z, ntokens).  Inside a step over
    ranks (`core.mesh.ambient_ranks`) `batch` is this rank's rows and the
    CE's denominator is the global batch's token count; under a model
    axis the CE is the vocab-parallel one."""
    x, aux, _ = _forward_full(params, cfg, batch, with_cache=False)
    labels = batch["labels"].long()
    block = _residual_block(cfg, batch)
    if block is not None and cfg.family == "ssm":
        # the ssm family's loss on the rank's own positions
        labels = labels[:, block[0]:block[1]]
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp_min(0)
    tp = param_ranks(cfg)
    if tp is None:
        logits = _logits(params, cfg, x)                   # [B,S,V] f32
        lse = torch.logsumexp(logits, dim=-1)
        nll = lse - logits.gather(-1, safe[..., None])[..., 0]
    else:
        logits, lo = _vocab_logits(params, cfg, x, tp,     # [B,S,V/M]
                                   seq_cut=block is not None)
        nll = _vocab_parallel_ce(logits, safe, lo, tp)
    ntokens = mask.sum()
    ranks = ambient_ranks()
    over = None if ranks is None else grad_axes(cfg, ranks)
    if ranks is not None:
        ntokens = mesh_sum([ntokens], ranks, over)[0]
    ce = (nll * mask).sum() / ntokens.clamp_min(1.0)
    loss = ce + LB_COEF * aux["load_balance"] + Z_COEF * aux["router_z"]
    metrics = {"ce": ce, "aux_lb": aux["load_balance"],
               "aux_z": aux["router_z"], "ntokens": ntokens}
    if ranks is None:
        return loss, metrics
    # a rank of a data-parallel step: `loss` is its share of the global
    # batch's (the CE over the global token count, the MoE's aux shares),
    # so the ranks' gradients sum to the global gradient; the metrics
    # and the returned loss's value are the global ones, equal on every
    # rank, and its gradient is the share's
    ce, lb, z = mesh_sum([torch.stack([ce, aux["load_balance"],
                                       aux["router_z"]]).detach()],
                         ranks, over)[0].unbind()
    total = ce + LB_COEF * lb + Z_COEF * z
    metrics.update(ce=ce, aux_lb=lb, aux_z=z)
    return total + (loss - loss.detach()), metrics


# --- prefill -----------------------------------------------------------------

def prefill(params, cfg, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Any]:
    """batch {"tokens": [B, S]} (audio: and "frames" [B, n_frames, D];
    vlm: and optionally "patch_embeds" [B, n_patches, D]) ->
    (logits of the last position [B, 1, V] float32, caches: stacked
    [L, B, S, Hkv, Dh] keys and values (dense, GQA moe), MLA latents,
    [L, B, ...] SSM states (ssm), the hybrid's nested tree, or audio's
    {"self", "cross"}).  Over ranks: the rank's rows run, the logits
    come back whole, the caches as the rank's `cache_pspecs` blocks."""
    ranks = ambient_ranks()
    n = batch["tokens"].shape[0]
    if ranks is not None:
        batch = {k: _rows(v, ranks) for k, v in batch.items()}
    x, _, caches = _forward_full(params, cfg, batch, with_cache=True)
    last = x[:, -1:, :]
    tp = model_ranks()
    if _residual_block(cfg, batch) is not None:
        # the last position is the last model rank's
        last = mesh_all_gather(last, tp, ("model",), 1)[:, -1:, :]
    logits = _logits(params, cfg, last)
    if ranks is None:
        return logits, caches
    if tp is not None:
        caches = _rank_caches(cfg, caches, tp)
    return _whole_rows(logits, n, ranks), caches


def _rank_caches(cfg, caches, mesh):
    """The rank's `rank_cache_pspecs` blocks of a prefill's caches, which
    hold the rank's rows: keys and values cut over the sequence
    (`_sequence_cut`), likewise the MLA latents, the SSM states cut over
    heads where the axis divides them, the conv windows whole, the cross
    cache as it is (the rank's heads)."""
    index, m = model_coord(mesh)

    def one(path, t):
        name = _path_str(path).split("/")[-1]
        if is_cross_cache(_path_str(path)):
            return t
        if name in ("k", "v", "ckv", "k_rope"):
            return _sequence_cut(cfg, t, mesh, heads=name in ("k", "v"))
        if name == "state" and t.shape[-3] % m == 0:
            h = t.shape[-3] // m
            return t.narrow(-3, index * h, h).contiguous()
        return t
    return tree_map_with_path(one, caches)


def _sequence_cut(cfg, t: torch.Tensor, mesh, heads: bool = True
                  ) -> torch.Tensor:
    """Stacked head-cut keys or values [L, B', S, Hkv', Dh] (each rank
    its `head_split` KV heads, padded for the gather; `heads`) or the
    MLA's latent or rope key [L, B', S, R] (whole on every rank) as the
    rank's block of the sequence-cut cache [L, B', S / |model|, ...]
    (whole S where the axis does not divide it, as `sanitize_spec`
    leaves it)."""
    index, m = model_coord(mesh)
    every = t if not heads else attn_mod.all_heads(
        cfg, mesh_all_gather(attn_mod.pad_kv(t, cfg, m, 3), mesh,
                             ("model",), 3), m, dim=3)
    s = every.shape[2]
    if s % m:
        return every
    return every[:, :, index * s // m:(index + 1) * s // m].contiguous()


# --- decode ------------------------------------------------------------------

def decode_step(params, cfg, tokens: torch.Tensor, caches, pos: torch.Tensor,
                ctx_len: int) -> Tuple[torch.Tensor, Any]:
    """tokens [B, 1]; pos [B] write index; ctx_len the cache length ->
    (logits [B, 1, V] float32, new caches).  Inside a
    `layers.serving_engine` scope the BitLinear GEMMs run on the DRIM
    fleet.  Over ranks: the global tokens and positions, the rank's
    cache blocks, the whole logits on every rank."""
    ranks = ambient_ranks()
    if ranks is not None:
        logits, caches = _decode(params, cfg, _rows(tokens, ranks), caches,
                                 _rows(pos, ranks), ctx_len)
        return _whole_rows(logits, tokens.shape[0], ranks), caches
    return _decode(params, cfg, tokens, caches, pos, ctx_len)


def _decode(params, cfg, tokens, caches, pos, ctx_len):
    window = _window_for(cfg, ctx_len)
    x = _embed(params, cfg, tokens, {})
    kw = {"ctx_len": ctx_len} if model_ranks() is not None else {}
    if cfg.family == "hybrid":
        return _hybrid_decode(params, cfg, x, caches, pos, window, kw)
    decode_fn = (B.xdec_block_decode if cfg.family == "audio"
                 else _block_fns(cfg)[2])
    new_caches = []
    for i in range(cfg.n_layers):
        x, nc = decode_fn(tree_slice(params["layers"], i), cfg, x,
                          tree_slice(caches, i), pos, window=window, **kw)
        new_caches.append(nc)
    return _logits(params, cfg, x), tree_stack(new_caches)


decode_step_eager = decode_step


def _hybrid_decode(params, cfg, x, caches, pos, window, kw):
    groups, per, tail = _hybrid_layout(cfg)
    new_groups, new_shared = [], []
    for g in range(groups):
        group_p = tree_slice(params["mamba_groups"], g)
        group_c = tree_slice(caches["groups"], g)
        new_m = []
        for i in range(per):
            x, nc = B.ssm_block_decode(tree_slice(group_p, i), cfg, x,
                                       tree_slice(group_c, i))
            new_m.append(nc)
        x, new_a = B.dense_block_decode(params["shared"], cfg, x,
                                        tree_slice(caches["shared"], g), pos,
                                        window=window, **kw)
        new_groups.append(tree_stack(new_m))
        new_shared.append(new_a)
    new_tail = []
    for i in range(tail):
        x, nc = B.ssm_block_decode(tree_slice(params["mamba_tail"], i), cfg,
                                   x, tree_slice(caches["tail"], i))
        new_tail.append(nc)
    return _logits(params, cfg, x), {
        "groups": tree_stack(new_groups), "shared": tree_stack(new_shared),
        "tail": tree_stack(new_tail) if tail else None}


# --- cache constructors ------------------------------------------------------

def empty_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16,
                 device=None):
    """Zeroed decode caches in prefill's layout: dense, vlm and GQA moe
    [L, batch, s_max, Hkv, Dh] keys and values, MLA moe [L, batch, s_max,
    r_kv] latents and [L, batch, s_max, dr] rope keys (`dtype`); ssm
    [L, batch, ...] float32 states; hybrid {"groups" [G, per, batch, ...],
    "shared" [G, batch, s_max, Hkv, Dh], "tail" [T, batch, ...] or None};
    audio {"self": GQA, "cross": [L, batch, n_frames, H, Dh]}.  Inside a
    mesh of ranks, this rank's blocks of them (`runtime.sharding.
    rank_cache_pspecs`)."""
    _check_family(cfg)
    ranks = ambient_ranks()
    if ranks is None:
        return _empty_caches(cfg, batch, s_max, dtype,
                             resolve_device(device))
    from repro_torch.runtime.sharding import rank_cache_pspecs
    whole = abstract_caches(cfg, batch, s_max, dtype)
    return tree_map(lambda t, spec: torch.zeros(
        local_shape(tuple(t.shape), spec, ranks), dtype=t.dtype,
        device=resolve_device(device)), whole,
        rank_cache_pspecs(ranks, whole))


def abstract_caches(cfg, batch: int, s_max: int, dtype=torch.bfloat16):
    """`empty_caches`'s tree as meta tensors (no storage), for specs."""
    _check_family(cfg)
    meta = torch.device("meta")
    with meta:
        return _empty_caches(cfg, batch, s_max, dtype, meta)


def _empty_caches(cfg, batch: int, s_max: int, dtype, dev: torch.device):
    def stack(n, c):
        return tree_map(lambda t: t[None].expand(n, *t.shape).contiguous(), c)

    if cfg.family in ("dense", "vlm"):
        return stack(cfg.n_layers, attn_mod.gqa_empty_cache(
            cfg, batch, s_max, dtype, dev))
    if cfg.family == "moe":
        empty = (attn_mod.mla_empty_cache if cfg.mla
                 else attn_mod.gqa_empty_cache)
        return stack(cfg.n_layers, empty(cfg, batch, s_max, dtype, dev))
    if cfg.family == "audio":
        shp = (batch, cfg.n_frames, cfg.n_heads, cfg.d_head)
        cross = {"k": torch.zeros(shp, dtype=dtype, device=dev),
                 "v": torch.zeros(shp, dtype=dtype, device=dev)}
        return stack(cfg.n_layers, {
            "self": attn_mod.gqa_empty_cache(cfg, batch, s_max, dtype, dev),
            "cross": cross})
    m = ssm_mod.ssm_empty_cache(cfg, batch, device=dev)
    if cfg.family == "ssm":
        return stack(cfg.n_layers, m)
    groups, per, tail = _hybrid_layout(cfg)
    return {"groups": stack(groups, stack(per, m)),
            "shared": stack(groups, attn_mod.gqa_empty_cache(
                cfg, batch, s_max, dtype, dev)),
            "tail": stack(tail, m) if tail else None}
