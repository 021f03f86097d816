"""Sharding rules: param/batch/cache PartitionSpecs for the production
mesh (port of `repro.runtime.sharding`).

Layout, as in the reference:
  * DP over ("pod", "data")        — batch dim of activations
  * TP over "model"                — Megatron column/row parallel kernels,
                                     vocab-parallel embedding + head
  * EP over "model"                — MoE expert banks
  * KV caches: sequence-sharded over "model", batch-sharded over DP
  * ZeRO-1: optimizer moments additionally sharded over "data" on the
    first divisible replicated dim

Rules are path-pattern based, so they survive stacking (the stacked
layers' leading dims are left-padded with None to the leaf's rank).
Every spec is SANITIZED against the dims: a non-dividing axis falls back
to the rule's next alternative (whisper's 51865 vocab cannot shard, so
its embedding shards d_model) or to replication.

The port's trees are nested dicts whose paths `tree.tree_map_with_path`
writes as "['layers']['moe']['gate']"; `_path_str` turns them into the
reference's "layers/moe/gate", which the rules match.  A leaf is anything
with a `.shape`: a tensor (meta tensors of `models.abstract_params`
included) or an `ExpertBank`.  The specs are computed over
`core.mesh.Mesh`, whose devices may be meta ones (`abstract_mesh`);
`dp_axes`, `sanitize_spec` and its divisibility rule (`fits`) live there.
"""
from __future__ import annotations

import re

from repro_torch.core.mesh import (Mesh, NamedSharding, PartitionSpec as P,
                                   dp_axes, fits, model_ranks, sanitize_spec)
from repro_torch.tree import tree_map, tree_map_with_path


# ---------------------------------------------------------------------------
# Parameter rules: (path substring match, spec for the TRAILING dims)
# ---------------------------------------------------------------------------

_COLUMN = ("model",)          # shard last dim  (e.g. [D, F] -> (None, model))
_ROW = ("model", None)        # shard first of last two ([F, D])
_COLUMN_2 = (None, "model")   # fallback: shard the other matmul dim
_EXPERT = ("model", None, None)  # [E, D, F] expert banks

# Each rule maps a path pattern to a list of ALTERNATIVE trailing specs;
# the first alternative whose named axes divide the dims wins.
_PARAM_RULES = (
    # order matters: first match wins
    ("embed", [("model", None), (None, "model"), ()]),   # [V, D]
    ("head", [(None, "model"), ("model", None), ()]),    # [D, V]
    ("router/kernel", [(None, None)]),                   # replicated router
    ("moe/gate", [_EXPERT]),
    ("moe/up", [_EXPERT]),
    ("moe/down", [_EXPERT]),
    ("shared/gate/kernel", [(None, "model")]),
    ("shared/up/kernel", [(None, "model")]),
    ("shared/down/kernel", [("model", None)]),
    ("wo/kernel", [_ROW, _COLUMN_2]),
    ("wo/bkernel", [_ROW, _COLUMN_2]),
    ("down/kernel", [_ROW, _COLUMN_2]),
    ("down/bkernel", [_ROW, _COLUMN_2]),
    ("out_proj/kernel", [_ROW, _COLUMN_2]),
    ("wq_a/kernel", [(None, None)]),     # MLA low-rank down-projections
    ("wkv_a/kernel", [(None, None)]),
    ("kernel", [(None, "model"), ("model", None)]),  # column-parallel
    ("bkernel", [(None, "model"), ("model", None)]),
    ("w_packed", [("model", None)]),     # packed BitLinear [N, W]
    ("alpha", [("model",)]),
    ("conv_w", [(None, "model")]),
    ("conv_b", [("model",)]),
    ("bias", [("model",)]),
    ("", [()]),                          # norms/scalars: replicated
)

_KEY = re.compile(r"\[(?:'((?:[^'\\]|\\.)*)'|(-?\d+))\]")


def _path_str(path) -> str:
    """The reference's "a/b/c" form of a port path ("['a']['b']['c']") or
    of a sequence of keys."""
    if isinstance(path, str):
        return "/".join(m.group(1) if m.group(1) is not None else m.group(2)
                        for m in _KEY.finditer(path))
    return "/".join(str(k) for k in path)


def _ndim(leaf) -> int:
    return len(leaf.shape)


def _spec_fits(trailing, shape, mesh: Mesh) -> bool:
    t = tuple(trailing)
    if len(t) > len(shape):
        t = t[-len(shape):] if shape else ()
    lead = (None,) * (len(shape) - len(t))
    return all(fits(mesh, entry, dim) for entry, dim in zip(lead + t, shape))


def param_spec(path, leaf, mesh: Mesh) -> P:
    s = _path_str(path)
    shape, ndim = tuple(leaf.shape), _ndim(leaf)
    for pat, alternatives in _PARAM_RULES:
        if pat and pat not in s:
            continue
        for trailing in alternatives:
            if _spec_fits(trailing, shape, mesh):
                t = tuple(trailing)
                if len(t) > ndim:
                    t = t[-ndim:] if ndim else ()
                lead = (None,) * (ndim - len(t))
                return P(*lead, *t)
        return P()  # no alternative fits: replicate
    return P()


def sequence_parallel(family: str | None) -> bool:
    """Whether `family`'s params are all replicated over the model axis:
    the ssm family (pure Mamba2), whose mixer dims do not divide a 16-way
    TP axis, and which only cuts its residual over the sequence (under
    `cfg.seq_parallel`, as the dense, vlm and moe families also do: that
    switch is the config's, `models.transformer._seq_block`)."""
    return family == "ssm"


# The replicated leaves that a residual cut over the sequence applies to
# the rank's block (`models.transformer.cuts_sequence`), so that each
# rank's gradient of them is a partial over the sequence, summed over
# the model group in the step: each block's norm scales and the final
# norm's (the dense, vlm and moe trunks), the encoder blocks' (audio).
# The ssm family sums every gradient over "model" (`grad_axes`); the
# hybrid's shared block and the audio decoder keep the residual whole.
_SEQUENCE_PARTIAL = {
    "dense": ("layers/attn_norm/", "layers/mlp_norm/", "final_norm/"),
    "vlm": ("layers/attn_norm/", "layers/mlp_norm/", "final_norm/"),
    "moe": ("layers/attn_norm/", "layers/mlp_norm/", "final_norm/"),
    "audio": ("enc_layers/attn_norm/", "enc_layers/mlp_norm/"),
}


def sequence_partial(path, family: str | None) -> bool:
    """Whether the leaf at `path` takes each rank's partial gradient over
    the sequence under a sequence-cut residual (`_SEQUENCE_PARTIAL`)."""
    return _path_str(path).startswith(_SEQUENCE_PARTIAL.get(family, ()))


def param_ranks(cfg):
    """The model axis over ranks that cuts `cfg`'s params
    (`core.mesh.model_ranks`), or None: no such axis, or a
    `sequence_parallel` family's replicated params."""
    return None if sequence_parallel(cfg.family) else model_ranks()


def param_pspecs(params, mesh: Mesh, family: str | None = None):
    """The params' specs: `param_spec` each, or all replicated for a
    `sequence_parallel` family."""
    if sequence_parallel(family):
        return tree_map(lambda leaf: P(), params)
    return tree_map_with_path(lambda p, leaf: param_spec(p, leaf, mesh),
                              params)


def param_shardings(mesh: Mesh, params, family: str | None = None):
    return tree_map(lambda s: NamedSharding(mesh, s),
                    param_pspecs(params, mesh, family))


# ---------------------------------------------------------------------------
# ZeRO-1: extend a param spec with "data" on the first divisible free dim
# ---------------------------------------------------------------------------

def zero1_spec(spec: P, shape, mesh: Mesh) -> P:
    if "data" not in mesh.axis_names:
        return spec
    ndata = mesh.shape["data"]
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (axis, dim) in enumerate(zip(parts, shape)):
        if axis is None and dim % ndata == 0 and dim >= ndata:
            parts[i] = "data"
            return P(*parts)
    return spec


def opt_state_pspecs(params, mesh: Mesh, zero1: bool = True,
                     family: str | None = None):
    """Moment tensors: param spec (+ data axis when zero1)."""
    specs = param_pspecs(params, mesh, family)
    if not zero1:
        return specs
    return tree_map(lambda s, p: zero1_spec(s, tuple(p.shape), mesh),
                    specs, params)


# ---------------------------------------------------------------------------
# Batch / cache / activation specs
# ---------------------------------------------------------------------------

def batch_specs(mesh: Mesh, batch_tree):
    dp = dp_axes(mesh)

    def spec(path, leaf):
        if _ndim(leaf) == 0:
            return P()
        return sanitize_spec(P(dp, *(None,) * (_ndim(leaf) - 1)),
                             tuple(leaf.shape), mesh)
    return tree_map_with_path(spec, batch_tree)


def cache_spec(path, leaf, mesh: Mesh) -> P:
    """KV caches: [L, B, S, ...] -> (None, dp, 'model', None...).

    SSM states [L, B, H, P, N] -> (None, dp, 'model', None, None).
    Leading stacked dims (layer/group/site) are any dims before batch,
    told apart by the path's last name, as the reference does (MLA's
    "ckv" ends in "v", so it takes the k/v rule there too)."""
    dp = dp_axes(mesh)
    s = _path_str(path)
    nd = _ndim(leaf)
    if s.endswith("k") or s.endswith("v"):          # [.., B, S, H, dh]
        lead = (None,) * (nd - 4)
        return P(*lead, dp, "model", None, None)
    if "ckv" in s or "k_rope" in s:                  # [.., B, S, R]
        lead = (None,) * (nd - 3)
        return P(*lead, dp, "model", None)
    if "state" in s:                                 # [.., B, H, P, N]
        lead = (None,) * (nd - 4)
        return P(*lead, dp, "model", None, None)
    if "conv" in s:                                  # [.., B, K-1, C]
        lead = (None,) * (nd - 3)
        return P(*lead, dp, None, "model")
    lead = (None,) * max(nd - 1, 0)
    return P(dp, *lead) if nd else P()


def cache_pspecs(mesh: Mesh, caches):
    return tree_map_with_path(
        lambda p, leaf: sanitize_spec(cache_spec(p, leaf, mesh),
                                      tuple(leaf.shape), mesh), caches)


def rank_cache_pspecs(mesh: Mesh, caches):
    """The caches' specs as a mesh of ranks holds them, a block a rank:
    `cache_pspecs`, but for the MLA latent, the SSM conv windows and the
    audio family's cross cache.  The reference's name test sends "ckv"
    and "conv" down its k/v branch, so on the stacked [L, B, S, R] latent
    and [L, B, K-1, C] window its spec cuts L over the data axes and B
    over "model", which GSPMD reshards to whatever each step needs; a
    rank holds only its block, and prefill and decode run on its rows, so
    the latent takes the branch written for it, as "k_rope" does (B over
    the data axes, S over "model"), and the conv window is cut over B
    alone: its channels' cut over "model" (the conv branch's) does not
    fall on the state's heads, and each rank's decode step reads the B
    and C channels every head shares.  The SSM states keep the
    reference's cut (heads over "model").  The cross cache's "cross/k"
    and "cross/v" [L, B, S_enc, H, Dh] take the reference's k/v branch,
    which cuts the frames over "model"; a rank whose `wk` and `wv` are
    column-cut computes its heads of every frame, and a frame cut would
    cost an all-to-all a layer at prefill and a q gather and a merged
    softmax a layer at decode (about 72 more collectives a decode step
    for whisper-medium), so over ranks it is cut over its heads (B over
    the data axes, H over "model"): a rank's bytes are still 1 / |model|
    of them."""
    def spec(path, leaf):
        name = _path_str(path)
        lead = (None,) * (_ndim(leaf) - 3)
        if name.endswith("ckv"):
            want = P(*lead, dp_axes(mesh), "model", None)
        elif name.endswith("conv"):
            want = P(*lead, dp_axes(mesh), None, None)
        elif is_cross_cache(name):
            want = P(*lead[1:], dp_axes(mesh), None, "model", None)
        else:
            want = cache_spec(path, leaf, mesh)
        return sanitize_spec(want, tuple(leaf.shape), mesh)
    return tree_map_with_path(spec, caches)


def is_cross_cache(name: str) -> bool:
    """Whether the cache leaf at `name` (the "a/b/c" form) is the audio
    family's cross cache, which holds heads of every frame rather than
    positions of the decoded sequence."""
    return name.startswith("cross/") or "/cross/" in name


def activation_spec(mesh: Mesh) -> P:
    """Residual-stream constraint [B, S, D]."""
    return P(dp_axes(mesh), None, None)
