"""ModelConfig and the dry-run's shape suite (port of
`repro.configs.base`: the fields the dense, vlm, MoE, SSM, hybrid and
audio families read, and `ShapeConfig`, `SHAPES`, `shapes_for`).

`seq_parallel` is the reference's switch, and acts over a `model` axis of
ranks: the residual of the dense, vlm and MoE trunks and of the audio
encoder is cut over the sequence, a block a rank (`models.blocks`); with
False the residual stays whole on every rank, and the ssm family's is
not cut either.  In one process it changes nothing.  The reference's
`scan_unroll` is not carried: the port loops over layers in Python and
has no scan.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense | vlm | moe | ssm | hybrid | audio
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # ffn
    d_ff: int = 0
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # Embedding/head vocab dim padded to a multiple of this; the logical
    # vocab stays vocab_size and the pad logits are masked to -1e30.
    vocab_pad_multiple: int = 128
    # "flash": the flash-attention kernel for unwindowed, block-aligned
    # full-sequence attention on the card (the dense-scores path on the
    # CPU, as the reference runs it off the TPU).  "xla": dense scores
    # everywhere (the reference's name for it).
    attention_impl: str = "flash"
    # Megatron-style sequence parallelism: the residual stream / norm
    # segments are sharded S-over-`model`; TP blocks all-gather on entry
    # and REDUCE-SCATTER on exit (half the wire bytes of the all-reduce
    # they replace, and the f32 norm segments stop being replicated).
    seq_parallel: bool = True
    # "ep": expert parallelism over the ambient mesh's `model` axis
    # (`moe._ep_shard_map`), which falls back to "grouped" off a mesh or
    # where the mesh does not divide the experts or the batch.
    # "grouped": routing and dispatch per batch row.  "global": one sort
    # over all B*S tokens (and every decode step, S == 1).
    moe_dispatch: str = "ep"
    # mla (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared attention block applied every N mamba blocks
    attn_every: int = 0
    # enc-dec (whisper)
    encoder_layers: int = 0
    n_frames: int = 1500        # stub conv frontend output length
    # vlm (llava): patch embeds prepended by the stub frontend
    n_patches: int = 0
    # long-context policy
    subquadratic: bool = False  # may run long_500k
    long_context_window: int = 4096  # hybrid attn window at >=128k ctx
    # the paper's technique as a first-class switch
    bitlinear: str = "none"     # none | ffn | attn | all
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training: recompute each layer's forward during the backward
    # (`torch.utils.checkpoint`) instead of keeping its activations
    remat: bool = True

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.d_inner else 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk + head), the
        reference's formula."""
        if self.family not in ("dense", "vlm", "moe", "ssm", "hybrid",
                               "audio"):
            raise ValueError(f"unknown family {self.family!r}")
        d, v = self.d_model, self.vocab_size
        n = 2 * v * d                                    # embed + head
        if self.family in ("dense", "vlm", "moe", "audio"):
            if self.mla:
                attn = (d * self.q_lora_rank
                        + self.q_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.qk_rope_dim)
                        + d * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.n_heads
                        * (self.qk_nope_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * d)
            else:
                attn = (d * self.n_heads * self.d_head
                        + 2 * d * self.n_kv_heads * self.d_head
                        + self.n_heads * self.d_head * d)
            if self.family == "moe":
                ffn = (d * self.n_experts
                       + 3 * self.n_experts * d * self.moe_d_ff
                       + 3 * self.n_shared_experts * d * self.moe_d_ff)
            else:
                ffn = 3 * d * self.d_ff
            per_layer = attn + ffn
        else:
            ci = self.d_inner + 2 * self.ssm_state
            per_layer = (d * (2 * self.d_inner + 2 * self.ssm_state
                              + self.ssm_heads)
                         + self.ssm_conv * ci + self.d_inner * d)
        if self.family == "hybrid":                      # one shared block
            n += 4 * d * self.n_heads * self.d_head + 3 * d * self.d_ff
        n += self.n_layers * per_layer
        if self.family == "audio":                       # the encoder
            n += self.encoder_layers * per_layer
        return n

    def active_param_count(self) -> int:
        """Parameters a token activates (MoE: its top_k routed experts and
        the shared ones; every other family: all of them)."""
        if self.family != "moe":
            return self.param_count()
        per_expert = 3 * self.d_model * self.moe_d_ff
        return (self.param_count() - self.n_layers * per_expert
                * (self.n_experts - self.top_k))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """Applicable shape cells for an arch (long_500k needs sub-quadratic)."""
    base = ("train_4k", "prefill_32k", "decode_32k")
    return base + ("long_500k",) if cfg.subquadratic else base
