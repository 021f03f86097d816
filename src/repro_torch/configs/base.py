"""ModelConfig (port of `repro.configs.base`, the fields the dense family
reads).

The reference's config also carries the MoE, MLA, SSM, hybrid, encoder
and sharding fields of its other architectures; they arrive with those
families (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense (the only family ported so far)
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
    # Embedding/head vocab dim padded to a multiple of this; the logical
    # vocab stays vocab_size and the pad logits are masked to -1e30.
    vocab_pad_multiple: int = 128
    # "flash": the flash-attention kernel for unwindowed, block-aligned
    # full-sequence attention on the card (the dense-scores path on the
    # CPU, as the reference runs it off the TPU).  "xla": dense scores
    # everywhere (the reference's name for it).
    attention_impl: str = "flash"
    # the paper's technique as a first-class switch
    bitlinear: str = "none"     # none | ffn | attn | all
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # training: recompute each layer's forward during the backward
    # (`torch.utils.checkpoint`) instead of keeping its activations
    remat: bool = True

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk + head), the
        reference's formula for the dense family."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count of family {self.family!r}: ROADMAP Queue 1 "
                "item 12")
        d, v = self.d_model, self.vocab_size
        attn = (d * self.n_heads * self.d_head
                + 2 * d * self.n_kv_heads * self.d_head
                + self.n_heads * self.d_head * d)
        return 2 * v * d + self.n_layers * (attn + 3 * d * self.d_ff)
