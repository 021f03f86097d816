"""ModelConfig (port of `repro.configs.base`, the fields the dense, SSM
and hybrid families read).

The reference's config also carries the MoE, MLA, encoder, vlm and
sharding fields of its other architectures; they arrive with those
families (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                 # dense | ssm | hybrid (the ported ones)
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
    # ssm (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    d_inner: int = 0
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared attention block applied every N mamba blocks
    attn_every: int = 0
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
        reference's formula for the dense, SSM and hybrid families."""
        if self.family not in ("dense", "ssm", "hybrid"):
            raise NotImplementedError(
                f"param_count of family {self.family!r}: ROADMAP Queue 1 "
                "item 12")
        d, v = self.d_model, self.vocab_size
        n = 2 * v * d                                    # embed + head
        if self.family == "dense":
            per_layer = (d * self.n_heads * self.d_head
                         + 2 * d * self.n_kv_heads * self.d_head
                         + self.n_heads * self.d_head * d
                         + 3 * d * self.d_ff)
        else:
            ci = self.d_inner + 2 * self.ssm_state
            per_layer = (d * (2 * self.d_inner + 2 * self.ssm_state
                              + self.ssm_heads)
                         + self.ssm_conv * ci + self.d_inner * d)
        if self.family == "hybrid":                      # one shared block
            n += 4 * d * self.n_heads * self.d_head + 3 * d * self.d_ff
        return n + self.n_layers * per_layer
