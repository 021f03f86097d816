"""drim-bnn widths (port of `repro.configs.drim_bnn`): the paper's own
application, a ~100M-class LM whose FFN projections are BitLinear
(XNOR-popcount).  This slice of the port serves its FFN BitLinear pair,
d_model -> d_ff -> d_model."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields of `repro.configs.base.ModelConfig` drim-bnn sets."""

    arch: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    bitlinear: str              # none | ffn | attn | all
    rope_theta: float

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


CONFIG = ModelConfig(
    arch="drim-bnn", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_head=64, d_ff=3072, vocab_size=32768,
    bitlinear="ffn", rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(n_layers=2, d_model=128, n_heads=4,
                              n_kv_heads=2, d_head=32, d_ff=256,
                              vocab_size=512)
