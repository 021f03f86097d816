"""drim-bnn (port of `repro.configs.drim_bnn`): the paper's own
application, a ~100M-class LM whose FFN projections are BitLinear
(XNOR-popcount)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="drim-bnn", family="dense", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=4, d_head=64, d_ff=3072, vocab_size=32768,
    bitlinear="ffn", rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(n_layers=2, d_model=128, n_heads=4,
                              n_kv_heads=2, d_head=32, d_ff=256,
                              vocab_size=512)
