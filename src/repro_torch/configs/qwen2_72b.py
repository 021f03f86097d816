"""qwen2-72b [dense] (port of `repro.configs.qwen2_72b`): GQA with 8 KV
heads, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen2-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=29568, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512)
