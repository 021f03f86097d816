"""qwen3-32b [dense] (port of `repro.configs.qwen3_32b`): qk_norm, GQA
with 8 KV heads."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="qwen3-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=64, n_kv_heads=8, d_head=128, d_ff=25600, vocab_size=151936,
    qk_norm=True, rope_theta=1e6)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512)
