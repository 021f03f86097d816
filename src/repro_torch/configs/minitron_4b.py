"""minitron-4b [dense] (port of `repro.configs.minitron_4b`): a pruned
Nemotron, GQA with 8 KV heads [arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="minitron-4b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, d_head=128, d_ff=9216, vocab_size=256000,
    rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=96, n_heads=3, n_kv_heads=1, d_head=32,
    d_ff=192, vocab_size=512)
