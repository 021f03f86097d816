"""kimi-k2-1t-a32b [moe] (port of `repro.configs.kimi_k2_1t_a32b`): 384
routed experts top-8 + 1 shared, GQA with 8 KV heads; ~1.04 T parameters,
~32 B active a token."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, d_head=128, vocab_size=163840,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    rope_theta=5e4)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    vocab_size=512, n_experts=8, top_k=2, moe_d_ff=64)
