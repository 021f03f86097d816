"""zamba2-1.2b [hybrid] (port of `repro.configs.zamba2_1p2b`): a Mamba2
backbone with one SHARED attention block applied after every 6 layers
(weights shared, caches per site) [arXiv:2411.15242].  Sub-quadratic at
long context through the shared block's attention window."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_head=64, d_ff=8192, vocab_size=32000,
    ssm_state=64, d_inner=4096, ssm_head_dim=64, ssm_conv=4,
    attn_every=6, subquadratic=True, long_context_window=4096,
    rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
    vocab_size=512, ssm_state=16, d_inner=128, ssm_head_dim=32,
    attn_every=2)
