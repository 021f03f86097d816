"""deepseek-v3-671b [moe] (port of `repro.configs.deepseek_v3_671b`): MLA,
1 shared + 256 routed experts, top-8; the MTP head is left out, as in the
reference [arXiv:2412.19437]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, vocab_size=129280,
    n_experts=256, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, vocab_size=512,
    n_experts=8, top_k=2, moe_d_ff=64, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
