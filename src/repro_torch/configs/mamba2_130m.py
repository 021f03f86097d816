"""mamba2-130m [ssm] (port of `repro.configs.mamba2_130m`): SSD (state-
space duality), attention-free [arXiv:2405.21060].  Sub-quadratic."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-130m", family="ssm", n_layers=24, d_model=768,
    vocab_size=50280, ssm_state=128, d_inner=1536, ssm_head_dim=64,
    ssm_conv=4, subquadratic=True)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, ssm_state=16, d_inner=128, ssm_head_dim=32,
    vocab_size=512)
