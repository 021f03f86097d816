"""llava-next-34b [vlm] (port of `repro.configs.llava_next_34b`): the
dense trunk behind an anyres tiling patch frontend STUB, whose patch
embeddings replace the first n_patches positions
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_head=128, d_ff=20480, vocab_size=64000,
    n_patches=2880, rope_theta=1e6)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
    d_ff=256, vocab_size=512, n_patches=16)
