"""whisper-medium [audio] (port of `repro.configs.whisper_medium`): an
encoder-decoder whose conv frontend is a stub (the batch carries
precomputed frame embeddings) [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_head=64, d_ff=4096, vocab_size=51865,
    encoder_layers=24, n_frames=1500, rope_theta=1e4)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, encoder_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
    d_head=32, d_ff=128, vocab_size=512, n_frames=32)
