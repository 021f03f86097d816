"""--arch id -> config resolution (port of `repro.configs.registry`):
every arch of the reference."""
from importlib import import_module

ARCHS = {
    "qwen3-14b": "qwen3_14b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-32b": "qwen3_32b",
    "minitron-4b": "minitron_4b",
    "whisper-medium": "whisper_medium",
    "llava-next-34b": "llava_next_34b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-1.2b": "zamba2_1p2b",
    "drim-bnn": "drim_bnn",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {sorted(ARCHS)}")
    return import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG
