"""Model configurations the port serves."""
from repro_torch.configs.base import (ModelConfig, SHAPES, ShapeConfig,
                                      shapes_for)
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
