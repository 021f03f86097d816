"""Optimizers, LR schedules and 1-bit gradient compression for training
(port of `repro.optim`)."""
from repro_torch.optim.compress import (compress_grad, compressed_allreduce,
                                        compress_tree, decompress_grad,
                                        decompress_tree, init_errors)
from repro_torch.optim.optimizers import (Optimizer, adafactor, adam8bit,
                                          adamw, clip_by_global_norm,
                                          get_optimizer)
from repro_torch.optim.schedule import constant, warmup_cosine
