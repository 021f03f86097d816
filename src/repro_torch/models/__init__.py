"""The LMs the port trains and serves (dense, SSM and hybrid): layers,
GQA attention, the Mamba2 mixer, blocks, trunk."""
from repro_torch.models.transformer import (decode_step, decode_step_eager,
                                            empty_caches, init_params,
                                            lm_from_jax, prefill, train_loss)
