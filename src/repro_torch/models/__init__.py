"""The LMs the port trains and serves (dense, MoE, SSM, hybrid and audio):
layers, GQA, MLA and cross-attention, the MoE FFN, the Mamba2 mixer,
blocks, trunk."""
from repro_torch.models.transformer import (abstract_caches, abstract_params,
                                            decode_step, decode_step_eager,
                                            empty_caches, init_params,
                                            lm_from_jax, prefill, train_loss)
