"""1-bit (sign) gradient compression with error feedback (port of
`repro.optim.compress`): the paper's bulk X(N)OR primitive applied to the
data-parallel gradient exchange.

Each worker would send only the sign bits of its error-corrected gradient
plus one float32 scale per tensor, and keep the quantization residual for
the next step.  On one card there is no exchange: the train step encodes
and decodes in place of it (`runtime.steps`), so the residual state and
the update match the reference's.  `compressed_allreduce`, the exchange
itself, needs a data-parallel group (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.tree import tree_map


def compress_grad(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (sign ±1 int8, scale, new_error); scale = mean|g + err|."""
    gc = g.to(torch.float32) + err
    scale = gc.abs().mean()
    sign = torch.where(gc >= 0, 1, -1).to(torch.int8)
    decoded = sign.to(torch.float32) * scale
    return sign, scale, gc - decoded


def decompress_grad(sign: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return sign.to(torch.float32) * scale


def compress_tree(grads, errors):
    """Tree version; returns (signs, scales, new_errors)."""
    out = tree_map(compress_grad, grads, errors)     # leaves: 3-tuples
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def decompress_tree(signs, scales):
    return tree_map(decompress_grad, signs, scales)


def init_errors(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_allreduce(grads, errors, axis_names):
    """The EF-compressed data-parallel mean: it needs a data-parallel
    process group, which the port does not have yet."""
    raise NotImplementedError(
        "compressed_allreduce needs a data-parallel group: ROADMAP Queue 1 "
        "item 12 (runtime/sharding.py)")
