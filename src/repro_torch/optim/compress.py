"""1-bit (sign) gradient compression with error feedback (port of
`repro.optim.compress`): the paper's bulk X(N)OR primitive applied to the
data-parallel gradient exchange.

Each worker sends only the sign of its error-corrected gradient (an int8
±1 payload) plus one float32 scale per tensor, and keeps the quantization
residual for the next step.  `compressed_allreduce` is that exchange over
a `torch.distributed` process group: NCCL on the card (one rank on one
card), gloo on the CPU.  The trainer, like the reference's, encodes and
decodes in its step (`runtime.steps`) and calls no collective but, over
a mesh of ranks, the sum of each leaf's |g + err| over its blocks
(`compress_blocks`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map


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


def compress_blocks(grads, errors, numels, keys, psum):
    """`compress_grad` and `decompress_grad` on blocks of the leaves (a
    rank's: `runtime.steps.rank_ef_compress`), lists in one order.  Each
    leaf's scale is the whole leaf's mean |g + err|: its block's sum of
    |g + err|, summed over the ranks that hold its other blocks
    (`psum(tensors, keys)`, `keys[i]` leaf i's group), over the leaf's
    `numels[i]`.  Returns (the decoded blocks, the new residual blocks)."""
    gcs = [g.to(torch.float32) + e for g, e in zip(grads, errors)]
    sums = psum([gc.abs().sum() for gc in gcs], keys)
    decoded, new_err = [], []
    for gc, total, n in zip(gcs, sums, numels):
        sign = torch.where(gc >= 0, 1, -1).to(torch.int8)
        d = decompress_grad(sign, total / n)
        decoded.append(d)
        new_err.append(gc - d)
    return decoded, new_err


def compress_tree(grads, errors):
    """Tree version; returns (signs, scales, new_errors)."""
    out = tree_map(compress_grad, grads, errors)     # leaves: 3-tuples
    return tuple(tree_map(lambda o, i=i: o[i], out) for i in range(3))


def decompress_tree(signs, scales):
    return tree_map(decompress_grad, signs, scales)


def init_errors(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_allreduce(grads, errors, axis_names, *, group=None):
    """EF-compressed data-parallel mean over `group` (default: the
    default process group), whose ranks are the workers along the
    reference's `axis_names` (the data-parallel axes the group spans).

    Encodes sign + scale (`compress_tree`), all-reduces each ±1 payload
    as INT8 with SUM (1 byte an element on the wire; exact for up to 127
    ranks) and the scales as float32 SUM divided by n, the group's size
    (gloo has no AVG), and decodes mean = sum_sign / n * avg_scale.
    Returns (mean_grads, new_errors).  Raises without an initialised
    process group: it never acts as if it had one rank."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "compressed_allreduce needs a process group: call "
            "torch.distributed.init_process_group first")
    del axis_names                      # the group decides who takes part
    signs, scales, new_err = compress_tree(grads, errors)
    n = dist.get_world_size(group)

    def summed(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    sum_sign = tree_map(lambda t: summed(t.to(torch.int8)), signs)
    leaves = tree_leaves(scales)
    stacked = summed(torch.stack(leaves).to(torch.float32)) / n
    avg_of = {id(t): stacked[i] for i, t in enumerate(leaves)}
    mean = tree_map(lambda t, sc: t.to(torch.float32) / n * avg_of[id(sc)],
                    sum_sign, scales)
    return mean, new_err
