"""Nested-dict parameter and cache trees: the few pytree operations the
port needs (the reference uses `jax.tree` and `jax.tree_util`).

Dicts are inner nodes, None is an empty subtree (as in `jax.tree`: the
hybrid family's cache has a None `tail` when its depth leaves none), and
everything else is a leaf.  Paths are written as `jax.tree_util.keystr`
writes them, e.g. "['layers']['attn']['wq']".
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, path: str = ""):
    """fn(path, leaf, *matching leaves) over the leaves of `tree`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree, *rest)


def tree_slice(tree, i: int):
    """Entry i of every stacked tensor leaf; other leaves as they are."""
    return tree_map(lambda a: a[i] if isinstance(a, torch.Tensor) else a,
                    tree)


def tree_unstack(tree, n: int) -> list:
    """The n entries of every stacked tensor leaf as n trees (the inverse
    of `tree_stack`).  One `unbind` per leaf, so autograd stacks the
    entries' gradients once, where n `tree_slice` calls would each
    scatter a gradient into a zeroed full-size tensor and sum n of
    them."""
    parts = tree_map(lambda a: (a.unbind(0) if isinstance(a, torch.Tensor)
                                else (a,) * n), tree)
    return [tree_map(lambda part, i=i: part[i], parts) for i in range(n)]


def tree_stack(trees: Sequence[Any]):
    """Stack matching tensor leaves along a new axis 0 (the inverse of
    `tree_slice`); other leaves are taken from the first tree."""
    return tree_map(lambda *leaves: (torch.stack(leaves)
                                     if isinstance(leaves[0], torch.Tensor)
                                     else leaves[0]), *trees)


def tree_leaves(tree) -> list:
    """The leaves in the order `jax.tree.leaves` gives them (dict keys
    sorted), so that sums over a tree add in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]
