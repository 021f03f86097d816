"""Train, prefill and decode steps (port of `repro.runtime.steps`).

`make_train_step(cfg, ...)` returns (step_fn, init_state, optimizer);
step_fn(state, batch) -> (new_state, metrics) is what the trainer
(`launch/train.py`) runs each step.  TrainState = {"params", "opt",
"errors"?, "step"}, nested dicts of tensors; gradient flow:

  autograd of train_loss               # the flash backward kernels inside
  [grad accumulation over `accum`]     # microbatches, summed in float32
  [optional 1-bit EF compression]      # optim/compress.py
  optimizer.update                     # AdamW / Adafactor / int8-Adam

The state's specs are the reference's (`train_state_pspecs`,
`state_shardings`: `runtime/sharding.py`'s rules, ZeRO-1 moments),
computed on `abstract_train_state` (meta tensors, no storage).  `place`
puts a state on its shardings: on a mesh whose devices are all one
device (the host mesh of one card, or of the CPU) each leaf moves whole
to that device, so a 1x1 mesh changes no value.

Over a mesh of ranks (`launch.mesh.cli_mesh` under torchrun: (D, M)
data x model) the step computes the global-batch formula of the
reference's pjit step on a (D, M) host mesh; only the float order
differs:

  each rank takes its rows of the global batch (of each microbatch's
    rows with `accum` > 1), contiguous, cut over the data axes alone
  each rank holds its model block of every param (`place`; Megatron's
    products and their collectives: `models`), and its loss is its data
    share of the global loss (`models.train_loss`)
  the gradients are summed over the data group (`core.mesh.mesh_sum`);
    the ssm family's over the model group too: its params are replicated
    and each rank's gradient comes from its block of the sequence; under
    a sequence-cut residual (`cfg.seq_parallel`) the other families'
    replicated norm scales too (`sharding.sequence_partial`: each rank
    applied them to its block), in one more all-reduce
  the global gradient norm sums the squares of the model-cut leaves over
    the model group and counts each replicated leaf once
  ZeRO-1: each rank holds its (model, data) block of every moment;
    AdamW and Adafactor update the rank's block of each param and the
    blocks are put back together over the data group alone (`core.mesh.
    mesh_gather`), so each rank keeps its model block.  Adafactor's
    factored statistics keep the reference's specs (its param's spec
    truncated to the vector's rank, plus ZeRO-1), which need not cut the
    block's rows and columns alike: the rank's entries are moved to the
    block and back (vectors, never a param), and its row and column
    sums, the rows' mean and the clip's RMS are summed over the ranks
    that cut the summed axes (`rank_adafactor_update`).  adam8bit's int8
    blocks of 256 run over the flattened leaf, and its state keeps the
    reference's specs too (the [n_blocks, 256] codes cut by the param's
    spec truncated, plus ZeRO-1): each rank fetches p and g over the run
    of its state's rows from the model blocks (`core.mesh.
    mesh_exchange`: a slab of the leaf, over the axes that cut the param
    and not the rows), updates its block, takes each block's scale as
    the maximum over the ranks that cut its 256 columns, and hands the
    new runs back to the model blocks (`rank_adam8bit_update`)
  --compress: each rank's residual block under the moments' ZeRO-1 spec
    takes its gradient block, gc = g + err; each leaf's scale mean |gc|
    sums its blocks' |gc| over the ranks that cut the leaf, one scalar a
    leaf (`rank_ef_compress`); the decoded ZeRO-1 blocks go to AdamW and
    Adafactor as they are, to adam8bit gathered over the data group into
    model blocks; the global norm (the metric, and the clip's) sums the
    decoded blocks' squares over the ranks that cut each leaf

A mesh of distinct devices with no process group would need a process
per device and raises.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import (NamedSharding, PartitionSpec as P,
                                   block_region, dp_axes, drop_axes,
                                   local_block, local_shape, mesh_exchange,
                                   mesh_gather, mesh_max, mesh_sum,
                                   run_boxes, sub_block)
from repro_torch.device import resolve_device
from repro_torch.models import (abstract_params, decode_step as model_decode,
                                init_params, lm_from_jax,
                                prefill as model_prefill, train_loss)
from repro_torch.models.transformer import (_to_torch, cuts_sequence,
                                           grad_axes)
from repro_torch.optim import (compress_tree, decompress_tree, get_optimizer,
                               init_errors, warmup_cosine)
from repro_torch.optim.compress import compress_blocks
from repro_torch.optim.optimizers import _BLOCK, global_norm as _global_norm
from repro_torch.runtime import sharding as shd
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path


# --- state construction ------------------------------------------------------

def make_train_state(seed, cfg, optimizer, *, device=None):
    params = init_params(seed, cfg, device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=resolve_device(device))}


def abstract_train_state(cfg, optimizer):
    """The train state's tree as meta tensors (the reference's
    `jax.eval_shape` of `make_train_state`): shapes and dtypes, no
    storage and no draw."""
    params = abstract_params(cfg)
    with torch.device("meta"):
        return {"params": params, "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32)}


def train_state_pspecs(state_shape, mesh, zero1: bool = True,
                       family: str | None = None):
    """PartitionSpecs for the full train state tree."""
    params = state_shape["params"]
    pspec = shd.param_pspecs(params, mesh, family)

    def opt_spec(path, leaf):
        s = shd._path_str(path)
        ndim = len(leaf.shape)
        # moment tensors mirror their param's spec (+ ZeRO-1 data axis);
        # match by stripping the leading "m|v|f|q" prefix
        for prefix in ("m/", "v/", "f/", "q/"):
            if s.startswith(prefix):
                sub = s[len(prefix):]
                for suffix in ("/vr", "/vc", "/v", "/mq", "/ms", "/vq",
                               "/vs"):
                    if sub.endswith(suffix):
                        sub = sub[: -len(suffix)]
                        break
                spec = _lookup_param_spec(pspec, sub)
                if spec is not None:
                    t = tuple(spec)[:ndim]
                    t = t + (None,) * (ndim - len(t))
                    spec2 = P(*t)
                    return (shd.zero1_spec(spec2, tuple(leaf.shape), mesh)
                            if zero1 else spec2)
        return P(*(None,) * ndim) if ndim else P()

    def opt_spec_sane(path, leaf):
        return shd.sanitize_spec(opt_spec(path, leaf), tuple(leaf.shape),
                                 mesh)

    opt = tree_map_with_path(opt_spec_sane, state_shape["opt"])
    return {"params": pspec, "opt": opt, "step": P()}


def _lookup_param_spec(pspec_tree, path_str: str):
    node = pspec_tree
    for part in path_str.split("/"):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return None
    return node if isinstance(node, P) else None


def state_shardings(state_shape, mesh, zero1: bool = True,
                    family: str | None = None):
    specs = train_state_pspecs(state_shape, mesh, zero1, family)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def state_pspecs(cfg, optimizer, mesh, compress: bool = False):
    """(the train state's specs, its abstract tree) as the trainer
    places it: `train_state_pspecs` of `abstract_train_state`, and with
    `compress` the error-feedback residuals on the moments' specs (the
    reference's trainer's)."""
    shape = abstract_train_state(cfg, optimizer)
    specs = train_state_pspecs(shape, mesh, family=cfg.family)
    if compress:
        specs["errors"] = shd.opt_state_pspecs(shape["params"], mesh,
                                               family=cfg.family)
        shape["errors"] = shape["params"]
    return specs, shape


def place(tree, shardings, shapes=None):
    """Every leaf of `tree` on its `NamedSharding`.  On a mesh of ranks
    each process keeps its own block of each leaf (`core.mesh.
    local_block` of the leaf's spec: the params cut over "model", the
    ZeRO-1 moments over "data" too) on its own device; with `shapes` (a
    tree of the whole leaves) a leaf that is already this rank's block
    (a fresh state from `make_train_step`'s `init_state` over ranks)
    stays as it is.  On a mesh whose devices are all one device the leaf
    moves there whole (a no-op when it is there already).  A mesh of
    distinct devices with no process group would need a process per
    device: ValueError."""
    def one(leaf, sh, whole=None):
        mesh = sh.mesh
        if mesh.ranks is not None:
            shape = tuple(leaf.shape if whole is None else whole.shape)
            sl = local_block(shape, sh.spec, mesh)
            if all(s.stop - s.start == n for s, n in zip(sl, leaf.shape)):
                return leaf.to(mesh.device)
            if tuple(leaf.shape) != shape:
                raise ValueError(f"a leaf {tuple(leaf.shape)} is neither "
                                 f"the whole {shape} nor its block under "
                                 f"{sh.spec}")
            return leaf[sl].to(mesh.device).clone()
        devs = set(mesh.devices.flat)
        if len(devs) != 1:
            raise ValueError(
                f"placing a state on a mesh of {len(devs)} distinct devices "
                f"({sorted(map(str, devs))}) needs a process per device: "
                "start one per device with torchrun (ROADMAP Queue 1 item "
                "15.1), or use a mesh of one device")
        return leaf.to(next(iter(devs)))
    if shapes is None:
        return tree_map(one, tree, shardings)
    return tree_map(one, tree, shardings, shapes)


def cut(tree, specs, mesh, within=None, shapes=None):
    """Each leaf's block on this rank (views; `place` without the move).
    With `within` (a tree of coarser specs) the leaves are already this
    rank's blocks under those, and `shapes` gives the whole leaves."""
    if within is None:
        return tree_map(lambda t, s: t[local_block(tuple(t.shape), s, mesh)],
                        tree, specs)
    return tree_map(lambda t, s, w, whole: t[sub_block(
        tuple(whole.shape), s, w, mesh)], tree, specs, within, shapes)


def gather(tree, specs, shapes, mesh, axes=None):
    """The leaves of a tree of this rank's blocks rebuilt over `axes`
    (default: every axis, so the whole leaves; `cut`'s inverse, over
    `core.mesh.mesh_gather`); `shapes` is a tree of the whole leaves
    (tensors, meta ones included)."""
    leaves = tree_leaves(tree)
    whole = mesh_gather(leaves, [tuple(t.shape) for t in tree_leaves(shapes)],
                        tree_leaves(specs), mesh, axes)
    of = {id(t): w for t, w in zip(leaves, whole)}
    return tree_map(lambda t: of[id(t)], tree)


def tp_global_norm(grads, specs, mesh):
    """The global norm of a gradient tree whose leaves are this rank's
    blocks under `specs` (the params' model blocks, or --compress's
    decoded ZeRO-1 blocks): each leaf's sum of squares in float32 (in
    `optim.global_norm`'s leaf order), summed over the ranks that cut the
    leaf (`_sum_by_group`: one all-reduce a distinct group), each
    replicated leaf's counted once."""
    leaves, leaf_specs = tree_leaves(grads), tree_leaves(specs)
    sums = _sum_by_group(
        [torch.sum(torch.square(g.to(torch.float32))) for g in leaves],
        [_cut_axes(sp, mesh) for sp in leaf_specs], mesh)
    return torch.sqrt(sum(sums))


def _sum_tree(tree, mesh, axes=None, also_model=None):
    """Every leaf summed over the ranks along `axes` (default: the data
    axes); the leaves whose path `also_model(path)` marks (the
    sequence-partial norm scales, `sharding.sequence_partial`) over
    "model" too, in one more all-reduce (`_sum_by_group`)."""
    axes = dp_axes(mesh) if axes is None else tuple(axes)
    leaves = tree_leaves(tree)
    if also_model is None:
        sums = mesh_sum(leaves, mesh, axes)
    else:
        marks = tree_leaves(tree_map_with_path(lambda p, t: also_model(p),
                                               tree))
        sums = _sum_by_group(leaves, [
            _cut_axes(axes + (("model",) if m else ()), mesh)
            for m in marks], mesh)
    of = {id(t): s for t, s in zip(leaves, sums)}
    return tree_map(lambda t: of[id(t)], tree)


def sum_rank_grads(cfg, grads, batch, mesh):
    """A rank's gradients of its share of the loss on `batch` (its rows)
    summed as the step sums them: over `transformer.grad_axes`, and where
    the step holds a sequence-cut residual (`transformer.cuts_sequence`)
    the sequence-partial norm scales (`sharding.sequence_partial`) over
    "model" too."""
    return _sum_tree(grads, mesh, grad_axes(cfg, mesh), functools.partial(
        shd.sequence_partial, family=cfg.family)
        if cuts_sequence(cfg, batch) else None)


def _cut_axes(entries, mesh) -> Tuple[str, ...]:
    """The axes named by spec `entries` that hold more than one rank, in
    the mesh's order: the group over which a sum of the blocks those
    entries cut runs."""
    named = set()
    for e in entries:
        if e is not None:
            named.update((e,) if isinstance(e, str) else e)
    return tuple(a for a in mesh.axis_names
                 if a in named and mesh.shape[a] > 1)


def _by_group(reduce, tensors, keys, mesh):
    """Each tensor reduced (`mesh_sum`, `mesh_max`) over the ranks along
    its key (a `_cut_axes` tuple): one call a distinct key; a key of no
    axis leaves its tensor as it is."""
    out = list(tensors)
    at: Dict[tuple, list] = {}
    for i, key in enumerate(keys):
        if key:
            at.setdefault(key, []).append(i)
    for axes, idx in at.items():
        for i, t in zip(idx, reduce([tensors[i] for i in idx], mesh, axes)):
            out[i] = t
    return out


def _sum_by_group(tensors, keys, mesh):
    return _by_group(mesh_sum, tensors, keys, mesh)


def _max_by_group(tensors, keys, mesh):
    return _by_group(mesh_max, tensors, keys, mesh)


def _padded(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _moved(blocks, shapes, have, want, mesh):
    """This rank's `blocks` of whole leaves of `shapes`, each under its
    spec in `have`, as its blocks under `want`: where the two cut a dim
    by different axes, the block is first gathered over `have`'s axes
    there (`mesh_gather`, one call an axis set), then sliced and copied
    out (`sub_block`).  A leaf whose two specs cut alike comes back as it
    is."""
    out = list(blocks)
    at: Dict[tuple, list] = {}
    for i, (shape, h, w) in enumerate(zip(shapes, have, want)):
        h, w = _padded(h, len(shape)), _padded(w, len(shape))
        differ = [d for d in range(len(shape))
                  if _cut_axes(h[d:d + 1], mesh) != _cut_axes(w[d:d + 1],
                                                             mesh)]
        if differ:
            at.setdefault(_cut_axes([h[d] for d in differ], mesh),
                          []).append(i)
    for axes, idx in at.items():
        got = [blocks[i] for i in idx]
        if axes:
            got = mesh_gather(got, [shapes[i] for i in idx],
                              [have[i] for i in idx], mesh, axes)
        for i, t in zip(idx, got):
            within = drop_axes(have[i], axes)
            out[i] = t[sub_block(shapes[i], want[i], within, mesh)].clone()
    return out


def rank_adafactor_update(optimizer, grads, params, opt, lr, specs, shapes,
                          mesh, grad_specs=None):
    """Adafactor's update over a mesh of ranks on this rank's blocks
    (`optimizer.update_blocks`): one process's values in another float
    order.  `grads` and `params` are the rank's model blocks (under
    `specs["params"]`; `grad_specs`, where given, are the gradients': the
    ZeRO-1 blocks --compress decodes are taken as they are), `opt` its
    state under `specs["opt"]`, `shapes` the whole trees ({"params",
    "opt"}).  Each leaf is updated on the
    rank's block under its ZeRO-1 spec (`sharding.zero1_spec` of the
    param's, AdamW's moments' cut).  The state keeps the reference's
    specs (each `vr` / `vc` cut by its param's spec truncated to its rank,
    plus ZeRO-1), so its entries for the block's rows and columns are
    moved there and back (`_moved`: vectors, never a param).  The row and
    column sums of g^2 and the rows' mean are summed over the ranks that
    cut the summed axis, the clip's sum of squares over the ranks that
    cut the leaf (`_sum_by_group`).  The new blocks are put back together
    over the data group, so the rank keeps its model block.  Returns (the
    new params, the new state)."""
    pspec, pshape = specs["params"], shapes["params"]
    fspec, fshape = specs["opt"]["f"], shapes["opt"]["f"]
    zspec = tree_map(lambda s, t: shd.zero1_spec(s, tuple(t.shape), mesh),
                     pspec, pshape)
    have, want, whole, stored = [], [], [], []

    def entries(z, p, st, sp, sh):
        z = _padded(z, p.dim())
        need = {"v": P(*z)}
        if p.dim() >= 2:
            need.update(vr=P(*z[:-1]), vc=P(*z[:-2], z[-1]))
        for k in st:
            have.append(sp[k])
            want.append(need[k])
            whole.append(tuple(sh[k].shape))
            stored.append(st[k])
        return {"rows": _cut_axes(z[-2:-1], mesh),
                "cols": _cut_axes(z[-1:], mesh), "leaf": _cut_axes(z, mesh)}
    groups = tree_map(entries, zspec, pshape, opt["f"], fspec, fshape)

    def rebuild(flat):
        it = iter(flat)
        return tree_map(lambda _, st: {k: next(it) for k in st}, zspec,
                        opt["f"])
    f_blocks = rebuild(_moved(stored, whole, have, want, mesh))
    blocks, new = optimizer.update_blocks(
        cut(grads, zspec, mesh, grad_specs or pspec, pshape),
        {"f": f_blocks, "step": opt["step"]},
        cut(params, zspec, mesh, pspec, pshape), lr, shapes=pshape,
        groups=groups, psum=lambda ts, ks: _sum_by_group(ts, ks, mesh))
    del f_blocks
    flat = []
    tree_map(lambda _, st, ns: flat.extend(ns[k] for k in st), zspec,
             opt["f"], new["f"])
    new_f = rebuild(_moved(flat, whole, want, have, mesh))
    return (gather(blocks, zspec, pshape, mesh, dp_axes(mesh)),
            {"f": new_f, "step": new["step"]})


def _state_rows(n: int, spec, mesh, rank=None) -> Tuple[slice, ...]:
    """The rows and columns of the [n_blocks, 256] view of a flattened
    leaf of `n` elements (adam8bit's codes) that `rank` holds under
    `spec`."""
    return local_block((-(-n // _BLOCK), _BLOCK), spec, mesh, rank)


def _run(n: int, spec, mesh, rank=None):
    """The run of the flattened leaf (a `core.mesh.mesh_exchange` region)
    that `rank`'s rows under `spec` cover, the padding left out."""
    rows = _state_rows(n, spec, mesh, rank)[0]
    return "run", (min(rows.start * _BLOCK, n), min(rows.stop * _BLOCK, n))


def _run_axes(shape, pspec, qspec, mesh, fetch: bool) -> Tuple[str, ...]:
    """The axes over which each rank fetches the run of its state rows
    (`_run` under `qspec`) from the blocks under `pspec` (`fetch`), or
    hands the runs back to those blocks: the axes that cut the leaf and
    not the rows (fetch), or the rows and not the leaf.  An axis that
    cuts both is left out where, on every rank, the run and the block it
    covers nest (the embedding's rows: nothing crosses), else kept."""
    shape = tuple(shape)
    n = math.prod(shape)
    cut, rows = _cut_axes(pspec, mesh), _cut_axes(tuple(qspec)[:1], mesh)
    axes = tuple(a for a in (cut if fetch else rows)
                 if a not in (rows if fetch else cut))
    if not any(a in rows for a in cut):
        return axes

    def nested(r):
        _, (s, e) = _run(n, drop_axes(qspec, () if fetch else axes), mesh, r)
        _, box = block_region(shape, drop_axes(pspec, axes) if fetch
                              else pspec, mesh, r)
        if fetch:
            return all(b0 <= p0 and p1 <= b1
                       for part in run_boxes(shape, s, e)
                       for (p0, p1), (b0, b1) in zip(part, box))
        first = np.ravel_multi_index([b0 for b0, _ in box], shape)
        last = np.ravel_multi_index([b1 - 1 for _, b1 in box], shape)
        return s <= first and last < e
    if all(nested(r) for r in range(mesh.ranks.size)):
        return axes
    return cut if fetch else rows


def rank_adam8bit_update(optimizer, grads, params, opt, lr, norm, specs,
                         shapes, mesh):
    """adam8bit's update over a mesh of ranks on this rank's blocks of its
    state (`optimizer.update_blocks`): given the same gradients and clip
    norm (`norm`, the global gradient norm, which the ranks add in
    another float order) the codes, scales and params are one process's
    to the bit.  The state keeps the
    reference's specs: each code leaf [n_blocks, 256] of the zero-padded
    flattened leaf cut by its param's spec truncated, plus ZeRO-1, so the
    rank's block is a run of rows (and, where the spec cuts them, a cut of
    the columns), not its param block.  `grads` and `params` are the
    rank's model blocks, `opt` its state, `shapes` the whole trees.

      the rank fetches p and g over the run of its rows from the model
        blocks (`core.mesh.mesh_exchange`, one broadcast an owner and
        axis set: `_run_axes`, the axes that cut the param and not the
        rows; for the embedding's rows, which both cut alike, nothing)
      it updates its [rows, cols] block; a block's scale is the maximum
        over its 256 columns, over the ranks that cut them
        (`_max_by_group`: one all-reduce a distinct group)
      the new rows' columns are gathered over those ranks
        (`mesh_gather`), and the runs handed back to the model blocks
        over the axes that cut the rows and not the param

    Ranks that hold the same state block compute the same values, as
    XLA's replicated state does.  Returns (the new params, the new
    state)."""
    pspec, pshape = specs["params"], shapes["params"]
    items = []
    tree_map(lambda sp, t, q, p, g: items.append(
        (sp, tuple(t.shape), q, p, g)), pspec, pshape, specs["opt"]["q"],
        params, grads)
    tensors, have, want, axes, whole = [], [], [], [], []
    for sp, shape, q, p, g in items:
        n = math.prod(shape)
        if _state_rows(n, q["ms"], mesh)[0] != _state_rows(n, q["mq"],
                                                           mesh)[0]:
            raise ValueError(f"adam8bit's scales {q['ms']} and codes "
                             f"{q['mq']} cut their rows apart")
        for t in (p, g):
            tensors.append(t)
            have.append(functools.partial(block_region, shape, sp, mesh))
            want.append(functools.partial(_run, n, q["mq"], mesh))
            axes.append(_run_axes(shape, sp, q["mq"], mesh, fetch=True))
            whole.append(shape)
    runs = iter(mesh_exchange(tensors, whole, have, want, axes, mesh))
    blocks = []
    for sp, shape, q, p, g in items:
        rows, cols = _state_rows(math.prod(shape), q["mq"], mesh)
        size = (rows.stop - rows.start) * _BLOCK
        for run in (next(runs), next(runs)):
            if run.numel() != size:
                run = torch.nn.functional.pad(run, (0, size - run.numel()))
            blocks.append(run.view(-1, _BLOCK)[:, cols])
    del runs, tensors
    p_blocks, g_blocks = iter(blocks[0::2]), iter(blocks[1::2])
    del blocks
    new_p, new_opt = optimizer.update_blocks(
        tree_map(lambda _: next(g_blocks), pspec),
        {"q": opt["q"], "step": opt["step"]},
        tree_map(lambda _: next(p_blocks), pspec), lr, norm=norm,
        groups=tree_map(lambda _, q: _cut_axes(tuple(q["mq"])[1:], mesh),
                        pspec, specs["opt"]["q"]),
        pmax=lambda ts, ks: _max_by_group(ts, ks, mesh))
    rows_of = []
    tree_map(lambda _, b: rows_of.append(b), pspec, new_p)
    del new_p
    at: Dict[tuple, list] = {}
    for i, (_, shape, q, _, _) in enumerate(items):
        cols = _cut_axes(tuple(q["mq"])[1:], mesh)
        if cols:
            at.setdefault(cols, []).append(i)
    for cols, idx in at.items():
        got = mesh_gather(
            [rows_of[i] for i in idx],
            [(-(-math.prod(items[i][1]) // _BLOCK), _BLOCK) for i in idx],
            [items[i][2]["mq"] for i in idx], mesh, cols)
        for i, t in zip(idx, got):
            rows_of[i] = t
    runs, have, want, axes = [], [], [], []
    for (sp, shape, q, _, _), block in zip(items, rows_of):
        n = math.prod(shape)
        _, (s, e) = _run(n, q["mq"], mesh)
        runs.append(block.reshape(-1)[:e - s])
        have.append(functools.partial(_run, n, q["mq"], mesh))
        want.append(functools.partial(block_region, shape, sp, mesh))
        axes.append(_run_axes(shape, sp, q["mq"], mesh, fetch=False))
    del rows_of
    new = iter(mesh_exchange(runs, [it[1] for it in items], have, want, axes,
                             mesh))
    return tree_map(lambda _: next(new), pspec), new_opt


def rank_ef_compress(grads, errors, specs, shapes, mesh):
    """--compress's error feedback over a mesh of ranks on this rank's
    blocks (`optim.compress.compress_blocks`): each leaf's residual block
    under `specs["errors"]` (the moments' ZeRO-1 spec) and the rank's
    gradient block inside it, gc = g + err; the leaf's scale mean |gc| the
    blocks' sums of |gc| summed over the ranks that cut the leaf
    (`_sum_by_group`: one all-reduce a distinct group) over its numel.
    `grads` are the rank's model blocks; no gradient or residual is
    gathered.  Returns (the decoded ZeRO-1 blocks, the new residual
    blocks)."""
    espec, pshape = specs["errors"], shapes["params"]
    g = tree_leaves(cut(grads, espec, mesh, specs["params"], pshape))
    leaves = tree_leaves(errors)
    decoded, new_err = compress_blocks(
        g, leaves, [t.numel() for t in tree_leaves(pshape)],
        [_cut_axes(sp, mesh) for sp in tree_leaves(espec)],
        lambda ts, ks: _sum_by_group(ts, ks, mesh))
    of = {id(t): (d, e) for t, d, e in zip(leaves, decoded, new_err)}
    return (tree_map(lambda t: of[id(t)][0], errors),
            tree_map(lambda t: of[id(t)][1], errors))


def rank_update(optimizer_name, optimizer, state, grads, lr, specs, shapes,
                mesh, *, compress=False, donate=False):
    """The update over a mesh of ranks from this rank's model blocks of
    the data-summed gradients (`make_train_step`'s over ranks): no rank
    gathers a whole leaf.  `state` is the rank's (its blocks under
    `specs`, of whole trees `shapes`); `donate`: AdamW in place.  Returns
    (the new params, the new optimizer state, the new residuals or None,
    the global gradient norm)."""
    params = state["params"]
    pspec, pshape = specs["params"], shapes["params"]
    gspec, new_err = pspec, None
    if compress:
        # the decoded gradients are ZeRO-1 blocks
        gspec = specs["errors"]
        grads, new_err = rank_ef_compress(grads, state["errors"], specs,
                                          shapes, mesh)
    grad_norm = tp_global_norm(grads, gspec, mesh)
    if optimizer_name == "adamw":
        # elementwise given the clip's scale: the rank's (model, data)
        # blocks, put back together over the data group
        mspec = specs["opt"]["m"]
        blocks, new_opt = optimizer.update(
            cut(grads, mspec, mesh, gspec, pshape), state["opt"],
            cut(params, mspec, mesh, pspec, pshape), lr, norm=grad_norm,
            **({"donate": True} if donate else {}))
        new_params = gather(blocks, mspec, pshape, mesh, dp_axes(mesh))
    elif optimizer_name == "adafactor":
        new_params, new_opt = rank_adafactor_update(
            optimizer, grads, params, state["opt"], lr, specs, shapes, mesh,
            grad_specs=gspec)
    else:
        if compress:
            # back to model blocks, which the state's runs are fetched from
            grads = gather(grads, gspec, pshape, mesh, dp_axes(mesh))
        new_params, new_opt = rank_adam8bit_update(
            optimizer, grads, params, state["opt"], lr, grad_norm, specs,
            shapes, mesh)
    return new_params, new_opt, new_err, grad_norm


def rank_rows(batch, mesh, accum: int = 1):
    """This rank's microbatches of the global `batch`: microbatch i is
    the global rows [i*B/accum, (i+1)*B/accum) (the reference's
    `reshape(accum, ...)`), cut over the data ranks contiguously in rank
    order (its data-parallel sharding of each microbatch)."""
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"a global batch of {rows} rows does not cut into "
                         f"{accum} microbatches")
    per = rows // accum
    mine = local_block((per,), P(dp_axes(mesh)), mesh)[0]
    return [{k: v[i * per + mine.start:i * per + mine.stop]
             for k, v in batch.items()} for i in range(accum)]


def train_state_from_jax(state, cfg, *, device=None):
    """The reference's whole TrainState (params, optimizer state, step,
    errors if any; numpy leaves, as `jax.tree.map(np.asarray, state)`
    gives them) as the port's, each leaf keeping its dtype."""
    dev = resolve_device(device)
    out = {k: tree_map(lambda a: _to_torch(np.asarray(a), dev), v)
           for k, v in state.items() if k != "params"}
    out["params"] = lm_from_jax(state["params"], cfg, device=dev)
    return out


# --- train step --------------------------------------------------------------

def _loss_and_grads(cfg, params, batch):
    """(loss, metrics, grads) of train_loss at `params`, which are taken
    as leaves of the graph (the caller's tensors are not changed)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    loss, metrics = train_loss(live, cfg, batch)
    grad_of = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda t: grad_of[id(t)], live))


def make_train_step(cfg, mesh=None, *, optimizer_name: str = "adamw",
                    peak_lr: float = 3e-4, warmup: int = 2000,
                    total_steps: int = 100_000, accum: int = 1,
                    compress: bool = False, donate: bool = False):
    """Returns (step_fn, init_state, optimizer); init_state(seed, device=)
    builds a fresh state.  With a `mesh`, each step runs inside `with
    mesh:` (the model code's ambient mesh).  Over a mesh of ranks
    init_state gives this rank's blocks of the fresh state (never the
    whole params on the device), step_fn takes the global batch and the
    state `place`d on the mesh (`state_pspecs`), and returns the rank's
    new state and the global metrics, equal on every rank.  `donate`
    (AdamW): step_fn takes the state's buffers, as the reference's
    trainer donates them, and updates its moments and params in place
    (the same bits as a new state); the caller must not use the state it
    passed again."""
    optimizer = get_optimizer(optimizer_name)
    in_place = {"donate": True} if donate and optimizer_name == "adamw" \
        else {}
    ranks = mesh if mesh is not None and mesh.ranks is not None else None
    if ranks is not None:
        specs, shapes = state_pspecs(cfg, optimizer, ranks, compress)

    def step_fn(state, batch) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        with (mesh if mesh is not None else contextlib.nullcontext()):
            return _step(state, batch)

    def _step(state, batch) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = state["params"]
        if ranks is not None:
            mbs = rank_rows(batch, ranks, accum)
        elif accum > 1:
            mbs = [{k: v.reshape(accum, v.shape[0] // accum,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(accum)]
        else:
            mbs = [batch]
        if accum > 1:
            gsum, lsum = None, 0.0
            for mb in mbs:
                loss, _, g = _loss_and_grads(cfg, params, mb)
                g = tree_map(lambda t: t.to(torch.float32), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = _loss_and_grads(cfg, params, mbs[0])
        if ranks is not None:
            grads = sum_rank_grads(cfg, grads, mbs[0], ranks)
            return _rank_update(state, grads, loss, metrics)

        if compress:
            grads, new_err = _ef_compress(grads, state["errors"])
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        grad_norm = _global_norm(grads)
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               lr, **in_place)
        return _finish(state, new_params, new_opt,
                       new_err if compress else None, loss, metrics, lr,
                       grad_norm)

    def _rank_update(state, grads, loss, metrics):
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        new_params, new_opt, new_err, grad_norm = rank_update(
            optimizer_name, optimizer, state, grads, lr, specs, shapes,
            ranks, compress=compress, donate=bool(in_place))
        return _finish(state, new_params, new_opt, new_err, loss, metrics,
                       lr, grad_norm)

    def _finish(state, new_params, new_opt, new_err, loss, metrics, lr,
                grad_norm):
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_err is not None:
            new_state["errors"] = new_err
        metrics = dict(metrics)
        metrics.update(loss=loss, lr=lr, grad_norm=grad_norm)
        return new_state, metrics

    def init_state(seed, *, device=None):
        if ranks is not None:
            return _rank_state(seed, device)
        st = make_train_state(seed, cfg, optimizer, device=device)
        if compress:
            st["errors"] = init_errors(st["params"])
        return st

    def _rank_state(seed, device):
        """A fresh state as this rank holds it (its blocks under `specs`),
        drawn as blocks: the params inside the mesh (`init_params`: the
        rank's model blocks, the weights one process's), AdamW's zero
        moments and the --compress residuals as their blocks within the
        params'; adam8bit's codes and scales at its blocks' shapes
        (`init_blocks`); Adafactor's factored state, whose leaves are not
        the params' shapes, from whole-shaped stand-ins (a zero expanded,
        no storage) of the params, cut."""
        with ranks:
            params = init_params(seed, cfg, device=device)
        pspec, pshape = specs["params"], shapes["params"]
        dev = resolve_device(device)

        def within(tree, spec):
            # a block smaller than the param's is copied out of it
            return tree_map(lambda b, t: t if b.shape == t.shape
                            else b.clone(),
                            cut(tree, spec, ranks, pspec, pshape), tree)
        if optimizer_name == "adamw":
            opt = optimizer.init(params)
            opt.update(m=within(opt["m"], specs["opt"]["m"]),
                       v=within(opt["v"], specs["opt"]["v"]))
        elif optimizer_name == "adam8bit":
            opt = optimizer.init_blocks(tree_map(
                lambda t, sp: local_shape(tuple(t.shape), sp, ranks),
                shapes["opt"]["q"], specs["opt"]["q"]), device=dev)
        else:
            stand = tree_map(lambda t: torch.zeros(
                (), dtype=t.dtype, device=dev).expand(t.shape), pshape)
            opt = tree_map(torch.Tensor.clone,
                           cut(optimizer.init(stand), specs["opt"], ranks))
        st = {"params": params, "opt": opt,
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
        if compress:
            st["errors"] = within(init_errors(params), specs["errors"])
        return st

    return step_fn, init_state, optimizer


def _ef_compress(grads, errors):
    signs, scales, new_err = compress_tree(grads, errors)
    return decompress_tree(signs, scales), new_err


# --- serve steps -------------------------------------------------------------

def make_prefill_step(cfg):
    def fn(params, batch):
        return model_prefill(params, cfg, batch)
    return fn


def make_decode_step(cfg, ctx_len: int):
    """`ctx_len` is the cache length; it selects the hybrid family's
    attention window."""
    def fn(params, tokens, caches, pos):
        return model_decode(params, cfg, tokens, caches, pos, ctx_len)
    return fn
