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
    that cut the summed axes (`rank_adafactor_update`).  adam8bit, whose
    int8 blocks of 256 run over the flattened leaf, gathers the params,
    gradients and state over both axes, updates whole leaves and keeps
    the rank's blocks
  --compress: the gradients and the cut residuals are gathered whole,
    the whole summed gradient is encoded and decoded, and each rank
    keeps its residuals' block; the update then runs on the rank's
    blocks as above

A mesh of distinct devices with no process group would need a process
per device and raises.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import (NamedSharding, PartitionSpec as P,
                                   axis_size, dp_axes, drop_axes,
                                   local_block, mesh_gather, mesh_sum,
                                   sub_block)
from repro_torch.device import resolve_device
from repro_torch.models import (abstract_params, decode_step as model_decode,
                                init_params, lm_from_jax,
                                prefill as model_prefill, train_loss)
from repro_torch.models.transformer import (_to_torch, cuts_sequence,
                                           grad_axes)
from repro_torch.optim import (compress_tree, decompress_tree, get_optimizer,
                               init_errors, warmup_cosine)
from repro_torch.optim.optimizers import global_norm as _global_norm
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


def _model_cut(spec, mesh) -> bool:
    return any(e is not None and "model" in ((e,) if isinstance(e, str)
                                             else e)
               for e in spec) and axis_size(mesh, "model") > 1


def tp_global_norm(grads, specs, mesh):
    """The global norm of a gradient tree whose leaves are this rank's
    model blocks under `specs`: each leaf's sum of squares in float32 (in
    `optim.global_norm`'s leaf order), the model-cut leaves' summed over
    the model group in one all-reduce, each replicated leaf's counted
    once."""
    leaves, leaf_specs = tree_leaves(grads), tree_leaves(specs)
    sums = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    cut_at = [i for i, sp in enumerate(leaf_specs) if _model_cut(sp, mesh)]
    if cut_at:
        total = mesh_sum([torch.stack([sums[i] for i in cut_at])], mesh,
                         ("model",))[0]
        for j, i in enumerate(cut_at):
            sums[i] = total[j]
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


def _sum_by_group(tensors, keys, mesh):
    """Each tensor summed over the ranks along its key (a `_cut_axes`
    tuple): one `mesh_sum` a distinct key; a key of no axis leaves its
    tensor as it is."""
    out = list(tensors)
    at: Dict[tuple, list] = {}
    for i, key in enumerate(keys):
        if key:
            at.setdefault(key, []).append(i)
    for axes, idx in at.items():
        for i, t in zip(idx, mesh_sum([tensors[i] for i in idx], mesh,
                                      axes)):
            out[i] = t
    return out


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
                          mesh):
    """Adafactor's update over a mesh of ranks on this rank's blocks
    (`optimizer.update_blocks`): one process's values in another float
    order.  `grads` and `params` are the rank's model blocks (under
    `specs["params"]`), `opt` its state under `specs["opt"]`, `shapes`
    the whole trees ({"params", "opt"}).  Each leaf is updated on the
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
        cut(grads, zspec, mesh, pspec, pshape), {"f": f_blocks,
                                                 "step": opt["step"]},
        cut(params, zspec, mesh, pspec, pshape), lr, shapes=pshape,
        groups=groups, psum=lambda ts, ks: _sum_by_group(ts, ks, mesh))
    del f_blocks
    flat = []
    tree_map(lambda _, st, ns: flat.extend(ns[k] for k in st), zspec,
             opt["f"], new["f"])
    new_f = rebuild(_moved(flat, whole, want, have, mesh))
    return (gather(blocks, zspec, pshape, mesh, dp_axes(mesh)),
            {"f": new_f, "step": new["step"]})


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
        """The update over a mesh of ranks from this rank's model blocks
        of the data-summed gradients."""
        params = state["params"]
        pspec, model = specs["params"], ("model",)
        # --compress's error feedback and adam8bit's int8 blocks over the
        # flattened leaf need whole leaves
        whole = compress or optimizer_name == "adam8bit"
        if whole:
            grads = gather(grads, pspec, shapes["params"], ranks, model)
        new_err = None
        if compress:
            errors = gather(state["errors"], specs["errors"],
                            shapes["errors"], ranks)
            grads, new_err = _ef_compress(grads, errors)
            new_err = tree_map(torch.Tensor.clone,
                               cut(new_err, specs["errors"], ranks))
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        grad_norm = (_global_norm(grads) if whole
                     else tp_global_norm(grads, pspec, ranks))
        if optimizer_name == "adamw":
            # elementwise given the clip's scale: the rank's (model, data)
            # blocks, put back together over the data group
            mspec = specs["opt"]["m"]
            g_blocks = (cut(grads, mspec, ranks) if whole else
                        cut(grads, mspec, ranks, pspec, shapes["params"]))
            blocks, new_opt = optimizer.update(
                g_blocks, state["opt"],
                cut(params, mspec, ranks, pspec, shapes["params"]), lr,
                norm=grad_norm, **in_place)
            new_params = gather(blocks, mspec, shapes["params"], ranks,
                                dp_axes(ranks))
        elif optimizer_name == "adafactor":
            if whole:
                grads = cut(grads, pspec, ranks)
            new_params, new_opt = rank_adafactor_update(
                optimizer, grads, params, state["opt"], lr, specs, shapes,
                ranks)
        else:       # adam8bit, on whole leaves
            full = gather(params, pspec, shapes["params"], ranks, model)
            opt = gather(state["opt"], specs["opt"], shapes["opt"], ranks)
            full, opt = optimizer.update(grads, opt, full, lr)
            new_params = tree_map(torch.Tensor.clone,
                                  cut(full, pspec, ranks))
            new_opt = tree_map(torch.Tensor.clone,
                               cut(opt, specs["opt"], ranks))
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
        params'; Adafactor's and adam8bit's state, whose leaves are not
        the params' shapes, from whole-shaped stand-ins (a zero
        expanded, no storage) of the params, cut."""
        with ranks:
            params = init_params(seed, cfg, device=device)
        pspec, pshape = specs["params"], shapes["params"]

        def within(tree, spec):
            # a block smaller than the param's is copied out of it
            return tree_map(lambda b, t: t if b.shape == t.shape
                            else b.clone(),
                            cut(tree, spec, ranks, pspec, pshape), tree)
        if optimizer_name == "adamw":
            opt = optimizer.init(params)
            opt.update(m=within(opt["m"], specs["opt"]["m"]),
                       v=within(opt["v"], specs["opt"]["v"]))
        else:
            dev = resolve_device(device)
            stand = tree_map(lambda t: torch.zeros(
                (), dtype=t.dtype, device=dev).expand(t.shape), pshape)
            opt = tree_map(torch.Tensor.clone,
                           cut(optimizer.init(stand), specs["opt"], ranks))
        st = {"params": params, "opt": opt,
              "step": torch.zeros((), dtype=torch.int32,
                                  device=resolve_device(device))}
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
