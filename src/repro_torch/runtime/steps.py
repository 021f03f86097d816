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
to that device, so a 1x1 mesh changes no value.  A mesh of distinct
devices needs a process per device (ROADMAP Queue 1) and raises.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.mesh import NamedSharding, PartitionSpec as P
from repro_torch.device import resolve_device
from repro_torch.models import (abstract_params, decode_step as model_decode,
                                init_params, lm_from_jax,
                                prefill as model_prefill, train_loss)
from repro_torch.models.transformer import _to_torch
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


def place(tree, shardings):
    """Every leaf of `tree` on its `NamedSharding`.  On a mesh whose
    devices are all one device the leaf moves there whole (a no-op when
    it is there already).  A mesh of distinct devices would need a
    process per device, which the port does not have: ValueError."""
    def one(leaf, sh):
        devs = set(sh.mesh.devices.flat)
        if len(devs) != 1:
            raise ValueError(
                f"placing a state on a mesh of {len(devs)} distinct devices "
                f"({sorted(map(str, devs))}) needs a process per device "
                "(ROADMAP Queue 1); use a mesh of one device")
        return leaf.to(next(iter(devs)))
    return tree_map(one, tree, shardings)


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
                    compress: bool = False):
    """Returns (step_fn, init_state, optimizer); init_state(seed, device=)
    builds a fresh state.  With a `mesh`, each step runs inside `with
    mesh:` (the model code's ambient mesh)."""
    optimizer = get_optimizer(optimizer_name)

    def step_fn(state, batch) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        with (mesh if mesh is not None else contextlib.nullcontext()):
            return _step(state, batch)

    def _step(state, batch) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        params = state["params"]
        if accum > 1:
            gsum, lsum = None, 0.0
            for i in range(accum):
                mb = {k: v.reshape(accum, v.shape[0] // accum,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, _, g = _loss_and_grads(cfg, params, mb)
                g = tree_map(lambda t: t.to(torch.float32), g)
                gsum = g if gsum is None else tree_map(torch.add, gsum, g)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / accum, gsum)
            loss = lsum / accum
            metrics = {"ce": loss}
        else:
            loss, metrics, grads = _loss_and_grads(cfg, params, batch)

        if compress:
            grads, new_err = _ef_compress(grads, state["errors"])
        lr = warmup_cosine(state["step"], peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               lr)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if compress:
            new_state["errors"] = new_err
        metrics = dict(metrics)
        metrics.update(loss=loss, lr=lr, grad_norm=_global_norm(grads))
        return new_state, metrics

    def init_state(seed, *, device=None):
        st = make_train_state(seed, cfg, optimizer, device=device)
        if compress:
            st["errors"] = init_errors(st["params"])
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
