"""Multi-pod dry-run on meta tensors: build every (arch x shape x mesh)
cell and report what one device of the production mesh would hold (port
of `repro.launch.dryrun`).

The reference AOT-compiles each cell's jitted step on 512 forced host
devices and reads XLA's analyses.  The port compiles nothing.  It builds
each cell's step and arguments on the meta device (shapes and dtypes, no
storage) with the specs of the 16 x 16 single-pod or 2 x 16 x 16
multi-pod mesh (`core.mesh.abstract_mesh`: `launch.mesh.
make_production_mesh` raises below 256 devices), runs the step once at
the cell's full global shape, and records:

  * lower_s             the time to build the cell and run its step on
                        meta tensors: the counterpart of `.lower()`, the
                        proof that shapes and specs cohere;
  * mem_argument_b      per-device bytes of the step's arguments: each
                        leaf's dims ceil-divided by the sizes of its
                        spec's mesh axes, summed over the leaves the step
                        reads (how XLA's argument_size_in_bytes is made:
                        jit prunes an argument nothing reads);
  * mem_output_b        the same over the outputs under their
                        out-shardings (XLA's output_size_in_bytes less its
                        8-byte tuple index per output leaf);
  * flops_global        `torch.utils.flop_counter.FlopCounterMode`'s
                        count of the whole global step as one process
                        runs it: not per device, and not an `hlo_*` key;
  * model_flops_global, param_count, active_param_count (as the
                        reference).

The step is traced with no ambient mesh: under the production mesh the
MoE would take its expert-parallel path, which runs a block per (data,
model) position in turn.  The mesh enters only through the specs.  On
meta tensors attention takes the dense-scores `_sdpa` (`_use_flash` is
for the card), which is right for shapes, so `flops_global` counts dense
scores.  The port's trunk is a Python loop, so the meta run counts every
layer.

Left out, as reference-only (they read XLA's compiler output, which a
process that compiles nothing does not have): mem_temp_b and mem_peak_b,
the hlo_* costs, collective_bytes_per_device and its HLO text parser,
and the probe extrapolation (`probe_points` to `probe_all`, which exist
because XLA counts a scanned layer once).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh single           # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # every cell

Each cell appends one JSON record to --out (resumable: cells already
there are skipped unless --force); the exit code is 1 when a cell fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config, shapes_for
from repro_torch.configs.registry import ARCHS
from repro_torch.core.mesh import (Mesh, NamedSharding, PartitionSpec as P,
                                   abstract_mesh, axis_size)
from repro_torch.models import abstract_caches, abstract_params
from repro_torch.models.transformer import padded_vocab
from repro_torch.optim import init_errors
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.steps import (abstract_train_state, make_decode_step,
                                       make_prefill_step, make_train_step,
                                       state_shardings)
from repro_torch.tree import tree_leaves, tree_map

# Per-arch optimizer defaults (the giant MoEs use adafactor).
ARCH_OPTIMIZER = {"kimi-k2-1t-a32b": "adafactor",
                  "deepseek-v3-671b": "adafactor"}

META = torch.device("meta")


def production_mesh(mesh_kind: str) -> Mesh:
    """The 16 x 16 (single) or 2 x 16 x 16 (multi) mesh over meta
    devices."""
    if mesh_kind == "multi":
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    if mesh_kind == "single":
        return abstract_mesh((16, 16), ("data", "model"))
    raise ValueError(f"unknown mesh {mesh_kind!r}: single or multi")


def input_specs(cfg, shape_name: str, *, batch_override=None):
    """Meta-tensor stand-ins for every model input (no storage)."""
    sh = SHAPES[shape_name]
    b = batch_override or sh.global_batch
    s = sh.seq_len
    i32 = torch.int32

    def sd(shp, dt):
        return torch.empty(shp, dtype=dt, device=META)

    if sh.kind == "train":
        batch = {"tokens": sd((b, s), i32), "labels": sd((b, s), i32)}
    elif sh.kind == "prefill":
        batch = {"tokens": sd((b, s), i32)}
    else:  # decode: one new token against an s-length cache
        batch = {"tokens": sd((b, 1), i32)}
    if cfg.family == "vlm" and sh.kind != "decode":
        batch["patch_embeds"] = sd((b, cfg.n_patches, cfg.d_model),
                                   torch.bfloat16)
    if cfg.family == "audio" and sh.kind != "decode":
        batch["frames"] = sd((b, cfg.n_frames, cfg.d_model), torch.bfloat16)
    return batch


def model_flops(cfg, shape_name: str) -> float:
    """Analytic MODEL_FLOPS: 6*N*D train / 2*N*D forward (+ attention)."""
    sh = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    tokens = sh.global_batch * (sh.seq_len if sh.kind != "decode" else 1)
    mult = 6.0 if sh.kind == "train" else 2.0
    flops = mult * n_active * tokens
    # attention quadratic term (full-attn archs; per-token*ctx for decode)
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        h_dim = cfg.n_heads * (cfg.v_head_dim if cfg.mla else cfg.d_head)
        ctx = sh.seq_len
        q_positions = tokens
        att = 2 * 2 * cfg.n_layers * q_positions * ctx * h_dim  # qk + av
        if sh.kind == "train":
            att = att / 2 * 3  # causal halves it, bwd doubles fwd
        flops += att
    return flops


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell's step and where its arguments and outputs live: the
    shardings are trees matching `fn`'s arguments and its outputs; None
    stands for a replicated output (the reference's unspecified one).
    A train step runs with autograd on, a serving step without."""

    fn: Callable
    in_shardings: Tuple[Any, ...]
    out_shardings: Tuple[Any, ...]
    train: bool = False


def _named(mesh: Mesh, specs):
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def build_cell(cfg, shape_name: str, mesh: Mesh, *, optimizer: str,
               compress: bool = False, zero1: bool = True):
    """Returns (cell, example_args): the step, its shardings, and its
    arguments as meta tensors."""
    sh = SHAPES[shape_name]
    batch = input_specs(cfg, shape_name)
    dp = shd.dp_axes(mesh)

    if sh.kind == "train":
        # traced with no ambient mesh (see the module docstring)
        step_fn, _, opt = make_train_step(
            cfg, None, optimizer_name=optimizer, compress=compress)
        state_shape = abstract_train_state(cfg, opt)
        if compress:
            state_shape = dict(state_shape)
            with META:
                state_shape["errors"] = init_errors(state_shape["params"])
        st_sh = state_shardings(state_shape, mesh, zero1=zero1,
                                family=cfg.family)
        if compress:
            st_sh["errors"] = _named(mesh, shd.opt_state_pspecs(
                state_shape["params"], mesh, family=cfg.family))
        b_sh = _named(mesh, shd.batch_specs(mesh, batch))
        return Cell(step_fn, (st_sh, b_sh), (st_sh, None), train=True), \
            (state_shape, batch)

    # serving: params only (bf16 serving dtype)
    serve_cfg = cfg.replace(param_dtype="bfloat16", remat=False)
    params_shape = abstract_params(serve_cfg)
    p_sh = _named(mesh, shd.param_pspecs(params_shape, mesh, cfg.family))
    caches_shape = abstract_caches(serve_cfg, sh.global_batch, sh.seq_len)
    c_sh = _named(mesh, shd.cache_pspecs(mesh, caches_shape))
    logits_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp, None, "model"), (sh.global_batch, 1, padded_vocab(cfg)),
        mesh))

    if sh.kind == "prefill":
        b_sh = _named(mesh, shd.batch_specs(mesh, batch))
        return Cell(make_prefill_step(serve_cfg), (p_sh, b_sh),
                    (logits_sh, c_sh)), (params_shape, batch)

    # decode
    tok_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp, None), (sh.global_batch, 1), mesh))
    pos_sh = NamedSharding(mesh, shd.sanitize_spec(
        P(dp), (sh.global_batch,), mesh))
    pos = torch.empty((sh.global_batch,), dtype=torch.int32, device=META)
    return Cell(make_decode_step(serve_cfg, sh.seq_len),
                (p_sh, tok_sh, c_sh, pos_sh), (logits_sh, c_sh)), \
        (params_shape, batch["tokens"], caches_shape, pos)


def shard_bytes(leaf, sharding) -> int:
    """Bytes of one device's block of `leaf` under `sharding` (None:
    replicated): each dim ceil-divided by its spec entry's devices."""
    n = leaf.element_size()
    spec = tuple(sharding.spec) if sharding is not None else ()
    for i, dim in enumerate(leaf.shape):
        entry = spec[i] if i < len(spec) else None
        parts = axis_size(sharding.mesh, entry) if entry is not None else 1
        n *= -(-dim // parts)
    return n


def device_bytes(trees, shardings, read=None) -> int:
    """Per-device bytes of a tuple of trees under their shardings (a None
    sharding replicates its whole tree); with `read` (leaf ids), only
    those leaves."""
    def one(leaf, sh=None):
        return shard_bytes(leaf, sh) if read is None or id(leaf) in read \
            else 0
    total = 0
    for tree, sh in zip(trees, shardings):
        total += sum(tree_leaves(tree_map(one, tree) if sh is None
                                 else tree_map(one, tree, sh)))
    return total


def _tensors(items):
    """The tensors among `items`, in lists and tuples at any depth."""
    for x in items:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


class _Dataflow(TorchDispatchMode):
    """Records each operator's input tensors and outputs, so that the
    argument leaves the step's outputs depend on can be found afterwards.
    The outputs are held, so that no id is reused during the run."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops.append(([id(t) for t in _tensors(args)]
                         + [id(t) for t in _tensors(kwargs.values())],
                         list(_tensors((out,)))))
        return out

    def live(self, outputs) -> set:
        """Ids of every tensor some output depends on (in-place updates
        included: an operator whose output is live makes its inputs
        live)."""
        live = {id(t) for t in outputs}
        for ins, outs in reversed(self.ops):
            if any(id(t) in live for t in outs):
                live.update(ins)
        return live


def run_meta(cell: Cell, args):
    """The cell's step run once on its meta arguments: (outputs, FLOPs
    counted by FlopCounterMode, the ids of the argument leaves the
    outputs depend on).  XLA removes what no output depends on, and jit
    then prunes an argument nothing reads (`keep_unused=False`): the SSM
    decode never reads `pos`, and whisper's decode reads its cross
    attention's query and output kernels but not its key and value
    kernels (the caches hold those)."""
    counter = FlopCounterMode(display=False)
    flow = _Dataflow()
    with counter, flow, \
            (torch.enable_grad() if cell.train else torch.no_grad()):
        out = cell.fn(*args)
    live = flow.live([t for o in out for t in tree_leaves(o)])
    read = {id(leaf) for a in args for leaf in tree_leaves(a)} & live
    return out, counter.get_total_flops(), read


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             optimizer=None, compress=False, zero1=True, variant="base",
             cfg_overrides=None) -> dict:
    optimizer = optimizer or ARCH_OPTIMIZER.get(arch, "adamw")
    mesh = production_mesh(mesh_kind)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "optimizer": optimizer,
           "devices": mesh.devices.size, "status": "ok",
           "compress": compress, "zero1": zero1}
    if cfg_overrides:
        rec["cfg_overrides"] = cfg_overrides
    t0 = time.time()
    try:
        cfg = get_config(arch)
        if cfg_overrides:
            cfg = cfg.replace(**cfg_overrides)
        cell, args = build_cell(cfg, shape_name, mesh, optimizer=optimizer,
                                compress=compress, zero1=zero1)
        out, flops, read = run_meta(cell, args)
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["mem_argument_b"] = device_bytes(args, cell.in_shardings, read)
        rec["mem_output_b"] = device_bytes(out, cell.out_shardings)
        rec["flops_global"] = float(flops)
        rec["model_flops_global"] = model_flops(cfg, shape_name)
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()
        print(f"memory per device: arguments {rec['mem_argument_b']:,} B, "
              f"outputs {rec['mem_output_b']:,} B; flops (global) "
              f"{flops:.3e}")
    except Exception as e:  # noqa: BLE001 -- record the failure, don't die
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def all_cells():
    for arch in ARCHS:
        if arch == "drim-bnn":
            continue  # paper-app config, not an assigned cell
        cfg = get_config(arch)
        for shape_name in shapes_for(cfg):
            for mesh_kind in ("single", "multi"):
                yield arch, shape_name, mesh_kind


def parse_overrides(items) -> dict:
    """`field=value` pairs, each value JSON where it parses (the
    reference's `--override`)."""
    overrides = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--optimizer")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--variant", default="base")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg field=value overrides (e.g. bitlinear=ffn)")
    args = ap.parse_args(argv)

    done = set()
    if os.path.exists(args.out) and not args.force:
        for line in open(args.out):
            try:
                r = json.loads(line)
                done.add((r["arch"], r["shape"], r["mesh"], r["variant"]))
            except json.JSONDecodeError:
                pass

    overrides = parse_overrides(args.override)
    cells = (list(all_cells()) if args.all
             else [(args.arch, args.shape, args.mesh)])
    failures = 0
    for arch, shape_name, mesh_kind in cells:
        key = (arch, shape_name, mesh_kind, args.variant)
        if key in done:
            print(f"skip {key} (cached)")
            continue
        print(f"=== {arch} x {shape_name} x {mesh_kind} "
              f"[{args.variant}] ===", flush=True)
        rec = run_cell(arch, shape_name, mesh_kind,
                       optimizer=args.optimizer, compress=args.compress,
                       zero1=not args.no_zero1, variant=args.variant,
                       cfg_overrides=overrides or None)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in ("status", "lower_s")
                          if k in rec}), flush=True)
        if rec["status"] != "ok":
            failures += 1
            print(rec.get("error", ""), file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
