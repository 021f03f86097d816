"""End-to-end trainer: config -> mesh -> data -> train step loop (port
of `repro.launch.train`).

  * --arch: drim-bnn (the paper's application) or any arch of
    `configs.ARCHS` (the dense, vlm, MoE, SSM, hybrid and audio
    families; `chip_smoke.py` trains one of each on the card)
  * checkpoint/restart (atomic manifests, async save, --resume)
  * heartbeats every step (runtime/ft.py)
  * gradient accumulation, 1-bit EF compression, ZeRO-1 specs
  * deterministic (seed, step) data order => restarts are exact

On the card (the default) attention runs the flash forward and backward
kernels; `--device cpu` runs the plain versions.  `--mesh` is the
reference's: "host" (the default) the host mesh over `--device`'s
devices, data x model n x 1; the state's shardings come from
`state_shardings` over the abstract state and the state is placed on
them (on one card or the CPU, a 1x1 mesh: nothing moves).  "single" and
"multi" are the 16 x 16 and 2 x 16 x 16 production meshes, which raise
ValueError below 256 and 512 devices.  The CPU-scale example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch drim-bnn \\
      --smoke-config --device cpu --steps 30 --batch 4 --seq 64

Prints one JSON line per logged step ({"step", "s_per_step", "loss",
"ce", "lr", "grad_norm", ...}; "wall_s" is the time since the loop
began, after the step's values reached the host), then
{"final_loss", "steps"}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, attach_modality_stub
from repro_torch.core.mesh import NamedSharding
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import cli_mesh
from repro_torch.optim import get_optimizer
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.runtime.steps import (abstract_train_state, make_train_step,
                                       place, state_shardings)
from repro_torch.tree import tree_map


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="drim-bnn")
    ap.add_argument("--smoke-config", action="store_true",
                    help="use the reduced config (CI scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup steps (default: min(2000, steps // 10))")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="1-bit EF gradient compression")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bitlinear", default=None,
                    help="override cfg.bitlinear (none|ffn|attn|all)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build_cfg(args):
    cfg = (get_smoke_config(args.arch) if args.smoke_config
           else get_config(args.arch))
    if args.bitlinear is not None:
        cfg = cfg.replace(bitlinear=args.bitlinear)
    return cfg


def build(args, mesh=None):
    """(cfg, step_fn, init_state) as the trainer builds them from its
    arguments, the step over `mesh` (default: the --mesh of --device)."""
    cfg = build_cfg(args)
    if mesh is None:
        mesh = cli_mesh(args.mesh, resolve_device(args.device))
    warmup = (args.warmup if args.warmup is not None
              else max(1, min(2000, args.steps // 10)))
    step_fn, init_state, _ = make_train_step(
        cfg, mesh, optimizer_name=args.optimizer, peak_lr=args.lr,
        warmup=warmup, total_steps=args.steps, accum=args.accum,
        compress=args.compress)
    return cfg, step_fn, init_state


def shardings(args, cfg, mesh):
    """The train state's shardings on `mesh`, as the reference's trainer
    computes them: `state_shardings` of the abstract state, and with
    --compress the error-feedback residuals on the moments' specs."""
    state_shape = abstract_train_state(cfg, get_optimizer(args.optimizer))
    st_sh = state_shardings(state_shape, mesh, family=cfg.family)
    if args.compress:
        st_sh["errors"] = tree_map(
            lambda s: NamedSharding(mesh, s),
            shd.opt_state_pspecs(state_shape["params"], mesh,
                                 family=cfg.family))
    return st_sh


def batch_at(data, cfg, step: int, seed: int, device):
    raw = attach_modality_stub(data.batch_at(step), cfg, seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def main(argv=None) -> float:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = cli_mesh(args.mesh, dev)
    cfg, step_fn, init_state = build(args, mesh)
    st_sh = shardings(args, cfg, mesh)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    with contextlib.ExitStack() as stack:
        stack.enter_context(mesh)
        hb_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="drimx_"))
        hb = HeartbeatMonitor(os.path.join(hb_dir, "heartbeats.jsonl"),
                              host_id=0)
        state = place(init_state(args.seed, device=dev), st_sh)
        start = 0
        if ckpt and args.resume:
            got = ckpt.restore_latest(state, device=dev)
            if got[0] is not None:
                start, state = got
                print(f"resumed from step {start}")

        metrics, saved = None, start
        t0 = time.time()
        for step in range(start, args.steps):
            state, metrics = step_fn(state, batch_at(data, cfg, step,
                                                     args.seed, dev))
            hb.beat(step)
            if (step + 1) % args.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                wall = time.time() - t0
                dt = wall / (step - start + 1)
                print(json.dumps({"step": step + 1, "s_per_step":
                                  round(dt, 3), **{k: round(v, 4)
                                                   for k, v in m.items()},
                                  "wall_s": wall}), flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
                saved = step + 1
        if ckpt:
            if saved != args.steps:
                ckpt.save(args.steps, state)
            ckpt.wait()
    final_loss = (float(metrics["loss"]) if metrics is not None
                  else float("nan"))
    print(json.dumps({"final_loss": final_loss, "steps": args.steps}))
    return final_loss


if __name__ == "__main__":
    main()
