"""End-to-end trainer: config -> data -> train step loop (port of
`repro.launch.train`).

  * --arch drim-bnn (the paper's application, the one arch ported)
  * checkpoint/restart (atomic manifests, async save, --resume)
  * heartbeats every step (runtime/ft.py)
  * gradient accumulation, 1-bit EF compression
  * deterministic (seed, step) data order => restarts are exact

On the card (the default) attention runs the flash forward and backward
kernels; `--device cpu` runs the plain versions.  `--mesh host` and
`single` both mean one device; `multi` needs meshes (ROADMAP Queue 1
item 12).  The CPU-scale example:

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
from repro_torch.device import resolve_device
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.runtime.steps import make_train_step


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
    args = ap.parse_args(argv)
    if args.mesh == "multi":
        raise NotImplementedError("--mesh multi needs a device mesh: ROADMAP "
                                  "Queue 1 item 12")
    return args


def build(args):
    """(cfg, step_fn, init_state) as the trainer builds them from its
    arguments."""
    cfg = (get_smoke_config(args.arch) if args.smoke_config
           else get_config(args.arch))
    if args.bitlinear is not None:
        cfg = cfg.replace(bitlinear=args.bitlinear)
    warmup = (args.warmup if args.warmup is not None
              else max(1, min(2000, args.steps // 10)))
    step_fn, init_state, _ = make_train_step(
        cfg, optimizer_name=args.optimizer, peak_lr=args.lr, warmup=warmup,
        total_steps=args.steps, accum=args.accum, compress=args.compress)
    return cfg, step_fn, init_state


def batch_at(data, cfg, step: int, seed: int, device):
    raw = attach_modality_stub(data.batch_at(step), cfg, seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def main(argv=None) -> float:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, step_fn, init_state = build(args)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None

    with contextlib.ExitStack() as stack:
        hb_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="drimx_"))
        hb = HeartbeatMonitor(os.path.join(hb_dir, "heartbeats.jsonl"),
                              host_id=0)
        state = init_state(args.seed, device=dev)
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
