"""End-to-end trainer: config -> mesh -> data -> train step loop (port
of `repro.launch.train`).

  * --arch: drim-bnn (the paper's application) or any arch of
    `configs.ARCHS` (the dense, vlm, MoE, SSM, hybrid and audio
    families; `chip_smoke.py` trains one of each on the card)
  * checkpoint/restart (atomic manifests, async save, --resume)
  * heartbeats every step (runtime/ft.py)
  * gradient accumulation, 1-bit EF compression, ZeRO-1 specs
  * --donate: the reference's donated state (`jax.jit(step_fn,
    donate_argnums=(0,))`): AdamW updates the state in place, the same
    bits, so a step holds one state, not two (what lets two ranks of
    the MoE's widest leaves share one card)
  * deterministic (seed, step) data order => restarts are exact

On the card (the default) attention runs the flash forward and backward
kernels; `--device cpu` runs the plain versions.  `--mesh` is the
reference's: "host" (the default) the host mesh, data x model n x 1; the
state's shardings come from `state_shardings` over the abstract state
and the state is placed on them.  In one process the host mesh is 1 x 1
over `--device` (nothing moves).  "single" and "multi" are the 16 x 16
and 2 x 16 x 16 production meshes, which raise ValueError below 256 and
512 devices.  The CPU-scale example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch drim-bnn \\
      --smoke-config --device cpu --steps 30 --batch 4 --seq 64

Under torchrun the trainer runs data-parallel over W ranks, a process
each; torchrun's environment is the only switch (`launch.mesh.
init_ranks`): gloo on the CPU (`--device cpu`), NCCL with a card a rank,
gloo where ranks share a card.  `--mesh host` is then (W, 1) over the
ranks; each rank takes its rows of every global batch, holds its ZeRO-1
block of the moments, and sums its gradients with the others'
(`runtime.steps`); the metrics are the global batch's:

  python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch drim-bnn --smoke-config \\
      --device cpu --steps 30 --batch 4 --seq 64

`--model-axis K` (default 1) makes the mesh (W / K, K): each rank
draws and holds only its model block of every param and moment by the
reference's specs, and the LM's products are Megatron's (column- and
row-parallel, the vocab-parallel embedding, head and cross-entropy; the
vlm's and the hybrid's shared block likewise; the MoE's experts, E / K a
rank, expert-parallel over the model group, and MLA on the rank's heads;
the hybrid's Mamba2 mixer on its cut params; the ssm family's params
replicated and its sequence cut over the model group, the gradients
summed over it; the audio family's encoder and cross-attention on the
rank's heads).  On the CPU, two data ranks of
two model ranks each:

  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch drim-bnn --smoke-config \\
      --device cpu --steps 30 --batch 4 --seq 64 --model-axis 2

In one process K > 1 raises ValueError: a model axis needs a process per
position.  Checkpoints hold the whole leaves (the cut ones gathered
first), written by rank 0 and published once, and restore at any (D, M)
and in one process.

Prints one JSON line per logged step ({"step", "s_per_step", "loss",
"ce", "lr", "grad_norm", ...}; "wall_s" is the time since the loop
began, after the step's values reached the host), then
{"final_loss", "steps"}; under ranks rank 0 alone prints them, after
every rank's first line (`init_ranks`).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import SyntheticLM, attach_modality_stub
from repro_torch.core.mesh import NamedSharding, mesh_barrier
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import cli_mesh, init_ranks
from repro_torch.optim import get_optimizer
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.runtime.steps import (gather, make_train_step, place,
                                       state_pspecs)
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
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the mesh's model axis (under torchrun)")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=None,
                    help="warmup steps (default: min(2000, steps // 10))")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="1-bit EF gradient compression")
    ap.add_argument("--donate", action="store_true",
                    help="hand each step the state's buffers (the "
                    "reference's donated state): AdamW updates its "
                    "moments and params in place, the same bits, one "
                    "state in memory instead of two")
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
        mesh = cli_mesh(args.mesh, resolve_device(args.device),
                        model_axis=args.model_axis)
    warmup = (args.warmup if args.warmup is not None
              else max(1, min(2000, args.steps // 10)))
    step_fn, init_state, _ = make_train_step(
        cfg, mesh, optimizer_name=args.optimizer, peak_lr=args.lr,
        warmup=warmup, total_steps=args.steps, accum=args.accum,
        compress=args.compress, donate=args.donate)
    return cfg, step_fn, init_state


def shardings(args, cfg, mesh):
    """The train state's shardings on `mesh`, as the reference's trainer
    computes them: `state_shardings` of the abstract state, and with
    --compress the error-feedback residuals on the moments' specs."""
    specs, _ = state_pspecs(cfg, get_optimizer(args.optimizer), mesh,
                            args.compress)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def batch_at(data, cfg, step: int, seed: int, device):
    raw = attach_modality_stub(data.batch_at(step), cfg, seed=seed)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


def main(argv=None) -> float:
    args = parse_args(argv)
    ranks = init_ranks(args.device)
    try:
        return _train(args, ranks)
    finally:
        if ranks is not None:
            ranks.close()


def _train(args, ranks) -> float:
    dev = ranks.device if ranks is not None else resolve_device(args.device)
    lead = ranks is None or ranks.rank == 0      # the rank that prints
    mesh = cli_mesh(args.mesh, dev, ranks, args.model_axis)
    cfg, step_fn, init_state = build(args, mesh)
    # the state's specs (`shardings`') and its whole leaves, abstract
    specs, whole = state_pspecs(cfg, get_optimizer(args.optimizer), mesh,
                                args.compress)
    st_sh = tree_map(lambda s: NamedSharding(mesh, s), specs)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    # under ranks rank 0 writes each checkpoint's whole leaves
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir and lead else None

    def save(step: int, state) -> None:
        """A checkpoint of the whole leaves (every rank takes part in
        gathering the cut ones)."""
        if ranks is not None:
            state = gather(state, specs, whole, mesh)
        if ckpt:
            ckpt.save(step, state)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mesh)
        hb_dir = args.ckpt_dir or _shared_tempdir(stack, ranks)
        hb = HeartbeatMonitor(os.path.join(hb_dir, "heartbeats.jsonl"),
                              host_id=0 if ranks is None else ranks.rank)
        # over ranks a fresh state comes as this rank's blocks
        state = place(init_state(args.seed, device=dev), st_sh, whole)
        start = 0
        if args.ckpt_dir and args.resume:
            # every rank reads the whole leaves and keeps its blocks
            got = Checkpointer(args.ckpt_dir).restore_latest(whole,
                                                             device=dev)
            if got[0] is not None:
                start, state = got[0], place(got[1], st_sh)
                if lead:
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
                if lead:
                    print(json.dumps({"step": step + 1, "s_per_step":
                                      round(dt, 3),
                                      **{k: round(v, 4)
                                         for k, v in m.items()},
                                      "wall_s": wall}), flush=True)
            if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                save(step + 1, state)
                saved = step + 1
        if args.ckpt_dir and saved != args.steps:
            save(args.steps, state)
        if ckpt:
            ckpt.wait()
        if ranks is not None:
            # every checkpoint published and every heartbeat written
            # before any rank goes on
            mesh_barrier(mesh)
    final_loss = (float(metrics["loss"]) if metrics is not None
                  else float("nan"))
    if lead:
        print(json.dumps({"final_loss": final_loss, "steps": args.steps}))
    return final_loss


def _shared_tempdir(stack, ranks) -> str:
    """A temporary directory for the heartbeats, removed on exit; under
    ranks rank 0 makes it and every rank gets its path."""
    path = [None]
    if ranks is None or ranks.rank == 0:
        path[0] = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="drimx_"))
    if ranks is not None and ranks.world > 1:
        dist.broadcast_object_list(path, src=0)
    return path[0]


if __name__ == "__main__":
    main()
