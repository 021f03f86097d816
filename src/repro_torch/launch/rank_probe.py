"""What a backend does with two ranks on one device: gloo's collectives
on the device's tensors, their times, and NCCL's answer.

    PYTHONPATH=src python -m repro_torch.launch.rank_probe
    PYTHONPATH=src python -m repro_torch.launch.rank_probe --device cpu --mb 1

Spawns two processes over a `FileStore` in a temporary directory.  With
gloo, both on `--device` (default: cuda:0): one `all_reduce` (float32,
int64), one `broadcast` (uint8, float32) and one `reduce_scatter_tensor`
(float32) each, whether they ran and summed right, then each payload
size of `--mb` MB of float32 all-reduced 3 times, broadcast 2 times and
reduce-scattered 3 times (the payload the input), each call timed
between device synchronisations.  On the card, then NCCL with both
ranks on cuda:0: the error it raises, or the sum it gave.  Prints one
JSON line per rank and backend: {"backend", "rank", "ops": {name: "ok"
or the error}, "sum", "reduce_scatter": the rank's block of a
reduce-scatter of [1, 2, 3, 4] + rank, "all_reduce_s": {mb: [s, ...]},
"broadcast_s", "reduce_scatter_s": {...}} or {"backend": "nccl",
"rank", "error" or "sum"}.  A process that does not
finish within `--timeout` s is killed and its line says so.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 2
# torch 2.13 renames `reduce_scatter_tensor` (the same call) and warns on
# the old name; 2.11 has only the old one
REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                         dist.reduce_scatter_tensor)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_gloo(rank: int, store: str, out: str, device: str, mbs) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    said = {"backend": "gloo", "rank": rank, "device": str(dev), "ops": {}}
    try:
        for name, dtype, call in (
                ("all_reduce_float32", torch.float32, dist.all_reduce),
                ("all_reduce_int64", torch.int64, dist.all_reduce),
                ("broadcast_uint8", torch.uint8,
                 lambda t: dist.broadcast(t, src=1)),
                ("broadcast_float32", torch.float32,
                 lambda t: dist.broadcast(t, src=0)),
                ("reduce_scatter_float32", torch.float32,
                 lambda t: REDUCE_SCATTER(
                     torch.empty(500, device=dev), t[:1000]))):
            t = torch.full((1001,), rank + 1, dtype=dtype, device=dev)
            try:
                call(t)
                _sync(dev)
                said["ops"][name] = "ok"
            except RuntimeError as err:
                said["ops"][name] = f"{type(err).__name__}: {err}"
        t = torch.full((3,), rank + 1.0, device=dev)
        dist.all_reduce(t)
        said["sum"] = t.tolist()
        t = torch.arange(1.0, 5.0, device=dev) + rank
        block = torch.empty(2, device=dev)
        REDUCE_SCATTER(block, t)
        said["reduce_scatter"] = block.tolist()
        said["all_reduce_s"], said["broadcast_s"] = {}, {}
        said["reduce_scatter_s"] = {}
        for mb in mbs:
            x = torch.ones(mb * (1 << 20) // 4, device=dev)
            half = torch.empty(x.numel() // WORLD, device=dev)
            for key, call, n in (("all_reduce_s", dist.all_reduce, 3),
                                 ("broadcast_s",
                                  lambda t: dist.broadcast(t, src=0), 2),
                                 ("reduce_scatter_s",
                                  lambda t: REDUCE_SCATTER(half, t), 3)):
                times = []
                for _ in range(n):
                    _sync(dev)
                    t0 = time.perf_counter()
                    call(x)
                    _sync(dev)
                    times.append(time.perf_counter() - t0)
                said[key][str(mb)] = times
            del x
    finally:
        with open(os.path.join(out, f"gloo{rank}.json"), "w") as f:
            json.dump(said, f)
        dist.destroy_process_group()


def probe_nccl(rank: int, store: str, out: str, device: str, mbs) -> None:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    said = {"backend": "nccl", "rank": rank, "device": str(dev)}
    try:
        dist.init_process_group("nccl", store=dist.FileStore(store, WORLD),
                                rank=rank, world_size=WORLD, device_id=dev)
        t = torch.ones(4, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize(dev)
        said["sum"] = t.tolist()
    except RuntimeError as err:           # the finding itself
        said["error"] = f"{type(err).__name__}: {err}"
    with open(os.path.join(out, f"nccl{rank}.json"), "w") as f:
        json.dump(said, f)


def run(fn, device: str, mbs, timeout: float) -> list:
    """Spawn the two ranks of `fn` (`probe_gloo` or `probe_nccl`);
    returns their lines (or a line that says a rank did not finish)."""
    with tempfile.TemporaryDirectory(prefix="rank_probe_") as d:
        ctx = mp.start_processes(fn, args=(os.path.join(d, "store"), d,
                                           device, mbs),
                                 nprocs=WORLD, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    break
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        name = "gloo" if fn is probe_gloo else "nccl"
        lines = []
        for r in range(WORLD):
            path = os.path.join(d, f"{name}{r}.json")
            lines.append(json.load(open(path)) if os.path.exists(path)
                         else {"backend": name, "rank": r,
                               "error": f"no answer within {timeout} s"})
        return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.rank_probe")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--mb", default="4,64,617",
                    help="payload sizes in MB (617: drim-bnn's gradients)")
    ap.add_argument("--timeout", type=float, default=240.0)
    args = ap.parse_args(argv)
    mbs = [int(m) for m in args.mb.split(",") if m]
    lines = run(probe_gloo, args.device, mbs, args.timeout)
    if torch.device(args.device).type == "cuda":
        lines += run(probe_nccl, args.device, mbs, args.timeout)
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
