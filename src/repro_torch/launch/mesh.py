"""LM device meshes (port of `repro.launch.mesh`): the named mesh, the
host mesh and the production mesh, and the data-parallel axes; and the
ranks a `torchrun` launch starts.

The mesh itself, its device lists and the block runner live in
`core.mesh`; this module only shapes meshes for the LM (`dp_axes` is
`core.mesh`'s).  `cli_mesh` is the serve and train CLIs' `--mesh`.  In
one process "host" is a 1 x 1 host mesh over the CLI's `--device`.
Under W ranks (`init_ranks`: torchrun's environment, or a process group
the caller initialised) it is the reference's host mesh over W devices,
`make_host_mesh(model_axis=K)`: (W / K, K) `("data", "model")`, whose
positions are the ranks (the CLIs' `--model-axis K`, default 1).  "single"
and "multi" are the production meshes, as the reference builds them;
they raise ValueError below 256 and 512 devices or ranks.  In one
process a model axis over devices of one card or the CPU is the block
runner's (`core.mesh.map_blocks`); the CLIs refuse K > 1 there, since a
model axis over ranks needs a process per position.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.mesh import Mesh, dp_axes, make_named_mesh, \
    make_rank_mesh, visible_devices

__all__ = ["make_named_mesh", "make_production_mesh", "make_host_mesh",
           "dp_axes", "cli_mesh", "init_ranks", "Ranks"]


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place among the ranks: `owned` when `init_ranks`
    initialised the process group (and `close` destroys it)."""

    rank: int
    world: int
    local_rank: int
    local_world: int
    backend: str
    device: torch.device
    owned: bool

    def device_of(self, rank: int) -> torch.device:
        """Rank `rank`'s device, by the rule `init_ranks` applies on each
        host (local rank = rank mod ranks a host)."""
        return rank_device(self.device.type, rank % self.local_world,
                           self.local_world)[1]

    def close(self) -> None:
        """Destroy the process group if `init_ranks` initialised it."""
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()


def rank_device(kind: str, local_rank: int, local_world: int):
    """(backend, device) of a rank: gloo on the CPU; on the cards NCCL
    with a card a rank where the host shows a card for each of its ranks,
    else gloo, several ranks to a card (NCCL refuses two ranks on one
    card: "Duplicate GPU detected")."""
    if kind == "cpu":
        return "gloo", torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run the ranks on the CPU")
    if n >= local_world:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % n)


def init_ranks(device: Optional[str] = None) -> Optional[Ranks]:
    """Set up the ranks, or None in a plain run (no process group and no
    torchrun environment).  `device` is the CLI's `--device` ("cpu", or
    None / "cuda" for the cards).  Reads torchrun's RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT, picks the
    backend from the devices (`rank_device`; never a retry after a
    failure), initialises the default process group and sets this rank's
    card; a process group the caller initialised is taken as it is.
    Every rank prints its first line: {"rank", "world_size", "backend",
    "device"}."""
    kind = "cpu" if device is not None and \
        torch.device(device).type == "cpu" else "cuda"
    owned = not (dist.is_available() and dist.is_initialized())
    if not owned:
        rank, world = dist.get_rank(), dist.get_world_size()
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    else:
        return None
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend, dev = rank_device(kind, local, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if owned:
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            **({"device_id": dev} if backend == "nccl" else {}))
    else:
        backend = dist.get_backend()
    print(json.dumps({"rank": rank, "world_size": world, "backend": backend,
                      "device": str(dev)}), flush=True)
    return Ranks(rank, world, local, local_world, backend, dev, owned)


def _ranked() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank_devices(kind: Optional[str] = None) -> list:
    """Each rank's device under the process group, by `rank_device`'s
    rule: on the CPU for `kind` "cpu", else (None, "cuda") on the cards,
    raising RuntimeError where none is visible, as `rank_device` does
    (pass `Ranks` to `cli_mesh` for the ranks' own choice)."""
    world = dist.get_world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return [rank_device(kind or "cuda", r % local_world, local_world)[1]
            for r in range(world)]


# The reference's production meshes: (shape, axes) by the dry-run's
# --mesh name.
PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None,
                         kind: Optional[str] = None) -> Mesh:
    """The reference's production shapes (PRODUCTION_MESHES): data x
    model 16 x 16, or pod x data x model 2 x 16 x 16.  Raises ValueError
    unless the devices (under a process group: the ranks, on the cards
    unless `kind` is "cpu") fill it, naming the count."""
    shape, axes = PRODUCTION_MESHES["multi" if multi_pod else "single"]
    if devices is None and _ranked():
        world = dist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(f"the production mesh {shape} needs "
                             f"{math.prod(shape)} devices, {world} ranks "
                             "exist")
        return make_rank_mesh(shape, axes, _rank_devices(kind))
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} devices, {len(devices)} exist")
    return make_named_mesh(shape, axes, devices)


def make_host_mesh(model_axis: int = 1,
                   devices: Optional[Sequence] = None,
                   kind: Optional[str] = None) -> Mesh:
    """Mesh over whatever devices exist (default: the visible CUDA
    devices; under a process group, the ranks, one position each, on the
    cards unless `kind` is "cpu": RuntimeError where no card is visible):
    data x model with `model_axis` devices on the model axis.  ValueError
    where `model_axis` does not divide the devices or ranks."""
    if devices is None and _ranked():
        return _rank_host_mesh(_rank_devices(kind), model_axis)
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide {n} "
                         "devices")
    return make_named_mesh((n // model_axis, model_axis), ("data", "model"),
                           devices)


def _rank_host_mesh(devs: list, model_axis: int) -> Mesh:
    n = len(devs)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide {n} "
                         "ranks")
    return make_rank_mesh((n // model_axis, model_axis), ("data", "model"),
                          devs)


def cli_mesh(kind: str, device: torch.device,
             ranks: Optional[Ranks] = None, model_axis: int = 1) -> Mesh:
    """The CLIs' `--mesh` on `device` (a resolved cpu or cuda device):
    "host", "single" or "multi", and `--model-axis`.  In one process the
    host mesh is 1 x 1 over `device` alone, also where more cards are
    visible: a mesh of distinct devices needs a process per device, and
    so does a model axis (ValueError for `model_axis` > 1).  Under
    `ranks` (or any initialised process group) it is `make_host_mesh(
    model_axis)` over the W ranks, each on its own device
    (`Ranks.device_of`)."""
    ranked = ranks is not None or _ranked()
    if kind == "host":
        if not ranked:
            if model_axis != 1:
                raise ValueError(
                    f"--model-axis {model_axis} in one process: a model "
                    "axis needs a process per position (start the ranks "
                    "with torchrun)")
            return make_host_mesh(devices=[device])
        devs = ([ranks.device_of(r) for r in range(ranks.world)]
                if ranks is not None else _rank_devices(device.type))
        return _rank_host_mesh(devs, model_axis)
    if kind in ("single", "multi"):
        if ranked:
            return make_production_mesh(multi_pod=kind == "multi",
                                        kind=device.type)
        devices = visible_devices() if device.type == "cuda" else [device]
        return make_production_mesh(multi_pod=kind == "multi",
                                    devices=devices)
    raise ValueError(f"unknown mesh {kind!r}: host, single or multi")
