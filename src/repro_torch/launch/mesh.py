"""LM device meshes (port of `repro.launch.mesh`): the named mesh, the
host mesh and the production mesh, and the data-parallel axes.

The mesh itself, its device lists and the block runner live in
`core.mesh`; this module only shapes meshes for the LM (`dp_axes` is
`core.mesh`'s).  `cli_mesh` is the serve and train CLIs' `--mesh`:
"host" a 1 x 1 host mesh over the CLI's `--device`, "single" and "multi"
the production meshes, as the reference builds them; those raise
ValueError below 256 and 512 devices.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core.mesh import Mesh, dp_axes, make_named_mesh, \
    visible_devices

__all__ = ["make_named_mesh", "make_production_mesh", "make_host_mesh",
           "dp_axes", "cli_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The reference's production shapes: data x model 16 x 16, or pod x
    data x model 2 x 16 x 16.  Raises ValueError with fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devices = visible_devices() if devices is None else list(devices)
    if len(devices) < math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} devices, {len(devices)} exist")
    return make_named_mesh(shape, axes, devices)


def make_host_mesh(model_axis: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over whatever devices exist (default: the visible CUDA
    devices): data x model with `model_axis` devices on the model axis."""
    devices = visible_devices() if devices is None else list(devices)
    n = len(devices)
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide {n} "
                         "devices")
    return make_named_mesh((n // model_axis, model_axis), ("data", "model"),
                           devices)


def cli_mesh(kind: str, device: torch.device) -> Mesh:
    """The CLIs' `--mesh` on `device` (a resolved cpu or cuda device):
    "host", "single" or "multi".  The host mesh is 1 x 1 over `device`
    alone, also where more cards are visible: an LM mesh of distinct
    devices needs a process per device (ROADMAP Queue 1 item 15)."""
    if kind == "host":
        return make_host_mesh(devices=[device])
    if kind in ("single", "multi"):
        devices = visible_devices() if device.type == "cuda" else [device]
        return make_production_mesh(multi_pod=kind == "multi",
                                    devices=devices)
    raise ValueError(f"unknown mesh {kind!r}: host, single or multi")
