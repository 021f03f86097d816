"""LM device meshes (port of `repro.launch.mesh`): the named mesh, the
host mesh and the production mesh, and the data-parallel axes.

The mesh itself, its device lists and the block runner live in
`core.mesh`; this module only shapes meshes for the LM.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from repro_torch.core.mesh import Mesh, make_named_mesh, visible_devices

__all__ = ["make_named_mesh", "make_production_mesh", "make_host_mesh",
           "dp_axes"]


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


def dp_axes(mesh: Mesh) -> tuple:
    """Axes used for data parallelism (batch sharding + grad reduce)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
