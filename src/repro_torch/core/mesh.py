"""Device meshes over explicit torch device lists, and the block runner
every sharded path shares.

A `Mesh` is a small frozen value: axis names and an object array of
`torch.device`s in the mesh's shape.  It is one process, not a process
group (no `torch.distributed.DeviceMesh`, which needs a process per
device): the reference shards its fleet with `shard_map` and no
collectives, so the port runs each block of a sharded tensor on its mesh
device in turn (`map_blocks`) and concatenates the results in order.

A device list may repeat one device (`[torch.device("cpu")] * 8`,
`[torch.device("cuda", 0)] * 8`): that is a real 2x4 or 1x8 split of the
work on one card or on the CPU, the port's counterpart of the reference's
`--xla_force_host_platform_device_count=8`.  Over `[torch.device("meta")]
* n` (`abstract_mesh`) it is the counterpart of
`jax.sharding.AbstractMesh`: specs for the (16, 16) and (2, 16, 16)
production shapes, computed with no device behind them.

`with mesh:` installs the mesh as the ambient one (`ambient_mesh()`, the
reference's `with mesh:`); nesting restores the outer mesh on exit.

This module sits below `core.device` and imports nothing of the port;
`launch.mesh` adds the LM meshes and `pim.mesh` the fleet mesh.  Defined
as functions, so importing it touches no device.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """Which mesh axis shards each dim (None: replicated), printed as the
    reference's `jax.sharding.PartitionSpec`.  An entry may name several
    axes (a tuple); as in jax, a one-axis tuple is stored as that axis and
    an empty one as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


def _entry(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


# the meshes entered with `with mesh:`, innermost last
_AMBIENT: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_ambient_mesh", default=())


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names over an object array of `torch.device`s."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self) -> None:
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} cannot "
                             f"take axes {self.axis_names}")
        self.devices.setflags(write=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (the reference's `mesh.shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"

    def __enter__(self) -> "Mesh":
        _AMBIENT.set(_AMBIENT.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.set(_AMBIENT.get()[:-1])


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `with mesh:` block, or None."""
    stack = _AMBIENT.get()
    return stack[-1] if stack else None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh: where each block of a leaf lives (the
    reference's `jax.sharding.NamedSharding`)."""

    mesh: Mesh
    spec: PartitionSpec


def axis_size(mesh: Mesh, entry) -> int:
    """Devices along a spec entry: 1 for None, the product of the named
    axes' sizes otherwise; ValueError for an axis the mesh lacks."""
    if entry is None:
        return 1
    n = 1
    for axis in ((entry,) if isinstance(entry, str) else entry):
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
        n *= mesh.shape[axis]
    return n


def fits(mesh: Mesh, entry, dim: int) -> bool:
    """Whether a spec entry's devices cut `dim` into equal, non-empty
    blocks (None always fits): the one divisibility rule of the specs."""
    n = axis_size(mesh, entry)
    return entry is None or (dim % n == 0 and dim >= n)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes used for data parallelism (batch sharding + grad reduce)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def visible_devices() -> list:
    """Every visible CUDA device (the default device list); raises without
    one, as the port's entry points do: pass devices for the CPU."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(e.g. [torch.device('cpu')] * 8) for the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_named_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                    devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over an explicit device list (default: every visible CUDA
    device, which must fill the shape exactly, as `jax.make_mesh` asks).

    The one mesh constructor everything shares; a longer list gives its
    prefix, as the fleet mesh needs when the fleet geometry cannot use
    every device."""
    n = math.prod(shape)
    if devices is None:
        devices = visible_devices()
        if len(devices) != n:
            raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                             f"{len(devices)} are visible")
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"got {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names))


def abstract_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...]
                  ) -> Mesh:
    """A mesh of the given shape over meta devices: for computing specs of
    shapes no machine here has (the reference's `AbstractMesh`)."""
    return make_named_mesh(shape, axis_names,
                           [torch.device("meta")] * math.prod(shape))


def sanitize_spec(spec: PartitionSpec, shape, mesh: Mesh) -> PartitionSpec:
    """Drop named axes that do not evenly divide their dim (the
    reference's `runtime.sharding.sanitize_spec`)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = [entry if fits(mesh, entry, dim) else None
           for entry, dim in zip(parts, shape)]
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def check_spec(spec: PartitionSpec, shape, mesh: Mesh) -> PartitionSpec:
    """Refuse a placement the mesh cannot hold without padding: every
    named axis must divide its dim exactly (`sanitize_spec`'s rule, which
    drops such an axis; a changed spec raises)."""
    want = list(spec)
    while want and want[-1] is None:
        want.pop()
    if len(spec) > len(shape) \
            or list(sanitize_spec(spec, shape, mesh)) != want:
        raise ValueError(
            f"mesh {dict(mesh.shape)} does not divide array shape "
            f"{tuple(shape)} under spec {spec}")
    return spec


def map_blocks(mesh: Mesh, fn: Callable, tensors: Sequence[torch.Tensor],
               spec: PartitionSpec):
    """Run `fn` on every mesh block of `tensors` and reassemble.

    Every tensor is laid out by `spec`, which names each mesh axis on one
    dim; that dim is cut into as many equal blocks as the axis has devices
    (`check_spec`'s rule: a mesh that does not divide it raises).
    `fn(*blocks)` runs once per mesh position on that position's device,
    with no communication, and returns a tensor or a tuple of tensors cut
    the same way.  The results are concatenated in mesh order on the first
    tensor's device: the unsharded run's layout, bit for bit, when `fn`
    treats every position alike."""
    grid = mesh.devices.shape
    dims = tuple(spec.index(axis) for axis in mesh.axis_names)
    for t in tensors:
        check_spec(spec, t.shape, mesh)
    home = tensors[0].device
    results = {}
    for pos in np.ndindex(*grid):
        blocks = []
        for t in tensors:
            idx = [slice(None)] * t.dim()
            for d, n, i in zip(dims, grid, pos):
                w = t.shape[d] // n
                idx[d] = slice(i * w, (i + 1) * w)
            blocks.append(t[tuple(idx)].to(mesh.devices[pos]))
        out = fn(*blocks)
        results[pos] = tuple(o.to(home) for o in out) \
            if isinstance(out, tuple) else out.to(home)

    def join(pick, prefix: Tuple[int, ...]) -> torch.Tensor:
        axis = len(prefix)
        if axis == len(grid):
            return pick(results[prefix])
        return torch.cat([join(pick, prefix + (i,))
                          for i in range(grid[axis])], dim=dims[axis])

    first = results[(0,) * len(grid)]
    if isinstance(first, tuple):
        return tuple(join(lambda o, j=j: o[j], ())
                     for j in range(len(first)))
    return join(lambda o: o, ())
