"""Device meshes over explicit torch device lists, and the block runner
every sharded path shares.

A `Mesh` is a small frozen value: axis names and an object array of
`torch.device`s in the mesh's shape.  A mesh of devices is one process
(no `torch.distributed.DeviceMesh`): the reference shards its fleet with
`shard_map` and no collectives, so the port runs each block of a sharded
tensor on its mesh device in turn (`map_blocks`) and concatenates the
results in order.

A device list may repeat one device (`[torch.device("cpu")] * 8`,
`[torch.device("cuda", 0)] * 8`): that is a real 2x4 or 1x8 split of the
work on one card or on the CPU, the port's counterpart of the reference's
`--xla_force_host_platform_device_count=8`.  Over `[torch.device("meta")]
* n` (`abstract_mesh`) it is the counterpart of
`jax.sharding.AbstractMesh`: specs for the (16, 16) and (2, 16, 16)
production shapes, computed with no device behind them.

`with mesh:` installs the mesh as the ambient one (`ambient_mesh()`, the
reference's `with mesh:`); nesting restores the outer mesh on exit.

A mesh of ranks (`make_rank_mesh`, under an initialised
`torch.distributed` process group) is the other kind: its positions are
processes, `ranks` holds the global rank at each, and each process holds
only its own block of a leaf cut by a `PartitionSpec` (`local_block`,
GSPMD's contiguous blocks).  Its collectives are `mesh_sum` (a sum over
an axis's ranks) and `mesh_gather` (cut blocks put back together by a
broadcast from each block's owner), written over `dist.all_reduce` and
`dist.broadcast` alone: gloo takes CUDA tensors for both (torch 2.11), so
one code path serves gloo on the CPU, gloo with several ranks on one
card, and NCCL with a card a rank.  `COLLECTIVE_STATS` counts their
calls, bytes and seconds.

This module sits below `core.device` and imports nothing of the port;
`launch.mesh` adds the LM meshes and `pim.mesh` the fleet mesh.  Defined
as functions, so importing it touches no device.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


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
    """Axis names over an object array of `torch.device`s; a mesh of
    ranks also holds the global rank at each position (`ranks`, an int
    array of the same shape; None: one process runs every position)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    ranks: Optional[np.ndarray] = None

    def __post_init__(self) -> None:
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} cannot "
                             f"take axes {self.axis_names}")
        self.devices.setflags(write=False)
        if self.ranks is not None:
            if self.ranks.shape != self.devices.shape:
                raise ValueError(f"ranks {self.ranks.shape} for a mesh of "
                                 f"shape {self.devices.shape}")
            self.ranks.setflags(write=False)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (the reference's `mesh.shape`)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def rank(self) -> int:
        """This process's rank (a mesh of ranks only)."""
        if self.ranks is None:
            raise ValueError("a mesh of devices has no ranks")
        return dist.get_rank()

    def coords(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The mesh position of `rank` (default: this process's)."""
        rank = self.rank if rank is None else rank
        at = np.argwhere(self.ranks == rank)
        if len(at) != 1:
            raise ValueError(f"rank {rank} is not in {self}")
        return tuple(int(i) for i in at[0])

    @property
    def device(self) -> torch.device:
        """This process's device (a mesh of ranks only)."""
        return self.devices[self.coords()]

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(self.devices.flat),
                None if self.ranks is None else tuple(self.ranks.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        ranks = "" if self.ranks is None else \
            f", ranks={self.ranks.flat[:].tolist()}"
        return f"Mesh({self.shape}, devices={list(self.devices.flat)}{ranks})"

    def __enter__(self) -> "Mesh":
        _AMBIENT.set(_AMBIENT.get() + (self,))
        return self

    def __exit__(self, *exc) -> None:
        _AMBIENT.set(_AMBIENT.get()[:-1])


def ambient_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `with mesh:` block, or None."""
    stack = _AMBIENT.get()
    return stack[-1] if stack else None


def ambient_ranks() -> Optional[Mesh]:
    """The ambient mesh when it is a mesh of ranks, else None: the model
    code's test for taking its share of a global-batch statistic."""
    mesh = ambient_mesh()
    return mesh if mesh is not None and mesh.ranks is not None else None


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


# --- meshes of ranks ----------------------------------------------------------

# calls, payload bytes and wall seconds of the rank collectives below
# (each call timed from its inputs' readiness to its result's: the card
# is synchronised on either side)
COLLECTIVE_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def make_rank_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                   devices: Sequence) -> Mesh:
    """A mesh whose positions are the ranks of the initialised default
    process group, in rank order; `devices[r]` is rank r's device.
    Raises ValueError without a process group or when the shape does not
    hold exactly the group's ranks."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh of ranks needs an initialised process "
                         "group (start the ranks with torchrun)")
    world = dist.get_world_size()
    if math.prod(shape) != world or len(devices) != world:
        raise ValueError(f"mesh shape {tuple(shape)} over {world} ranks "
                         f"({len(devices)} devices)")
    mesh = make_named_mesh(shape, axis_names, devices)
    return dataclasses.replace(
        mesh, ranks=np.arange(world, dtype=np.int64).reshape(tuple(shape)))


def _block_of(mesh: Mesh, entry, coords: Tuple[int, ...]) -> Tuple[int, int]:
    """(block index, block count) of a spec entry at mesh `coords`: the
    named axes' coordinates in order, the first the most significant."""
    if entry is None:
        return 0, 1
    index, count = 0, 1
    for axis in ((entry,) if isinstance(entry, str) else entry):
        size = mesh.shape[axis]
        index = index * size + coords[mesh.axis_names.index(axis)]
        count *= size
    return index, count


def local_block(shape, spec: PartitionSpec, mesh: Mesh,
                rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The slices of a leaf of `shape` that `rank` (default: this
    process) holds under `spec`: along each named dim, the rank's block of
    dim / devices contiguous elements (`check_spec`'s rule: a mesh that
    does not divide the dim raises)."""
    check_spec(spec, shape, mesh)
    coords = mesh.coords(rank)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for entry, dim in zip(parts, shape):
        index, count = _block_of(mesh, entry, coords)
        width = dim // count
        out.append(slice(index * width, (index + 1) * width))
    return tuple(out)


def local_shape(shape, spec: PartitionSpec, mesh: Mesh,
                rank: Optional[int] = None) -> Tuple[int, ...]:
    """The shape of `local_block`."""
    return tuple(s.stop - s.start for s in local_block(shape, spec, mesh,
                                                       rank))


def _axis_group(mesh: Mesh, axes: Tuple[str, ...]):
    """(process group, size) of the ranks that share this rank's
    coordinates off `axes`; a group of one rank is (None, 1).  A group
    of some but not all ranks (a `model` axis over ranks beside the data
    axes) waits for ROADMAP Queue 1 item 15.2."""
    coords = mesh.coords()
    keep = tuple(slice(None) if a in axes else coords[i]
                 for i, a in enumerate(mesh.axis_names))
    members = mesh.ranks[keep].size
    if members == 1:
        return None, 1
    if members == mesh.ranks.size:
        return dist.group.WORLD, members
    raise ValueError(f"a collective over {axes} of {mesh.shape} spans some "
                     "of the ranks: a model axis over ranks is ROADMAP "
                     "Queue 1 item 15.2")


def _timed(fn, t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    COLLECTIVE_STATS["calls"] += 1
    COLLECTIVE_STATS["bytes"] += t.numel() * t.element_size()
    COLLECTIVE_STATS["seconds"] += time.perf_counter() - t0


def mesh_sum(tensors: Sequence[torch.Tensor], mesh: Mesh,
             axes: Optional[Tuple[str, ...]] = None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks along `axes` (default: the data
    axes), as new tensors; the inputs are not changed.  The tensors of
    one dtype travel as one flat buffer (one `all_reduce` a dtype).
    Where the axes hold one rank the tensors come back as they are."""
    axes = dp_axes(mesh) if axes is None else tuple(axes)
    group, n = _axis_group(mesh, axes)
    if n == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _timed(lambda: dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                                       group=group), flat)
        offset = 0
        for i in idx:
            n_el = tensors[i].numel()
            out[i] = flat[offset:offset + n_el].view(tensors[i].shape)
            offset += n_el
    return out


def mesh_gather(blocks: Sequence[torch.Tensor], shapes, specs, mesh: Mesh
                ) -> List[torch.Tensor]:
    """The whole leaves from this rank's blocks (`local_block` of each
    `shapes[i]` under `specs[i]`).  Each distinct block is broadcast from
    its owner, the lowest rank that holds it, bit for bit (no sum: a zero
    filled all-reduce would turn -0.0 into +0.0); an owner's blocks of
    every leaf travel as one byte buffer, so a gather is one `broadcast`
    per owning rank.  A leaf whose spec cuts it into one block (replicated,
    or named axes of one rank) comes back as it is."""
    me = mesh.rank
    world = mesh.ranks.size
    device = blocks[0].device if blocks else mesh.device
    out: List[Optional[torch.Tensor]] = [None] * len(blocks)
    sends: Dict[int, List[Tuple[int, Tuple[slice, ...]]]] = {}
    for i, (blk, shape, spec) in enumerate(zip(blocks, shapes, specs)):
        shape = tuple(shape)
        if all(axis_size(mesh, e) == 1 for e in spec):
            out[i] = blk            # every rank holds the whole leaf
            continue
        out[i] = torch.empty(shape, dtype=blk.dtype, device=device)
        owned = set()
        for r in range(world):
            sl = local_block(shape, spec, mesh, r)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in owned:
                owned.add(key)
                sends.setdefault(r, []).append((i, sl))
    for r in sorted(sends):
        items = sends[r]
        sizes = [math.prod(s.stop - s.start for s in sl)
                 * blocks[i].element_size() for i, sl in items]
        if r == me:
            buf = torch.cat([blocks[i].contiguous().reshape(-1)
                             .view(torch.uint8) for i, _ in items])
        else:
            buf = torch.empty(sum(sizes), dtype=torch.uint8, device=device)
        if world > 1:
            _timed(lambda: dist.broadcast(buf, src=int(r)), buf)
        offset = 0
        for (i, sl), size in zip(items, sizes):
            block_shape = tuple(s.stop - s.start for s in sl)
            out[i][sl] = buf[offset:offset + size].view(out[i].dtype) \
                .view(block_shape)
            offset += size
    return out


def mesh_barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh.ranks.size > 1:
        t = torch.zeros(1, device=mesh.device)
        _timed(lambda: dist.all_reduce(t), t)
