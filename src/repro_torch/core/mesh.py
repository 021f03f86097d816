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
GSPMD's contiguous blocks).  Its collectives run over the ranks that
share this rank's coordinates off some axes (`_axis_group`: one
`dist.new_group` per distinct group of each axis set, all made once per
mesh by every rank in one order): `mesh_sum` and `mesh_max` (all-reduces),
`mesh_all_gather` (blocks concatenated along a dim in mesh order),
`mesh_reduce_scatter` (a sum of which each rank keeps its block along a
dim), `mesh_gather` (cut blocks put back together by a broadcast from
each block's owner) and `mesh_exchange` (the same between a rank's block
and a run of the flattened leaf).  They are written over `dist.all_reduce`,
`dist.all_gather`, `dist.reduce_scatter_tensor` and `dist.broadcast`,
which gloo takes for CUDA tensors too, so one code path serves gloo on
the CPU, gloo with several ranks on one card, and NCCL with a card a
rank.  `COLLECTIVE_STATS` counts their calls, bytes and seconds, in all,
by axis ("calls:data", "bytes:model", ...) and by kind
("calls/reduce-scatter", ...); inside a `record_collectives()` block each
call is also listed with its kind, group size, payload and axes (the
dry-run's per-rank trace, `launch.dryrun.rank_trace`).

Megatron's four operators for a `model` axis over ranks (the ambient
mesh's, `model_ranks`) are autograd functions: `copy_to_model` (forward
the identity, backward the sum over the model group), `reduce_from_model`
(forward the sum, backward the identity), `gather_from_model` (forward an
all-gather along a dim, backward the rank's slice) and `vocab_lookup`
(the rows of a vocabulary-cut table, zero outside the rank's range,
summed over the model group).  Two more serve the Mamba2 mixer:
`scatter_to_model` (forward the rank's block along a dim, backward the
all-gather: the input of a row-parallel product that every rank computes
whole) and, for a sequence cut over the model group, `gather_sequence`
(forward an all-gather along a dim, backward the gradients summed over
the group and the rank's block kept, since each rank uses the others'
blocks differently) and `sequence_halo` (the previous rank's last
frames of a causal convolution, zeros on the first rank).

Megatron's sequence-parallel pair serves a residual cut over the
sequence (the reference's `seq_parallel`): `gather_from_sequence`
(forward an all-gather of the rank's block, backward the gradient
reduce-scattered in float32: the input of column-parallel products, each
rank's gradient a partial) and `reduce_scatter_to_sequence` (forward
float32 partials reduce-scattered and rounded once, backward the
all-gather: the exit of a row-parallel product).  `sequence_cut(mesh)`
marks the code that holds such a block (`sequence_ranks`), so the
row-parallel products inside it end in the reduce-scatter.

This module sits below `core.device` and imports nothing of the port;
`launch.mesh` adds the LM meshes and `pim.mesh` the fleet mesh.  Defined
as functions, so importing it touches no device.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import itertools
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

# calls, payload bytes and wall seconds of the rank collectives below, in
# all, by the axes they ran over ("calls:data", "bytes:model", ...;
# "data+model" where a call spans both) and by kind ("calls/all-reduce",
# "bytes/reduce-scatter", ...); each call timed from its inputs'
# readiness to its result's: the card is synchronised on either side
COLLECTIVE_STATS = {f"{k}{axes}": 0.0 if k == "seconds" else 0
                    for k in ("calls", "bytes", "seconds")
                    for axes in ("", ":data", ":model", ":data+model")}

# {(default group, mesh shape, axis names): {(axes, members): group}}:
# the sub-groups of each mesh of ranks, made once
_GROUPS: Dict[tuple, Dict[tuple, object]] = {}

# the lists of the open `record_collectives` blocks (module-wide, not per
# thread: a backward may run on the autograd engine's thread)
_RECORDS: List[list] = []


@contextlib.contextmanager
def record_collectives():
    """Yields a list that gets one dict per rank collective run inside
    the block, in order: {"kind": "all-reduce", "all-gather",
    "reduce-scatter" or "broadcast", "n": the group's ranks,
    "payload_b": the bytes `COLLECTIVE_STATS` counts (an
    all-reduce's buffer, an all-gather's input, a reduce-scatter's input,
    a broadcast's buffer), "axes": the axes' label ("model", "pod+data",
    ...)}."""
    calls: list = []
    _RECORDS.append(calls)
    try:
        yield calls
    finally:
        _RECORDS.remove(calls)


def forget_groups() -> None:
    """Drop the sub-groups made for every mesh of ranks: call it when the
    default group they belong to is destroyed, since a new default group
    may reuse its id (`_group_key`) and would be handed dead sub-groups."""
    _GROUPS.clear()


def make_rank_mesh(shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                   devices: Sequence) -> Mesh:
    """A mesh whose positions are the ranks of the initialised default
    process group, in rank order; `devices[r]` is rank r's device.
    Raises ValueError without a process group or when the shape does not
    hold exactly the group's ranks.  Every rank must call it, in the same
    order as the others: the first call for a shape makes the process
    groups of its axis sets (`dist.new_group` is collective)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("a mesh of ranks needs an initialised process "
                         "group (start the ranks with torchrun)")
    world = dist.get_world_size()
    if math.prod(shape) != world or len(devices) != world:
        raise ValueError(f"mesh shape {tuple(shape)} over {world} ranks "
                         f"({len(devices)} devices)")
    mesh = make_named_mesh(shape, axis_names, devices)
    mesh = dataclasses.replace(
        mesh, ranks=np.arange(world, dtype=np.int64).reshape(tuple(shape)))
    _make_groups(mesh)
    return mesh


def _group_key(mesh: Mesh) -> tuple:
    return (id(dist.distributed_c10d._get_default_group()),
            mesh.devices.shape, mesh.axis_names)


def _members(mesh: Mesh, axes: Tuple[str, ...],
             coords: Tuple[int, ...]) -> Tuple[int, ...]:
    """The global ranks sharing `coords` off `axes`, ascending (the mesh
    order of their blocks)."""
    keep = tuple(slice(None) if a in axes else coords[i]
                 for i, a in enumerate(mesh.axis_names))
    return tuple(int(r) for r in np.sort(mesh.ranks[keep].reshape(-1)))


def _make_groups(mesh: Mesh) -> None:
    """One process group per distinct group of ranks of every axis set
    that spans some but not all ranks, made by every rank in one order."""
    key = _group_key(mesh)
    if key in _GROUPS:
        return
    groups = {}
    names = mesh.axis_names
    world = mesh.ranks.size
    for n in range(1, len(names)):
        for subset in itertools.combinations(names, n):
            for pos in np.ndindex(*mesh.devices.shape):
                members = _members(mesh, subset, pos)
                if 1 < len(members) < world \
                        and (subset, members) not in groups:
                    groups[(subset, members)] = dist.new_group(
                        list(members))
    _GROUPS[key] = groups


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


def drop_axes(spec: PartitionSpec, axes: Tuple[str, ...]) -> PartitionSpec:
    """`spec` with the named `axes` taken out of every entry: the spec of
    the block a gather over `axes` rebuilds."""
    def keep(entry):
        if entry is None:
            return None
        return tuple(a for a in ((entry,) if isinstance(entry, str)
                                 else entry) if a not in axes)
    return PartitionSpec(*(keep(e) for e in spec))


def sub_block(shape, spec: PartitionSpec, within: PartitionSpec,
              mesh: Mesh, rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The slices of this rank's block under `spec` inside its block under
    `within` (a coarser cut of the same leaf of `shape`, e.g. a ZeRO-1
    moment's spec inside its param's); ValueError where it is not inside."""
    inner = local_block(shape, spec, mesh, rank)
    outer = local_block(shape, within, mesh, rank)
    if any(i.start < o.start or i.stop > o.stop
           for i, o in zip(inner, outer)):
        raise ValueError(f"{spec} is not a cut of {within}")
    return tuple(slice(i.start - o.start, i.stop - o.start)
                 for i, o in zip(inner, outer))


def _axis_group(mesh: Mesh, axes: Tuple[str, ...]):
    """(process group, size) of the ranks that share this rank's
    coordinates off `axes`; a group of one rank is (None, 1), of every
    rank the default group."""
    members = _members(mesh, axes, mesh.coords())
    if len(members) == 1:
        return None, 1
    if len(members) == mesh.ranks.size:
        return dist.group.WORLD, len(members)
    _make_groups(mesh)
    return _GROUPS[_group_key(mesh)][(tuple(a for a in mesh.axis_names
                                            if a in axes), members)], \
        len(members)


def _label(mesh: Mesh, axes: Tuple[str, ...]) -> str:
    return "+".join(a for a in mesh.axis_names
                    if a in axes and mesh.shape[a] > 1)


def _timed(fn, t: torch.Tensor, label: str, kind: str, n: int) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    for suffix in ("", f"/{kind}") + ((f":{label}",) if label else ()):
        COLLECTIVE_STATS[f"calls{suffix}"] = \
            COLLECTIVE_STATS.get(f"calls{suffix}", 0) + 1
        COLLECTIVE_STATS[f"bytes{suffix}"] = \
            COLLECTIVE_STATS.get(f"bytes{suffix}", 0) \
            + t.numel() * t.element_size()
        COLLECTIVE_STATS[f"seconds{suffix}"] = \
            COLLECTIVE_STATS.get(f"seconds{suffix}", 0.0) + dt
    for calls in _RECORDS:
        calls.append({"kind": kind, "n": n,
                      "payload_b": t.numel() * t.element_size(),
                      "axes": label})


def _all_reduce(tensors: Sequence[torch.Tensor], mesh: Mesh,
                axes: Tuple[str, ...], op) -> List[torch.Tensor]:
    group, n = _axis_group(mesh, axes)
    if n == 1:
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _timed(lambda: dist.all_reduce(flat, op=op, group=group), flat,
               _label(mesh, axes), "all-reduce", n)
        offset = 0
        for i in idx:
            n_el = tensors[i].numel()
            out[i] = flat[offset:offset + n_el].view(tensors[i].shape)
            offset += n_el
    return out


def mesh_sum(tensors: Sequence[torch.Tensor], mesh: Mesh,
             axes: Optional[Tuple[str, ...]] = None) -> List[torch.Tensor]:
    """Each tensor summed over the ranks along `axes` (default: the data
    axes), as new tensors; the inputs are not changed.  The tensors of
    one dtype travel as one flat buffer (one `all_reduce` a dtype).
    Where the axes hold one rank the tensors come back as they are."""
    axes = dp_axes(mesh) if axes is None else tuple(axes)
    return _all_reduce(tensors, mesh, axes, dist.ReduceOp.SUM)


def mesh_max(tensors: Sequence[torch.Tensor], mesh: Mesh,
             axes: Tuple[str, ...] = ("model",)) -> List[torch.Tensor]:
    """`mesh_sum` with the elementwise maximum (default over "model")."""
    return _all_reduce(tensors, mesh, tuple(axes), dist.ReduceOp.MAX)


def mesh_all_gather(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...],
                    dim: int) -> torch.Tensor:
    """Every rank's `t` along `axes` concatenated along `dim` in mesh
    order (one `all_gather`); `t` itself where the axes hold one rank.
    The ranks' tensors must have one shape."""
    group, n = _axis_group(mesh, tuple(axes))
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _timed(lambda: dist.all_gather(parts, t, group=group), t,
           _label(mesh, tuple(axes)), "all-gather", n)
    return torch.cat(parts, dim)


def mesh_reduce_scatter(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...],
                        dim: int) -> torch.Tensor:
    """`t` summed over the ranks along `axes`, of which this rank keeps
    its block along `dim` (the group's equal blocks in mesh order): one
    `reduce_scatter_tensor` of `t` with `dim` moved to the front; `t`
    itself where the axes hold one rank.  The ranks' tensors must have one
    shape, and the group must divide `dim`."""
    group, n = _axis_group(mesh, tuple(axes))
    if n == 1:
        return t
    dim %= t.dim()
    if t.shape[dim] % n:
        raise ValueError(f"a reduce-scatter over {n} ranks cannot cut a dim "
                         f"of {t.shape[dim]}")
    front = t.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // n, *front.shape[1:]),
                      dtype=t.dtype, device=t.device)
    # torch 2.13 renames `reduce_scatter_tensor` (the same call) and
    # warns on the old name, the card's 2.11 has only the old one
    call = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)
    _timed(lambda: call(out, front, group=group), front,
           _label(mesh, tuple(axes)), "reduce-scatter", n)
    return out.movedim(0, dim)


def mesh_gather(blocks: Sequence[torch.Tensor], shapes, specs, mesh: Mesh,
                axes: Optional[Tuple[str, ...]] = None
                ) -> List[torch.Tensor]:
    """The leaves rebuilt over `axes` (default: every axis, so the whole
    leaves) from this rank's blocks (`local_block` of each `shapes[i]`
    under `specs[i]`): each comes back as its block under the spec with
    `axes` taken out (`drop_axes`), so a gather over "data" alone keeps
    the model cut.  Each distinct block is broadcast within the group
    over `axes` from its owner, the lowest rank that holds it, bit for
    bit (no sum: a zero filled all-reduce would turn -0.0 into +0.0); an
    owner's blocks of every leaf travel as one byte buffer, so a gather is
    one `broadcast` per owning rank (`mesh_exchange` between the blocks).
    A leaf whose block is already the rebuilt one comes back as it is."""
    axes = tuple(mesh.axis_names) if axes is None else tuple(axes)
    out = list(blocks)
    idx = [i for i, (shape, spec) in enumerate(zip(shapes, specs))
           if local_block(tuple(shape), spec, mesh)
           != local_block(tuple(shape), drop_axes(spec, axes), mesh)]

    def box(shape, spec):
        return functools.partial(block_region, tuple(shape), spec, mesh)
    got = mesh_exchange(
        [blocks[i] for i in idx], [shapes[i] for i in idx],
        [box(shapes[i], specs[i]) for i in idx],
        [box(shapes[i], drop_axes(specs[i], axes)) for i in idx],
        [axes] * len(idx), mesh)
    for i, t in zip(idx, got):
        out[i] = t
    return out


# A region of a leaf: ("box", ((start, stop), ...)), a block whose tensor
# is the block, or ("run", (start, stop)), a run of the row-major
# flattened leaf whose tensor is 1-D.
Region = Tuple[str, tuple]


def run_boxes(shape, start: int, stop: int) -> List[tuple]:
    """The boxes ((start, stop) a dim) whose elements are the run [start,
    stop) of the row-major flattened leaf of `shape`, in order: at most
    2 len(shape) - 1, each a contiguous part of the run."""
    shape = tuple(shape)
    if start >= stop:
        return []
    if len(shape) == 1:
        return [((start, stop),)]
    inner = math.prod(shape[1:])
    a, ra = divmod(start, inner)
    b, rb = divmod(stop, inner)
    if a == b:
        return [((a, a + 1),) + box for box in run_boxes(shape[1:], ra, rb)]
    out = []
    if ra:
        out += [((a, a + 1),) + box
                for box in run_boxes(shape[1:], ra, inner)]
        a += 1
    if b > a:
        out.append(((a, b),) + tuple((0, d) for d in shape[1:]))
    if rb:
        out += [((b, b + 1),) + box for box in run_boxes(shape[1:], 0, rb)]
    return out


def _parts(region: Region, shape) -> List[Tuple[tuple, Optional[int]]]:
    """[(box, offset)]: the boxes that make up `region`, each with its
    offset in the run's tensor (None for a box, whose tensor is itself)."""
    kind, at = region
    if kind == "box":
        return [(at, None)]
    out, offset = [], 0
    for box in run_boxes(shape, *at):
        out.append((box, offset))
        offset += math.prod(e - s for s, e in box)
    return out


def block_region(shape, spec: PartitionSpec, mesh: Mesh,
                 rank: Optional[int] = None) -> Region:
    """`rank`'s block under `spec` (`local_block`) as a region."""
    return "box", tuple((s.start, s.stop)
                        for s in local_block(shape, spec, mesh, rank))


def _region_shape(region: Region) -> Tuple[int, ...]:
    kind, at = region
    if kind == "box":
        return tuple(e - s for s, e in at)
    return (max(at[1] - at[0], 0),)


def _in_part(t: torch.Tensor, box: tuple, offset: Optional[int]
             ) -> torch.Tensor:
    """The view of a region's tensor `t` that holds its part `box`."""
    if offset is None:
        return t
    n = math.prod(e - s for s, e in box)
    return t[offset:offset + n].view(tuple(e - s for s, e in box))


def mesh_exchange(tensors: Sequence[torch.Tensor], shapes,
                  have: Sequence[Callable[[int], Region]],
                  want: Sequence[Callable[[int], Region]],
                  axes: Sequence[Tuple[str, ...]], mesh: Mesh
                  ) -> List[torch.Tensor]:
    """Leaf i's region `want[i](this rank)` of a whole leaf of `shapes[i]`,
    put together from the regions `have[i](r)` that the ranks r of this
    rank's group along `axes[i]` hold, this rank's in `tensors[i]`: the
    general `mesh_gather`, between a rank's block and a run of the
    flattened leaf either way.  Each owner (the lowest rank of the group
    that holds a region) broadcasts its region's overlaps with each
    distinct region the group wants, bit for bit: one `broadcast` an
    owner and axis set, its leaves in one byte buffer.  ValueError where
    the group does not hold every element this rank wants."""
    me = mesh.rank
    out = [torch.empty(_region_shape(w(me)), dtype=t.dtype, device=t.device)
           for t, w in zip(tensors, want)]

    def read(it):
        # a piece (leaf, kept, box, its have part, offset, want part,
        # offset) out of this rank's tensor
        i, _, box, hb, ho, _, _ = it
        return _in_part(tensors[i], hb, ho)[tuple(
            slice(s - o, e - o) for (s, e), (o, _) in zip(box, hb))]

    def write(it, value):
        i, _, box, _, _, wb, wo = it
        _in_part(out[i], wb, wo)[tuple(
            slice(s - o, e - o) for (s, e), (o, _) in zip(box, wb))] = value
    at: Dict[tuple, List[int]] = {}
    for i, a in enumerate(axes):
        at.setdefault(tuple(a), []).append(i)
    for group_axes, idx in at.items():
        group, n = _axis_group(mesh, group_axes)
        members = _members(mesh, group_axes, mesh.coords())
        sends: Dict[int, list] = {}
        for i in idx:
            shape, mine = tuple(shapes[i]), want[i](me)
            wanted = list(dict.fromkeys(want[i](q) for q in members))
            held, covered = set(), 0
            for r in members:
                h = have[i](r)
                if h in held:
                    continue
                held.add(h)
                for w in wanted:
                    for hb, ho in _parts(h, shape):
                        for wb, wo in _parts(w, shape):
                            box = tuple((max(a0, b0), min(a1, b1)) for
                                        (a0, a1), (b0, b1) in zip(hb, wb))
                            if all(s < e for s, e in box):
                                sends.setdefault(r, []).append(
                                    (i, w == mine, box, hb, ho, wb, wo))
                                if w == mine:
                                    covered += math.prod(e - s
                                                         for s, e in box)
            if covered != math.prod(_region_shape(mine)):
                raise ValueError(f"the ranks along {group_axes} hold "
                                 f"{covered} of the {mine} elements this "
                                 "rank wants")
        for r in sorted(sends):
            # the widest dtypes first, so that each piece's view of the
            # byte buffer is aligned to its element
            items = sorted(sends[r],
                           key=lambda it: -tensors[it[0]].element_size())
            if n == 1:
                for it in items:
                    write(it, read(it))
                continue
            sizes = [math.prod(e - s for s, e in it[2])
                     * tensors[it[0]].element_size() for it in items]
            if r == me:
                buf = torch.cat([read(it).contiguous().reshape(-1)
                                 .view(torch.uint8) for it in items])
            else:
                buf = torch.empty(sum(sizes), dtype=torch.uint8,
                                  device=out[items[0][0]].device)
            _timed(lambda: dist.broadcast(buf, src=int(r), group=group),
                   buf, _label(mesh, group_axes), "broadcast", n)
            offset = 0
            for it, size in zip(items, sizes):
                if it[1]:
                    write(it, buf[offset:offset + size]
                          .view(tensors[it[0]].dtype)
                          .view(tuple(e - s for s, e in it[2])))
                offset += size
    return out


def mesh_barrier(mesh: Mesh) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh.ranks.size > 1:
        t = torch.zeros(1, device=mesh.device)
        _timed(lambda: dist.all_reduce(t), t,
               _label(mesh, mesh.axis_names), "all-reduce", mesh.ranks.size)


# --- the model axis: Megatron's operators ------------------------------------

def model_ranks() -> Optional[Mesh]:
    """The ambient mesh of ranks when its `model` axis holds more than one
    rank (the model code's switch for its cut params), else None."""
    mesh = ambient_ranks()
    if mesh is None or mesh.shape.get("model", 1) == 1:
        return None
    return mesh


def model_coord(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's index along "model", the axis's size)."""
    return (mesh.coords()[mesh.axis_names.index("model")],
            mesh.shape["model"])


def _model_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`t` summed over the model group in float32, in `t`'s dtype."""
    return mesh_sum([t.to(torch.float32).contiguous()], mesh,
                    ("model",))[0].to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _model_sum(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh_sum([x.contiguous()], mesh, ("model",))[0]

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return mesh_all_gather(x, mesh, ("model",), dim)

    @staticmethod
    def backward(ctx, grad):
        index, _ = model_coord(ctx.mesh)
        return grad.narrow(ctx.dim, index * ctx.width, ctx.width), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The identity; its gradient is summed over the model group (in
    float32): the input of a column-parallel product, or a whole weight
    that each rank uses its own part of."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` summed over the model group (the partials of a row-parallel
    product); its gradient passes unchanged."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model group's blocks of `x` concatenated along `dim` in mesh
    order; the gradient keeps the rank's own block."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def vocab_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int,
                 mesh: Mesh, seq_dim: Optional[int] = None) -> torch.Tensor:
    """Rows `tokens` of a table cut over its vocabulary: this rank holds
    rows [lo, lo + len(table)); a token outside them gives zeros, and the
    ranks' rows are summed over the model group (one rank holds each
    token's row, so the sum is that row).  With `seq_dim` the sum is
    reduce-scattered along it: the rank's block of the sequence."""
    local = tokens.long() - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    rows = rows.to(torch.float32) * inside[..., None].to(torch.float32)
    if seq_dim is not None:
        return reduce_scatter_to_sequence(rows, mesh, seq_dim, table.dtype)
    return reduce_from_model(rows, mesh).to(table.dtype)


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        index, m = model_coord(mesh)
        ctx.mesh, ctx.dim = mesh, dim
        width = x.shape[dim] // m
        return x.narrow(dim, index * width, width).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return mesh_all_gather(grad, ctx.mesh, ("model",), ctx.dim), None, \
            None


class _GatherSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.width = mesh, dim, x.shape[dim]
        return mesh_all_gather(x, mesh, ("model",), dim)

    @staticmethod
    def backward(ctx, grad):
        index, _ = model_coord(ctx.mesh)
        whole = mesh_sum([grad.contiguous()], ctx.mesh, ("model",))[0]
        return whole.narrow(ctx.dim, index * ctx.width, ctx.width), None, \
            None


class _SequenceHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tail, mesh):
        index, m = model_coord(mesh)
        ctx.mesh, ctx.frames = mesh, tail.shape[1]
        tails = mesh_all_gather(tail, mesh, ("model",), 1)
        k = tail.shape[1]
        halo = (torch.zeros_like(tail) if index == 0
                else tails[:, (index - 1) * k:index * k].contiguous())
        last = tails[:, (m - 1) * k:].contiguous()
        ctx.mark_non_differentiable(last)
        return halo, last

    @staticmethod
    def backward(ctx, grad, _grad_last):
        index, m = model_coord(ctx.mesh)
        k = ctx.frames
        grads = mesh_all_gather(grad.contiguous(), ctx.mesh, ("model",), 1)
        if index == m - 1:
            return torch.zeros_like(grad), None
        return grads[:, (index + 1) * k:(index + 2) * k], None


def scatter_to_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block of `x` along `dim` (|model| equal blocks in mesh
    order); the gradient is the group's blocks all-gathered, so a whole
    `x` that every rank computes alike gets the whole gradient on every
    rank (the input of a row-parallel product)."""
    return _ScatterToModel.apply(x, mesh, dim % x.dim())


def gather_sequence(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The model group's blocks of `x` concatenated along `dim` in mesh
    order, for ranks that each use the whole differently (a sequence cut
    over the group): the gradient is the ranks' gradients summed over the
    group, of which the rank keeps its own block."""
    return _GatherSequence.apply(x, mesh, dim % x.dim())


def sequence_halo(tail: torch.Tensor, mesh: Mesh
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the previous model rank's `tail` [B, K-1, C], zeros on the first
    rank; the last rank's, with no gradient) in one all-gather: the halo
    of a causal convolution over a sequence cut over the model group, and
    its last frames.  The halo's gradient goes back to the rank it came
    from."""
    return _SequenceHalo.apply(tail, mesh)


# --- the sequence-parallel residual: Megatron's pair -------------------------

# the mesh of ranks whose model group cuts the residual over the sequence
# in the code running now (`sequence_cut`), or None
_SEQUENCE: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_sequence_cut", default=None)


@contextlib.contextmanager
def sequence_cut(mesh: Optional[Mesh]):
    """Inside the block, the residual is this rank's block of a sequence
    cut over `mesh`'s model group (None: whole), which `sequence_ranks`
    tells the row-parallel products.  A block function enters it itself,
    so remat's recompute, which runs the function again on the autograd
    engine's thread, is inside it too."""
    token = _SEQUENCE.set(mesh)
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


def sequence_ranks() -> Optional[Mesh]:
    """The mesh of the innermost `sequence_cut`, or None."""
    return _SEQUENCE.get()


class _GatherFromSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh_all_gather(x, mesh, ("model",), dim)

    @staticmethod
    def backward(ctx, grad):
        part = grad.to(torch.float32)
        return mesh_reduce_scatter(part, ctx.mesh, ("model",), ctx.dim) \
            .to(grad.dtype), None, None


class _ReduceScatterToSequence(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, mesh, dim, dtype):
        ctx.mesh, ctx.dim, ctx.dtype = mesh, dim, part.dtype
        return mesh_reduce_scatter(part.to(torch.float32), mesh,
                                   ("model",), dim).to(dtype)

    @staticmethod
    def backward(ctx, grad):
        return mesh_all_gather(grad, ctx.mesh, ("model",), ctx.dim) \
            .to(ctx.dtype), None, None, None


def gather_from_sequence(x: torch.Tensor, mesh: Mesh, dim: int
                         ) -> torch.Tensor:
    """The model group's blocks of a sequence-cut `x` concatenated along
    `dim` in mesh order (one all-gather, in x's dtype); the gradient, a
    partial on each rank (the whole sequence's input of column-parallel
    products), is reduce-scattered over the group in float32, of which
    the rank keeps its block, rounded once to the gradient's dtype."""
    return _GatherFromSequence.apply(x, mesh, dim % x.dim())


def reduce_scatter_to_sequence(part: torch.Tensor, mesh: Mesh, dim: int,
                               dtype: Optional[torch.dtype] = None
                               ) -> torch.Tensor:
    """The ranks' partials `part` (a row-parallel product's, over the
    whole sequence) summed over the model group in float32, of which the
    rank keeps its block along `dim`, rounded once to `dtype` (default:
    part's); the gradient, the block's, is all-gathered over the group.
    At two ranks the block is the all-reduce's, bit for bit."""
    return _ReduceScatterToSequence.apply(
        part, mesh, dim % part.dim(), part.dtype if dtype is None else dtype)
