"""Fleet mesh: lay the simulated DRIM slot axis over devices (port of
`repro.pim.mesh`).

Every (chip, bank, subarray) slot runs the same program over its own rows,
with no cross-slot communication, so the leading [chips, banks] dims are
the natural cut for sharded simulation of DRIM-S-scale fleets: each mesh
device simulates its own block of banks, bit-identical to the unsharded
path.

Mesh layout (axes named by `core.device.MESH_AXES`):

            banks ->
    chips   +--------+--------+
      |     | dev 0  | dev 1  |     each device holds
      v     +--------+--------+     [chips/mc, banks/mb, subarrays,
            | dev 2  | dev 3  |      rows, words] of the fleet state
            +--------+--------+

`fleet_mesh` picks the largest (mc, mb) with mc | chips, mb | banks and
mc*mb <= available devices, preferring to split banks (the axis DRIM-S
scales: 256 banks x 152 sub-arrays).  Without a device list it takes every
visible CUDA device (one card: a 1x1 mesh, the unsharded path); a list may
repeat one device, so `[torch.device("cpu")] * 8` runs a real 2x4 split
on the CPU.

A sharded run (`core.mesh.map_blocks`) cuts [chips, banks] into the
mesh's mc x mb blocks, runs each on its mesh device and concatenates the
results in order.  `shard_staged` and `shard_device` only check that the
mesh divides the array (`_check_spec`, the reference's exact-divisibility
rule and `ValueError`, the one check `map_blocks` also applies): the
blocks are cut when the run dispatches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import MESH_AXES, DrimDevice
from repro_torch.core.timing import DrimGeometry
from repro_torch.core.mesh import (Mesh, PartitionSpec as P,
                                   check_spec as _check_spec,
                                   make_named_mesh, visible_devices)

AXIS_CHIPS, AXIS_BANKS = MESH_AXES

# Device state [chips, banks, subarrays, rows, words]: shard the two
# leading dims.  Staged wave payloads [waves, n_rows, chips, banks,
# subarrays, row_words] carry the same split two axes later.
DEVICE_SPEC = P(AXIS_CHIPS, AXIS_BANKS)
STAGED_SPEC = P(None, None, AXIS_CHIPS, AXIS_BANKS)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def fleet_shape(geom: DrimGeometry, n_devices: int) -> Tuple[int, int]:
    """Largest (mc, mb) with mc | chips, mb | banks, mc*mb <= n_devices.

    Ties prefer the banks axis (mb), matching how DRIM-S scales out."""
    best = (1, 1)
    for mc in _divisors(geom.chips):
        for mb in _divisors(geom.banks):
            if mc * mb > n_devices:
                continue
            if (mc * mb, mb) > (best[0] * best[1], best[1]):
                best = (mc, mb)
    return best


def fleet_mesh(geom: DrimGeometry, *,
               devices: Optional[Sequence] = None) -> Mesh:
    """A (chips, banks) mesh for this geometry over `devices` (default:
    every visible CUDA device).  One device gives the 1x1 mesh, over which
    a sharded run is the plain path bit for bit."""
    if devices is None:
        devices = visible_devices()
    mc, mb = fleet_shape(geom, len(devices))
    return make_named_mesh((mc, mb), MESH_AXES, list(devices))


def shard_staged(staged: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Check a staged wave payload is shard-aligned on the fleet mesh;
    returns it as it is (a sharded run cuts its blocks at dispatch)."""
    _check_spec(STAGED_SPEC, staged.shape, mesh)
    return staged


def shard_device(dev: DrimDevice, mesh: Mesh) -> DrimDevice:
    """Check a DrimDevice's state is shard-aligned on the fleet mesh;
    returns it as it is."""
    _check_spec(DEVICE_SPEC, dev.data.shape, mesh)
    return dev
