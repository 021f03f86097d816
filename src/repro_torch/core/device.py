"""Bank/chip-level DRIM device model: a [chips, banks, subarrays] stack
(port of `repro.core.device`).

The paper's throughput comes from inter-subarray parallelism: every
computational sub-array of every bank (and every chip) executes the same
AAP sequence in lock-step over different rows.  `DrimDevice` holds the
whole stack's state as one batched tensor pair, and program execution is
one `isa.run_program` over it: the slot dimensions ride along as leading
batch dimensions, as the reference's `jax.vmap` over the slot axis.

Addressing follows `subarray.py`: word-lines [0, n_rows) are data rows
plus x1..x8, [n_rows, n_rows + 4) the four DCC word-lines.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import resolve_device

from .faults import slot_ids_grid
from .isa import run_program
from .mesh import PartitionSpec, map_blocks
from .subarray import N_XROWS, SubArray, as_words, make_subarray, row_words
from .timing import DrimGeometry

# Mesh axis names the fleet is laid out over (`pim/mesh.py` builds meshes
# with these axes; `device_run_program_sharded` and the scheduler's
# sharded wave runs cut the leading device dims on them).
MESH_AXES = ("chips", "banks")


@dataclasses.dataclass(frozen=True)
class DrimDevice:
    """Batched state of every computational sub-array in the device.

    data: [chips, banks, subarrays, n_rows, words] int32
    dcc:  [chips, banks, subarrays, 2, words]      int32
    """

    data: torch.Tensor
    dcc: torch.Tensor

    # -- geometry ----------------------------------------------------------
    @property
    def chips(self) -> int:
        return self.data.shape[0]

    @property
    def banks(self) -> int:
        return self.data.shape[1]

    @property
    def subarrays(self) -> int:
        return self.data.shape[2]

    @property
    def n_slots(self) -> int:
        """Total (chip, bank, subarray) slots = SIMD width in rows."""
        return self.chips * self.banks * self.subarrays

    @property
    def n_rows(self) -> int:
        return self.data.shape[3]

    @property
    def words(self) -> int:
        return self.data.shape[4]

    @property
    def row_bits(self) -> int:
        return self.words * 32

    # -- word-line aliases (same layout in every slot) ---------------------
    def wl_x(self, k: int) -> int:
        return self.n_rows - N_XROWS + (k - 1)

    def wl_dcc(self, k: int) -> int:
        return self.n_rows + (k - 1)

    def slot(self, chip: int, bank: int, sub: int) -> SubArray:
        """View one slot as a plain SubArray (for single-lane debugging)."""
        return SubArray(data=self.data[chip, bank, sub],
                        dcc=self.dcc[chip, bank, sub])


def make_device(geom: Optional[DrimGeometry] = None, *,
                chips: int = 2, banks: int = 4, subarrays: int = 8,
                n_data: int = 16, row_bits: int = 256,
                device=None) -> DrimDevice:
    """Fresh all-zero device on `device` (None: the CUDA card).  `geom`
    overrides chips/banks/subarrays and row_bits; `n_data` stays a knob
    so callers can keep the per-slot row count small."""
    dev = resolve_device(device)
    if geom is not None:
        chips, banks, subarrays = (geom.chips, geom.banks,
                                   geom.subarrays_per_bank)
        row_bits = geom.row_bits
    w = row_words(row_bits)
    lead = (chips, banks, subarrays)
    return DrimDevice(
        data=torch.zeros(lead + (n_data + N_XROWS, w), dtype=torch.int32,
                         device=dev),
        dcc=torch.zeros(lead + (2, w), dtype=torch.int32, device=dev))


def device_template(dev: DrimDevice) -> SubArray:
    """Zero SubArray with this device's per-slot shape, to resolve x/dcc
    word-line aliases when building microprograms."""
    return make_subarray(n_data=dev.n_rows - N_XROWS, row_bits=dev.row_bits)


def device_load_rows(dev: DrimDevice, start: int, rows) -> DrimDevice:
    """Load per-slot row blocks: rows [chips, banks, subarrays, k, words]
    are written to word-lines [start, start+k) of every slot of a copy of
    `dev` (the DDR write path, not an AAP)."""
    rows = as_words(rows, dev.data.device)
    data = dev.data.clone()
    data[:, :, :, start:start + rows.shape[3]] = rows
    return dataclasses.replace(dev, data=data)


def device_broadcast_rows(dev: DrimDevice, start: int, rows) -> DrimDevice:
    """Write the same [k, words] block into every slot at `start`."""
    rows = as_words(rows, dev.data.device)
    return device_load_rows(dev, start,
                            rows.expand(dev.data.shape[:3] + rows.shape))


def device_read_row(dev: DrimDevice, wl: int) -> torch.Tensor:
    """Read word-line `wl` of every slot -> [chips, banks, subarrays, words]."""
    return dev.data[:, :, :, wl, :]


def device_read_rows(dev: DrimDevice, wls) -> torch.Tensor:
    """Gather word-lines (in any order) from every slot -> [len(wls),
    chips, banks, subarrays, words]: the row axis leads, the order in
    which results go back to the host."""
    idx = torch.as_tensor(list(wls), dtype=torch.int64,
                          device=dev.data.device)
    return dev.data[:, :, :, idx, :].movedim(3, 0)


def device_read_row_window(dev: DrimDevice, start: int, k: int) -> torch.Tensor:
    """Read the contiguous word-lines [start, start+k) of every slot ->
    [k, chips, banks, subarrays, words] (the DDR read path)."""
    return device_read_rows(dev, range(start, start + k))


def _device_run_program(dev: DrimDevice, encoded, faults=None,
                        bank_lo: int = 0,
                        banks_total: Optional[int] = None,
                        donate: bool = False) -> DrimDevice:
    sa = SubArray(data=dev.data, dcc=dev.dcc)
    if faults is not None:
        faults = faults.wave_model()
    sids = None
    if faults is not None:
        # Global slot ids so a bank slice draws the same flips as the
        # full-fleet dispatch of the identical program.
        sids = slot_ids_grid(dev.chips, dev.banks, dev.subarrays,
                             bank_lo=bank_lo, banks_total=banks_total,
                             device=dev.data.device)
    out = run_program(sa, encoded, faults=faults, slot_id=sids,
                      copy=not donate)
    return DrimDevice(data=out.data, dcc=out.dcc)


def device_run_program(dev: DrimDevice, encoded, *, donate: bool = False,
                       faults=None) -> DrimDevice:
    """Execute one encoded [n, 5] AAP stream on EVERY slot at once, the
    SIMD lock-step of paper §3.4.

    donate=True runs in place on `dev`'s tensors (the input then holds
    the output state); the default copies the state once, so callers can
    compare pre/post states.

    faults: optional `core.faults.FaultModel` -- seed-deterministic bit
    flips on DRA/TRA results; an inactive model is the fault-free path.
    """
    return _device_run_program(dev, encoded, faults, donate=donate)


def device_run_program_banked(dev: DrimDevice, encoded_by_block,
                              bank_blocks, *, faults=None) -> DrimDevice:
    """MIMD over the bank axis: a DIFFERENT encoded stream per bank block.

    bank_blocks: (lo, hi) pairs partitioning [0, banks) into contiguous
    blocks; block i runs `encoded_by_block[i]` on its [chips, hi-lo,
    subarrays] slice through the same interpreter as `device_run_program`,
    anchored at its physical banks (`bank_lo`, `banks_total`) so its flips
    are the full fleet's.  This is the full-state reference the per-bank
    queue engine (`pim/queue.py`) is held to: each block has its own
    program counter."""
    if len(encoded_by_block) != len(bank_blocks):
        raise ValueError("one encoded stream per bank block required")
    cover = [b for lo, hi in bank_blocks for b in range(lo, hi)]
    if cover != list(range(dev.banks)):
        raise ValueError(f"bank blocks {list(bank_blocks)} do not "
                         f"partition [0, {dev.banks})")
    datas, dccs = [], []
    for (lo, hi), enc in zip(bank_blocks, encoded_by_block):
        block = DrimDevice(data=dev.data[:, lo:hi], dcc=dev.dcc[:, lo:hi])
        out = _device_run_program(block, enc, faults, bank_lo=lo,
                                  banks_total=dev.banks)
        datas.append(out.data)
        dccs.append(out.dcc)
    return DrimDevice(data=torch.cat(datas, dim=1),
                      dcc=torch.cat(dccs, dim=1))


def device_run_program_sharded(dev: DrimDevice, encoded, mesh, *,
                               faults=None) -> DrimDevice:
    """`device_run_program` over a (chips, banks) device mesh.

    Every sub-array runs the same stream over its own rows, so the leading
    [chips, banks] dims split across `mesh` with no communication: each
    mesh device runs the interpreter on its block, and the blocks are
    concatenated in order (`core.mesh.map_blocks`).  The mesh's shape
    must divide (chips, banks); `pim.mesh.fleet_mesh` builds exactly that.
    Bit-identical to `device_run_program` either way."""
    if faults is not None and faults.active:
        raise ValueError(
            "fault injection is not supported on the shard_map path: "
            "global slot ids are not visible inside a mesh shard, so "
            "flips could not stay identical to the vmap engines; run "
            "faulted programs with mesh=None")

    def block(data, dcc):
        out = _device_run_program(DrimDevice(data=data, dcc=dcc), encoded)
        return out.data, out.dcc

    data, dcc = map_blocks(mesh, block, (dev.data, dev.dcc),
                           PartitionSpec(*MESH_AXES))
    return DrimDevice(data=data, dcc=dcc)
