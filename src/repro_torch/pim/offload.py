"""The "gpu" comparator's cost (port of the comparator side of
`repro.pim.offload`).

The comparator evaluates a lowered program with the native bulk bit-wise
kernels and prices it with a roofline of the card: the boundary planes
(every loaded input and every read-back output, `n_bits` bits each) over
device memory, and one bit-op per node per bit over the integer rate.
The constants are those of an NVIDIA H100 SXM 80GB HBM3 at its 700 W
limit, from NVIDIA's data sheet:

  * HBM3 bandwidth 3.35e12 B/s;
  * bit-ops at 32 per int32 operation, the int32 rate being 64 lanes per
    SM against the 128 behind the 67 TFLOP/s float32 peak (which counts an
    FMA as two): 67e12 / 4 * 32 = 5.36e14 bit-ops/s.

Energy is the card's 700 W limit over the latency: an upper bound, since
the data sheet gives no energy per HBM3 byte.

The placement `Verdict` and `build_verdict` (pricing the DRIM-queued row
with `pim.queue.QueueSchedule`) come with ROADMAP Queue 1 item 10.
`VerdictRow` is here already, so that the comparator row has the shape
every contender's row will share.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.pim.scheduler import OP_ARITY, RESULT_ROWS

GPU_NAME = "NVIDIA H100 80GB HBM3, 700 W"
GPU_HBM_BW = 3.35e12                  # bytes/s
GPU_BITOPS = 67e12 / 4 * 32           # bit-ops/s: int32 rate x 32 bits
GPU_POWER_W = 700.0


@dataclasses.dataclass(frozen=True)
class VerdictRow:
    """One contender, priced with the same fields as every other."""

    contender: str          # "DRIM-fused" | "DRIM-queued" | ... | "GPU"
    latency_s: float        # end-to-end (compute and DMA composed per
                            # the contender's own overlap model)
    compute_s: float
    dma_s: float            # boundary traffic
    energy_j: float
    aaps: int               # serialized AAP cycles (0 for the GPU)
    ddr_rows_moved: int


@dataclasses.dataclass(frozen=True)
class GpuCost:
    """Roofline cost of the "gpu" comparator engine: boundary planes over
    HBM, a bit-op floor at the int32 rate, energy at the power limit."""

    n_bits: int
    boundary_bytes: float
    compute_s: float
    dma_s: float
    energy_j: float

    @property
    def latency_s(self) -> float:
        return max(self.compute_s, self.dma_s)


def _gpu_row(n_io_planes: int, n_node_bitops: int,
             n_bits: int) -> VerdictRow:
    """The GPU contender's row."""
    boundary = n_io_planes * n_bits / 8.0
    compute = n_node_bitops * n_bits / GPU_BITOPS
    dma = boundary / GPU_HBM_BW
    latency = max(compute, dma)
    return VerdictRow(
        contender="GPU", latency_s=latency, compute_s=compute, dma_s=dma,
        energy_j=latency * GPU_POWER_W, aaps=0, ddr_rows_moved=0)


def _boundary_planes(lowered) -> Tuple[int, int]:
    """(io planes, node bit-ops) of a lowering, for the GPU row."""
    if lowered.kind == "op":
        return OP_ARITY[lowered.op] + len(RESULT_ROWS[lowered.op]), 1
    fp = lowered.fp
    return len(fp.loaded_inputs) + len(fp.readback_rows), fp.n_nodes


def gpu_cost(lowered, n_bits: int) -> GpuCost:
    """Closed-form cost of the "gpu" engine for `Lowered.cost()`."""
    n_io, n_ops = _boundary_planes(lowered)
    row = _gpu_row(n_io, n_ops, n_bits)
    return GpuCost(n_bits=n_bits, boundary_bytes=n_io * n_bits / 8.0,
                   compute_s=row.compute_s, dma_s=row.dma_s,
                   energy_j=row.energy_j)
