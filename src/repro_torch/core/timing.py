"""DRAM geometry and timing for DRIM (port of `repro.core.timing`).

Every sub-array of every bank computes one row-wide bulk op per AAP
sequence in lock-step; `subarrays_per_bank` is the one free parameter
(1024 reproduces the paper's Fig. 8 ratios).
"""
from __future__ import annotations

import dataclasses

T_AAP_S = 90e-9  # seconds per AAP (ACT-ACT-PRE envelope)

# Host DMA bandwidth in and out of the DIMM: x64 DDR4-2400 peak.
DDR4_BW_BYTES_S = 19.2e9


def ddr_rows_s(rows: int, row_bits: int) -> float:
    """Seconds to move `rows` row-wide payloads over the host DDR bus."""
    return rows * (row_bits / 8.0) / DDR4_BW_BYTES_S


@dataclasses.dataclass(frozen=True)
class DrimGeometry:
    banks: int = 8
    subarrays_per_bank: int = 1024
    row_bits: int = 256          # 512 rows x 256 bit-lines (paper §3.4)
    t_aap_s: float = T_AAP_S
    chips: int = 1               # rank/DIMM scale-out; all chips lock-step

    @property
    def n_subarrays(self) -> int:
        """Concurrently computing sub-arrays across the whole device."""
        return self.chips * self.banks * self.subarrays_per_bank

    @property
    def parallel_bits(self) -> int:
        return self.n_subarrays * self.row_bits


# DRIM-R: regular DDR4-class chip.  DRIM-S: 3D-stacked, 256 banks, of
# which ~15% of the sub-arrays compute concurrently (thermal envelope).
DRIM_R = DrimGeometry(banks=8)
DRIM_S = DrimGeometry(banks=256, subarrays_per_bank=152)
