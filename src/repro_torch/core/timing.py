"""DRAM geometry and timing for DRIM (port of `repro.core.timing`).

Every sub-array of every bank computes one row-wide bulk op per AAP
sequence in lock-step; `subarrays_per_bank` is the one free parameter
(1024 reproduces the paper's Fig. 8 ratios).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .isa import AAP_COUNTS

T_AAP_S = 90e-9  # seconds per AAP (ACT-ACT-PRE envelope)

# The per-channel command bus issues one command per slot at the
# DDR4-2400 command clock (1200 MHz); an AAP takes 3 of the ~108 slots
# its 90 ns envelope spans.
T_CMD_S = 1.0 / 1.2e9
CMD_SLOTS_PER_AAP = round(T_AAP_S / T_CMD_S)          # = 108

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


def drim_throughput_bits(geom: DrimGeometry, op: str) -> float:
    """Output bits per second of a bulk bit-wise op on DRIM: every
    sub-array computes one row per `AAP_COUNTS[op]` AAPs, all in
    lock-step (the paper's Fig. 8 model)."""
    return geom.parallel_bits / (AAP_COUNTS[op] * geom.t_aap_s)


def drim_latency_s(geom: DrimGeometry, op: str, n_bits: int) -> float:
    """Seconds to process an `n_bits` bulk operand vector."""
    waves = -(-n_bits // geom.parallel_bits)  # ceil
    return waves * AAP_COUNTS[op] * geom.t_aap_s


# Area model (paper §3.4): reported, not simulated.
def area_report() -> Dict[str, str]:
    return {
        "sa_addon_transistors_per_BL": "22",
        "dcc_rows": "2 rows (4 word-lines), ~1T/BL each",
        "modified_row_decoder": "4:12 MRD, +2T per WL driver buffer chain",
        "ctrl_mux_transistors": "6",
        "equivalent_rows_per_subarray": "24",
        "dram_chip_area_overhead": "~9.3%",
    }
