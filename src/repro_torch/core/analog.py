"""Table 3 of the paper (port of the table in `repro.core.analog`).

The reference's analog model (the charge-sharing sense amplifier and its
`jax.random` Monte-Carlo over process variation) is a later slice of the
port; for now this module holds only the paper's own table, which
`FaultModel.from_corner(source="paper")` reads.

PAPER_TABLE3[variation] = {"TRA": %, "DRA": %}: the share of triple-row
and dual-row activations that latch a wrong bit at a +-variation corner.
"""
from __future__ import annotations

PAPER_TABLE3 = {
    0.05: {"TRA": 0.00, "DRA": 0.00},
    0.10: {"TRA": 0.18, "DRA": 0.00},
    0.15: {"TRA": 5.5, "DRA": 1.2},
    0.20: {"TRA": 17.1, "DRA": 9.6},
    0.30: {"TRA": 28.4, "DRA": 16.4},
}
