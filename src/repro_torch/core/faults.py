"""Table-3 fault injection: seed-deterministic bit flips on AAP results
(port of `repro.core.faults`).

The paper's Table 3 reports the share of erroneous operations under
process variation: at the +-15% corner about 1.2% of DRAs and 5.5% of
TRAs latch the wrong value.  `FaultModel` carries those per-op failure
probabilities into execution: a failing DRA/TRA instance flips ONE bit of
the charge-shared bit-line value before the destructive write-back, so
every word-line the AAP touches sees the same wrong level.

Whether an op instance fails, and which bit it corrupts, is a pure
counter-based hash of (seed, op index, slot), where `slot` is the global
sub-array coordinate `(chip * banks + bank) * subarrays + subarray`.  No
generator state is threaded anywhere, so every engine (resident, baseline,
the CUDA interpreter) draws the identical flip for the same op on the same
sub-array, the reference's engines included.

The hash is uint32 arithmetic.  torch has no usable uint32, and on int32
bit patterns the unsigned compare, the unsigned modulus and the wrapping
multiply all go wrong without an error, so every value here is an int64
holding the unsigned 32-bit number, products are taken in 16-bit halves
so they never leave int64, and only the final flip mask is narrowed to an
int32 bit pattern.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["FaultModel", "fault_mask", "mix32", "slot_ids_grid"]

_U32 = 1 << 32
_MASK = _U32 - 1
# Distinct stream constants for the fail draw vs the bit-position draw.
_GOLDEN = 0x9E3779B9
_POS_SALT = 0x85EBCA6B


def as_u32(x, device=None) -> torch.Tensor:
    """A Python int, numpy array or tensor of 32-bit words -> an int64
    tensor holding their unsigned values (int32 patterns are read as
    uint32)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.uint32:
            x = x.view(torch.int32)
        return (x.to(device=device, dtype=torch.int64)) & _MASK
    if isinstance(x, (int, np.integer)):
        return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)
    a = np.asarray(x)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"expected integer words, got {a.dtype}")
    return torch.from_numpy(a.astype(np.int64) & _MASK).to(device)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a constant c, exactly:
    each 16-bit half of c keeps its partial product below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def mix32(x) -> torch.Tensor:
    """Murmur3-style 32-bit finalizer; int64 in [0, 2**32) out."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def slot_ids_grid(chips: int, banks_local: int, subarrays: int, *,
                  bank_lo: int = 0, banks_total: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """Global slot ids, [chips, banks_local, subarrays] int64 (unsigned
    32-bit values).

    `bank_lo`/`banks_total` anchor a bank slice at its physical position
    so the slice draws the same flips as the full-fleet dispatch."""
    bt = banks_local if banks_total is None else banks_total
    c = torch.arange(chips, dtype=torch.int64, device=device)[:, None, None]
    b = torch.arange(banks_local, dtype=torch.int64,
                     device=device)[None, :, None]
    s = torch.arange(subarrays, dtype=torch.int64, device=device)[None, None]
    return ((c * bt + bank_lo + b) * subarrays + s) & _MASK


def fault_mask(thresh, op_index, slot_hash, word_ids,
               n_positions: int) -> torch.Tensor:
    """int32 flip mask for one AAP: one flipped bit per failing slot.

    thresh: failure threshold (`p * 2**32`), a Python int or a tensor.
    op_index: instruction counter, a Python int or a tensor.
    slot_hash: `mix32(slot_id ^ seed)`, broadcastable with `word_ids`.
    word_ids: word index within the row.
    n_positions: row width in bits, the bit-position modulus.

    The first draw decides failure (hash < thresh, unsigned); the second
    picks the corrupted bit.  Returns a mask shaped like
    `broadcast(slot_hash, word_ids)`, zero everywhere but the single
    (word, bit) of each failing slot.
    """
    slot_hash = as_u32(slot_hash)
    dev = slot_hash.device
    if isinstance(op_index, torch.Tensor):
        op = _mul32(as_u32(op_index, dev), _GOLDEN)
    else:
        op = (int(op_index) * _GOLDEN) & _MASK
    x = mix32(slot_hash ^ op)
    fail = x < (as_u32(thresh, dev) if isinstance(thresh, torch.Tensor)
                else int(thresh) & _MASK)
    pos = mix32(x ^ _POS_SALT) % n_positions
    hit = fail & ((pos >> 5) == as_u32(word_ids, dev))
    mask = torch.where(hit, torch.ones_like(pos) << (pos & 31),
                       torch.zeros_like(pos))
    return torch.where(mask >= 1 << 31, mask - _U32, mask).to(torch.int32)


def _thresh(p: float) -> int:
    """Failure probability -> uint32 comparison threshold."""
    return min(int(round(p * _U32)), _U32 - 1)


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Process-variation fault model for the simulated DRIM fleet.

    p_dra / p_tra: probability that a DRA / TRA instance latches one
        wrong bit (Table-3 "% erroneous operations" as a fraction).
    seed: stream seed for the counter-based flip hash.
    stuck_rows: ((word_line, bit), ...) -- rows forced to all-0/all-1
        after every AAP (stuck-at cells).  Word-lines beyond a program's
        template are inert for that program.
    dead_queues: ((queue, stage), ...) -- command queues killed at a
        fence stage of a partitioned graph; a bare queue id means dead
        from stage 0.  Carried for the queued engine of a later slice;
        a wave body never sees it.
    protected_ops: op indices executed on guard-banded sense amps
        (hardening voters / parity reducers) -- never flip.
    """
    p_dra: float = 0.0
    p_tra: float = 0.0
    seed: int = 0
    stuck_rows: Tuple[Tuple[int, int], ...] = ()
    dead_queues: Tuple[Tuple[int, int], ...] = ()
    protected_ops: Tuple[int, ...] = ()

    def __post_init__(self):
        for name in ("p_dra", "p_tra"):
            p = getattr(self, name)
            if not 0.0 <= p < 1.0:
                raise ValueError(f"{name}={p} outside [0, 1)")
        object.__setattr__(self, "stuck_rows",
                           tuple((int(r), int(v))
                                 for r, v in self.stuck_rows))
        for _, v in self.stuck_rows:
            if v not in (0, 1):
                raise ValueError("stuck_rows bit values must be 0 or 1")
        norm = []
        for entry in self.dead_queues:
            q, s = entry if isinstance(entry, (tuple, list)) else (entry, 0)
            norm.append((int(q), int(s)))
        object.__setattr__(self, "dead_queues", tuple(norm))
        object.__setattr__(self, "protected_ops",
                           tuple(sorted({int(i)
                                         for i in self.protected_ops})))

    @classmethod
    def from_corner(cls, variation: float = 0.15, *, seed: int = 0,
                    source: str = "sim", trials: int = 10_000,
                    mc_seed: int = 0, device=None, **kw) -> "FaultModel":
        """Build a model from a process-variation corner.

        source="sim" runs `analog.monte_carlo_error_rates` for the corner
        (calibrated simulator rates; `device` as there, None = the card);
        source="paper" reads the corner straight out of
        `analog.PAPER_TABLE3` (no Monte-Carlo)."""
        from .analog import PAPER_TABLE3, monte_carlo_error_rates
        if source == "paper":
            try:
                rates = PAPER_TABLE3[variation]
            except KeyError:
                raise ValueError(
                    f"variation {variation} not a Table-3 corner; "
                    f"choose from {sorted(PAPER_TABLE3)}") from None
        elif source == "sim":
            rates = monte_carlo_error_rates(
                trials=trials, variations=(variation,), seed=mc_seed,
                device=device)[variation]
        else:
            raise ValueError(f"unknown source {source!r} "
                             "(expected 'sim' or 'paper')")
        return cls(p_dra=rates["DRA"] / 100.0, p_tra=rates["TRA"] / 100.0,
                   seed=seed, **kw)

    # -- activity predicates ------------------------------------------------
    @property
    def flips_active(self) -> bool:
        """True when the wave interpreters have any work to do."""
        return bool(self.p_dra or self.p_tra or self.stuck_rows)

    @property
    def active(self) -> bool:
        return self.flips_active or bool(self.dead_queues)

    # -- derived constants --------------------------------------------------
    @property
    def dra_thresh(self) -> int:
        return _thresh(self.p_dra)

    @property
    def tra_thresh(self) -> int:
        return _thresh(self.p_tra)

    # -- observability ------------------------------------------------------
    def count_faultable(self, program) -> dict:
        """Host-side census of the armed fault sites in an AAP program:
        how many DRA / TRA instances can draw flips under this model
        (zero-probability op kinds and `protected_ops` indices do not
        count)."""
        from .isa import OP_DRA, OP_TRA
        prot = set(self.protected_ops)
        dra = tra = 0
        for i, ins in enumerate(program):
            if i in prot:
                continue
            if ins.op == OP_DRA and self.p_dra:
                dra += 1
            elif ins.op == OP_TRA and self.p_tra:
                tra += 1
        return {"dra": dra, "tra": tra}

    # -- derivation helpers -------------------------------------------------
    def with_protected(self, ops) -> "FaultModel":
        """A copy with `ops` added to the protected op-index set."""
        merged = tuple(sorted(set(self.protected_ops) | {int(i)
                                                         for i in ops}))
        return dataclasses.replace(self, protected_ops=merged)

    def wave_model(self) -> Optional["FaultModel"]:
        """The model a wave body should see: dead-queue entries are a
        dispatcher concern, and a model with no flips at all drops to
        None so the fault-free path runs unchanged."""
        if not self.flips_active:
            return None
        if self.dead_queues:
            return dataclasses.replace(self, dead_queues=())
        return self
