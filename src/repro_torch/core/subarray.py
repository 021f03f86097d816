"""Bit-accurate functional model of a DRIM computational DRAM sub-array
(port of `repro.core.subarray`).

A 512-row sub-array is split into data rows, the eight computation rows
x1..x8 and two dual-contact (DCC) rows with two word-lines each:

  wl in [0, n_rows)            : normal rows (data + x1..x8)
  wl in [n_rows, n_rows + 4)   : dcc1..dcc4 (cell A via BL, A via BL-bar,
                                 cell B via BL, B via BL-bar)

A BL-bar word-line stores the complement of the bit-line on a write and
puts the complement of its cell on the bit-line on a read; DRA and TRA
leave every source at the final bit-line level (paper Fig. 6).

`SubArray` holds the state (`data` [..., n_rows, words], `dcc` [..., 2,
words]); leading dimensions batch slots, so one state can be a whole
fleet.  Programs are also emitted against it as an address template.
The AAP primitives update the state IN PLACE and return it: the
reference's are pure, but a replay of thousands of AAPs over a fleet's
state would otherwise copy the state once per AAP.  `isa.run_program`
copies its input once, so it stays pure to its caller.

Words are carried as int32 bit patterns: torch's uint32 lacks `~`, the
shifts and the comparisons.  `>>` on int32 is arithmetic, so every shift
is masked.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

WORD_BITS = 32
N_XROWS = 8
N_DCC_WL = 4


def row_words(row_bits: int) -> int:
    if row_bits % WORD_BITS:
        raise ValueError(f"row_bits must be a multiple of {WORD_BITS}")
    return row_bits // WORD_BITS


@dataclasses.dataclass(frozen=True)
class SubArray:
    """State of one computational sub-array, or of a batch of them."""

    data: torch.Tensor   # [..., n_rows, words] int32 -- data rows + x1..x8
    dcc: torch.Tensor    # [..., 2, words]      int32 -- DCC cells A and B

    @property
    def n_rows(self) -> int:
        return self.data.shape[-2]

    @property
    def words(self) -> int:
        return self.data.shape[-1]

    @property
    def row_bits(self) -> int:
        return self.words * WORD_BITS

    def wl_dcc(self, k: int) -> int:
        """Word-line address of dcc{k}, k in 1..4."""
        return self.n_rows + (k - 1)

    def wl_x(self, k: int) -> int:
        """Word-line address of x{k}, k in 1..8 (paper Fig. 3)."""
        return self.n_rows - N_XROWS + (k - 1)


def make_subarray(n_data: int = 500, row_bits: int = 256, *,
                  device="cpu") -> SubArray:
    """Fresh sub-array: n_data data rows + 8 x-rows, all zero.  Host-side
    by default: it serves far more often as an address template than as
    state (`device.make_device` is the fleet's entry point)."""
    w = row_words(row_bits)
    return SubArray(
        data=torch.zeros((n_data + N_XROWS, w), dtype=torch.int32,
                         device=device),
        dcc=torch.zeros((2, w), dtype=torch.int32, device=device))


def load_rows(sa: SubArray, start: int, rows) -> SubArray:
    """Host-side data load (models the DDR write path, not an AAP):
    word-lines [start, start + k) of a copy of `sa` take `rows` [..., k,
    words]."""
    rows = as_words(rows, sa.data.device)
    data = sa.data.clone()
    data[..., start:start + rows.shape[-2], :] = rows
    return dataclasses.replace(sa, data=data)


# ---------------------------------------------------------------------------
# ACTIVATE: place a word-line's value on the bit-line (digital fast path).
# Word-line addresses are Python ints: the stream is always known on the
# host.
# ---------------------------------------------------------------------------

def activate_read(sa: SubArray, wl: int) -> torch.Tensor:
    """Sense amplification of one row: the value ON THE BIT-LINE."""
    if wl < sa.n_rows:
        return sa.data[..., wl, :]
    off = wl - sa.n_rows
    v = sa.dcc[..., off // 2, :]
    return ~v if off % 2 else v


def _write_wl(sa: SubArray, wl: int, bl_value: torch.Tensor) -> SubArray:
    """Second ACTIVATE of an AAP: connect `wl`'s capacitor to its bit-line
    while the SA drives BL = bl_value (BL-bar word-lines store ~bl_value).
    In place."""
    if wl < sa.n_rows:
        sa.data[..., wl, :] = bl_value
    else:
        off = wl - sa.n_rows
        sa.dcc[..., off // 2, :] = ~bl_value if off % 2 else bl_value
    return sa


# ---------------------------------------------------------------------------
# AAP primitives (paper §3.2), in place.  Every read resolves before the
# first write, so a source that is also written reads its old value.
# ---------------------------------------------------------------------------

def aap_copy(sa: SubArray, src: int, des: int) -> SubArray:
    """AAP type-1: ACTIVATE src, ACTIVATE des, PRECHARGE.  Copy/NOT."""
    return _write_wl(sa, des, activate_read(sa, src))


def aap_copy2(sa: SubArray, src: int, des1: int, des2: int) -> SubArray:
    """AAP type-2: one source, two destinations (simultaneous).  The BL
    value is copied out first: a write through a DCC cell's other
    word-line would change the view of it."""
    bl = activate_read(sa, src).clone()
    return _write_wl(_write_wl(sa, des1, bl), des2, bl)


def _dra_bl(sa: SubArray, src1: int, src2: int) -> torch.Tensor:
    return ~(activate_read(sa, src1) ^ activate_read(sa, src2))


def _tra_bl(sa: SubArray, src1: int, src2: int, src3: int) -> torch.Tensor:
    a = activate_read(sa, src1)
    b = activate_read(sa, src2)
    c = activate_read(sa, src3)
    return (a & b) | (a & c) | (b & c)


def _write_all(sa: SubArray, wls, bl: torch.Tensor) -> SubArray:
    for wl in wls:              # sources end at the BL level (Fig. 6)
        _write_wl(sa, wl, bl)
    return sa


def aap_dra(sa: SubArray, src1: int, src2: int, des: int) -> SubArray:
    """AAP type-3: Dual-Row Activation (the paper's contribution, §3.1):
    BL = XNOR(a, b) in one cycle; both sources end at the BL level."""
    return _write_all(sa, (src1, src2, des), _dra_bl(sa, src1, src2))


def aap_tra(sa: SubArray, src1: int, src2: int, src3: int,
            des: int) -> SubArray:
    """AAP type-4: Ambit-style Triple-Row Activation => MAJ3 on the BL;
    all three sources end at the majority level."""
    return _write_all(sa, (src1, src2, src3, des),
                      _tra_bl(sa, src1, src2, src3))


# ---------------------------------------------------------------------------
# Bit packing helpers (host <-> sub-array layout)
# ---------------------------------------------------------------------------

_TWO_32 = 1 << 32


def wrap_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor of the same bits."""
    return torch.where(words >= 1 << 31, words - _TWO_32, words) \
        .to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., n*32] {0,1} -> [..., n] int32 words (bit 0 = LSB of word 0).

    Each word is built in int64 and wrapped, so bit 31 cannot overflow."""
    *lead, n = bits.shape
    if n % WORD_BITS:
        raise ValueError("bit length must be a multiple of 32")
    shifts = torch.arange(WORD_BITS, dtype=torch.int64, device=bits.device)
    b = bits.reshape(*lead, n // WORD_BITS, WORD_BITS).to(torch.int64)
    return wrap_int32((b << shifts).sum(-1))


def as_words(x, device) -> torch.Tensor:
    """Integer words (numpy array, sequence or tensor) -> the int32 tensor
    of the same 32 low bits on `device`.  Float inputs raise: a float feed
    truncating silently would be a wrong answer."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32:
            return x.to(device)
        if x.dtype == torch.uint32:
            return x.view(torch.int32).to(device)
        if x.dtype.is_floating_point or x.dtype.is_complex \
                or x.dtype == torch.bool:
            raise TypeError(f"expected integer words, got {x.dtype}")
        return wrap_int32(x.to(torch.int64) & 0xFFFFFFFF).to(device)
    a = np.asarray(x)
    if not np.issubdtype(a.dtype, np.integer):
        raise TypeError(f"expected integer words, got {a.dtype}")
    a = np.ascontiguousarray(a.astype(np.uint32).view(np.int32))
    return torch.from_numpy(a).to(device)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """[..., n] int32 words -> [..., n*32] {0,1} int32."""
    *lead, n = words.shape
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*lead, n * WORD_BITS)
