"""DRIM sub-array address template and bit packing (port of
`repro.core.subarray`).

A 512-row sub-array is split into data rows, the eight computation rows
x1..x8 and two dual-contact (DCC) rows with two word-lines each:

  wl in [0, n_rows)            : normal rows (data + x1..x8)
  wl in [n_rows, n_rows + 4)   : dcc1..dcc4 (cell A via BL, A via BL-bar,
                                 cell B via BL, B via BL-bar)

The port needs the sub-array only as an address template: programs are
emitted against it, and the wave engines (`core.isa.run_program_unrolled`
and the AAP interpreter kernel) hold the state themselves.

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
    """Address template of one computational sub-array."""

    n_rows: int          # data rows + x1..x8
    words: int

    def wl_dcc(self, k: int) -> int:
        """Word-line address of dcc{k}, k in 1..4."""
        return self.n_rows + (k - 1)

    def wl_x(self, k: int) -> int:
        """Word-line address of x{k}, k in 1..8 (paper Fig. 3)."""
        return self.n_rows - N_XROWS + (k - 1)


def make_subarray(n_data: int = 500, row_bits: int = 256) -> SubArray:
    """Template with n_data data rows + 8 x-rows."""
    return SubArray(n_rows=n_data + N_XROWS, words=row_words(row_bits))


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
