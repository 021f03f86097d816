"""Sign packer: [R, K] float32/bfloat16 -> [R, ceil(K/32)] int32 sign words
(port of `repro.kernels.packbits`).

Bit j of word w is 1 where x[r, 32w + j] >= 0 (little-endian; -0.0 packs
to 1, NaN to 0); bits past K are 0.

Kernel: `csrc/pack_signs.cu`, replacing the TPU kernel
`src/repro/kernels/packbits.py:_pack_kernel`.  One warp builds one word
with `__ballot_sync`; the op reads each input once and writes 1/32 of
it, so device-memory bandwidth bounds it, and the kernel's reads are
fully coalesced (one 128-byte row segment per warp for float32).  On a
CPU tensor the wrapper runs `pack_signs_plain`; on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.subarray import WORD_BITS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_signs_ref

_DTYPES = (torch.float32, torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_signs")
    for fn in (lib.pack_signs_f32, lib.pack_signs_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def pack_signs_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version: pad K with -1 (bits 0), then pack."""
    k = x.shape[-1]
    pad = (-k) % WORD_BITS
    x = torch.nn.functional.pad(x.to(torch.float32), (0, pad), value=-1.0)
    return pack_signs_ref(x)


def pack_signs(x: torch.Tensor) -> torch.Tensor:
    """[R, K] float32/bfloat16 contiguous -> [R, ceil(K/32)] int32."""
    if x.dim() != 2:
        raise ValueError(f"pack_signs takes [R, K], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"pack_signs takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("pack_signs takes a contiguous tensor")
    if x.device.type == "cpu":
        return pack_signs_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_signs runs on cpu or cuda, not {x.device}")
    rows, k = x.shape
    words = -(-k // WORD_BITS)
    out = torch.empty((rows, words), dtype=torch.int32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    fn = lib.pack_signs_f32 if x.dtype == torch.float32 else lib.pack_signs_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), out.data_ptr(), rows, k, words, stream),
                     "pack_signs")
    pack_signs.launches += 1
    return out


pack_signs.launches = 0
