"""Sign packer and unpacker (port of `repro.kernels.packbits`):
[R, K] float32/bfloat16 -> [R, ceil(K/32)] int32 sign words, and
[R, W] int32 words -> [R, 32 W] values in {-1, +1}.

Bit j of word w is 1 where x[r, 32w + j] >= 0 (little-endian; -0.0 packs
to 1, NaN to 0); bits past K are 0.

Kernel: `csrc/pack_signs.cu`, replacing the TPU kernel
`src/repro/kernels/packbits.py:_pack_kernel`.  One warp builds one word
with `__ballot_sync`; the op reads each input once and writes 1/32 of
it, so device-memory bandwidth bounds it, and the kernel's reads are
fully coalesced (one 128-byte row segment per warp for float32).  On a
CPU tensor the wrapper runs `pack_signs_plain`; on a CUDA tensor it
launches the kernel or raises.

Unpacker: `csrc/unpack_signs.cu`, replacing
`src/repro/kernels/packbits.py:_unpack_kernel`.  Each thread writes one
16-byte chunk of the output from bit patterns, so the writes (32 values
per 4-byte word) stream fully coalesced; they bound it.  Float32,
bfloat16 and int8 outputs; `unpack_signs_plain` on a CPU tensor.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.subarray import WORD_BITS
from repro_torch.kernels import _build
from repro_torch.kernels.ref import pack_signs_ref, unpack_signs_ref

_DTYPES = (torch.float32, torch.bfloat16)
_UNPACK_ENTRY = {torch.float32: "unpack_signs_f32",
                 torch.bfloat16: "unpack_signs_bf16",
                 torch.int8: "unpack_signs_i8"}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("pack_signs")
    for fn in (lib.pack_signs_f32, lib.pack_signs_bf16):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _unpack_lib() -> ctypes.CDLL:
    lib = _build.load("unpack_signs")
    for entry in _UNPACK_ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p]
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


def unpack_signs_plain(p: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain torch version (`ref.unpack_signs_ref`)."""
    return unpack_signs_ref(p, dtype)


def unpack_signs(p: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[R, W] int32 contiguous -> [R, 32 W] of `dtype` (float32, bfloat16
    or int8): +1 where the bit is set, -1 where it is not."""
    if p.dim() != 2:
        raise ValueError(f"unpack_signs takes [R, W], got shape "
                         f"{tuple(p.shape)}")
    if p.dtype != torch.int32:
        raise TypeError(f"unpack_signs takes int32 words, got {p.dtype}")
    if dtype not in _UNPACK_ENTRY:
        raise TypeError(f"unpack_signs writes float32, bfloat16 or int8, "
                        f"not {dtype}")
    if not p.is_contiguous():
        raise ValueError("unpack_signs takes a contiguous tensor")
    if p.device.type == "cpu":
        return unpack_signs_plain(p, dtype)
    if p.device.type != "cuda":
        raise ValueError(f"unpack_signs runs on cpu or cuda, not {p.device}")
    rows, words = p.shape
    out = torch.empty((rows, words * WORD_BITS), dtype=dtype, device=p.device)
    if out.numel() == 0:
        return out
    fn = getattr(_unpack_lib(), _UNPACK_ENTRY[dtype])
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(p.data_ptr(), out.data_ptr(), p.numel(), stream),
                     "unpack_signs")
    unpack_signs.launches += 1
    return out


unpack_signs.launches = 0
