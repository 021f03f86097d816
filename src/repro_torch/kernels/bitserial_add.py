"""Bit-serial ripple-carry adder over packed bit-planes (port of
`repro.kernels.bitserial_add`).

`bitplane_add(a_planes, b_planes)` adds two [nbits, W] int32 bit-plane
arrays (plane i holds bit i of 32 W lanes, least significant first) and
returns (sum planes [nbits, W], carry-out [W]): the DRIM in-memory adder
of Table 2, Sum = a ^ b ^ c and Cout = MAJ3 per bit-slice.

Kernel: `csrc/bitplane_add.cu`, replacing the TPU kernel
`src/repro/kernels/bitserial_add.py:_add_kernel`.  One thread per word
column (four where the planes allow 128-bit accesses) with the carry in a
register across a runtime loop over the planes; device-memory bandwidth
bounds it.  On a CPU tensor the wrapper runs `bitplane_add_plain`; on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitplane_add_ref


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bitplane_add")
    p = ctypes.c_void_p
    lib.bitplane_add.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_longlong,
                                 p]
    lib.bitplane_add.restype = ctypes.c_int
    return lib


def bitplane_add_plain(a_planes: torch.Tensor, b_planes: torch.Tensor):
    """Plain torch version (`ref.bitplane_add_ref`)."""
    return bitplane_add_ref(a_planes, b_planes)


def bitplane_add(a_planes: torch.Tensor, b_planes: torch.Tensor):
    """(sum planes [nbits, W], carry-out [W]) of two contiguous [nbits, W]
    int32 plane arrays."""
    for t in (a_planes, b_planes):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError("bitplane_add takes int32 word tensors")
        if t.dim() != 2:
            raise ValueError("bitplane_add takes [nbits, W] planes, got "
                             f"shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError("bitplane_add takes contiguous tensors")
    if a_planes.shape != b_planes.shape:
        raise ValueError(f"plane shapes differ: {tuple(a_planes.shape)} vs "
                         f"{tuple(b_planes.shape)}")
    if a_planes.device != b_planes.device:
        raise ValueError("operands lie on different devices")
    if a_planes.device.type == "cpu":
        return bitplane_add_plain(a_planes, b_planes)
    if a_planes.device.type != "cuda":
        raise ValueError(f"bitplane_add runs on cpu or cuda, not "
                         f"{a_planes.device}")
    nbits, w = a_planes.shape
    sums = torch.empty_like(a_planes)
    carry = torch.empty(w, dtype=torch.int32, device=a_planes.device)
    if w == 0:
        return sums, carry
    with torch.cuda.device(a_planes.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_lib().bitplane_add(
            a_planes.data_ptr(), b_planes.data_ptr(), sums.data_ptr(),
            carry.data_ptr(), nbits, w, stream), "bitplane_add")
    bitplane_add.launches += 1
    return sums, carry


bitplane_add.launches = 0
