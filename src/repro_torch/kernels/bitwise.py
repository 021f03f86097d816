"""Bulk bit-wise ops on packed int32 words (port of `repro.kernels.bitwise`).

`bitwise(op, a, b=None, c=None)` applies one op of the DRIM controller's
table to word tensors of one shape, elementwise, and returns a tensor of
that shape (for "fa" the pair (sum, carry)).  Words are int32 bit
patterns, so every op is exactly the reference's uint32 op.

Kernels: `csrc/bitwise.cu`, three of them templated on the op, replacing
the TPU kernels `src/repro/kernels/bitwise.py:_not_kernel`,
`_binary_kernel` and `_ternary_kernel`.  They stream every word once with
128-bit accesses and a scalar head and tail, so any length and any start
address runs without a padding copy; device-memory bandwidth bounds them
(the design note is in the source).  The output is allocated in the first
operand's 16-byte phase so that a sliced operand still streams with
vectors.  On a CPU tensor the wrapper runs `bitwise_plain`; on a CUDA
tensor it launches the kernel or raises.  Each kernel has its own
launcher with its own launch counter: `not_kernel.launches`,
`binary_kernel.launches`, `ternary_kernel.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitwise_ref

BINARY_OPS = ("xnor", "xor", "and", "or", "nand", "nor")
TERNARY_OPS = ("maj3", "min3", "fa")  # fa: full adder (sum, carry)
UNARY_OPS = ("not",)

# op codes of `csrc/bitwise.cu` (enum Op)
_CODE = {"not": 0, "xnor": 1, "xor": 2, "and": 3, "or": 4, "nand": 5,
         "nor": 6, "maj3": 7, "min3": 8, "fa": 9}
_ARITY = {**{op: 1 for op in UNARY_OPS}, **{op: 2 for op in BINARY_OPS},
          **{op: 3 for op in TERNARY_OPS}}
_PHASE_WORDS = 4          # int32 words per 16 bytes


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bitwise")
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.bitwise_not.argtypes = [p, p, ll, p]
    lib.bitwise_binary.argtypes = [ctypes.c_int, p, p, p, ll, p]
    lib.bitwise_ternary.argtypes = [ctypes.c_int, p, p, p, p, p, ll, p]
    for fn in (lib.bitwise_not, lib.bitwise_binary, lib.bitwise_ternary):
        fn.restype = ctypes.c_int
    return lib


def bitwise_plain(op: str, a, b=None, c=None):
    """Plain torch version (`ref.bitwise_ref`)."""
    return bitwise_ref(op, a, b, c)


def _operands(op: str, a, b, c):
    if op not in _ARITY:
        raise ValueError(f"unknown op {op!r}")
    arity = _ARITY[op]
    if (b is None) != (arity < 2) or (c is None) != (arity < 3):
        raise ValueError(f"{op} takes {arity} operands")
    given = [a, b, c][:arity]
    for t in given:
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
            raise TypeError("bitwise takes int32 word tensors")
        if t.shape != a.shape:
            raise ValueError(f"operand shapes differ: {tuple(t.shape)} vs "
                             f"{tuple(a.shape)}")
        if t.device != a.device:
            raise ValueError("operands lie on different devices")
        if not t.is_contiguous():
            raise ValueError("bitwise takes contiguous tensors")
    return given


def _phased_empty(like: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor of `like`'s shape whose start shares `like`'s
    16-byte phase (a view into a buffer up to 3 words longer)."""
    n = like.numel()
    shift = (like.data_ptr() % 16) // 4
    buf = torch.empty(n + _PHASE_WORDS - 1, dtype=torch.int32,
                      device=like.device)
    start = (shift - buf.data_ptr() // 4) % _PHASE_WORDS
    return buf[start:start + n].view(like.shape)


def _launch(entry: str, op: str, given, n_out: int):
    """Run one of the three kernels on validated CUDA operands."""
    a = given[0]
    if a.numel() == 0:
        return tuple(torch.empty_like(a) for _ in range(n_out))
    outs = tuple(_phased_empty(a) for _ in range(n_out))
    fn = getattr(_lib(), entry)
    code = () if op in UNARY_OPS else (_CODE[op],)
    out_ptrs = [o.data_ptr() for o in outs]
    if op in TERNARY_OPS:
        out_ptrs = [out_ptrs[0], out_ptrs[-1]]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(*code, *(t.data_ptr() for t in given), *out_ptrs,
                        a.numel(), stream), f"bitwise {op}")
    return outs


def not_kernel(a: torch.Tensor) -> torch.Tensor:
    """`csrc/bitwise.cu` NOT on a CUDA word tensor."""
    out, = _launch("bitwise_not", "not", [a], 1)
    if a.numel():
        not_kernel.launches += 1
    return out


def binary_kernel(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`csrc/bitwise.cu` two-input `op` on CUDA word tensors."""
    out, = _launch("bitwise_binary", op, [a, b], 1)
    if a.numel():
        binary_kernel.launches += 1
    return out


def ternary_kernel(op: str, a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor):
    """`csrc/bitwise.cu` three-input `op` on CUDA word tensors; (sum,
    carry) for "fa"."""
    outs = _launch("bitwise_ternary", op, [a, b, c], 2 if op == "fa" else 1)
    if a.numel():
        ternary_kernel.launches += 1
    return outs if op == "fa" else outs[0]


not_kernel.launches = 0
binary_kernel.launches = 0
ternary_kernel.launches = 0


def bitwise(op: str, a: torch.Tensor, b: torch.Tensor | None = None,
            c: torch.Tensor | None = None):
    """Bulk bit-wise `op` on int32 word tensors of one shape; returns a
    tensor of that shape, or (sum, carry) for "fa"."""
    _operands(op, a, b, c)
    if a.device.type == "cpu":
        return bitwise_plain(op, a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"bitwise runs on cpu or cuda, not {a.device}")
    if op in UNARY_OPS:
        return not_kernel(a)
    if op in BINARY_OPS:
        return binary_kernel(op, a, b)
    return ternary_kernel(op, a, b, c)
