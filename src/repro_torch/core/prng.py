"""A torch twin of the `jax.random` draws the Table-3 Monte-Carlo makes
(`core/analog.py`), bit for bit, under the reference's configuration:
the threefry2x32 generator with `jax_threefry_partitionable` on (the
default of the jax the reference runs under).

A key is an int64 tensor [2] of 32-bit words (torch's uint32 lacks
shifts; every word is masked to 32 bits), on the device it was made on;
every draw lands on its key's device.

  PRNGKey(seed), split(key, num), fold_in(key, data)
  random_bits(key, shape)   32-bit words: the two threefry outputs XORed
  uniform(key, shape, minval, maxval)   float32
  bernoulli(key, p, shape)  uniform < p
  normal(key, shape)        sqrt(2) * erf_inv(uniform on (-1, 1))

`normal` follows XLA's expansion of `erf_inv` on the CPU: Giles' float32
polynomial in w = -log1p(-x^2), where `log1p` is XLA's own (a Cephes
rational for small arguments, else its float32 `log` polynomial of
1 + x), and every multiply that the CPU backend fuses into the next add
is one fused multiply-add here too (`fma`: the exact product and sum in
float64, rounded to odd, then once to float32).  Each other operation is
one correctly rounded float32 operation, as on the card, so the draws do
not depend on the device.
"""
from __future__ import annotations

import math
import struct
from typing import Sequence, Tuple, Union

import torch

from repro_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The raw key of `jax.random.PRNGKey(seed)`: the seed's high and low
    32-bit words (an int32 seed's high word is 0)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**63:
        raise ValueError(f"seed {seed} outside [-2**31, 2**63)")
    hi = seed >> 32 if seed >= 0 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64,
                        device=resolve_device(device))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds), elementwise over the
    counter words x1, x2 under the key words k1, k2 (int64 tensors)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def _counts(key: torch.Tensor, n: int):
    """The high and low words of iota(n) as 64-bit counters."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """[num, 2] keys: threefry of the counters 0..num-1 (the partitionable
    split)."""
    b1, b2 = threefry2x32(key[0], key[1], *_counts(key, num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key `jax.random.fold_in(key, data)` gives: threefry of the
    counter pair (0, data)."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(key[0], key[1], zero, zero + (int(data) & MASK32))
    return torch.cat([o1, o2])


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit words (int64 in [0, 2**32)) of `shape`: the two threefry
    outputs of each element's flat index, XORed."""
    shape = _shape(shape)
    b1, b2 = threefry2x32(key[0], key[1], *_counts(key, math.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def _f32(bits: int) -> float:
    """The float32 with these bits, as a Python float (exact)."""
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once: the exact product and sum in
    float64, rounded to odd (the last bit set where the sum was inexact),
    then to float32; rounding to odd first makes the second rounding the
    correctly rounded one, 53 >= 24 + 2 bits."""
    p = a.to(torch.float64) * b.to(torch.float64)        # exact
    c = c.to(torch.float64)
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)                         # p + c - s, exact
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)      # |s| up or down
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


def uniform(key: torch.Tensor, shape: Shape, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """float32 in [minval, maxval): 23 random mantissa bits under the
    exponent of 1, less 1, scaled by (maxval - minval) and shifted by
    minval in one fused multiply-add, then max(minval, .)."""
    dev = key.device
    lo, hi = _scalar(minval, dev), _scalar(maxval, dev)
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def bernoulli(key: torch.Tensor, p=0.5, shape: Shape = ()) -> torch.Tensor:
    """bool: uniform(key, shape) < p."""
    return uniform(key, shape) < _scalar(p, key.device)


# XLA's float32 log (a Cephes-style polynomial on the mantissa in
# [sqrt(1/2), sqrt(2))), coefficients as float32 bit patterns.
_LOG_P = tuple(_f32(b) for b in (
    0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3E4CCEAC, 0xBE7FFFFC,
    0x3DEF251A, 0xBE2AAE50, 0x3EAAAAAA))
_LOG_Q1, _LOG_Q2 = _f32(0xB95E8083), _f32(0x3F318000)  # ln 2 = q2 + q1
_SQRT_HALF = _f32(0x3F3504F3)
# XLA's log1p for |x| < sqrt(2) - 1: x - x^2/2 + x^3 P(x)/Q(x) (Cephes)
_LOG1P_Q = tuple(_f32(b) for b in (
    0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982))
_LOG1P_P = tuple(_f32(b) for b in (
    0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
    0x41A05101))
_LOG1P_SMALL = _f32(0x3ED413CD)
# Giles' erf_inv, w < 5 and w >= 5 coefficients, highest power first
_ERFINV_LT5 = tuple(_f32(b) for b in (
    0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB, 0xBAA45408,
    0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F))
_ERFINV_GE5 = tuple(_f32(b) for b in (
    0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B, 0xBBF9C5D7,
    0x3C1AA57E, 0x3F8036DB, 0x40354F7E))
SQRT2_F32 = _f32(0x3FB504F3)


def _log_f32(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, operation for operation."""
    tiny = _f32(0x00800000)
    yc = torch.where(y > tiny, y, torch.full_like(y, tiny))
    bits = yc.view(torch.int32)
    e = ((bits >> 23) & 0x1FF) - 127
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF
    e = e.to(torch.float32) + 1.0
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    z = x * x
    x3 = z * x
    c = [torch.full_like(x, v) for v in _LOG_P]
    a = fma(fma(x, c[0], c[1]), x, c[6])
    b = fma(fma(x, c[2], c[3]), x, c[7])
    d = fma(fma(x, c[4], c[5]), x, c[8])
    poly = fma(fma(fma(a, x3, b), x3, d), x3, e * _LOG_Q1)
    r = fma(e, torch.full_like(e, _LOG_Q2), (x - z * 0.5) + poly)
    r = torch.where((y <= 0) | torch.isnan(y), torch.full_like(r, math.nan), r)
    r = torch.where(y == 0, torch.full_like(r, -math.inf), r)
    return torch.where(y == math.inf, y, r)


def log1p(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p on the CPU, operation for operation."""
    large = _log_f32(v + 1.0)
    v2 = v * v
    zero = v * 0.0
    q = zero + 1.0
    for c in _LOG1P_Q:
        q = fma(q, v, torch.full_like(v, c))
    p = zero + _LOG1P_P[0]
    for c in _LOG1P_P[1:]:
        p = fma(p, v, torch.full_like(v, c))
    small = v + fma(v2, torch.full_like(v, -0.5), (v * v2) * (p / q))
    return torch.where(v.abs() < _LOG1P_SMALL, small, large)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv on the CPU: x * P(w), w = -log1p(-x^2), the
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, by fused Horner steps;
    +-inf at |x| = 1."""
    lg = log1p(x * -x)
    lt5 = lg > -5.0
    # sqrt in float64, rounded once to float32: correctly rounded (torch's
    # float32 sqrt on some CPUs is not)
    root = torch.sqrt(-lg.to(torch.float64)).to(torch.float32)
    t = torch.where(lt5, -2.5 - lg, root - 3.0)
    coef = [torch.where(lt5, a, b) for a, b in zip(
        (torch.full_like(x, v) for v in _ERFINV_LT5),
        (torch.full_like(x, v) for v in _ERFINV_GE5))]
    p = fma(coef[0], t, coef[1])
    for c in coef[2:]:
        p = fma(t, p, c)
    p = torch.where(x.abs() == 1.0, torch.full_like(p, math.inf), p)
    return x * p


def normal(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """float32 standard normals: sqrt(2) * erf_inv(u), u uniform on
    (-1, 1) from the float32 just above -1."""
    u = uniform(key, shape, _f32(0xBF7FFFFF), 1.0)
    return erf_inv(u) * SQRT2_F32
