"""Fused BNN dot product on the DRIM fleet: XNOR -> popcount-accumulate
(port of `repro.pim.bnn`).

C[m, n] = 2*popcount(XNOR(a[m], b[n])) - K.  On DRIM the layout is
vertical (bit-serial): lane m*N + n -- one bit-line position across the
fleet's rows -- holds output element (m, n), and plane k holds bit k of
every lane's operand pair.  Two popcount dataflows:

  * RIPPLE (`bnn_dot_graph`): each XNOR plane is added into a
    ceil(log2(K+1))-plane resident counter by a full ripple of Table-2
    adders, so the stream grows as K * (1 + 7*nbits).
  * CARRY-SAVE (`bnn_dot_graph_carrysave`): a 3:2-compressor tree; each
    full adder retires a whole plane, ~K adders in all.

Either way the whole dot is ONE AAP stream per slot; the 2K+1 operand
planes are loaded once per tile and only the counter planes are read
back.  Staging (lane broadcast + word packing) and decoding run as plain
torch on the device the dot runs on.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core import DRIM_R, DrimGeometry
from repro_torch.core.subarray import WORD_BITS, pack_bits, unpack_bits
from repro_torch.device import resolve_device
from repro_torch.pim.graph import BulkGraph, FusedSchedule

# Serving reduction tile: the carry-save graph keeps ~2K+1 data rows live
# at the XNOR level, so K beyond the ~500-row sub-array budget cannot
# lower (K=256 needs 513 live rows).  Chunk dots sum exactly.
DEFAULT_K_TILE = 128


def counter_bits(k_bits: int) -> int:
    """Bit-planes needed to count K ones: ceil(log2(K+1))."""
    return max(1, math.ceil(math.log2(k_bits + 1)))


def bnn_dot_graph(k_bits: int) -> BulkGraph:
    """XNOR -> ripple popcount-accumulate over K bit-plane inputs.

    Inputs a0..a{K-1}, b0..b{K-1} and `zero`; outputs c0..c{nbits-1}, the
    popcount as counter bit-planes."""
    if k_bits < 1:
        raise ValueError("k_bits must be positive")
    nbits = counter_bits(k_bits)
    g = BulkGraph()
    a = [g.input(f"a{k}") for k in range(k_bits)]
    b = [g.input(f"b{k}") for k in range(k_bits)]
    zero = g.input("zero")
    acc = [zero] * nbits
    for k in range(k_bits):
        carry = g.op("xnor2", a[k], b[k])
        # counter += plane: the counter cannot overflow nbits, so the
        # final carry is dead and its row is recycled immediately.
        for i in range(nbits):
            acc[i], carry = g.op("add", acc[i], carry, zero)
    for i in range(nbits):
        g.output(f"c{i}", acc[i])
    return g


def bnn_dot_graph_carrysave(k_bits: int) -> Tuple[BulkGraph, int]:
    """Carry-save 3:2-compressor tree popcount over K bit-plane inputs.

    Same inputs/outputs as `bnn_dot_graph`.  While a weight level holds
    >= 3 planes a full adder compresses three into sum (same weight) +
    carry (next weight); a half adder (`add` with the zero plane) settles
    a level left with two.  Returns (graph, nbits)."""
    if k_bits < 1:
        raise ValueError("k_bits must be positive")
    g = BulkGraph()
    a = [g.input(f"a{k}") for k in range(k_bits)]
    b = [g.input(f"b{k}") for k in range(k_bits)]
    zero = g.input("zero")
    levels: List[List] = [[g.op("xnor2", a[k], b[k])
                           for k in range(k_bits)]]
    w = 0
    while w < len(levels):
        vals = levels[w]
        carries: List = []
        while len(vals) >= 3:
            s, c = g.op("add", vals[0], vals[1], vals[2])
            vals = vals[3:] + [s]
            carries.append(c)
        if len(vals) == 2:
            s, c = g.op("add", vals[0], vals[1], zero)
            vals = [s]
            carries.append(c)
        levels[w] = vals
        if carries:
            if w + 1 < len(levels):
                levels[w + 1].extend(carries)
            else:
                levels.append(carries)
        w += 1
    for i, vals in enumerate(levels):
        g.output(f"c{i}", vals[0])
    return g, len(levels)


def _lane_planes(a_bits: torch.Tensor, b_bits: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """[M, K] x [N, K] sign bits -> (a planes, b planes) as [K, W] int32
    words over lanes l = m*N + n: bit l%32 of word l//32 (little-endian),
    zero lanes past M*N.  Plane a_k broadcasts A[:, k] across the N
    columns, plane b_k tiles B[:, k] across the M rows."""
    m, k_bits = a_bits.shape
    n, kb2 = b_bits.shape
    if k_bits != kb2:
        raise ValueError("operand K dimensions differ")
    lanes = m * n
    pad = -lanes % WORD_BITS

    def pack(lane_bits: torch.Tensor) -> torch.Tensor:
        lane_bits = lane_bits.reshape(k_bits, lanes)
        return pack_bits(torch.nn.functional.pad(lane_bits, (0, pad)))

    a_planes = pack(a_bits.T.to(torch.uint8)[:, :, None].expand(k_bits, m, n))
    b_planes = pack(b_bits.T.to(torch.uint8)[:, None, :].expand(k_bits, m, n))
    return a_planes, b_planes, lanes


def stage_bnn_planes(a_bits, b_bits,
                     ) -> Tuple[Dict[str, torch.Tensor], int]:
    """Lay out an [M, K] x [N, K] binary GEMM as the named bit-plane feeds
    of `bnn_dot_graph` (a0.., b0.., zero) on the operands' device.
    Returns (feeds, n_lanes)."""
    a_planes, b_planes, lanes = _lane_planes(torch.as_tensor(a_bits),
                                             torch.as_tensor(b_bits))
    feeds: Dict[str, torch.Tensor] = {}
    for k in range(a_planes.shape[0]):
        feeds[f"a{k}"] = a_planes[k]
        feeds[f"b{k}"] = b_planes[k]
    feeds["zero"] = torch.zeros_like(a_planes[0])
    return feeds, lanes


def decode_counts(outs: Dict[str, torch.Tensor], nbits: int,
                  lanes: int) -> torch.Tensor:
    """Counter bit-planes c0..c{nbits-1} (int32 words) -> per-lane
    popcount (int32) on the planes' device."""
    count = unpack_bits(outs["c0"].reshape(-1))[:lanes]
    for i in range(1, nbits):
        count = count + (unpack_bits(outs[f"c{i}"].reshape(-1))[:lanes] << i)
    return count


def bnn_dot_drim(a_bits, b_bits, *, geom: DrimGeometry = DRIM_R,
                 accumulate: str = "ripple", engine: str = "resident",
                 device=None) -> Tuple[torch.Tensor, FusedSchedule]:
    """Full fused BNN dot product on the simulated fleet.

    a_bits [M, K], b_bits [N, K] sign bits in {0, 1} (numpy or tensors).
    Returns (C [M, N] int32 on `device`, schedule), C = 2*popcount(XNOR)
    - K.  `accumulate` picks the popcount dataflow: "ripple" or
    "carrysave"."""
    from repro_torch.pim.compiler import compile as drim_compile
    dev = resolve_device(device)
    a_bits = torch.as_tensor(a_bits, device=dev)
    b_bits = torch.as_tensor(b_bits, device=dev)
    m, k_bits = a_bits.shape
    n = b_bits.shape[0]
    if accumulate == "ripple":
        graph, nbits = bnn_dot_graph(k_bits), counter_bits(k_bits)
    elif accumulate == "carrysave":
        graph, nbits = bnn_dot_graph_carrysave(k_bits)
    else:
        raise ValueError(f"unknown accumulate mode {accumulate!r}")
    feeds, lanes = stage_bnn_planes(a_bits, b_bits)
    low = drim_compile(graph, geom=geom).lower(engine=engine)
    outs = low.run(feeds, n_bits=lanes, device=dev)
    count = decode_counts(outs, nbits, lanes)
    return (2 * count - k_bits).reshape(m, n), low.schedule


# ---------------------------------------------------------------------------
# The serving path: BitLinear GEMMs routed through jit
# ---------------------------------------------------------------------------

def k_chunks(k_bits: int, k_tile: Optional[int] = None) -> Tuple[int, ...]:
    """Split a reduction width into row-budget-sized kernel chunks."""
    tile = k_tile or DEFAULT_K_TILE
    if k_bits < 1:
        raise ValueError("k_bits must be positive")
    if tile < 1:
        raise ValueError("k_tile must be positive")
    chunks = [tile] * (k_bits // tile)
    if k_bits % tile:
        chunks.append(k_bits % tile)
    return tuple(chunks)


@functools.lru_cache(maxsize=None)
def bitlinear_kernel(k_bits: int):
    """The serving kernel for one reduction width, traced once: a `jit`
    function over 2K bit-planes (a0..a{K-1}, b0..b{K-1}) returning the
    carry-save popcount of the XNOR planes -- node for node the dataflow
    of `bnn_dot_graph_carrysave`."""
    from repro_torch.pim import frontend

    def body(*planes):
        xn = [frontend.xnor(a, b)
              for a, b in zip(planes[:k_bits], planes[k_bits:])]
        return frontend.popcount(xn)

    names = [f"a{i}" for i in range(k_bits)] \
        + [f"b{i}" for i in range(k_bits)]
    return frontend.jit(body, arg_names=names,
                        name=f"bitlinear_dot[K={k_bits}]")


def serving_lowering(k_bits: int, *, engine: str = "resident",
                     geom: Optional[DrimGeometry] = None):
    """compile -> lower the serving kernel once per (K, engine, geometry)
    through the process-wide `compiler.lower_cached` memo."""
    from repro_torch.pim import compiler
    return compiler.lower_cached(
        bitlinear_kernel(k_bits).trace(),
        key=("bitlinear_dot", k_bits), geom=geom, engine=engine)


def serve_bnn_matmul(a_bits, b_bits, *, engine: str = "resident",
                     geom: Optional[DrimGeometry] = None,
                     k_tile: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Serving-path binary GEMM on the DRIM fleet.

    a_bits [M, K], b_bits [N, K] sign bits in {0, 1} (numpy or tensors);
    returns C [M, N] int32 on `device`, the ±1 dot, exactly.  The
    reduction dim tiles into `k_chunks` (sub-array row budget); each chunk
    runs the cached carry-save kernel and the partial dots sum exactly."""
    dev = resolve_device(device)
    a_bits = torch.as_tensor(a_bits, device=dev).to(torch.uint8)
    b_bits = torch.as_tensor(b_bits, device=dev).to(torch.uint8)
    if a_bits.dim() != 2 or b_bits.dim() != 2:
        raise ValueError("serve_bnn_matmul takes 2-D sign-bit operands")
    m, k_bits = a_bits.shape
    n, kb2 = b_bits.shape
    if k_bits != kb2:
        raise ValueError("operand K dimensions differ")
    lanes = m * n
    total = torch.zeros(lanes, dtype=torch.int32, device=dev)
    offset = 0
    for kc in k_chunks(k_bits, k_tile):
        low = serving_lowering(kc, engine=engine, geom=geom)
        a_planes, b_planes, _ = _lane_planes(a_bits[:, offset:offset + kc],
                                             b_bits[:, offset:offset + kc])
        outs = low.run(*a_planes, *b_planes, n_bits=lanes, device=dev)
        count = decode_counts({f"c{i}": p for i, p in enumerate(outs)},
                              len(outs), lanes)
        total += 2 * count - kc
        offset += kc
    return total.reshape(m, n)
