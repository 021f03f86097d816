"""Foundational layers: norms, dense, rotary, the SwiGLU MLP, and
BitLinear (port of `repro.models.layers`).

Functional like the reference: every layer is init(generator, ...) ->
params and apply(params, x), with params plain dicts of tensors (scan-
stacked [L, ...] in the model trunk).  Initial values come from a seeded
`torch.Generator` with the reference's distributions, not its numbers.
The reference's `ambient_mesh` is `core.mesh.ambient_mesh`; its
`constrain` has no counterpart: one process holds every block, where a
sharding constraint is the identity.

BitLinear is the paper's technique as a layer: weights are sign-binarized
with a per-output-channel scale alpha = mean|w| (XNOR-Net).  Training uses
a straight-through estimator over the dense shadow weights (`bitlinear`);
serving runs from bit-packed weights through the XNOR-popcount kernel
(`bitlinear_packed`), or -- inside a `serving_engine(...)` scope --
through the DRIM fleet simulation (`pim.bnn.serve_bnn_matmul`).  The JAX
layout is kept: shadow weights are [d_in, d_out], packed weights
[d_out, ceil(d_in/32)].

Every route computes the exact integer dot first, rounds it once to the
activation dtype, then multiplies by `alpha.to(x.dtype)` and adds the
bias, in the reference's order, so the routes agree bit for bit.

Under a `model` axis over ranks (`core.mesh.model_ranks`) each rank holds
its block of every weight by the reference's specs, and the products are
Megatron's: `linear_col` (column-parallel: the replicated input against
the rank's output columns) and `linear_row` (row-parallel: the rank's
block of the input features against its rows, the partials summed over
the model group in float32 and rounded once to the activation dtype;
BitLinear's alpha = mean|w| over the whole d_in from the group's sum of
|w|).  A leaf that the specs do not cut the way its product wants (a
fallback spec, replication, or a column range off the block boundaries)
is gathered whole and the rank takes the part it needs; its gradient is
then summed over the group.  The packed `down` layer is cut over its
output, so its input is gathered over the group first.  With no model
axis over ranks both are `linear`.  Inside a `core.mesh.sequence_cut`
(a residual cut over the sequence) `linear_row`'s result is the rank's
block of the sequence: the float32 partials reduce-scattered in place
of the all-reduce, the packed layer's gathered whole cut to the block.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.mesh import (copy_to_model, gather_from_model,
                                   model_coord, model_ranks,
                                   reduce_from_model,
                                   reduce_scatter_to_sequence,
                                   scatter_to_model, sequence_ranks)
from repro_torch.core.subarray import as_words
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_slice, tree_stack

Params = Dict[str, Any]

# (engine, queue count, geometry) of the active DRIM serving scope, or
# None for the native packed-kernel path.
_SERVING: contextvars.ContextVar[Optional[Tuple[str, Any, Any]]] = \
    contextvars.ContextVar("repro_torch_serving_engine", default=None)


@contextlib.contextmanager
def serving_engine(engine: Optional[str] = None, *,
                   n_queues: Optional[int] = None, geom=None):
    """Route BitLinear matmuls through the DRIM pipeline for the scope.

    `engine` is a `pim.compiler.ENGINE_REGISTRY` name: None or the
    comparator "gpu" keeps the native packed-kernel path; "resident",
    "baseline", "queued" and "cuda" run the sign GEMMs on the DRIM fleet
    (`n_queues`: the "queued" engine's queue count).  The fleet runs on
    the activations' device."""
    if engine is not None:
        from repro_torch.pim.compiler import get_engine
        if not get_engine(engine).device:   # fail fast on unknown names
            engine = None                   # "gpu" == the native path
    token = _SERVING.set((engine, n_queues, geom) if engine is not None
                         else None)
    try:
        yield
    finally:
        _SERVING.reset(token)


def serving_engine_name() -> Optional[str]:
    """The active DRIM serving engine, or None for the native path."""
    active = _SERVING.get()
    return active[0] if active is not None else None


def _drim_gemm(x: torch.Tensor, wb_bits: torch.Tensor) -> torch.Tensor:
    """x [..., K] activations vs wb_bits [N, K] weight sign bits, as a ±1
    dot on the DRIM fleet; returns [..., N] int32 (exact)."""
    from repro_torch.pim.bnn import serve_bnn_matmul
    engine, n_queues, geom = _SERVING.get()
    lead = x.shape[:-1]
    xb = kops.sign_bits(x.to(torch.float32)).reshape(-1, x.shape[-1])
    dot = serve_bnn_matmul(xb, wb_bits, engine=engine, geom=geom,
                           n_queues=n_queues, device=x.device)
    return dot.reshape(*lead, wb_bits.shape[0])


def _he(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen) / math.sqrt(shape[0])).to(dtype)


# --- norms -------------------------------------------------------------------

def rmsnorm_init(d: int) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * params["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32),
            "bias": torch.zeros(d, dtype=torch.float32)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """The reference defines it and no model calls it; kept for parity."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


# --- dense / BitLinear -------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, dtype=torch.float32) -> Params:
    p = {"kernel": _he(gen, (d_in, d_out), dtype)}
    if bias:
        p["bias"] = torch.zeros(d_out, dtype=dtype)
    return p


def dense(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def bitlinear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                   bias: bool = False, dtype=torch.float32) -> Params:
    # "bkernel" (vs "kernel") marks the layer as binarized.
    p = dense_init(gen, d_in, d_out, bias=bias, dtype=dtype)
    p["bkernel"] = p.pop("kernel")
    return p


def _ste_sign(w: torch.Tensor) -> torch.Tensor:
    """sign(w) with straight-through gradient."""
    s = torch.where(w >= 0, 1.0, -1.0).to(w.dtype)
    return w + (s - w).detach()


def bitlinear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """XNOR-Net linear from dense shadow weights: y = (sign(x) xnor-dot
    sign(w)) * alpha, the STE formulation (or the DRIM fleet inside a
    `serving_engine` scope)."""
    w = params["bkernel"]
    alpha = w.abs().mean(0).to(x.dtype)               # [d_out]
    if _SERVING.get() is not None:
        wb_bits = kops.sign_bits(w).T                  # [d_out, d_in]
        y = _drim_gemm(x, wb_bits).to(x.dtype) * alpha
    else:
        # The ±1 dot in float32 (every partial sum an integer below 2**24,
        # so exact whatever the summation order), rounded once to x.dtype
        # as the integer routes round it.  A bfloat16 product could
        # reduce split-K partial sums in bfloat16 on the card and round
        # the same integer differently.
        wb = _ste_sign(w).to(torch.float32)
        xb = _ste_sign(x.to(torch.float32))
        y = (xb @ wb).to(x.dtype) * alpha
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def row_alpha(rows: torch.Tensor, d_in: int, mesh) -> torch.Tensor:
    """alpha [d_out] of a BitLinear whose rows [d_in / |model|, d_out] are
    cut over the model group: sum|w| in float64 over the group, divided
    by d_in, rounded once to the weights' dtype."""
    total = reduce_from_model(rows.abs().to(torch.float64).sum(0), mesh)
    return (total / d_in).to(rows.dtype)


def pack_bitlinear_rows(params: Params, mesh) -> Params:
    """`pack_bitlinear` of a row-parallel layer's shadow weights [..., d_in
    / |model|, d_out] (this rank's rows; stacked ones layer by layer) into
    the packed spec's block, cut over d_out: the rows gathered over the
    model group, the rank's output columns packed over the whole d_in,
    alpha the row product's (`row_alpha`), so the packed and the shadow
    products agree bit for bit."""
    w = params["bkernel"].detach()
    if w.dim() > 2:
        return tree_stack([pack_bitlinear_rows(tree_slice(params, i), mesh)
                           for i in range(w.shape[0])])
    index, m = model_coord(mesh)
    d_in, d_out = w.shape[0] * m, w.shape[1]
    if d_out % m:
        raise ValueError(f"{d_out} output features do not divide a model "
                         f"axis of {m}")
    lo, hi = index * d_out // m, (index + 1) * d_out // m
    whole = gather_from_model(w, mesh, 0)
    out = {"w_packed": kops.pack_signs(whole[:, lo:hi].T.contiguous()),
           "alpha": row_alpha(w, d_in, mesh)[lo:hi],
           "k_bits": int(d_in)}
    if "bias" in params:
        b = params["bias"].detach()
        out["bias"] = b if b.shape[0] != d_out else b[lo:hi]
    return out


def pack_bitlinear(params: Params) -> Params:
    """Dense shadow weights -> packed serving weights: w_packed [d_out,
    ceil(d_in/32)] int32 sign words, alpha [d_out], k_bits = d_in.

    Scan-stacked leaves ([L, d_in, d_out]) pack layer by layer, so each
    layer's alpha is the very reduction `bitlinear` computes on that
    layer's slice, bit for bit."""
    w = params["bkernel"].detach()                    # [..., d_in, d_out]
    if w.dim() > 2:
        return tree_stack([pack_bitlinear(tree_slice(params, i))
                           for i in range(w.shape[0])])
    out = {
        "w_packed": kops.pack_signs(w.T.contiguous()),
        "alpha": w.abs().mean(0),
        "k_bits": int(w.shape[0]),
    }
    if "bias" in params:
        out["bias"] = params["bias"].detach()
    return out


def bitlinear_packed(packed: Params, x: torch.Tensor,
                     k_bits: int) -> torch.Tensor:
    """Serving path: activations sign-packed on the fly, weights stay
    bit-packed.  Inside a `serving_engine` scope the packed words are
    unpacked to sign bits and the GEMM runs on the DRIM fleet instead of
    the XNOR-popcount kernel."""
    if _SERVING.get() is not None:
        wb_bits = kops.unpack_sign_bits(packed["w_packed"], k_bits)
        y = _drim_gemm(x, wb_bits).to(x.dtype)
    else:
        y = kops.binary_matmul(x, packed["w_packed"], k_bits, dtype=x.dtype)
    y = y * packed["alpha"].to(x.dtype)
    if "bias" in packed:
        y = y + packed["bias"].to(x.dtype)
    return y


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype=torch.float32,
                bitlinear_on: bool = False) -> Params:
    return (bitlinear_init if bitlinear_on else dense_init)(
        gen, d_in, d_out, bias=bias, dtype=dtype)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "bkernel" in params:
        return bitlinear(params, x)
    if "w_packed" in params:
        # the activation's feature dim is the reduction width
        return bitlinear_packed(params, x, x.shape[-1])
    return dense(params, x)


# --- Megatron's column- and row-parallel products ----------------------------

def _whole(t: torch.Tensor, shape, mesh) -> torch.Tensor:
    """The whole leaf of `shape` from this rank's block `t` (cut over
    "model" on at most one dim), for a use in which each rank takes its
    own part: gathered where cut, and its gradient summed over the
    model group."""
    cut = [d for d, (a, b) in enumerate(zip(t.shape, shape)) if a != b]
    if len(cut) > 1 or (cut and t.shape[cut[0]] * model_coord(mesh)[1]
                        != shape[cut[0]]):
        raise ValueError(f"a block {tuple(t.shape)} of a leaf "
                         f"{tuple(shape)} is not a model-axis cut")
    if cut:
        t = gather_from_model(t, mesh, cut[0])
    return copy_to_model(t, mesh)


def part_of(t: torch.Tensor, shape, dim: int, lo: int, hi: int, mesh
            ) -> torch.Tensor:
    """Elements [lo, hi) along `dim` of the leaf of `shape` whose block
    this rank holds as `t`: the block itself where the leaf is cut there
    into exactly that block, else a slice of the whole leaf."""
    index, m = model_coord(mesh)
    width = shape[dim] // m
    if t.shape[dim] * m == shape[dim] \
            and tuple(t.shape[:dim]) + tuple(t.shape[dim + 1:]) \
            == tuple(shape[:dim]) + tuple(shape[dim + 1:]) \
            and (lo, hi) == (index * width, (index + 1) * width):
        return t
    return _whole(t, shape, mesh).narrow(dim, lo, hi - lo)


def _bias_part(params: Params, d_out: int, lo: int, hi: int, mesh):
    return ({"bias": part_of(params["bias"], (d_out,), 0, lo, hi, mesh)}
            if "bias" in params else {})


def linear_col(params: Params, x: torch.Tensor, d_out: int,
               lo: Optional[int] = None, hi: Optional[int] = None
               ) -> torch.Tensor:
    """Column-parallel `linear` of a [d_in, d_out] layer (packed: [d_out,
    W]): the replicated input x [..., d_in] against output columns [lo,
    hi) (default: this rank's block of d_out / |model|), [..., hi - lo].
    The caller passes x through `copy_to_model`.  `linear` with no model
    axis over ranks."""
    mesh = model_ranks()
    if mesh is None:
        return linear(params, x)
    index, m = model_coord(mesh)
    if lo is None:
        if d_out % m:
            raise ValueError(f"{d_out} output features do not divide a "
                             f"model axis of {m}")
        lo, hi = index * d_out // m, (index + 1) * d_out // m
    d_in = x.shape[-1]
    if "w_packed" in params:
        w = params["w_packed"]
        packed = {"w_packed": part_of(w, (d_out, w.shape[-1]), 0, lo, hi,
                                      mesh),
                  "alpha": part_of(params["alpha"], (d_out,), 0, lo, hi,
                                   mesh),
                  **_bias_part(params, d_out, lo, hi, mesh)}
        return bitlinear_packed(packed, x, d_in)
    key = "bkernel" if "bkernel" in params else "kernel"
    cols = {key: part_of(params[key], (d_in, d_out), 1, lo, hi, mesh),
            **_bias_part(params, d_out, lo, hi, mesh)}
    return bitlinear(cols, x) if key == "bkernel" else dense(cols, x)


# the sequence dim of the [B, S, ...] activations a sequence cut holds
SEQ_DIM = 1


def row_sum(part: torch.Tensor, mesh, dtype=None) -> torch.Tensor:
    """A row-parallel product's partials summed over the model group in
    float32 and rounded once to `dtype` (default: part's): the whole sum
    on every rank, or inside a `sequence_cut` the rank's block of the
    sequence (a reduce-scatter)."""
    dtype = part.dtype if dtype is None else dtype
    if sequence_ranks() is not None:
        return reduce_scatter_to_sequence(part.to(torch.float32), mesh,
                                          SEQ_DIM, dtype)
    return reduce_from_model(part.to(torch.float32), mesh).to(dtype)


def linear_row(params: Params, x: torch.Tensor, d_in: int, d_out: int
               ) -> torch.Tensor:
    """Row-parallel `linear` of a [d_in, d_out] layer: x [..., d_in /
    |model|] is this rank's block of the input features, the result
    [..., d_out] the whole output on every rank (inside a `sequence_cut`
    the rank's block of the sequence).  Shadow and dense weights: the
    rank's rows, the partial products summed over the model group in
    float32 and rounded once to x's dtype (`row_sum`).  Packed weights
    (cut over d_out): x gathered over the group, the rank's output
    columns, gathered (and cut to the block: every rank holds the whole).
    alpha and a bias act on the result, through `copy_to_model` inside a
    sequence cut, where each rank's gradient of them is its block's.
    `linear` with no model axis over ranks."""
    mesh = model_ranks()
    if mesh is None:
        return linear(params, x)
    index, m = model_coord(mesh)
    if x.shape[-1] * m != d_in:
        raise ValueError(f"a row-parallel input of {x.shape[-1]} features "
                         f"is not a block of {d_in} over {m} ranks")
    cut = sequence_ranks() is not None
    if "w_packed" in params:
        x_all = gather_from_model(x, mesh, -1)
        if params["w_packed"].shape[0] == d_out:     # replicated
            y = bitlinear_packed(params, x_all, d_in)
        else:
            y = gather_from_model(linear_col(params, x_all, d_out), mesh, -1)
        return scatter_to_model(y, mesh, SEQ_DIM) if cut else y
    lo, hi = index * x.shape[-1], (index + 1) * x.shape[-1]
    key = "bkernel" if "bkernel" in params else "kernel"
    rows = part_of(params[key], (d_in, d_out), 0, lo, hi, mesh)
    if key == "kernel":
        part = x.to(torch.float32) @ rows.to(x.dtype).to(torch.float32)
        y = row_sum(part, mesh, x.dtype)
    else:
        dot, alpha = row_bitlinear_parts(rows, x, d_in, mesh)
        if cut:         # the block's share of alpha's gradient
            alpha = copy_to_model(alpha, mesh)
        y = dot.to(x.dtype) * alpha.to(x.dtype)
    if "bias" in params:
        b = params["bias"]
        b = b if b.shape[0] == d_out else gather_from_model(b, mesh, 0)
        y = y + (copy_to_model(b, mesh) if cut else b).to(x.dtype)
    return y


def row_bitlinear_parts(rows: torch.Tensor, x: torch.Tensor, d_in: int,
                        mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the ±1 dot [..., d_out] float32 (`row_sum`: inside a
    `sequence_cut` the rank's block of the sequence), alpha [d_out] in the
    weights' dtype) of a row-parallel BitLinear from this rank's rows
    [d_in / |model|, d_out] and input block x: each rank's partial dot is an
    integer below 2**24 in float32 (from the DRIM fleet inside a
    `serving_engine` scope), so their sum over the model group is the
    one-process dot exactly; alpha = mean|w| over the whole d_in from the
    group's sum of |w|, in float64 and rounded once: the correctly rounded
    mean.  (The one-process float32 `mean` is not: it sums in its own
    order, up to 3 float32 ulps from the exact mean at these widths, and
    no split of the rows can repeat that order.)"""
    alpha = row_alpha(rows, d_in, mesh)
    if _SERVING.get() is not None:
        part = _drim_gemm(x, kops.sign_bits(rows).T).to(torch.float32)
    else:
        part = _ste_sign(x.to(torch.float32)) \
            @ _ste_sign(rows).to(torch.float32)
    return row_sum(part, mesh), alpha


# --- rotary embeddings -------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, d_head]; positions [..., S] (int)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [d/2]
    angles = positions[..., None].to(torch.float32) * freqs    # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --- gated MLP (SwiGLU) ------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             dtype=torch.float32, bitlinear_on: bool = False) -> Params:
    return {
        "gate": linear_init(gen, d_model, d_ff, dtype=dtype,
                            bitlinear_on=bitlinear_on),
        "up": linear_init(gen, d_model, d_ff, dtype=dtype,
                          bitlinear_on=bitlinear_on),
        "down": linear_init(gen, d_ff, d_model, dtype=dtype,
                            bitlinear_on=bitlinear_on),
    }


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * logistic(x) with logistic as 1 / (1 + exp(-x)), each op rounded
    to x's dtype: the reference's `jax.nn.silu` as XLA computes it, bit
    for bit in bfloat16 on the CPU (torch's fused SiLU rounds once and
    differs in the last bit of ~40 % of bfloat16 values).  In float32 it
    is within 3 ulps of XLA's (equal on 96 % of values)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def mlp(params: Params, x: torch.Tensor, d_ff: Optional[int] = None
        ) -> torch.Tensor:
    """The SwiGLU MLP; under a model axis over ranks (`d_ff` given, x
    through `copy_to_model`) gate and up are column-parallel and down is
    row-parallel."""
    if d_ff is None or model_ranks() is None:
        return linear(params["down"], silu(linear(params["gate"], x))
                      * linear(params["up"], x))
    h = silu(linear_col(params["gate"], x, d_ff)) \
        * linear_col(params["up"], x, d_ff)
    return linear_row(params["down"], h, d_ff, x.shape[-1])


class BitLinear(nn.Module):
    """d_in -> d_out BitLinear holding either dense shadow weights
    (`bkernel`, a trainable Parameter) or packed serving weights
    (`w_packed` and `alpha` buffers, with `k_bits`)."""

    def __init__(self, *, bkernel: Optional[torch.Tensor] = None,
                 w_packed: Optional[torch.Tensor] = None,
                 alpha: Optional[torch.Tensor] = None,
                 k_bits: Optional[int] = None,
                 bias: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        if (bkernel is None) == (w_packed is None):
            raise ValueError("give either bkernel or w_packed/alpha/k_bits")
        if bkernel is not None:
            self.bkernel = nn.Parameter(bkernel)
            self.k_bits = int(bkernel.shape[0])
            self.register_buffer("w_packed", None)
            self.register_buffer("alpha", None)
        else:
            if alpha is None or k_bits is None:
                raise ValueError("packed weights need alpha and k_bits")
            self.bkernel = None
            self.register_buffer("w_packed", w_packed)
            self.register_buffer("alpha", alpha)
            self.k_bits = int(k_bits)
        self.bias = nn.Parameter(bias) if bias is not None else None

    def _params(self) -> Params:
        if self.bkernel is not None:
            p: Params = {"bkernel": self.bkernel}
        else:
            p = {"w_packed": self.w_packed, "alpha": self.alpha}
        if self.bias is not None:
            p["bias"] = self.bias
        return p

    def pack(self) -> "BitLinear":
        """A packed serving copy of a dense layer."""
        if self.bkernel is None:
            raise ValueError("layer is already packed")
        return BitLinear(**pack_bitlinear(self._params()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bkernel is not None:
            return bitlinear(self._params(), x)
        return bitlinear_packed(self._params(), x, self.k_bits)


def bitlinear_from_jax(params: Params, *, device=None) -> BitLinear:
    """A dense BitLinear from the reference's numpy parameters
    {"bkernel": [d_in, d_out], "bias"?}."""
    dev = resolve_device(device)
    w = torch.from_numpy(np.asarray(params["bkernel"], np.float32).copy())
    bias = params.get("bias")
    return BitLinear(
        bkernel=w.to(dev),
        bias=(torch.from_numpy(np.asarray(bias, np.float32).copy()).to(dev)
              if bias is not None else None))


def packed_from_jax(packed: Params, *, device=None) -> BitLinear:
    """A packed BitLinear from the reference's `pack_bitlinear` output
    {"w_packed": [d_out, W] uint32, "alpha": [d_out], "k_bits", "bias"?}."""
    dev = resolve_device(device)
    bias = packed.get("bias")
    return BitLinear(
        w_packed=as_words(np.asarray(packed["w_packed"]), dev),
        alpha=torch.from_numpy(np.asarray(packed["alpha"],
                                          np.float32).copy()).to(dev),
        k_bits=int(np.asarray(packed["k_bits"])),
        bias=(torch.from_numpy(np.asarray(bias, np.float32).copy()).to(dev)
              if bias is not None else None))
