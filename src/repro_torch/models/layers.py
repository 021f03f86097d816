"""BitLinear, the paper's technique as a layer (port of the BitLinear part
of `repro.models.layers`).

Weights are sign-binarized with a per-output-channel scale alpha =
mean|w| (XNOR-Net).  Training uses a straight-through estimator over the
dense shadow weights (`bitlinear`); serving runs from bit-packed weights
through the XNOR-popcount kernel (`bitlinear_packed`), or -- inside a
`serving_engine(...)` scope -- through the DRIM fleet simulation
(`pim.bnn.serve_bnn_matmul`).  The JAX layout is kept: shadow weights
are [d_in, d_out], packed weights [d_out, ceil(d_in/32)].

Every route computes the exact integer dot first, then `.to(x.dtype)`,
then `* alpha.to(x.dtype)`, then the bias, in the reference's order, so
the routes agree bit for bit.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.subarray import as_words
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

Params = Dict[str, Any]

# (engine, geometry) of the active DRIM serving scope, or None for the
# native packed-kernel path.
_SERVING: contextvars.ContextVar[Optional[Tuple[str, Any]]] = \
    contextvars.ContextVar("repro_torch_serving_engine", default=None)


@contextlib.contextmanager
def serving_engine(engine: Optional[str] = None, *, geom=None):
    """Route BitLinear matmuls through the DRIM pipeline for the scope.

    `engine` is a `pim.compiler.ENGINE_REGISTRY` name ("resident",
    "cuda"); None keeps the native packed-kernel path.  The fleet runs on
    the activations' device."""
    if engine is not None:
        from repro_torch.pim.compiler import get_engine
        get_engine(engine)                  # fail fast on unknown names
    token = _SERVING.set((engine, geom) if engine is not None else None)
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
    engine, geom = _SERVING.get()
    lead = x.shape[:-1]
    xb = kops.sign_bits(x.to(torch.float32)).reshape(-1, x.shape[-1])
    dot = serve_bnn_matmul(xb, wb_bits, engine=engine, geom=geom,
                           device=x.device)
    return dot.reshape(*lead, wb_bits.shape[0])


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
        wb = _ste_sign(w).to(x.dtype)
        xb = _ste_sign(x.to(torch.float32)).to(x.dtype)
        y = (xb @ wb) * alpha
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def pack_bitlinear(params: Params) -> Params:
    """Dense shadow weights -> packed serving weights: w_packed [d_out,
    ceil(d_in/32)] int32 sign words, alpha [d_out], k_bits = d_in."""
    w = params["bkernel"].detach()                    # [d_in, d_out]
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
