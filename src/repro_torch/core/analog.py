"""Analog model of the DRIM sense amplifier and the Table-3 Monte-Carlo
(port of `repro.core.analog`).

  * Charge sharing of k activated cells with the precharged bit-line:
        V_BL = (sum_i C_i V_i + C_BL Vdd/2) / (sum_i C_i + C_BL)
  * DRA senses the isolated node (a small residual C_BL) with two
    shifted-VTC inverters: NOR at Vs_low ~ Vdd/4, NAND at Vs_high ~ 3Vdd/4,
    XOR = NAND & ~NOR, XNOR its complement.
  * TRA (Ambit) senses MAJ3 on the regular bit-line against Vdd/2, the
    full bit-line capacitance sharing the charge (an ~87 mV margin).
  * A "+-p" corner scales each component X0 to X0 (1 + U(-p, +p)), the
    shifted-VTC inverters' thresholds by `vs_vtc_gain` x p; an 8 mV
    normal noise floor is added to the sensed voltage.

PAPER_TABLE3[variation] = {"TRA": %, "DRA": %}: the paper's share of
triple- and dual-row activations that latch a wrong bit at a corner.

Draws come from `core.prng`, the twin of `jax.random`.  The arithmetic
follows the reference's Monte-Carlo as XLA compiles it for the CPU: a
chain of multiplies by constants is one multiply by their float32
product (`_c`), and a multiply whose only use is an add is fused into it
(`prng.fma`, rounded once).  Every other operation is one float32
operation in the reference's order, so the Monte-Carlo gives the
reference's error counts exactly, on the CPU or on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

from . import prng


@dataclasses.dataclass(frozen=True)
class AnalogParams:
    vdd: float = 1.2            # 45nm NCSU PDK class supply
    c_cell: float = 22e-15      # DRAM storage cap (Rambus model class), F
    c_bl_full: float = 85e-15   # full bit-line parasitic (512-cell BL), F
    c_bl_residual: float = 1.5e-15  # parasitic left on the isolated sense node, F
    vs_low: float = 0.25        # low-Vs inverter threshold, x Vdd
    vs_high: float = 0.75       # high-Vs inverter threshold, x Vdd
    vs_sa: float = 0.5          # regular SA switching threshold, x Vdd
    vs_vtc_gain: float = 2.0    # dual-Vth VTC inverters: Vs spread multiplier
    # Additive sense-node noise floor (coupling: Cwbl / Ccross, Fig. 7).
    noise_mv: float = 8.0


DEFAULT = AnalogParams()

# the float32 just above -1, the low end of `prng.normal`'s uniform
_NORMAL_LO = prng._f32(0xBF7FFFFF)


def _c(*factors: float) -> float:
    """The float32 constant XLA folds a chain of multiplies into: each
    factor in float32, the product rounded after each step."""
    out = np.float32(factors[0])
    for f in factors[1:]:
        out = np.float32(out * np.float32(f))
    return float(out)


def _factor(key, frac, shape):
    """1 + U(-frac, +frac): a corner's multiplier of a nominal value."""
    return prng.uniform(key, shape, -frac, frac) + 1.0


def _perturb(key, nominal, frac, shape):
    """Uniform +-frac corner: X0 * (1 + U(-frac, +frac))."""
    return _factor(key, frac, shape) * _c(nominal)


def _noise_scaled(key, shape) -> torch.Tensor:
    """erf_inv of `normal`'s uniform: the normal before its sqrt(2), which
    the compiled reference folds into the noise amplitude."""
    return prng.erf_inv(prng.uniform(key, shape, _NORMAL_LO, 1.0))


def _share(v_terms: Sequence[torch.Tensor], caps: Sequence[torch.Tensor],
           bl: torch.Tensor, bl_num: float, bl_den: float) -> torch.Tensor:
    """Charge sharing of the cells (index order) with a bit-line of
    capacitance bl * bl_den precharged to bl_num / bl_den."""
    charge = caps[0] * v_terms[0]
    cap = caps[0]
    for c, v in zip(caps[1:], v_terms[1:]):
        charge = prng.fma(c, v, charge)
        cap = cap + c
    num = prng.fma(bl, torch.full_like(bl, bl_num), charge)
    return num / prng.fma(bl, torch.full_like(bl, bl_den), cap)


def charge_share_voltage(cell_voltages: torch.Tensor,
                         cell_caps: torch.Tensor, c_bl: torch.Tensor,
                         vdd: float) -> torch.Tensor:
    """V after charge sharing k cells (last axis) with the precharged BL."""
    return _share(cell_voltages.unbind(-1), cell_caps.unbind(-1), c_bl,
                  _c(vdd / 2.0), 1.0)


def _xnor_xor(v, lo_thresh, hi_thresh):
    nor_ = v < lo_thresh
    nand_ = v < hi_thresh
    xor_ = nand_ & ~nor_
    return (~xor_).to(torch.int32), xor_.to(torch.int32)


def dra_sense(v: torch.Tensor, p: AnalogParams, vs_low, vs_high):
    """Reconfigurable-SA outputs (xnor_on_bl, xor_on_blbar) as {0,1} int32
    for a sense-node voltage `v` (Fig. 4b): NOR = v < Vs_low,
    NAND = v < Vs_high, XOR = NAND & ~NOR."""
    return _xnor_xor(v, vs_low * _c(p.vdd), vs_high * _c(p.vdd))


def _key(key, device):
    return prng.PRNGKey(0, device=device) if key is None else key


def dra_analog(a_bits: torch.Tensor, b_bits: torch.Tensor, key=None,
               variation: float = 0.0, p: AnalogParams = DEFAULT):
    """Full analog DRA on {0,1} bit tensors at a +-variation corner.

    En_C isolates the sense node from the heavy bit-line, so only the two
    cell caps plus a small residual drive the shifted-VTC inverters.
    Returns (xnor, xor) as {0,1} int32."""
    a, b = a_bits.to(torch.float32), b_bits.to(torch.float32)
    shape = tuple(a.shape)
    k = prng.split(_key(key, a.device), 8)
    c_a = _perturb(k[0], p.c_cell, variation, shape)
    c_b = _perturb(k[1], p.c_cell, variation, shape)
    f_bl = _factor(k[2], variation, shape)
    vs_frac = _c(variation, p.vs_vtc_gain)
    f_low = _factor(k[3], vs_frac, shape)
    f_high = _factor(k[4], vs_frac, shape)
    # stored charge level also varies (write driver + retention)
    v_a = a * _perturb(k[5], p.vdd, variation, shape)
    v_b = b * _perturb(k[6], p.vdd, variation, shape)
    v = _share((v_a, v_b), (c_a, c_b), f_bl,
               _c(p.c_bl_residual, p.vdd / 2.0), _c(p.c_bl_residual))
    v = prng.fma(_noise_scaled(k[7], shape),
                 torch.full_like(v, _c(p.noise_mv * 1e-3, math.sqrt(2))), v)
    return _xnor_xor(v, f_low * _c(p.vs_low, p.vdd),
                     f_high * _c(p.vs_high, p.vdd))


def tra_analog(a_bits, b_bits, c_bits, key=None, variation: float = 0.0,
               p: AnalogParams = DEFAULT) -> torch.Tensor:
    """Analog TRA (Ambit §2.1): MAJ3 sensed against the Vdd/2 SA threshold,
    the full bit-line parasitic sharing the charge.  {0,1} int32."""
    bits = [t.to(torch.float32) for t in (a_bits, b_bits, c_bits)]
    shape = tuple(bits[0].shape)
    k = prng.split(_key(key, bits[0].device), 9)
    caps = [_perturb(k[i], p.c_cell, variation, shape) for i in range(3)]
    f_bl = _factor(k[3], variation, shape)
    f_sa = _factor(k[4], variation, shape)
    v_abc = [x * _perturb(k[5 + i], p.vdd, variation, shape)
             for i, x in enumerate(bits)]
    v = _share(v_abc, caps, f_bl, _c(p.c_bl_full, p.vdd / 2.0),
               _c(p.c_bl_full))
    v = prng.fma(_noise_scaled(k[8], shape),
                 torch.full_like(v, _c(p.noise_mv * 1e-3, math.sqrt(2))), v)
    return (v > f_sa * _c(p.vs_sa, p.vdd)).to(torch.int32)


# ---------------------------------------------------------------------------
# Table-3 Monte-Carlo reproduction
# ---------------------------------------------------------------------------

def percent(wrong: int, trials: int) -> float:
    """The Monte-Carlo's percentage for `wrong` of `trials` results: the
    float32 count times the float32 constant (1 / trials) x 100, as the
    compiled reference computes its mean x 100."""
    return float(np.float32(wrong) *
                 np.float32(_c(np.float32(1.0) / np.float32(trials), 100.0)))


def monte_carlo_error_rates(trials: int = 10_000,
                            variations=(0.05, 0.10, 0.15, 0.20, 0.30),
                            seed: int = 0, p: AnalogParams = DEFAULT, *,
                            device=None) -> Dict[float, Dict[str, float]]:
    """Percentage of erroneous DRA / TRA results across `trials` trials at
    each corner (corner i draws from fold_in(PRNGKey(seed), i)), on
    `device` (None: the card).

    Each trial draws one random input combination and one process corner
    sample, mirroring the paper's 10k-trial Cadence Spectre MC (§3.3)."""
    key = prng.PRNGKey(seed, device=resolve_device(device))
    out = {}
    for i, var in enumerate(variations):
        ka, kb, kc, kd, ke = prng.split(prng.fold_in(key, i), 5)
        a, b, c = (prng.bernoulli(k_, 0.5, (trials,)).to(torch.int32)
                   for k_ in (ka, kb, kc))
        var32 = float(np.float32(var))
        xnor_, _ = dra_analog(a, b, kd, var32, p)
        maj_ = tra_analog(a, b, c, ke, var32, p)
        dra_wrong = int((xnor_ != 1 - (a ^ b)).sum())
        tra_wrong = int((maj_ != ((a & b) | (a & c) | (b & c))).sum())
        out[var] = {"DRA": percent(dra_wrong, trials),
                    "TRA": percent(tra_wrong, trials)}
    return out


# Paper Table 3 reference values (percent error at each +-variation).
PAPER_TABLE3 = {
    0.05: {"TRA": 0.00, "DRA": 0.00},
    0.10: {"TRA": 0.18, "DRA": 0.00},
    0.15: {"TRA": 5.5, "DRA": 1.2},
    0.20: {"TRA": 17.1, "DRA": 9.6},
    0.30: {"TRA": 28.4, "DRA": 16.4},
}
