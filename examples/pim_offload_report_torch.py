"""PIM-offload codesign report on PyTorch and one CUDA card (the torch
twin of `examples/pim_offload_report.py`): which bulk bit-wise payloads
belong in the memory fleet, priced against the card.

    PYTHONPATH=src python examples/pim_offload_report_torch.py   # on the card
    PYTHONPATH=src python examples/pim_offload_report_torch.py --device cpu

For every architecture the port registers (drim-bnn, the dense, vlm,
MoE, SSM, hybrid and audio archs), prices the framework's own
bulk-bitwise payloads (BitLinear weight sign-planes, 1-bit EF gradient
reduction, sign-plane copies) through the staged pipeline -- one
`drim.compile(op).lower().verdict(n_bits)` per payload, every contender
priced with the same `VerdictRow` fields -- and prints the placement
verdict.  The comparator is the card's roofline (the "GPU" row: an H100
SXM at 700 W), where the reference prices a TPU.

The fused-graph section prices whole dataflow graphs (the BNN XNOR ->
popcount-accumulate chain) the same way.  A cross-check section re-prices
one lowering with `simulate=True` (the AAP streams actually run on the
simulated fleet, on `--device`) and the numbers must not move.
"""
import argparse

import numpy as np
import torch

import drim_torch as drim
from repro_torch.configs import get_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core import DrimGeometry
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import pack_signs_ref, xnor_gemm_ref
from repro_torch.pim.bnn import bnn_dot_drim, bnn_dot_graph
from repro_torch.pim.offload import plan_model_payloads


def drim_row(v: drim.Verdict) -> drim.VerdictRow:
    return next(r for r in v.rows if r.contender.startswith("DRIM"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"{'arch':<18}{'payload':<26}{'bits':>10}{'DRIM':>11}"
          f"{'GPU':>11}{'speedup':>9}  winner")
    for arch in ARCHS:
        cfg = get_config(arch)
        for name, v in plan_model_payloads(cfg).items():
            dr, gpu = drim_row(v), v.row("GPU")
            print(f"{arch:<18}{name:<26}{v.n_bits:>10.2e}"
                  f"{dr.latency_s * 1e3:>9.2f}ms"
                  f"{gpu.latency_s * 1e3:>9.2f}ms"
                  f"{gpu.latency_s / max(dr.latency_s, 1e-30):>9.2f}"
                  f"  {v.winner}")

    print("\n-- locality sensitivity (1 Gbit xnor2) --")
    v = drim.compile("xnor2").lower().verdict(2 ** 30)
    dr, gpu = drim_row(v), v.row("GPU")
    # staging operands through the host adds the boundary traffic the
    # in-DRAM premise avoids -- the same bytes the GPU row already prices
    # as its HBM DMA time, so reuse that figure as the staging penalty
    staged = dr.latency_s + gpu.dma_s
    print(f"operands_in_dram=True   DRIM {dr.latency_s * 1e3:7.3f} ms "
          f"vs GPU {gpu.latency_s * 1e3:7.3f} ms -> {v.winner}")
    print(f"operands_in_dram=False  DRIM {staged * 1e3:7.3f} ms "
          f"vs GPU {gpu.latency_s * 1e3:7.3f} ms -> "
          f"{'DRIM' if staged < gpu.latency_s else 'GPU'}")

    print(f"\n-- closed-form schedule vs simulated execution (1 Mbit, "
          f"on {dev.type}) --")
    for op in ("xnor2", "add"):
        low = drim.compile(op).lower()
        ana = low.cost(2 ** 20)
        sim = low.verdict(2 ** 20, simulate=True, device=dev)
        measured = low.schedule               # set by the simulated run
        dev_frac = measured.latency_s / ana.latency_s - 1.0
        print(f"{op:<7} schedule {ana.latency_s * 1e6:7.2f} us  "
              f"simulated {measured.latency_s * 1e6:7.2f} us  "
              f"dev {dev_frac:+.2%}  (tiles={measured.tiles}, "
              f"waves={measured.waves}, "
              f"active={measured.active_subarrays}, "
              f"occupancy={measured.occupancy:.0%}, "
              f"simulated={sim.simulated})")

    print("\n-- fused dataflow graphs: BNN XNOR->popcount-accumulate "
          "(2^27-bit planes) --")
    print(f"{'K':>4}{'nodes':>7}{'fused':>10}{'unfused':>10}{'GPU':>10}"
          f"{'x unfused':>10}{'energy x':>9}  winner")
    for k in (8, 32, 128):
        v = drim.compile(bnn_dot_graph(k)).lower().verdict(2 ** 27)
        fused = v.row("DRIM-fused")
        unfused = v.row("DRIM-unfused")
        gpu = v.row("GPU")
        print(f"{k:>4}{v.n_nodes:>7}"
              f"{fused.latency_s * 1e3:>8.2f}ms"
              f"{unfused.latency_s * 1e3:>8.2f}ms"
              f"{gpu.latency_s * 1e3:>8.2f}ms"
              f"{v.speedup('DRIM-fused', 'DRIM-unfused'):>10.3f}"
              f"{unfused.energy_j / fused.energy_j:>9.2f}"
              f"  {v.winner}")

    print("\n-- fused BNN dot-product executed on the simulated fleet --")
    rng = np.random.default_rng(42)
    m, n, k = 4, 5, 8
    a_bits = rng.integers(0, 2, (m, k)).astype(np.uint8)
    b_bits = rng.integers(0, 2, (n, k)).astype(np.uint8)
    geom = DrimGeometry(chips=1, banks=2, subarrays_per_bank=2,
                        row_bits=32)
    c, sched = bnn_dot_drim(a_bits, b_bits, geom=geom, device=dev)
    ap_ = torch.from_numpy(np.where(a_bits, 1.0, -1.0).astype(np.float32))
    bp_ = torch.from_numpy(np.where(b_bits, 1.0, -1.0).astype(np.float32))
    pad = torch.nn.functional.pad
    ref = xnor_gemm_ref(pack_signs_ref(pad(ap_, (0, 32 - k), value=-1.0)),
                        pack_signs_ref(pad(bp_, (0, 32 - k), value=-1.0)), k)
    exact = bool(torch.equal(c.cpu(), ref))
    print(f"{m}x{n} dot products, K={k}: bit-exact={exact}; "
          f"{sched.aaps_sequential} fused AAP cycles vs "
          f"{sched.unfused_aaps_sequential} unfused, "
          f"{sched.ddr_rows_moved} DDR rows vs "
          f"{sched.unfused_ddr_rows_moved}")
    if not exact:
        raise SystemExit("the fleet's dots differ from xnor_gemm_ref")

    print("\nVerdict: PIM wins when operands already live in DRAM and the"
          "\nresult stays there; staging through the host erases the win --"
          "\nand fusing whole graphs keeps intermediates resident, so the"
          "\nwin compounds with chain depth.")


if __name__ == "__main__":
    main()
