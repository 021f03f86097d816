"""Table-3 fault injection on the serving dot: bare, ECC- and TMR-hardened.

The carry-save BNN dot of one serving K chunk (`bnn_dot_graph_carrysave(
128)`) runs on the DRIM-R fleet, 4 waves of word columns from
`np.random.default_rng(0)`, under the paper's Table-3 corner
(`FaultModel.from_corner(0.15, source="paper")`: 1.2% of DRAs and 5.5% of
TRAs flip one bit) for each harden scheme on the "resident" engine, and
prints one JSON line per scheme: AAPs per tile, the bits that differ from
the clean numpy oracle (`graph_ref_results`) and the ECC parity mismatch
bits.  `chip_smoke.py`'s faults phase runs the same payload on the card.

Flips are a pure hash of (seed, op index, global slot), so the counts are
deterministic: any engine on any device gives the same ones.

    PYTHONPATH=src python -m repro_torch.launch.faults [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from repro_torch.core import DRIM_R, FaultModel
from repro_torch.core.subarray import WORD_BITS
from repro_torch.device import resolve_device
from repro_torch.pim.bnn import bnn_dot_graph_carrysave
from repro_torch.pim.compiler import compile
from repro_torch.pim.graph import BulkGraph, graph_ref_results

K_BITS = 128                 # the serving chunk (`pim.bnn.k_chunks`)
WAVES = 4                    # waves of DRIM-R word columns per plane
SEED = 0                     # feeds and fault stream
CORNER = 0.15                # Table-3 process-variation corner
SCHEMES = (None, "ecc", "tmr", "tmr+ecc")
# (corrupted bits, ECC mismatch bits) of each scheme at this payload, as
# this CLI first printed them on the CPU and an H100 then repeated them;
# flips are a pure hash, so any other count is a fault of the port
EXPECTED = {None: (801_291, None), "ecc": (794_487, 480_804),
            "tmr": (382, None), "tmr+ecc": (368, 264)}


def fault_feeds(graph: BulkGraph, n_words: int,
                seed: int = SEED) -> Dict[str, np.ndarray]:
    """Random uint32 input planes from `np.random.default_rng(seed)`, in
    the graph's input order; the constant plane "zero" is all zeros."""
    rng = np.random.default_rng(seed)
    return {n: (np.zeros(n_words, np.uint32) if n == "zero"
                else rng.integers(0, 1 << 32, n_words, dtype=np.uint32))
            for n in graph.input_names}


def corrupted_bits(outs, oracle: Dict[str, np.ndarray]) -> int:
    """Bits of the outputs that differ from the oracle's."""
    total = 0
    for name, want in oracle.items():
        got = outs[name]
        got = (got.cpu().numpy() if isinstance(got, torch.Tensor)
               else np.asarray(got)).view(np.uint32)
        total += int(np.unpackbits((got ^ want).view(np.uint8)).sum())
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs plain torch")
    dev = resolve_device(ap.parse_args(argv).device)
    graph, _ = bnn_dot_graph_carrysave(K_BITS)
    n_words = WAVES * DRIM_R.n_subarrays * DRIM_R.row_bits // WORD_BITS
    feeds = fault_feeds(graph, n_words)
    oracle = graph_ref_results(graph, feeds)
    faults = FaultModel.from_corner(CORNER, source="paper", seed=SEED)
    for scheme in SCHEMES:
        low = compile(graph, geom=DRIM_R).lower("resident", harden=scheme)
        t0 = time.perf_counter()
        outs = low.run(feeds, device=dev, faults=faults)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(json.dumps({
            "scheme": scheme or "none", "device": str(dev),
            "k_bits": K_BITS, "words": n_words, "aaps_per_tile": low.aaps,
            "corrupted_bits": corrupted_bits(outs, oracle),
            "ecc_mismatch_bits": (low.last_ecc.mismatch_bits
                                  if low.last_ecc is not None else None),
            "run_s": secs}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
