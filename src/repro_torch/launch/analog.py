"""The paper's Table-3 Monte-Carlo on one device: wrong DRA and TRA
results at the five process-variation corners, and the fault model
`FaultModel.from_corner(CORNER, source="sim")` builds from its corner.

    python -m repro_torch.launch.analog [--device cpu]

Prints one JSON line: the wrong results out of TRIALS at each corner,
the fault model's rates, the device and the wall time; exits 1 unless the
counts equal EXPECTED and FROM_CORNER.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np

from repro_torch.core.analog import monte_carlo_error_rates, percent
from repro_torch.core.faults import FaultModel
from repro_torch.device import resolve_device

TRIALS = 10_000
SEED = 0
CORNER = 0.15
# Wrong results out of TRIALS (seed 0) at each corner, as the reference's
# `monte_carlo_error_rates()` gives them with jax 0.9.0 (threefry2x32,
# partitionable) and the port repeats them on the CPU and an H100; the
# Monte-Carlo is deterministic, so any other count is a fault of the port.
EXPECTED = {0.05: {"DRA": 0, "TRA": 0}, 0.10: {"DRA": 0, "TRA": 20},
            0.15: {"DRA": 237, "TRA": 474}, 0.20: {"DRA": 756, "TRA": 1105},
            0.30: {"DRA": 1829, "TRA": 1884}}
# `from_corner(CORNER, source="sim")` runs that corner alone, from
# fold_in(key, 0) where the five-corner run used fold_in(key, 2): its
# own counts.
FROM_CORNER = {"DRA": 244, "TRA": 492}


def as_rates(counts: Dict[float, Dict[str, int]],
             trials: int = TRIALS) -> Dict[float, Dict[str, float]]:
    """Counts as the Monte-Carlo's percentages."""
    return {v: {op: percent(n, trials) for op, n in c.items()}
            for v, c in counts.items()}


def as_counts(rates: Dict[float, Dict[str, float]],
              trials: int = TRIALS) -> Dict[float, Dict[str, int]]:
    """The Monte-Carlo's percentages as counts of wrong results."""
    return {v: {op: int(np.rint(pct * trials / 100.0))
                for op, pct in r.items()} for v, r in rates.items()}


def run(device) -> dict:
    """The five corners and the corner's fault model on `device`; raises
    if a count differs from EXPECTED or FROM_CORNER."""
    t0 = time.perf_counter()
    rates = monte_carlo_error_rates(trials=TRIALS, seed=SEED, device=device)
    t1 = time.perf_counter()
    model = FaultModel.from_corner(CORNER, source="sim", trials=TRIALS,
                                   mc_seed=SEED, device=device)
    t2 = time.perf_counter()
    counts = as_counts(rates)
    if counts != EXPECTED or rates != as_rates(EXPECTED):
        raise AssertionError(f"Monte-Carlo counts {counts} != {EXPECTED}")
    want = as_rates({CORNER: FROM_CORNER})[CORNER]
    got = {"DRA": model.p_dra, "TRA": model.p_tra}
    if got != {op: pct / 100.0 for op, pct in want.items()}:
        raise AssertionError(f"from_corner({CORNER}) rates {got}, expected "
                             f"{FROM_CORNER} of {TRIALS}")
    return {"device": str(device), "trials": TRIALS,
            "wrong": {str(v): c for v, c in counts.items()},
            "from_corner": {"variation": CORNER, "p_dra": model.p_dra,
                            "p_tra": model.p_tra},
            "monte_carlo_s": t1 - t0, "from_corner_s": t2 - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs on the host")
    dev = resolve_device(ap.parse_args(argv).device)
    try:
        out = run(dev)
    except AssertionError as err:
        print(json.dumps({"device": str(dev), "error": str(err)}))
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
