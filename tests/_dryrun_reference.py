"""The reference's dry-run, run in a process of its own for the port's
dry-run tests.

`repro.launch.dryrun` forces 512 host devices through `XLA_FLAGS` when it
is imported, which would fix that device count for every later test of a
pytest worker; so the tests run this script in a subprocess:

    python tests/_dryrun_reference.py < request.json > answer.json

The request is {"tables": bool, "cells": [[arch, shape, mesh, compress,
zero1], ...], "hlo": [[line, total devices], ...], "run_cell": [[arch,
shape, mesh, cfg_overrides], ...]}.  With "run_cell" the answer carries
the keys of the record the reference's `run_cell` writes for each (its
probe left out).  With "hlo" the
answer carries the reference's `collective_bytes_per_device` of each
HLO line (total, by kind, counts) and its COLLECTIVES.  With "tables"
the answer carries ARCH_OPTIMIZER, all_cells() and, for every arch and
applicable shape of the published configs, input_specs (shapes and
dtypes) and model_flops.  Each cell is
the arch's smoke config at the shape's full global size, lowered and
compiled as `run_cell` compiles it; its answer is XLA's
memory_analysis() argument and output bytes and the number of output
leaves.
"""
import contextlib
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402

from repro.configs import get_config, get_smoke_config, shapes_for  # noqa: E402
from repro.configs.registry import ARCHS  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402


def tables() -> dict:
    specs, flops = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            key = f"{arch}|{shape}"
            specs[key] = {k: [list(v.shape), str(v.dtype)] for k, v in
                          dryrun.input_specs(cfg, shape).items()}
            flops[key] = dryrun.model_flops(cfg, shape)
    return {"arch_optimizer": dryrun.ARCH_OPTIMIZER,
            "all_cells": [list(c) for c in dryrun.all_cells()],
            "input_specs": specs, "model_flops": flops}


def cell(arch: str, shape: str, mesh_kind: str, compress: bool,
         zero1: bool) -> dict:
    cfg = get_smoke_config(arch)
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi")
    with mesh:
        jitted, args = dryrun.build_cell(
            cfg, shape, mesh,
            optimizer=dryrun.ARCH_OPTIMIZER.get(arch, "adamw"),
            compress=compress, zero1=zero1)
        lowered = jitted.lower(*args)
        ma = lowered.compile().memory_analysis()
    return {"argument_b": int(ma.argument_size_in_bytes),
            "output_b": int(ma.output_size_in_bytes),
            "output_leaves": len(jax.tree.leaves(lowered.out_info))}


def main() -> None:
    req = json.load(sys.stdin)
    out = tables() if req.get("tables") else {}
    out["cells"] = {"|".join(map(str, c)): cell(*c)
                    for c in req.get("cells", [])}
    if req.get("run_cell"):
        # run_cell prints; the answer alone goes to stdout
        with contextlib.redirect_stdout(sys.stderr):
            out["run_cell"] = [sorted(dryrun.run_cell(
                arch, shape, mesh, cfg_overrides=ov, probe=False))
                for arch, shape, mesh, ov in req["run_cell"]]
    if req.get("hlo"):
        out["collectives"] = list(dryrun.COLLECTIVES)
        out["hlo"] = [dryrun.collective_bytes_per_device(line, devices)
                      for line, devices in req["hlo"]]
    json.dump(out, sys.stdout)


if __name__ == "__main__":
    main()
