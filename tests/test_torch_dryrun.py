"""The port's dry-run (`repro_torch.launch.dryrun`) against the
reference's (`repro.launch.dryrun`): the shape suite, the cell list, the
input specs and model FLOPs of every arch and shape, the per-device
bytes of the serving cells (prefill_32k and decode_32k at each family's
smoke config on the 16 x 16 mesh, and one decode cell on the 2 x 16 x 16
mesh) against XLA's memory_analysis(), the meta run's FLOPs against the
same step on real CPU tensors, and the CLI.

The reference runs in one subprocess for this module
(`_dryrun_reference.py`): importing `repro.launch.dryrun` forces 512 host
devices on the process.  The train cells are held in
`test_torch_dryrun_train.py`.
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _dryrun_cells import FAMILY_ARCHS, HERE, ask_reference, check_memory
from repro_torch.configs import (ARCHS, SHAPES, ShapeConfig, get_config,
                                 get_smoke_config, shapes_for)
from repro_torch.launch import dryrun
from repro_torch.models import empty_caches, init_params
from repro_torch.optim import get_optimizer
from repro_torch.runtime.steps import make_train_state
from repro_torch.tree import tree_map

SERVE_CELLS = ([[arch, shape, "single", False, True]
                for arch in FAMILY_ARCHS
                for shape in ("prefill_32k", "decode_32k")]
               + [["deepseek-v3-671b", "decode_32k", "multi", False, True]])


@pytest.fixture(scope="module")
def ref():
    return ask_reference({"tables": True, "cells": SERVE_CELLS})


def test_shapes_equal_the_reference():
    from repro.configs import SHAPES as REF_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shapes_for_equals_the_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.configs import shapes_for as ref_shapes_for
    assert shapes_for(get_config(arch)) == ref_shapes_for(ref_config(arch))


def test_cells_and_optimizers_equal_the_reference(ref):
    assert dryrun.ARCH_OPTIMIZER == ref["arch_optimizer"]
    assert [list(c) for c in dryrun.all_cells()] == ref["all_cells"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_model_flops_equal_the_reference(ref, arch):
    cfg = get_config(arch)
    for shape in shapes_for(cfg):
        key = f"{arch}|{shape}"
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in dryrun.input_specs(cfg, shape).items()}
        assert got == ref["input_specs"][key], key
        assert all(v.is_meta for v in
                   dryrun.input_specs(cfg, shape).values())
        assert dryrun.model_flops(cfg, shape) == ref["model_flops"][key]


@pytest.mark.parametrize("cell", SERVE_CELLS,
                         ids=lambda c: "-".join(map(str, c)))
def test_serve_cell_memory_equals_xla(ref, cell):
    check_memory(ref, cell)


# --- the meta run's FLOPs against a real run ------------------------------

TINY = {"tiny_train": ShapeConfig("tiny_train", 32, 2, "train"),
        "tiny_prefill": ShapeConfig("tiny_prefill", 32, 2, "prefill"),
        "tiny_decode": ShapeConfig("tiny_decode", 32, 2, "decode")}


def real_like(tree, rng):
    """A CPU tensor for every meta leaf: integers 0 (token ids, labels,
    positions), floats drawn from a seeded generator."""
    def one(t):
        if not t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype)
        return torch.from_numpy(rng.standard_normal(
            t.shape, dtype=np.float32) * 0.02).to(t.dtype)
    return tree_map(one, tree)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("shape", sorted(TINY))
def test_meta_flops_equal_a_real_run(monkeypatch, arch, shape):
    for name, sh in TINY.items():
        monkeypatch.setitem(SHAPES, name, sh)
    cfg = get_smoke_config(arch)
    cell, args = dryrun.build_cell(cfg, shape,
                                   dryrun.production_mesh("single"),
                                   optimizer="adamw")
    _, meta_flops, _ = dryrun.run_meta(cell, args)
    rng = np.random.default_rng(0)
    real = [real_like(a, rng) for a in args]
    if cell.train:
        real[0] = make_train_state(0, cfg, get_optimizer("adamw"),
                                   device="cpu")
    else:
        serve_cfg = cfg.replace(param_dtype="bfloat16", remat=False)
        real[0] = init_params(0, serve_cfg, device="cpu")
        if TINY[shape].kind == "decode":
            real[2] = empty_caches(serve_cfg, 2, 32, device="cpu")
    counter = FlopCounterMode(display=False)
    with counter, (torch.enable_grad() if cell.train else torch.no_grad()):
        cell.fn(*real)
    assert meta_flops > 0
    assert meta_flops == counter.get_total_flops()


# --- the CLI ----------------------------------------------------------------

def records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_cli_writes_skips_and_forces(tmp_path, capsys):
    out = tmp_path / "cells.jsonl"
    argv = ["--arch", "mamba2-130m", "--shape", "decode_32k", "--out",
            str(out)]
    assert dryrun.main(argv) == 0
    (rec,) = records(out)
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["variant"]) == \
        ("mamba2-130m", "decode_32k", "single", "base")
    cfg = get_config("mamba2-130m")
    assert rec["param_count"] == cfg.param_count()
    assert rec["model_flops_global"] == dryrun.model_flops(cfg,
                                                           "decode_32k")
    for key in ("lower_s", "mem_argument_b", "mem_output_b",
                "flops_global"):
        assert rec[key] > 0
    assert dryrun.main(argv) == 0                     # cached: skipped
    assert len(records(out)) == 1
    assert "(cached)" in capsys.readouterr().out
    assert dryrun.main(argv + ["--force"]) == 0
    assert len(records(out)) == 2


def test_cli_override_parses_as_the_reference(tmp_path):
    assert dryrun.parse_overrides(
        ["bitlinear=ffn", "n_layers=2", "capacity_factor=1.5",
         "remat=false", "name=\"x\""]) == {
        "bitlinear": "ffn", "n_layers": 2, "capacity_factor": 1.5,
        "remat": False, "name": "x"}
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                        "--mesh", "multi", "--override", "n_layers=1",
                        "--variant", "l1", "--out", str(out)]) == 0
    (rec,) = records(out)
    assert rec["cfg_overrides"] == {"n_layers": 1}
    assert rec["variant"] == "l1" and rec["devices"] == 512
    assert rec["param_count"] == \
        get_config("qwen3-14b").replace(n_layers=1).param_count()


def test_cli_exits_1_on_a_cell_that_cannot_be_built(tmp_path):
    out = tmp_path / "cells.jsonl"
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k",
                        "--override", "no_such_field=1",
                        "--out", str(out)]) == 1
    (rec,) = records(out)
    assert rec["status"] == "error" and "no_such_field" in rec["error"]


def test_cli_runs_without_jax(tmp_path):
    """The acceptance cell as a user runs it, in a process where any
    import of jax, the reference or drim fails."""
    out = tmp_path / "cells.jsonl"
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'drim'):\n"
            "    sys.modules[name] = None\n"
            "from repro_torch.launch import dryrun\n"
            "sys.exit(dryrun.main(sys.argv[1:]))\n")
    done = subprocess.run(
        [sys.executable, "-c", code, "--arch", "qwen3-14b", "--shape",
         "train_4k", "--mesh", "single", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(HERE.parent / "src"), "PATH": "/usr/bin"})
    assert done.returncode == 0, done.stderr[-2000:]
    (rec,) = records(out)
    assert rec["status"] == "ok" and rec["optimizer"] == "adamw"
    assert rec["mem_argument_b"] > 0
