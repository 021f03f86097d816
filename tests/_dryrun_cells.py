"""Helpers of the dry-run tests: ask the reference's dry-run (in a
subprocess, `_dryrun_reference.py`) and measure the port's cell."""
import json
import os
import pathlib
import subprocess
import sys

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun

HERE = pathlib.Path(__file__).resolve().parent
# one smoke config per family (moe twice: MLA and GQA)
FAMILY_ARCHS = ("qwen3-14b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
                "mamba2-130m", "zamba2-1.2b", "whisper-medium",
                "llava-next-34b")


def ask_reference(request: dict, timeout: int = 600) -> dict:
    """The reference's answer to `request` (see `_dryrun_reference.py`),
    from a process of its own.  It inherits no `XLA_FLAGS`: other test
    modules set a device count there at import, which would override the
    512 devices the reference's dry-run asks for."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    done = subprocess.run(
        [sys.executable, str(HERE / "_dryrun_reference.py")],
        input=json.dumps(request), capture_output=True, text=True,
        env=env, timeout=timeout)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout)


def cell_key(cell) -> str:
    return "|".join(map(str, cell))


def port_memory(arch: str, shape: str, mesh_kind: str, compress: bool,
                zero1: bool):
    """(mem_argument_b, mem_output_b) of the port's cell at the arch's
    smoke config, as `run_cell` computes them."""
    cell, args = dryrun.build_cell(
        get_smoke_config(arch), shape, dryrun.production_mesh(mesh_kind),
        optimizer=dryrun.ARCH_OPTIMIZER.get(arch, "adamw"),
        compress=compress, zero1=zero1)
    out, _, read = dryrun.run_meta(cell, args)
    return (dryrun.device_bytes(args, cell.in_shardings, read),
            dryrun.device_bytes(out, cell.out_shardings))


def check_memory(ref: dict, cell) -> None:
    """The port's per-device bytes against XLA's memory_analysis(): the
    arguments byte for byte, the outputs less XLA's 8-byte tuple index
    per output leaf."""
    want = ref["cells"][cell_key(cell)]
    arg_b, out_b = port_memory(*cell)
    assert arg_b == want["argument_b"]
    assert out_b == want["output_b"] - 8 * want["output_leaves"]
