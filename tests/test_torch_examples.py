"""The torch twins of `examples/` run on the CPU, each in its own process
under `-W error::DeprecationWarning` (the reference's example gate: no
twin may reach a deprecated shim), at its smallest size, and print what
their reference examples print.  Each test checks the exit code and one
printed number against the reference: exact for the structural numbers
and the Monte-Carlo percentages (integers and their float32 ratios).

The serve and train twins run at the sizes `tests/test_torch_serve.py`
and `tests/test_torch_train.py` use.  Their tokens and losses follow each
package's own seeded weights, so the number checked is the run's shape
(tokens per request, steps); those tests hold the tokens and the train
steps equal to the reference's with its weights carried over; the
train twin is checked against the steps it was asked for."""
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
TINY_SERVE = ["--layers", "2", "--d-model", "32", "--d-ff", "64",
              "--heads", "2", "--kv-heads", "1", "--d-head", "16",
              "--vocab", "128", "--prompt-len", "8", "--gen", "5",
              "--batch", "2"]


def run_example(name, *args, tmp_path):
    """Run examples/<name> with --device cpu; returns its stdout."""
    out = subprocess.run(
        [sys.executable, "-W", "error::DeprecationWarning",
         str(ROOT / "examples" / name), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=TIMEOUT, cwd=tmp_path,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1", "TMPDIR": str(tmp_path),
             "HOME": str(tmp_path)})
    assert out.returncode == 0, f"{name}:\n{out.stdout}\n{out.stderr}"
    assert "jax" not in out.stderr.lower()
    return out.stdout


def test_quickstart_twin(tmp_path):
    """The traced kernel's fused AAPs and the +-30 % corner's Monte-Carlo
    error rates are the reference's; the packer and the adder sections
    report their outputs checked (against the plain packer, a + b)."""
    import drim
    from repro.core import monte_carlo_error_rates

    out = run_example("quickstart_torch.py", tmp_path=tmp_path)
    assert "Quickstart complete" in out
    assert "(32x smaller) == the plain packer" in out
    assert "carry-out (32,) == a + b" in out

    @drim.jit
    def kernel(a_, b_, c_):
        x_ = drim.xnor(a_, b_)
        s_, carry = drim.full_add(x_, c_, b_)
        return {"s": s_, "carry": carry}
    aaps = drim.compile(kernel).lower().aaps
    assert f"traced kernel: {kernel.trace().n_nodes} nodes fused into " \
        f"{aaps} AAPs/tile over 1 wave(s)" in out
    rates = monte_carlo_error_rates(trials=2000, variations=(0.10, 0.30),
                                    seed=0)
    for var, r in rates.items():
        assert f"±{var:.0%} corner: DRA err {r['DRA']:5.2f}% " in out
        assert f"TRA err {r['TRA']:5.2f}% " in out


def test_pim_offload_report_twin(tmp_path):
    """The fused BNN dot's AAP cycles and DDR rows are the reference's
    closed form (`plan_graph_schedule`, what its example measures)."""
    from repro.core import DrimGeometry
    from repro.pim.bnn import bnn_dot_graph
    from repro.pim.graph import plan_graph_schedule

    out = run_example("pim_offload_report_torch.py", tmp_path=tmp_path)
    geom = DrimGeometry(chips=1, banks=2, subarrays_per_bank=2, row_bits=32)
    s = plan_graph_schedule(bnn_dot_graph(8), 4 * 5, geom=geom)
    assert (f"4x5 dot products, K=8: bit-exact=True; {s.aaps_sequential} "
            f"fused AAP cycles vs {s.unfused_aaps_sequential} unfused, "
            f"{s.ddr_rows_moved} DDR rows vs {s.unfused_ddr_rows_moved}") \
        in out
    # every registered arch priced, the vlm's among them
    assert "drim-bnn" in out and "llava-next-34b" in out
    assert "item 12" not in out
    assert re.search(r"simulated=True\)", out)


def test_telemetry_trace_twin(tmp_path):
    """The chaos run requeues the reference partition's segments of the
    dead queue; the trace parses."""
    from repro.pim.bnn import bnn_dot_graph_carrysave
    from repro.pim.graph import partition_graph

    trace = tmp_path / "trace.json"
    out = run_example("telemetry_trace_torch.py", "--trace-out", str(trace),
                      tmp_path=tmp_path)
    gp = partition_graph(bnn_dot_graph_carrysave(4)[0], 4)
    orphans = sum(1 for s in gp.segments if s.part == 2)
    assert f"chaos: requeued {orphans} segments on survivors (0, 1, 3)" \
        in out
    assert int(re.search(r"chaos\.requeued_segments\s+(\d+)",
                         out).group(1)) == orphans
    assert json.loads(trace.read_text())["traceEvents"]
    assert re.search(r"wrote \d+ trace events", out)


def test_serve_decode_twin(tmp_path):
    """One JSON stats line: the tokens per request and the batch of the
    reference CLI's reading of the same flags."""
    from repro.launch import serve as ref_serve

    out = run_example("serve_decode_torch.py", *TINY_SERVE, "--engine",
                      "resident", tmp_path=tmp_path)
    stats = json.loads(out.strip().splitlines()[-1])
    ref = ref_serve.parse_args(["--smoke-config"] + TINY_SERVE)
    assert (stats["gen"], stats["batch"]) == (ref.gen, ref.batch)
    assert stats["engine"] == "resident" and stats["device"] == "cpu"
    assert len(stats["sample_ids"]) == ref.gen
    assert all(0 <= t < ref.vocab for t in stats["sample_ids"])


def test_train_bnn_lm_twin(tmp_path):
    """The steps asked for, logged one by one; a finite final loss below
    the first step's."""
    argv = ["--quick", "--steps", "6", "--batch", "4", "--seq", "64",
            "--log-every", "1"]
    out = run_example("train_bnn_lm_torch.py", *argv, tmp_path=tmp_path)
    lines = out.strip().splitlines()
    assert lines[0].startswith("training drim-bnn (smoke) for 6 steps")
    final = json.loads(lines[-2])
    logged = [json.loads(line) for line in lines[1:-2]]
    assert final["steps"] == 6 == len(logged) == logged[-1]["step"]
    first = logged[0]["loss"]
    assert np.isfinite(final["final_loss"]) and final["final_loss"] < first
    assert lines[-1].startswith(f"final loss {final['final_loss']:.4f}")


def test_serve_and_train_twins_pass_mesh_host():
    """The serve and train twins pass `--mesh host`, as their reference
    examples do, to CLIs that take it."""
    from repro_torch.launch import serve, train
    for ref, twin in (("serve_decode.py", "serve_decode_torch.py"),
                      ("train_bnn_lm.py", "train_bnn_lm_torch.py")):
        for name in (ref, twin):
            text = (ROOT / "examples" / name).read_text()
            assert '"--mesh", "host"' in text, name
    assert serve.parse_args([]).mesh == train.parse_args([]).mesh == "host"
