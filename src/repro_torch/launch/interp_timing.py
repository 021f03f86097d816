"""Time the AAP interpreter kernel, fault-free and fault-injecting, the
XNOR-popcount GEMM and the sign packer on the main paths' launches, at
their shapes, so two checkouts can be compared on one card.

    python3 src/repro_torch/launch/interp_timing.py [--src DIR] [--label L]
        [--kernels interp,gemm,pack]

`--src` names the `src` directory whose `repro_torch` is imported and
timed (default: the one this file lies in); run the script once per
checkout in one call, alternating them, to compare two versions of the
kernels.  Interpreter cases, each over DRIM-R waves of 65,536 word columns
(the ragged soup excepted) with tiles from `np.random.default_rng(0)`:

  - serving K=128: the decode launch of the "cuda" serving route, 1 wave;
  - K=32 dot: the bulk phase's carry-save K=32 dot, 1 wave;
  - TMR K=128 fault-free: the faults phase's TMR stream, 4 waves;
  - not, xnor2, add: Fig. 8's ops through the "cuda" engine, 256 waves
    (2**29 bits a plane);
  - TMR K=128 faulted: the same TMR stream under the faults phase's
    Table-3 corner, 4 waves;
  - ragged soup faulted: a 300-AAP soup over every word-line with stuck
    rows, protected ops and a bank offset, 3 waves of 999 columns.

GEMM cases ("gemm" lines): the drim-bnn FFN pair at 512 rows, decode
(batch 4) and prefill (batch 4 x 256 tokens) through both projections,
on random sign words.

Packer cases ("pack" lines, `PACK_SHAPES`): the FFN pair's float32
operands, the float32 weights the packed serving route packs, its
bfloat16 activations at decode and prefill (the continuous batcher's
too), ragged K and views one element in, from `np.random.default_rng(0)`
normals, and an empty kernel's launch.

Each case prints one JSON line: the device time per launch in a CUDA
graph (`ms`), the eager time per call (`call_ms`) and a SHA-256 of the
output words, which must agree between checkouts.  The wrappers are
called as the engine calls them: with the packed stream where they take
one.  The card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np

WAVE_COLS = 65536             # DRIM-R: 16,384 sub-arrays x 128 bits / 32
BULK_WAVES = 256              # 2**29 bits over DRIM-R's 2**21 a wave


def graph_ms(torch, fn, iters: int = 10, replays: int = 5) -> float:
    """Mean device time per call of `fn`, `iters` calls captured in one
    CUDA graph and replayed `replays` times between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (iters * replays)


def call_ms(torch, fn, iters: int = 20) -> float:
    """Mean eager time per call of `fn` between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def cases():
    """(label, program, readback rows, template rows, staged rows,
    waves) of each timed launch."""
    from repro_torch.core import DRIM_R
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave, serving_lowering
    from repro_torch.pim.scheduler import OP_ARITY
    out = []
    fp = serving_lowering(128, engine="cuda", geom=DRIM_R).fp
    out.append(("serving K=128", fp.program, fp.readback_rows,
                fp.template_rows, len(fp.loaded_inputs), 1))
    for label, k, harden, waves in (("K=32 dot", 32, None, 1),
                                    ("TMR K=128 fault-free", 128, "tmr", 4)):
        fp = drim_compile(bnn_dot_graph_carrysave(k)[0], geom=DRIM_R).lower(
            "cuda", harden=harden).fp
        out.append((label, fp.program, fp.readback_rows, fp.template_rows,
                    len(fp.loaded_inputs), waves))
    for op in ("not", "xnor2", "add"):
        low = drim_compile(op).lower("cuda")
        out.append((op, low.program, low.result_rows, low.n_rows,
                    OP_ARITY[op], BULK_WAVES))
    return out


def faulted_cases():
    """(label, program, readback rows, template rows, staged rows, waves,
    [chips, banks, subarrays, row words], fault model, (bank_lo,
    banks_total)) of each timed faulted launch."""
    from repro_torch.core import AAP, DRIM_R, FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    low = drim_compile(bnn_dot_graph_carrysave(payload.K_BITS)[0],
                       geom=DRIM_R).lower("cuda", harden="tmr")
    fp = low.fp
    corner = low._resolve_faults(FaultModel.from_corner(
        payload.CORNER, source="paper", seed=payload.SEED))
    geom4 = (DRIM_R.chips, DRIM_R.banks, DRIM_R.subarrays_per_bank,
             DRIM_R.row_bits // 32)
    rng = np.random.default_rng(1)
    n_rows, arity = 20, {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    ragged = FaultModel(p_dra=0.3, p_tra=0.4, seed=5,
                        stuck_rows=((2, 1), (17, 0), (21, 1)),
                        protected_ops=tuple(range(0, 300, 7)))
    return [("TMR K=128 faulted", fp.program, fp.readback_rows,
             fp.template_rows, len(fp.loaded_inputs), payload.WAVES, geom4,
             corner, (0, None)),
            ("ragged soup faulted", soup, tuple(range(n_rows + 4)), n_rows,
             6, 3, (1, 3, 37, 9), ragged, (2, 8))]


# (use, M, N, K) of each timed GEMM launch
GEMM_SHAPES = [("ffn", 512, 3072, 768), ("ffn", 512, 768, 3072),
               ("decode", 4, 3072, 768), ("decode", 4, 768, 3072),
               ("prefill", 1024, 3072, 768), ("prefill", 1024, 768, 3072)]


# (rows, K, dtype name, offset in elements) of each timed packer launch
PACK_SHAPES = [(512, 768, "float32", 0), (3072, 768, "float32", 0),
               (512, 3072, "float32", 0), (768, 3072, "float32", 0),
               (4, 768, "bfloat16", 0), (4, 3072, "bfloat16", 0),
               (1024, 768, "bfloat16", 0), (1024, 3072, "bfloat16", 0),
               (256, 768, "bfloat16", 0), (256, 3072, "bfloat16", 0),
               (200, 768, "bfloat16", 0), (200, 3072, "bfloat16", 0),
               (2, 768, "bfloat16", 0), (2, 3072, "bfloat16", 0),
               (300, 700, "bfloat16", 0), (300, 700, "float32", 0),
               (512, 768, "float32", 1), (1024, 3072, "bfloat16", 1)]


def emit(torch, kind: str, rec: dict, run, iters: int = 10) -> None:
    """Time `run` and print one line of `kind` with its output's digest."""
    out = run()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    rec.update(ms=graph_ms(torch, run, iters),
               call_ms=call_ms(torch, run, 2 * iters), sha256=digest[:16])
    print(f"{kind} " + json.dumps(rec), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir))
    ap.add_argument("--label", default="")
    ap.add_argument("--kernels", default="interp,gemm,pack",
                    help="comma-separated: interp (both interpreters), "
                         "gemm, pack")
    args = ap.parse_args()
    kinds = set(args.kernels.split(","))
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("interp_timing needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card {smi.splitlines()[0]}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    if "interp" in kinds:
        time_interpreters(torch, args, rng)
    if "gemm" in kinds:
        from repro_torch.kernels import xnor_popcount
        for use, m, n, k in GEMM_SHAPES:
            a, b = (torch.from_numpy(rng.integers(
                -2**31, 2**31, (rows, -(-k // 32)), dtype=np.int32)).to(dev)
                for rows in (m, n))
            emit(torch, "gemm", {"label": args.label, "case": use,
                                 "shape": [m, n, k]},
                 lambda: xnor_popcount.xnor_gemm_packed(a, b, k))
    if "pack" in kinds:
        from repro_torch.kernels import packbits
        if hasattr(packbits, "launch_floor"):      # an empty kernel's launch
            print("pack " + json.dumps({
                "label": args.label, "case": "empty kernel",
                "ms": graph_ms(torch, packbits.launch_floor, 50)}),
                flush=True)
        for rows, k, dtype, offset in PACK_SHAPES:
            flat = rng.standard_normal(rows * k + offset, dtype=np.float32)
            x = torch.from_numpy(flat).to(dev, getattr(torch, dtype))
            x = x[offset:].view(rows, k)
            rec = {"label": args.label, "shape": [rows, k], "dtype": dtype,
                   "offset": offset}
            emit(torch, "pack", rec, lambda: packbits.pack_signs(x), iters=50)


def time_interpreters(torch, args, rng) -> None:
    """The fault-free and fault-injecting interpreter cases."""
    from repro_torch.core import dcc_state_rows, encode_kernel_stream, \
        kstream_slot
    from repro_torch.kernels import aap_interpreter
    dev = torch.device("cuda")
    takes_packed = "packed" in inspect.signature(
        aap_interpreter.aap_interp).parameters
    for label, prog, readback, n_rows, n_in, waves in cases():
        stream_np = encode_kernel_stream(prog, n_rows=n_rows)
        stream = torch.from_numpy(stream_np).to(dev)
        slot_list = [kstream_slot(r, n_rows) for r in readback]
        slots = torch.tensor(slot_list, dtype=torch.int32, device=dev)
        n_state = dcc_state_rows(n_rows)
        kw = {}
        if takes_packed:
            kw["packed"] = aap_interpreter.pack_stream(stream_np, slot_list,
                                                       n_state, n_in)
        tiles = torch.from_numpy(rng.integers(
            -2**31, 2**31, (waves, n_in, WAVE_COLS), dtype=np.int32)).to(dev)

        def run():
            return aap_interpreter.aap_interp(stream, tiles, slots, n_state,
                                              **kw)
        rec = {"label": args.label, "case": label, "n_ins": len(prog),
               "waves": waves, "n_in": n_in, "cols": WAVE_COLS,
               "n_state": n_state}
        if takes_packed:
            rec["slots"] = kw["packed"].n_slots
        emit(torch, "interp", rec, run)
        del tiles

    # the faulted replay: packed with its stuck rows where the wrapper
    # takes a packed stream, as the engine packs it
    faulted_packed = "packed" in inspect.signature(
        aap_interpreter.aap_interp_faulted).parameters
    for (label, prog, readback, n_rows, n_in, waves, geom4, faults,
         (bank_lo, banks_total)) in faulted_cases():
        c, b, s, w = geom4
        stream_np = encode_kernel_stream(prog, n_rows=n_rows)
        slot_list = [kstream_slot(r, n_rows) for r in readback]
        n_state = dcc_state_rows(n_rows)
        operands = (
            torch.from_numpy(stream_np).to(dev),
            torch.from_numpy(aap_interpreter._op_thresholds(
                prog, faults).view(np.int32)).to(dev),
            aap_interpreter.column_meta(c, b, s, w, seed=faults.seed,
                                        bank_lo=bank_lo,
                                        banks_total=banks_total, device=dev),
            torch.from_numpy(rng.integers(
                -2**31, 2**31, (waves, n_in, c * b * s * w),
                dtype=np.int32)).to(dev),
            torch.tensor(slot_list, dtype=torch.int32, device=dev),
            n_state,
            torch.tensor(faults.stuck_rows, dtype=torch.int32,
                         device=dev).reshape(-1, 2),
            32 * w)
        kw = {}
        if faulted_packed:
            kw["packed"] = aap_interpreter.pack_stream(
                stream_np, slot_list, n_state, n_in,
                stuck=faults.stuck_rows)

        def run_faulted():
            return aap_interpreter.aap_interp_faulted(*operands, **kw)
        rec = {"label": args.label, "case": label, "n_ins": len(prog),
               "waves": waves, "n_in": n_in, "cols": c * b * s * w,
               "n_state": n_state}
        if faulted_packed:
            rec["slots"] = kw["packed"].n_slots
        emit(torch, "interp", rec, run_faulted)
        del operands



if __name__ == "__main__":
    main()
