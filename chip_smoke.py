#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile the eight CUDA sources of `src/repro_torch/csrc/`
                (one nvcc per source, all started together), print
                ptxas's registers and spills per kernel, and count each
                flash kernel's tensor-core instructions (HMMA) and the
                XNOR GEMM's (IMMA) in their SASS: the bfloat16 forward,
                dkv and dq kernels and the GEMM must have some, the
                float32 flash kernels none ("sass" lines);
  2. kernels -- hold each kernel against its plain torch version on the
                card at the main paths' shapes plus a ragged shape (exact
                equality for the integer kernels; flash attention's float32
                output at the reference test's 2e-5, its bfloat16 output
                within about one bfloat16 ulp), and time kernel, plain
                version and, where one exists, one PyTorch call computing
                the same function (`torch._int_mm` on the +-1 int8
                operands for the GEMM, at its decode, prefill and FFN
                shapes, and a float32 matmul beside it; SDPA for flash
                attention); the sign packer at the FFN pair's and the
                packed weights' float32 shapes, the served bfloat16
                activations (decode [4, K], prefill [1024, K]), ragged K
                and views one element in (the scalar path), beside an
                empty kernel's launch (`launch_floor_ms`); the AAP
                interpreter on its packed stream
                at the serving decode shape (K=128, one full DRIM-R wave),
                the bulk phase's K=32 dot (one wave), the TMR stream
                fault-free over 4 waves and a ragged soup,
                against the plain replay and its plain twin ("detail"
                lines with slots, words_per_thread, block_cols and
                smem_bound_ms);
                the fault-injecting interpreter on its packed stream
                (stuck rows folded in) at the TMR-hardened K=128 stream
                over 4 DRIM-R waves and at a ragged shape with stuck
                rows, protected ops and a bank offset, against the plain
                replay and the packed twin (its slots, words_per_thread
                and smem_bound_ms); the bulk bit-wise kernels (not, the binary and
                the ternary ops), the bit-plane adder and the sign
                unpacker exactly, at the bulk phase's shapes and at ragged
                ones (a length no block divides, a start one word off
                16-byte alignment, empty tensors, 1 and 33 planes), the
                unpacker on the drim-bnn FFN weights packed by the pack
                kernel, in float32, bfloat16 and int8; the flash
                backward kernels (dkv, dq) at the training shape and the
                forward's other cases (float32 at the reference test's
                2e-4, bfloat16 within about one bfloat16 ulp), with SDPA's
                backward as their yardstick; forward and backward also at
                the training shape and the bfloat16 tensor-core kernels'
                edges (FLASH_BF16_EDGES), a "detail" line each;
  3. path    -- one drim-bnn FFN BitLinear pair at full width (768 -> 3072
                -> 768) on M = 512 activation rows, weights from a seeded
                numpy generator, each projection served by the native
                packed route (pack + XNOR-GEMM kernels) and by the DRIM
                route (AAP interpreter kernel on the DRIM-R fleet); the
                int32 dots of both routes must equal the plain reference
                computed on the CPU, and the float outputs must agree;
  4. serve   -- the drim-bnn LM at full width and depth (12 layers,
                seeded weights) through `repro_torch.launch.serve`: batch
                4, a 256-token prompt (flash prefill), 8 greedy tokens, on
                the native dense route, the native packed route (with its
                bit-exactness check) and the DRIM packed route ("cuda"
                engine); the token ids must be identical across the three.
                Then `run_continuous` with prompts of 256 and 200 tokens
                (the second takes the dense-scores attention) into 2
                slots, native packed and DRIM packed, with identical
                tokens per request;
  5. faults  -- Table-3 fault injection (the +-15% corner of the paper)
                on the carry-save K=128 serving dot at full width: DRIM-R,
                4 waves, 262,144 words per input plane, bare and hardened
                ("ecc", "tmr", "tmr+ecc"), on the "cuda", "resident" and
                (bare and "tmr") "baseline" engines, which must agree bit
                for bit, ECC verdicts included; against the clean numpy
                oracle the bare run must be corrupted, ECC must flag it
                and TMR must leave fewer bits wrong than bare; a
                fault-free TMR run must be exact;
  6. bulk    -- the paper's Fig. 8 ops on the card at its largest vector,
                2**29 bits (64 MiB planes from a seeded generator):
                not, xnor2 and add through `compile(op).lower("gpu")`
                (the native comparator, one bulk bit-wise kernel per op)
                and through `lower("cuda")` (the DRIM-R fleet's AAP
                interpreter over 256 waves), both exact against the plain
                version; the 32-bit word add as the bit-plane adder over
                [32, 2**19] planes; the carry-save K=32 serving dot at
                full DRIM-R width on "gpu" and "cuda" and the numpy
                oracle; the FFN weights packed and unpacked.  Then each
                op's kernel time, its Gbit/s beside the DRIM-R model and
                the paper's GPU model, and the op-averaged DRIM-R / H100
                ratio beside the paper's 8.4 ("bulk" lines);
  7. analog  -- the paper's Table-3 Monte-Carlo on the card (10,000
                trials at the five corners, seed 0, draws from the port's
                twin of jax.random): the wrong DRA and TRA results must
                equal `launch.analog.EXPECTED` and
                `FaultModel.from_corner(0.15, source="sim")` the rates of
                `launch.analog.FROM_CORNER`; then a 32-bit
                `multibit_add_program` over one DRIM-R wave (2**21
                elements) on the AAP interpreter must equal numpy's a + b;
                prints the phase's wall time ("analog" line);
  8. train   -- the drim-bnn LM trained at full width and depth through
                `repro_torch.launch.train.main` (examples/train_bnn_lm.py's
                batch 8, seq 256, AdamW 3e-4; 20 steps, seeded weights,
                deterministic algorithms): finite losses, the last below
                the first, s/step and tokens/s ("train" lines); then the
                step-10 checkpoint restored into a fresh state and trained
                10 more steps must equal the straight run's step-20 state
                bit for bit;
  9. counts  -- the launch counters are zeroed just before phase 3, before
                each of phase 4's five legs, before phase 5, phase 6,
                phase 7 and each of phase 8's two legs, and read just
                after each:
                phase 3 must launch the three BNN kernels, each serving
                leg exactly the launches its route implies
                (`expected_launches`), phase 5 the faulted interpreter
                once per faulted "cuda" run and the fault-free one once,
                phase 6 one bulk kernel per "gpu" op run and per non-copy
                graph node (by kind), the interpreter once per "cuda" run
                and never on "gpu", phase 7 the interpreter once, phase 8
                per step the flash forward
                twice per layer (remat) and each backward kernel once per
                layer; a counter a leg does not name must stay 0;
 10. check   -- a float32 smoke-config prefill, and the same config's
                first train step (loss and gradients), on the card held to
                the same on the CPU (after the counts are read).

Prints the kernels' JSON line (the packer's entry also under "served" at
its decode [4, 768] bfloat16 and [3072, 768] float32 weight shapes), the
card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

# cuBLAS picks its reduction order per call unless its workspace is fixed
# before CUDA starts; the train phase's restart check needs that order to
# repeat (torch.use_deterministic_algorithms requires this setting).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
M_ROWS = 512                      # activation rows: a 512-token prefill

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bandwidth, and the
# int32 rate of the CUDA cores -- 64 INT32 lanes per SM against the 128
# FP32 lanes behind the 67 TFLOP/s float32 figure, which counts an FMA as
# two operations, so a quarter of it.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 67e12 / 4
BF16_FLOPS_S = 989e12             # dense tensor-core bf16 peak
INT8_OPS_S = 1979e12              # dense tensor-core int8 peak

# flash attention, (atol, rtol) of out against the plain version: float32
# at the reference test's 2e-5 (tests/test_flash_attention.py); bfloat16
# at one bfloat16 ulp (at most 2**-7 of the value, 4e-3 near zero), since
# kernel and plain version each round a float32 result to bfloat16 once.
# lse at 1e-4.
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (4e-3, 2 ** -7)}
LSE_TOL = 1e-4
# flash backward, (atol, rtol) of dq, dk, dv against the plain backward:
# float32 at the reference test's 2e-4 (tests/test_flash_attention.py:
# test_flash_backward); bfloat16 at one bfloat16 ulp, as FLASH_TOL, since
# kernel and plain version each round a float32 sum to bfloat16 once.
BWD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (4e-3, 2 ** -7)}
# bfloat16 flash cases beyond the main paths' shapes, for the tensor-core
# kernels' edges (b, h, hkv, sq, sk, d, bq, bk, causal, dtype): Sq != Sk
# at D = 128 causal, D = 32 non-causal, D = 16, n_rep 1, 3 and 4.
FLASH_BF16_EDGES = [
    (1, 4, 1, 64, 192, 128, 64, 64, True, torch.bfloat16),
    (1, 2, 2, 256, 256, 32, 128, 64, False, torch.bfloat16),
    (2, 6, 2, 128, 128, 16, 64, 64, True, torch.bfloat16),
    (2, 4, 4, 192, 320, 64, 64, 64, False, torch.bfloat16)]
# The train phase: examples/train_bnn_lm.py's run (batch 8, seq 256,
# AdamW at 3e-4) at full width and depth, cut to TRAIN_STEPS steps, with a
# checkpoint at RESTART_AT for the restart check.
TRAIN_STEPS, RESTART_AT = 20, 10
PROFILE_STEPS = 3               # steps traced after the restart check
TRAIN = ["--arch", "drim-bnn", "--steps", str(TRAIN_STEPS), "--batch", "8",
         "--seq", "256", "--lr", "3e-4", "--log-every", "1",
         "--ckpt-every", str(RESTART_AT), "--seed", str(SEED)]
# The card's float32 smoke-config train step against the CPU's: both sum
# float32 in other orders (about 1e-6 relative, as the CPU tests measure
# against the reference); the gradient's bound leaves room for an STE
# sign flip of an activation within float32 noise of 0.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3
SERVE = ["--arch", "drim-bnn", "--batch", "4", "--prompt-len", "256",
         "--gen", "8", "--seed", str(SEED), "--temperature", "0"]
# integer operations of one armed DRA/TRA's draw: the XOR of the slot
# hash with i * golden (one scalar per instruction), mix32 (3 xor-shifts,
# 2 multiplies) and the compare.  A draw belongs to a (sub-array, op)
# pair: the words of a row and the waves share it.  The rare failing
# draw's bit position and its one flipped word are not counted.
HASH_OPS = 10

# The bulk phase: Fig. 8's largest vector (benchmarks/fig8_throughput.py
# sweeps 2**27..2**29 bits), 2**24 words, 64 MiB a plane: above the 50 MB
# L2, so every call streams from device memory.
BULK_BITS = 1 << 29
BULK_WORDS = BULK_BITS // 32
ADD_PLANES = (32, BULK_WORDS // 32)      # a 32-bit word add of 2**24 lanes
FIG8_OPS = ("not", "xnor2", "add")
# integer operations per word of each bulk bit-wise op (for its bound)
BITWISE_OPS = {"not": 1, "xnor": 2, "xor": 1, "and": 1, "or": 1, "nand": 2,
               "nor": 2, "maj3": 5, "min3": 6, "fa": 7}


def cuda_ms(fn, iters: int) -> float:
    """Mean time per call of `fn`, called eagerly `iters` times after a
    warm-up, between two CUDA events: what a caller pays, host launch
    cost included when it exceeds the device time."""
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


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Mean device time per call of `fn`: `iters` calls captured in one
    CUDA graph, replayed `replays` times between two CUDA events, so the
    host's per-call cost drops out."""
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


def profiled_device_ms(fn, iters: int) -> float:
    """Device time per call of the kernels `fn` launches: `iters` calls
    after a warm-up under `torch.profiler`, each kernel's device time
    summed, so the host's per-call cost drops out."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0
               and e.device_type.name == "CUDA") / 1e3 / iters


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(what: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs diff {err})")
    return err


def bound(bytes_moved: float, ops: float, ops_s: float = INT32_OPS_S):
    by_bytes = bytes_moved / HBM_BYTES_S * 1e3
    by_ops = ops / ops_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def check_close(what: str, got, want, atol: float,
                rtol: float | None = None) -> float:
    """|got - want| <= atol + rtol * |want| everywhere (numpy's
    assert_allclose; rtol defaults to atol); returns the max abs error."""
    rtol = atol if rtol is None else rtol
    got, want = got.to(torch.float32), want.to(torch.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    diff = (got - want).abs()
    if not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs diff {float(diff.max())})")
    return float(diff.max())


def sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    return float(smi.stdout.strip().splitlines()[0])


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    sources = ["pack_signs", "xnor_gemm", "aap_interp", "flash_attn_fwd",
               "flash_attn_bwd", "bitwise", "bitplane_add", "unpack_signs"]
    reports = _build.build(sources)
    missing = [n for n in sources if not _build._lib_path(n).exists()]
    if missing:
        raise AssertionError(f"no library built for {missing}")
    secs = time.time() - t0
    for name, text in sorted(reports.items()):
        entry = spill = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "spill stores" in line:
                spill = line.strip()
            elif "Used" in line:
                print(f"ptxas {name} {entry}: "
                      f"{line.split('info    :')[-1].strip()}; {spill}")
    print(f"build: {len(sources)} sources, {secs:.2f} s")
    check_tensor_cores(_build)


def check_tensor_cores(_build):
    """Count the tensor-core instructions of the flash kernels (HMMA) and
    of the XNOR GEMM (IMMA) in the built libraries' SASS ("sass" lines):
    the bfloat16 forward, dkv and dq kernels and the GEMM must have some,
    the float32 flash kernels none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, op in (("flash_attn_fwd", "HMMA"), ("flash_attn_bwd", "HMMA"),
                     ("xnor_gemm", "IMMA")):
        sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[-1].strip()
                counts[fn] = 0
            elif fn is not None and op in line:
                counts[fn] += 1
        if not counts:
            raise AssertionError(f"{name}: no function in the SASS")
        for fn, n in sorted(counts.items()):
            print("sass " + json.dumps({"source": name, "function": fn,
                                        op.lower(): n}))
            want = "bf16_kernel" in fn if op == "HMMA" else True
            if want != (n > 0):
                raise AssertionError(f"{name} {fn}: {n} {op} instructions")


def phase_kernels(rng):
    """Each kernel against its plain version; returns the per-kernel
    records measured at the up-projection's shapes."""
    from repro_torch.core import (AAP, DRIM_R, dcc_state_rows,
                                  encode_kernel_stream, kstream_slot)
    from repro_torch.kernels import aap_interpreter, packbits, xnor_popcount
    from repro_torch.kernels.ref import unpack_signs_ref
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave, serving_lowering
    dev = torch.device("cuda")
    d_model, d_ff = 768, 3072
    records = {}

    # -- sign packer ------------------------------------------------------
    # the FFN pair's float32 operands, the weights the packed serving route
    # packs once (float32, models/layers.py), the bfloat16 activations it
    # packs per forward (decode at batch 4, prefill at 4 x 256 tokens,
    # and the continuous batcher's), ragged K (the scalar path where a
    # row's bytes are not a multiple of 16) and a view one element in
    pack_shapes = [(M_ROWS, d_model, torch.float32, 0),   # up activations
                   (d_ff, d_model, torch.float32, 0),     # up weights
                   (M_ROWS, d_ff, torch.float32, 0),      # down activations
                   (d_model, d_ff, torch.float32, 0),     # down weights
                   (4, d_model, torch.bfloat16, 0),       # decode up
                   (4, d_ff, torch.bfloat16, 0),          # decode down
                   (1024, d_model, torch.bfloat16, 0),    # prefill up
                   (1024, d_ff, torch.bfloat16, 0),       # prefill down
                   # the continuous batcher's prefills (256 and 200
                   # tokens) and decode steps (2 slots)
                   (256, d_model, torch.bfloat16, 0),
                   (256, d_ff, torch.bfloat16, 0),
                   (200, d_model, torch.bfloat16, 0),
                   (200, d_ff, torch.bfloat16, 0),
                   (2, d_model, torch.bfloat16, 0),
                   (2, d_ff, torch.bfloat16, 0),
                   (300, 700, torch.bfloat16, 0),         # ragged R and K
                   (300, 700, torch.float32, 0),
                   (257, 33, torch.bfloat16, 0), (64, 1, torch.float32, 0),
                   (M_ROWS, d_model, torch.float32, 1),   # offset view
                   (1024, d_ff, torch.bfloat16, 1)]
    # beside the FFN pair's shape, the kernels line carries the served
    # shapes with the most launches: the decode activations and the weights
    served_keys = [(4, d_model, torch.bfloat16, 0),
                   (d_ff, d_model, torch.float32, 0)]
    served = []
    floor_ms = graph_ms(packbits.launch_floor, 50)
    print("detail " + json.dumps({"kernel": "empty", "launch_floor_ms":
                                  floor_ms}))
    for rows, k, dt, offset in pack_shapes:
        flat = rng.standard_normal(rows * k + offset, dtype=np.float32)
        x = torch.from_numpy(flat).to(dev, dt)[offset:].view(rows, k)
        x[0, :4] = torch.tensor([-0.0, float("nan"), 0.0, -1e-30])[:k]
        got = packbits.pack_signs(x)
        err = check_equal(f"pack_signs {rows}x{k} {dt} +{offset}", got,
                          packbits.pack_signs_plain(x))
        ms = graph_ms(lambda: packbits.pack_signs(x), 50)
        call_ms = cuda_ms(lambda: packbits.pack_signs(x), 200)
        plain_ms = graph_ms(lambda: packbits.pack_signs_plain(x), 20)
        nbytes = x.numel() * x.element_size() + got.numel() * 4
        b_ms, b_by = bound(nbytes, x.numel())
        detail = {"shape": [rows, k], "dtype": str(dt), "offset": offset,
                  "path": packbits.pack_path(x), "ms": ms,
                  "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": b_ms}
        print("detail " + json.dumps({"kernel": "pack_signs", **detail,
                                      "launch_floor_ms": floor_ms}))
        if (rows, k, dt, offset) in served_keys:
            served.append(detail)
        if (rows, k, dt, offset) == (M_ROWS, d_model, torch.float32, 0):
            records["pack_signs"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                launch_floor_ms=floor_ms,
                shape=f"[{rows},{k}] float32 -> [{rows},{-(-k // 32)}] int32")
    records["pack_signs"]["served"] = served

    # -- XNOR-popcount GEMM -------------------------------------------------
    # the FFN pair at M_ROWS rows, the serving decode (batch 4) and prefill
    # (batch 4 x 256 tokens) through both projections, ragged shapes
    gemm_shapes = [("ffn", M_ROWS, d_ff, d_model),
                   ("ffn", M_ROWS, d_model, d_ff),
                   ("decode", 4, d_ff, d_model), ("decode", 4, d_model, d_ff),
                   ("prefill", 1024, d_ff, d_model),
                   ("prefill", 1024, d_model, d_ff),
                   ("ragged", 100, 77, 700), ("ragged", 17, 9, 1)]
    for use, m, n, k in gemm_shapes:
        w = -(-k // 32)
        a = torch.from_numpy(rng.integers(-2**31, 2**31, (m, w),
                                          dtype=np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-2**31, 2**31, (n, w),
                                          dtype=np.int32)).to(dev)
        got = xnor_popcount.xnor_gemm_packed(a, b, k)
        err = check_equal(f"xnor_gemm {m}x{n}x{k}", got,
                          xnor_popcount.xnor_gemm_plain(a, b, k))
        ms = graph_ms(lambda: xnor_popcount.xnor_gemm_packed(a, b, k), 50)
        call_ms = cuda_ms(lambda: xnor_popcount.xnor_gemm_packed(a, b, k), 200)
        plain_ms = graph_ms(lambda: xnor_popcount.xnor_gemm_plain(a, b, k), 3)
        # The same function as one PyTorch call, yardsticks the port never
        # calls: torch._int_mm on the +-1 int8 operands (exact in int32;
        # it takes M > 16 and K, N multiples of 8), and beside it a
        # float32 torch.matmul, TF32 off (exact: every partial sum is an
        # integer below 2**24).
        pa8 = unpack_signs_ref(a, torch.int8)[:, :k].contiguous()
        pb8 = unpack_signs_ref(b, torch.int8)[:, :k].contiguous()
        library_ms, library_note = None, None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            if not torch.equal(torch._int_mm(pa8, pb8.T), got):
                raise AssertionError("torch._int_mm yardstick disagrees")
            library_ms = graph_ms(lambda: torch._int_mm(pa8, pb8.T), 50)
        else:
            library_note = ("torch._int_mm takes M > 16 and K, N multiples "
                            f"of 8, not {m} x {k} x {n}")
        pa, pb = pa8.to(torch.float32), pb8.to(torch.float32).T.contiguous()
        if not torch.equal(torch.matmul(pa, pb).to(torch.int32), got):
            raise AssertionError("float32 torch.matmul yardstick disagrees")
        library_fp32_ms = graph_ms(lambda: torch.matmul(pa, pb), 50)
        # the least time: inputs read once and the int32 output written
        # once over HBM, against 2 M N K int8 operations on the tensor cores
        b_ms, b_by = bound((m + n) * w * 4 + m * n * 4, 2 * m * n * k,
                           INT8_OPS_S)
        print("detail " + json.dumps({
            "kernel": "xnor_gemm", "use": use, "shape": [m, n, k], "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_note": library_note,
            "library_fp32_ms": library_fp32_ms, "bound_ms": b_ms,
            "bound_by": b_by}))
        if (m, n, k) == (M_ROWS, d_ff, d_model):
            records["xnor_gemm"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                library_fp32_ms=library_fp32_ms,
                shape=f"[{m},{w}] x [{n},{w}] int32, K={k} -> [{m},{n}] int32")

    # -- AAP interpreter ------------------------------------------------------
    low = serving_lowering(128, engine="cuda", geom=DRIM_R)
    fp = low.fp
    cols = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    # the decode shape the serving legs launch (K=128, one full DRIM-R
    # wave), the bulk phase's carry-save K=32 dot (one wave), the TMR
    # stream as the faults phase runs it fault-free (4 waves), and a
    # ragged soup
    graph, _ = bnn_dot_graph_carrysave(128)
    tmr = drim_compile(graph, geom=DRIM_R).lower("cuda", harden="tmr").fp
    k32 = drim_compile(bnn_dot_graph_carrysave(32)[0],
                       geom=DRIM_R).lower("cuda").fp
    cases = [("serving K=128", fp.program, fp.readback_rows,
              fp.template_rows, 1, len(fp.loaded_inputs), cols),
             ("K=32 dot", k32.program, k32.readback_rows, k32.template_rows,
              1, len(k32.loaded_inputs), cols),
             ("tmr K=128 fault-free", tmr.program, tmr.readback_rows,
              tmr.template_rows, 4, len(tmr.loaded_inputs), cols)]
    # ragged: a random soup over every word-line, DCC aliases included,
    # 3 waves of a column count that no block width divides
    n_rows = 20
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    cases.append(("ragged soup", soup, tuple(range(n_rows + 4)), n_rows, 3,
                  6, 1000))
    sm_clock_hz = sm_clock_mhz() * 1e6
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, prog, readback, n_rows_t, waves, n_in, ncols in cases:
        stream_np = encode_kernel_stream(prog, n_rows=n_rows_t)
        stream = torch.from_numpy(stream_np).to(dev)
        slot_list = [kstream_slot(r, n_rows_t) for r in readback]
        slots = torch.tensor(slot_list, dtype=torch.int32, device=dev)
        n_state = dcc_state_rows(n_rows_t)
        packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state,
                                             n_in)
        tiles = torch.from_numpy(rng.integers(
            -2**31, 2**31, (waves, n_in, ncols), dtype=np.int32)).to(dev)

        def run():
            return aap_interpreter.aap_interp(stream, tiles, slots, n_state,
                                              packed=packed)
        got = run()
        err = check_equal(f"aap_interp {label}", got,
                          aap_interpreter.aap_interp_plain(
                              stream, tiles, slots, n_state))
        check_equal(f"aap_interp {label} (plain twin)", got,
                    aap_interpreter.aap_interp_packed_plain(packed, tiles))
        ms = graph_ms(run, 10)
        call_ms = cuda_ms(run, 50)
        # The plain replay reads the stream to the host (`tolist`), which
        # a CUDA graph cannot capture: timed eagerly.
        plain_ms = cuda_ms(lambda: aap_interpreter.aap_interp_plain(
            stream, tiles, slots, n_state), 2)
        nbytes = tiles.numel() * 4 + got.numel() * 4 + \
            packed.words.nbytes + packed.loads.nbytes
        b_ms, b_by = bound(nbytes, len(prog) * waves * ncols)
        w, threads, _ = aap_interpreter.launch_geometry(
            packed.n_slots, ncols, waves, sms,
            aap_interpreter.words_choices(ncols, tiles.data_ptr()))
        smem_ms = smem_bound_ms(packed, waves, ncols, sms, sm_clock_hz)
        print("detail " + json.dumps({
            "kernel": "aap_interp", "case": label, "n_ins": len(prog),
            "n_in": n_in, "n_state": n_state, "slots": packed.n_slots,
            "peak_live": packed.peak_live, "waves": waves, "cols": ncols,
            "words_per_thread": w, "block_threads": threads,
            "block_cols": threads * w, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "smem_bound_ms": smem_ms, "sm_clock_mhz": sm_clock_hz / 1e6}))
        if label.startswith("serving"):
            records["aap_interp"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"{len(prog)} AAPs over [{waves},{n_in},{ncols}] "
                      f"int32, {packed.n_slots} slots of {n_state} state "
                      f"rows")

    records["aap_interp_faulted"] = phase_faulted_kernel(rng)
    records["flash_attn_fwd"] = phase_flash(rng)
    records.update(phase_flash_bwd(rng))
    records.update(phase_bulk_kernels(rng))
    return records


def smem_bound_ms(packed, waves: int, cols: int, sms: int,
                  sm_clock_hz: float) -> float:
    """The interpreter's shared-memory bound: per instruction its three
    reads and the writes that are read later (not to the sink, slot 1),
    per staged row its copy, per output its read, 4 bytes a word column,
    over the SMs' 128 bytes a clock."""
    fields = packed.words[:packed.n_ins].view(np.uint32)
    writes = np.stack([fields[:, 1] >> 16, fields[:, 2] & 0xFFFF,
                       fields[:, 2] >> 16, fields[:, 3] & 0xFFFF])
    accesses = 3 * packed.n_ins + int((writes != 1).sum()) + \
        len(packed.loads) - 4 + int((packed.out_map[:, 0] >= 0).sum())
    return accesses * 4 * waves * cols / (sms * 128 * sm_clock_hz) * 1e3


def faulted_operands(prog, n_rows, readback, waves, n_in, geom4, faults,
                     bank_geom, rng):
    """The fault-injecting interpreter's operands on the card, as the
    "cuda" engine builds them, over random tiles."""
    from repro_torch.core import dcc_state_rows, encode_kernel_stream, \
        kstream_slot
    from repro_torch.kernels import aap_interpreter
    dev = torch.device("cuda")
    c, b, s, w = geom4
    stream = torch.from_numpy(encode_kernel_stream(prog, n_rows=n_rows)).to(dev)
    thresh = torch.from_numpy(aap_interpreter._op_thresholds(
        prog, faults).view(np.int32)).to(dev)
    meta = aap_interpreter.column_meta(c, b, s, w, seed=faults.seed,
                                       bank_lo=bank_geom[0],
                                       banks_total=bank_geom[1], device=dev)
    slots = torch.tensor([kstream_slot(r, n_rows) for r in readback],
                         dtype=torch.int32, device=dev)
    stuck = torch.tensor(faults.stuck_rows, dtype=torch.int32,
                         device=dev).reshape(-1, 2)
    tiles = torch.from_numpy(rng.integers(
        -2**31, 2**31, (waves, n_in, c * b * s * w), dtype=np.int32)).to(dev)
    return (stream, thresh, meta, tiles, slots, dcc_state_rows(n_rows), stuck,
            32 * w)


def phase_faulted_kernel(rng):
    """The fault-injecting interpreter on its packed stream (stuck rows
    folded in, as the "cuda" engine packs it) against the plain replay and
    the packed twin: the TMR-hardened K=128 stream at the Table-3 corner
    over the faults phase's 4 DRIM-R waves, and a ragged soup with three
    stuck rows (an operand row, a result row and a DCC cell), protected
    ops and a bank offset.  Returns the record of the first."""
    from repro_torch.core import AAP, DRIM_R, FaultModel
    from repro_torch.kernels import aap_interpreter
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    graph, _ = bnn_dot_graph_carrysave(payload.K_BITS)
    tmr = drim_compile(graph, geom=DRIM_R).lower("cuda", harden="tmr")
    fp = tmr.fp
    corner = tmr._resolve_faults(FaultModel.from_corner(
        payload.CORNER, source="paper", seed=payload.SEED))
    geom4 = (DRIM_R.chips, DRIM_R.banks, DRIM_R.subarrays_per_bank,
             DRIM_R.row_bits // 32)
    n_rows = 20
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    ragged = FaultModel(p_dra=0.3, p_tra=0.4, seed=5,
                        stuck_rows=((2, 1), (17, 0), (21, 1)),
                        protected_ops=tuple(range(0, 300, 7)))
    cases = [("tmr K=128", fp.program, fp.readback_rows, fp.template_rows,
              payload.WAVES, len(fp.loaded_inputs), geom4, corner, (0, None)),
             ("ragged soup", soup, tuple(range(n_rows + 4)), n_rows, 3, 6,
              (1, 3, 37, 9), ragged, (2, 8))]
    record = None
    sm_clock_hz = sm_clock_mhz() * 1e6
    sms = torch.cuda.get_device_properties("cuda").multi_processor_count
    for label, prog, readback, n_rows_t, waves, n_in, g4, faults, bank in cases:
        args = faulted_operands(prog, n_rows_t, readback, waves, n_in, g4,
                                faults, bank, rng)
        stream, thresh, meta, tiles = args[:4]
        packed = aap_interpreter.pack_stream(
            stream.cpu().numpy(), args[4].tolist(), args[5], n_in,
            stuck=args[6].tolist())

        def run():
            return aap_interpreter.aap_interp_faulted(*args, packed=packed)
        got = run()
        err = check_equal(f"aap_interp_faulted {label}", got,
                          aap_interpreter.aap_interp_faulted_plain(*args))
        check_equal(f"aap_interp_faulted {label} (plain twin)", got,
                    aap_interpreter.aap_interp_packed_plain(
                        packed, tiles, thresh, meta, args[7]))
        ms = graph_ms(run, 5)
        call_ms = cuda_ms(run, 10)
        # the plain replay reads the stream to the host: timed eagerly
        plain_ms = cuda_ms(lambda: aap_interpreter.aap_interp_faulted_plain(
            *args), 1)
        armed = int((thresh != 0).sum())
        cols = tiles.shape[2]
        nbytes = 4 * (tiles.numel() + got.numel() + stream.numel()
                      + thresh.numel() + meta.numel())
        n_sub = cols // g4[3]           # sub-arrays: one draw each
        b_ms, b_by = bound(nbytes, waves * cols * len(prog)
                           + n_sub * HASH_OPS * armed)
        w, threads, _ = aap_interpreter.launch_geometry(
            packed.n_slots, cols, waves, sms,
            aap_interpreter.words_choices(cols, tiles.data_ptr()),
            faulted=True)
        flips = int((got != aap_interpreter.aap_interp(
            stream, tiles, args[4], args[5])).sum())
        if flips == 0:
            raise AssertionError(f"aap_interp_faulted {label}: no word "
                                 "differs from the fault-free kernel's")
        print("detail " + json.dumps({
            "kernel": "aap_interp_faulted", "case": label,
            "n_ins": len(prog), "armed": armed, "n_in": n_in,
            "n_state": args[5], "slots": packed.n_slots,
            "peak_live": packed.peak_live, "waves": waves, "cols": cols,
            "words_per_thread": w, "block_threads": threads,
            "stuck_rows": list(faults.stuck_rows),
            "words_differing_from_fault_free": flips,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "smem_bound_ms": smem_bound_ms(packed, waves, cols, sms,
                                           sm_clock_hz),
            "sm_clock_mhz": sm_clock_hz / 1e6}))
        if record is None:
            record = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                shape=f"{len(prog)} AAPs ({armed} armed) over [{waves},{n_in},"
                      f"{cols}] int32, {packed.n_slots} slots of {args[5]} "
                      f"state rows")
        del args, got
    return record


def phase_flash(rng):
    """Flash attention forward against its plain version; returns the
    record of the drim-bnn prefill shape."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    cases = [  # b, h, hkv, sq, sk, d, bq, bk, causal, dtype
        (4, 12, 4, 2048, 2048, 64, 128, 128, True, torch.bfloat16),
        (4, 12, 4, 256, 256, 64, 128, 128, True, torch.bfloat16),
        (1, 4, 1, 64, 192, 128, 64, 64, True, torch.float32),
        (1, 2, 2, 256, 256, 32, 128, 64, False, torch.float32),
        # the training step's shape, then the tensor-core kernel's edges
        (8, 12, 4, 256, 256, 64, 128, 128, True, torch.bfloat16),
        *FLASH_BF16_EDGES]
    record = None
    for b, h, hkv, sq, sk, d, bq, bk, causal, dt in cases:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt)
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
        n_rep = h // hkv

        def kernel():
            return fa.flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=bq,
                                bk=bk)

        def plain():
            return fa.flash_attention_plain(q, k, v, causal, n_rep)

        out, lse = kernel()
        want, want_lse = plain()
        label = f"flash {list(q.shape)} {dt} causal={causal}"
        err = check_close(label + " out", out, want, *FLASH_TOL[dt])
        lse_err = check_close(label + " lse", lse, want_lse, LSE_TOL)
        ms = graph_ms(kernel, 20)
        call_ms = cuda_ms(kernel, 50)
        plain_ms = cuda_ms(plain, 3)
        library_ms = lib_err = None
        if causal and sq == sk:
            # One PyTorch call computing the same function, a yardstick
            # the port never calls.
            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True)
            lib_err = float((library().float() - want.float()).abs().max())
            library_ms = graph_ms(library, 20)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
            + lse.numel() * 4
        flops = 4 * b * h * sq * sk * d * (0.5 if causal else 1.0)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_S)
        print("detail " + json.dumps({
            "kernel": "flash_attn_fwd", "q": list(q.shape),
            "kv": list(k.shape), "dtype": str(dt), "causal": causal,
            "max_abs_err": err, "lse_max_abs_err": lse_err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bound_ms": b_ms, "bound_by": b_by}))
        if record is None:
            record = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                shape=f"q {list(q.shape)} k/v {list(k.shape)} bfloat16, "
                      "causal")
        del q, k, v, out, lse, want, want_lse
    return record


def phase_flash_bwd(rng):
    """The flash backward kernels (dkv, dq) against the plain backward on
    the same q, k, v, do and the forward kernel's out and lse; returns
    their records at the training shape (q [8,12,256,64], bf16, causal).
    `library_ms` is SDPA's backward, `torch.autograd.grad` over one
    retained graph, timed eagerly (the autograd engine runs the backward
    on the forward's stream, so it cannot be captured alone), and
    `library_device_ms` the device time of the kernels it launches, summed
    under `torch.profiler`, free of the host's speed."""
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    cases = [  # b, h, hkv, sq, sk, d, causal, dtype
        (8, 12, 4, 256, 256, 64, True, torch.bfloat16),
        (4, 12, 4, 2048, 2048, 64, True, torch.bfloat16),
        (1, 4, 1, 64, 192, 128, True, torch.float32),
        (1, 2, 2, 256, 256, 32, False, torch.float32),
        *(c[:6] + c[8:] for c in FLASH_BF16_EDGES)]
    records = {}
    for b, h, hkv, sq, sk, d, causal, dt in cases:
        q, k, v, do = (torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).to(dev, dt) for shape in
            ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, h, sq, d)))
        n_rep = h // hkv
        out, lse = fa.flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=64,
                                bk=64)
        delta = fa._delta(out, do)

        def dkv():
            return fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal,
                                    n_rep=n_rep)

        def dq():
            return fa.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal,
                                   n_rep=n_rep)

        def plain():
            return fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                causal, n_rep)

        want_q, want_k, want_v = plain()
        label = f"flash bwd {list(q.shape)} {dt} causal={causal}"
        got_k, got_v = dkv()
        got_q = dq()
        errs = {"dk": check_close(label + " dk", got_k, want_k,
                                  *BWD_TOL[dt]),
                "dv": check_close(label + " dv", got_v, want_v,
                                  *BWD_TOL[dt]),
                "dq": check_close(label + " dq", got_q, want_q,
                                  *BWD_TOL[dt])}
        if causal and sk > sq:
            # keys past the last query: no query sees them
            hidden = torch.cat([got_k[:, :, sq:], got_v[:, :, sq:]])
            if bool(hidden.any()):
                raise AssertionError(f"{label}: dk/dv of keys no query sees "
                                     "are not exactly 0")
        plain_ms = cuda_ms(plain, 3)
        library_ms = library_device_ms = lib_err = None
        if causal and sq == sk:
            # One PyTorch call computing the same gradients, a yardstick
            # the port never calls.
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (q, k, v))
            lo = torch.nn.functional.scaled_dot_product_attention(
                lq, lk, lv, is_causal=True, enable_gqa=True)

            def library():
                return torch.autograd.grad(lo, (lq, lk, lv), do,
                                           retain_graph=True)
            lib_err = max(float((g.float() - w.float()).abs().max())
                          for g, w in zip(library(), (want_q, want_k,
                                                      want_v)))
            library_ms = cuda_ms(library, 20)
            library_device_ms = profiled_device_ms(library, 20)
        half = 0.5 if causal else 1.0
        esize = q.element_size()
        for name, fn, n_prod, outs in (("flash_bwd_dkv", dkv, 4,
                                        k.numel() + v.numel()),
                                       ("flash_bwd_dq", dq, 3, q.numel())):
            ms = graph_ms(fn, 20)
            call_ms = cuda_ms(fn, 50)
            nbytes = (2 * q.numel() + k.numel() + v.numel() + outs) * esize \
                + 2 * lse.numel() * 4
            flops = 2 * n_prod * b * h * sq * sk * d * half
            b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_S)
            err = max(errs[g] for g in (("dk", "dv") if name ==
                                         "flash_bwd_dkv" else ("dq",)))
            rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=library_ms,
                       library_device_ms=library_device_ms,
                       shape=f"q {list(q.shape)} k/v {list(k.shape)} "
                             f"{str(dt).split('.')[-1]}, causal={causal}")
            print("detail " + json.dumps({
                "kernel": name, "causal": causal, "dtype": str(dt),
                "library_max_abs_err": lib_err, **rec}))
            records.setdefault(name, rec)
        del q, k, v, do, out, lse, delta, want_q, want_k, want_v
    return records


def card_words(rng, n: int, offset: int = 0) -> torch.Tensor:
    """n random int32 words on the card, starting `offset` words into
    their own buffer (offset 1 puts the start 4 bytes off 16-byte
    alignment)."""
    return torch.from_numpy(rng.integers(-2**31, 2**31, n + offset,
                                         dtype=np.int32)).cuda()[offset:]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def bitwise_kernel(op: str):
    """(counter name, arity, words moved per operand word) of the bulk
    kernel that runs bit-wise `op`."""
    from repro_torch.kernels.bitwise import BINARY_OPS, TERNARY_OPS
    if op in TERNARY_OPS:
        return "bitwise_ternary", 3, 5 if op == "fa" else 4
    if op in BINARY_OPS:
        return "bitwise_binary", 2, 3
    return "bitwise_not", 1, 2


def phase_bulk_kernels(rng):
    """The bulk bit-wise kernels, the bit-plane adder and the sign
    unpacker against their plain versions, exactly, at the bulk phase's
    shapes and at ragged ones; returns their records (not, xor, fa at
    2**24 words; the adder at [32, 2**19]; the unpacker at the up
    projection's packed weights [3072, 24] to bfloat16)."""
    from repro_torch.kernels import bitserial_add, packbits
    from repro_torch.kernels.bitwise import (BINARY_OPS, TERNARY_OPS,
                                             UNARY_OPS, bitwise,
                                             bitwise_plain)
    records = {}
    # -- bitwise: every op at the bulk length, a ragged length, a
    # misaligned start and empty -----------------------------------------
    bulk = [card_words(rng, BULK_WORDS) for _ in range(3)]
    cases = [("bulk", bulk),
             ("ragged", [card_words(rng, 1000003) for _ in range(3)]),
             ("offset 1", [card_words(rng, 1000003, 1) for _ in range(3)]),
             ("offset 1, 2 words", [card_words(rng, 2, 1)
                                    for _ in range(3)]),
             ("empty", [card_words(rng, 0) for _ in range(3)])]
    arity = {op: bitwise_kernel(op)[1]
             for op in UNARY_OPS + BINARY_OPS + TERNARY_OPS}
    errs = {}
    for label, operands in cases:
        for op, k in arity.items():
            args = operands[:k]
            got, want = (as_tuple(bitwise(op, *args)),
                         as_tuple(bitwise_plain(op, *args)))
            for g, w in zip(got, want):
                errs[op] = max(errs.get(op, 0), check_equal(
                    f"bitwise {op} {label}", g, w))
    print("detail " + json.dumps({
        "kernel": "bitwise", "cases": [c[0] for c in cases],
        "ops": list(arity), "exact": True}))
    library = {"not": torch.bitwise_not, "xor": torch.bitwise_xor}
    for name, op in (("bitwise_not", "not"), ("bitwise_binary", "xor"),
                     ("bitwise_binary", "xnor"), ("bitwise_ternary", "fa")):
        args = bulk[:arity[op]]
        ms = graph_ms(lambda: bitwise(op, *args), 50)
        call_ms = cuda_ms(lambda: bitwise(op, *args), 200)
        plain_ms = graph_ms(lambda: bitwise_plain(op, *args), 20)
        library_ms = None
        if op in library:
            if not torch.equal(library[op](*args), bitwise(op, *args)):
                raise AssertionError(f"torch yardstick for {op} disagrees")
            library_ms = graph_ms(lambda: library[op](*args), 50)
        b_ms, b_by = bound(bitwise_kernel(op)[2] * 4 * BULK_WORDS,
                           BITWISE_OPS[op] * BULK_WORDS)
        rec = dict(max_abs_err=errs[op], ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms,
                   shape=f"{op}: {arity[op]} x [{BULK_WORDS}] int32 -> "
                         f"{2 if op == 'fa' else 1} x [{BULK_WORDS}]")
        print("detail " + json.dumps({"kernel": name, "op": op, **rec}))
        if op != "xnor":
            records[name] = rec
    del bulk, cases

    # -- bit-plane adder --------------------------------------------------
    add_cases = [("bulk", ADD_PLANES, 0), ("1 plane", (1, 1001), 0),
                 ("33 planes", (33, 1001), 0),
                 ("33 planes, offset 1", (33, 1000), 1),
                 ("empty", (8, 0), 0)]
    for label, (nbits, w), offset in add_cases:
        a, b = (card_words(rng, nbits * w, offset).view(nbits, w)
                for _ in range(2))
        s, c = bitserial_add.bitplane_add(a, b)
        want_s, want_c = bitserial_add.bitplane_add_plain(a, b)
        err = max(check_equal(f"bitplane_add {label} sum", s, want_s),
                  check_equal(f"bitplane_add {label} carry", c, want_c))
        if label != "bulk":
            continue
        ms = graph_ms(lambda: bitserial_add.bitplane_add(a, b), 50)
        call_ms = cuda_ms(lambda: bitserial_add.bitplane_add(a, b), 200)
        plain_ms = graph_ms(lambda: bitserial_add.bitplane_add_plain(a, b),
                            5)
        b_ms, b_by = bound(4 * (3 * nbits + 1) * w, 7 * nbits * w)
        records["bitplane_add"] = dict(
            max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=f"2 x [{nbits},{w}] int32 -> [{nbits},{w}] + [{w}]")
        print("detail " + json.dumps({"kernel": "bitplane_add",
                                      **records["bitplane_add"]}))
    print("detail " + json.dumps({"kernel": "bitplane_add", "exact": True,
                                  "cases": [c[0] for c in add_cases]}))

    # -- sign unpacker: the drim-bnn up projection's weights [d_ff, d_model]
    # packed by the pack kernel, then ragged and empty ----------------------
    w_up = torch.from_numpy(rng.standard_normal((3072, 768),
                                                dtype=np.float32)).cuda()
    packed = packbits.pack_signs(w_up)
    unpack_cases = [("ffn weights", packed),
                    ("offset 1", card_words(rng, 130 * 33, 1).view(130, 33)),
                    ("empty", card_words(rng, 0).view(0, 4))]
    for label, p in unpack_cases:
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            got = packbits.unpack_signs(p, dt)
            err = check_equal(f"unpack_signs {label} {dt}", got,
                              packbits.unpack_signs_plain(p, dt))
            if label != "ffn weights":
                continue
            if not torch.equal(got.to(torch.float32),
                               torch.where(w_up >= 0, 1.0, -1.0)):
                raise AssertionError("unpack(pack(w)) is not sign(w)")
            ms = graph_ms(lambda: packbits.unpack_signs(p, dt), 50)
            call_ms = cuda_ms(lambda: packbits.unpack_signs(p, dt), 200)
            plain_ms = graph_ms(lambda: packbits.unpack_signs_plain(p, dt),
                                20)
            n = p.numel()
            b_ms, b_by = bound(n * (4 + 32 * got.element_size()), 64 * n)
            rec = dict(max_abs_err=err, ms=ms, call_ms=call_ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None,
                       shape=f"[{p.shape[0]},{p.shape[1]}] int32 -> "
                             f"[{p.shape[0]},{32 * p.shape[1]}] {dt}")
            print("detail " + json.dumps({"kernel": "unpack_signs",
                                          "dtype": str(dt), **rec}))
            if dt == torch.bfloat16:
                records["unpack_signs"] = rec
    return records


def sign_planes(x: np.ndarray, nbits: int) -> np.ndarray:
    """[nbits, n / 32] uint32 bit planes of uint64 values x: bit j of word
    c of plane i is bit i of element 32 c + j."""
    shifts = np.arange(32, dtype=np.uint64)
    return np.stack([(((x >> np.uint64(i)) & np.uint64(1)).reshape(-1, 32)
                      << shifts).sum(1).astype(np.uint32)
                     for i in range(nbits)])


def plane_values(planes: np.ndarray) -> np.ndarray:
    """The uint64 values of [nbits, W] uint32 bit planes (sign_planes'
    inverse)."""
    shifts = np.arange(32, dtype=np.uint64)
    vals = np.zeros(planes.shape[1] * 32, np.uint64)
    for i, plane in enumerate(planes.astype(np.uint64)):
        vals |= (((plane[:, None] >> shifts) & np.uint64(1)).ravel()
                 << np.uint64(i))
    return vals


def phase_analog(wrappers):
    """The paper's Table-3 Monte-Carlo on the card (five corners, 10,000
    trials, seed 0) and `FaultModel.from_corner(0.15, source="sim")`,
    held to the counts the port records (`launch.analog.EXPECTED`, held to
    the reference by the CPU tests); then a 32-bit `multibit_add_program`
    (7 AAPs a bit slice) over one full DRIM-R wave on the AAP interpreter,
    held to numpy's a + b.  Returns the phase's launch counts: the
    interpreter once, nothing else."""
    from repro_torch.core import (DRIM_R, dcc_state_rows,
                                  encode_kernel_stream, kstream_slot,
                                  make_subarray, multibit_add_program)
    from repro_torch.kernels import aap_interpreter
    from repro_torch.launch import analog
    dev = torch.device("cuda")
    nbits = 32
    sa = make_subarray(n_data=4 * nbits + 1, row_bits=32)   # a template
    a_rows, b_rows = range(nbits), range(nbits, 2 * nbits)
    cin = 2 * nbits                                         # stays zero
    sum_rows = range(cin + 1, cin + 1 + nbits)
    carry_rows = range(cin + 1 + nbits, cin + 1 + 2 * nbits)
    prog = multibit_add_program(sa, a_rows, b_rows, cin, sum_rows,
                                carry_rows)
    stream_np = encode_kernel_stream(prog, n_rows=sa.n_rows)
    slot_list = [kstream_slot(r, sa.n_rows)
                 for r in (*sum_rows, carry_rows[-1])]
    n_state = dcc_state_rows(sa.n_rows)
    cols = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    rng = np.random.default_rng([SEED, 19])
    a, b = (rng.integers(0, 1 << 32, cols * 32, dtype=np.uint64)
            for _ in range(2))
    tiles = np.concatenate([sign_planes(a, nbits), sign_planes(b, nbits)])
    packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state,
                                         2 * nbits)

    def run():
        t0 = time.perf_counter()
        mc = analog.run(dev)
        out = aap_interpreter.aap_interp(
            torch.from_numpy(stream_np).to(dev),
            torch.from_numpy(tiles.view(np.int32)[None]).to(dev),
            torch.tensor(slot_list, dtype=torch.int32, device=dev),
            n_state, packed=packed)
        torch.cuda.synchronize()
        return mc, out, time.perf_counter() - t0

    (mc, out, wall_s), counts = counted(wrappers, "analog", run,
                                        lambda _: {"aap_interp": 1})
    got = plane_values(out[0].cpu().numpy().view(np.uint32))
    if not np.array_equal(got, a + b):
        bad = int(np.flatnonzero(got != a + b)[0])
        raise AssertionError(f"multibit add: element {bad} is {got[bad]}, "
                             f"not {a[bad]} + {b[bad]}")
    print("analog " + json.dumps({
        **mc, "multibit_add": {"bits": nbits, "aaps": len(prog),
                               "elements": cols * 32, "exact": True},
        "wall_s": wall_s}))
    return counts


def phase_bulk(wrappers):
    """Fig. 8 on the card: the paper's three ops at 2**29 bits on the
    native "gpu" comparator and on the DRIM-R fleet ("cuda"), the 32-bit
    word add, the carry-save serving dot at full width on both engines,
    and the FFN weights packed and unpacked, counted; then the times
    ("bulk" lines).  Returns the phase's launch counts."""
    from repro_torch.core import (DRIM_R, PAPER_CLAIMS, all_platforms,
                                  drim_throughput_bits)
    from repro_torch.kernels import ops
    from repro_torch.kernels.bitserial_add import bitplane_add_plain
    from repro_torch.kernels.bitwise import bitwise_plain
    from repro_torch.pim import compile as drim_compile, graph_ref_results
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    from repro_torch.pim.compiler import NATIVE_OP
    from repro_torch.pim.scheduler import OP_ARITY
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    planes = [card_words(rng, BULK_WORDS) for _ in range(3)]
    graph, _ = bnn_dot_graph_carrysave(32)
    g_words = DRIM_R.n_subarrays * DRIM_R.row_bits // 32    # one wave
    g_feeds = {n: (np.zeros(g_words, np.uint32) if n == "zero" else
                   rng.integers(0, 1 << 32, g_words, dtype=np.uint32))
               for n in graph.input_names}
    w_up = torch.from_numpy(rng.standard_normal(
        (3072, 768), dtype=np.float32)).to(dev, torch.bfloat16)
    waves = BULK_BITS // DRIM_R.parallel_bits
    lowered = {op: drim_compile(op).lower("gpu") for op in FIG8_OPS}
    drim_s = {}

    def body():
        for op in FIG8_OPS:
            args = planes[:OP_ARITY[op]]
            low = lowered[op]
            got = low.run(*args, n_bits=BULK_BITS, device=dev)
            if low.schedule != low.cost(BULK_BITS):
                raise AssertionError(f"{op}: gpu schedule != cost")
            want = as_tuple(bitwise_plain(NATIVE_OP[op], *args))
            torch.cuda.synchronize()
            t = time.perf_counter()
            drim = drim_compile(op).lower("cuda").run(*args, device=dev)
            torch.cuda.synchronize()
            drim_s[op] = time.perf_counter() - t
            if low.schedule.n_bits != BULK_BITS or len(got) != len(want):
                raise AssertionError(f"{op}: bad result arity or n_bits")
            for g, w, d in zip(got, want, drim):
                check_equal(f"bulk {op} gpu vs plain", g, w)
                check_equal(f"bulk {op} gpu vs cuda (DRIM-R)", g, d)
            del got, want, drim
        a, b = (t.view(*ADD_PLANES) for t in planes[:2])
        s, c = ops.bitplane_add(a, b)
        want_s, want_c = bitplane_add_plain(a, b)
        check_equal("bulk 32-bit add sum", s, want_s)
        check_equal("bulk 32-bit add carry", c, want_c)
        del s, c, want_s, want_c
        on_card = {n: torch.from_numpy(v.view(np.int32)).to(dev)
                   for n, v in g_feeds.items()}
        native = drim_compile(graph).lower("gpu").run(on_card, device=dev)
        fleet = drim_compile(graph).lower("cuda").run(on_card, device=dev)
        oracle = graph_ref_results(graph, g_feeds)
        if set(native) != set(oracle) or set(fleet) != set(oracle):
            raise AssertionError("carry-save K=32: output names differ")
        for name, want in oracle.items():
            w = torch.from_numpy(want.view(np.int32))
            check_equal(f"carry-save {name} gpu vs cuda", native[name],
                        fleet[name])
            check_equal(f"carry-save {name} gpu vs oracle",
                        native[name].cpu(), w)
        signs = ops.unpack_signs(ops.pack_signs(w_up), torch.bfloat16)
        if not torch.equal(signs, torch.where(w_up >= 0, 1.0, -1.0)
                           .to(torch.bfloat16)):
            raise AssertionError("unpack(pack(w_up)) is not sign(w_up)")

    def expected(_):
        """One bulk kernel per "gpu" op run and per non-copy graph node,
        by kind; the interpreter once per "cuda" run; the adder, packer
        and unpacker once each."""
        nodes = [NATIVE_OP[op] for op, _, _ in graph.nodes if op != "copy"]
        per = {"bitwise_not": 0, "bitwise_binary": 0, "bitwise_ternary": 0}
        for op in [NATIVE_OP[op] for op in FIG8_OPS] + nodes:
            per[bitwise_kernel(op)[0]] += 1
        per.update(aap_interp=len(FIG8_OPS) + 1, bitplane_add=1,
                   pack_signs=1, unpack_signs=1)
        return per

    _, counts = counted(wrappers, "bulk", body, expected)
    print("bulk " + json.dumps({
        "exact": True, "n_bits": BULK_BITS, "drim_r_waves": waves,
        "carry_save_k32_words": g_words,
        "carry_save_k32_nodes": len(graph.nodes),
        "drim_r_cuda_run_s": drim_s}))

    # -- times (not counted) ---------------------------------------------------
    plats = all_platforms()
    h100, model_gpu, drim_r = {}, {}, {}
    for op in FIG8_OPS:
        args = planes[:OP_ARITY[op]]
        native = NATIVE_OP[op]
        kernel_ms = graph_ms(lambda: ops.bitwise(native, *args), 50)
        run_ms = cuda_ms(lambda: lowered[op].run(*args, device=dev), 50)
        line = {"op": op, "kernel": bitwise_kernel(native)[0],
                "bitwise_op": native, "kernel_ms": kernel_ms,
                "gpu_engine_run_ms": run_ms}
        moved = bitwise_kernel(native)[2] * 4 * BULK_WORDS
        if op == "add":
            # Fig. 8's GPU adds words (3 bits moved per output bit); the
            # full adder above is one bit-slice of DRIM's bit-serial add
            line.update(fa_gbit_s=BULK_BITS / (kernel_ms * 1e-3) / 1e9,
                        fa_hbm_share=moved / (kernel_ms * 1e-3)
                        / HBM_BYTES_S)
            a, b = (t.view(*ADD_PLANES) for t in planes[:2])
            kernel_ms = graph_ms(lambda: ops.bitplane_add(a, b), 50)
            moved = 4 * (3 * ADD_PLANES[0] + 1) * ADD_PLANES[1]
            line.update(word_add=f"bitplane_add {list(ADD_PLANES)}",
                        word_add_ms=kernel_ms)
        h100[op] = BULK_BITS / (kernel_ms * 1e-3) / 1e9
        drim_r[op] = drim_throughput_bits(DRIM_R, op) / 1e9
        model_gpu[op] = plats["GPU"].throughput_bits(op) / 1e9
        line.update(h100_gbit_s=h100[op],
                    hbm_share=moved / (kernel_ms * 1e-3) / HBM_BYTES_S,
                    drim_r_model_gbit_s=drim_r[op],
                    paper_gpu_model_gbit_s=model_gpu[op],
                    drim_over_h100=drim_r[op] / h100[op],
                    drim_over_paper_gpu=drim_r[op] / model_gpu[op])
        print("bulk " + json.dumps(line))

    def avg(rows):
        return float(np.mean([rows[op] for op in FIG8_OPS]))

    print("bulk " + json.dumps({
        "summary": "DRIM-R over GPU, op-averaged (fig8_throughput.ratios)",
        "drim_over_h100": avg(drim_r) / avg(h100),
        "drim_over_paper_gpu_model": avg(drim_r) / avg(model_gpu),
        "paper_claim": PAPER_CLAIMS[("DRIM-R", "GPU")]}))
    return counts


def check_ste_product(rng):
    """The dense STE product on the card at a decode shape (M=4, K=3072,
    the down projection): the port's float32 product rounded once must
    equal the exact dot; also reports whether a plain bfloat16 matmul of
    the same ±1 operands (the formulation before the float32 repair)
    happens to round the same way on this card."""
    from repro_torch.models import layers
    dev = torch.device("cuda")
    x = torch.from_numpy(rng.standard_normal((4, 3072), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3072, 768), dtype=np.float32))
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    sx = torch.where(x >= 0, 1.0, -1.0)
    sw = torch.where(w >= 0, 1.0, -1.0)
    exact = (sx.double() @ sw.double()).to(torch.bfloat16)
    alpha = w.abs().mean(0)
    got = layers.bitlinear({"bkernel": w}, x)
    if not torch.equal(got, exact * alpha):
        raise AssertionError("dense STE product is not the exact dot")
    bf16 = sx.to(torch.bfloat16) @ sw.to(torch.bfloat16)
    print("detail " + json.dumps({
        "check": "bfloat16 ±1 product, M=4 K=3072 N=768",
        "float32_route_exact": True,
        "bfloat16_matmul_differs": int((bf16 != exact).sum())}))


def phase_path(rng):
    """The drim-bnn FFN BitLinear pair at full width, both routes."""
    from repro_torch.configs.drim_bnn import CONFIG
    from repro_torch.core import DRIM_R
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import xnor_gemm_dense_ref
    from repro_torch.models.layers import bitlinear_from_jax, serving_engine
    from repro_torch.pim.bnn import serve_bnn_matmul
    dev = torch.device("cuda")
    d_model, d_ff = CONFIG.d_model, CONFIG.d_ff
    x_np = rng.standard_normal((M_ROWS, d_model), dtype=np.float32)
    w_up = rng.standard_normal((d_model, d_ff), dtype=np.float32) \
        / np.sqrt(d_model)
    w_down = rng.standard_normal((d_ff, d_model), dtype=np.float32) \
        / np.sqrt(d_ff)

    x = torch.from_numpy(x_np).to(dev)
    x_cpu = torch.from_numpy(x_np)
    for name, w in (("up", w_up), ("down", w_down)):
        k = w.shape[0]
        t0 = time.perf_counter()
        layer = bitlinear_from_jax({"bkernel": w}, device=dev).pack()
        y_native = layer(x)
        d_native = ops.binary_matmul(x, layer.w_packed, k, dtype=torch.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with serving_engine("cuda", geom=DRIM_R):
            y_drim = layer(x)
        d_drim = serve_bnn_matmul(
            ops.sign_bits(x), ops.unpack_sign_bits(layer.w_packed, k),
            engine="cuda", geom=DRIM_R, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d_ref = xnor_gemm_dense_ref(x_cpu, torch.from_numpy(w).T)
        for route, d in (("native", d_native), ("drim", d_drim)):
            if d.shape != (M_ROWS, w.shape[1]) or \
                    not torch.equal(d.cpu(), d_ref):
                raise AssertionError(f"{name}: {route} route dots differ "
                                     "from the plain reference")
        if not torch.equal(y_native, y_drim):
            raise AssertionError(f"{name}: native and DRIM BitLinear "
                                 "outputs differ")
        if not torch.isfinite(y_native).all():
            raise AssertionError(f"{name}: non-finite BitLinear output")
        print("path " + json.dumps({
            "projection": name, "m": M_ROWS, "k": k, "n": w.shape[1],
            "native_route_s": t1 - t0, "drim_route_s": t2 - t1,
            "dots_equal_reference": True}))
        x, x_cpu = y_native, y_native.cpu()


def serve_line(leg: str, stats) -> None:
    keys = ("prefill_s", "compile_s", "decode_tok_per_s", "decode_p50_ms",
            "decode_p99_ms", "n_waves", "wall_s", "tok_per_s")
    print("serve " + json.dumps({"leg": leg, **{k: stats[k] for k in keys
                                                if k in stats}}))


def expected_launches(cfg, *, packed: bool, native_fwd: int,
                      drim_steps: int, aligned: int):
    """The launches a serving leg must make: flash once per layer per
    prefill whose length is a multiple of 128 (`aligned` of them); on a
    packed route the packer once per BitLinear weight matrix (the offline
    packing) and, like the GEMM, once per BitLinear per native forward
    (`native_fwd`: each prefill, the bit-exactness check's packed step,
    each native decode step); the interpreter once per K chunk per
    BitLinear per DRIM decode step."""
    from repro_torch.pim.bnn import k_chunks
    n_bl = 3 * cfg.n_layers                      # gate, up, down per layer
    chunks = cfg.n_layers * sum(len(k_chunks(k)) for k in
                                (cfg.d_model, cfg.d_model, cfg.d_ff))
    gemm = n_bl * native_fwd if packed else 0
    return {"pack_signs": gemm + n_bl if packed else 0, "xnor_gemm": gemm,
            "aap_interp": chunks * drim_steps, "aap_interp_faulted": 0,
            "flash_attn_fwd": cfg.n_layers * aligned}


def counted(wrappers, leg: str, run, want_of):
    """Zero every launch counter, `run()`, read the counters and hold them
    to `want_of(result)` (a counter it does not name must stay 0);
    returns (result, counts)."""
    for fn in wrappers.values():
        fn.launches = 0
    result = run()
    got = {name: fn.launches for name, fn in wrappers.items()}
    print("counts " + json.dumps({"phase": leg, **got}))
    named = want_of(result)
    if not set(named) <= set(wrappers):
        raise AssertionError(f"{leg}: no counter for {set(named) - set(wrappers)}")
    want = {name: named.get(name, 0) for name in wrappers}
    if got != want:
        raise AssertionError(f"{leg}: launches {got}, expected {want}")
    return result, got


def phase_serve(wrappers):
    """The drim-bnn LM served at full width and depth through the serving
    entry points, three routes with identical tokens; then the continuous
    batcher on two routes.  Each leg's launches are counted on their own;
    returns them by leg."""
    from repro_torch.launch import serve
    legs = {"gpu dense": ["--engine", "gpu"],
            "gpu packed": ["--engine", "gpu", "--packed"],
            "cuda packed": ["--engine", "cuda", "--packed"]}
    cfg = serve.build_cfg(serve.parse_args(SERVE))
    n_gen = 8
    # native forwards of a static leg: the prefill, then on the native
    # packed route the bit-exactness check's packed step and every decode
    # step (the warm-up included); the DRIM route decodes on the fleet
    native = {"gpu dense": 0, "gpu packed": 2 + n_gen, "cuda packed": 2}
    gens, counts = {}, {}
    for leg, extra in legs.items():
        args = serve.parse_args(SERVE + extra)
        (gen, stats), counts[leg] = counted(
            wrappers, leg, lambda: serve.run_serve(args),
            lambda _, leg=leg, args=args: expected_launches(
                cfg, packed=args.packed, native_fwd=native[leg],
                drim_steps=n_gen if args.engine == "cuda" else 0,
                aligned=1))
        if gen.shape != (4, n_gen) or gen.min() < 0 \
                or gen.max() >= cfg.vocab_size:
            raise AssertionError(f"{leg}: bad token ids {gen.tolist()}")
        gens[leg] = gen
        serve_line(leg, stats)
    first = gens["gpu dense"]
    for leg, gen in gens.items():
        if not np.array_equal(gen, first):
            raise AssertionError(f"{leg} tokens {gen.tolist()} differ from "
                                 f"gpu dense {first.tolist()}")
    print("serve " + json.dumps({"tokens_identical": True,
                                 "tokens": first.tolist()}))

    prompts = [np.random.default_rng([SEED, 2]).integers(0, cfg.vocab_size, n)
               for n in (256, 200)]
    results = {}
    for leg in ("gpu packed", "cuda packed"):
        args = serve.parse_args(SERVE + legs[leg] + ["--batch", "2",
                                                     "--continuous", "2"])
        drim = args.engine == "cuda"
        # one prefill per request, only the 256-token one aligned; one
        # decode step per wave
        (res, stats), counts["continuous " + leg] = counted(
            wrappers, "continuous " + leg,
            lambda: serve.run_continuous(args, prompts=prompts),
            lambda out, drim=drim: expected_launches(
                cfg, packed=True,
                native_fwd=2 + (0 if drim else out[1]["n_waves"]),
                drim_steps=out[1]["n_waves"] if drim else 0, aligned=1))
        serve_line("continuous " + leg, stats)
        results[leg] = res
    for r in range(2):
        a, b = results["gpu packed"][r], results["cuda packed"][r]
        if len(a) != n_gen or not np.array_equal(a, b):
            raise AssertionError(f"continuous request {r}: {a.tolist()} vs "
                                 f"{b.tolist()}")
    print("serve " + json.dumps({"continuous_tokens_identical": True,
                                 "tokens": {r: v.tolist() for r, v in
                                            results["gpu packed"].items()}}))
    return counts


def phase_faults(wrappers):
    """Table-3 fault injection on the K=128 serving dot at full width on
    DRIM-R, every harden scheme, engines held bit-identical; returns the
    phase's launch counts."""
    from repro_torch.core import DRIM_R, FaultModel
    from repro_torch.launch import faults as payload
    from repro_torch.pim import compile as drim_compile, graph_ref_results
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    dev = torch.device("cuda")
    graph, _ = bnn_dot_graph_carrysave(payload.K_BITS)
    n_words = payload.WAVES * DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    feeds = payload.fault_feeds(graph, n_words)
    t0 = time.perf_counter()
    oracle = graph_ref_results(graph, feeds)
    oracle_s = time.perf_counter() - t0
    on_card = {n: torch.from_numpy(a.view(np.int32)).to(dev)
               for n, a in feeds.items()}
    corner = FaultModel.from_corner(payload.CORNER, source="paper",
                                    seed=payload.SEED)

    def run(engine, scheme, faults):
        low = drim_compile(graph, geom=DRIM_R).lower(engine, harden=scheme,
                                                     faults=faults)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = low.run(on_card, device=dev)
        torch.cuda.synchronize()
        return low, out, time.perf_counter() - t

    def body():
        lines = {}
        for scheme in payload.SCHEMES:
            engines = ("cuda", "resident") + (
                ("baseline",) if scheme in (None, "tmr") else ())
            runs = {eng: run(eng, scheme, corner) for eng in engines}
            low, first, _ = runs["cuda"]
            if set(first) != set(oracle) or any(
                    t.shape != (n_words,) for t in first.values()):
                raise AssertionError(f"faults {scheme}: outputs "
                                     f"{sorted(first)} of the wrong shape")
            for eng, (other, out, _) in runs.items():
                if set(out) != set(first) or not all(
                        torch.equal(out[k], first[k]) for k in first):
                    raise AssertionError(f"faults {scheme}: engine {eng} "
                                         "differs from cuda")
                if other.last_ecc != low.last_ecc:
                    raise AssertionError(f"faults {scheme}: {eng} ECC "
                                         f"{other.last_ecc} != "
                                         f"{low.last_ecc}")
            line = {"scheme": scheme or "none", "aaps_per_tile": low.aaps,
                    "corrupted_bits": payload.corrupted_bits(first, oracle),
                    "ecc_mismatch_bits": (low.last_ecc.mismatch_bits
                                          if low.last_ecc else None),
                    "engines_identical": True,
                    "engine_s": {eng: r[2] for eng, r in runs.items()}}
            print("faults " + json.dumps(line))
            lines[scheme] = line
            del runs, first, low
        _, clean, secs = run("cuda", "tmr", None)
        if payload.corrupted_bits(clean, oracle) != 0:
            raise AssertionError("the fault-free tmr run differs from the "
                                 "oracle")
        print("faults " + json.dumps({"scheme": "tmr", "faults": None,
                                      "corrupted_bits": 0,
                                      "engine_s": {"cuda": secs},
                                      "oracle_cpu_s": oracle_s}))
        return lines

    lines, counts = counted(
        wrappers, "faults", body,
        lambda _: {"pack_signs": 0, "xnor_gemm": 0, "aap_interp": 1,
                   "aap_interp_faulted": len(payload.SCHEMES),
                   "flash_attn_fwd": 0})
    bare = lines[None]["corrupted_bits"]
    if bare <= 0:
        raise AssertionError("the bare run at the Table-3 corner corrupted "
                             "nothing")
    if lines["ecc"]["ecc_mismatch_bits"] <= 0:
        raise AssertionError("ECC flagged no mismatch at the corner")
    if lines["tmr"]["corrupted_bits"] >= bare:
        raise AssertionError(f"TMR left {lines['tmr']['corrupted_bits']} "
                             f"bits wrong, bare {bare}")
    for scheme, want in payload.EXPECTED.items():
        got = (lines[scheme]["corrupted_bits"],
               lines[scheme]["ecc_mismatch_bits"])
        if got != want:
            raise AssertionError(f"faults {scheme}: (corrupted, ECC "
                                 f"mismatch) bits {got}, expected {want} "
                                 "(launch.faults.EXPECTED)")
    return counts


def check_prefill_reference():
    """The float32 smoke config's prefill logits on the card (flash
    attention at S=128) against the same prefill on the CPU (dense
    scores), same seeded weights and tokens, within 1e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, prefill
    cfg = get_smoke_config("drim-bnn").replace(dtype="float32",
                                                param_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng([SEED, 3]).integers(
        0, cfg.vocab_size, (2, 128)))
    before = flash_attention.flash_fwd.launches
    logits = {}
    for dev in ("cuda", "cpu"):
        params = init_params(SEED, cfg, device=dev)
        lg, _ = prefill(params, cfg, {"tokens": toks.to(dev)})
        logits[dev] = lg.cpu()
    if flash_attention.flash_fwd.launches != before + cfg.n_layers:
        raise AssertionError("the card's prefill did not run the flash "
                             "kernel in every layer")
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    if not (torch.isfinite(logits["cuda"]).all() and err <= 1e-3):
        raise AssertionError(f"card prefill differs from the CPU's by {err}")
    print("serve " + json.dumps({"prefill_vs_cpu_max_abs_err": err}))


def flat_leaves(tree):
    """(path, leaf) of a nested-dict tree, in sorted key order."""
    if not isinstance(tree, dict):
        return [("", tree)]
    return [(f"{k}/{p}".rstrip("/"), leaf) for k in sorted(tree)
            for p, leaf in flat_leaves(tree[k])]


def phase_train(wrappers):
    """The drim-bnn LM trained at full width and depth through the
    trainer's CLI entry point (`launch.train.main`): batch 8, seq 256,
    AdamW at 3e-4, TRAIN_STEPS steps with checkpoints every RESTART_AT,
    under deterministic algorithms.  Then the restart check: the step-
    RESTART_AT checkpoint restored into a fresh state and trained to the
    end must give the very parameters and optimizer state the straight
    run saved.  Returns the launch counts of both legs."""
    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    dev = torch.device("cuda")
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    torch.use_deterministic_algorithms(True)
    # Deterministic mode also fills every new tensor with NaN, a check for
    # reads of uninitialized memory that costs a kernel per allocation and
    # does not change which results repeat: off, so s/step is the step's.
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        with tempfile.TemporaryDirectory(prefix="drim_train_") as ckpt_dir:
            argv = TRAIN + ["--ckpt-dir", ckpt_dir]
            args = train.parse_args(argv)
            cfg, step_fn, init_state = train.build(args)
            per_step = {"flash_attn_fwd": (2 if cfg.remat else 1)
                        * cfg.n_layers, "flash_bwd_dkv": cfg.n_layers,
                        "flash_bwd_dq": cfg.n_layers}

            def run():
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    final = train.main(argv)
                return final, [json.loads(line) for line in
                               text.getvalue().splitlines()]
            (final, lines), counts["train"] = counted(
                wrappers, "train", run,
                lambda _: {k: n * TRAIN_STEPS for k, n in per_step.items()})
            steps = [line for line in lines if "step" in line]
            losses = [line["loss"] for line in steps]
            if len(steps) != TRAIN_STEPS or not np.all(np.isfinite(losses)) \
                    or not np.isfinite(final):
                raise AssertionError(f"train: bad losses {losses} {final}")
            if not final < losses[0]:
                raise AssertionError(f"train: the loss did not fall "
                                     f"({losses[0]} -> {final})")
            # s/step after the first (warm-up) step; each logged step
            # ends with its metrics on the host
            s_step = (steps[-1]["wall_s"] - steps[0]["wall_s"]) \
                / (TRAIN_STEPS - 1)
            tokens = args.batch * args.seq
            print("train " + json.dumps({
                "arch": args.arch, "layers": cfg.n_layers,
                "d_model": cfg.d_model, "bitlinear": cfg.bitlinear,
                "remat": cfg.remat, "batch": args.batch, "seq": args.seq,
                "steps": TRAIN_STEPS, "first_step_s": steps[0]["wall_s"],
                "s_per_step": s_step, "tokens_per_s": tokens / s_step,
                "first_loss": losses[0], "last_loss": final,
                "losses": losses,
                "grad_norm": [line["grad_norm"] for line in steps],
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))

            def restart():
                ck = Checkpointer(ckpt_dir)
                fresh = init_state(SEED + 1, device=dev)
                state = ck.restore(RESTART_AT, fresh, device=dev)
                data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                                   seed=args.seed)
                for step in range(RESTART_AT, TRAIN_STEPS):
                    state, _ = step_fn(state, train.batch_at(
                        data, cfg, step, args.seed, dev))
                torch.cuda.synchronize()
                return state, ck.restore(TRAIN_STEPS, fresh, device=dev)
            (resumed, straight), counts["train restart"] = counted(
                wrappers, "train restart", restart,
                lambda _: {k: n * (TRAIN_STEPS - RESTART_AT)
                           for k, n in per_step.items()})
            differ = [p for (p, a), (_, b) in zip(flat_leaves(resumed),
                                                  flat_leaves(straight))
                      if not torch.equal(a, b)]
            if differ:
                raise AssertionError(f"restart: {len(differ)} leaves differ "
                                     f"from the straight run, e.g. "
                                     f"{differ[:3]}")
            print("train " + json.dumps({
                "restart": f"{RESTART_AT} + checkpoint + "
                           f"{TRAIN_STEPS - RESTART_AT} steps",
                "leaves": len(flat_leaves(straight)),
                "bit_identical_to_straight_run": True,
                "deterministic_algorithms": True}))
            data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                               seed=args.seed)
            profile_train_steps(step_fn, resumed, [
                train.batch_at(data, cfg, TRAIN_STEPS + i, args.seed, dev)
                for i in range(PROFILE_STEPS)])
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    return counts


def profile_train_steps(step_fn, state, batches) -> None:
    """Where a training step's time goes: PROFILE_STEPS steps under
    `torch.profiler`, the device time of each kernel summed by kind (the
    flash kernels, GEMMs, the rest), the kernel launches per step, and the
    device's idle share of the host-clock wall time ("train" line)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = len(batches)
    kernels = [(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
               for e in prof.key_averages()
               if e.self_device_time_total > 0 and e.device_type.name ==
               "CUDA"]
    busy = sum(ms for _, ms, _ in kernels)

    def kind(name: str) -> str:
        low = name.lower()
        if "flash" in low and ("bwd" in low or "fwd" in low):
            return "flash kernels (port)"
        if "gemm" in low or "xmma" in low or "cutlass" in low:
            return "gemm (cuBLAS)"
        return "other"
    by_kind = {}
    for name, ms, _ in kernels:
        by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    print("train " + json.dumps({
        "profile_steps": n, "wall_ms_per_step": wall * 1e3 / n,
        "device_busy_ms_per_step": busy,
        "device_idle_share": (1 - busy / (wall * 1e3 / n)) if busy else None,
        "device_launches_per_step": sum(c for _, _, c in kernels),
        "device_ms_per_step_by_kind": by_kind,
        "top_kernels_ms_per_step": [[name[:80], ms, cnt]
                                    for name, ms, cnt in top]}))


def check_train_reference():
    """The float32 smoke config's first-step loss and gradients on the
    card (flash forward and backward kernels at S=128) against the same
    step on the CPU (dense scores), same seeded weights and batch: the
    loss within TRAIN_LOSS_RTOL, the whole gradient within
    TRAIN_GRAD_RTOL in relative L2."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import init_params, train_loss
    from repro_torch.tree import tree_map
    cfg = get_smoke_config("drim-bnn").replace(dtype="float32",
                                                param_dtype="float32")
    toks = torch.from_numpy(np.random.default_rng([SEED, 4]).integers(
        0, cfg.vocab_size, (2, 129)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = flash_attention.flash_bwd_dq.launches
    got = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.requires_grad_(True),
                          init_params(SEED, cfg, device=dev))
        loss, _ = train_loss(params, cfg, {k: v.to(dev)
                                           for k, v in batch.items()})
        grads = torch.autograd.grad(loss, [t for _, t in
                                           flat_leaves(params)])
        got[dev] = (float(loss.detach()), [g.cpu() for g in grads])
    if flash_attention.flash_bwd_dq.launches != before + cfg.n_layers:
        raise AssertionError("the card's step did not run the flash "
                             "backward in every layer")
    (l_card, g_card), (l_cpu, g_cpu) = got["cuda"], got["cpu"]
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(g_card, g_cpu))
    den = sum(float((b ** 2).sum()) for b in g_cpu)
    rel = (num / den) ** 0.5
    worst = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(g_card, g_cpu))
    line = {"loss_card": l_card, "loss_cpu": l_cpu,
            "grad_rel_l2": rel, "worst_leaf_rel_l2": worst}
    print("train " + json.dumps(line))
    if not (np.isfinite(l_card) and abs(l_card - l_cpu)
            <= TRAIN_LOSS_RTOL * abs(l_cpu) and rel <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"card train step differs from the CPU's: "
                             f"{line}")


def read_counts(wrappers, names, phase: str):
    launches = {name: fn.launches for name, fn in wrappers.items()}
    idle = [n for n in names if launches[n] <= 0]
    if idle:
        raise AssertionError(f"{phase} never launched {idle}")
    print("counts " + json.dumps({"phase": phase, **launches}))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import (aap_interpreter, bitserial_add,
                                     flash_attention, packbits, xnor_popcount)
    from repro_torch.kernels.bitwise import (binary_kernel, not_kernel,
                                             ternary_kernel)

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    phase_build()
    records = phase_kernels(rng)
    check_ste_product(rng)

    wrappers = {"pack_signs": packbits.pack_signs,
                "xnor_gemm": xnor_popcount.xnor_gemm_packed,
                "aap_interp": aap_interpreter.aap_interp,
                "aap_interp_faulted": aap_interpreter.aap_interp_faulted,
                "flash_attn_fwd": flash_attention.flash_fwd,
                "flash_bwd_dkv": flash_attention.flash_bwd_dkv,
                "flash_bwd_dq": flash_attention.flash_bwd_dq,
                "bitwise_not": not_kernel, "bitwise_binary": binary_kernel,
                "bitwise_ternary": ternary_kernel,
                "bitplane_add": bitserial_add.bitplane_add,
                "unpack_signs": packbits.unpack_signs}
    for fn in wrappers.values():
        fn.launches = 0
    phase_path(rng)
    path_launches = read_counts(wrappers, ("pack_signs", "xnor_gemm",
                                           "aap_interp"), "path")
    by_leg = phase_serve(wrappers)
    by_leg["faults"] = phase_faults(wrappers)
    by_leg["bulk"] = phase_bulk(wrappers)
    by_leg["analog"] = phase_analog(wrappers)
    by_leg.update(phase_train(wrappers))
    launches = {name: sum(c[name] for c in by_leg.values())
                for name in wrappers}
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"the main paths never launched {idle}")
    check_prefill_reference()
    check_train_reference()

    meta = {
        "pack_signs": ("src/repro_torch/csrc/pack_signs.cu",
                       "src/repro/kernels/packbits.py:26 _pack_kernel"),
        "xnor_gemm": ("src/repro_torch/csrc/xnor_gemm.cu",
                      "src/repro/kernels/xnor_popcount.py:40 "
                      "_xnor_gemm_kernel"),
        "aap_interp": ("src/repro_torch/csrc/aap_interp.cu",
                       "src/repro/kernels/aap_interpreter.py:64 "
                       "_interp_kernel"),
        "aap_interp_faulted": ("src/repro_torch/csrc/aap_interp.cu",
                               "src/repro/kernels/aap_interpreter.py:106 "
                               "_interp_kernel_faulted"),
        "flash_attn_fwd": ("src/repro_torch/csrc/flash_attn_fwd.cu",
                           "src/repro/kernels/flash_attention.py:48 "
                           "_fwd_kernel"),
        "flash_bwd_dkv": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                          "src/repro/kernels/flash_attention.py:127 "
                          "_bwd_dkv_kernel"),
        "flash_bwd_dq": ("src/repro_torch/csrc/flash_attn_bwd.cu",
                         "src/repro/kernels/flash_attention.py:169 "
                         "_bwd_dq_kernel"),
        "bitwise_not": ("src/repro_torch/csrc/bitwise.cu",
                        "src/repro/kernels/bitwise.py:64 _not_kernel"),
        "bitwise_binary": ("src/repro_torch/csrc/bitwise.cu",
                           "src/repro/kernels/bitwise.py:32 _binary_kernel"),
        "bitwise_ternary": ("src/repro_torch/csrc/bitwise.cu",
                            "src/repro/kernels/bitwise.py:50 "
                            "_ternary_kernel"),
        "bitplane_add": ("src/repro_torch/csrc/bitplane_add.cu",
                         "src/repro/kernels/bitserial_add.py:24 _add_kernel"),
        "unpack_signs": ("src/repro_torch/csrc/unpack_signs.cu",
                         "src/repro/kernels/packbits.py:34 _unpack_kernel"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_leg": {leg: c[name] for leg, c in by_leg.items()},
            "path_launches": path_launches[name],
            "max_abs_err": r["max_abs_err"], "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "library_device_ms": r.get("library_device_ms"),
            "library_fp32_ms": r.get("library_fp32_ms"),
            "launch_floor_ms": r.get("launch_floor_ms"),
            "served": r.get("served"), "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
