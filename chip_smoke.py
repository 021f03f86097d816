#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   -- compile the three CUDA kernels from `src/repro_torch/csrc/`
                (one nvcc per source, all started together);
  2. kernels -- hold each kernel against its plain torch version on the
                card at the main path's shapes plus a ragged shape, with
                exact equality, and time kernel, plain version and (for
                the GEMM) one PyTorch call computing the same function;
  3. path    -- one drim-bnn FFN BitLinear pair at full width (768 -> 3072
                -> 768) on M = 512 activation rows, weights from a seeded
                numpy generator, each projection served by the native
                packed route (pack + XNOR-GEMM kernels) and by the DRIM
                route (AAP interpreter kernel on the DRIM-R fleet); the
                int32 dots of both routes must equal the plain reference
                computed on the CPU, and the float outputs must agree;
  4. counts  -- every kernel's launch counter, zeroed just before phase 3,
                must be above 0 after it.

Prints the kernels' JSON line, the card's name and power limit, and last
`{"ok": true, "device": {...}}`.  Exits nonzero without a CUDA card.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

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


def max_abs_err(got, want) -> int:
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def check_equal(what: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs diff {err})")
    return err


def bound(bytes_moved: float, ops: float):
    by_bytes = bytes_moved / HBM_BYTES_S * 1e3
    by_ops = ops / INT32_OPS_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.time()
    reports = _build.build(["pack_signs", "xnor_gemm", "aap_interp"])
    secs = time.time() - t0
    for name, text in sorted(reports.items()):
        for line in text.splitlines():
            if "Used" in line:
                print(f"ptxas {name}: {line.split('info    :')[-1].strip()}")
    print(f"build: {secs:.2f} s")


def phase_kernels(rng):
    """Each kernel against its plain version; returns the per-kernel
    records measured at the up-projection's shapes."""
    from repro_torch.core import (AAP, DRIM_R, dcc_state_rows,
                                  encode_kernel_stream, kstream_slot)
    from repro_torch.kernels import aap_interpreter, packbits, xnor_popcount
    from repro_torch.kernels.ref import unpack_signs_ref
    from repro_torch.pim.bnn import serving_lowering
    dev = torch.device("cuda")
    d_model, d_ff = 768, 3072
    records = {}

    # -- sign packer ------------------------------------------------------
    pack_shapes = [(M_ROWS, d_model, torch.float32),   # up activations
                   (d_ff, d_model, torch.float32),     # up weights (d_out, d_in)
                   (M_ROWS, d_ff, torch.float32),      # down activations
                   (d_model, d_ff, torch.float32),     # down weights
                   (300, 700, torch.bfloat16)]         # ragged R and K
    for rows, k, dt in pack_shapes:
        x = torch.from_numpy(rng.standard_normal((rows, k), dtype=np.float32))
        x = x.to(dev, dt)
        x[0, :4] = torch.tensor([-0.0, float("nan"), 0.0, -1e-30])
        got = packbits.pack_signs(x)
        err = check_equal(f"pack_signs {rows}x{k}", got,
                          packbits.pack_signs_plain(x))
        ms = graph_ms(lambda: packbits.pack_signs(x), 50)
        call_ms = cuda_ms(lambda: packbits.pack_signs(x), 200)
        plain_ms = graph_ms(lambda: packbits.pack_signs_plain(x), 20)
        nbytes = x.numel() * x.element_size() + got.numel() * 4
        b_ms, b_by = bound(nbytes, x.numel())
        print("detail " + json.dumps({
            "kernel": "pack_signs", "shape": [rows, k], "dtype": str(dt),
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms}))
        if (rows, k) == (M_ROWS, d_model):
            records["pack_signs"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"[{rows},{k}] float32 -> [{rows},{-(-k // 32)}] int32")

    # -- XNOR-popcount GEMM -------------------------------------------------
    gemm_shapes = [(M_ROWS, d_ff, d_model), (M_ROWS, d_model, d_ff),
                   (100, 77, 700)]                      # ragged M, N, K
    for m, n, k in gemm_shapes:
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
        # The same function as one PyTorch call: the ±1 operands through
        # a float32 torch.matmul, TF32 off (exact: every partial sum is an
        # integer below 2**24; a bf16 product would round its bf16 output
        # above 256).  A yardstick only; the port never calls it.
        pa = unpack_signs_ref(a, torch.float32)[:, :k].contiguous()
        pb = unpack_signs_ref(b, torch.float32)[:, :k].T.contiguous()
        lib_out = torch.matmul(pa, pb)
        if not torch.equal(lib_out.to(torch.int32), got):
            raise AssertionError("float32 torch.matmul yardstick disagrees")
        library_ms = graph_ms(lambda: torch.matmul(pa, pb), 50)
        nbytes = (m + n) * w * 4 + m * n * 4
        b_ms, b_by = bound(nbytes, 3 * m * n * w)
        print("detail " + json.dumps({
            "kernel": "xnor_gemm", "shape": [m, n, k], "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms}))
        if (m, n, k) == (M_ROWS, d_ff, d_model):
            records["xnor_gemm"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                shape=f"[{m},{w}] x [{n},{w}] int32, K={k} -> [{m},{n}] int32")

    # -- AAP interpreter ------------------------------------------------------
    low = serving_lowering(128, engine="cuda", geom=DRIM_R)
    fp = low.fp
    cols = DRIM_R.n_subarrays * DRIM_R.row_bits // 32
    cases = [("serving K=128", fp.program, fp.readback_rows,
              fp.template_rows, 1, len(fp.loaded_inputs), cols)]
    # ragged: a random soup over every word-line, DCC aliases included,
    # 3 waves of a column count that no block width divides
    n_rows = 20
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    soup = tuple(AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                               for _ in range(arity[op])))
                 for op in (int(rng.integers(0, 4)) for _ in range(300)))
    cases.append(("ragged soup", soup, tuple(range(n_rows + 4)), n_rows, 3,
                  6, 1000))
    for label, prog, readback, n_rows_t, waves, n_in, ncols in cases:
        stream = torch.from_numpy(
            encode_kernel_stream(prog, n_rows=n_rows_t)).to(dev)
        slots = torch.tensor([kstream_slot(r, n_rows_t) for r in readback],
                             dtype=torch.int32, device=dev)
        n_state = dcc_state_rows(n_rows_t)
        tiles = torch.from_numpy(rng.integers(
            -2**31, 2**31, (waves, n_in, ncols), dtype=np.int32)).to(dev)
        got = aap_interpreter.aap_interp(stream, tiles, slots, n_state)
        err = check_equal(f"aap_interp {label}", got,
                          aap_interpreter.aap_interp_plain(
                              stream, tiles, slots, n_state))
        ms = graph_ms(lambda: aap_interpreter.aap_interp(
            stream, tiles, slots, n_state), 10)
        call_ms = cuda_ms(lambda: aap_interpreter.aap_interp(
            stream, tiles, slots, n_state), 50)
        # The plain replay reads the stream to the host (`tolist`), which
        # a CUDA graph cannot capture: timed eagerly.
        plain_ms = cuda_ms(lambda: aap_interpreter.aap_interp_plain(
            stream, tiles, slots, n_state), 2)
        nbytes = tiles.numel() * 4 + got.numel() * 4 + stream.numel() * 4
        b_ms, b_by = bound(nbytes, len(prog) * waves * ncols)
        print("detail " + json.dumps({
            "kernel": "aap_interp", "case": label, "n_ins": len(prog),
            "n_in": n_in, "n_state": n_state, "waves": waves,
            "cols": ncols, "block_cols": aap_interpreter.block_cols(n_state),
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms}))
        if label.startswith("serving"):
            records["aap_interp"] = dict(
                max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"{len(prog)} AAPs over [{waves},{n_in},{ncols}] "
                      f"int32, {n_state} state rows")
    return records


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import aap_interpreter, packbits, xnor_popcount

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    phase_build()
    records = phase_kernels(rng)

    wrappers = {"pack_signs": packbits.pack_signs,
                "xnor_gemm": xnor_popcount.xnor_gemm_packed,
                "aap_interp": aap_interpreter.aap_interp}
    for fn in wrappers.values():
        fn.launches = 0
    phase_path(rng)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    idle = [name for name, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")

    meta = {
        "pack_signs": ("src/repro_torch/csrc/pack_signs.cu",
                       "src/repro/kernels/packbits.py:26 _pack_kernel"),
        "xnor_gemm": ("src/repro_torch/csrc/xnor_gemm.cu",
                      "src/repro/kernels/xnor_popcount.py:40 "
                      "_xnor_gemm_kernel"),
        "aap_interp": ("src/repro_torch/csrc/aap_interp.cu",
                       "src/repro/kernels/aap_interpreter.py:64 "
                       "_interp_kernel"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "max_abs_diff": r["max_abs_err"],
            "ms": r["ms"], "kernel_ms": r["ms"], "call_ms": r["call_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
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
