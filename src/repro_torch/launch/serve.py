"""Batched serving driver: prefill once, decode N tokens, report tok/s
(port of `repro.launch.serve`).

  * static-shape KV caches sized to --ctx;
  * greedy or temperature sampling;
  * --engine {resident,baseline,cuda,gpu}: how BitLinear decode matmuls
    execute.  "gpu", the registry's comparator (the reference's "tpu"), is
    the native route on the card (the packed XNOR-popcount kernel under
    --packed, else the dense STE product); a DRIM engine routes every
    decode GEMM through the drim.jit carry-save pipeline on the simulated
    fleet ("cuda": the AAP interpreter kernel; "baseline": the slow
    full-state interpreter).  Prefill always runs the native
    route, and its attention runs the flash kernel where it applies;
  * --packed: BitLinear weights bit-packed (32x smaller weight reads),
    with a bit-exactness check against the dense STE path at temperature
    0;
  * --microbench: the prefill / insert / generate split (the maxtext
    experimental_decode_microbenchmark pattern), each stage's first call
    reported apart as its `compile_s`;
  * --continuous N: N staggered requests through the continuous-batching
    wave scheduler (`launch.batching.WaveBatcher`);
  * --resilient: the decode fn wrapped in retry-with-backoff and a
    fallback to the "gpu" engine; incidents land in the stats record and
    on the telemetry registry instead of killing the server;
  * --telemetry / --trace-out PATH: arm `runtime.telemetry` (spans
    through lowering and decode, the registry snapshot folded into the
    stats under "telemetry"); --trace-out also writes the Chrome-trace /
    Perfetto JSON.  Spans read the host's clock: on the card a span
    around queued launches closes before they finish (a "decode:token"
    span ends with the step's device sync);
  * --device: where to serve (default: the card; "cpu" runs the plain
    torch versions of the kernels);
  * --arch: every arch (`configs.ARCHS`: drim-bnn, the dense
    qwen3-14b, qwen3-32b, qwen2-72b and minitron-4b, the vlm
    llava-next-34b, whose batch carries zero patch embeddings for the
    stub vision frontend, the MoE deepseek-v3-671b (MLA) and
    kimi-k2-1t-a32b (GQA), the SSM mamba2-130m, the hybrid zamba2-1.2b
    and the encoder-decoder whisper-medium, whose batch carries zero
    frame embeddings for the stub audio frontend, as in the
    reference).  Only drim-bnn has
    BitLinear layers (`bitlinear="ffn"`), so on the others every engine
    serves the native route, as in the reference.

Timing: the first decode step runs UNTIMED as warm-up and is reported as
`compile_s` (first launches: kernel builds, DRIM lowerings), so
`decode_tok_per_s` and the p50/p99 step latencies are steady-state.

  * --n-queues: the queue count of --engine queued;
  * --mesh {host,single,multi}: the reference's.  "host" (the default)
    is the host mesh over --device's devices (data x model n x 1; on one
    card or the CPU, 1 x 1), entered around setup, prefill and decode:
    under it every MoE prefill takes the expert-parallel dispatch, as the
    reference's default does.  "single" and "multi" are the production
    meshes, which raise ValueError below 256 and 512 devices;
  * --model-axis K: under torchrun, W ranks serve every family over the
    (W / K, K) host mesh (`launch.mesh.make_host_mesh(model_axis=K)`):
    each rank draws and holds only its blocks of the params (packed ones
    included; the MoE's experts, E / K a rank; the ssm family's whole)
    and of the sequence-cut KV or MLA latent caches by the reference's
    specs (the SSM states cut over heads, the conv windows whole, the
    audio family's cross cache over heads), runs its rows of the batch,
    its heads and its experts (`models`; the ssm family its block of the
    prompt's sequence), and gets the whole logits, so every rank samples
    the same tokens; rank 0 alone prints the stats line, after every
    rank's first line (`launch.mesh.init_ranks`).  --continuous,
    --microbench and --resilient run over the ranks too (every rank the
    same waves; each stage's time per rank and their maximum; one
    failure flag a decode attempt gathered over the mesh, so every rank
    takes the same retry, fallback or abort).  A model axis that does not
    divide the ranks, or K > 1 in one process, raises ValueError.  On the
    CPU:

      python -m torch.distributed.run --nproc-per-node 2 \\
          -m repro_torch.launch.serve --arch drim-bnn --smoke-config \\
          --device cpu --prompt-len 128 --gen 4 --model-axis 2

CPU-scale examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch drim-bnn \\
      --smoke-config --device cpu --engine resident --prompt-len 128 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --smoke-config --device cpu --prompt-len 64 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --smoke-config --device cpu --prompt-len 128 \\
      --gen 4
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.batching import (NATIVE_ENGINE, WaveBatcher, fold_in,
                                         make_decode_fn, sequence_block)
from repro_torch.core.mesh import (ambient_ranks, local_block,
                                   mesh_all_gather, model_ranks)
from repro_torch.launch.mesh import cli_mesh, init_ranks
from repro_torch.models import decode_step, empty_caches, init_params, prefill
from repro_torch.models.layers import pack_bitlinear, pack_bitlinear_rows
from repro_torch.runtime import telemetry
from repro_torch.runtime.sharding import (_path_str, is_cross_cache,
                                         param_pspecs)
from repro_torch.tree import tree_map_with_path

# config-geometry override flags -> ModelConfig fields (0 = keep)
_CFG_OVERRIDES = (("layers", "n_layers"), ("d_model", "d_model"),
                  ("d_ff", "d_ff"), ("heads", "n_heads"),
                  ("kv_heads", "n_kv_heads"), ("d_head", "d_head"),
                  ("vocab", "vocab_size"))


def parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.pim.compiler import engines
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="drim-bnn")
    ap.add_argument("--smoke-config", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--ctx", type=int, default=0,
                    help="cache length (default prompt+gen)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the mesh's model axis (under torchrun)")
    ap.add_argument("--engine", default=NATIVE_ENGINE, choices=engines(),
                    help="BitLinear decode matmul backend: 'gpu' (the "
                    "registry's comparator) = the native route; the DRIM "
                    "engines route decode GEMMs through the drim.jit "
                    "compile->lower->run pipeline")
    ap.add_argument("--n-queues", type=int, default=None,
                    help="queue count for --engine queued")
    ap.add_argument("--packed", action="store_true",
                    help="serve from bit-packed BitLinear weights")
    ap.add_argument("--microbench", action="store_true",
                    help="prefill/insert/generate microbenchmark split")
    ap.add_argument("--continuous", type=int, default=0, metavar="N",
                    help="run N requests through the continuous-batching "
                    "wave scheduler instead of one static batch")
    ap.add_argument("--arrive-every", type=int, default=1,
                    help="waves between request arrivals in --continuous "
                    "mode (0 = all arrive at wave 0)")
    ap.add_argument("--resilient", action="store_true",
                    help="wrap the decode fn in retry-with-backoff and a "
                    "fallback to the 'gpu' engine; incidents land in the "
                    "stats record instead of killing the server")
    ap.add_argument("--telemetry", action="store_true",
                    help="arm the observability layer: span tracing "
                    "through lowering/decode, registry snapshot folded "
                    "into the stats record under 'telemetry'")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Chrome-trace/Perfetto JSON here after "
                    "the run (implies --telemetry)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    for flag, _field in _CFG_OVERRIDES:
        ap.add_argument(f"--{flag.replace('_', '-')}", type=int,
                        default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def build_cfg(args):
    cfg = (get_smoke_config(args.arch) if args.smoke_config
           else get_config(args.arch))
    over = {field: getattr(args, flag) for flag, field in _CFG_OVERRIDES
            if getattr(args, flag)}
    if over:
        cfg = cfg.replace(**over)
    return cfg.replace(param_dtype="bfloat16")


def splice_caches(caches, pre_caches):
    """Right-size prefill caches into the ctx-length decode caches.

    Every leaf must either match exactly or fit inside the decode cache at
    the same rank; anything else raises, naming the offending cache path.
    """
    def splice(path, full, pre):
        if full.shape == pre.shape:
            return pre.to(full.dtype)
        if full.dim() == pre.dim() and all(
                p <= f for p, f in zip(pre.shape, full.shape)):
            out = full.clone()
            out[tuple(slice(0, n) for n in pre.shape)] = pre.to(full.dtype)
            return out
        raise ValueError(
            f"cache splice mismatch at {path}: prefill leaf "
            f"{tuple(pre.shape)} cannot splice into decode cache "
            f"{tuple(full.shape)}")

    return tree_map_with_path(splice, caches, pre_caches)


def splice_rank_caches(caches, pre_caches, s_pre: int, s_ctx: int, mesh):
    """`splice_caches` under a model axis over ranks: the [.., B', S, Hkv,
    Dh] keys and values (dense, vlm, GQA moe, the hybrid's shared block,
    the audio family's self cache) and the MLA's [L, B', S, R] latents are
    the rank's sequence blocks (dim 2) of an `s_pre`-long prefill cache
    and an `s_ctx`-long decode cache (each whole where the axis does not
    divide its length), which do not line up; the prefill's are gathered
    over the model group and the rank copies the prompt positions its
    decode block holds (`batching.sequence_block`).  The SSM states (the
    rank's heads), conv windows (whole: the last sequence rank's final
    frames, which prefill hands every rank) and the audio family's cross
    cache (the rank's heads of every frame) have no sequence dim and are
    the decode caches' blocks as they are."""
    def splice(path, full, pre):
        name = _path_str(path)
        if is_cross_cache(name) or name.split("/")[-1] not in (
                "k", "v", "ckv", "k_rope"):
            if full.shape != pre.shape:
                raise ValueError(f"cache splice mismatch at {path}: "
                                 f"{tuple(pre.shape)} is not the block "
                                 f"{tuple(full.shape)}")
            return pre.to(full.dtype)
        own = sequence_block(pre, s_pre, s_ctx, mesh, 2)
        out = full.clone()
        out[:, :, :own.shape[2]] = own.to(full.dtype)
        return out

    return tree_map_with_path(splice, caches, pre_caches)


def place_params(params, mesh, family: str | None = None):
    """This rank's blocks of a whole param tree by the reference's specs
    (`runtime.sharding.param_pspecs` of `family`: the ssm family's are
    replicated); leaves the specs leave whole stay as they are."""
    def one(path, leaf, spec):
        sl = local_block(tuple(leaf.shape), spec, mesh)
        if all(s.stop - s.start == n for s, n in zip(sl, leaf.shape)):
            return leaf
        return leaf[sl].clone()
    return tree_map_with_path(one, params, param_pspecs(params, mesh,
                                                        family))


def pack_model_params(params):
    """The offline --packed conversion: every BitLinear param dict (marker:
    'bkernel') in the tree becomes its bit-packed serving form; works on
    scan-stacked [L, d_in, d_out] leaves.  Under a model axis over ranks
    the tree holds this rank's blocks: a column-parallel layer packs its
    own columns, the row-parallel `down` packs into the packed spec's
    output block (`layers.pack_bitlinear_rows`)."""
    mesh = model_ranks()

    def walk(p, name=""):
        if isinstance(p, dict):
            if "bkernel" in p:
                if mesh is not None and name == "down":
                    return pack_bitlinear_rows(p, mesh)
                return pack_bitlinear(p)
            return {k: walk(v, k) for k, v in p.items()}
        return p
    return walk(params)


def _assert_packed_bit_exact(cfg, dense_params, packed_params, tok, caches,
                             pos, ctx_len: int) -> None:
    """--packed at temperature 0 must reproduce the dense STE path
    bitwise: the packed XNOR-popcount dot and the STE product both give
    the same exact integer, rounded once, so logits -- and served tokens
    -- must match."""
    lg_dense = decode_step(dense_params, cfg, tok, caches, pos, ctx_len)[0]
    lg_packed = decode_step(packed_params, cfg, tok, caches, pos, ctx_len)[0]
    ids_dense = lg_dense[:, -1, :].argmax(-1)
    ids_packed = lg_packed[:, -1, :].argmax(-1)
    if not torch.equal(ids_dense, ids_packed):
        raise RuntimeError(
            "--packed decode diverged from the dense STE path at "
            f"temperature 0: token ids {ids_packed.tolist()} vs "
            f"{ids_dense.tolist()}")
    np.testing.assert_allclose(lg_packed.cpu().numpy(),
                               lg_dense.cpu().numpy(), rtol=1e-5, atol=1e-5,
                               err_msg="--packed logits drifted from the "
                               "dense STE path")


def make_resilient_decode(cfg, ctx_len: int, temperature: float,
                          engine: str, n_queues, *, max_retries: int = 2,
                          backoff_s: float = 0.05,
                          sleep: Callable[[float], None] = time.sleep,
                          make_fn: Callable = make_decode_fn,
                          ) -> Tuple[Callable, Dict[str, Any],
                                     List[Dict[str, Any]]]:
    """Graceful degradation for the serving hot path.

    A decode step that raises (a DRIM engine wedged mid-lowering, a dead
    queue surfacing as a dispatch error) is retried with exponential
    backoff on the SAME engine; once retries exhaust, the server rebuilds
    the decode fn on the "gpu" comparator engine (the reference's "tpu"),
    which gives the DRIM engines' tokens, and keeps serving.

    Every failure appends a structured incident record -- `t_s` (seconds
    since this wrapper was built), `engine`, `attempt`, `retries`
    (retries already burned on the current engine), `error`, `action`,
    `action_kind`, and for fallbacks a `fallback_reason` -- and books it
    on the telemetry registry (``serve.incident:*`` counters, a
    "serve:incident" instant when armed).

    Inside a mesh of ranks every rank must take the same decision, or one
    would sit in a collective while another retries: each attempt ends
    with one all-gather of every rank's failure flag over the whole mesh
    (`state["flag_calls"]`, `state["flag_s"]`: its cost), and a failure on
    any rank makes every rank book the same incident (its `error` the
    rank's own exception, or on a rank that did not fail, which ranks
    did) and retry, fall back or abort together.  The flag is read at the
    step's end, so a rank's failure must surface there too: a rank that
    raises inside a step, between the step's own collectives, leaves the
    other ranks waiting in them.

    Returns (decode_fn, state, incidents); `state["engine"]` tracks the
    engine currently serving.  `make_fn(cfg, ctx_len, temperature, engine,
    n_queues)` builds a decode fn (`make_decode_fn`) and `sleep` waits;
    both are injectable so tests drive the failure path with fakes and no
    wall-clock."""
    mesh = ambient_ranks()
    if mesh is not None and mesh.ranks.size == 1:
        mesh = None
    state: Dict[str, Any] = {
        "engine": engine, "flag_calls": 0, "flag_s": 0.0,
        "fn": make_fn(cfg, ctx_len, temperature, engine, n_queues)}
    incidents: List[Dict[str, Any]] = []
    clock0 = time.perf_counter()

    def book(rec: Dict[str, Any], kind: str) -> None:
        rec["action_kind"] = kind
        incidents.append(rec)
        telemetry.REGISTRY.counters("serve")[f"incident:{kind}"] += 1
        telemetry.event("serve:incident", cat="serve", tid="serve", **rec)

    def failed_ranks(err) -> List[int]:
        """The ranks whose attempt raised (this process alone: [0] or
        [])."""
        if mesh is None:
            return [] if err is None else [0]
        t0 = time.perf_counter()
        flags = mesh_all_gather(
            torch.tensor([0 if err is None else 1], dtype=torch.int32,
                         device=mesh.device), mesh, mesh.axis_names, 0)
        flags = flags.cpu().tolist()
        state["flag_calls"] += 1
        state["flag_s"] += time.perf_counter() - t0
        order = mesh.ranks.reshape(-1).tolist()
        return [r for r, f in zip(order, flags) if f]

    def dec(*args):
        attempt, delay = 0, backoff_s
        while True:
            err, out = None, None
            try:
                out = state["fn"](*args)
            except Exception as e:  # noqa: BLE001 -- any engine failure
                err = e
            failed = failed_ranks(err)
            if not failed:
                return out
            text = (f"{type(err).__name__}: {err}" if err is not None
                    else f"failed on rank(s) {failed}")
            rec = {"t_s": round(time.perf_counter() - clock0, 6),
                   "engine": state["engine"], "attempt": attempt,
                   "retries": attempt, "error": text[:200]}
            if mesh is not None:
                rec["failed_ranks"] = failed
            attempt += 1
            if attempt <= max_retries:
                rec["action"] = f"retry(backoff={delay:g}s)"
                book(rec, "retry")
                sleep(delay)
                delay *= 2
            elif state["engine"] != NATIVE_ENGINE:
                rec["action"] = f"fallback:{NATIVE_ENGINE}"
                rec["fallback_reason"] = (
                    f"retries exhausted on engine "
                    f"{state['engine']!r} ({max_retries} retries)")
                book(rec, "fallback")
                state["engine"] = NATIVE_ENGINE
                state["fn"] = make_fn(cfg, ctx_len, temperature,
                                      NATIVE_ENGINE, n_queues)
                attempt, delay = 0, backoff_s
            else:
                rec["action"] = "abort"
                book(rec, "abort")
                if err is not None:
                    raise err
                raise RuntimeError(f"decode aborted: {text}")

    return dec, state, incidents


def _percentiles_ms(step_times: List[float]) -> Tuple[float, float]:
    if not step_times:
        return 0.0, 0.0
    arr = np.asarray(step_times) * 1e3
    return float(np.percentile(arr, 50)), float(np.percentile(arr, 99))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prompts(args, cfg, n: int) -> np.ndarray:
    """Seeded prompt tokens [n, prompt_len], a stream apart from the
    weights'."""
    return np.random.default_rng([args.seed, 1]).integers(
        0, cfg.vocab_size, (n, args.prompt_len))


def model_batch(cfg, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The prefill batch: the tokens, and zero stub-frontend outputs in
    bfloat16, as the reference serves them: the vlm family's patch
    embeddings [B, n_patches, d_model], the audio family's frame
    embeddings [B, n_frames, d_model]."""
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros(
            tokens.shape[0], cfg.n_patches, cfg.d_model,
            dtype=torch.bfloat16, device=tokens.device)
    if cfg.family == "audio":
        batch["frames"] = torch.zeros(tokens.shape[0], cfg.n_frames,
                                      cfg.d_model, dtype=torch.bfloat16,
                                      device=tokens.device)
    return batch


def _setup(args, cfg, dev, params=None, tokens=None) -> Dict[str, Any]:
    """Params + prompt batch + prefill + spliced ctx caches.  Under a model
    axis over ranks every rank draws only its blocks of the params
    (`models.init_params` inside the mesh) or keeps its blocks of the
    whole params it is given, then packs them."""
    ctx_len = args.ctx or (args.prompt_len + args.gen)
    mesh = model_ranks()
    if params is None:
        params = init_params(args.seed, cfg, device=dev)
    elif mesh is not None:
        params = place_params(params, mesh, cfg.family)
    if tokens is None:
        tokens = _prompts(args, cfg, args.batch)
    tokens = torch.as_tensor(np.array(tokens), device=dev).long()
    dense_params = params
    if args.packed:
        params = pack_model_params(params)

    t0 = time.perf_counter()
    logits, pre_caches = prefill(params, cfg, model_batch(cfg, tokens))
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    empty = empty_caches(cfg, tokens.shape[0], ctx_len, device=dev)
    caches = (splice_caches(empty, pre_caches) if mesh is None else
              splice_rank_caches(empty, pre_caches, tokens.shape[1],
                                 ctx_len, mesh))
    return dict(ctx_len=ctx_len, params=params, dense_params=dense_params,
                logits=logits, caches=caches, prefill_s=t_prefill)


def serve_mesh(args, dev):
    """The CLI's `--mesh` and `--model-axis` on `dev` (`cli_mesh`: a model
    axis that does not divide the ranks, or K > 1 in one process, raises
    ValueError)."""
    return cli_mesh(args.mesh, dev, model_axis=args.model_axis)


def run_serve(args, *, params=None, tokens=None,
              make_fn: Callable = make_decode_fn,
              sleep: Callable[[float], None] = time.sleep,
              ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """The static-batch serving loop; returns (generated ids [B, gen],
    stats dict).  `params` (the port's tree) and `tokens`
    ([B, prompt_len]) replace the seeded weights and prompts; `make_fn`
    (`make_decode_fn`'s signature) builds the decode fn and, with
    --resilient, `make_resilient_decode` wraps it and backs off with
    `sleep`."""
    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    with serve_mesh(args, dev) as mesh:
        if mesh.ranks is not None:
            dev = mesh.device
        return _serve(args, cfg, dev, params, tokens, make_fn, sleep)


def _serve(args, cfg, dev, params, tokens, make_fn, sleep):
    st = _setup(args, cfg, dev, params, tokens)
    params, caches = st["params"], st["caches"]
    batch, prompt_len = st["logits"].shape[0], args.prompt_len
    if args.resilient:
        dec, eng_state, incidents = make_resilient_decode(
            cfg, st["ctx_len"], args.temperature, args.engine,
            args.n_queues, make_fn=make_fn, sleep=sleep)
    else:
        dec = make_fn(cfg, st["ctx_len"], args.temperature, args.engine,
                      args.n_queues)
        eng_state = {"engine": args.engine, "flag_calls": 0}
        incidents = []

    tok = st["logits"][:, -1, :].argmax(-1)[:, None]
    pos0 = torch.full((batch,), prompt_len, dtype=torch.long, device=dev)

    if args.packed and args.temperature == 0:
        _assert_packed_bit_exact(cfg, st["dense_params"], params, tok,
                                 caches, pos0, st["ctx_len"])

    # Untimed warm-up on the first step's exact shapes: first launches
    # (kernel builds, DRIM kernel traces and lowerings) land here.
    t0 = time.perf_counter()
    dec(params, tok, caches, pos0, fold_in(args.seed, 100))
    _sync(dev)
    compile_s = time.perf_counter() - t0

    out = [tok.cpu().numpy()]
    step_times: List[float] = []
    for i in range(args.gen - 1):
        pos = torch.full((batch,), prompt_len + i, dtype=torch.long,
                         device=dev)
        t1 = time.perf_counter()
        with telemetry.span("decode:token", cat="serve", tid="serve",
                            token=i, engine=eng_state["engine"],
                            batch=batch):
            tok, caches = dec(params, tok, caches, pos,
                              fold_in(args.seed, 100 + i))
            _sync(dev)
        step_times.append(time.perf_counter() - t1)
        out.append(tok.cpu().numpy())

    gen = np.concatenate(out, 1)
    p50, p99 = _percentiles_ms(step_times)
    stats = {
        "arch": cfg.arch, "engine": eng_state["engine"], "device": str(dev),
        "packed": bool(args.packed), "batch": batch, "gen": args.gen,
        "prefill_s": st["prefill_s"], "compile_s": compile_s,
        "decode_tok_per_s": batch * (args.gen - 1)
        / max(sum(step_times), 1e-9),
        "decode_p50_ms": p50, "decode_p99_ms": p99,
        "sample_ids": gen[0, :8].tolist(),
    }
    if args.resilient:
        stats["requested_engine"] = args.engine
        stats["incidents"] = incidents
        if eng_state["flag_calls"]:
            stats["failure_flag"] = {
                "calls": eng_state["flag_calls"], "s": eng_state["flag_s"],
                "s_per_call": eng_state["flag_s"] / eng_state["flag_calls"]}
    if telemetry.enabled():
        stats["telemetry"] = telemetry.snapshot()
    return gen, stats


def run_microbench(args) -> Tuple[None, Dict[str, Any]]:
    """The maxtext-style decode microbenchmark split: prefill / insert /
    generate timed separately.  Nothing is compiled ahead here, so each
    stage's `compile_s` is its first call's time (kernel builds, DRIM
    lowerings), reported apart from the steady state of the next calls,
    as `run_serve` treats its warm-up step.  Over ranks each rank draws
    its blocks of the params, the insert is `splice_rank_caches`, and each
    stage's figures are this rank's, with every rank's beside them
    (`per_rank`, in rank order) and their maximum (`max`)."""
    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    with serve_mesh(args, dev) as mesh:
        if mesh.ranks is not None:
            dev = mesh.device
        return _microbench(args, cfg, dev)


def _microbench(args, cfg, dev) -> Tuple[None, Dict[str, Any]]:
    iters = 3
    ctx_len = args.ctx or (args.prompt_len + args.gen)
    params = init_params(args.seed, cfg, device=dev)
    if args.packed:
        params = pack_model_params(params)
    batch = model_batch(cfg, torch.as_tensor(_prompts(args, cfg, args.batch),
                                             device=dev).long())
    mesh = model_ranks()

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, time.perf_counter() - t0

    def split(fn):
        """(last output, first call's seconds, the next `iters` calls')."""
        out, first = timed(fn)
        times = []
        for _ in range(iters):
            out, t = timed(fn)
            times.append(t)
        return out, first, times

    # prefill: full-sequence forward building batch caches
    (logits, pre_caches), pf_first, times = split(
        lambda: prefill(params, cfg, batch))
    prefill_stats = {"compile_s": pf_first, "avg_s": float(np.mean(times))}

    # insert: splice prefill caches into the ctx-length decode caches
    empty = empty_caches(cfg, args.batch, ctx_len, device=dev)
    caches, ins_first, times = split(
        lambda: splice_caches(empty, pre_caches) if mesh is None else
        splice_rank_caches(empty, pre_caches, args.prompt_len, ctx_len,
                           mesh))
    insert_stats = {"compile_s": ins_first, "avg_s": float(np.mean(times))}

    # generate: steady-state decode steps after one untimed warm-up
    dec = make_decode_fn(cfg, ctx_len, args.temperature, args.engine,
                         args.n_queues)
    tok = logits[:, -1, :].argmax(-1)[:, None]
    pos0 = torch.full((args.batch,), args.prompt_len, dtype=torch.long,
                      device=dev)
    _, gen_first = timed(lambda: dec(params, tok, caches, pos0,
                                     fold_in(args.seed, 100)))
    step_times = []
    for i in range(max(args.gen - 1, 1)):
        pos = torch.full((args.batch,), args.prompt_len + i,
                         dtype=torch.long, device=dev)
        (tok, caches), t = timed(lambda: dec(params, tok, caches, pos,
                                             fold_in(args.seed, 100 + i)))
        step_times.append(t)
    p50, p99 = _percentiles_ms(step_times)
    generate_stats = {
        "compile_s": gen_first,
        "tok_per_s": args.batch * len(step_times)
        / max(sum(step_times), 1e-9),
        "p50_ms": p50, "p99_ms": p99}

    split_stats = {"prefill": prefill_stats, "insert": insert_stats,
                   "generate": generate_stats}
    ranks = ambient_ranks()
    if ranks is not None:
        _every_rank(split_stats, ranks)
    stats = {"arch": cfg.arch, "engine": args.engine, "device": str(dev),
             "packed": bool(args.packed), "batch": args.batch,
             "microbench": split_stats}
    return None, stats


def _every_rank(split_stats: Dict[str, Dict[str, float]], mesh) -> None:
    """Each stage's figures from every rank of `mesh` (one all-gather),
    added to the stage as `per_rank` {name: [rank 0's, ...]} and `max`."""
    names = [(stage, k) for stage, fig in split_stats.items() for k in fig]
    mine = torch.tensor([[split_stats[st][k] for st, k in names]],
                        dtype=torch.float64, device=mesh.device)
    every = mesh_all_gather(mine, mesh, mesh.axis_names, 0).cpu()
    order = np.argsort(mesh.ranks.reshape(-1))
    every = every[torch.as_tensor(order)]
    for j, (stage, k) in enumerate(names):
        fig = split_stats[stage]
        col = every[:, j].tolist()
        fig.setdefault("per_rank", {})[k] = col
        fig.setdefault("max", {})[k] = max(col)


def run_continuous(args, *, params=None, prompts=None
                   ) -> Tuple[Dict[int, np.ndarray], Dict[str, Any]]:
    """Staggered requests through the wave batcher; arrivals join the next
    shared wave, positions and slots tracked per request.  `prompts` (a
    list of 1-D token arrays, any lengths) replaces the --continuous
    seeded prompts; `params` (dense) the seeded weights (over ranks the
    whole tree, of which each rank keeps its blocks).  Over ranks every
    rank runs the same waves and returns the same results."""
    dev = resolve_device(args.device)
    cfg = build_cfg(args)
    with serve_mesh(args, dev) as mesh:
        if mesh.ranks is not None:
            dev = mesh.device
            if params is not None and model_ranks() is not None:
                params = place_params(params, mesh, cfg.family)
        return _continuous(args, cfg, dev, params, prompts)


def _continuous(args, cfg, dev, params, prompts
                ) -> Tuple[Dict[int, np.ndarray], Dict[str, Any]]:
    ctx_len = args.ctx or (args.prompt_len + args.gen)
    if params is None:
        params = init_params(args.seed, cfg, device=dev)
    if args.packed:
        params = pack_model_params(params)
    batcher = WaveBatcher(cfg, params, n_slots=args.batch, ctx_len=ctx_len,
                          temperature=args.temperature, seed=args.seed,
                          engine=args.engine, n_queues=args.n_queues,
                          device=dev)
    if prompts is None:
        prompts = list(_prompts(args, cfg, args.continuous))
    for r, prompt in enumerate(prompts):
        batcher.submit(prompt, args.gen, arrival_wave=r * args.arrive_every)
    t0 = time.perf_counter()
    results = batcher.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    total_toks = sum(len(v) for v in results.values())
    occupancy = (float(np.mean([w["n_active"] for w in batcher.wave_log]))
                 if batcher.wave_log else 0.0)
    stats = {
        "arch": cfg.arch, "engine": args.engine, "device": str(dev),
        "packed": bool(args.packed), "n_requests": len(prompts),
        "n_slots": args.batch, "n_waves": batcher.wave,
        "total_tokens": total_toks, "wall_s": wall,
        "tok_per_s": total_toks / max(wall, 1e-9),
        "mean_active_slots": occupancy,
        "request_tokens": {int(r): v.tolist()[:8]
                           for r, v in results.items()},
    }
    return results, stats


def main(argv=None):
    args = parse_args(argv)
    ranks = init_ranks(args.device)
    try:
        return _main(args, ranks is None or ranks.rank == 0)
    finally:
        if ranks is not None:
            ranks.close()


def _main(args, lead: bool):
    if args.telemetry or args.trace_out:
        telemetry.arm()
    if args.microbench:
        gen, stats = run_microbench(args)
    elif args.continuous:
        gen, stats = run_continuous(args)
    else:
        gen, stats = run_serve(args)
    if telemetry.enabled() and "telemetry" not in stats:
        stats["telemetry"] = telemetry.snapshot()
    if args.trace_out and lead:
        stats["trace_out"] = telemetry.export_trace(args.trace_out)
    if lead:
        print(json.dumps(stats))
    return gen


if __name__ == "__main__":
    main()
