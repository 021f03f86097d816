"""The dense LM under a `model` axis over ranks: Megatron's cut params and
their collectives (`core.mesh`'s sub-groups and operators, `models.
layers`' column- and row-parallel products, the rank's heads, the
vocab-parallel embedding, head and cross-entropy, flash-decoding over a
sequence-cut cache, `runtime.steps`' (model, data) update), in training
and in serving, held against the port's one-process run and the
reference.

Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
4 ranks runs the (2, 2) and (1, 4) meshes, then a world of 2 ranks the
(1, 2) mesh (it restores the (2, 2) checkpoint).  Each scenario's
results go back to the parent in a file; the parent computes the
one-process and reference numbers.

Bounds, each measured on this CPU first:
  * a (1, 1) mesh under a process group: bit for bit the plain run.
  * the Megatron operators (a column then a row product, float32):
    outputs and gradients within OPS_TOL (1e-6 absolute plus 1e-6
    relative) of one process's (measured: 1.2e-6 absolute on values near
    1.2, 1e-6 relative): the products' partials sum in another order.
  * the row-parallel BitLinear's ±1 dot: exact; its alpha the correctly
    rounded mean (summed in float64), and within ALPHA_ULPS float32 ulps
    of one process's float32 `mean`, which sums in its own order and is
    itself up to 3 ulps from the exact mean (measured at [256, 128] and
    [3072, 768]); the vocab-parallel embedding: equal.
  * the vocab-parallel CE and its gradient (a padded vocabulary, its pad
    columns masked at their global index): OPS_TOL.
  * the global gradient norm: rtol F32_RTOL, as the data ranks'.
  * training (float32 configs): losses, metrics and params within
    `test_torch_ranks`' bounds (F32_RTOL, F32_PARAM_ATOL / RTOL) of one
    process's; the bfloat16 CLI from the reference trainer's state within
    its REF_LOSS_RTOL of the reference's losses.
  * prefill (float32): logits and the gathered caches PREFILL_ATOL of one
    process's and the reference's (the test_torch_lm bound, 2e-5);
    greedy tokens equal on every route.
  * heads the model axis does not divide (6 over 4, 9 over 4): prefill
    logits PREFILL_ATOL, a decode step's logits PREFILL_ATOL and one
    step's gradients (the rank's blocks) within the gradient-norm test's
    bounds of one process's and of the reference's (its prefill,
    decode_step and value_and_grad on the same params and inputs).
  * the dry-run's rank trace (`launch.dryrun.rank_trace`, a fake process
    group on meta tensors) against each gloo rank's own record of the
    same step: calls and payload bytes by axis and calls by kind equal.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import local_block, make_named_mesh
from repro_torch.launch import dryrun, serve, train
from repro_torch.models import (init_params, layers, lm_from_jax, prefill,
                                transformer)
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map

from test_torch_ranks import (F32_PARAM_ATOL, F32_PARAM_RTOL, F32_RTOL,
                              REF_LOSS_RTOL, SMALL, assert_mostly_close,
                              assert_trees_close, assert_trees_equal,
                              batches, flat, float32_configs, main_lines,
                              restore, result, run_world, step_losses,
                              step_run)

OPS_TOL = {"atol": 1e-6, "rtol": 1e-6}
ALPHA_ULPS = 3
PREFILL_ATOL = 2e-5
TP_REF_CLI = ["--arch", "drim-bnn", "--smoke-config", "--steps", "3",
              "--batch", "2", "--seq", "32", "--log-every", "1", "--lr",
              "3e-3", "--warmup", "1"]
SERVE_ARGS = ["--arch", "drim-bnn", "--smoke-config", "--device", "cpu",
              "--prompt-len", "32", "--gen", "5", "--temperature", "0"]
# a cache of 40 positions is cut over the sequence at M = 2 and 4; one of
# 37 (the prompt and 5 tokens) is whole on every rank
ROUTES = {"gpu": ["--ctx", "40"], "packed": ["--ctx", "40", "--packed"],
          "resident": ["--ctx", "40", "--engine", "resident"],
          "gpu whole cache": []}
PAD_VOCAB = 500                 # padded to 512


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32(arch="drim-bnn", **over):
    return get_smoke_config(arch).replace(dtype="float32", **over)


def host_mesh(model_axis):
    return train.cli_mesh("host", torch.device("cpu"), model_axis=model_axis)


def seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def mesh_here(shape):
    """The (D, M) mesh of ranks built here without a group (for
    `local_block` of a given rank)."""
    mesh = make_named_mesh(shape, ("data", "model"),
                           [torch.device("cpu")] * int(np.prod(shape)))
    return dataclasses.replace(mesh, ranks=np.arange(
        int(np.prod(shape))).reshape(shape))


# --- the rank side -----------------------------------------------------------

def ops_inputs():
    x = seeded((2, 8, 128), 1)
    w1, w2 = seeded((128, 256), 2) / 8, seeded((256, 128), 3) / 16
    return x, w1, w2


def scenario_ops(out):
    """The Megatron operators, the BitLinear row parts, the embedding and
    the vocab-parallel CE at (1, M)."""
    mesh = host_mesh(out["world"])
    index, m = core_mesh.model_coord(mesh)
    x, w1, w2 = ops_inputs()
    # the whole params, drawn outside the mesh (inside it each rank draws
    # only its blocks)
    cfg = f32(vocab_size=PAD_VOCAB)
    params = init_params(0, cfg, device="cpu")
    whole = init_params(0, f32(), device="cpu")
    w1b = w1[:, index * 256 // m:(index + 1) * 256 // m].clone()
    w2b = w2[index * 256 // m:(index + 1) * 256 // m].clone()
    x, w1b, w2b = (t.requires_grad_(True) for t in (x, w1b, w2b))
    res = {}
    with mesh:
        h = layers.linear_col({"kernel": w1b},
                              core_mesh.copy_to_model(x, mesh), 256)
        y = layers.linear_row({"kernel": w2b}, torch.tanh(h), 256, 128)
        (y * seeded(y.shape, 4)).sum().backward()
        res["mlp"] = {"y": y.detach(), "dx": x.grad, "dw1": w1b.grad,
                      "dw2": w2b.grad}
        rows = w2b.detach()
        dot, alpha = layers.row_bitlinear_parts(
            rows, torch.tanh(h).detach(), 256, mesh)
        res["bitlinear"] = {"dot": dot, "alpha": alpha}
        lo = index * 512 // m
        local = {"embed": params["embed"][lo:lo + 512 // m],
                 "head": params["head"][:, lo:lo + 512 // m].clone()
                 .requires_grad_(True),
                 "final_norm": params["final_norm"]}
        toks = torch.from_numpy(np.random.default_rng(5).integers(
            0, PAD_VOCAB, (2, 8)))
        res["embed"] = transformer._embed(local, cfg, toks, {})
        hid = seeded((2, 8, cfg.d_model), 6).requires_grad_(True)
        logits, lo_ = transformer._vocab_logits(local, cfg, hid, mesh)
        nll = transformer._vocab_parallel_ce(logits, toks, lo_, mesh)
        nll.sum().backward()
        res["ce"] = {"nll": nll.detach(), "dhid": hid.grad,
                     "dhead": local["head"].grad}
        # the global gradient norm of the model blocks
        cfg = f32()
        specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
        placed = steps.cut(whole, specs["params"], mesh)
        b = steps.rank_rows(batches(cfg, 1)[0], mesh)[0]
        _, metrics, raw = steps._loss_and_grads(cfg, placed, b)
        grads = steps.sum_rank_grads(cfg, raw, b, mesh)
        res["norm"] = {"loss": metrics["ce"],
                       "norm": steps.tp_global_norm(grads, specs["params"],
                                                    mesh),
                       "grads": grads}
        # the remat layers' recompute off the forward's thread (the
        # autograd engine's thread on the card), where `with mesh:` is
        # not in effect
        live = tree_map(lambda t: t.detach().requires_grad_(True), placed)
        loss, _ = transformer.train_loss(live, cfg, b)
    got = {}

    def backward():
        got["grads"] = torch.autograd.grad(loss, tree_leaves(live))
    worker = threading.Thread(target=backward)
    worker.start()
    worker.join()
    res["thread"] = all(torch.equal(a, c) for a, c in
                        zip(got["grads"], tree_leaves(raw)))
    return res


def scenario_cli(out):
    """The float32 CLI at the world's meshes, 3 steps, a checkpoint."""
    got = {}
    axes = (2, 4) if out["world"] == 4 else (2,)
    for arch in ("drim-bnn", "qwen3-14b"):
        for k in axes:
            if arch == "qwen3-14b" and k == 4:
                continue
            with float32_configs():
                final, lines = main_lines([
                    "--arch", arch, *SMALL, "--steps", "3", "--model-axis",
                    str(k), "--ckpt-dir",
                    out["dir"] + f"/cli_{arch}_{out['world']}_{k}"])
            got[(arch, k)] = {"final": final, "lines": lines}
    return got


def scenario_reference(out):
    """The bfloat16 CLI at (1, 2) from the reference trainer's state."""
    state_np = torch.load(out["dir"] + "/ref_state.pt", weights_only=False)
    inner = train.build

    def from_reference(args, mesh=None):
        cfg, step_fn, _ = inner(args, mesh)
        return cfg, step_fn, lambda seed, device=None: \
            steps.train_state_from_jax(state_np, cfg, device=device)
    train.build = from_reference
    try:
        _, lines = main_lines(TP_REF_CLI + ["--device", "cpu",
                                            "--model-axis", "2"])
    finally:
        train.build = inner
    return {"losses": step_losses(lines)}


def scenario_optimizers(out):
    """adafactor, adam8bit and --compress at (2, 2), 2 steps."""
    mesh = host_mesh(2)
    res = {}
    for name, opt, compress in (("adafactor", "adafactor", False),
                                ("adam8bit", "adam8bit", False),
                                ("compress", "adamw", True)):
        m, state, specs = step_run("drim-bnn", opt, 2, mesh,
                                   compress=compress)
        shapes = steps.state_pspecs(f32(), get_optimizer(opt), mesh,
                                    compress)[1]
        res[name] = {"metrics": m,
                     "params": steps.gather(state["params"],
                                            specs["params"],
                                            shapes["params"], mesh)}
    return res


def scenario_restore(out):
    """The (2, 2) run's checkpoint restored at (1, 2): each rank's blocks
    of the whole leaves, and 1 more step from them."""
    mesh = host_mesh(2)
    cfg = get_smoke_config("drim-bnn")
    like = steps.abstract_train_state(cfg, get_optimizer("adamw"))
    from repro_torch.checkpoint.checkpoint import Checkpointer
    ck = Checkpointer(out["dir"] + "/cli_drim-bnn_4_2")
    specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
    state = steps.place(ck.restore(ck.latest_step(), like, device="cpu"),
                        tree_map(lambda s: core_mesh.NamedSharding(mesh, s),
                                 specs))
    return {"state": state}


def prefill_inputs(out):
    """(float32 config, the reference trainer's initial params, tokens)."""
    state_np = torch.load(out["dir"] + "/ref_state.pt", weights_only=False)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (4, 32)))
    return f32(), state_np["params"], toks


def scenario_prefill(out):
    """The float32 prefill at each mesh of the world from the reference's
    params: the whole logits and the rank's cache blocks."""
    cfg, params_np, toks = prefill_inputs(out)
    params = lm_from_jax(params_np, cfg, device="cpu")
    res = {}
    for k in ((2, 4) if out["world"] == 4 else (2,)):
        with host_mesh(k) as mesh:
            placed = serve.place_params(params, mesh)
            logits, caches = prefill(placed, cfg, {"tokens": toks})
        res[k] = {"logits": logits, "caches": caches}
    return res


def scenario_serve(out):
    """The bfloat16 CLI serve loop on each route at each mesh, and the
    rank's decode cache blocks."""
    res = {}
    for k in ((2, 4) if out["world"] == 4 else (2,)):
        for route, extra in ROUTES.items():
            args = serve.parse_args(SERVE_ARGS + extra
                                    + ["--model-axis", str(k)])
            gen, stats = serve.run_serve(args)
            res[(k, route)] = gen
    return res


def scenario_cache_blocks(out):
    """The rank's empty decode caches and spliced caches at (1, M): the
    shapes of its `cache_pspecs` blocks, for a length the axis divides
    and one it does not."""
    cfg = get_smoke_config("drim-bnn")
    mesh = host_mesh(out["world"])
    res = {}
    with mesh:
        for ctx in (36, 37):
            res[ctx] = tuple(transformer.empty_caches(
                cfg, 4, ctx, device="cpu")["k"].shape)
    return res


# heads a model axis of 4 does not divide: 1.5 a rank, each rank's two
# heads reading one KV head; 2.25 a rank, rank 1's heads 2-4 reading KV
# heads 0, 1, 1 (`attention.kv_index`: one KV head a query head)
UNEVEN = {"6 over 2": {"n_heads": 6, "n_kv_heads": 2},
          "9 over 3": {"n_heads": 9, "n_kv_heads": 3}}
UNEVEN_CTX = (40, 37)            # a sequence-cut decode cache, a whole one


def uneven_cfg(name):
    return get_smoke_config("qwen3-14b").replace(dtype="float32",
                                                 **UNEVEN[name])


def uneven_inputs(cfg):
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (4, 32)))
    return init_params(0, cfg, device="cpu"), toks


def uneven_decode(params, cfg, toks, logits, caches, ctx, mesh=None):
    """One greedy decode step after a prefill of `toks` into float32
    caches of `ctx` positions (the rank's blocks under a mesh of ranks;
    bfloat16 caches would round float-order changes of K and V apart)."""
    empty = transformer.empty_caches(cfg, toks.shape[0], ctx,
                                     dtype=torch.float32, device="cpu")
    spliced = (serve.splice_caches(empty, caches) if mesh is None else
               serve.splice_rank_caches(empty, caches, toks.shape[1], ctx,
                                        mesh))
    tok = logits[:, -1].argmax(-1)[:, None]
    pos = torch.full((toks.shape[0],), toks.shape[1], dtype=torch.long)
    return transformer.decode_step(params, cfg, tok, spliced, pos, ctx)[0]


def scenario_uneven_heads(out):
    """Heads a model axis of 4 does not divide, at (1, 4): the float32
    prefill's logits, a decode step's over each cache, one step's
    gradients of the rank's blocks."""
    mesh = host_mesh(4)
    res = {}
    for name in UNEVEN:
        cfg = uneven_cfg(name)
        params, toks = uneven_inputs(cfg)
        got = {}
        with mesh:
            placed = serve.place_params(params, mesh)
            logits, caches = prefill(placed, cfg, {"tokens": toks})
            got["prefill"] = logits
            for ctx in UNEVEN_CTX:
                got[ctx] = uneven_decode(placed, cfg, toks, logits, caches,
                                         ctx, mesh)
            specs = steps.state_pspecs(cfg, get_optimizer("adamw"),
                                       mesh)[0]
            b = steps.rank_rows(batches(cfg, 1)[0], mesh)[0]
            got["grads"] = steps.sum_rank_grads(cfg, steps._loss_and_grads(
                cfg, steps.cut(params, specs["params"], mesh), b)[2], b,
                mesh)
        res[name] = got
    return res


# The rank trace against the gloo run: drim-bnn and an arch of each other
# family at smoke width, a train, prefill and decode step each
TRACE_ARCHS = ("drim-bnn", "qwen3-14b", "deepseek-v3-671b", "mamba2-130m",
               "zamba2-1.2b", "whisper-medium", "llava-next-34b")
TRACE_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
TRACE_BATCH, TRACE_SEQ, TRACE_CTX = 4, 32, 40


def trace_batch(cfg, kind, device):
    """A step's global batch: seeded on a real device, meta tensors of
    the same shapes and dtypes on meta."""
    s = 1 if kind == "decode" else TRACE_SEQ
    shapes = {"tokens": ((TRACE_BATCH, s), torch.long)}
    if kind == "train":
        shapes["labels"] = ((TRACE_BATCH, s), torch.long)
    if kind != "decode" and cfg.family == "vlm":
        shapes["patch_embeds"] = ((TRACE_BATCH, cfg.n_patches, cfg.d_model),
                                  torch.bfloat16)
    if kind != "decode" and cfg.family == "audio":
        shapes["frames"] = ((TRACE_BATCH, cfg.n_frames, cfg.d_model),
                            torch.bfloat16)
    if torch.device(device).type == "meta":
        return {k: torch.empty(shp, dtype=dt, device="meta")
                for k, (shp, dt) in shapes.items()}
    rng = np.random.default_rng(9)
    return {k: (torch.from_numpy(rng.integers(0, cfg.vocab_size, shp))
                if dt == torch.long else
                torch.from_numpy(rng.standard_normal(shp).astype(
                    np.float32)).to(dt))
            for k, (shp, dt) in shapes.items()}


def trace_cfg(arch, kind):
    """The arch's smoke config (whisper's widened to 4 heads, as the audio
    ranks tests widen it: its cross-attention takes whole heads a rank);
    a serving step's in the dry-run's bfloat16 serving dtype."""
    cfg = get_smoke_config(arch)
    if arch == "whisper-medium":
        cfg = cfg.replace(n_heads=4, n_kv_heads=4)
    return cfg if kind == "train" else cfg.replace(param_dtype="bfloat16",
                                                   remat=False)


def scenario_trace(out):
    """Every (arch, kind) step at each mesh of the world, its collectives
    recorded (`core.mesh.record_collectives`) -> `dryrun.
    collective_fields`."""
    res = {}
    for shape in TRACE_SHAPES[out["world"]]:
        mesh = host_mesh(shape[1])
        for arch in TRACE_ARCHS:
            for kind in ("train", "prefill", "decode"):
                cfg = trace_cfg(arch, kind)
                fn, args, grad = dryrun.rank_steps(
                    cfg, kind, mesh, trace_batch(cfg, kind, "cpu"),
                    ctx_len=TRACE_CTX, device="cpu")
                with core_mesh.record_collectives() as calls, \
                        (torch.enable_grad() if grad else torch.no_grad()):
                    fn(*args)
                res[(shape, arch, kind)] = dryrun.collective_fields(calls)
    return res


def scenario_refusals(out):
    said = {}
    calls = {
        "moe": lambda: serve.main(["--arch", "deepseek-v3-671b",
                                   "--smoke-config", "--device", "cpu",
                                   "--model-axis", "2"]),
        "audio": lambda: train.main(["--arch", "whisper-medium", *SMALL,
                                   "--steps", "1", "--model-axis", "2"]),
        "divide": lambda: host_mesh(3),
        "continuous": lambda: serve.main(SERVE_ARGS + ["--continuous", "2",
                                                       "--model-axis", "2"]),
        "moe_train": lambda: train.main(["--arch", "kimi-k2-1t-a32b",
                                         *SMALL, "--steps", "1",
                                         "--model-axis", "2"]),
    }
    for name, call in calls.items():
        try:
            got = call()
            said[name] = ("ran", getattr(got, "shape", got))
        except ValueError as err:
            said[name] = str(err)
    return said


def _rank_entry(rank, world, store, out_dir, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    try:
        for name in names:
            out = {"dir": out_dir, "world": world}
            try:
                results[name] = globals()[f"scenario_{name}"](out)
            except Exception:   # noqa: BLE001 -- reported by the parent
                import traceback
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# --- the parent side ---------------------------------------------------------

@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp
    import types

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, steps=jsteps)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("tp")


@pytest.fixture(scope="module")
def reference(jref, tmp):
    from test_torch_train_families import reference_cli_run
    state_np, metrics = reference_cli_run(jref, TP_REF_CLI)
    torch.save(state_np, tmp / "ref_state.pt")
    return metrics


@pytest.fixture(scope="module")
def world4(reference, tmp):
    return run_world(4, ["cli", "optimizers", "prefill", "serve", "ops",
                         "cache_blocks", "uneven_heads", "trace"], tmp,
                     entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, reference, tmp):
    return run_world(2, ["ops", "cli", "reference", "restore", "prefill",
                         "serve", "cache_blocks", "refusals", "trace"], tmp,
                     entry=_rank_entry)


def blocks_of(whole, shape, spec, world):
    """Each rank's block of `whole` under `spec` over the mesh `shape`."""
    mesh = mesh_here(shape)
    return [whole[local_block(tuple(whole.shape), spec, mesh, r)]
            for r in range(world)]


def close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), err_msg=what,
                               **tol)


# --- the operators -----------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
def test_megatron_operators_equal_one_process(m, world2, world4):
    """A column product, tanh, a row product at (1, M): the output and
    the gradients of x and of each rank's weight blocks."""
    ranks = {2: world2, 4: world4}[m]
    x, w1, w2 = ops_inputs()
    x, w1, w2 = (t.requires_grad_(True) for t in (x, w1, w2))
    y = torch.tanh(x @ w1) @ w2
    (y * seeded(y.shape, 4)).sum().backward()
    for r in range(m):
        got = result(ranks, "ops", r)["mlp"]
        close(got["y"], y, OPS_TOL, "y")
        close(got["dx"], x.grad, OPS_TOL, "dx")
        w = 256 // m
        close(got["dw1"], w1.grad[:, r * w:(r + 1) * w], OPS_TOL, "dw1")
        close(got["dw2"], w2.grad[r * w:(r + 1) * w], OPS_TOL, "dw2")


@pytest.mark.parametrize("m", [2, 4])
def test_row_bitlinear_dot_is_exact(m, world2, world4):
    ranks = {2: world2, 4: world4}[m]
    x, w1, w2 = ops_inputs()
    h = torch.tanh(x @ w1)
    want = layers._ste_sign(h) @ layers._ste_sign(w2)
    alpha = w2.abs().mean(0)
    for r in range(m):
        got = result(ranks, "ops", r)["bitlinear"]
        assert torch.equal(got["dot"], want)
        assert torch.equal(got["alpha"],
                           w2.abs().to(torch.float64).mean(0).float())
        ulp = torch.nextafter(alpha, torch.full_like(alpha, np.inf)) - alpha
        assert float(((got["alpha"] - alpha).abs() / ulp).max()) \
            <= ALPHA_ULPS


@pytest.mark.parametrize("m", [2, 4])
def test_vocab_parallel_embedding_and_cross_entropy(m, world2, world4):
    """A padded vocabulary (500 of 512 columns): the lookup equal, the CE
    and its gradients within OPS_TOL, the pad columns masked at their
    global index (a local mask would leave rank 0's columns 500-511 of a
    256-column block alone, and rank 1's none)."""
    ranks = {2: world2, 4: world4}[m]
    cfg = f32(vocab_size=PAD_VOCAB)
    params = init_params(0, cfg, device="cpu")
    params["head"].requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, PAD_VOCAB, (2, 8)))
    emb = transformer._embed(params, cfg, toks, {})
    hid = seeded((2, 8, cfg.d_model), 6).requires_grad_(True)
    logits = transformer._logits(params, cfg, hid)
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, toks[..., None])[..., 0]
    nll.sum().backward()
    assert bool((logits[..., PAD_VOCAB:] == torch.tensor(-1e30)).all())
    for r in range(m):
        got = result(ranks, "ops", r)
        assert torch.equal(got["embed"], emb)
        close(got["ce"]["nll"], nll, OPS_TOL, "nll")
        close(got["ce"]["dhid"], hid.grad, OPS_TOL, "dhid")
        w = 512 // m
        close(got["ce"]["dhead"], params["head"].grad[:, r * w:(r + 1) * w],
              OPS_TOL, "dhead")


@pytest.mark.parametrize("m", [2, 4])
def test_grad_norm_counts_each_leaf_once(m, world2, world4):
    """The global norm from the model blocks equals one process's; the
    blocks' gradients are one process's cut by the specs (at (1, 4) the
    KV heads are half-head column blocks: each rank gathers wk and wv and
    takes the head its query head reads)."""
    ranks = {2: world2, 4: world4}[m]
    cfg = f32()
    params = init_params(0, cfg, device="cpu")
    b = batches(cfg, 1)[0]
    loss, _, grads = steps._loss_and_grads(cfg, params, b)
    norm = global_norm(grads)
    mesh = mesh_here((1, m))
    specs = sharding.param_pspecs(params, mesh)
    for r in range(m):
        got = result(ranks, "ops", r)["norm"]
        np.testing.assert_allclose(float(got["norm"]), float(norm),
                                   rtol=F32_RTOL)
        np.testing.assert_allclose(float(got["loss"]), float(loss),
                                   rtol=F32_RTOL)
        want = tree_map(lambda g, s: g[local_block(tuple(g.shape), s, mesh,
                                                   r)], grads, specs)
        assert_trees_close(got["grads"], want, 1e-5, 1e-4)
        assert result(ranks, "ops", r)["thread"]


def test_one_by_one_mesh_under_a_group_is_the_plain_run(tmp_path):
    """A (1, 1) mesh of ranks (one process under a gloo group): two steps
    bit for bit the steps without a mesh."""
    want_m, want, _ = step_run("drim-bnn", "adamw", 2, None)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = host_mesh(1)
        assert mesh.ranks is not None and mesh.shape == {"data": 1,
                                                         "model": 1}
        got_m, got, _ = step_run("drim-bnn", "adamw", 2, mesh)
    finally:
        dist.destroy_process_group()
    assert got_m == want_m
    assert_trees_equal(got["params"], want["params"])
    assert_trees_equal(got["opt"], want["opt"])


# --- training ----------------------------------------------------------------

_ONE_PROCESS = {}


def one_process_cli(arch, tmp):
    """(step lines, restored checkpoint) of the float32 CLI in one
    process, once per arch."""
    if arch not in _ONE_PROCESS:
        with float32_configs():
            _, lines = main_lines(["--arch", arch, *SMALL, "--steps", "3",
                                   "--ckpt-dir", str(tmp / f"one_{arch}")])
        _ONE_PROCESS[arch] = ([ln for ln in lines if "step" in ln],
                              restore(tmp / f"one_{arch}", arch))
    return _ONE_PROCESS[arch]


@pytest.mark.parametrize("arch,shape", [
    ("drim-bnn", (1, 2)), ("drim-bnn", (2, 2)), ("drim-bnn", (1, 4)),
    ("qwen3-14b", (1, 2)), ("qwen3-14b", (2, 2))])
def test_cli_over_a_model_axis_equals_one_process(arch, shape, world2,
                                                  world4, tmp):
    """`train.main --model-axis M` over D * M ranks: every step's loss,
    CE, grad norm and lr, and the checkpoint's whole params and moments,
    within the data ranks' float32 bounds of one process's; rank 0 alone
    prints the steps."""
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    got = result(ranks, "cli")[(arch, shape[1])]
    want, whole = one_process_cli(arch, tmp)
    have = [ln for ln in got["lines"] if "step" in ln]
    assert got["lines"][0]["world_size"] == world and len(have) == 3
    for h, w in zip(have, want):
        for key in ("loss", "ce", "grad_norm", "lr", "ntokens"):
            np.testing.assert_allclose(h[key], w[key], rtol=F32_RTOL,
                                       err_msg=key)
    for r in range(1, world):
        assert not [ln for ln in result(ranks, "cli", r)[(arch, shape[1])]
                    ["lines"] if "step" in ln]
    assert_trees_close(restore(tmp / f"cli_{arch}_{world}_{shape[1]}",
                               arch), whole, F32_PARAM_ATOL, F32_PARAM_RTOL)


def test_model_axis_equals_the_reference_trainer(world2, reference):
    """The bfloat16 CLI at (1, 2) from the reference trainer's state: its
    losses within the one-process CLI's bound of the reference's."""
    got = result(world2, "reference")["losses"]
    assert len(got) == len(reference) == 3
    for g, w in zip(got, reference):
        np.testing.assert_allclose(g, w["loss"], rtol=REF_LOSS_RTOL)


@pytest.mark.parametrize("name", ["adafactor", "adam8bit", "compress"])
def test_whole_leaf_optimizers_at_two_by_two(name, world4):
    """adafactor (each rank's blocks updated, its factored statistics
    summed over the ranks that cut their axes), adam8bit (the runs of
    each rank's state rows updated, its block maxima taken over the ranks
    that cut the blocks' columns) and --compress (each rank's residual
    block fed back, a leaf's mean |g + err| summed over its blocks) at
    (2, 2), none of them on whole leaves: two steps' metrics within the
    float32 bounds and params within them (adam8bit: but for
    INT8_FLIP_SHARE of each leaf's elements, an int8 code that rounds
    the other way)."""
    opt = {"compress": "adamw"}.get(name, name)
    want_m, want, _ = step_run("drim-bnn", opt, 2, None,
                               compress=name == "compress")
    for r in range(4):
        got = result(world4, "optimizers", r)[name]
        for g, w in zip(got["metrics"], want_m):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=F32_RTOL,
                                           err_msg=key)
        if name == "adam8bit":
            assert_mostly_close(flat(got["params"]), flat(want["params"]))
            continue
        assert_trees_close(got["params"], want["params"], F32_PARAM_ATOL,
                           F32_PARAM_RTOL)


def test_two_by_two_checkpoint_restores_at_one_by_two(world2, tmp):
    """The (2, 2) run's checkpoint (whole leaves) restored in one process,
    and at (1, 2): each rank holds exactly its spec blocks of it."""
    whole = restore(tmp / "cli_drim-bnn_4_2")
    mesh = mesh_here((1, 2))
    specs = steps.state_pspecs(get_smoke_config("drim-bnn"),
                               get_optimizer("adamw"), mesh)[0]
    for r in range(2):
        got = result(world2, "restore", r)["state"]
        want = tree_map(lambda t, s: t[local_block(tuple(t.shape), s, mesh,
                                                   r)], whole, specs)
        assert_trees_equal(got, want)
    # the model-cut leaves are halves
    halves = [(g, w) for g, w in zip(tree_leaves(got), tree_leaves(whole))
              if g.shape != w.shape]
    assert len(halves) > 20
    assert all(2 * g.numel() == w.numel() for g, w in halves)


# --- serving -----------------------------------------------------------------

@pytest.fixture(scope="module")
def prefills(jref, tmp, reference):
    """(one process's logits and caches, the reference's) of the float32
    prefill of `prefill_inputs`."""
    cfg, params_np, toks = prefill_inputs({"dir": str(tmp)})
    logits, caches = prefill(lm_from_jax(params_np, cfg, device="cpu"), cfg,
                             {"tokens": toks})
    cj = jref.configs.get_smoke_config("drim-bnn").replace(dtype="float32")
    lj, pre_j = jref.models.prefill(
        jref.jax.tree.map(jref.jnp.asarray, params_np), cj,
        {"tokens": jref.jnp.asarray(toks.numpy())})
    return (logits, caches), (torch.from_numpy(np.array(lj)),
                              {k: torch.from_numpy(np.array(v))
                               for k, v in pre_j.items()})


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_prefill_logits_and_cache_blocks(shape, world2, world4, prefills):
    """Every rank's whole logits within PREFILL_ATOL of one process's and
    the reference's; each rank's caches are its `cache_pspecs` blocks of
    one process's (within the bound), so gathered they are the whole."""
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    (logits, caches), (lj, cj) = prefills
    mesh = mesh_here(shape)
    specs = sharding.cache_pspecs(mesh, caches)
    assert tuple(specs["k"]) == (None, "data", "model") or shape[0] == 1
    tol = {"atol": PREFILL_ATOL, "rtol": 0}
    for r in range(world):
        got = result(ranks, "prefill", r)[shape[1]]
        close(got["logits"], logits, tol, "logits")
        close(got["logits"], lj, tol, "reference logits")
        for name in ("k", "v"):
            sl = local_block(tuple(caches[name].shape), specs[name], mesh, r)
            assert got["caches"][name].shape == caches[name][sl].shape
            close(got["caches"][name], caches[name][sl], tol, name)
            close(got["caches"][name], cj[name][sl], tol, "reference")


@pytest.fixture(scope="module")
def served_one_process():
    return {route: serve.run_serve(serve.parse_args(SERVE_ARGS + extra))[0]
            for route, extra in ROUTES.items()}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_greedy_tokens_equal_on_every_route(shape, world2, world4,
                                            served_one_process):
    """`serve.run_serve` (bfloat16 smoke weights, a 32-token prompt, the
    prefill's token and 4 decode steps) on "gpu", "gpu --packed" and
    "resident" over a sequence-cut cache, and "gpu" over a whole one: the
    tokens one process serves, on every rank."""
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    want = served_one_process["gpu"]
    for route, gen in served_one_process.items():
        np.testing.assert_array_equal(gen, want, err_msg=route)
    for r in range(world):
        got = result(ranks, "serve", r)
        for route in ROUTES:
            np.testing.assert_array_equal(got[(shape[1], route)], want,
                                          err_msg=f"rank {r} {route}")


@pytest.mark.parametrize("m", [2, 4])
def test_decode_cache_blocks_follow_the_specs(m, world2, world4):
    """The rank's empty decode caches at (1, M): cut over the sequence
    where M divides it (36), whole where it does not (37)."""
    ranks = {2: world2, 4: world4}[m]
    for r in range(m):
        got = result(ranks, "cache_blocks", r)
        assert got[36] == (2, 4, 36 // m, 2, 32)
        assert got[37] == (2, 4, 37, 2, 32)


def test_refusals(world2):
    """The MoE and audio families run under a model axis (served and
    trained), and so does --continuous over ranks, with one process's
    request tokens; a model axis that does not divide the ranks raises
    ValueError, and so does K > 1 in one process."""
    said = result(world2, "refusals")
    assert said["moe"] == ("ran", (4, 16))
    assert said["moe_train"][0] == "ran" \
        and np.isfinite(said["moe_train"][1])
    assert said["audio"][0] == "ran" and np.isfinite(said["audio"][1])
    assert "does not divide 2 ranks" in said["divide"]
    assert said["continuous"][0] == "ran"
    want = serve.main(SERVE_ARGS + ["--continuous", "2"])
    got = said["continuous"][1]
    assert sorted(got) == sorted(want) == [0, 1]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    with pytest.raises(ValueError, match="process per position"):
        host_mesh(2)


def test_torchrun_serve_cli_over_a_model_axis(tmp_path):
    """The serve CLI as a user starts it, 2 gloo ranks with --model-axis
    2: every rank prints its first line, rank 0 alone the stats, whose
    tokens are one process's."""
    argv = SERVE_ARGS + ROUTES["gpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(
                   os.path.dirname(os.path.dirname(__file__)), "src"),
                   os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *argv,
         "--model-axis", "2"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(obj) for obj in re.findall(r"\{[^{}]*\}",
                                                   proc.stdout)]
    assert sorted(ln["rank"] for ln in lines if "rank" in ln) == [0, 1]
    stats = [ln for ln in lines if "sample_ids" in ln]
    _, want = serve.run_serve(serve.parse_args(argv))
    assert len(stats) == 1
    assert stats[0]["sample_ids"] == want["sample_ids"]


# --- heads the model axis does not divide -------------------------------------

@pytest.fixture(scope="module")
def uneven_reference(jref):
    """{name: the reference's float32 prefill logits, its decode step's
    logits over float32 caches of each UNEVEN_CTX, and its
    `value_and_grad` gradients (as the port's tree)} of each UNEVEN
    config, on the port's params and inputs of `uneven_inputs`."""
    from repro.launch import serve as jserve
    jnp = jref.jnp
    res = {}
    for name in UNEVEN:
        cfg = uneven_cfg(name)
        params, toks = uneven_inputs(cfg)
        cj = jref.configs.get_smoke_config("qwen3-14b").replace(
            dtype="float32", **UNEVEN[name])
        pj = jref.jax.tree.map(jnp.asarray,
                               tree_map(lambda t: t.numpy(), params))
        lj, pre = jref.models.prefill(pj, cj,
                                      {"tokens": jnp.asarray(toks.numpy())})
        got = {"prefill": torch.from_numpy(np.array(lj))}
        tok = jnp.argmax(lj[:, -1], -1)[:, None]
        pos = jnp.full((toks.shape[0],), toks.shape[1], dtype=jnp.int32)
        for ctx in UNEVEN_CTX:
            empty = jref.models.empty_caches(cj, toks.shape[0], ctx,
                                             dtype=jnp.float32)
            got[ctx] = torch.from_numpy(np.array(jref.models.decode_step(
                pj, cj, tok, jserve.splice_caches(empty, pre), pos,
                ctx)[0]))
        b = {k: jnp.asarray(v.numpy())
             for k, v in batches(cfg, 1)[0].items()}
        _, gj = jref.jax.value_and_grad(
            lambda p: jref.models.train_loss(p, cj, b), has_aux=True)(pj)
        got["grads"] = lm_from_jax(jref.jax.tree.map(np.asarray, gj), cfg,
                                   device="cpu")
        res[name] = got
    return res


@pytest.mark.parametrize("name", list(UNEVEN))
def test_heads_the_model_axis_does_not_divide(name, world4,
                                              uneven_reference):
    """6 heads over 2 KV heads and 9 over 3 at (1, 4), 1.5 and 2.25 heads
    a rank: each rank computes every head its block of wq's columns
    overlaps and hands exactly that block to the row-parallel wo.  The
    prefill's logits, a decode step's over a sequence-cut (40) and a whole
    (37) cache, and one step's gradients of each rank's blocks equal one
    process's and the reference's within the bounds."""
    cfg = uneven_cfg(name)
    params, toks = uneven_inputs(cfg)
    logits, caches = prefill(params, cfg, {"tokens": toks})
    tol = {"atol": PREFILL_ATOL, "rtol": 0}
    loss, _, grads = steps._loss_and_grads(cfg, params,
                                           batches(cfg, 1)[0])
    ref = uneven_reference[name]
    mesh = mesh_here((1, 4))
    specs = sharding.param_pspecs(params, mesh)
    for r in range(4):
        got = result(world4, "uneven_heads", r)[name]
        close(got["prefill"], logits, tol, "prefill")
        close(got["prefill"], ref["prefill"], tol, "reference prefill")
        for ctx in UNEVEN_CTX:
            close(got[ctx], uneven_decode(params, cfg, toks, logits, caches,
                                          ctx), tol, f"decode {ctx}")
            close(got[ctx], ref[ctx], tol, f"reference decode {ctx}")
        for whole in (grads, ref["grads"]):
            want = tree_map(lambda g, s: g[local_block(tuple(g.shape), s,
                                                       mesh, r)],
                            whole, specs)
            assert_trees_close(got["grads"], want, 1e-5, 1e-4)


def test_uneven_heads_split_and_straddle():
    """Which heads and columns each rank of 4 takes: 9 heads over 3 KV
    heads (n_rep 3) give rank 1 heads 2-4, whose KV heads 0, 1, 1 are read
    one a query head (`kv_index`); 6 over 2 leave every rank one KV head;
    an axis that does not divide H * Dh raises."""
    from repro_torch.models import attention
    cfg = uneven_cfg("9 over 3")
    assert [attention.head_split(cfg, i, 4) for i in range(4)] == [
        (0, 3, 0, 1), (2, 5, 0, 2), (4, 7, 1, 3), (6, 9, 2, 3)]
    assert [attention.head_columns(cfg, i, 4) for i in range(4)] == [
        (0, 72), (72, 144), (144, 216), (216, 288)]
    assert attention.kv_index(cfg, 2, 5, 0, 2) == [0, 1, 1]
    assert attention.kv_index(cfg, 0, 3, 0, 1) is None
    cfg6 = uneven_cfg("6 over 2")
    assert all(attention.kv_index(cfg6, *attention.head_split(cfg6, i, 4))
               is None for i in range(4))
    with pytest.raises(ValueError, match="do not divide"):
        attention.head_columns(cfg.replace(d_head=30), 0, 4)


# --- the dry-run's rank trace -------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_rank_trace_equals_the_gloo_run(shape, world2, world4):
    """The rank trace of each (arch, kind) step, on a fake process group
    and meta tensors as each rank, against that gloo rank's record of
    the same step: every collective field equal."""
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    for r in range(world):
        got = result(ranks, "trace", r)
        for arch in TRACE_ARCHS:
            for kind in ("train", "prefill", "decode"):
                cfg = trace_cfg(arch, kind)
                want = dryrun.rank_trace(
                    cfg, kind, shape, ("data", "model"),
                    trace_batch(cfg, kind, "meta"), ctx_len=TRACE_CTX,
                    rank=r, flops=False)
                have = got[(shape, arch, kind)]
                assert sum(have["collective_counts"].values()) > 0
                for key, value in have.items():
                    assert want[key] == value, (r, arch, kind, key)
                # the trace's own fields: its time and its memory (a
                # gloo rank's bytes hang on its worker threads' timing)
                assert want.keys() - have.keys() == {
                    "rank_trace_s", "mem_temp_b", "rank_argument_b"}
