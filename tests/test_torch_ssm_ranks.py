"""The ssm family over ranks: mamba2's smoke config with its params
replicated and its sequence cut over a `model` axis of ranks (the
reference's sequence-parallel path, `models.ssm.ssm_mix(seq_cut=True)`),
and served over a data mesh, held against the port's one-process runs
and the reference.

Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
4 ranks runs the (1, 4) and (2, 2) meshes, then a world of 2 ranks the
(1, 2) and (2, 1) meshes.  The parent computes the reference's and one
process's numbers and hands the ranks their inputs in files.

Bounds, each measured on this CPU first (float32 activations; the scan
rounds its operands to bfloat16, in the forward and, through the casts'
gradients, in the backward, so a float-order change that flips one
rounding moves a gradient by up to 2**-8 of its size):
  * the mixer alone (`ssm_mix` on a seeded [2, S, 64] input, the
    reference's `ssm_init` weights; one process's output within
    REF_MIX_ATOL, 2e-3, of the reference's at S = 512, measured 6.5e-4):
    the rank's block of the output, the final state and the conv tail
    within MIX_ATOL (1e-5; measured 0) of one process's, where each rank
    holds whole 256-token chunks (S = 512 and 1024 at (1, 2), 1024 at
    (1, 4)) and where it does not (S = 16 at (1, 2), 512 at (1, 4): the
    gathered sequence).  The gradients of the output's weighted sum, the
    input's block and each param's summed over the model group, within
    MIX_GRAD_RTOL of each leaf's largest |value| (sequence-parallel:
    1e-5, measured 1.5e-6; gathered: 1e-2, measured 1.7e-3: each rank's
    backward runs the whole sequence with the other blocks' gradients
    zero, and the partials' sum flips bfloat16 roundings).
  * the model (S = 512: `prefill`, three decode steps over a 516- and a
    517-long cache, the train loss's gradients summed over the axes the
    step sums them over): the prefill's last logits, every decode
    step's and the caches' blocks (the states over heads, the conv
    windows whole) within MODEL_ATOL (1e-5; measured 1.7e-6) at (1, 2),
    (2, 1), (2, 2) and (1, 4); the gradients within GRAD_RTOL of each
    leaf's largest |value| (1e-5 where the ranks hold whole chunks,
    measured 8.8e-7; 1e-2 at (1, 4), 128 tokens a rank, the gathered
    sequence, measured 1.5e-3), the gradient norm within NORM_RTOL (1e-4;
    measured 2.3e-6) of one process's.
  * the specs: mamba2's, zamba2's and llava's param, ZeRO-1 train-state
    and cache specs at full size equal the reference's at (1, 2), (2, 2)
    and (1, 4); the ranks' cache layout (`rank_cache_pspecs`) differs
    only in the SSM conv windows (whole over "model").
  * the rank-block init: the whole init on every rank, leaf for leaf
    (replicated params).
  * the serve CLI (float32 activations, bfloat16 params, the reference's
    weights through `lm_from_jax`, 512-token prompts): the reference
    CLI's greedy tokens at (1, 2), (2, 1), (2, 2) and (1, 4); the (2, 1)
    run gives one process's tokens bit for bit.
  * the train CLI from the reference trainer's state (bfloat16, 4 x 512
    tokens): each step's loss within `test_torch_ranks.REF_LOSS_RTOL`
    (1e-3) of the reference's at (1, 2), (2, 2) and (1, 4); the 2-rank
    checkpoint restored in one process equals each rank's state.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import PartitionSpec, local_block
from repro_torch.launch import serve, train
from repro_torch.models import init_params, prefill, ssm, transformer
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

from test_torch_moe_ranks import float32_serving, mesh_here
from test_torch_ranks import (REF_LOSS_RTOL, assert_trees_equal, flat,
                              main_lines, restore, result, run_world,
                              step_losses)

ARCH = "mamba2-130m"
B, S, CTXS = 2, 512, (516, 517)
MIX_ATOL = 1e-5
REF_MIX_ATOL = 2e-3
MIX_GRAD_RTOL = {"sp": 1e-5, "gathered": 1e-2}
MODEL_ATOL = 1e-5
# by mesh: (1, 4) cuts 512 tokens into blocks of 128, the gathered path
GRAD_RTOL = {(1, 2): 1e-5, (2, 1): 1e-5, (2, 2): 1e-5, (1, 4): 1e-2}
NORM_RTOL = 1e-4
# the mixer's cases by mesh: (S, the path each rank takes)
MIX_CASES = {(1, 2): ((512, "sp"), (1024, "sp"), (16, "gathered")),
             (1, 4): ((1024, "sp"), (512, "gathered"))}
SERVE_ARGV = ["--arch", ARCH, "--smoke-config", "--batch", "4",
              "--prompt-len", "512", "--gen", "5"]
TRAIN_ARGV = ["--arch", ARCH, "--smoke-config", "--steps", "3", "--batch",
              "4", "--seq", "512", "--log-every", "1", "--lr", "3e-3",
              "--warmup", "1"]
# (data, model) meshes each world runs
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_cfg(arch=ARCH):
    return configs.get_smoke_config(arch).replace(dtype="float32")


def host_mesh(model_axis):
    return train.cli_mesh("host", torch.device("cpu"), model_axis=model_axis)


def model_batch(cfg, seed=7, s=S):
    """Seeded tokens and labels [B, s], and the vlm's seeded patch
    embeddings."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, s)))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32))
    return batch


def model_run(params, cfg, mesh=None, ctxs=CTXS, s=S):
    """Prefill of `s` tokens, then three decode steps over each cache
    length of `ctxs`,
    and the train loss's gradients (over ranks: the rank's rows, summed
    as a step sums them, `steps.sum_rank_grads`), in one
    process or under `mesh` (a mesh of ranks: the rank's blocks)."""
    batch = model_batch(cfg, s=s)
    pre_batch = {k: v for k, v in batch.items() if k != "labels"}
    res = {}
    with (mesh if mesh is not None else contextlib.nullcontext()):
        with torch.no_grad():
            logits, pre = prefill(params, cfg, pre_batch)
            res["logits"], res["caches"] = logits, pre
            for ctx in ctxs:
                empty = transformer.empty_caches(cfg, B, ctx,
                                                 dtype=torch.float32,
                                                 device="cpu")
                caches = (serve.splice_caches(empty, pre) if mesh is None
                          else serve.splice_rank_caches(empty, pre, s, ctx,
                                                        mesh))
                out = []
                for i in range(3):
                    pos = torch.full((B,), s + i, dtype=torch.long)
                    lg, caches = transformer.decode_step(
                        params, cfg, batch["tokens"][:, i:i + 1], caches,
                        pos, ctx)
                    out.append(lg)
                res[ctx] = {"logits": out, "caches": caches}
        mine = batch if mesh is None else steps.rank_rows(batch, mesh)[0]
        _, _, grads = steps._loss_and_grads(cfg, params, mine)
        if mesh is not None:
            grads = steps.sum_rank_grads(cfg, grads, mine, mesh)
    res["grads"] = grads
    return res


def mix_inputs(s):
    """A seeded mixer input [B, s, d_model] and the weights of the
    output's weighted sum."""
    cfg = f32_cfg()
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((B, s, cfg.d_model))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((B, s, cfg.d_model))
                         .astype(np.float32))
    return x, w


def mix_run(p, x, w, mesh=None):
    """`ssm_mix` on x (under `mesh`: the rank's sequence block): the
    output, the cache, and the gradients of sum(out * w) for x and the
    params (over ranks summed over the model group)."""
    cfg = f32_cfg()
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    x = x.clone().requires_grad_(True)
    with (mesh if mesh is not None else contextlib.nullcontext()):
        out, cache = ssm.ssm_mix(live, cfg, x, seq_cut=mesh is not None)
        (out * w).sum().backward()
        leaves = tree_leaves(live)
        grads = [t.grad for t in leaves]
        if mesh is not None:
            grads = core_mesh.mesh_sum(grads, mesh, ("model",))
    return {"out": out.detach(), "cache": cache, "dx": x.grad,
            "grads": dict(zip(flat(live), grads))}


# --- the rank side -----------------------------------------------------------

def scenario_mix(out):
    """The mixer at each mesh of the world with a model axis, on the
    rank's sequence block."""
    p = torch.load(out["dir"] + "/mix_params.pt")
    res = {}
    for shape in SHAPES[out["world"]]:
        if shape != (1, out["world"]):
            continue
        mesh = host_mesh(shape[1])
        index, m = core_mesh.model_coord(mesh)
        for s, _ in MIX_CASES[shape]:
            x, w = mix_inputs(s)
            blk = slice(index * s // m, (index + 1) * s // m)
            res[(shape, s)] = mix_run(p, x[:, blk], w[:, blk], mesh)
    return res


def scenario_model(out):
    cfg = f32_cfg()
    params = torch.load(out["dir"] + "/model_params.pt")
    res = {}
    for shape in SHAPES[out["world"]]:
        mesh = host_mesh(shape[1])
        res[shape] = model_run(params, cfg, mesh)
        specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
        res[shape]["norm"] = steps.tp_global_norm(res[shape]["grads"],
                                                  specs["params"], mesh)
    return res


def scenario_init(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        with host_mesh(shape[1]):
            cfg = configs.get_smoke_config(ARCH).replace(
                param_dtype="bfloat16")
            res[shape] = init_params(0, cfg, device="cpu")
    return res


def scenario_serve(out):
    """The serve CLI (float32 activations) from the reference's weights
    and prompts at each mesh of the world."""
    params, toks = torch.load(out["dir"] + "/serve.pt", weights_only=False)
    res = {}
    for shape in SHAPES[out["world"]]:
        args = serve.parse_args(SERVE_ARGV + ["--device", "cpu",
                                              "--model-axis",
                                              str(shape[1])])
        with float32_serving(serve):
            res[shape], _ = serve.run_serve(args, params=params,
                                            tokens=toks)
    return res


def train_from(state_np, argv):
    """`train.main(argv)` from the reference trainer's state: (each
    step's loss, the step lines printed, the final state)."""
    inner, losses, last = train.build, [], []

    def from_reference(args, mesh=None):
        cfg, step_fn, _ = inner(args, mesh)

        def step(state, batch):
            new, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            last[:] = [new]
            return new, metrics
        return cfg, step, lambda seed, device=None: \
            steps.train_state_from_jax(state_np, cfg, device=device)
    train.build = from_reference
    try:
        _, lines = main_lines(argv)
    finally:
        train.build = inner
    return {"losses": losses, "printed": step_losses(lines),
            "state": last[0]}


def scenario_train(out):
    """The train CLI under a model axis of the world's meshes from the
    reference trainer's state; at (1, 2) with a checkpoint."""
    state_np = torch.load(out["dir"] + "/train.pt", weights_only=False)
    res = {}
    for shape in SHAPES[out["world"]]:
        if shape[1] == 1:
            continue
        ckpt = (["--ckpt-dir", out["dir"] + "/ckpt"] if shape == (1, 2)
                else [])
        res[shape] = train_from(state_np, TRAIN_ARGV + [
            "--device", "cpu", "--model-axis", str(shape[1]), *ckpt])
    return res


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
    import types

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.launch import serve as jserve
    from repro.models import ssm as jssm
    from repro.optim import get_optimizer as jget_optimizer
    from repro.runtime import sharding as jshd
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, serve=jserve, ssm=jssm,
                                 steps=jsteps, shd=jshd, P=P,
                                 get_optimizer=jget_optimizer)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("ssm_ranks")


@pytest.fixture(scope="module")
def mix_one(jref, tmp):
    """One process's mixer at every S of the cases, from the reference's
    `ssm_init` weights (saved for the ranks), and the reference's mixer
    output at S = 512."""
    jax = jref.jax
    cj = jref.configs.get_smoke_config(ARCH).replace(dtype="float32")
    pj = jref.ssm.ssm_init(jax.random.PRNGKey(3), cj)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    torch.save(p, tmp / "mix_params.pt")
    one = {}
    for s in sorted({s for cases in MIX_CASES.values() for s, _ in cases}):
        x, w = mix_inputs(s)
        one[s] = mix_run(p, x, w)
    x, _ = mix_inputs(512)
    y, _ = jref.ssm.ssm_mix(pj, cj, jref.jnp.asarray(x.numpy()))
    return p, one, torch.from_numpy(np.array(y))


@pytest.fixture(scope="module")
def model_one(tmp):
    cfg = f32_cfg()
    params = init_params(0, cfg, device="cpu")
    torch.save(params, tmp / "model_params.pt")
    return params, model_run(params, cfg)


@pytest.fixture(scope="module")
def serve_ref(jref, tmp):
    """The reference serve CLI's greedy tokens (float32 activations); its
    weights (through `lm_from_jax`) and prompts saved for the ranks; the
    port's one-process tokens from them."""
    from test_torch_mesh_cli import ref_serve_host_arrays, ref_weights
    with float32_serving(serve, jref.serve):
        gen, _ = ref_serve_host_arrays(jref, SERVE_ARGV)
        params, toks = ref_weights(jref, serve.parse_args(
            SERVE_ARGV + ["--device", "cpu"]))
        one, _ = serve.run_serve(serve.parse_args(SERVE_ARGV + [
            "--device", "cpu"]), params=params, tokens=toks)
    torch.save((params, toks), tmp / "serve.pt")
    return np.asarray(gen), one


@pytest.fixture(scope="module")
def train_ref(jref, tmp):
    from test_torch_train_families import reference_cli_run
    state_np, metrics = reference_cli_run(jref, TRAIN_ARGV)
    torch.save(state_np, tmp / "train.pt")
    return metrics


@pytest.fixture(scope="module")
def world4(mix_one, model_one, serve_ref, train_ref, tmp):
    return run_world(4, ["mix", "model", "init", "serve", "train"], tmp,
                     entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, tmp):
    return run_world(2, ["mix", "model", "init", "serve", "train"], tmp,
                     entry=_rank_entry)


def _np(t):
    return t.detach().float().numpy()


def ranks_of(shape, world2, world4):
    return {2: world2, 4: world4}[shape[0] * shape[1]]


def close_rel(got, want, rtol, what=""):
    """max |got - want| within rtol of max |want|."""
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got.float() - want.float()).abs().max())
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def test_mixer_matches_the_reference(mix_one):
    """The one-process mixer the ranks are held to is the reference's
    `ssm_mix` (S = 512, float32) within REF_MIX_ATOL."""
    _, one, want = mix_one
    np.testing.assert_allclose(_np(one[512]["out"]), _np(want),
                               atol=REF_MIX_ATOL, rtol=0)


@pytest.mark.parametrize("shape,s,path", [
    (shape, s, path) for shape, cases in MIX_CASES.items()
    for s, path in cases])
def test_sequence_parallel_mixer_equals_one_process(shape, s, path, world2,
                                                    world4, mix_one):
    """`ssm_mix(seq_cut=True)` on each rank's sequence block: the block of
    one process's output, the whole sequence's final state and conv tail
    on every rank, the input's gradient block and every param's gradient
    summed over the model group, within their bounds of one process's.
    S = 512 and 1024 at (1, 2), 1024 at (1, 4): whole 256-token chunks a
    rank; S = 16 at (1, 2), 512 at (1, 4): the gathered sequence."""
    _, one, _ = mix_one
    want = one[s]
    m = shape[1]
    for r in range(m):
        got = result(ranks_of(shape, world2, world4), "mix", r)[(shape, s)]
        blk = slice(r * s // m, (r + 1) * s // m)
        np.testing.assert_allclose(_np(got["out"]), _np(want["out"][:, blk]),
                                   atol=MIX_ATOL, rtol=0)
        for name in ("state", "conv"):
            np.testing.assert_allclose(_np(got["cache"][name]),
                                       _np(want["cache"][name]),
                                       atol=MIX_ATOL, rtol=0, err_msg=name)
        close_rel(got["dx"], want["dx"][:, blk], MIX_GRAD_RTOL[path], "dx")
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in got["grads"].items():
            close_rel(g, want["grads"][k], MIX_GRAD_RTOL[path], k)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("arch", [ARCH, "zamba2-1.2b", "llava-next-34b"])
def test_specs_follow_the_reference(arch, shape, jref):
    """At full size on abstract meshes: the param specs (mamba2's
    replicated), the train state's with ZeRO-1 and the decode caches'
    equal the reference's spec for spec; the ranks' cache layout is the
    reference's but for the SSM conv windows, cut over the data axes
    alone."""
    from jax.sharding import AbstractMesh

    from test_torch_sharding import port_specs, ref_specs
    names = ("data", "model")
    mj, mt = AbstractMesh(shape, names), core_mesh.abstract_mesh(shape,
                                                                 names)
    cj, ct = jref.configs.get_config(arch), configs.get_config(arch)
    opt = "adamw"
    sj = jref.steps.abstract_train_state(cj, jref.get_optimizer(opt))
    st = steps.abstract_train_state(ct, get_optimizer(opt))
    assert port_specs(sharding.param_pspecs(st["params"], mt, ct.family)) \
        == ref_specs(jref, jref.shd.param_pspecs(sj["params"], mj,
                                                 cj.family))
    assert port_specs(steps.train_state_pspecs(st, mt, family=ct.family)) \
        == ref_specs(jref, jref.steps.train_state_pspecs(
            sj, mj, family=cj.family))
    cache_j = jref.jax.eval_shape(lambda: jref.models.empty_caches(cj, 4,
                                                                   1024))
    cache_t = transformer.abstract_caches(ct, 4, 1024)
    want = ref_specs(jref, jref.shd.cache_pspecs(mj, cache_j))
    assert port_specs(sharding.cache_pspecs(mt, cache_t)) == want
    ranked = port_specs(sharding.rank_cache_pspecs(mt, cache_t))
    leaves = flat(cache_t)
    assert ranked.keys() == want.keys() == leaves.keys()
    for path, spec in ranked.items():
        t = leaves[path]
        if path.endswith("['conv']"):      # B over the data axes alone
            assert spec == tuple(sharding.sanitize_spec(PartitionSpec(
                *(None,) * (t.dim() - 3), ("data",)), tuple(t.shape), mt))
        else:
            assert spec == want[path], path


def test_a_ragged_sequence_still_raises():
    """A sequence that is not a multiple of the SSD chunk raises as in one
    process (the chunk grid is the whole sequence's)."""
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        ssm.ssd_chunk(300)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_model_over_ranks_equals_one_process(shape, world2, world4,
                                             model_one):
    """mamba2's float32 smoke model over each mesh: the prefill's last
    logits (the last sequence rank's), each rank's cache blocks (its rows;
    the states' heads, the conv windows whole), three decode steps over a
    36- and a 37-long cache, within MODEL_ATOL of one process's; the
    gradients summed as the step sums them within GRAD_RTOL of each
    leaf's largest value, and their global norm within NORM_RTOL."""
    params, one = model_one
    cfg = f32_cfg()
    mesh = mesh_here(shape)
    world = shape[0] * shape[1]
    tol = dict(atol=MODEL_ATOL, rtol=0)
    specs = sharding.rank_cache_pspecs(mesh, one["caches"])
    for r in range(world):
        got = result(ranks_of(shape, world2, world4), "model", r)[shape]
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]),
                                   **tol)

        def blocks(path, g, w, spec):
            want = w[local_block(tuple(w.shape), spec, mesh, r)]
            assert g.shape == want.shape, path
            np.testing.assert_allclose(_np(g), _np(want), **tol,
                                       err_msg=path)
        tree_map_with_path(blocks, got["caches"], one["caches"], specs)
        if shape[1] > 1:
            assert got["caches"]["state"].shape[2] == cfg.ssm_heads // shape[1]
        for ctx in CTXS:
            for g, w in zip(got[ctx]["logits"], one[ctx]["logits"],
                            strict=True):
                np.testing.assert_allclose(_np(g), _np(w), **tol)
            tree_map_with_path(blocks, got[ctx]["caches"],
                               one[ctx]["caches"],
                               sharding.rank_cache_pspecs(
                                   mesh, one[ctx]["caches"]))
        g, w = flat(got["grads"]), flat(one["grads"])
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape, k       # replicated params
            close_rel(g[k], w[k], GRAD_RTOL[shape], k)
        np.testing.assert_allclose(float(got["norm"]),
                                   float(global_norm(one["grads"])),
                                   rtol=NORM_RTOL)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_rank_init_is_the_whole_init(shape, world2, world4):
    """`init_params` inside a mesh of ranks: the ssm family's params are
    replicated (`sharding.param_pspecs`), so every rank holds the whole
    init, leaf for leaf."""
    cfg = configs.get_smoke_config(ARCH).replace(param_dtype="bfloat16")
    whole = init_params(0, cfg, device="cpu")
    mesh = mesh_here(shape)
    for r in range(shape[0] * shape[1]):
        assert_trees_equal(result(ranks_of(shape, world2, world4), "init",
                                  r)[shape], whole)
    assert all(tuple(s) == () for s in tree_leaves(sharding.param_pspecs(
        whole, mesh, cfg.family)))
    if shape[1] > 1:    # the other families' rules would cut in_proj
        assert any(tuple(s) for s in tree_leaves(sharding.param_pspecs(
            whole, mesh)))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_serve_cli_over_ranks_gives_the_reference_tokens(shape, world2,
                                                         world4, serve_ref):
    """`serve.run_serve` with the reference's weights and prompts: the
    reference CLI's greedy tokens on every rank; over the (2, 1) data
    mesh one process's tokens bit for bit."""
    want, one = serve_ref
    np.testing.assert_array_equal(one, want)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "serve", r)[shape]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        if shape == (2, 1):
            assert np.array_equal(got, one)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_train_cli_over_a_model_axis_equals_the_reference(shape, world2,
                                                          world4, train_ref):
    """The bfloat16 train CLI under a model axis from the reference
    trainer's state: each step's loss within REF_LOSS_RTOL of the
    reference's on every rank, rank 0 alone printing."""
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "train", r)[shape]
        assert len(got["losses"]) == len(train_ref) == 3
        assert len(got["printed"]) == (0 if r else 3)
        for g, w in zip(got["losses"], train_ref):
            np.testing.assert_allclose(g, w["loss"], rtol=REF_LOSS_RTOL)


def test_two_rank_checkpoint_restores_in_one_process(world2, tmp):
    """The (1, 2) run's checkpoint, restored in one process, equals each
    rank's final state: the replicated params whole, the moments whole
    (no data axis to cut them over)."""
    whole = restore(tmp / "ckpt", ARCH, "adamw")
    for r in range(2):
        assert_trees_equal(result(world2, "train", r)[(1, 2)]["state"],
                           whole)


def test_torchrun_serve_cli_over_a_model_axis(tmp_path):
    """The serve CLI as a user starts it: 2 gloo ranks with --model-axis 2
    print their first lines, rank 0 alone the stats, whose tokens are one
    process's."""
    argv = [*SERVE_ARGV, "--device", "cpu"]
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
    assert len(stats) == 1
    _, one = serve.run_serve(serve.parse_args(argv))
    assert stats[0]["sample_ids"] == one["sample_ids"]
