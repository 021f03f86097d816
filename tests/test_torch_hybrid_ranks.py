"""The hybrid and vlm families over a `model` axis of ranks: zamba2's
Mamba2 mixer on params cut by the reference's specs (`models.ssm`: the
column-parallel in_proj gathered, the conv and dt_bias blocks gathered
whole, the rank's rows of y through the row-parallel out_proj), its
shared attention block and llava's trunk on the dense family's Megatron
path, and both served over a data mesh, held against the port's
one-process runs and the reference.

Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
4 ranks runs the (2, 2) mesh, then a world of 2 ranks the (1, 2) and
(2, 1) meshes (zamba2's smoke config has 2 attention heads, which a
model axis of 4 does not split).  The parent computes the reference's and
one process's numbers and hands the ranks their inputs in files.

Bounds, each measured on this CPU first (float32 activations; zamba2's
scan rounds its operands to bfloat16 in the forward and, through the
casts' gradients, in the backward, so a float-order change that flips
one rounding moves a gradient by up to 2**-8 of its size):
  * zamba2's mixer alone (`ssm_mix` on a seeded [2, 32, 64] input, the
    reference's `ssm_init` weights; one process's output within
    REF_MIX_ATOL, 4e-4, of the reference's, measured 9.0e-5): the
    rank's rows of the output, the final state and the conv tail within
    MIX_ATOL (1e-5; measured 1.2e-6) of one process's at (1, 2) and
    (2, 2); the gradients of the output's weighted sum, the input's rows
    and each param's block (summed over the data ranks), within
    MIX_GRAD_RTOL (1e-5; measured 6.9e-7) of each leaf's largest
    |value|.
  * the model (zamba2 and llava, S = 32: `prefill`, three decode steps
    over a 36-long cache (cut over the sequence), a 37-long one (whole)
    and for zamba2 a 40-long one with its shared attention windowed to
    8 positions (`transformer._window_for`, its threshold lowered to
    40), the train loss's gradients summed over the data ranks) at
    (1, 2), (2, 1) and (2, 2), each figure against one process's
    (`MODEL_TOL`): the prefill's last logits and every decode step's
    (absolute), each cache block and each gradient block (relative to
    the leaf's largest |value|), the global gradient norm (relative).
    llava: 1e-5, 1e-5, 1e-5, 1e-4 (measured 5.5e-7, 8.2e-7, 1.4e-6, 0).
    zamba2: 1e-4, 5e-3, 5e-2, 1e-3 (measured 3.2e-5, 7.6e-4, 1.4e-2,
    1.1e-4): the Megatron shared block's float order flips bfloat16
    roundings in the scans after it, which its five layers carry on.
    With those roundings off in both runs (`ssm._bf` the identity, the
    "zamba2 unrounded" case) zamba2 is held to 1e-5, 1e-5, 1e-4, 1e-5
    (measured 4.5e-7, 3.5e-6, 2.6e-5 on dt_bias, 2.1e-7).
  * the rank-block init: the whole init cut by the specs, leaf for leaf.
  * the serve CLI (float32 activations, bfloat16 params, the reference's
    weights through `lm_from_jax`): the reference CLI's greedy tokens at
    (1, 2), (2, 1) and (2, 2); the (2, 1) run gives one process's tokens
    bit for bit.
  * the train CLI from the reference trainer's state (bfloat16): each
    step's loss within `test_torch_ranks.REF_LOSS_RTOL` (1e-3) of the
    reference's at (1, 2) and (2, 2) (llava with --donate at (1, 2)); the
    2-rank zamba2 checkpoint restored in one process equals each rank's
    blocks.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import PartitionSpec, local_block
from repro_torch.launch import serve, train
from repro_torch.models import init_params, ssm, transformer
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

from test_torch_moe_ranks import float32_serving, mesh_here, rank_blocks
from test_torch_ranks import (REF_LOSS_RTOL, assert_trees_equal, flat,
                              restore, result, run_world)
from test_torch_ssm_ranks import close_rel, host_mesh, train_from

import test_torch_ssm_ranks as ssm_ranks

HYBRID, VLM = "zamba2-1.2b", "llava-next-34b"
ARCHS = (HYBRID, VLM)
B, S = 2, 32
CTXS = {HYBRID: (36, 37, 40), VLM: (36, 37)}
WINDOW_CTX, WINDOW = 40, 8
REF_MIX_ATOL = 4e-4
MIX_ATOL = 1e-5
MIX_GRAD_RTOL = 1e-5
# by case: the bounds on logits (absolute), cache and gradient blocks
# (relative to the leaf's largest |value|) and the gradient norm
UNROUNDED = "zamba2 unrounded"
MODEL_TOL = {VLM: dict(logits=1e-5, cache=1e-5, grad=1e-5, norm=1e-4),
             HYBRID: dict(logits=1e-4, cache=5e-3, grad=5e-2, norm=1e-3),
             UNROUNDED: dict(logits=1e-5, cache=1e-5, grad=1e-4, norm=1e-5)}
SERVE_ARGV = ["--smoke-config", "--batch", "4", "--prompt-len", "32",
              "--gen", "5"]
TRAIN_ARGV = ["--smoke-config", "--steps", "3", "--batch", "4", "--seq",
              "32", "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_cfg(arch):
    cfg = configs.get_smoke_config(arch).replace(dtype="float32")
    return cfg.replace(long_context_window=WINDOW) if arch == HYBRID else cfg


@contextlib.contextmanager
def short_window_threshold():
    """The hybrid's shared attention windowed from a 40-long cache on
    (`transformer.LONG_CTX_THRESHOLD`, 131072 in the configs)."""
    inner = transformer.LONG_CTX_THRESHOLD
    transformer.LONG_CTX_THRESHOLD = WINDOW_CTX
    try:
        yield
    finally:
        transformer.LONG_CTX_THRESHOLD = inner


@contextlib.contextmanager
def unrounded(case):
    """For the "zamba2 unrounded" case the scan's bfloat16 roundings off
    (`ssm._bf` the identity)."""
    inner = ssm._bf
    if case == UNROUNDED:
        ssm._bf = lambda t: t
    try:
        yield
    finally:
        ssm._bf = inner


def model_run(params, cfg, mesh=None, case=None):
    with short_window_threshold(), unrounded(case):
        return ssm_ranks.model_run(params, cfg, mesh, CTXS[cfg.arch], s=S)


def arch_of(case):
    return HYBRID if case == UNROUNDED else case


def mix_inputs():
    cfg = f32_cfg(HYBRID)
    rng = np.random.default_rng(11)
    x, w = (torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                             .astype(np.float32)) for _ in range(2))
    return x, w


def rows(t, mesh):
    return t[local_block((t.shape[0],), PartitionSpec(("data",)), mesh)[0]]


def mix_run(p, mesh=None):
    """zamba2's `ssm_mix` (under `mesh`: the rank's blocks of the params
    and rows of the input): the output, the cache and the gradients of
    sum(out * w) for x and the params (over ranks summed over the data
    ranks)."""
    cfg = f32_cfg(HYBRID)
    x, w = mix_inputs()
    if mesh is not None:
        x, w = rows(x, mesh), rows(w, mesh)
        p = serve.place_params({"mixer": p}, mesh, cfg.family)["mixer"]
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    x = x.clone().requires_grad_(True)
    with (mesh if mesh is not None else contextlib.nullcontext()):
        out, cache = ssm.ssm_mix(live, cfg, x)
        (out * w).sum().backward()
        grads = [t.grad for t in tree_leaves(live)]
        if mesh is not None:
            grads = core_mesh.mesh_sum(grads, mesh)
    return {"out": out.detach(), "cache": cache, "dx": x.grad,
            "grads": dict(zip(flat(live), grads))}


# --- the rank side -----------------------------------------------------------

def scenario_mix(out):
    p = torch.load(out["dir"] + "/mix_params.pt")
    return {shape: mix_run(p, host_mesh(shape[1]))
            for shape in SHAPES[out["world"]] if shape[1] > 1}


def scenario_model(out):
    res = {}
    for case in MODEL_TOL:
        cfg = f32_cfg(arch_of(case))
        params = torch.load(out["dir"] + f"/model_{cfg.arch}.pt")
        for shape in SHAPES[out["world"]]:
            mesh = host_mesh(shape[1])
            placed = serve.place_params(params, mesh, cfg.family)
            got = model_run(placed, cfg, mesh, case)
            specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
            got["norm"] = steps.tp_global_norm(got["grads"],
                                               specs["params"], mesh)
            res[(case, shape)] = got
    return res


def scenario_init(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        with host_mesh(shape[1]):
            for arch in ARCHS:
                cfg = configs.get_smoke_config(arch).replace(
                    param_dtype="bfloat16")
                res[(arch, shape)] = init_params(0, cfg, device="cpu")
    return res


def scenario_serve(out):
    res = {}
    for arch in ARCHS:
        params, toks = torch.load(out["dir"] + f"/serve_{arch}.pt",
                                  weights_only=False)
        for shape in SHAPES[out["world"]]:
            args = serve.parse_args(["--arch", arch, *SERVE_ARGV,
                                     "--device", "cpu", "--model-axis",
                                     str(shape[1])])
            with float32_serving(serve):
                res[(arch, shape)], _ = serve.run_serve(
                    args, params=params, tokens=toks)
    return res


def scenario_train(out):
    res = {}
    for arch in ARCHS:
        state_np = torch.load(out["dir"] + f"/train_{arch}.pt",
                              weights_only=False)
        for shape in SHAPES[out["world"]]:
            if shape[1] == 1:
                continue
            extra = []
            if shape == (1, 2):
                extra = (["--ckpt-dir", out["dir"] + "/ckpt"]
                         if arch == HYBRID else ["--donate"])
            res[(arch, shape)] = train_from(state_np, [
                "--arch", arch, *TRAIN_ARGV, "--device", "cpu",
                "--model-axis", str(shape[1]), *extra])
    return res


def scenario_refusals(out):
    """What ranks refused until they ran it: the audio family served over
    the world's meshes and trained under a model axis, and the batcher,
    the microbenchmark and the retrying decode over ranks for the hybrid
    (the batcher refusing the hybrid there as in one process)."""
    said = {}
    whisper = ["--arch", "whisper-medium", *SERVE_ARGV, "--device", "cpu"]
    calls = {("audio train", 2): lambda: train.main(
        ["--arch", "whisper-medium", *TRAIN_ARGV, "--device", "cpu",
         "--model-axis", "2"])}
    for shape in SHAPES[out["world"]]:
        calls[("audio serve", shape[1])] = lambda k=shape[1]: serve.main(
            whisper + ["--model-axis", str(k)])
    for flag in (["--continuous", "2"], ["--microbench"], ["--resilient"]):
        calls[(flag[0], 2)] = lambda flag=flag: serve.main(
            ["--arch", HYBRID, *SERVE_ARGV, "--device", "cpu",
             "--model-axis", "2", *flag])
    for key, call in calls.items():
        try:
            with float32_serving(serve):
                said[key] = ("ran", call())
        except (ValueError, NotImplementedError) as err:
            said[key] = ("raised", str(err))
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
    import types

    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.launch import serve as jserve
    from repro.models import ssm as jssm
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, serve=jserve, ssm=jssm,
                                 steps=jsteps)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("hybrid_ranks")


@pytest.fixture(scope="module")
def mix_one(jref, tmp):
    """One process's zamba2 mixer from the reference's `ssm_init` weights
    (saved for the ranks), and the reference's output."""
    jax = jref.jax
    cj = jref.configs.get_smoke_config(HYBRID).replace(dtype="float32")
    pj = jref.ssm.ssm_init(jax.random.PRNGKey(5), cj)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    torch.save(p, tmp / "mix_params.pt")
    x, _ = mix_inputs()
    y, _ = jref.ssm.ssm_mix(pj, cj, jref.jnp.asarray(x.numpy()))
    return p, mix_run(p), torch.from_numpy(np.array(y))


@pytest.fixture(scope="module")
def model_one(tmp):
    one = {}
    for case in MODEL_TOL:
        cfg = f32_cfg(arch_of(case))
        params = init_params(0, cfg, device="cpu")
        torch.save(params, tmp / f"model_{cfg.arch}.pt")
        one[case] = (params, model_run(params, cfg, case=case))
    return one


@pytest.fixture(scope="module")
def serve_ref(jref, tmp):
    """The reference serve CLI's greedy tokens (float32 activations) and
    the port's one-process tokens for both archs; the weights (through
    `lm_from_jax`) and prompts saved for the ranks."""
    from test_torch_mesh_cli import ref_serve_host_arrays, ref_weights
    want = {}
    with float32_serving(serve, jref.serve):
        for arch in ARCHS:
            argv = ["--arch", arch, *SERVE_ARGV]
            gen, _ = ref_serve_host_arrays(jref, argv)
            params, toks = ref_weights(jref, serve.parse_args(
                argv + ["--device", "cpu"]))
            one, _ = serve.run_serve(serve.parse_args(
                argv + ["--device", "cpu"]), params=params, tokens=toks)
            torch.save((params, toks), tmp / f"serve_{arch}.pt")
            want[arch] = (np.asarray(gen), one)
    return want


@pytest.fixture(scope="module")
def train_ref(jref, tmp):
    from test_torch_train_families import reference_cli_run
    want = {}
    for arch in ARCHS:
        state_np, metrics = reference_cli_run(jref, ["--arch", arch,
                                                     *TRAIN_ARGV])
        torch.save(state_np, tmp / f"train_{arch}.pt")
        want[arch] = metrics
    return want


NAMES = ["mix", "model", "init", "serve", "train"]


@pytest.fixture(scope="module")
def world4(mix_one, model_one, serve_ref, train_ref, tmp):
    return run_world(4, NAMES, tmp, entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, tmp):
    return run_world(2, NAMES + ["refusals"], tmp, entry=_rank_entry)


def _np(t):
    return t.detach().float().numpy()


def ranks_of(shape, world2, world4):
    return {2: world2, 4: world4}[shape[0] * shape[1]]


def test_mixer_matches_the_reference(mix_one):
    """The one-process zamba2 mixer the ranks are held to is the
    reference's `ssm_mix` within REF_MIX_ATOL."""
    _, one, want = mix_one
    np.testing.assert_allclose(_np(one["out"]), _np(want),
                               atol=REF_MIX_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_mixer_on_cut_params_equals_one_process(shape, world2, world4,
                                                mix_one):
    """zamba2's mixer on each rank's blocks of the params (in_proj's
    columns, the conv's channels, dt_bias's heads, out_proj's rows): the
    rank's rows of one process's output, state and conv tail, and the
    gradient of each param's block (summed over the data ranks) and of
    the input's rows, within their bounds."""
    p, one, _ = mix_one
    mesh = mesh_here(shape)
    cfg = f32_cfg(HYBRID)
    whole = flat(p)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "mix", r)[shape]
        sl = local_block((B,), PartitionSpec(("data",)), mesh, r)[0]
        np.testing.assert_allclose(_np(got["out"]), _np(one["out"][sl]),
                                   atol=MIX_ATOL, rtol=0)
        for name in ("state", "conv"):
            np.testing.assert_allclose(_np(got["cache"][name]),
                                       _np(one["cache"][name][sl]),
                                       atol=MIX_ATOL, rtol=0, err_msg=name)
        close_rel(got["dx"], one["dx"][sl], MIX_GRAD_RTOL, "dx")
        assert got["grads"].keys() == whole.keys()
        for k, g in got["grads"].items():
            blk = local_block(tuple(whole[k].shape), sharding.param_spec(
                k, whole[k], mesh), mesh, r)
            assert g.shape == whole[k][blk].shape, k
            close_rel(g, one["grads"][k][blk], MIX_GRAD_RTOL, k)
    # the reference's cuts: in_proj by column over the fused width, the
    # conv and dt_bias over channels and heads, out_proj by row
    got = result(ranks_of(shape, world2, world4), "mix")[shape]["grads"]
    width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    assert got["['in_proj']['kernel']"].shape[-1] == width // 2
    assert got["['conv_w']"].shape[-1] \
        == (cfg.d_inner + 2 * cfg.ssm_state) // 2
    assert got["['dt_bias']"].shape[-1] == cfg.ssm_heads // 2
    assert got["['out_proj']['kernel']"].shape[0] \
        == cfg.d_inner // 2
    assert got["['a_log']"].shape[-1] == cfg.ssm_heads


@pytest.mark.parametrize("case", list(MODEL_TOL))
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_model_over_ranks_equals_one_process(shape, case, world2, world4,
                                             model_one):
    """zamba2's and llava's float32 smoke models over each mesh: the
    prefill's last logits, each rank's cache blocks, three decode steps
    over a cut (36), a whole (37) and for zamba2 a windowed (40) cache,
    each gradient block and the global norm, within the case's
    `MODEL_TOL` of one process's."""
    params, one = model_one[case]
    tol = MODEL_TOL[case]
    mesh = mesh_here(shape)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "model",
                     r)[(case, shape)]
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]),
                                   atol=tol["logits"], rtol=0)

        def blocks(path, g, w, spec):
            want = w[local_block(tuple(w.shape), spec, mesh, r)]
            assert g.shape == want.shape, path
            close_rel(g, want, tol["cache"], path)
        tree_map_with_path(blocks, got["caches"], one["caches"],
                           sharding.rank_cache_pspecs(mesh, one["caches"]))
        for ctx in CTXS[arch_of(case)]:
            for g, w in zip(got[ctx]["logits"], one[ctx]["logits"],
                            strict=True):
                np.testing.assert_allclose(_np(g), _np(w),
                                           atol=tol["logits"], rtol=0)
            tree_map_with_path(blocks, got[ctx]["caches"],
                               one[ctx]["caches"],
                               sharding.rank_cache_pspecs(
                                   mesh, one[ctx]["caches"]))
        g, w = flat(got["grads"]), flat(rank_blocks(one["grads"], mesh, r))
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape, k
            close_rel(g[k], w[k], tol["grad"], k)
        np.testing.assert_allclose(float(got["norm"]),
                                   float(global_norm(one["grads"])),
                                   rtol=tol["norm"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_rank_block_init_equals_init_then_cut(shape, world2, world4):
    """`init_params` inside a mesh of ranks draws only the rank's blocks,
    and they equal the whole init cut by the specs, leaf for leaf (the
    hybrid's mixer leaves and shared block, llava's trunk)."""
    mesh = mesh_here(shape)
    for arch in ARCHS:
        cfg = configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
        whole = init_params(0, cfg, device="cpu")
        for r in range(shape[0] * shape[1]):
            got = result(ranks_of(shape, world2, world4), "init",
                         r)[(arch, shape)]
            assert_trees_equal(got, rank_blocks(whole, mesh, r))
        assert any(a.shape != b.shape for a, b in zip(
            tree_leaves(got), tree_leaves(whole)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2)])
def test_serve_cli_over_ranks_gives_the_reference_tokens(shape, arch, world2,
                                                         world4, serve_ref):
    """`serve.run_serve` with the reference's weights and prompts: the
    reference CLI's greedy tokens on every rank; over the (2, 1) data
    mesh one process's tokens bit for bit."""
    want, one = serve_ref[arch]
    np.testing.assert_array_equal(one, want)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "serve",
                     r)[(arch, shape)]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        if shape == (2, 1):
            assert np.array_equal(got, one)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_train_cli_over_a_model_axis_equals_the_reference(shape, arch,
                                                          world2, world4,
                                                          train_ref):
    """The bfloat16 train CLI under a model axis from the reference
    trainer's state: each step's loss within REF_LOSS_RTOL of the
    reference's on every rank, rank 0 alone printing (llava at (1, 2)
    with --donate)."""
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "train",
                     r)[(arch, shape)]
        assert len(got["losses"]) == len(train_ref[arch]) == 3
        assert len(got["printed"]) == (0 if r else 3)
        for g, w in zip(got["losses"], train_ref[arch]):
            np.testing.assert_allclose(g, w["loss"], rtol=REF_LOSS_RTOL)


def test_two_rank_checkpoint_restores_in_one_process(world2, tmp):
    """zamba2's (1, 2) checkpoint holds the whole leaves: restored in one
    process and cut by the specs, it equals each rank's final state."""
    cfg = configs.get_smoke_config(HYBRID)
    mesh = mesh_here((1, 2))
    specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
    whole = restore(tmp / "ckpt", HYBRID, "adamw")
    for r in range(2):
        blocks = tree_map(lambda t, s: t[local_block(tuple(t.shape), s, mesh,
                                                     r)], whole, specs)
        assert_trees_equal(result(world2, "train", r)[(HYBRID, (1, 2))]
                           ["state"], blocks)


def test_ranks_still_refuse_the_audio_family_and_the_batcher(world2):
    """whisper-medium under a model axis and served over 2 ranks ((1, 2)
    and the (2, 1) data mesh) runs, with one process's tokens; over
    ranks the hybrid runs --microbench and --resilient (one process's
    tokens), and the batcher refuses it as in one process (float32
    activations throughout)."""
    whisper = ["--arch", "whisper-medium", *SERVE_ARGV, "--device", "cpu"]
    hybrid = ["--arch", HYBRID, *SERVE_ARGV, "--device", "cpu"]
    with float32_serving(serve):
        one_whisper = serve.main(whisper)
        one_hybrid = serve.main(hybrid)
        with pytest.raises(NotImplementedError) as refused:
            serve.main(hybrid + ["--continuous", "2"])
    for r in range(2):
        said = result(world2, "refusals", r)
        kind, loss = said[("audio train", 2)]
        assert kind == "ran" and np.isfinite(loss)
        for k in (2, 1):
            kind, gen = said[("audio serve", k)]
            assert kind == "ran"
            np.testing.assert_array_equal(gen, one_whisper)
        assert said[("--continuous", 2)] == ("raised", str(refused.value))
        assert said[("--microbench", 2)] == ("ran", None)
        kind, gen = said[("--resilient", 2)]
        assert kind == "ran"
        np.testing.assert_array_equal(gen, one_hybrid)
