"""The MoE family over a `model` axis of ranks: expert parallelism over the
model group (`moe._rank_ep`), MLA on the rank's heads with a
sequence-cut latent cache, each rank drawing only its blocks of the
params (`models.init_params` inside a mesh of ranks), and deepseek-v3's
and kimi-k2's smoke configs served and trained through the CLIs over
ranks, held against the reference and the port's one-process runs.

Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
4 ranks runs the (2, 2) and (1, 4) meshes, then a world of 2 ranks the
(1, 2) and (2, 1) meshes.  The parent computes the reference's and one
process's numbers and hands the ranks their inputs in files.

Bounds, each measured on this CPU first:
  * rank EP (kimi-k2's smoke config with the capacity raised to the
    expert count, as `tests/test_torch_ep.py`, float32, B=4, S=16, the
    reference's `moe_init` weights) against the reference's global
    `moe_ffn`: the reference's own 2e-5 on the outputs (measured: at
    most 1.0e-6 at (1, 2), (2, 2) and (1, 4)) and 1e-3 on the gradients
    (the input's 1.7e-6, the params' 1.9e-5); the decode dispatch
    (S == 1) the same.
  * at (1, 2) without the shared experts (whose row-parallel `down`
    sums its partials in another order): the port's one-process EP over
    a 1x2 mesh bit for bit; two float32 partials add the same in either
    order.
  * MLA (deepseek-v3's float32 smoke config, params from `init_params`)
    at (1, 2) against one process: prefill logits and each rank's
    sequence blocks of the latent caches within PREFILL_ATOL (the
    test_torch_lm bound, 2e-5; measured 2.6e-7), three decode steps
    over a cut (40) and a whole (37) latent cache within it too
    (3.9e-7), the gradients of the train loss within GRAD_ATOL plus
    GRAD_RTOL of each leaf's (measured: 1.5e-7 absolute, on gradients
    up to 0.15).
  * the rank-block init: equal, leaf for leaf, to the whole init cut by
    the specs.
  * the serve CLI (the smoke configs with float32 activations and
    bfloat16 params, the reference's weights carried over by
    `lm_from_jax`): the reference CLI's greedy tokens at (1, 2) and
    (2, 1).  (In bfloat16 activations the reference's and the port's
    one-process kimi-k2 tokens part already: a bfloat16 near tie.)
  * the train CLI at (1, 2) from the reference trainer's state (deepseek
    with AdamW on cut moments, kimi with adafactor on each rank's
    blocks): each step's loss within `test_torch_ranks.REF_LOSS_RTOL`
    (1e-3) of the reference's; its 2-rank checkpoint restored in one
    process equals each rank's blocks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import local_block, make_named_mesh
from repro_torch.launch import serve, train
from repro_torch.models import init_params, moe, prefill, transformer
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

from test_torch_ranks import (REF_LOSS_RTOL, assert_trees_equal, flat,
                              main_lines, restore, result, run_world,
                              step_losses)

B, S = 4, 16
EP_TOL = dict(rtol=2e-5, atol=2e-5)
EP_GRAD_ATOL = 1e-3
PREFILL_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
MOE_ARCHS = ("deepseek-v3-671b", "kimi-k2-1t-a32b")
SERVE_ARGV = ["--smoke-config", "--batch", "2", "--prompt-len", "16",
              "--gen", "5"]
TRAIN_OPT = {"deepseek-v3-671b": "adamw", "kimi-k2-1t-a32b": "adafactor"}
TRAIN_ARGV = ["--smoke-config", "--steps", "3", "--batch", "2", "--seq",
              "32", "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
# (data, model) meshes each world runs
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ep_cfg():
    ct = configs.get_smoke_config("kimi-k2-1t-a32b")
    return ct.replace(capacity_factor=float(ct.n_experts))


def mla_cfg():
    return configs.get_smoke_config("deepseek-v3-671b").replace(
        dtype="float32")


def host_mesh(model_axis):
    return train.cli_mesh("host", torch.device("cpu"), model_axis=model_axis)


def mesh_here(shape):
    """The (D, M) mesh of ranks built here without a group."""
    mesh = make_named_mesh(shape, ("data", "model"),
                           [torch.device("cpu")] * int(np.prod(shape)))
    return dataclasses.replace(mesh, ranks=np.arange(
        int(np.prod(shape))).reshape(shape))


def rank_blocks(tree, mesh, rank=None):
    """Each leaf of a whole param tree cut to `rank`'s block by the
    reference's specs (`runtime.sharding.param_spec`)."""
    return tree_map_with_path(lambda p, t: t[local_block(
        tuple(t.shape), sharding.param_spec(p, t, mesh), mesh, rank)],
        tree)


def mla_tokens():
    return torch.from_numpy(np.random.default_rng(7).integers(
        0, 512, (B, 32)))


def mla_batch():
    toks = mla_tokens()
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def mla_run(params, cfg, mesh=None):
    """Prefill, then three decode steps over a cut (40) and a whole (37)
    float32 cache, and the train loss's gradients: under `mesh` (a mesh
    of ranks: the rank's blocks) or in one process."""
    toks = mla_tokens()
    res = {}
    ctx_mgr = mesh if mesh is not None else torch.no_grad()
    with ctx_mgr:
        with torch.no_grad():
            logits, pre = prefill(params, cfg, {"tokens": toks})
        res["logits"], res["caches"] = logits, pre
        for ctx in (40, 37):
            empty = transformer.empty_caches(cfg, B, ctx,
                                             dtype=torch.float32,
                                             device="cpu")
            caches = (serve.splice_caches(empty, pre) if mesh is None else
                      serve.splice_rank_caches(empty, pre, 32, ctx, mesh))
            steps_out = []
            with torch.no_grad():
                for i in range(3):
                    pos = torch.full((B,), 32 + i, dtype=torch.long)
                    lg, caches = transformer.decode_step(
                        params, cfg, toks[:, i:i + 1], caches, pos, ctx)
                    steps_out.append(lg)
            res[ctx] = {"logits": steps_out, "caches": caches}
    if mesh is None:
        _, _, grads = steps._loss_and_grads(cfg, params, mla_batch())
    else:
        with mesh:
            _, _, grads = steps._loss_and_grads(cfg, params, mla_batch())
            grads = steps.sum_rank_grads(cfg, grads, mla_batch(), mesh)
    res["grads"] = grads
    return res


# --- the rank side -----------------------------------------------------------

def _ep_live(pt, mesh, shared=True):
    p = serve.place_params({"layers": {"moe": pt}}, mesh)["layers"]["moe"]
    if not shared:
        p = {k: v for k, v in p.items() if k != "shared"}
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), p)


def scenario_ep(out):
    """Rank EP at each mesh of the world: the rank's rows of the output,
    the gradients of the global sum (the params' summed over the data
    ranks), prefill (S = 16) and decode (S = 1); at (1, 2) also the
    routed experts alone."""
    pt, xt = torch.load(out["dir"] + "/ep_inputs.pt")
    ct = ep_cfg()
    res = {}
    for shape in SHAPES[out["world"]]:
        if shape[1] == 1:
            continue
        mesh = host_mesh(shape[1])
        for s in (S, 1):
            live = _ep_live(pt, mesh)
            x = transformer._rows(xt[:, :s], mesh).clone().requires_grad_(
                True)
            with mesh:
                mode = moe.dispatch_mode(ct, s, x.shape[0])
                y, _ = moe.moe_ffn(live, ct, x)
            y.sum().backward()
            leaves = flat({"layers": {"moe": live}})
            grads = dict(zip(leaves, core_mesh.mesh_sum(
                [t.grad for t in leaves.values()], mesh)))
            res[(shape, s)] = {"mode": mode, "y": y.detach(),
                               "dx": x.grad, "grads": grads}
        if shape == (1, 2):
            with mesh:
                y, _ = moe.moe_ffn(_ep_live(pt, mesh, shared=False), ct, xt)
            res["routed"] = y.detach()
    return res


def scenario_mla(out):
    cfg = mla_cfg()
    params = torch.load(out["dir"] + "/mla_params.pt")
    mesh = host_mesh(2)
    res = mla_run(serve.place_params(params, mesh), cfg, mesh)
    specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
    res["norm"] = steps.tp_global_norm(res["grads"], specs["params"], mesh)
    return res


def scenario_init(out):
    """`init_params` inside each mesh of the world with a model axis:
    the rank's blocks (bfloat16 params, as the serve CLI draws them)."""
    res = {}
    for shape in SHAPES[out["world"]]:
        if shape[1] == 1:
            continue
        with host_mesh(shape[1]):
            for arch in MOE_ARCHS:
                cfg = configs.get_smoke_config(arch).replace(
                    param_dtype="bfloat16")
                res[(shape, arch)] = init_params(0, cfg, device="cpu")
    return res


@contextlib.contextmanager
def float32_serving(*modules):
    """The serve CLIs' `build_cfg` (the port's, and the reference's where
    given) with float32 activations; the params stay bfloat16."""
    inner = [m.build_cfg for m in modules]
    for m, fn in zip(modules, inner):
        m.build_cfg = lambda args, fn=fn: fn(args).replace(dtype="float32")
    try:
        yield
    finally:
        for m, fn in zip(modules, inner):
            m.build_cfg = fn


def scenario_serve(out):
    """The serve CLI (float32 activations) at (1, 2) and (2, 1) from the
    reference's weights and prompts, both archs."""
    res = {}
    for arch in MOE_ARCHS:
        argv = ["--arch", arch, *SERVE_ARGV, "--device", "cpu"]
        params, toks = torch.load(out["dir"] + f"/serve_{arch}.pt",
                                  weights_only=False)
        for k in (2, 1):
            args = serve.parse_args(argv + ["--model-axis", str(k)])
            with float32_serving(serve):
                gen, _ = serve.run_serve(args, params=params, tokens=toks)
            res[(arch, k)] = gen
    return res


def scenario_train(out):
    """The train CLI at (1, 2) from the reference trainer's state, both
    archs, with a checkpoint at the end: each step's loss (the global
    one, on every rank), the lines rank 0 printed and the rank's final
    state."""
    res = {}
    for arch, donate in [(a, []) for a in MOE_ARCHS] \
            + [("deepseek-v3-671b", ["--donate"])]:
        state_np = torch.load(out["dir"] + f"/train_{arch}.pt",
                              weights_only=False)
        inner, losses, last = train.build, [], []

        def from_reference(args, mesh=None, state_np=state_np):
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
            _, lines = main_lines(
                ["--arch", arch, *TRAIN_ARGV, "--optimizer",
                 TRAIN_OPT[arch], "--device", "cpu", "--model-axis", "2",
                 "--ckpt-dir", out["dir"] + f"/ckpt_{arch}{''.join(donate)}",
                 *donate])
        finally:
            train.build = inner
        res[arch + "".join(donate)] = {
            "losses": losses, "printed": step_losses(lines),
            "state": last[0]}
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

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.launch import serve as jserve
    from repro.models import moe as jmoe
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, moe=jmoe, serve=jserve,
                                 steps=jsteps)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("moe_ranks")


@pytest.fixture(scope="module")
def ep_ref(jref, tmp):
    """The reference's global dispatch (outputs and gradients of the sum)
    at S = 16 and S = 1 on `tests/test_torch_ep.py`'s inputs; the port's
    params and x saved for the ranks."""
    jax, jnp = jref.jax, jref.jnp
    cj = jref.configs.get_smoke_config("kimi-k2-1t-a32b")
    cj = cj.replace(capacity_factor=float(cj.n_experts))
    key = jax.random.PRNGKey(0)
    pj = jref.moe.moe_init(key, cj)
    xj = jax.random.normal(jax.random.fold_in(key, 1), (B, S, cj.d_model),
                           jnp.float32)
    pt = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    xt = torch.from_numpy(np.array(xj))
    torch.save((pt, xt), tmp / "ep_inputs.pt")
    glob = cj.replace(moe_dispatch="global")
    want = {}
    for s in (S, 1):
        def loss(pp, xx):
            return jref.moe.moe_ffn(pp, glob, xx)[0].sum()
        y, _ = jref.moe.moe_ffn(pj, glob, xj[:, :s])
        gp, gx = jax.grad(loss, argnums=(0, 1))(pj, xj[:, :s])
        want[s] = {"y": torch.from_numpy(np.array(y)),
                   "dx": torch.from_numpy(np.array(gx)),
                   "grads": flat(jax.tree.map(
                       lambda a: torch.from_numpy(np.array(a)), gp))}
    routed = {k: v for k, v in pt.items() if k != "shared"}
    with make_named_mesh((1, 2), ("data", "model"),
                         [torch.device("cpu")] * 2):
        one_ep, _ = moe.moe_ffn(routed, ep_cfg(), xt)
    return pt, want, one_ep


@pytest.fixture(scope="module")
def mla_one(tmp):
    cfg = mla_cfg()
    params = init_params(0, cfg, device="cpu")
    torch.save(params, tmp / "mla_params.pt")
    return params, mla_run(params, cfg)


@pytest.fixture(scope="module")
def serve_ref(jref, tmp):
    """The reference serve CLI's greedy tokens for both archs, float32
    activations (the bfloat16 smoke configs' router logits tie or flip
    a choice here and there, in one process too); its weights (through
    `lm_from_jax`) and prompts saved for the ranks."""
    from test_torch_mesh_cli import ref_serve_host_arrays, ref_weights
    want = {}
    with float32_serving(serve, jref.serve):
        for arch in MOE_ARCHS:
            argv = ["--arch", arch, *SERVE_ARGV]
            gen, _ = ref_serve_host_arrays(jref, argv)
            torch.save(ref_weights(jref, serve.parse_args(
                argv + ["--device", "cpu"])), tmp / f"serve_{arch}.pt")
            want[arch] = np.asarray(gen)
    return want


@pytest.fixture(scope="module")
def train_ref(jref, tmp):
    """The reference trainer's loop for each arch: its initial state
    (saved for the ranks) and each step's metrics."""
    from test_torch_train_families import reference_cli_run
    want = {}
    for arch in MOE_ARCHS:
        state_np, metrics = reference_cli_run(
            jref, ["--arch", arch, *TRAIN_ARGV, "--optimizer",
                   TRAIN_OPT[arch]])
        torch.save(state_np, tmp / f"train_{arch}.pt")
        want[arch] = metrics
    return want


@pytest.fixture(scope="module")
def world4(ep_ref, tmp):
    return run_world(4, ["ep", "init"], tmp, entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, ep_ref, mla_one, serve_ref, train_ref, tmp):
    return run_world(2, ["ep", "mla", "init", "serve", "train"], tmp,
                     entry=_rank_entry)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("s", [S, 1])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_rank_ep_equals_the_reference_global(shape, s, world2, world4,
                                             ep_ref):
    """Each rank's rows of the output within 2e-5 of the reference's
    global dispatch, the input's gradient rows and every param's
    gradient block (summed over the data ranks) within 1e-3; S = 16 takes
    "ep" (a group a row), S = 1 the decode's global group."""
    pt, want, _ = ep_ref
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    mesh = mesh_here(shape)
    ref = want[s]
    for r in range(world):
        got = result(ranks, "ep", r)[(shape, s)]
        assert got["mode"] == ("ep" if s > 1 else "global")
        rows = local_block((B,), core_mesh.PartitionSpec(("data",)), mesh,
                           r)[0]
        np.testing.assert_allclose(_np(got["y"]), _np(ref["y"][rows]),
                                   **EP_TOL)
        np.testing.assert_allclose(_np(got["dx"]), _np(ref["dx"][rows]),
                                   atol=EP_GRAD_ATOL, rtol=0)
        whole = flat({"layers": {"moe": pt}})
        for path, g in got["grads"].items():
            key = path.replace("['layers']['moe']", "")
            leaf = whole[path]
            sl = local_block(tuple(leaf.shape), sharding.param_spec(
                path, leaf, mesh), mesh, r)
            assert g.shape == leaf[sl].shape, path
            np.testing.assert_allclose(_np(g), _np(ref["grads"][key][sl]),
                                       atol=EP_GRAD_ATOL, rtol=0,
                                       err_msg=path)
        assert set(got["grads"]) == set(whole)


def test_rank_ep_at_one_by_two_is_one_process_ep_bit_for_bit(world2,
                                                             ep_ref):
    """The routed experts at (1, 2) over ranks: the one-process EP over a
    1x2 mesh's output, bit for bit, on both ranks."""
    _, _, one_ep = ep_ref
    for r in range(2):
        assert torch.equal(result(world2, "ep", r)["routed"], one_ep)


def test_expert_banks_are_cut_over_the_model_axis(world2, world4):
    """Each rank holds E / |model| experts of every bank, and the router
    whole (`scenario_ep`'s gradients have the blocks' shapes)."""
    ct = ep_cfg()
    for ranks, shape in ((world2, (1, 2)), (world4, (2, 2)),
                         (world4, (1, 4))):
        got = result(ranks, "ep")[(shape, S)]["grads"]
        for name in ("gate", "up", "down"):
            assert got[f"['layers']['moe'][{name!r}]"].shape[0] \
                == ct.n_experts // shape[1]
        assert tuple(got["['layers']['moe']['router']['kernel']"].shape) \
            == (ct.d_model, ct.n_experts)


def test_mla_on_the_rank_heads_equals_one_process(world2, mla_one):
    """deepseek-v3's float32 smoke config at (1, 2): the prefill's whole
    logits and each rank's sequence blocks of the latent caches, three
    decode steps over a cut (40) and a whole (37) latent cache, and the
    train loss's gradient blocks, all within their bounds of one
    process's; the global gradient norm (`steps.tp_global_norm`, the
    experts' blocks summed over the group) within 1e-5 of one
    process's."""
    params, one = mla_one
    cfg = mla_cfg()
    mesh = mesh_here((1, 2))
    specs = sharding.rank_cache_pspecs(mesh, one["caches"])
    tol = dict(atol=PREFILL_ATOL, rtol=0)
    for r in range(2):
        got = result(world2, "mla", r)
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]),
                                   **tol)
        for name, t in one["caches"].items():
            assert tuple(specs[name])[2] == "model"
            sl = local_block(tuple(t.shape), specs[name], mesh, r)
            assert got["caches"][name].shape[2] == t.shape[2] // 2
            np.testing.assert_allclose(_np(got["caches"][name]),
                                       _np(t[sl]), **tol, err_msg=name)
        for ctx in (40, 37):
            for g, w in zip(got[ctx]["logits"], one[ctx]["logits"],
                            strict=True):
                np.testing.assert_allclose(_np(g), _np(w), **tol)
            for name, t in one[ctx]["caches"].items():
                want = t if ctx % 2 else t[local_block(
                    tuple(t.shape), specs[name], mesh, r)]
                np.testing.assert_allclose(_np(got[ctx]["caches"][name]),
                                           _np(want), **tol)
        blocks = rank_blocks(one["grads"], mesh, r)
        g, w = flat(got["grads"]), flat(blocks)
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape, k
            np.testing.assert_allclose(_np(g[k]), _np(w[k]), atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=k)
    # the global norm counts each expert block and each cut leaf once
    want = float(global_norm(one["grads"]))
    for r in range(2):
        np.testing.assert_allclose(float(result(world2, "mla", r)["norm"]),
                                   want, rtol=1e-5)
    # the MLA's up-projections are cut over heads, its down-projections
    # whole on every rank
    attn = flat(result(world2, "mla")["grads"]["layers"]["attn"])
    heads = cfg.n_heads // 2
    assert attn["['wq_b']['kernel']"].shape[-1] \
        == heads * (cfg.qk_nope_dim + cfg.qk_rope_dim)
    assert attn["['wo']['kernel']"].shape[-2] == heads * cfg.v_head_dim
    assert attn["['wq_a']['kernel']"].shape[-1] == cfg.q_lora_rank


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_rank_block_init_equals_init_then_cut(shape, world2, world4):
    """`init_params` inside a mesh of ranks draws only the rank's blocks,
    and they equal the whole init cut by the specs, leaf for leaf (the
    expert banks' blocks included)."""
    world = shape[0] * shape[1]
    ranks = {2: world2, 4: world4}[world]
    mesh = mesh_here(shape)
    for arch in MOE_ARCHS:
        cfg = configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
        whole = init_params(0, cfg, device="cpu")
        for r in range(world):
            got = result(ranks, "init", r)[(shape, arch)]
            assert_trees_equal(got, rank_blocks(whole, mesh, r))
        banks = got["layers"]["moe"]["gate"]
        assert banks.shape[1] == cfg.n_experts // shape[1]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_over_ranks_gives_the_reference_tokens(arch, world2,
                                                         serve_ref):
    """`serve.run_serve` with the reference's weights (`lm_from_jax`) and
    prompts: the reference CLI's greedy tokens at (1, 2) (experts and
    heads over the model group) and at (2, 1) (a row a rank), on both
    ranks."""
    for r in range(2):
        got = result(world2, "serve", r)
        for k in (2, 1):
            np.testing.assert_array_equal(got[(arch, k)], serve_ref[arch],
                                          err_msg=f"rank {r} model {k}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_cli_over_a_model_axis_equals_the_reference(arch, world2,
                                                          train_ref, tmp):
    """The bfloat16 train CLI at (1, 2) from the reference trainer's
    state (deepseek-v3 AdamW on cut moments, kimi-k2 adafactor on each
    rank's blocks): each step's loss within REF_LOSS_RTOL of the
    reference's, on both ranks; the 2-rank checkpoint restored in one
    process equals each rank's own blocks."""
    want = train_ref[arch]
    mesh = mesh_here((1, 2))
    cfg = configs.get_smoke_config(arch)
    opt = get_optimizer(TRAIN_OPT[arch])
    specs = steps.state_pspecs(cfg, opt, mesh)[0]
    whole = restore(tmp / f"ckpt_{arch}", arch, TRAIN_OPT[arch])
    for r in range(2):
        got = result(world2, "train", r)[arch]
        assert len(got["losses"]) == len(want) == 3
        assert len(got["printed"]) == (0 if r else 3)
        for g, w in zip(got["losses"], want):
            np.testing.assert_allclose(g, w["loss"], rtol=REF_LOSS_RTOL)
        blocks = tree_map(lambda t, s: t[local_block(tuple(t.shape), s,
                                                     mesh, r)],
                          whole, specs)
        assert_trees_equal(got["state"], blocks)
    halves = [(g, w) for g, w in zip(tree_leaves(got["state"]["params"]),
                                     tree_leaves(whole["params"]))
              if g.shape != w.shape]
    assert halves and all(2 * g.numel() == w.numel() for g, w in halves)


def test_donated_state_trains_to_the_same_bits(world2):
    """`train.main --donate` (the reference trainer's donated state:
    AdamW's moments and params updated in place) at (1, 2): every loss
    and the final state of each rank bit for bit the undonated run's."""
    for r in range(2):
        got = result(world2, "train", r)
        plain, donated = got["deepseek-v3-671b"], \
            got["deepseek-v3-671b--donate"]
        assert donated["losses"] == plain["losses"]
        assert_trees_equal(donated["state"], plain["state"])


def test_donated_adamw_update_is_the_functional_update_in_place():
    """AdamW's `update(..., donate=True)`: the functional update's new
    params and moments, bit for bit, written into the tensors it was
    given."""
    opt = get_optimizer("adamw")
    rng = np.random.default_rng(3)
    params = {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(
        np.float32)).to(torch.bfloat16), "b": torch.zeros(48)}
    grads = tree_map(lambda t: torch.from_numpy(rng.standard_normal(
        tuple(t.shape)).astype(np.float32)).to(t.dtype), params)
    state = opt.init(params)
    state = opt.update(grads, state, params, torch.tensor(1e-2))[1]
    want_p, want_s = opt.update(grads, state, params, torch.tensor(1e-2))
    given = tree_map(torch.clone, {"p": params, "m": state["m"],
                                   "v": state["v"]})
    got_p, got_s = opt.update(grads, {**state, "m": given["m"],
                                      "v": given["v"]}, given["p"],
                              torch.tensor(1e-2), donate=True)
    assert_trees_equal(got_p, want_p)
    assert_trees_equal({"m": got_s["m"], "v": got_s["v"]},
                       {"m": want_s["m"], "v": want_s["v"]})
    assert all(a is b for a, b in zip(tree_leaves(got_p),
                                      tree_leaves(given["p"])))
    assert all(a is b for a, b in zip(tree_leaves(got_s["m"]),
                                      tree_leaves(given["m"])))
