"""The audio family over a `model` axis of ranks: whisper-medium's encoder
on the rank's heads (the dense cut), its decoder's self-attention on the
dense path and its cross-attention on the rank's heads of every frame
(`wq`, `wk`, `wv` column-parallel, `wo` row-parallel; the cross cache
cut over heads, `runtime.sharding.rank_cache_pspecs`), and both served
over a data mesh, held against the port's one-process runs and the
reference.

Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
4 ranks runs the (2, 2) and (1, 4) meshes, then a world of 2 ranks the
(1, 2) and (2, 1) meshes.  whisper-medium's smoke config has 2 heads,
which a model axis of 4 does not split, so at (1, 4) both packages run it
widened to 4 heads (`WIDE`).  The parent computes the reference's and one
process's numbers and hands the ranks their inputs in files.

Bounds (float32 activations), each measured on this CPU first:
  * the encoder block and the decoder block (xdec) on each rank's blocks
    of seeded params at (1, 2) and (1, 4): both blocks' outputs, the
    gradients of their outputs' weighted sums for both inputs and each
    param's block, within `OPS_RTOL` of each tensor's largest |value|
    (the row-parallel products sum float32 partials in another order;
    measured 1.0e-6).
  * the model (S = 32, 32 frames: `prefill`, three decode steps over a
    36-long self cache, cut over the sequence, and a 37-long one, whole,
    the train loss's gradients summed over the data ranks) at (1, 2),
    (2, 1), (2, 2) and (1, 4), each against one process's (`MODEL_TOL`):
    the prefill's last logits and every decode step's (absolute), each
    cache block and each gradient block (relative to the leaf's largest
    |value|), the global gradient norm (relative); measured 2.4e-7,
    9.7e-7, 2.1e-6, 0.  Each rank holds 1 / |ranks| of the cross
    cache.
  * the rank-block init: the whole init cut by the specs, leaf for leaf.
  * the serve CLI (float32 activations, bfloat16 params, the reference's
    weights through `lm_from_jax`): the reference CLI's greedy tokens on
    every mesh; the (2, 1) run gives one process's tokens bit for bit.
  * the train CLI from the reference trainer's state (bfloat16): each
    step's loss within `test_torch_ranks.REF_LOSS_RTOL` (1e-3) of the
    reference's at (1, 2) and (2, 2).
  * whisper-medium's published vocabulary of 51,865 is padded to 51,968
    = 128 x 406 rows, which 2 and 4 divide: its embedding is cut by rows
    and its head by columns at (1, 2) and (1, 4), as the reference's
    `param_pspecs` cut them.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.mesh import PartitionSpec, abstract_mesh, local_block
from repro_torch.launch import serve
from repro_torch.models import blocks, init_params, prefill, transformer
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_map, tree_map_with_path

from test_torch_moe_ranks import float32_serving, mesh_here, rank_blocks
from test_torch_ranks import (REF_LOSS_RTOL, assert_trees_equal, flat,
                              result, run_world)
from test_torch_ssm_ranks import close_rel, host_mesh, train_from

ARCH = "whisper-medium"
B, S = 2, 32
CTXS = (36, 37)
WIDE = {"n_heads": 4, "n_kv_heads": 4}
WIDE_ARGV = ["--heads", "4", "--kv-heads", "4"]
OPS_RTOL = 1e-5
MODEL_TOL = dict(logits=1e-5, cache=1e-5, grad=1e-5, norm=1e-5)
SERVE_ARGV = ["--arch", ARCH, "--smoke-config", "--batch", "4",
              "--prompt-len", "32", "--gen", "5"]
TRAIN_ARGV = ["--arch", ARCH, "--smoke-config", "--steps", "3", "--batch",
              "4", "--seq", "32", "--log-every", "1", "--lr", "3e-3",
              "--warmup", "1"]
SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide(shape) -> bool:
    return shape[1] == 4


def f32_cfg(widen=False):
    cfg = configs.get_smoke_config(ARCH).replace(dtype="float32")
    return cfg.replace(**WIDE) if widen else cfg


def model_batch(cfg, seed=7):
    """Seeded tokens and labels [B, S] and frame embeddings [B, frames,
    d_model]."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1),
            "frames": torch.from_numpy(rng.standard_normal(
                (B, cfg.n_frames, cfg.d_model)).astype(np.float32))}


def model_run(params, cfg, mesh=None):
    """Prefill, then three decode steps over each cache length of CTXS,
    and the train loss's gradients (over ranks: the rank's rows, summed
    as a step sums them, `steps.sum_rank_grads`), in one process or under
    `mesh` (a mesh of ranks: the rank's blocks)."""
    batch = model_batch(cfg)
    pre_batch = {k: v for k, v in batch.items() if k != "labels"}
    res = {}
    with (mesh if mesh is not None else contextlib.nullcontext()):
        with torch.no_grad():
            logits, pre = prefill(params, cfg, pre_batch)
            res["logits"], res["caches"] = logits, pre
            for ctx in CTXS:
                empty = transformer.empty_caches(cfg, B, ctx,
                                                 dtype=torch.float32,
                                                 device="cpu")
                caches = (serve.splice_caches(empty, pre) if mesh is None
                          else serve.splice_rank_caches(empty, pre, S, ctx,
                                                        mesh))
                out = []
                for i in range(3):
                    pos = torch.full((B,), S + i, dtype=torch.long)
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


def ops_params(cfg):
    """Seeded float32 params of one encoder block and one decoder
    block."""
    gen = torch.Generator().manual_seed(3)
    return {"enc": blocks.dense_block_init(gen, cfg),
            "dec": blocks.xdec_block_init(gen, cfg)}


def ops_run(p, cfg, mesh=None):
    """The encoder block over seeded frames, then the decoder block over
    seeded embeddings against its output (under `mesh`: on the rank's
    blocks of the params): both outputs and the gradients of their
    weighted sums for both inputs and every param."""
    rng = np.random.default_rng(5)
    x, enc, wx, we = (torch.from_numpy(rng.standard_normal(
        (B, n, cfg.d_model)).astype(np.float32))
        for n in (S, cfg.n_frames, S, cfg.n_frames))
    if mesh is not None:
        p = serve.place_params(p, mesh, cfg.family)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), p)
    x, enc = x.requires_grad_(True), enc.requires_grad_(True)
    pos = torch.arange(S)[None].expand(B, S)
    enc_pos = torch.arange(cfg.n_frames)[None].expand(B, cfg.n_frames)
    with (mesh if mesh is not None else contextlib.nullcontext()):
        ye, _, _ = blocks.dense_block(live["enc"], cfg, enc, enc_pos,
                                      causal=False)
        yd, _, _ = blocks.xdec_block(live["dec"], cfg, x, pos, ye)
        ((ye * we).sum() + (yd * wx).sum()).backward()
    return {"enc_out": ye.detach(), "dec_out": yd.detach(), "dx": x.grad,
            "denc": enc.grad,
            "grads": {k: t.grad for k, t in flat(live).items()}}


# --- the rank side -----------------------------------------------------------

def scenario_ops(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        if shape[0] == 1:
            cfg = f32_cfg(wide(shape))
            res[shape] = ops_run(ops_params(cfg), cfg, host_mesh(shape[1]))
    return res


def scenario_model(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        cfg = f32_cfg(wide(shape))
        params = torch.load(out["dir"] + f"/model_{wide(shape)}.pt")
        mesh = host_mesh(shape[1])
        got = model_run(serve.place_params(params, mesh, cfg.family), cfg,
                        mesh)
        specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
        got["norm"] = steps.tp_global_norm(got["grads"], specs["params"],
                                           mesh)
        res[shape] = got
    return res


def scenario_init(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        cfg = f32_cfg(wide(shape)).replace(param_dtype="bfloat16")
        with host_mesh(shape[1]):
            res[shape] = init_params(0, cfg, device="cpu")
    return res


def scenario_serve(out):
    res = {}
    for shape in SHAPES[out["world"]]:
        extra = WIDE_ARGV if wide(shape) else []
        params, toks = torch.load(out["dir"] + f"/serve_{wide(shape)}.pt",
                                  weights_only=False)
        args = serve.parse_args(SERVE_ARGV + extra + [
            "--device", "cpu", "--model-axis", str(shape[1])])
        with float32_serving(serve):
            res[shape], _ = serve.run_serve(args, params=params, tokens=toks)
    return res


def scenario_train(out):
    state_np = torch.load(out["dir"] + "/train.pt", weights_only=False)
    return {shape: train_from(state_np, [*TRAIN_ARGV, "--device", "cpu",
                                         "--model-axis", str(shape[1])])
            for shape in SHAPES[out["world"]]
            if shape[1] > 1 and not wide(shape)}


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
    from repro.runtime import sharding as jshd
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, serve=jserve, shd=jshd,
                                 steps=jsteps, P=P)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("audio_ranks")


@pytest.fixture(scope="module")
def ops_one():
    return {widen: ops_run(ops_params(f32_cfg(widen)), f32_cfg(widen))
            for widen in (False, True)}


@pytest.fixture(scope="module")
def model_one(tmp):
    one = {}
    for widen in (False, True):
        cfg = f32_cfg(widen)
        params = init_params(0, cfg, device="cpu")
        torch.save(params, tmp / f"model_{widen}.pt")
        one[widen] = (params, model_run(params, cfg))
    return one


@pytest.fixture(scope="module")
def serve_ref(jref, tmp):
    """The reference serve CLI's greedy tokens (float32 activations) and
    the port's one-process tokens, at 2 heads and widened to 4; the
    weights (through `lm_from_jax`) and prompts saved for the ranks."""
    from test_torch_mesh_cli import ref_serve_host_arrays, ref_weights
    want = {}
    with float32_serving(serve, jref.serve):
        for widen in (False, True):
            argv = SERVE_ARGV + (WIDE_ARGV if widen else [])
            gen, _ = ref_serve_host_arrays(jref, argv)
            params, toks = ref_weights(jref, serve.parse_args(
                argv + ["--device", "cpu"]))
            one, _ = serve.run_serve(serve.parse_args(
                argv + ["--device", "cpu"]), params=params, tokens=toks)
            torch.save((params, toks), tmp / f"serve_{widen}.pt")
            want[widen] = (np.asarray(gen), one)
    return want


@pytest.fixture(scope="module")
def train_ref(jref, tmp):
    from test_torch_train_families import reference_cli_run
    state_np, metrics = reference_cli_run(jref, TRAIN_ARGV)
    torch.save(state_np, tmp / "train.pt")
    return metrics


NAMES = ["ops", "model", "init", "serve", "train"]


@pytest.fixture(scope="module")
def world4(ops_one, model_one, serve_ref, train_ref, tmp):
    return run_world(4, NAMES, tmp, entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, tmp):
    return run_world(2, NAMES, tmp, entry=_rank_entry)


def ranks_of(shape, world2, world4):
    return {2: world2, 4: world4}[shape[0] * shape[1]]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_encoder_and_cross_attention_on_cut_params_equal_one_process(
        shape, world2, world4, ops_one):
    """The encoder block (bidirectional attention on the rank's heads)
    and the decoder block (its cross-attention on the rank's heads of
    every frame) on each rank's blocks of the params: both outputs, the
    gradients of both inputs and of each param's block within OPS_RTOL of
    one process's; the cross-attention's `wq` / `wk` / `wv` cut by
    columns, its `wo` by rows."""
    one = ops_one[wide(shape)]
    mesh = mesh_here(shape)
    cfg = f32_cfg(wide(shape))
    whole = flat(ops_params(cfg))
    for r in range(shape[1]):
        got = result(ranks_of(shape, world2, world4), "ops", r)[shape]
        for key in ("enc_out", "dec_out", "dx", "denc"):
            close_rel(got[key], one[key], OPS_RTOL, key)
        assert got["grads"].keys() == whole.keys()
        for k, g in got["grads"].items():
            blk = local_block(tuple(whole[k].shape), sharding.param_spec(
                k, whole[k], mesh), mesh, r)
            close_rel(g, one["grads"][k][blk], OPS_RTOL, k)
    grads = result(ranks_of(shape, world2, world4), "ops")[shape]["grads"]
    width = cfg.n_heads * cfg.d_head
    for name in ("wq", "wk", "wv"):
        assert grads[f"['dec']['cross']['{name}']['kernel']"].shape \
            == (cfg.d_model, width // shape[1])
    assert grads["['dec']['cross']['wo']['kernel']"].shape \
        == (width // shape[1], cfg.d_model)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_model_over_ranks_equals_one_process(shape, world2, world4,
                                             model_one):
    """whisper's float32 smoke model over each mesh (the frames cut by
    rows with the tokens): the prefill's last logits, each rank's cache
    blocks (the self cache cut over the sequence, the cross cache over
    heads), three decode steps over a cut (36) and a whole (37) self
    cache, each gradient block and the global norm, within `MODEL_TOL`
    of one process's."""
    params, one = model_one[wide(shape)]
    mesh = mesh_here(shape)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "model", r)[shape]
        np.testing.assert_allclose(_np(got["logits"]), _np(one["logits"]),
                                   atol=MODEL_TOL["logits"], rtol=0)

        def blocks_of(path, g, w, spec):
            want = w[local_block(tuple(w.shape), spec, mesh, r)]
            assert g.shape == want.shape, path
            close_rel(g, want, MODEL_TOL["cache"], path)
        tree_map_with_path(blocks_of, got["caches"], one["caches"],
                           sharding.rank_cache_pspecs(mesh, one["caches"]))
        for ctx in CTXS:
            for g, w in zip(got[ctx]["logits"], one[ctx]["logits"],
                            strict=True):
                np.testing.assert_allclose(_np(g), _np(w),
                                           atol=MODEL_TOL["logits"], rtol=0)
            tree_map_with_path(blocks_of, got[ctx]["caches"],
                               one[ctx]["caches"],
                               sharding.rank_cache_pspecs(
                                   mesh, one[ctx]["caches"]))
        g, w = flat(got["grads"]), flat(rank_blocks(one["grads"], mesh, r))
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].shape == w[k].shape, k
            close_rel(g[k], w[k], MODEL_TOL["grad"], k)
        np.testing.assert_allclose(float(got["norm"]),
                                   float(global_norm(one["grads"])),
                                   rtol=MODEL_TOL["norm"])


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_each_rank_holds_its_share_of_the_cross_cache(shape, world2,
                                                      world4, model_one):
    """The cross cache over ranks: each rank's prefill and decode blocks
    of "cross/k" and "cross/v" hold 1 / |ranks| of one process's bytes
    (its rows and its heads of every frame), and the self cache under a
    model axis its sequence block."""
    _, one = model_one[wide(shape)]
    n = shape[0] * shape[1]
    for r in range(n):
        got = result(ranks_of(shape, world2, world4), "model", r)[shape]
        for caches, whole in ((got["caches"], one["caches"]),
                              (got[36]["caches"], one[36]["caches"])):
            for name in ("k", "v"):
                g, w = caches["cross"][name], whole["cross"][name]
                assert n * g.numel() == w.numel(), name
                assert g.shape[2] == w.shape[2]          # every frame
                assert g.shape[3] * shape[1] == w.shape[3]
        g, w = got[36]["caches"]["self"]["k"], one[36]["caches"]["self"]["k"]
        assert g.shape[2] * shape[1] == w.shape[2]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_rank_block_init_equals_init_then_cut(shape, world2, world4):
    """`init_params` inside a mesh of ranks draws only the rank's blocks
    (the encoder's layers and each cross-attention leaf among them), and
    they equal the whole init cut by the specs, leaf for leaf."""
    mesh = mesh_here(shape)
    cfg = f32_cfg(wide(shape)).replace(param_dtype="bfloat16")
    whole = init_params(0, cfg, device="cpu")
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "init", r)[shape]
        assert_trees_equal(got, rank_blocks(whole, mesh, r))
    if shape[1] > 1:
        assert got["layers"]["cross"]["wk"]["kernel"].shape[-1] \
            * shape[1] == whole["layers"]["cross"]["wk"]["kernel"].shape[-1]
        assert got["enc_layers"]["attn"]["wo"]["kernel"].shape[-2] \
            * shape[1] == whole["enc_layers"]["attn"]["wo"]["kernel"] \
            .shape[-2]


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_serve_cli_over_ranks_gives_the_reference_tokens(shape, world2,
                                                         world4, serve_ref):
    """`serve.run_serve` with the reference's weights and prompts (and
    zero frames): the reference CLI's greedy tokens on every rank; over
    the (2, 1) data mesh one process's tokens bit for bit."""
    want, one = serve_ref[wide(shape)]
    np.testing.assert_array_equal(one, want)
    for r in range(shape[0] * shape[1]):
        got = result(ranks_of(shape, world2, world4), "serve", r)[shape]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        if shape == (2, 1):
            assert np.array_equal(got, one)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
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


@pytest.mark.parametrize("m", [2, 4])
def test_padded_vocabulary_cuts_as_the_reference(m, jref):
    """whisper-medium at full size over the abstract (1, m) mesh: its
    vocabulary of 51,865 padded to 51,968 (128 x 406), which the model
    axis divides, so the embedding is cut by rows and the head by
    columns, and every param spec equals the reference's; the decode
    caches' specs equal the reference's, and the ranks' layout is theirs
    but for the cross cache, cut over heads."""
    from jax.sharding import AbstractMesh

    from test_torch_sharding import port_specs, ref_specs
    shape, names = (1, m), ("data", "model")
    mj, mt = AbstractMesh(shape, names), abstract_mesh(shape, names)
    cj, ct = jref.configs.get_config(ARCH), configs.get_config(ARCH)
    assert transformer.padded_vocab(ct) == 51968 == 128 * 406
    pj = jref.jax.eval_shape(
        lambda: jref.models.init_params(jref.jax.random.PRNGKey(0), cj))
    got = sharding.param_pspecs(transformer.abstract_params(ct), mt,
                                ct.family)
    assert got["embed"] == PartitionSpec("model", None)
    assert got["head"] == PartitionSpec(None, "model")
    assert port_specs(got) == ref_specs(
        jref, jref.shd.param_pspecs(pj, mj, cj.family))
    cache_j = jref.jax.eval_shape(lambda: jref.models.empty_caches(cj, 4,
                                                                   1024))
    cache_t = transformer.abstract_caches(ct, 4, 1024)
    want = ref_specs(jref, jref.shd.cache_pspecs(mj, cache_j))
    assert port_specs(sharding.cache_pspecs(mt, cache_t)) == want
    ranked = port_specs(sharding.rank_cache_pspecs(mt, cache_t))
    assert ranked.keys() == want.keys()
    for path, spec in ranked.items():
        if path.startswith("['cross']"):     # H over "model", every frame
            assert spec == (None, "data", None, "model"), path
        else:
            assert spec == want[path], path
