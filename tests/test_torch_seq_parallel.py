"""The sequence-parallel residual over a `model` axis of ranks (the
reference's `seq_parallel`, `_sp`): the dense, vlm and MoE trunks and the
audio encoder hold the rank's block of the sequence between blocks,
gather it entering the column-parallel products and reduce-scatter the
row-parallel partials (`core.mesh.gather_from_sequence`,
`reduce_scatter_to_sequence`, `layers.row_sum`), and the step sums the
replicated norm scales' partial gradients over the model group
(`runtime.sharding.sequence_partial`, `steps.sum_rank_grads`).

Ranks are spawned over gloo with `test_torch_ranks`' harness, as
`test_torch_tp.py` spawns them: a world of 4 ranks runs the (2, 2) and
(1, 4) meshes, a world of 2 ranks the (1, 2) mesh, each a float32 smoke
config of drim-bnn, qwen3-14b, llava, deepseek-v3 (MLA and a shared
expert) and whisper-medium (its encoder; 4 heads, as the tp tests widen
it, so that 4 ranks take whole heads).

Bounds, each an existing one:
  * prefill logits and each rank's cache blocks: PREFILL_ATOL (2e-5, the
    test_torch_lm bound of `test_torch_tp.py` and
    `test_torch_moe_ranks.py`) of one process's and of the reference's;
  * each leaf's gradient block after one step (the step's sums):
    `test_torch_ranks`' F32_PARAM_ATOL / RTOL of one process's; a planted
    fault (the mlp_norm scales left unsummed over the model group) must
    fail it;
  * three AdamW steps: the losses within F32_RTOL of one process's, and
    the replicated leaves equal bit for bit on every rank;
  * at (1, 2), where every sum is over two terms: the prefill logits and
    caches and every gradient but the summed norm scales bit for bit
    `seq_parallel=False`'s.
The rank traces (`launch.dryrun.rank_trace`, a fake group on meta
tensors) run here: a decode step (S = 1) and an S the axis does not
divide trace the collectives of `seq_parallel=False`; with False the
traces are the design before the cut (digests of the earlier trace); the
cut's temp falls by at least (1 - 1/M) of the remat-saved layer inputs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.core.mesh import NamedSharding, local_block
from repro_torch.launch import dryrun, serve
from repro_torch.models import init_params, prefill
from repro_torch.optim import get_optimizer
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

from test_torch_ranks import (F32_PARAM_ATOL, F32_PARAM_RTOL, F32_RTOL,
                              assert_trees_close, batches, result,
                              run_world)
from test_torch_tp import PREFILL_ATOL, host_mesh, mesh_here

ARCHS = ("drim-bnn", "qwen3-14b", "llava-next-34b", "deepseek-v3-671b",
         "whisper-medium")
SHAPES = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
PROMPT = 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(arch, **over):
    cfg = get_smoke_config(arch).replace(dtype="float32", **over)
    if arch == "whisper-medium":
        cfg = cfg.replace(n_heads=4, n_kv_heads=4)
    return cfg


def serve_batch(cfg):
    """The prefill's batch: 4 prompts of PROMPT tokens (and the stub
    frontends' patches or frames) from the first training batch."""
    b = batches(cfg, 1, seq=PROMPT)[0]
    return {k: v for k, v in b.items() if k != "labels"}


def rank_grads(cfg, params, mesh):
    """(this rank's gradient blocks after the step's sums, the same with
    the mlp_norm scales left out of the model sum)."""
    specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
    b = steps.rank_rows(batches(cfg, 1)[0], mesh)[0]
    with mesh:
        _, _, g = steps._loss_and_grads(
            cfg, steps.cut(params, specs["params"], mesh), b)
        summed = steps.sum_rank_grads(cfg, g, b, mesh)
    inner = sharding.sequence_partial
    sharding.sequence_partial = lambda path, family: inner(
        path, family) and "mlp_norm" not in sharding._path_str(path)
    try:
        with mesh:
            planted = steps.sum_rank_grads(cfg, g, b, mesh)
    finally:
        sharding.sequence_partial = inner
    return summed, planted


def replicated_after_steps(cfg, mesh, n=3):
    """(losses, {path: leaf} of the replicated params) after n AdamW
    steps of `make_train_step` over `mesh` (None: one process)."""
    step_fn, init_state, opt = steps.make_train_step(
        cfg, mesh, optimizer_name="adamw", peak_lr=3e-3, warmup=1,
        total_steps=10)
    state = init_state(0, device="cpu")
    specs = None
    if mesh is not None:
        specs, shapes = steps.state_pspecs(cfg, opt, mesh)
        state = steps.place(state, tree_map(
            lambda s: NamedSharding(mesh, s), specs), shapes)
    losses = []
    for b in batches(cfg, n):
        state, m = step_fn(state, b)
        losses.append(float(m["loss"]))
    if mesh is None:
        return losses, {}
    leaves = {}
    tree_map_with_path(lambda p, t, s: leaves.__setitem__(p, t)
                       if all(e is None for e in s) else None,
                       state["params"], specs["params"])
    return losses, leaves


def scenario_cut(out):
    """Every arch at each mesh of the world: the prefill's logits and
    cache blocks, the summed gradient blocks (and the planted fault's),
    3 steps' losses and replicated leaves; at (1, 2) the prefill and the
    gradients with `seq_parallel=False` too."""
    res = {}
    for shape in SHAPES[out["world"]]:
        mesh = host_mesh(shape[1])
        for arch in ARCHS:
            cfg = cfg_of(arch)
            params = init_params(0, cfg, device="cpu")
            got = {}
            for sp in (True, False) if shape == (1, 2) else (True,):
                c = cfg.replace(seq_parallel=sp)
                with mesh:
                    placed = serve.place_params(params, mesh)
                    logits, caches = prefill(placed, c, serve_batch(c))
                grads, planted = rank_grads(c, params, mesh)
                got[sp] = {"logits": logits, "caches": caches,
                           "grads": grads, "planted": planted}
            got["steps"] = replicated_after_steps(cfg, mesh)
            res[(shape, arch)] = got
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
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("seq_parallel")


@pytest.fixture(scope="module")
def world4(tmp):
    return run_world(4, ["cut"], tmp / "w4", entry=_rank_entry)


@pytest.fixture(scope="module")
def world2(world4, tmp):
    return run_world(2, ["cut"], tmp / "w2", entry=_rank_entry)


def ranks_of(shape, world2, world4):
    return {2: world2, 4: world4}[shape[0] * shape[1]]


_ONE = {}


def one_process(arch):
    """(params, prefill logits and caches, one step's gradients, 3 steps'
    losses) of the float32 smoke config in one process, once per arch."""
    if arch not in _ONE:
        cfg = cfg_of(arch)
        params = init_params(0, cfg, device="cpu")
        logits, caches = prefill(params, cfg, serve_batch(cfg))
        grads = steps._loss_and_grads(cfg, params, batches(cfg, 1)[0])[2]
        _ONE[arch] = {"params": params, "logits": logits, "caches": caches,
                      "grads": grads,
                      "losses": replicated_after_steps(cfg, None)[0]}
    return _ONE[arch]


@pytest.fixture(scope="module")
def reference_prefills():
    """{arch: (the reference's float32 prefill logits, its caches as the
    port's tree)} on the port's params and prompts."""
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    res = {}
    for arch in ARCHS:
        cfg = cfg_of(arch)
        cj = jconfigs.get_smoke_config(arch).replace(dtype="float32")
        if arch == "whisper-medium":
            cj = cj.replace(n_heads=4, n_kv_heads=4)
        pj = jax.tree.map(jnp.asarray, tree_map(
            lambda t: t.numpy(), one_process(arch)["params"]))
        bj = {k: jnp.asarray(v.numpy()) for k, v in serve_batch(cfg).items()}
        lj, cache = jmodels.prefill(pj, cj, bj)
        res[arch] = (torch.from_numpy(np.array(lj)),
                     tree_map(lambda a: torch.from_numpy(np.array(a)),
                              jax.tree.map(np.asarray, cache)))
    return res


def close(got, want, atol, what):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               want.detach().float().numpy(), atol=atol,
                               rtol=0, err_msg=what)


def cache_blocks(caches, mesh, rank):
    """Each cache leaf's block of `rank` under `rank_cache_pspecs`."""
    specs = sharding.rank_cache_pspecs(mesh, caches)
    return tree_map(lambda t, s: t[local_block(tuple(t.shape), s, mesh,
                                               rank)], caches, specs)


def grad_blocks(grads, mesh, rank):
    specs = sharding.param_pspecs(grads, mesh)
    return tree_map(lambda g, s: g[local_block(tuple(g.shape), s, mesh,
                                               rank)], grads, specs)


CASES = [(shape, arch) for shape in ((1, 2), (2, 2), (1, 4))
         for arch in ARCHS]


def case_id(case):
    shape, arch = case
    return f"{arch}-{shape[0]}x{shape[1]}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_prefill_logits_and_cache_blocks(case, world2, world4,
                                         reference_prefills):
    """Every rank's whole logits within PREFILL_ATOL of one process's and
    the reference's; its caches its `rank_cache_pspecs` blocks of both's
    within the bound."""
    shape, arch = case
    ranks = ranks_of(shape, world2, world4)
    one = one_process(arch)
    lj, cj = reference_prefills[arch]
    mesh = mesh_here(shape)
    for r in range(len(ranks)):
        got = result(ranks, "cut", r)[(shape, arch)][True]
        close(got["logits"], one["logits"], PREFILL_ATOL, "logits")
        close(got["logits"], lj, PREFILL_ATOL, "reference logits")
        for want in (one["caches"], cj):
            for (path, g), w in zip(
                    flat_items(got["caches"]),
                    tree_leaves(cache_blocks(want, mesh, r))):
                assert g.shape == w.shape, path
                close(g, w, PREFILL_ATOL, path)


def flat_items(tree):
    """(path, leaf) pairs in `tree_leaves`' order."""
    return list(zip(tree_leaves(tree_map_with_path(lambda p, t: p, tree)),
                    tree_leaves(tree)))


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradient_blocks_after_one_step(case, world2, world4):
    """Each rank's gradient blocks after the step's sums within
    F32_PARAM_ATOL / RTOL of one process's; the planted fault (the
    mlp_norm scales' partials left unsummed) is not."""
    shape, arch = case
    ranks = ranks_of(shape, world2, world4)
    one = one_process(arch)["grads"]
    mesh = mesh_here(shape)
    caught = []
    for r in range(len(ranks)):
        got = result(ranks, "cut", r)[(shape, arch)][True]
        want = grad_blocks(one, mesh, r)
        assert_trees_close(got["grads"], want, F32_PARAM_ATOL,
                           F32_PARAM_RTOL)
        try:
            assert_trees_close(got["planted"], want, F32_PARAM_ATOL,
                               F32_PARAM_RTOL)
        except AssertionError:
            caught.append(r)
    assert caught, "the planted fault passed on every rank"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_replicated_leaves_equal_on_every_rank(case, world2, world4):
    """Three AdamW steps: every rank's losses within F32_RTOL of one
    process's, and each replicated leaf (the norm scales among them, whose
    gradients the cut sums over the model group) equal bit for bit on
    every rank."""
    shape, arch = case
    ranks = ranks_of(shape, world2, world4)
    want = one_process(arch)["losses"]
    first = result(ranks, "cut", 0)[(shape, arch)]["steps"][1]
    assert any("norm" in p for p in first)
    for r in range(len(ranks)):
        losses, leaves = result(ranks, "cut", r)[(shape, arch)]["steps"]
        np.testing.assert_allclose(losses, want, rtol=F32_RTOL)
        assert leaves.keys() == first.keys()
        for p, t in leaves.items():
            assert torch.equal(t, first[p]), (r, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_ranks_are_the_whole_residual_bit_for_bit(arch, world2):
    """At (1, 2) every sum is over two terms: the prefill's logits and
    caches and every gradient equal `seq_parallel=False`'s bit for bit,
    but the leaves whose gradient sums the blocks' partials in another
    order, within F32_PARAM_ATOL / RTOL: the summed norm scales, and the
    row-parallel BitLinear weights (`wo`, `down`), through alpha, which
    scales the block."""
    family = cfg_of(arch).family
    for r in range(2):
        got = result(world2, "cut", r)[((1, 2), arch)]
        cut, whole = got[True], got[False]
        assert torch.equal(cut["logits"], whole["logits"])
        for (path, a), b in zip(flat_items(cut["caches"]),
                                tree_leaves(whole["caches"])):
            assert torch.equal(a, b), path
        for (path, a), b in zip(flat_items(cut["grads"]),
                                tree_leaves(whole["grads"])):
            if sharding.sequence_partial(path, family) or re.search(
                    r"\['(wo|down)'\]\['bkernel'\]$", path):
                np.testing.assert_allclose(a.numpy(), b.numpy(),
                                           atol=F32_PARAM_ATOL,
                                           rtol=F32_PARAM_RTOL)
            else:
                assert torch.equal(a, b), path


# --- the rank traces ---------------------------------------------------------

TRACE_B = 4


def trace(cfg, kind, shape, s, ctx_len=0, layers=None):
    """`dryrun.rank_trace` of rank 0 of a (kind, S) step on meta tensors."""
    if layers:
        cfg = cfg.replace(n_layers=layers)
    b = {"tokens": ((TRACE_B, s), torch.long)}
    if kind == "train":
        b["labels"] = ((TRACE_B, s), torch.long)
    if kind != "decode" and cfg.family == "vlm":
        b["patch_embeds"] = ((TRACE_B, cfg.n_patches, cfg.d_model),
                             torch.bfloat16)
    if kind != "decode" and cfg.family == "audio":
        b["frames"] = ((TRACE_B, cfg.n_frames, cfg.d_model), torch.bfloat16)
    batch = {k: torch.empty(shp, dtype=dt, device="meta")
             for k, (shp, dt) in b.items()}
    return dryrun.rank_trace(cfg, kind, shape, ("data", "model"), batch,
                             ctx_len=ctx_len, flops=False)


COLLECTIVE_KEYS = ("collective_counts", "collective_by_kind",
                   "collective_bytes_per_device", "collective_calls_by_axis",
                   "collective_payload_b_by_axis")


def collectives(rec):
    return {k: rec[k] for k in COLLECTIVE_KEYS}


# (kind, S): a decode step, and a full sequence of 30 positions, which a
# model axis of 4 does not divide (whisper's encoder: 30 frames)
UNCUT = [("decode", 1), ("prefill", 30), ("train", 30)]


@pytest.mark.parametrize("arch", ARCHS)
def test_an_uncut_sequence_traces_the_whole_residual(arch):
    """S = 1, and an S the model axis does not divide, at (1, 4): the
    collectives of `seq_parallel=False`, and no reduce-scatter."""
    cfg = get_smoke_config(arch)
    if arch == "whisper-medium":
        cfg = cfg.replace(n_heads=4, n_kv_heads=4, n_frames=30)
    for kind, s in UNCUT:
        got = {sp: collectives(trace(cfg.replace(seq_parallel=sp), kind,
                                     (1, 4), s, ctx_len=40))
               for sp in (True, False)}
        assert got[True] == got[False], (kind, s)
        assert got[True]["collective_counts"]["reduce-scatter"] == 0


# sha256 of the collective fields (json, sorted keys) of rank 0's trace
# of each (arch, kind) step of 32 positions at (1, 4), from the rank path
# before the sequence cut: `seq_parallel=False` must trace it unchanged
WHOLE_RESIDUAL_TRACES = {
    ("drim-bnn", "train"): "86ee58a97ed6c709",
    ("drim-bnn", "prefill"): "8b1f08d2aadac8e2",
    ("qwen3-14b", "train"): "60f87af8f1034197",
    ("qwen3-14b", "prefill"): "daf4a320c9772618",
    ("llava-next-34b", "train"): "c016367a01e23e66",
    ("llava-next-34b", "prefill"): "daf4a320c9772618",
    ("deepseek-v3-671b", "train"): "78b37f3e6055d2ff",
    ("deepseek-v3-671b", "prefill"): "a3dcb5f45b69b081",
    ("whisper-medium", "train"): "fc05aa948448be1c",
    ("whisper-medium", "prefill"): "9fa2ec28433e1b75",
}


def digest(fields) -> str:
    return hashlib.sha256(json.dumps(fields, sort_keys=True).encode()) \
        .hexdigest()[:16]


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_residual_traces_the_earlier_rank_path(arch):
    """`seq_parallel=False`: the train and prefill steps' collectives at
    (1, 4) are the rank path's before the cut (their digests); True adds
    reduce-scatters."""
    cfg = get_smoke_config(arch)
    if arch == "whisper-medium":
        cfg = cfg.replace(n_heads=4, n_kv_heads=4)
    for kind in ("train", "prefill"):
        fields = {sp: collectives(trace(cfg.replace(seq_parallel=sp), kind,
                                        (1, 4), 32))
                  for sp in (True, False)}
        assert digest(fields[False]) == WHOLE_RESIDUAL_TRACES[(arch, kind)]
        assert fields[True]["collective_counts"]["reduce-scatter"] > 0
        assert fields[False]["collective_counts"]["reduce-scatter"] == 0


@pytest.mark.parametrize("m", [2, 4])
def test_the_cut_frees_the_saved_layer_inputs(m):
    """Rank 0's train-step temp on drim-bnn's smoke config at 16 layers
    and 1024 positions over (1, M): the cut's at least (1 - 1/M) of the
    16 remat-saved layer inputs [B, S, D] below the whole residual's (at
    64 positions the optimizer's update, not the backward, holds the
    peak, and the temps are equal)."""
    cfg = get_smoke_config("drim-bnn")
    s, layers = 1024, 16
    temp = {sp: trace(cfg.replace(seq_parallel=sp), "train", (1, m), s,
                      layers=layers)["mem_temp_b"] for sp in (True, False)}
    saved = layers * TRACE_B * s * cfg.d_model \
        * cfg.activation_dtype.itemsize
    assert temp[False] - temp[True] >= (1 - 1 / m) * saved, (temp, saved)


def test_the_config_carries_the_reference_switch():
    """`seq_parallel` is a field of the port's ModelConfig with the
    reference's default (True)."""
    from repro.configs.base import ModelConfig as JModelConfig

    from repro_torch.configs.base import ModelConfig

    def default(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}[
            "seq_parallel"]
    assert default(ModelConfig) is default(JModelConfig) is True
