"""Adafactor over a mesh of ranks on each rank's blocks (`runtime.steps.
rank_adafactor_update`, `optim.optimizers.adafactor`'s `update_blocks`),
held against one process's `adafactor().update` on the same whole leaves.

A synthetic tree names its leaves so that `runtime.sharding`'s rules cut
them as the MoE giants' are cut (float32, seeded with numpy):
  * "moe/gate"       [2, 4, 128, 256]  an expert bank, (None, model, -, -)
  * "attn/wq/kernel" [2, 128, 256]     column-parallel, (None, None,
                                       model): its `vc` is cut as its
                                       rows are, not as its columns
  * "attn/wo/kernel" [2, 256, 128]     row-parallel, (None, model, None)
  * "embed"          [512, 128]        (model, None), ZeRO-1 on its
                                       columns: its `vc` is cut over model
  * "mlp/up/kernel"  [2, 64, 256]      a dim under 128: not factored
  * "norm/scale"     [256]             1-D: not factored
Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
2 ranks runs the (1, 2) and (2, 1) meshes, a world of 4 the (2, 2) and
(1, 4) meshes.  Each rank draws the whole tree and three steps' whole
gradients from one seed, keeps its blocks (`steps.cut` of the state's
specs) and updates them three times.

Bounds: `test_torch_ranks`' float32 ones (F32_PARAM_ATOL / RTOL), on the
params, the gathered state and each step's RMS-clipped update (the
params' step over lr): the row and column sums, the rows' mean and the
clip's sum of squares add their partials in another order.  Measured on
this CPU: the largest gap was 4.8e-5, on an update (a param's float32
ulp over lr), at every mesh 2.4e-5 or 4.8e-5.  A planted fault
(one leaf's row sums left unsummed over the ranks that cut its columns,
`_sum_by_group`'s first call) must move some value past the bound.  The
update's collectives over the model axis carry only vectors and scalars:
fewer bytes in all than one rank's block of the smallest leaf, where the
whole-leaf path gathered each gradient and param over it.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import local_shape
from repro_torch.launch import train
from repro_torch.optim import get_optimizer
from repro_torch.runtime import steps
from repro_torch.tree import tree_leaves, tree_map

from test_torch_ranks import (F32_PARAM_ATOL, F32_PARAM_RTOL,
                              assert_trees_close, flat, result, run_world)

TREE = {"moe": {"gate": (2, 4, 128, 256)},
        "attn": {"wq": {"kernel": (2, 128, 256)},
                 "wo": {"kernel": (2, 256, 128)}},
        "embed": (512, 128),
        "mlp": {"up": {"kernel": (2, 64, 256)}},
        "norm": {"scale": (256,)}}
STEPS, LR = 3, 1e-2
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def whole_tree(seed):
    """The synthetic tree's leaves drawn from `seed` (float32)."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda shp: torch.from_numpy(
        rng.standard_normal(shp).astype(np.float32)), TREE)


def draws():
    """(the whole params, each step's whole gradients, scaled by the
    step's number)."""
    params = whole_tree(0)
    grads = [tree_map(lambda g, i=i: g * (i + 1.0), whole_tree(i + 1))
             for i in range(STEPS)]
    return params, grads


def meta_state(opt):
    params = tree_map(lambda shp: torch.empty(shp, device="meta"), TREE)
    with torch.device("meta"):
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32)}


def one_process():
    """One process's three updates on the whole tree: (params, state,
    each step's update (p_old - p_new) / lr)."""
    opt = get_optimizer("adafactor")
    params, grads = draws()
    state = opt.init(params)
    updates = []
    for g in grads:
        new, state = opt.update(g, state, params, LR)
        updates.append(tree_map(lambda a, b: (a - b) / LR, params, new))
        params = new
    return params, state, updates


# --- the rank side -----------------------------------------------------------

def rank_run(mesh, plant=False):
    """Three block updates on this rank of `mesh`, from the whole draws
    cut to its blocks: the gathered params, state and updates, the local
    and spec shapes of the rank's state, and the collectives of each
    update (`record_collectives`)."""
    opt = get_optimizer("adafactor")
    shapes = meta_state(opt)
    specs = steps.train_state_pspecs(shapes, mesh)
    params, grads = draws()
    state = {"params": params, "opt": opt.init(params)}
    state = tree_map(torch.Tensor.clone, steps.cut(
        state, {k: specs[k] for k in state}, mesh))
    real = steps._sum_by_group
    calls = {"n": 0}

    def planted(tensors, keys, mesh):
        # the first call's row sums of the first leaf cut across its
        # columns stay this rank's own partial
        calls["n"] += 1
        out = real(tensors, keys, mesh)
        if calls["n"] % 3 == 1:
            i = next(i for i in range(0, len(keys), 2) if keys[i])
            out[i] = tensors[i]
        return out
    if plant:
        steps._sum_by_group = planted
    updates, recorded = [], []
    try:
        for g in grads:
            g_blocks = steps.cut(g, specs["params"], mesh)
            with core_mesh.record_collectives() as seen:
                new_p, new_opt = steps.rank_adafactor_update(
                    opt, g_blocks, state["params"], state["opt"], LR,
                    specs, shapes, mesh)
            recorded.append(seen)
            updates.append(tree_map(lambda a, b: (a - b) / LR,
                                    state["params"], new_p))
            state = {"params": new_p, "opt": new_opt}
    finally:
        steps._sum_by_group = real
    whole = {k: shapes[k] for k in ("params", "opt")}
    return {
        "params": steps.gather(state["params"], specs["params"],
                               shapes["params"], mesh),
        "opt": steps.gather(state["opt"], specs["opt"], shapes["opt"],
                            mesh),
        "updates": [steps.gather(u, specs["params"], shapes["params"], mesh)
                    for u in updates],
        "local_shapes": tree_map(lambda t: tuple(t.shape), state["opt"]),
        "spec_shapes": tree_map(lambda t, s: local_shape(tuple(t.shape), s,
                                                         mesh),
                                whole["opt"], specs["opt"]),
        "model_blocks": [int(np.prod(local_shape(tuple(t.shape), s, mesh)))
                         * 4 for t, s in zip(tree_leaves(shapes["params"]),
                                             tree_leaves(specs["params"]))
                         if any(e is not None for e in s)],
        "collectives": recorded}


def scenario_update(out):
    res = {}
    for shape in MESHES[out["world"]]:
        mesh = train.cli_mesh("host", torch.device("cpu"),
                              model_axis=shape[1])
        res[shape] = {"clean": rank_run(mesh),
                      "planted": rank_run(mesh, plant=True)}
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
def worlds(tmp_path_factory):
    return {w: run_world(w, ["update"], tmp_path_factory.mktemp(f"af{w}"),
                         entry=_rank_entry) for w in (2, 4)}


@pytest.fixture(scope="module")
def want():
    return one_process()


def runs(worlds, shape, kind="clean"):
    world = shape[0] * shape[1]
    return [result(worlds[world], "update", r)[shape][kind]
            for r in range(world)]


def close(got, want):
    """Whether every leaf of `got` is within the float32 bound of
    `want`'s."""
    g, w = flat(got), flat(want)
    return g.keys() == w.keys() and all(
        torch.allclose(g[k].float(), w[k].float(), atol=F32_PARAM_ATOL,
                       rtol=F32_PARAM_RTOL) for k in g)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_block_update_equals_one_process(shape, worlds, want):
    """Three block updates at `shape`, on every rank: the params, the
    gathered `vr` / `vc` / `v` and each step's clipped update within the
    float32 bounds of one process's; each rank's state its specs' local
    shapes."""
    params, state, updates = want
    for got in runs(worlds, shape):
        assert got["local_shapes"] == got["spec_shapes"]
        assert_trees_close(got["params"], params, F32_PARAM_ATOL,
                           F32_PARAM_RTOL)
        assert_trees_close(got["opt"], state, F32_PARAM_ATOL,
                           F32_PARAM_RTOL)
        assert len(got["updates"]) == STEPS
        for g, w in zip(got["updates"], updates):
            assert_trees_close(g, w, F32_PARAM_ATOL, F32_PARAM_RTOL)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_a_row_sum_left_out_fails_the_bound(shape, worlds, want):
    """The planted fault (one leaf's row sums not summed over the ranks
    that cut its columns) moves the params, the state or an update past
    the bound on some rank."""
    params, state, updates = want
    held = [close(got["params"], params) and close(got["opt"], state)
            and all(close(g, w) for g, w in zip(got["updates"], updates))
            for got in runs(worlds, shape, "planted")]
    assert not all(held)


@pytest.mark.parametrize("shape", [(1, 2), (2, 1), (2, 2), (1, 4)])
def test_no_whole_leaf_crosses_the_ranks(shape, worlds):
    """No collective of an update moves a whole bank's bytes, and those
    over the model axis carry fewer bytes in all than one rank's block of
    the smallest cut leaf: vectors and scalars, no gradient or param."""
    bank = 4 * int(np.prod(TREE["moe"]["gate"]))
    for got in runs(worlds, shape):
        smallest = min(got["model_blocks"])
        for seen in got["collectives"]:
            assert all(c["payload_b"] < bank for c in seen)
            model = sum(c["payload_b"] for c in seen
                        if "model" in c["axes"])
            assert model < smallest, (model, smallest)


def test_whole_blocks_in_one_process_are_the_update():
    """`update_blocks` on whole leaves with no sum across ranks: one
    process's `update` within the float32 bounds (the means are sums
    over the count there)."""
    opt = get_optimizer("adafactor")
    params, grads = draws()
    state = opt.init(params)
    shapes = meta_state(opt)["params"]
    groups = tree_map(lambda _: {"rows": (), "cols": (), "leaf": ()},
                      TREE)
    a, sa = params, state
    b, sb = params, state
    for g in grads:
        a, sa = opt.update(g, sa, a, LR)
        b, sb = opt.update_blocks(g, sb, b, LR, shapes=shapes,
                                  groups=groups, psum=lambda ts, ks: ts)
    assert_trees_close(b, a, F32_PARAM_ATOL, F32_PARAM_RTOL)
    assert_trees_close(sb, sa, F32_PARAM_ATOL, F32_PARAM_RTOL)
