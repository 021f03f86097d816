"""--compress over a mesh of ranks on each rank's blocks (`runtime.steps.
rank_ef_compress`, `optim.compress.compress_blocks`, inside `steps.
rank_update`), held against one process's error feedback and update on
the same whole leaves (`steps._ef_compress`, `optimizer.update`).

The synthetic tree is `test_torch_adam8bit_ranks`' (its leaves cut as
qwen3-14b's: a (None, None, model) stack, a row-parallel one, the
embedding, the head, a norm scale and two leaves whose sizes are not
multiples of 256).  The residuals keep the moments' ZeRO-1 specs.  Ranks
are spawned over gloo with `test_torch_ranks`' harness: a world of 2
ranks runs the (1, 2) and (2, 1) meshes, a world of 4 the (2, 2) and
(1, 4) meshes.  Each rank draws the whole tree and three steps' whole
gradients from one seed, keeps its blocks and runs three updates with
AdamW, Adafactor and adam8bit after the error feedback.

Bounds: `test_torch_ranks`' float32 ones (F32_PARAM_ATOL / RTOL) on the
params, the gathered residuals and the gathered AdamW and Adafactor
state, the global norm of the decoded gradients within F32_RTOL: each
leaf's sum of |g + err| and the norm's sums of squares add their blocks'
partials in another order.  adam8bit after it: the params and moments
within those bounds but for INT8_FLIP_SHARE of each leaf's elements.  A
planted fault (one leaf's sum of |g + err| left as the rank's own) must
move some value past the bound.  The error feedback's collectives are
all-reduces of one scalar a leaf: fewer bytes than the whole-leaf path's
gathers of the gradients over the model axis and the residuals over
both.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import local_shape
from repro_torch.launch import dryrun, train
from repro_torch.optim import get_optimizer, init_errors
from repro_torch.optim.optimizers import global_norm
from repro_torch.runtime import sharding, steps
from repro_torch.tree import tree_leaves, tree_map

from test_torch_adam8bit_ranks import (MESHES, SHAPES, STEPS, TREE, draws,
                                       values)
from test_torch_ranks import (F32_PARAM_ATOL, F32_PARAM_RTOL, F32_RTOL,
                              assert_mostly_close, assert_trees_close, flat,
                              result, run_world)

LR = 1e-2
OPTIMIZERS = ("adamw", "adafactor", "adam8bit")
# rank 0's temp in this CPU's dry-run of qwen3-14b's train_4k cell over
# the 16 x 16 mesh with --compress, at most this many times the AdamW
# cell's without
TEMP_RATIO = 1.5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meta_state(opt):
    params = tree_map(lambda shp: torch.empty(shp, device="meta"), TREE)
    with torch.device("meta"):
        return {"params": params, "opt": opt.init(params),
                "errors": params, "step": torch.zeros((), dtype=torch.int32)}


def one_process(name):
    """One process's three steps on the whole tree: (params, state,
    residuals, each step's global norm of the decoded gradients)."""
    opt = get_optimizer(name)
    params, grads = draws()
    state, errors, norms = opt.init(params), init_errors(params), []
    for g in grads:
        decoded, errors = steps._ef_compress(g, errors)
        norms.append(float(global_norm(decoded)))
        params, state = opt.update(decoded, state, params, LR)
    return params, state, errors, norms


# --- the rank side -----------------------------------------------------------

def rank_run(mesh, name, plant=False):
    """Three steps of `steps.rank_update` with --compress on this rank of
    `mesh`, from the whole draws cut to its blocks: the gathered params,
    state and residuals, each step's norm, the residuals' local and spec
    shapes, each error feedback's collectives and the whole-leaf path's
    (the gradients gathered over the model axis, the residuals whole)."""
    opt = get_optimizer(name)
    shapes = meta_state(opt)
    specs = steps.train_state_pspecs(shapes, mesh)
    specs["errors"] = sharding.opt_state_pspecs(shapes["params"], mesh)
    params, grads = draws()
    state = {"params": params, "opt": opt.init(params),
             "errors": init_errors(params)}
    state = tree_map(torch.Tensor.clone, steps.cut(
        state, {k: specs[k] for k in state}, mesh))
    real = steps.compress_blocks

    def planted(g, e, numels, keys, psum):
        # the first leaf cut over the ranks keeps its own sum of |g + err|
        def partial(ts, ks):
            out = psum(ts, ks)
            i = next(i for i, k in enumerate(ks) if k)
            out[i] = ts[i]
            return out
        return real(g, e, numels, keys, partial)

    def feedback(g, e, numels, keys, psum):
        with core_mesh.record_collectives() as seen:
            out = (planted if plant else real)(g, e, numels, keys, psum)
        recorded.append(seen)
        return out
    steps.compress_blocks = feedback
    recorded, norms = [], []
    try:
        for g in grads:
            new_p, new_opt, new_err, norm = steps.rank_update(
                name, opt, state, steps.cut(g, specs["params"], mesh), LR,
                specs, shapes, mesh, compress=True)
            norms.append(float(norm))
            state = {"params": new_p, "opt": new_opt, "errors": new_err}
    finally:
        steps.compress_blocks = real
    with core_mesh.record_collectives() as old:
        steps.gather(steps.cut(grads[0], specs["params"], mesh),
                     specs["params"], shapes["params"], mesh, ("model",))
        steps.gather(state["errors"], specs["errors"], shapes["errors"],
                     mesh)
    return {
        "params": steps.gather(state["params"], specs["params"],
                               shapes["params"], mesh),
        "opt": steps.gather(state["opt"], specs["opt"], shapes["opt"],
                            mesh),
        "errors": steps.gather(state["errors"], specs["errors"],
                               shapes["errors"], mesh),
        "norms": norms,
        "local_shapes": tree_map(lambda t: tuple(t.shape), state["errors"]),
        "spec_shapes": tree_map(lambda t, s: local_shape(tuple(t.shape), s,
                                                         mesh),
                                shapes["errors"], specs["errors"]),
        "collectives": recorded, "whole_leaf_path": old}


def scenario_update(out):
    res = {}
    for shape in MESHES[out["world"]]:
        mesh = train.cli_mesh("host", torch.device("cpu"),
                              model_axis=shape[1])
        res[shape] = {name: {"clean": rank_run(mesh, name)}
                      for name in OPTIMIZERS}
        res[shape]["adamw"]["planted"] = rank_run(mesh, "adamw", plant=True)
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
    return {w: run_world(w, ["update"], tmp_path_factory.mktemp(f"ef{w}"),
                         entry=_rank_entry) for w in (2, 4)}


@pytest.fixture(scope="module")
def want():
    return {name: one_process(name) for name in OPTIMIZERS}


def runs(worlds, shape, name, kind="clean"):
    world = shape[0] * shape[1]
    return [result(worlds[world], "update", r)[shape][name][kind]
            for r in range(world)]


def check(got, name, want):
    """Raises where `got` is past the bound of one process's `want`."""
    params, state, errors, norms = want
    np.testing.assert_allclose(got["norms"], norms, rtol=F32_RTOL)
    assert_trees_close(got["errors"], errors, F32_PARAM_ATOL,
                       F32_PARAM_RTOL)
    if name == "adam8bit":
        assert_mostly_close(flat(got["params"]), flat(params))
        assert_mostly_close(values(got["opt"]["q"]), values(state["q"]))
        return
    assert_trees_close(got["params"], params, F32_PARAM_ATOL,
                       F32_PARAM_RTOL)
    assert_trees_close(got["opt"], state, F32_PARAM_ATOL, F32_PARAM_RTOL)


@pytest.mark.parametrize("name", OPTIMIZERS)
@pytest.mark.parametrize("shape", SHAPES)
def test_block_feedback_equals_one_process(shape, name, worlds, want):
    """Three steps at `shape` on every rank: the norms, residuals, params
    and state within the bounds of one process's; each rank's residuals
    its specs' local shapes."""
    for got in runs(worlds, shape, name):
        assert got["local_shapes"] == got["spec_shapes"]
        check(got, name, want[name])


@pytest.mark.parametrize("shape", SHAPES)
def test_a_sum_left_out_fails_the_bound(shape, worlds, want):
    """The planted fault (one leaf's sum of |g + err| not summed over the
    ranks that cut it) moves some value past the bound on some rank."""
    def holds(got):
        try:
            check(got, "adamw", want["adamw"])
        except AssertionError:
            return False
        return True
    assert not all(holds(got)
                   for got in runs(worlds, shape, "adamw", "planted"))


@pytest.mark.parametrize("shape", SHAPES)
def test_no_whole_leaf_crosses_the_ranks(shape, worlds):
    """Each error feedback's collectives are all-reduces of one float32
    scalar a leaf at most, fewer bytes than the whole-leaf path's
    gathers of the gradients over the model axis and the residuals over
    both axes."""
    leaves = len(tree_leaves(TREE))
    for name in OPTIMIZERS:
        for got in runs(worlds, shape, name):
            old = sum(c["payload_b"] for c in got["whole_leaf_path"])
            for seen in got["collectives"]:
                assert all(c["kind"] == "all-reduce" for c in seen)
                new = sum(c["payload_b"] for c in seen)
                assert new <= 4 * leaves < old, (new, old)


def test_qwen3_14b_dry_run_temp_against_adamw():
    """This CPU's rank 0 trace of qwen3-14b's train_4k cell over the
    16 x 16 mesh (`launch.dryrun.rank_trace`, meta tensors): with
    --compress AdamW's temp at most TEMP_RATIO times its temp without,
    where the whole-leaf feedback's was 18.6 times (269.01 GB against
    14.49 GB); the calls over both axes carry scalars beside AdamW's own
    (the whole-leaf path made 257, 59.07 GB)."""
    cfg = get_config("qwen3-14b")
    got = {compress: dryrun.rank_trace(
        cfg, "train", *dryrun.PRODUCTION_MESHES["single"],
        dryrun.input_specs(cfg, "train_4k"), optimizer="adamw",
        compress=compress, flops=False) for compress in (False, True)}
    assert got[True]["mem_temp_b"] <= TEMP_RATIO * got[False]["mem_temp_b"]
    both = {c: g["collective_payload_b_by_axis"].get("data+model", 0)
            for c, g in got.items()}
    leaves = len(tree_leaves(steps.abstract_train_state(
        cfg, get_optimizer("adamw"))["params"]))
    assert 0 <= both[True] - both[False] <= 8 * leaves, both
