"""adam8bit over a mesh of ranks on each rank's blocks of its state
(`runtime.steps.rank_adam8bit_update`, `optim.optimizers.adam8bit`'s
`update_blocks` and `init_blocks`), held against one process's
`adam8bit().update` on the same whole leaves.

A synthetic tree names its leaves so that `runtime.sharding`'s rules cut
them as qwen3-14b's are cut (float32, seeded with numpy); the state's
codes [n_blocks, 256] are cut by the param's spec truncated, plus ZeRO-1:
  * "attn/wq/kernel"   [5, 64, 256]   (None, None, model); at two data
                                      ranks each rank's rows are 2.5 of
                                      the 5 layers, as qwen3-14b's 40
                                      over 16
  * "attn/wo/kernel"   [5, 256, 64]   row-parallel, (None, model, None)
  * "embed"            [512, 128]     (model, None); its codes (model,
                                      data): rows cut as the param's
  * "head"             [128, 384]     (None, model); its codes (data,
                                      model), and 384 is 1.5 blocks of
                                      256, as qwen3-14b's 151936 is not a
                                      multiple of 256
  * "final_norm/scale" [1280]         replicated; its codes (None, data)
  * "mlp/up/kernel"    [3, 40, 100]   12,000 elements, not a multiple of
                                      256: the last block is padded
  * "mlp/down/kernel"  [3, 100, 44]   padded too, its rows cut over data
Ranks are spawned over gloo with `test_torch_ranks`' harness: a world of
2 ranks runs the (1, 2) and (2, 1) meshes, a world of 4 the (2, 2) and
(1, 4) meshes.  Each rank draws the whole tree and three steps' whole
gradients from one seed, keeps its blocks (`steps.cut` of the state's
specs) and updates them three times.

Bounds: with the clip off (`grad_clip=0`) every code, scale and param
equal to one process's, bit for bit: a block's scale is a maximum, exact
in any order, and the rest is elementwise.  With the clip on, its scale
comes from the global norm summed in another order, so `test_torch_
ranks`' adam8bit bounds hold: the float32 bounds but for
INT8_FLIP_SHARE of each leaf's elements, on the params and on the
moments the codes and scales give.  A planted fault (one leaf's block
maxima left out of the maximum over the ranks that cut their columns)
must move the moments past that bound.  No whole state leaf crosses the
ranks: no int8 tensor larger than the rank's own code block is made, no
broadcast runs over both axes, and the model axis carries fewer bytes
than the whole-leaf update's gathers of the cut params and gradients.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.core import mesh as core_mesh
from repro_torch.core.mesh import local_shape
from repro_torch.launch import dryrun, train
from repro_torch.optim import get_optimizer
from repro_torch.optim.optimizers import _quantize_i8
from repro_torch.runtime import steps
from repro_torch.tree import tree_leaves, tree_map

from test_torch_ranks import (assert_mostly_close, flat, flat_states,
                              result, run_world)

TREE = {"attn": {"wq": {"kernel": (5, 64, 256)},
                 "wo": {"kernel": (5, 256, 64)}},
        "embed": (512, 128),
        "head": (128, 384),
        "final_norm": {"scale": (1280,)},
        "mlp": {"up": {"kernel": (3, 40, 100)},
                "down": {"kernel": (3, 100, 44)}}}
STEPS, LR = 3, 1e-2
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
SHAPES = [(1, 2), (2, 1), (2, 2), (1, 4)]
# rank 0's temp in this CPU's dry-run of qwen3-14b's train_4k cell over
# the 16 x 16 mesh, at most this many times the AdamW cell's
TEMP_RATIO = 2.5


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


def one_process(clip):
    """One process's three updates on the whole tree: (params, state)."""
    opt = get_optimizer("adam8bit", grad_clip=clip)
    params, grads = draws()
    state = opt.init(params)
    for g in grads:
        params, state = opt.update(g, state, params, LR)
    return params, state


def values(q):
    """{leaf/m or v: the moment its codes and scales give}."""
    return {f"{k}/{m}": (v[m + "q"].float() * v[m + "s"]).reshape(-1)
            for k, v in flat_states(q).items() for m in "mv"}


class Int8Sizes(TorchDispatchMode):
    """The largest int8 tensor any operator makes (elements)."""

    def __init__(self):
        super().__init__()
        self.most = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, torch.Tensor) and t.dtype == torch.int8:
                self.most = max(self.most, t.numel())
        return out


# --- the rank side -----------------------------------------------------------

def rank_run(mesh, clip, plant=False):
    """Three block updates on this rank of `mesh`, from the whole draws
    cut to its blocks: the gathered params and state, the local and spec
    shapes of the rank's state, each update's collectives and largest
    int8 tensor, the rank's largest code block, the whole-leaf path's
    collectives (the params, gradients and state gathered whole), and
    whether `init_blocks` at the rank's shapes is the cut of `init`."""
    opt = get_optimizer("adam8bit", grad_clip=clip)
    shapes = meta_state(opt)
    specs = steps.train_state_pspecs(shapes, mesh)
    params, grads = draws()
    whole_init = opt.init(params)
    state = {"params": params, "opt": whole_init}
    state = tree_map(torch.Tensor.clone, steps.cut(
        state, {k: specs[k] for k in state}, mesh))
    blank = opt.init_blocks(tree_map(
        lambda t, s: local_shape(tuple(t.shape), s, mesh),
        shapes["opt"]["q"], specs["opt"]["q"]))
    init_equal = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(blank), tree_leaves(state["opt"])))
    real = steps._max_by_group

    def planted(tensors, keys, mesh):
        # the first leaf whose columns are cut keeps its own block maxima
        out = real(tensors, keys, mesh)
        i = next(i for i in range(0, len(keys), 2) if keys[i])
        out[i], out[i + 1] = tensors[i], tensors[i + 1]
        return out
    if plant:
        steps._max_by_group = planted
    recorded, int8_most = [], []
    try:
        for g in grads:
            g_blocks = steps.cut(g, specs["params"], mesh)
            with core_mesh.record_collectives() as seen, Int8Sizes() as big:
                norm = steps.tp_global_norm(g_blocks, specs["params"], mesh)
                new_p, new_opt = steps.rank_adam8bit_update(
                    opt, g_blocks, state["params"], state["opt"], LR, norm,
                    specs, shapes, mesh)
            recorded.append(seen)
            int8_most.append(big.most)
            state = {"params": new_p, "opt": new_opt}
    finally:
        steps._max_by_group = real
    with core_mesh.record_collectives() as old:
        steps.gather(state["params"], specs["params"], shapes["params"],
                     mesh, ("model",))
        steps.gather(steps.cut(grads[0], specs["params"], mesh),
                     specs["params"], shapes["params"], mesh, ("model",))
        steps.gather(state["opt"], specs["opt"], shapes["opt"], mesh)
    return {
        "params": steps.gather(state["params"], specs["params"],
                               shapes["params"], mesh),
        "opt": steps.gather(state["opt"], specs["opt"], shapes["opt"],
                            mesh),
        "local_shapes": tree_map(lambda t: tuple(t.shape), state["opt"]),
        "spec_shapes": tree_map(lambda t, s: local_shape(tuple(t.shape), s,
                                                         mesh),
                                shapes["opt"], specs["opt"]),
        "collectives": recorded, "int8_most": int8_most,
        "code_block_most": max(t.numel() for t in tree_leaves(state["opt"])
                               if t.dtype == torch.int8),
        "whole_leaf_path": old, "init_equal": init_equal}


def scenario_update(out):
    res = {}
    for shape in MESHES[out["world"]]:
        mesh = train.cli_mesh("host", torch.device("cpu"),
                              model_axis=shape[1])
        res[shape] = {"exact": rank_run(mesh, 0.0),
                      "clipped": rank_run(mesh, 1.0),
                      "planted": rank_run(mesh, 0.0, plant=True)}
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
    return {w: run_world(w, ["update"], tmp_path_factory.mktemp(f"a8{w}"),
                         entry=_rank_entry) for w in (2, 4)}


@pytest.fixture(scope="module")
def want():
    return {0.0: one_process(0.0), 1.0: one_process(1.0)}


def runs(worlds, shape, kind):
    world = shape[0] * shape[1]
    return [result(worlds[world], "update", r)[shape][kind]
            for r in range(world)]


def held(got, params, state):
    """Whether the params and the moments are within the adam8bit bound
    (`assert_mostly_close`) of one process's."""
    try:
        assert_mostly_close(flat(got["params"]), flat(params))
        assert_mostly_close(values(got["opt"]["q"]), values(state["q"]))
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("shape", SHAPES)
def test_block_update_equals_one_process(shape, worlds, want):
    """Three block updates at `shape`, on every rank: with the clip off
    the codes, scales and params bit for bit one process's; with it on
    within the adam8bit bounds; each rank's state its specs' local
    shapes."""
    for got in runs(worlds, shape, "exact"):
        assert got["local_shapes"] == got["spec_shapes"]
        params, state = want[0.0]
        g, w = flat(got["opt"]), flat(state)
        assert g.keys() == w.keys()
        assert not [k for k in g if not torch.equal(g[k], w[k])]
        g, w = flat(got["params"]), flat(params)
        assert not [k for k in g if not torch.equal(g[k], w[k])]
    for got in runs(worlds, shape, "clipped"):
        assert got["local_shapes"] == got["spec_shapes"]
        assert held(got, *want[1.0])


@pytest.mark.parametrize("shape", SHAPES)
def test_a_block_max_left_out_fails_the_bound(shape, worlds, want):
    """The planted fault (one leaf's block maxima not taken over the
    ranks that cut its columns) moves the moments past the bound on some
    rank."""
    assert not all(held(got, *want[0.0])
                   for got in runs(worlds, shape, "planted"))


@pytest.mark.parametrize("shape", SHAPES)
def test_no_whole_leaf_crosses_the_ranks(shape, worlds):
    """No int8 tensor larger than the rank's largest code block is made
    (the whole-leaf path gathered every code leaf), no broadcast runs
    over both axes, and the model axis carries fewer bytes than the
    whole-leaf path's gathers of the cut params and gradients over it:
    the runs of the state's rows, not the leaves."""
    for got in runs(worlds, shape, "exact"):
        old = got["whole_leaf_path"]
        assert max(c["payload_b"] for c in old) > 0
        for seen, most in zip(got["collectives"], got["int8_most"]):
            assert most <= got["code_block_most"]
            assert not [c for c in seen if c["kind"] == "broadcast"
                        and c["axes"] == "data+model"]
            model = sum(c["payload_b"] for c in seen
                        if "model" in c["axes"])
            whole = sum(c["payload_b"] for c in old if c["axes"] == "model")
            assert model < whole or whole == 0 == model, (model, whole)


@pytest.mark.parametrize("shape", SHAPES)
def test_rank_init_is_the_cut_of_init(shape, worlds):
    """`init_blocks` at the rank's block shapes: the codes 0 and scales
    1e-12 of `init`'s leaves' cut, bit for bit."""
    for got in runs(worlds, shape, "exact"):
        assert got["init_equal"]


def test_init_is_the_quantized_zero_leaf():
    """`init` (now made at the shapes, no float32 leaf drawn) equals
    `_quantize_i8` of a zero leaf bit for bit, padding included."""
    params, _ = draws()
    state = get_optimizer("adam8bit").init(params)
    pairs = []
    tree_map(lambda p, leaf: pairs.append((p, leaf)), params, state["q"])
    assert len(pairs) == len(tree_leaves(params))
    for p, leaf in pairs:
        q, s = _quantize_i8(torch.zeros(p.shape))
        for a, b in ((leaf["mq"], q), (leaf["vq"], q), (leaf["ms"], s),
                     (leaf["vs"], s)):
            assert a.dtype == b.dtype and torch.equal(a, b), p.shape


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_whole_blocks_in_one_process_are_the_update(clip):
    """`update_blocks` on the whole [n_blocks, 256] views (the padded
    leaves) with no maximum across ranks and the clip's norm given:
    `update` bit for bit."""
    from repro_torch.optim.optimizers import global_norm
    opt = get_optimizer("adam8bit", grad_clip=clip)
    params, grads = draws()

    def padded(t):
        flat_t = t.reshape(-1)
        return torch.nn.functional.pad(
            flat_t, (0, -flat_t.numel() % 256)).view(-1, 256)
    a, sa = params, opt.init(params)
    b, sb = tree_map(padded, params), opt.init(params)
    groups = tree_map(lambda _: (), TREE)
    for g in grads:
        a, sa = opt.update(g, sa, a, LR)
        b, sb = opt.update_blocks(tree_map(padded, g), sb, b, LR,
                                  norm=global_norm(g), groups=groups,
                                  pmax=lambda ts, ks: ts)
    for k, t in flat(a).items():
        assert torch.equal(flat(b)[k].reshape(-1)[:t.numel()],
                           t.reshape(-1)), k
    assert not [k for k, t in flat(sa).items()
                if not torch.equal(t, flat(sb)[k])]


def test_qwen3_14b_dry_run_temp_against_adamw():
    """This CPU's rank 0 trace of qwen3-14b's train_4k cell over the
    16 x 16 mesh (`launch.dryrun.rank_trace`, meta tensors): adam8bit's
    temp at most TEMP_RATIO times AdamW's, where the whole-leaf update's
    was 25.4 times (367.72 GB against 14.49 GB), and its calls over both
    axes AdamW's (the whole-leaf path made 257)."""
    cfg = get_config("qwen3-14b")
    got = {opt: dryrun.rank_trace(
        cfg, "train", *dryrun.PRODUCTION_MESHES["single"],
        dryrun.input_specs(cfg, "train_4k"), optimizer=opt, flops=False)
        for opt in ("adamw", "adam8bit")}
    assert got["adam8bit"]["mem_temp_b"] \
        <= TEMP_RATIO * got["adamw"]["mem_temp_b"], got
    calls = {opt: g["collective_calls_by_axis"].get("data+model", 0)
             for opt, g in got.items()}
    assert calls["adam8bit"] == calls["adamw"], calls
