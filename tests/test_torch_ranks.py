"""The trainer over a data mesh of ranks (`launch.train` under torchrun:
`launch.mesh.init_ranks`, `runtime.steps`' data-parallel step, the
ZeRO-1 moments, `core.mesh`'s collectives), held against the port's
one-process run and the reference's trainer loop.

Ranks are spawned with `torch.multiprocessing` over gloo and a
`FileStore` in `tmp_path` (a module fixture starts each world once and
runs every scenario of it; each scenario's results go back to the parent
in a file), and one test starts the CLI with torchrun itself.

Bounds, each measured on a CPU first:
  * W = 1 under a process group: bit for bit the run without one.
  * float32 configs (the smoke configs with dtype float32), W = 2 and 4
    against one process: losses and metrics rtol F32_RTOL, parameters
    and moments F32_PARAM_ATOL / F32_PARAM_RTOL.  The ranks sum the same
    float32 gradients in another order (about 1e-7 relative), and
    AdamW's first steps move every element by about lr whatever its
    gradient's size, so an element whose gradient is within that noise of
    zero may move the other way (2 lr); the bound leaves room for that.
  * adam8bit: the same bounds but for INT8_FLIP_SHARE of each leaf's
    elements (measured: 5 of 65,536), where an int8 code of a moment
    rounds the other way and moves its element far.
  * the MoE (deepseek-v3 smoke, float32): the aux losses and the loss
    rtol F32_RTOL, the summed router gradients AUX_GRAD_RTOL (relative
    L2); a per-rank or a W-fold aux is 10 % off or more.
  * the bfloat16 smoke configs (the CLI's own): against the reference
    trainer's loop `test_torch_train_families.CLI_LOSS_RTOL` (1e-3)
    over its three steps; the torchrun CLI against one process
    BF16_LOSS_RTOL: bfloat16 rounds each rank's partial weight gradients
    (measured: 2e-3 relative of the summed gradient, 2e-4 of the
    loss after three steps).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.configs import get_smoke_config
from repro_torch.core.mesh import (NamedSharding, PartitionSpec,
                                   local_block, local_shape,
                                   make_named_mesh)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.optim import get_optimizer
from repro_torch.runtime import steps
from repro_torch.runtime.ft import HeartbeatMonitor
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

F32_RTOL = 1e-5
F32_PARAM_ATOL, F32_PARAM_RTOL = 1e-3, 1e-4
AUX_GRAD_RTOL = 1e-4
INT8_FLIP_SHARE = 1e-3
BF16_LOSS_RTOL = 1e-3
REF_LOSS_RTOL = 1e-3            # test_torch_train_families.CLI_LOSS_RTOL
SPAWN_TIMEOUT_S = 120

SMALL = ["--smoke-config", "--device", "cpu", "--batch", "4", "--seq",
         "32", "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
REF_CLI = ["--arch", "drim-bnn", "--smoke-config", "--steps", "3",
           "--batch", "2", "--seq", "32", "--log-every", "1", "--lr",
           "3e-3", "--warmup", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- helpers both sides share -----------------------------------------------

@contextlib.contextmanager
def float32_configs():
    """`train.build_cfg` with the activations in float32."""
    inner = train.build_cfg
    train.build_cfg = lambda args: inner(args).replace(dtype="float32")
    try:
        yield
    finally:
        train.build_cfg = inner


@contextlib.contextmanager
def recorded_states():
    """`train.build` whose step records each new state: yields a list
    that holds the states the trainer stepped to, in order."""
    inner, seen = train.build, []

    def spy(args, mesh=None):
        cfg, step_fn, init_state = inner(args, mesh)

        def step(state, batch):
            new, metrics = step_fn(state, batch)
            seen.append(new)
            return new, metrics
        return cfg, step, init_state
    train.build = spy
    try:
        yield seen
    finally:
        train.build = inner


def main_lines(argv):
    """(final loss, the JSON lines `train.main(argv)` printed)."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        final = train.main(argv)
    return final, [json.loads(line) for line in text.getvalue().splitlines()
                   if line.startswith("{")]


def step_losses(lines):
    return [line["loss"] for line in lines if "step" in line]


def flat(tree):
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, t), tree)
    return out


def batches(cfg, n, batch=4, seq=32):
    data = SyntheticLM(cfg.vocab_size, seq, batch, seed=0)
    return [train.batch_at(data, cfg, i, 0, "cpu") for i in range(n)]


def uneven_batch(cfg):
    """A global batch of 4 rows whose -1 labels fall unevenly on the two
    ranks and on the two microbatches of accum 2."""
    b = batches(cfg, 1)[0]
    labels = b["labels"].clone()
    labels[1, 3:] = -1          # rank 0's second row at accum 1
    labels[3, :20] = -1         # rank 1's row of microbatch 1 at accum 2
    labels[2, 30:] = -1
    return {**b, "labels": labels}


def step_run(arch, optimizer, n_steps, mesh, *, compress=False, accum=1,
             batch_list=None):
    """`make_train_step` over `mesh` (None: one process) for n_steps on
    the float32 smoke config: (metrics per step, final state, specs)."""
    cfg = get_smoke_config(arch).replace(dtype="float32")
    step_fn, init_state, opt = steps.make_train_step(
        cfg, mesh, optimizer_name=optimizer, peak_lr=3e-3, warmup=1,
        total_steps=10, accum=accum, compress=compress)
    state = init_state(0, device="cpu")
    specs = None
    if mesh is not None:
        specs, shapes = steps.state_pspecs(cfg, opt, mesh, compress)
        state = steps.place(state, tree_map(
            lambda s: NamedSharding(mesh, s), specs), shapes)
    metrics = []
    for b in (batch_list or batches(cfg, n_steps)):
        state, m = step_fn(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state, specs


def moe_grads(mesh):
    """(loss, metrics, grads) of the deepseek-v3 float32 smoke config's
    train loss over a global batch of 4 (over `mesh`: the rank's rows,
    gradients summed over the ranks)."""
    cfg = get_smoke_config("deepseek-v3-671b").replace(dtype="float32")
    params = steps.make_train_state(0, cfg, get_optimizer("adamw"),
                                    device="cpu")["params"]
    b = batches(cfg, 1)[0]
    if mesh is None:
        return steps._loss_and_grads(cfg, params, b)
    with mesh:
        loss, metrics, g = steps._loss_and_grads(
            cfg, params, steps.rank_rows(b, mesh)[0])
    return loss, metrics, steps._sum_tree(g, mesh)


# --- the rank side -----------------------------------------------------------

def scenario_cli_w1(out):
    """W = 1: the bfloat16 CLI with a checkpoint."""
    final, lines = main_lines(["--arch", "drim-bnn", *SMALL, "--steps", "3",
                               "--ckpt-dir", out["dir"] + "/w1"])
    return {"final": final, "lines": lines}


def scenario_cli_f32(out):
    """The float32 CLI, 3 steps, checkpoint at the end."""
    with float32_configs():
        final, lines = main_lines(["--arch", "drim-bnn", *SMALL, "--steps",
                                   "3", "--ckpt-dir",
                                   out["dir"] + f"/f32_{out['world']}"])
    return {"final": final, "lines": lines}


def scenario_reference(out):
    """The bfloat16 CLI from the reference trainer's initial state."""
    state_np = torch.load(out["dir"] + "/ref_state.pt", weights_only=False)
    inner = train.build

    def from_reference(args, mesh=None):
        cfg, step_fn, _ = inner(args, mesh)
        return cfg, step_fn, lambda seed, device=None: \
            steps.train_state_from_jax(state_np, cfg, device=device)
    train.build = from_reference
    try:
        final, lines = main_lines(REF_CLI + ["--device", "cpu"])
    finally:
        train.build = inner
    return {"losses": step_losses(lines)}


def scenario_restart(out):
    """4 straight steps, and 2 + a restart + 2, both checkpointing; the
    ranks' own states at steps 2 and 4 of the straight run."""
    argv = ["--arch", "drim-bnn", *SMALL, "--steps", "4", "--ckpt-every",
            "2"]
    with recorded_states() as seen:
        main_lines(argv + ["--ckpt-dir", out["dir"] + "/straight"])
    main_lines(["--arch", "drim-bnn", *SMALL, "--steps", "2",
                "--ckpt-dir", out["dir"] + "/resumed"])
    _, lines = main_lines(argv + ["--ckpt-dir", out["dir"] + "/resumed",
                                  "--resume"])
    return {"local": {2: seen[1], 4: seen[3]}, "resumed_lines": lines}


def scenario_uneven(out):
    mesh = train.cli_mesh("host", torch.device("cpu"))
    cfg = get_smoke_config("drim-bnn").replace(dtype="float32")
    res = {}
    for accum in (1, 2):
        m, state, _ = step_run("drim-bnn", "adamw", 1, mesh, accum=accum,
                               batch_list=[uneven_batch(cfg)])
        res[accum] = {"metrics": m, "params": state["params"]}
    return res


def scenario_moe(out):
    mesh = train.cli_mesh("host", torch.device("cpu"))
    loss, metrics, grads = moe_grads(mesh)
    # this rank's own aux (its counts and tokens only), for the check
    # that a per-rank aux would fail the bound
    cfg = get_smoke_config("deepseek-v3-671b").replace(dtype="float32")
    params = steps.make_train_state(0, cfg, get_optimizer("adamw"),
                                    device="cpu")["params"]
    own = steps.rank_rows(batches(cfg, 1)[0], mesh)[0]
    with torch.no_grad():
        _, own_metrics = steps.train_loss(params, cfg, own)
    return {"loss": loss, "metrics": metrics, "grads": grads,
            "own_aux_lb": own_metrics["aux_lb"]}


def scenario_optimizers(out):
    mesh = train.cli_mesh("host", torch.device("cpu"))
    res = {}
    for name, opt, compress in (("adafactor", "adafactor", False),
                                ("adam8bit", "adam8bit", False),
                                ("compress", "adamw", True)):
        m, state, specs = step_run("drim-bnn", opt, 2, mesh,
                                   compress=compress)
        cfg = get_smoke_config("drim-bnn").replace(dtype="float32")
        shapes = steps.state_pspecs(cfg, get_optimizer(opt), mesh,
                                    compress)[1]
        local = {k: state[k] for k in ("opt", "errors") if k in state}
        want = tree_map(lambda t, s: local_shape(tuple(t.shape), s,
                                                       mesh),
                        {k: shapes[k] for k in local},
                        {k: specs[k] for k in local})
        gathered = steps.gather(state["opt"], specs["opt"], shapes["opt"],
                                mesh)
        res[name] = {"metrics": m, "params": state["params"],
                     "local_shapes": tree_map(lambda t: tuple(t.shape),
                                              local),
                     "spec_shapes": want, "opt": gathered,
                     "errors": (steps.gather(state["errors"],
                                             specs["errors"],
                                             shapes["errors"], mesh)
                                if compress else None)}
    return res


def scenario_hosts(out):
    """A Checkpointer save by both ranks, each writing its share."""
    from repro_torch.core.mesh import mesh_barrier
    mesh = train.cli_mesh("host", torch.device("cpu"))
    state = {"a": torch.arange(6.0), "d": torch.full((2,), -0.0),
             "b": {"c": torch.ones(3, dtype=torch.int32)}}
    ck = Checkpointer(out["dir"] + "/hosts", host_id=mesh.rank, n_hosts=2,
                      barrier=lambda: mesh_barrier(mesh))
    ck.save(5, state)
    ck.wait()
    return {"state": state, "latest": ck.latest_step(),
            "restored": ck.restore(5, state, device="cpu")}


def scenario_refusals(out):
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve
    said = {}
    for name, call in (
            ("serve", lambda: serve.main(["--arch", "drim-bnn",
                                          "--smoke-config", "--device",
                                          "cpu", "--prompt-len", "16",
                                          "--gen", "2"])),
            ("moe_serve", lambda: serve.main([
                "--arch", "deepseek-v3-671b", "--smoke-config", "--device",
                "cpu", "--model-axis", "2"])),
            ("model_axis", lambda: lmesh.make_host_mesh(model_axis=2,
                                                        kind="cpu")),
            ("model_axis_3", lambda: lmesh.make_host_mesh(model_axis=3,
                                                          kind="cpu")),
            ("single", lambda: train.cli_mesh("single",
                                              torch.device("cpu"))),
            ("no_card", lambda: lmesh.make_host_mesh())):
        try:
            got = call()
            if hasattr(got, "devices"):       # a mesh: its devices
                said[name] = ("ran", got.devices.shape,
                              str(got.devices.flat[0]))
            else:
                said[name] = ("ran", tuple(getattr(got, "shape", ())))
        except (ValueError, RuntimeError) as err:
            said[name] = f"{type(err).__name__}: {err}"
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
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def run_world(world, names, tmp, entry=None, timeout=SPAWN_TIMEOUT_S):
    """Spawn `world` gloo ranks running the named scenarios (`entry`, a
    module's `_rank_entry`, default this one's); returns each rank's
    {scenario: results}."""
    os.makedirs(tmp, exist_ok=True)
    store = tmp / f"store{world}"
    if store.exists():
        store.unlink()
    ctx = mp.start_processes(entry or _rank_entry,
                             args=(world, str(store), str(tmp), names),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {world}-rank world took over "
                                     f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def result(ranks, name, rank=0):
    got = ranks[rank][name]
    if isinstance(got, dict) and "error" in got:
        raise AssertionError(f"rank {rank}, {name}:\n{got['error']}")
    return got


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
def reference(jref, tmp_path_factory):
    """The reference trainer's loop (no mesh) for REF_CLI: its initial
    state, saved for the ranks, and each step's metrics."""
    from test_torch_train_families import reference_cli_run
    state_np, metrics = reference_cli_run(jref, REF_CLI)
    tmp = tmp_path_factory.mktemp("ranks_ref")
    torch.save(state_np, tmp / "ref_state.pt")
    return tmp, metrics


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_w1")
    return tmp, run_world(1, ["cli_w1"], tmp)


@pytest.fixture(scope="module")
def world2(reference, tmp_path_factory):
    tmp = reference[0]
    names = ["cli_f32", "reference", "restart", "uneven", "moe",
             "optimizers", "hosts", "refusals"]
    return tmp, run_world(2, names, tmp)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks_w4")
    return tmp, run_world(4, ["cli_f32"], tmp)


def rank_mesh_here(world):
    """The trainer's (W, 1) mesh of ranks, built here without a group
    (for `local_block` of a given rank)."""
    mesh = make_named_mesh((world, 1), ("data", "model"),
                           [torch.device("cpu")] * world)
    return dataclasses.replace(
        mesh, ranks=np.arange(world).reshape(world, 1))


def restore(path, arch="drim-bnn", optimizer="adamw", step=None):
    cfg = get_smoke_config(arch)
    like = steps.abstract_train_state(cfg, get_optimizer(optimizer))
    ck = Checkpointer(path)
    return ck.restore(step if step is not None else ck.latest_step(), like,
                      device="cpu")


def assert_trees_close(got, want, atol, rtol):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for k in g:
        np.testing.assert_allclose(g[k].float().numpy(),
                                   w[k].float().numpy(), atol=atol,
                                   rtol=rtol, err_msg=k)


def assert_trees_equal(got, want):
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    differ = [k for k in g if not torch.equal(g[k], w[k])]
    assert not differ, differ[:5]


# --- one rank ----------------------------------------------------------------

def test_one_rank_under_a_group_is_the_plain_run_bit_for_bit(world1,
                                                              tmp_path):
    tmp, ranks = world1
    got = result(ranks, "cli_w1")
    final, lines = main_lines(["--arch", "drim-bnn", *SMALL, "--steps", "3",
                               "--ckpt-dir", str(tmp_path / "plain")])
    rank_line = got["lines"][0]
    assert rank_line == {"rank": 0, "world_size": 1, "backend": "gloo",
                         "device": "cpu"}
    drop = ("s_per_step", "wall_s")
    assert [{k: v for k, v in line.items() if k not in drop}
            for line in got["lines"][1:]] == \
        [{k: v for k, v in line.items() if k not in drop} for line in lines]
    assert got["final"] == final
    assert_trees_equal(restore(tmp / "w1"), restore(tmp_path / "plain"))


# --- two and four ranks, float32 ---------------------------------------------

def one_process_f32(tmp_path):
    argv = ["--arch", "drim-bnn", *SMALL, "--steps", "3", "--ckpt-dir",
            str(tmp_path / "one")]
    with float32_configs():
        return main_lines(argv)


@pytest.mark.parametrize("world", [2, 4])
def test_adamw_ranks_equal_one_process(world, world2, world4, tmp_path):
    tmp, ranks = {2: world2, 4: world4}[world]
    got = result(ranks, "cli_f32")
    final, lines = one_process_f32(tmp_path)
    assert got["lines"][0]["world_size"] == world
    assert got["lines"][0]["backend"] == "gloo"
    want = [ln for ln in lines if "step" in ln]
    have = [ln for ln in got["lines"] if "step" in ln]
    assert len(have) == len(want) == 3
    for h, w in zip(have, want):
        for key in ("loss", "ce", "grad_norm", "lr", "ntokens"):
            np.testing.assert_allclose(h[key], w[key], rtol=F32_RTOL,
                                       err_msg=key)
    np.testing.assert_allclose(got["final"], final, rtol=F32_RTOL)
    # every rank printed its first line, rank 0 alone the rest
    for r in range(1, world):
        assert [ln.keys() for ln in result(ranks, "cli_f32", r)["lines"]] \
            == [{"rank", "world_size", "backend", "device"}]
    assert_trees_close(restore(tmp / f"f32_{world}"),
                       restore(tmp_path / "one"), F32_PARAM_ATOL,
                       F32_PARAM_RTOL)


def test_two_ranks_equal_the_reference_trainer(world2, reference):
    _, want = reference
    got = result(world2[1], "reference")["losses"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w["loss"], rtol=REF_LOSS_RTOL)
    assert got[-1] < got[0]


def test_torchrun_cli_trains_on_two_gloo_ranks(tmp_path):
    """The CLI as a user starts it: rank 0 alone prints the steps, every
    rank its first line, and the losses are one process's within the
    bfloat16 bound."""
    argv = ["--arch", "drim-bnn", *SMALL, "--steps", "3"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(
                   os.path.dirname(os.path.dirname(__file__)), "src"),
                   os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    # the ranks share the stream: their lines may run into each other
    lines = [json.loads(obj) for obj in re.findall(r"\{[^{}]*\}",
                                                   proc.stdout)]
    firsts = [ln for ln in lines if "rank" in ln]
    assert sorted(ln["rank"] for ln in firsts) == [0, 1]
    assert {ln["backend"] for ln in firsts} == {"gloo"}
    got = [ln["loss"] for ln in lines if "step" in ln]
    _, plain = main_lines(argv)
    want = step_losses(plain)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=BF16_LOSS_RTOL)
    assert [ln["final_loss"] for ln in lines if "final_loss" in ln] \
        == [pytest.approx(got[-1], rel=1e-4)]


# --- the global formula ------------------------------------------------------

@pytest.mark.parametrize("accum", [1, 2])
def test_uneven_masks_take_the_global_ce(accum, world2):
    got = result(world2[1], "uneven")[accum]
    cfg = get_smoke_config("drim-bnn").replace(dtype="float32")
    b = uneven_batch(cfg)
    want_m, want_state, _ = step_run("drim-bnn", "adamw", 1, None,
                                     accum=accum, batch_list=[b])
    for key in ("ce", "loss", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][0][key],
                                   want_m[0][key], rtol=F32_RTOL,
                                   err_msg=key)
    assert_trees_close(got["params"], want_state["params"],
                       F32_PARAM_ATOL, F32_PARAM_RTOL)
    # the mean of the ranks' (or microbatches') own CEs is another
    # number: the masks fall unevenly, so the test tells them apart
    params = steps.make_train_state(0, cfg, get_optimizer("adamw"),
                                    device="cpu")["params"]
    with torch.no_grad():
        own = [float(steps.train_loss(params, cfg, {
            k: v[i:i + 1] for k, v in b.items()})[1]["ce"]) for i in range(4)]
    naive = sum(own) / 4
    assert abs(naive - got["metrics"][0]["ce"]) > 100 * F32_RTOL * naive


def test_moe_aux_is_counted_once(world2):
    """deepseek-v3 (smoke, float32) at W = 2: aux_lb, aux_z, the loss and
    the router gradients equal the one-process step's."""
    r0 = result(world2[1], "moe", 0)
    r1 = result(world2[1], "moe", 1)
    loss, metrics, grads = moe_grads(None)
    for got in (r0, r1):
        np.testing.assert_allclose(float(got["loss"]), float(loss),
                                   rtol=F32_RTOL)
        for key in ("aux_lb", "aux_z", "ce", "ntokens"):
            np.testing.assert_allclose(float(got["metrics"][key]),
                                       float(metrics[key]), rtol=F32_RTOL,
                                       err_msg=key)
    assert torch.equal(r0["metrics"]["aux_lb"], r1["metrics"]["aux_lb"])
    want = {k: v for k, v in flat(grads).items() if "router" in k}
    have = {k: v for k, v in flat(r0["grads"]).items() if "router" in k}
    assert want and have.keys() == want.keys()
    for k in want:
        err = float((have[k] - want[k]).norm() / want[k].norm())
        assert err < AUX_GRAD_RTOL, (k, err)
    # a per-rank aux (each rank's own counts and tokens) is another
    # number, and a W-fold aux gradient (the aux terms counted twice)
    # moves the router gradients past the bound
    own = float(r0["own_aux_lb"])
    assert abs(own - float(metrics["aux_lb"])) > 1e-3 * abs(own)
    from repro_torch.models import transformer
    lb, z = transformer.LB_COEF, transformer.Z_COEF
    transformer.LB_COEF, transformer.Z_COEF = 2 * lb, 2 * z
    try:
        twice = flat(moe_grads(None)[2])
    finally:
        transformer.LB_COEF, transformer.Z_COEF = lb, z
    worst = max(float((twice[k] - want[k]).norm() / want[k].norm())
                for k in want)
    assert worst > 10 * AUX_GRAD_RTOL


# --- ZeRO-1 state ------------------------------------------------------------

@pytest.mark.parametrize("name", ["adafactor", "adam8bit", "compress"])
def test_zero1_optimizers_equal_one_process(name, world2):
    opt = {"compress": "adamw"}.get(name, name)
    compress = name == "compress"
    want_m, want_state, _ = step_run("drim-bnn", opt, 2, None,
                                     compress=compress)
    for rank in (0, 1):
        got = result(world2[1], "optimizers", rank)[name]
        assert got["local_shapes"] == got["spec_shapes"]
        for g, w in zip(got["metrics"], want_m):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=F32_RTOL,
                                           err_msg=key)
        if opt == "adam8bit":
            # an int8 code that rounds the other way moves its element
            # far (a second moment coded 0 divides by eps): a few
            # elements a leaf, the others within the float32 bound
            def values(q):
                return {f"{k}/{m}": (v[m + "q"].float() * v[m + "s"])
                        .reshape(-1)
                        for k, v in flat_states(q).items() for m in "mv"}
            assert_mostly_close(flat(got["params"]),
                                flat(want_state["params"]))
            assert_mostly_close(values(got["opt"]["q"]),
                                values(want_state["opt"]["q"]))
            continue
        assert_trees_close(got["params"], want_state["params"],
                           F32_PARAM_ATOL, F32_PARAM_RTOL)
        assert_trees_close(got["opt"], want_state["opt"],
                           F32_PARAM_ATOL, F32_PARAM_RTOL)
        if compress:
            assert_trees_close(got["errors"], want_state["errors"],
                               F32_PARAM_ATOL, F32_PARAM_RTOL)
    moments = flat(result(world2[1], "optimizers", 0)[name]["local_shapes"])
    whole = flat(tree_map(lambda t: tuple(t.shape), {
        k: want_state[k] for k in ("opt", "errors") if k in want_state}))
    assert any(moments[k] != whole[k] for k in moments), \
        "ZeRO-1 cut no leaf"


def assert_mostly_close(have, want):
    """Each leaf within the float32 bound but for INT8_FLIP_SHARE of its
    elements."""
    assert have.keys() == want.keys()
    for k in want:
        h, w = have[k].float(), want[k].float()
        off = ~torch.isclose(h, w, rtol=F32_PARAM_RTOL, atol=F32_PARAM_ATOL)
        assert off.float().mean() <= INT8_FLIP_SHARE, (k, int(off.sum()))


def flat_states(tree, prefix=""):
    """{param path: its adam8bit state dict}."""
    if "mq" in tree:
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(flat_states(v, f"{prefix}/{k}"))
    return out


# --- checkpoints and heartbeats ----------------------------------------------

def test_two_rank_checkpoint_restores_in_one_process(world2):
    tmp, ranks = world2
    got = [result(ranks, "restart", r) for r in range(2)]
    whole = restore(tmp / "straight", step=4)
    mesh = rank_mesh_here(2)
    cfg = get_smoke_config("drim-bnn")
    specs = steps.state_pspecs(cfg, get_optimizer("adamw"), mesh)[0]
    for r in range(2):
        cut = tree_map(lambda t, s: t[local_block(tuple(t.shape), s, mesh, r)],
                       whole, specs)
        assert_trees_equal(got[r]["local"][4], cut)
    manifest = json.load(open(tmp / "straight" / "step_000000004" /
                              "manifest.json"))
    assert manifest["n_hosts"] == 1
    assert len(manifest["leaves"]) == len(tree_leaves(whole))


def test_two_rank_restart_equals_the_straight_run(world2):
    tmp, ranks = world2
    resumed = result(ranks, "restart")["resumed_lines"]
    assert [ln["step"] for ln in resumed if "step" in ln] == [3, 4]
    assert_trees_equal(restore(tmp / "resumed", step=4),
                       restore(tmp / "straight", step=4))


def test_heartbeats_show_every_rank(world2):
    tmp, _ = world2
    table = HeartbeatMonitor(str(tmp / "straight" / "heartbeats.jsonl"),
                             host_id=0).table()
    assert sorted(table) == [0, 1]
    assert {h.last_step for h in table.values()} == {3}


def test_a_save_by_two_hosts_is_published_once(world2):
    """Checkpointer(host_id=rank, n_hosts=2, barrier=...): each rank
    writes its share of the leaves, rank 0 publishes the step (a manifest
    of every leaf) once, after a barrier, and both read it back."""
    tmp, ranks = world2
    for r in range(2):
        got = result(ranks, "hosts", r)
        assert got["latest"] == 5
        assert_trees_equal(got["restored"], got["state"])
    d = tmp / "hosts" / "step_000000005"
    manifest = json.load(open(d / "manifest.json"))
    assert manifest["n_hosts"] == 2 and manifest["step"] == 5
    assert sorted(manifest["leaves"]) == ["a", "b/c", "d"]
    assert sorted(os.listdir(d)) == ["a.npy", "b__c.npy", "d.npy",
                                     "manifest.json"]
    assert not [p for p in os.listdir(tmp / "hosts") if p.endswith(".tmp")]


# --- refusals ----------------------------------------------------------------

def test_serve_and_model_axes_refuse_ranks(world2):
    """Over 2 ranks the dense family serves (on the (2, 1) mesh), the
    (1, 2) mesh exists and a MoE serve under a model axis of 2 runs; the
    production mesh raises, naming the device count."""
    said = result(world2[1], "refusals")
    assert said["serve"] == ("ran", (4, 2))
    assert said["model_axis"] == ("ran", (1, 2), "cpu")
    assert said["model_axis_3"] == ("ValueError: model_axis=3 does not "
                                    "divide 2 ranks")
    assert said["moe_serve"] == ("ran", (4, 16))
    assert "needs 256 devices" in said["single"]


def test_host_mesh_under_ranks_without_a_card_raises(world2):
    """Under a gloo group on the CPU, with no card visible, the host mesh
    of the ranks raises, naming the missing card: the CPU is used only
    where the caller asks for it (`kind="cpu"`, or explicit devices)."""
    said = result(world2[1], "refusals")["no_card"]
    assert said.startswith("RuntimeError: no CUDA device is available"), \
        said


def test_place_without_a_group_refuses_distinct_devices():
    two = make_named_mesh((2, 1), ("data", "model"),
                          [torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="process per device"):
        steps.place({"w": torch.ones(4)},
                    {"w": NamedSharding(two, PartitionSpec("data"))})


def test_rank_probe_on_the_cpu():
    """`launch.rank_probe` (the card's gloo and NCCL probe) on CPU
    tensors: both ranks run every collective and sum right."""
    from repro_torch.launch import rank_probe
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        lines = rank_probe.main(["--device", "cpu", "--mb", "1",
                                 "--timeout", "100"])
    assert [json.loads(line) for line in text.getvalue().splitlines()] \
        == lines
    assert [(ln["backend"], ln["rank"]) for ln in lines] == [("gloo", 0),
                                                            ("gloo", 1)]
    for ln in lines:
        assert set(ln["ops"].values()) == {"ok"}
        assert ln["sum"] == [3.0, 3.0, 3.0]
        assert ln["reduce_scatter"] == [[3.0, 5.0], [7.0, 9.0]][ln["rank"]]
        assert len(ln["all_reduce_s"]["1"]) == 3
        assert len(ln["broadcast_s"]["1"]) == 2
        assert len(ln["reduce_scatter_s"]["1"]) == 3
