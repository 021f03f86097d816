"""The serve and train CLIs under `--mesh`, on the smoke configs with
`--device cpu`.

  * `--mesh host` (the default, a 1x1 mesh of the CPU) serves drim-bnn's
    tokens and trains its losses exactly as the same code run with no
    mesh in context, and as the reference's CLI with its weights carried
    over.
  * deepseek-v3's smoke config: under `--mesh host` the port's prefill
    takes the expert-parallel dispatch (a spy counts it) and serves the
    reference CLI's greedy tokens under the reference's own default
    `--mesh host`.
  * `--mesh single` and `--mesh multi` raise the production mesh's
    ValueError in both CLIs, before any weight is drawn.
"""
import json
import time
import types

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.launch import batching, serve, train
from repro_torch.models import moe
from repro_torch.runtime import steps

CPU = ["--device", "cpu"]
SERVE = ["--smoke-config", "--batch", "2", "--prompt-len", "16", "--gen",
         "5"]
TRAIN = ["--smoke-config", "--batch", "2", "--seq", "32", "--steps", "3",
         "--log-every", "1", "--warmup", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    import jax

    from repro import models as jmodels
    from repro.launch import serve as jserve
    return types.SimpleNamespace(jax=jax, models=jmodels, serve=jserve)


def ref_weights(jref, args):
    """The reference CLI's seeded weights (as the port's tree) and
    prompts for `args`."""
    key = jref.jax.random.PRNGKey(args.seed)
    cfg = serve.build_cfg(args)
    pj = jref.models.init_params(key, jref.serve.build_cfg(args))
    toks = jref.jax.random.randint(jref.jax.random.fold_in(key, 1),
                                   (args.batch, args.prompt_len), 0,
                                   cfg.vocab_size)
    return (models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), cfg,
                               device="cpu"), np.asarray(toks))


def ref_serve_host_arrays(jref, argv):
    """The reference CLI's `run_serve` with the arrays its expert-parallel
    prefill returns fetched to the host before they reach `splice_caches`
    and each decode step.  Under jax 0.9 they carry an explicit ("data",
    "model") sharding that the reference's unsharded splice and its
    decode gather refuse (ShardingTypeError; the reference pins jax 0.4).
    The values are the CLI's own: prefill (expert-parallel) and decode
    run as the CLI runs them, under its default `--mesh host`."""
    jserve = jref.serve
    splice, make_decode = jserve.splice_caches, jserve.make_decode_fn

    def on_host(tree):
        return jref.jax.tree.map(np.asarray, tree)

    def host_splice(empty, pre):
        return splice(empty, on_host(pre))

    def host_decode_fn(*a, **kw):
        dec = make_decode(*a, **kw)
        return lambda *args: dec(*on_host(args))
    jserve.splice_caches, jserve.make_decode_fn = host_splice, host_decode_fn
    try:
        return jserve.run_serve(jserve.parse_args(argv))
    finally:
        jserve.splice_caches, jserve.make_decode_fn = splice, make_decode


def test_serve_cli_under_mesh(jref):
    argv = ["--arch", "drim-bnn"] + SERVE
    args = serve.parse_args(argv + CPU)
    assert args.mesh == "host"
    got, _ = serve.run_serve(args)
    # the same serving loop with no mesh in context
    cfg = serve.build_cfg(args)
    bare, _ = serve._serve(args, cfg, torch.device("cpu"), None, None,
                           batching.make_decode_fn, time.sleep)
    np.testing.assert_array_equal(got, bare)
    # the reference CLI's tokens, its weights carried over
    want, _ = jref.serve.run_serve(jref.serve.parse_args(argv))
    params, toks = ref_weights(jref, args)
    got, _ = serve.run_serve(args, params=params, tokens=toks)
    np.testing.assert_array_equal(got, np.asarray(want))

    # deepseek-v3: EP in the port's prefill, the reference's tokens
    argv = ["--arch", "deepseek-v3-671b"] + SERVE
    want, _ = ref_serve_host_arrays(jref, argv)
    args = serve.parse_args(argv + CPU)
    params, toks = ref_weights(jref, args)
    calls = []
    inner = moe._ep_shard_map

    def spy(*a):
        calls.append(dict(a[-1].shape))
        return inner(*a)
    moe._ep_shard_map = spy
    try:
        got, _ = serve.run_serve(args, params=params, tokens=toks)
    finally:
        moe._ep_shard_map = inner
    cfg = serve.build_cfg(args)
    assert calls == [{"data": 1, "model": 1}] * cfg.n_layers
    np.testing.assert_array_equal(got, np.asarray(want))

    for kind, n in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            serve.main(argv + CPU + ["--mesh", kind])
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            serve.run_microbench(serve.parse_args(argv + CPU
                                                  + ["--mesh", kind]))


def test_train_cli_under_mesh(capsys):
    """drim-bnn: the losses of `--mesh host` (the state placed on its
    ZeRO-1 shardings over a 1x1 mesh) equal the step loop's with no mesh
    and an unplaced state, bit for bit; single and multi raise."""
    argv = TRAIN + CPU
    final = train.main(argv + ["--mesh", "host"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    logged = [x["loss"] for x in lines if "step" in x]

    args = train.parse_args(argv)
    cfg = train.build_cfg(args)
    step_fn, init_state, _ = steps.make_train_step(
        cfg, optimizer_name=args.optimizer, peak_lr=args.lr, warmup=1,
        total_steps=args.steps)
    state = init_state(args.seed, device="cpu")
    data = train.SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                             seed=args.seed)
    losses = []
    for step in range(args.steps):
        state, m = step_fn(state, train.batch_at(data, cfg, step, args.seed,
                                                 torch.device("cpu")))
        losses.append(float(m["loss"]))
    assert final == losses[-1]
    assert logged == [round(x, 4) for x in losses]

    mesh = train.cli_mesh("host", torch.device("cpu"))
    assert mesh.shape == {"data": 1, "model": 1}
    sh = train.shardings(args, cfg, mesh)
    assert all(s.mesh is mesh for s in _flat(sh))
    for kind, n in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            train.main(argv + ["--mesh", kind])


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


def test_place_refuses_a_mesh_of_distinct_devices():
    from repro_torch.core.mesh import NamedSharding, PartitionSpec
    from repro_torch.core.mesh import make_named_mesh
    one = make_named_mesh((2, 1), ("data", "model"),
                          [torch.device("cpu")] * 2)
    t = {"w": torch.ones(4)}
    placed = steps.place(t, {"w": NamedSharding(one, PartitionSpec())})
    assert torch.equal(placed["w"], t["w"])
    two = make_named_mesh((2, 1), ("data", "model"),
                          [torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="ROADMAP Queue 1"):
        steps.place(t, {"w": NamedSharding(two, PartitionSpec("data"))})


def test_host_mesh_is_the_cli_device_alone(monkeypatch):
    """With two cards visible, `--mesh host` is still a 1x1 mesh over the
    CLI's device (an LM mesh of distinct devices needs a process per
    device), and the trainer runs with its default mesh."""
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import mesh as lmesh
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(core_mesh, "visible_devices", lambda: two)
    monkeypatch.setattr(lmesh, "visible_devices", lambda: two)
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        mesh = lmesh.cli_mesh("host", dev)
        assert mesh.shape == {"data": 1, "model": 1}
        assert list(mesh.devices.flat) == [dev]
    for kind, n in (("single", 256), ("multi", 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices, 2 exist"):
            lmesh.cli_mesh(kind, torch.device("cuda", 0))
    assert np.isfinite(train.main(TRAIN + CPU))
