"""The port's training path held against the JAX reference on the CPU:
`train_loss` and its gradients, the optimizers, LR schedules, 1-bit
gradient compression, data pipeline, checkpoints, train step, fault-
tolerance helpers and the `launch.train` CLI.  Inputs are made from seeds
with numpy and handed to both packages; weights and optimizer states are
carried across with `lm_from_jax` / `train_state_from_jax`.

Tolerances (float32 smoke config, `dtype` and `param_dtype` float32):
  * train_loss with bitlinear="none": loss at rtol 1e-6, each gradient
    leaf within 1e-5 relative L2 (the two frameworks sum float32 in other
    orders; measured ~1e-6).
  * bitlinear="ffn": the whole gradient within 1e-4 relative L2.  The
    STE product is float32 in both here, but a sign of an activation
    within float32 noise of 0 may flip between the frameworks and move
    the entries of one row; with this seed none does (measured ~5e-7).
  * optimizer updates from identical params, grads and state: float32
    rounding, rtol 1e-5 plus 1e-6 of the leaf's largest magnitude (XLA
    fuses multiply-adds that torch rounds twice); adam8bit's int8 moments
    may differ by 1 only where the quantizer's input lies at a rounding
    tie, and the test counts those.
  * data batches, checkpoints and restarts: bit for bit.
"""
import json
import os
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.data import pipeline
from repro_torch.launch import train
from repro_torch.models import transformer
from repro_torch.optim import (compress, compress_grad, compress_tree,
                               compressed_allreduce, constant,
                               decompress_tree, get_optimizer, init_errors,
                               optimizers, warmup_cosine)
from repro_torch.runtime import ft, steps
from repro_torch.tree import tree_map

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEAF_RTOL = {"none": 1e-5}
MODEL_RTOL = {"none": 1e-5, "ffn": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and their
    thread pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.checkpoint import checkpoint as jckpt
    from repro.data import pipeline as jpipe
    from repro.optim import compress as jcompress
    from repro.optim import optimizers as joptim
    from repro.optim import schedule as jsched
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, ckpt=jckpt, pipe=jpipe,
                                 compress=jcompress, optim=joptim,
                                 sched=jsched, steps=jsteps)


def f32_configs(jref, **over):
    over = dict(dtype="float32", param_dtype="float32", **over)
    return (jref.configs.get_smoke_config("drim-bnn").replace(**over),
            configs.get_smoke_config("drim-bnn").replace(**over))


def flat(tree, prefix=""):
    """{"a/b": leaf} of a nested-dict tree."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flat(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return out


def jflat(jref, tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in
            jref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def lm_batch(vocab, b=2, s=32, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1          # masked labels
    return batch


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# train_loss and its gradients
# ---------------------------------------------------------------------------

def port_loss_and_grads(params, cfg, batch):
    leaves = flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    loss, metrics = models.train_loss(
        params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("bitlinear", ["none", "ffn"])
def test_train_loss_and_grads_equal_the_reference(jref, bitlinear):
    cj, ct = f32_configs(jref, bitlinear=bitlinear, remat=False)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    batch = lm_batch(cj.vocab_size)
    jb = {k: jref.jnp.asarray(v) for k, v in batch.items()}
    (lj, mj), gj = jref.jax.value_and_grad(
        lambda p: jref.models.train_loss(p, cj, jb), has_aux=True)(pj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    lt, mt, gt = port_loss_and_grads(pt, ct, batch)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    for name in ("ce", "aux_lb", "aux_z", "ntokens"):
        np.testing.assert_allclose(float(mt[name].detach()),
                                   float(mj[name]), rtol=1e-6, err_msg=name)
    assert float(mt["ntokens"]) == 2 * 32 - 3
    want = jflat(jref, gj)
    assert sorted(want) == sorted(gt)
    for path, g in gt.items():
        if bitlinear in LEAF_RTOL:
            assert rel_l2(g.numpy(), want[path]) <= LEAF_RTOL[bitlinear], path
    num = sum(float(((g.numpy() - want[p]) ** 2).sum()) for p, g in gt.items())
    den = sum(float((want[p] ** 2).sum()) for p in gt)
    assert (num / den) ** 0.5 <= MODEL_RTOL[bitlinear]


def test_remat_gives_the_same_gradients():
    ct = configs.get_smoke_config("drim-bnn").replace(dtype="float32")
    batch = lm_batch(ct.vocab_size, seed=1)
    out = {}
    for remat in (True, False):
        params = models.init_params(0, ct, device="cpu")
        out[remat] = port_loss_and_grads(params, ct.replace(remat=remat),
                                         batch)
    assert torch.equal(out[True][0], out[False][0])
    for path, g in out[True][2].items():
        assert torch.equal(g, out[False][2][path]), path


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """With remat the backward runs each layer's forward again (so a
    training step on the card runs the flash forward 2L times)."""
    calls = []
    real = transformer.B.dense_block

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(transformer.B, "dense_block", spy)
    ct = configs.get_smoke_config("drim-bnn")
    batch = lm_batch(ct.vocab_size, seed=2)
    for remat, want in ((True, 2), (False, 1)):
        calls.clear()
        port_loss_and_grads(models.init_params(0, ct, device="cpu"),
                            ct.replace(remat=remat), batch)
        assert len(calls) == want * ct.n_layers


# ---------------------------------------------------------------------------
# optimizers, schedules, compression
# ---------------------------------------------------------------------------

def opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((2, 130, 160)).astype(np.float32),
              "b": rng.standard_normal(300).astype(np.float32),
              "n": {"s": rng.standard_normal((128, 129)).astype(np.float32)}}

    def grads():
        return tree_map(lambda p: (rng.standard_normal(p.shape) * 0.3)
                        .astype(np.float32), params)
    return params, grads(), grads()


def to_port(tree):
    return tree_map(lambda a: transformer._to_torch(np.asarray(a), "cpu"),
                    tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "adam8bit"])
def test_optimizer_update_equals_the_reference(jref, name):
    """One update from identical params, grads and (nonzero) state: the
    reference's state after a first update, carried across."""
    jnp = jref.jnp
    params, g1, g2 = opt_inputs()
    jopt, topt = jref.optim.get_optimizer(name), get_optimizer(name)
    lr = 3e-3
    p1, s1 = jopt.update(jref.jax.tree.map(jnp.asarray, g1),
                         jopt.init(jref.jax.tree.map(jnp.asarray, params)),
                         jref.jax.tree.map(jnp.asarray, params),
                         jnp.float32(lr))
    p2, s2 = jopt.update(jref.jax.tree.map(jnp.asarray, g2), s1, p1,
                         jnp.float32(lr))
    state = to_port(jref.jax.tree.map(np.asarray, s1))
    tp, ts = topt.update(to_port(g2), state, to_port(
        jref.jax.tree.map(np.asarray, p1)), torch.tensor(lr))
    # the port's init has the reference's tree
    init = topt.init(to_port(params))
    assert sorted(flat(init)) == sorted(jflat(jref, jopt.init(
        jref.jax.tree.map(jnp.asarray, params))))
    got = {**{"p/" + k: v for k, v in flat(tp).items()},
           **{"s/" + k: v for k, v in flat(ts).items()}}
    want = {**{"p/" + k: v for k, v in jflat(jref, p2).items()},
            **{"s/" + k: v for k, v in jflat(jref, s2).items()}}
    assert sorted(got) == sorted(want)
    ties = 0
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype == np.int8:
            diff = np.abs(g.astype(np.int32) - w)
            assert diff.max(initial=0) <= 1, path
            # a mismatch only where the quantizer's input is a tie
            ties += int((diff > 0).sum())
            if diff.any():
                x = quantizer_input(state, to_port(g2), path,
                                    got[path[:-1] + "s"])
                frac = (x - np.floor(x))[diff > 0]
                assert np.all(np.abs(frac - 0.5) < 1e-3), path
        elif w.dtype == np.int32:
            assert np.array_equal(g, w), path
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max(initial=0),
                                       err_msg=path)
    print(f"{name}: {ties} int8 moments differ at rounding ties")


def quantizer_input(state, grads, path, scale):
    """adam8bit's new moment over its block scale, the value the
    quantizer rounds, for the int8 leaf at `path` ("s/q/<param>/mq")."""
    keys = path.split("/")[2:-1]
    g, s = optimizers.clip_by_global_norm(grads, 1.0), state["q"]
    for k in keys:
        g, s = g[k], s[k]
    deq = optimizers._dequantize_i8
    if path.endswith("mq"):
        m = 0.9 * deq(s["mq"], s["ms"], g.shape) + 0.1 * g
    else:
        m = 0.95 * deq(s["vq"], s["vs"], g.shape) + 0.05 * g * g
    flat_m = torch.nn.functional.pad(m.reshape(-1),
                                     (0, (-m.numel()) % 256))
    return (flat_m.reshape(-1, 256) / scale).numpy()


def test_adam8bit_quantizer_round_trip():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 100)).astype(np.float32))
    q, s = optimizers._quantize_i8(x)
    assert q.dtype == torch.int8 and q.shape == (2, 256)
    back = optimizers._dequantize_i8(q, s, x.shape)
    assert float((back - x).abs().max()) <= float(s.max()) / 2 + 1e-6


def test_clip_by_global_norm(jref):
    params, g, _ = opt_inputs(1)
    got = optimizers.clip_by_global_norm(to_port(g), 1.0)
    want = jref.optim.clip_by_global_norm(
        jref.jax.tree.map(jref.jnp.asarray, g), 1.0)
    for path, w in jflat(jref, want).items():
        np.testing.assert_allclose(flat(got)[path].numpy(), w, rtol=1e-6,
                                   atol=1e-9)
    assert optimizers.clip_by_global_norm(to_port(g), 0) is not None
    with pytest.raises(KeyError):
        get_optimizer("sgd")


def test_schedules_equal_the_reference(jref):
    steps_ = np.arange(0, 130, dtype=np.int32)
    kw = dict(peak_lr=3e-4, warmup=10, total=120)
    np.testing.assert_allclose(
        warmup_cosine(torch.from_numpy(steps_), **kw).numpy(),
        np.asarray(jref.sched.warmup_cosine(jref.jnp.asarray(steps_), **kw)),
        rtol=1e-6, atol=1e-12)
    assert float(warmup_cosine(0, **kw)) == 0.0
    assert float(warmup_cosine(10, **kw)) == pytest.approx(3e-4)
    assert float(warmup_cosine(500, **kw)) == pytest.approx(3e-5)
    c = constant(torch.tensor(7, dtype=torch.int32), peak_lr=1e-3, warmup=5)
    assert c.dtype == torch.float32 and float(c) == pytest.approx(1e-3)
    assert float(jref.sched.constant(jref.jnp.asarray(7), peak_lr=1e-3)) \
        == float(c)


@pytest.mark.parametrize("seed,scale", [(0, 0.01), (1, 1.0), (2, 100.0)])
def test_compression_equals_the_reference_and_keeps_the_ef_invariant(
        jref, seed, scale):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(64).astype(np.float32) * scale
    err = rng.standard_normal(64).astype(np.float32) * 0.1
    sign, s, new_err = compress_grad(torch.from_numpy(g),
                                     torch.from_numpy(err))
    jsign, js, jerr = jref.compress.compress_grad(jref.jnp.asarray(g),
                                                  jref.jnp.asarray(err))
    assert sign.dtype == torch.int8 and set(sign.tolist()) <= {-1, 1}
    assert np.array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    np.testing.assert_allclose(new_err.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-6 * scale)
    # error feedback: what is sent plus the residual is the corrected grad
    decoded = compress.decompress_grad(sign, s)
    np.testing.assert_allclose((decoded + new_err).numpy(), g + err,
                               rtol=1e-5, atol=1e-5)


def test_compress_tree_and_allreduce():
    params = {"a": torch.ones(4, 4), "b": {"c": -torch.ones(3)}}
    errs = init_errors(params)
    signs, scales, new_errs = compress_tree(params, errs)
    dec = decompress_tree(signs, scales)
    assert sorted(flat(dec)) == sorted(flat(params))
    assert torch.equal(dec["b"]["c"], -torch.ones(3))
    assert all(bool(torch.isfinite(e).all()) for e in flat(new_errs).values())
    with pytest.raises(RuntimeError, match="init_process_group"):
        compressed_allreduce(params, errs, "data")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_batches_equal_the_reference(jref, tmp_path):
    for step in (0, 3):
        got = pipeline.SyntheticLM(512, 16, 4, seed=5).batch_at(step)
        want = jref.pipe.SyntheticLM(512, 16, 4, seed=5).batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k])
    path = str(tmp_path / "toks.bin")
    np.random.default_rng(0).integers(0, 1000, 4000).astype(np.uint32) \
        .tofile(path)
    for host in (0, 1):
        got = pipeline.MemmapLM(path, 16, 3, host_id=host, n_hosts=2,
                                seed=1).batch_at(2)
        want = jref.pipe.MemmapLM(path, 16, 3, host_id=host, n_hosts=2,
                                  seed=1).batch_at(2)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    cfg = configs.get_smoke_config("drim-bnn")
    b = pipeline.SyntheticLM(512, 8, 2).batch_at(0)
    assert sorted(pipeline.attach_modality_stub(dict(b), cfg)) \
        == ["labels", "tokens"]


def test_prefetcher_and_host_slice():
    data = pipeline.SyntheticLM(64, 8, 2, seed=1)
    pf = pipeline.Prefetcher(iter(data), depth=2)
    try:
        for step in range(3):
            got = next(pf)
            assert np.array_equal(got["tokens"],
                                  data.batch_at(step)["tokens"])
    finally:
        pf.close()
    assert pipeline.host_batch_slice(32, 1, 4) == 8


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4), "h": torch.ones(2).bfloat16()},
            "opt": {"m": torch.zeros(3, 4),
                    "q": torch.ones(5, dtype=torch.int8)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t)
    t2 = tree_map(lambda x: x + 1, t)
    ck.save(2, t2)
    ck.wait()
    step, got = ck.restore_latest(tree_map(lambda x: x.to("meta"), t),
                                  device="cpu")
    assert step == 2
    for path, want in flat(t2).items():
        g = flat(got)[path]
        assert g.dtype == want.dtype and torch.equal(g, want), path


def test_checkpoint_keep_policy_and_crash_safety(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2)
    t = _tree()
    for s in (1, 2, 3):
        ck.save(s, t)
    ck.wait()
    saved = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    assert len(saved) == 2 and int(saved[-1].split("_")[1]) == 3
    # a partially written step dir must be ignored (LATEST decides)
    os.makedirs(os.path.join(d, "step_000000099"))
    step, _ = ck.restore_latest(t, device="cpu")
    assert step == 3
    with pytest.raises(ValueError, match="does not match"):
        ck.restore(3, {**t, "step": torch.zeros(2)}, device="cpu")
    assert Checkpointer(str(tmp_path / "empty")).restore_latest(t) \
        == (None, None)


def test_checkpoint_write_errors_surface(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(4, _tree())
    ck.wait()
    os.makedirs(tmp_path / "step_000000005" / "x")   # in the way
    ck.save(5, _tree())
    with pytest.raises(RuntimeError, match="checkpoint save failed"):
        ck.wait()


def test_checkpoints_cross_between_the_packages(jref, tmp_path):
    jnp = jref.jnp
    jtree = {"params": {"w": jnp.arange(12.0).reshape(3, 4),
                        "b": jnp.ones((4,))},
             "opt": {"m": jnp.zeros((3, 4)), "q": jnp.ones(5, jnp.int8)},
             "step": jnp.asarray(7, jnp.int32)}
    like = tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jref.jax.tree.map(np.asarray, jtree))
    jck = jref.ckpt.Checkpointer(str(tmp_path / "j"))
    jck.save(3, jtree)
    jck.wait()
    step, got = Checkpointer(str(tmp_path / "j")).restore_latest(
        like, device="cpu")
    assert step == 3
    for path, want in jflat(jref, jtree).items():
        assert np.array_equal(flat(got)[path].numpy(), want), path
        assert flat(got)[path].numpy().dtype == want.dtype

    tck = Checkpointer(str(tmp_path / "t"))
    tck.save(9, tree_map(lambda t: t + 1, like))
    tck.wait()
    step, back = jref.ckpt.Checkpointer(str(tmp_path / "t")).restore_latest(
        jref.jax.eval_shape(lambda: jtree))
    assert step == 9
    for path, want in flat(like).items():
        got_j = jflat(jref, back)[path]
        assert np.array_equal(got_j, (want + 1).numpy()), path
    with open(tmp_path / "t" / "step_000000009" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["leaves"]["opt/q"] == {"shape": [5], "dtype": "int8"}


# ---------------------------------------------------------------------------
# train steps, restart, CLI
# ---------------------------------------------------------------------------

def _run(cfg, n_steps, *, state=None, start=0, ckpt=None, ckpt_at=None):
    step_fn, init_state, _ = steps.make_train_step(
        cfg, optimizer_name="adamw", peak_lr=1e-3, warmup=2,
        total_steps=n_steps)
    data = pipeline.SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    state = state if state is not None else init_state(0, device="cpu")
    for step in range(start, n_steps):
        state, _ = step_fn(state, train.batch_at(data, cfg, step, 0, "cpu"))
        if ckpt is not None and step + 1 == ckpt_at:
            ckpt.save(step + 1, state)
            ckpt.wait()
    return state


def test_restart_bit_exact(tmp_path):
    """8 steps straight vs 4 + checkpoint + restore into a fresh state + 4:
    bit-identical parameters (the twin of
    tests/test_restart_equivalence.py)."""
    cfg = configs.get_smoke_config("drim-bnn").replace(remat=False)
    final_a = _run(cfg, 8)
    ck = Checkpointer(str(tmp_path))
    _run(cfg, 8, ckpt=ck, ckpt_at=4)
    fresh = steps.make_train_step(cfg)[1](1, device="cpu")
    step, restored = ck.restore_latest(fresh, device="cpu")
    assert step == 4
    final_b = _run(cfg, 8, state=restored, start=4)
    for path, a in flat(final_a["params"]).items():
        assert torch.equal(a, flat(final_b["params"])[path]), path
    assert int(final_b["step"]) == 8


@pytest.mark.parametrize("accum,compress_", [(1, False), (2, True)])
def test_train_state_from_jax_gives_the_reference_step(jref, accum,
                                                       compress_):
    cj, ct = f32_configs(jref, remat=False)
    mesh = jref.jax.make_mesh((1, 1), ("data", "model"))
    kw = dict(optimizer_name="adamw", peak_lr=1e-3, warmup=2,
              total_steps=10, accum=accum, compress=compress_)
    jstep, jinit, _ = jref.steps.make_train_step(cj, mesh, **kw)
    batch = lm_batch(cj.vocab_size, b=4, s=16, seed=3)
    with mesh:
        jstate = jref.jax.jit(jinit)(jref.jax.random.PRNGKey(0))
        jnew, jm = jref.jax.jit(jstep)(
            jstate, {k: jref.jnp.asarray(v) for k, v in batch.items()})
    tstep, _, _ = steps.make_train_step(ct, **kw)
    tstate = steps.train_state_from_jax(
        jref.jax.tree.map(np.asarray, jstate), ct, device="cpu")
    assert sorted(flat(tstate)) == sorted(jflat(jref, jstate))
    tnew, tm = tstep(tstate, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    for name in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, err_msg=name)
    assert int(tnew["step"]) == 1
    want = jflat(jref, jnew["params"])
    for path, p in flat(tnew["params"]).items():
        np.testing.assert_allclose(p.numpy(), want[path], rtol=1e-5,
                                   atol=1e-6 * np.abs(want[path]).max(),
                                   err_msg=path)


def test_prefill_and_decode_steps_wrap_the_model():
    cfg = configs.get_smoke_config("drim-bnn")
    params = models.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)))
    logits, caches = steps.make_prefill_step(cfg)(params, {"tokens": toks})
    want, _ = models.prefill(params, cfg, {"tokens": toks})
    assert torch.equal(logits, want)
    empty = models.empty_caches(cfg, 2, 12, device="cpu")
    pos = torch.tensor([0, 0])
    got, _ = steps.make_decode_step(cfg, 12)(params, toks[:, :1], empty, pos)
    want, _ = models.decode_step(params, cfg, toks[:, :1], empty, pos, 12)
    assert torch.equal(got, want)


def test_cli_trains_on_the_cpu_without_jax(tmp_path):
    code = ("import runpy, sys; sys.argv = sys.argv[:1] + sys.argv[2:]; "
            "runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__'); "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'drim'))))")
    argv = ["--smoke-config", "--device", "cpu", "--steps", "6", "--batch",
            "4", "--seq", "64", "--lr", "3e-3", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"]
    out = subprocess.run(
        [sys.executable, "-c", "import json; " + code, "-"] + argv,
        check=True, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert lines[-1] == []                        # no JAX, no reference
    logged = [line for line in lines[:-2] if "step" in line]
    assert [line["step"] for line in logged] == [1, 2, 3, 4, 5, 6]
    assert {"loss", "ce", "lr", "grad_norm", "s_per_step"} <= set(logged[0])
    final = lines[-2]
    assert final["steps"] == 6 and final["final_loss"] < logged[0]["loss"]
    assert sorted(p for p in os.listdir(tmp_path) if p.startswith("step_")) \
        == ["step_000000003", "step_000000006"]
    beats = open(tmp_path / "heartbeats.jsonl").read().splitlines()
    assert len(beats) == 6


def test_cli_resumes_from_the_latest_checkpoint(tmp_path, capsys):
    argv = ["--smoke-config", "--device", "cpu", "--batch", "2", "--seq",
            "32", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--warmup", "1"]
    train.main(argv + ["--steps", "2"])
    capsys.readouterr()
    train.main(argv + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "resumed from step 2"
    assert [json.loads(line)["step"] for line in out[1:-1]] == [3]
    with pytest.raises(ValueError, match="needs 512 devices"):
        train.main(argv + ["--mesh", "multi"])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_entry_points_default_to_the_card(no_cuda, jref, tmp_path):
    cfg = configs.get_smoke_config("drim-bnn")
    opt = get_optimizer("adamw")
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)})
    ck.wait()
    cj = jref.configs.get_smoke_config("drim-bnn")
    jparams = jref.jax.tree.map(np.asarray, jref.models.init_params(
        jref.jax.random.PRNGKey(0), cj))
    calls = [
        lambda: train.main(["--smoke-config", "--steps", "1"]),
        lambda: steps.make_train_state(0, cfg, opt),
        lambda: steps.make_train_step(cfg)[1](0),
        lambda: steps.train_state_from_jax({"params": jparams}, cfg),
        lambda: ck.restore(1, {"w": torch.ones(2)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_heartbeats_and_stragglers(tmp_path):
    path = str(tmp_path / "hb.jsonl")
    h0 = ft.HeartbeatMonitor(path, host_id=0, dead_after_s=10.0)
    h1 = ft.HeartbeatMonitor(path, host_id=1, dead_after_s=10.0)
    h0.beat(10)
    h1.beat(4)
    with open(path, "a") as f:
        f.write('{"host": 2, "step": 5, "t"')      # torn write
    tab = h0.table()
    assert set(tab) == {0, 1} and tab[0].last_step == 10
    assert tab[0].step_latency == 0.0
    now = max(h.last_seen for h in tab.values())
    assert h0.report(now=now + 1.0) == ([], [])
    assert h0.report(now=now + 11.0)[1] == [0, 1]
    assert h0.prune(now=now + 11.0) == [0, 1] and h0.table() == {}


def test_elastic_plan_and_restarts():
    assert ft.elastic_plan(3, 4, 24, model_parallel=2) == \
        {"data": 6, "model": 2, "per_host_batch": 8}
    with pytest.raises(ValueError, match="resize the fleet to 6 hosts"):
        ft.elastic_plan(7, 1, 24, model_parallel=1)
    attempts = []

    def train_once(start):
        attempts.append(start)
        if len(attempts) < 3:
            raise RuntimeError("host lost")
        return 42
    assert ft.run_with_restarts(train_once, max_restarts=3) == 42
    assert attempts == [None, None, None]
    with pytest.raises(RuntimeError, match="host lost"):
        ft.run_with_restarts(lambda s: (_ for _ in ()).throw(
            RuntimeError("host lost")), max_restarts=1)
