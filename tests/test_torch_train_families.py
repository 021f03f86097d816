"""Training every family against the reference: the float32 smoke
config's loss and gradients against `jax.value_and_grad` of the
reference's `train_loss` (the port with remat on), the trainer CLI's
losses over three steps against the reference's CLI from the same
state, and what both packages do with a vlm training sequence shorter
than its patches.

Gradient bounds, in relative L2 of the whole gradient and of each leaf
(measured on this CPU: the dense, MoE, audio and vlm archs agree within
1.6e-6, mamba2 within 7.9e-6, zamba2 within 2.7e-3):
  * dense, MoE (MLA and GQA), audio, vlm: 1e-5.  Both packages sum
    float32 in other orders (~1e-6); a top-k choice that flipped would
    move the router's and the experts' gradients by far more.
  * ssm: 1e-4.  The SSD scan rounds its product operands to bfloat16 in
    float32 configs too (both packages, by design); the packages agree on
    every rounding but sum the chunks in other orders.
  * hybrid: 1.6e-2, the families tests' four bfloat16 ulps.  The same
    rounding, and the shared attention between the groups amplifies a
    one-ulp change (`test_torch_families.py`'s docstring).
"""
import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.launch import train
from repro_torch.runtime import steps
from repro_torch.tree import tree_map_with_path

ARCHS = ("qwen3-14b", "mamba2-130m", "zamba2-1.2b", "deepseek-v3-671b",
         "kimi-k2-1t-a32b", "whisper-medium", "llava-next-34b")
GRAD_RTOL = {"qwen3-14b": 1e-5, "mamba2-130m": 1e-4, "zamba2-1.2b": 1.6e-2,
             "deepseek-v3-671b": 1e-5, "kimi-k2-1t-a32b": 1e-5,
             "whisper-medium": 1e-5, "llava-next-34b": 1e-5}
LOSS_RTOL = 1e-6
B, S = 2, 32


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
    import jax.numpy as jnp

    from repro import configs as jconfigs
    from repro import models as jmodels
    from repro.runtime import steps as jsteps
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, steps=jsteps)


def flat_port(tree):
    out = {}
    tree_map_with_path(lambda path, t: out.__setitem__(path, t), tree)
    return out


def flat_ref(jref, tree):
    return {jref.jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def family_batch(cfg, seed: int = 2):
    """Tokens, labels with a fifth masked, and the audio frames or vlm
    patch embeddings, as numpy arrays."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
              "labels": np.where(rng.random((B, S)) < 0.2, -1,
                                 rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "audio":
        arrays["frames"] = np.random.default_rng(9).standard_normal(
            (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patch_embeds"] = np.random.default_rng(10).standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return arrays


def grad_errors(got: dict, want: dict):
    """(whole-gradient relative L2, {leaf: relative L2})."""
    assert sorted(got) == sorted(want)
    num = sum(float(((got[p] - want[p]) ** 2).sum()) for p in got)
    den = sum(float((want[p] ** 2).sum()) for p in got)
    leaf = {p: float(np.linalg.norm(got[p] - want[p])
                     / max(np.linalg.norm(want[p]), 1e-30)) for p in got}
    return (num / den) ** 0.5, leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_the_reference(arch, jref):
    over = dict(dtype="float32", param_dtype="float32")
    cj = jref.configs.get_smoke_config(arch).replace(remat=False, **over)
    ct = configs.get_smoke_config(arch).replace(remat=True, **over)
    arrays = family_batch(cj)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    (loss_j, _), gj = jref.jax.value_and_grad(
        lambda p: jref.models.train_loss(
            p, cj, {k: jref.jnp.asarray(v) for k, v in arrays.items()}),
        has_aux=True)(pj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    leaves = flat_port(pt)
    for t in leaves.values():
        t.requires_grad_(True)
    loss_t, _ = models.train_loss(
        pt, ct, {k: torch.from_numpy(v) for k, v in arrays.items()})
    grads = torch.autograd.grad(loss_t, list(leaves.values()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    whole, per_leaf = grad_errors(
        {p: g.numpy() for p, g in zip(leaves, grads)}, flat_ref(jref, gj))
    bound = GRAD_RTOL[arch]
    assert whole <= bound
    worst = max(per_leaf, key=per_leaf.get)
    assert per_leaf[worst] <= bound, worst


def test_a_zeroed_leaf_fails_the_bound(jref):
    """The bound catches a gradient the backward dropped: one leaf of the
    loosest family's gradient zeroed fails it."""
    got = {"a": np.ones(4, np.float32), "b": np.full(4, 2.0, np.float32)}
    want = {k: v.copy() for k, v in got.items()}
    got["a"] = np.zeros(4, np.float32)
    whole, leaf = grad_errors(got, want)
    assert whole > max(GRAD_RTOL.values()) and leaf["a"] == 1.0


# --- the trainer CLI -------------------------------------------------------

CLI = ["--smoke-config", "--steps", "3", "--batch", "2", "--seq", "32",
       "--log-every", "1", "--lr", "3e-3", "--warmup", "1"]
# The CLI's losses at the bfloat16 smoke configs over 3 steps against the
# reference trainer's from the same state: bfloat16 activations round
# apart here and there, and each step's update carries that on (measured
# on this CPU: at most 2.2e-4 relative, zamba2's third step).
CLI_LOSS_RTOL = 1e-3


def reference_cli_run(jref, argv):
    """The reference trainer's loop (`repro.launch.train.main`) as it runs
    `argv`, with its step built without a mesh: under jax 0.9 its main's
    host mesh gives the state explicit shardings, and the embedding
    gather then raises `ShardingTypeError` for every arch (the reference
    pins jax 0.4; ROADMAP Queue 3).  Returns (its initial state as numpy
    leaves, each step's metrics as floats)."""
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.data.pipeline import attach_modality_stub as jattach
    jax, jnp = jref.jax, jref.jnp
    args = train.parse_args(argv)           # the reference's flags
    cfg = jref.configs.get_smoke_config(args.arch)
    warmup = (args.warmup if args.warmup is not None
              else max(1, min(2000, args.steps // 10)))
    step_fn, init_state, _ = jref.steps.make_train_step(
        cfg, None, optimizer_name=args.optimizer, peak_lr=args.lr,
        warmup=warmup, total_steps=args.steps, accum=args.accum,
        compress=args.compress)
    state = jax.jit(init_state)(jax.random.PRNGKey(args.seed))
    first = jax.tree.map(np.asarray, state)
    data = JSyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    jstep = jax.jit(step_fn)
    metrics = []
    for step in range(args.steps):
        raw = jattach(data.batch_at(step), cfg, seed=args.seed)
        state, m = jstep(state, {k: jnp.asarray(v) for k, v in raw.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return first, metrics


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_losses_match_the_reference(arch, jref, monkeypatch):
    """Three steps of the port's trainer CLI (`launch.train.main`) from
    the reference trainer's initial state (carried over by
    `train_state_from_jax`) on the same batches (`SyntheticLM` and the
    modality stubs equal the reference's: `test_torch_train.py`), each
    step's loss against the reference's."""
    optimizer = ("adafactor" if arch.startswith(("deepseek", "kimi"))
                 else "adamw")
    argv = ["--arch", arch, *CLI, "--optimizer", optimizer]
    state_np, want = reference_cli_run(jref, argv)
    build = train.build
    got = []

    def from_reference(args, mesh=None):
        cfg, step_fn, _ = build(args, mesh)

        def step(state, batch):
            state, m = step_fn(state, batch)
            got.append({k: float(v) for k, v in m.items()})
            return state, m
        return cfg, step, lambda seed, device=None: \
            steps.train_state_from_jax(state_np, cfg, device=device)
    monkeypatch.setattr(train, "build", from_reference)
    final, lines = run_lines(train.main, argv + ["--device", "cpu"])
    assert [line["step"] for line in lines if "loss" in line] == [1, 2, 3]
    assert final == got[-1]["loss"]
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=CLI_LOSS_RTOL)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
    assert got[-1]["loss"] < got[0]["loss"]


def run_lines(fn, argv):
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        final = fn(argv)
    return final, [json.loads(line) for line in text.getvalue().splitlines()
                   if line.startswith("{")]


# --- a vlm sequence shorter than its patches ---------------------------------

def test_short_vlm_training_sequence_raises_in_both(jref):
    """`_embed` puts the n_patches patch embeddings first and keeps the
    token embeddings past them, so a sequence shorter than the patches
    comes out n_patches long in both packages (the smoke config: 16)
    while the positions and labels stay S long: both packages raise in
    the first layer's rotary embedding (the reference a TypeError, the
    port a RuntimeError), before a loss could be formed."""
    cj = jref.configs.get_smoke_config("llava-next-34b")
    ct = configs.get_smoke_config("llava-next-34b")
    short = cj.n_patches // 2
    rng = np.random.default_rng(0)
    arrays = {"tokens": rng.integers(0, cj.vocab_size, (B, short)),
              "labels": rng.integers(0, cj.vocab_size, (B, short)),
              "patch_embeds": rng.standard_normal(
                  (B, cj.n_patches, cj.d_model)).astype(np.float32)}
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    with pytest.raises((TypeError, ValueError)):
        jref.models.train_loss(
            pj, cj, {k: jref.jnp.asarray(v) for k, v in arrays.items()})
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    with pytest.raises(RuntimeError, match="size of tensor"):
        models.train_loss(pt, ct, {k: torch.from_numpy(v)
                                   for k, v in arrays.items()})
    # the trunk's sequence is the patches' length in the port
    x = models.transformer._embed(
        pt, ct, torch.from_numpy(arrays["tokens"]),
        {"patch_embeds": torch.from_numpy(arrays["patch_embeds"])})
    assert x.shape[1] == ct.n_patches
