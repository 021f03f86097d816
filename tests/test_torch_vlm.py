"""The port's vlm family (llava-next-34b) held against the JAX reference,
and the SiLU that the dense MLP, the SSM mixer and the MoE experts share.

llava is the dense trunk behind a stub vision frontend: the batch's patch
embeddings [B, n_patches, D] replace the first n_patches token
embeddings, and decode embeds tokens only.  The reference's parameters
are carried over by `lm_from_jax`; patches and tokens are the same
seeded numpy arrays in both packages.

Tolerances, as `tests/test_torch_families.py` states them: float32 at
rtol = atol = 1e-4 (the loss at rtol 1e-6, as `tests/test_torch_train.py`
holds drim-bnn's), the bfloat16 attention caches of a float32 config at
one bfloat16 ulp, bfloat16 values at 4 bfloat16 ulps of their magnitude;
greedy tokens equal.  The SiLU and the bfloat16 dense MLP are held
bit-equal.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.data import pipeline
from repro_torch.launch import batching, serve
from repro_torch.models import layers, transformer
from repro_torch.tree import tree_map, tree_map_with_path

ARCH = "llava-next-34b"
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
KV_F32 = dict(rtol=2 ** -7, atol=1e-4)
B, CTX = 2, 32


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
    from repro.data import pipeline as jpipeline
    from repro.launch import batching as jbatching
    from repro.launch import serve as jserve
    from repro.models import layers as jlayers
    from repro.models import transformer as jtransformer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, configs=jconfigs, models=jmodels,
        pipeline=jpipeline, batching=jbatching, serve=jserve,
        layers=jlayers, transformer=jtransformer)


def tol(dtype, want):
    """F32, or 4 bfloat16 ulps of the values' magnitude."""
    if dtype == "float32":
        return F32
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return dict(rtol=BF16["rtol"], atol=BF16["atol"] * scale)


def close(got, want, tolerance):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tolerance)


def flat(jref, port, ref):
    """(port leaves, reference leaves) of two trees by path."""
    fj = {jref.jax.tree_util.keystr(k): v for k, v in
          jref.jax.tree_util.tree_flatten_with_path(ref)[0]}
    ft = {}
    tree_map_with_path(lambda path, t: ft.__setitem__(path, t), port)
    assert sorted(ft) == sorted(fj)
    return ft, fj


def close_caches(jref, dtype, got, want):
    ft, fj = flat(jref, got, want)
    for path, t in ft.items():
        assert tuple(t.shape) == fj[path].shape, path
        close(t, fj[path], KV_F32 if dtype == "float32"
              else tol(dtype, fj[path]))


def model_pair(jref, dtype, **over):
    """(jax cfg, jax params, port cfg, port params) of the smoke config,
    the reference's parameters carried over."""
    over = dict(dtype=dtype, param_dtype=dtype, **over)
    cj = jref.configs.get_smoke_config(ARCH).replace(remat=False, **over)
    ct = configs.get_smoke_config(ARCH).replace(**over)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    return cj, pj, ct, pt


def batch_pair(jref, cfg, s, seed=0, **extra):
    """Seeded tokens [B, s] and patch embeddings [B, n_patches, D] (and
    `extra` arrays) as both packages' batches."""
    rng = np.random.default_rng(seed)
    arrays = dict(tokens=rng.integers(0, cfg.vocab_size, (B, s)),
                  patch_embeds=rng.standard_normal(
                      (B, cfg.n_patches, cfg.d_model)).astype(np.float32),
                  **extra)
    return ({k: jref.jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_published_size():
    """34.4 B parameters, 0.558 B a layer: the reference's formula."""
    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 34_388_049_920
    per_layer = (cfg.param_count() - 2 * cfg.vocab_size * cfg.d_model) \
        // cfg.n_layers
    assert per_layer == 557_842_432
    assert configs.get_smoke_config(ARCH).n_patches == 16


def test_params_and_caches_are_the_dense_trunks(jref):
    """vlm draws the dense trunk's weights (the same seed, the same
    tensors), and its caches have the reference's layout.  (Its parameter
    tree against the reference's: `tests/test_torch_families.py`.)"""
    cj = jref.configs.get_smoke_config(ARCH)
    ct = configs.get_smoke_config(ARCH)
    pj = jref.jax.eval_shape(
        lambda: jref.models.init_params(jref.jax.random.PRNGKey(0), cj))
    ft, fj = flat(jref, models.empty_caches(ct, 3, CTX, device="cpu"),
                  jref.models.empty_caches(cj, 3, CTX))
    for path, t in ft.items():
        assert tuple(t.shape) == fj[path].shape and not t.any(), path
    vlm = flat(jref, models.init_params(0, ct, device="cpu"), pj)[0]
    dense = flat(jref, models.init_params(0, ct.replace(family="dense"),
                                          device="cpu"), pj)[0]
    for path, t in vlm.items():
        assert torch.equal(t, dense[path]), path


# ---------------------------------------------------------------------------
# the patch prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,positions", [(24, 24), (8, 16)],
                         ids=["prompt-past-the-patches", "short-prompt"])
def test_embed_with_patches_equals_the_reference(s, positions, jref):
    """Patches then the token embeddings past them; a prompt shorter than
    the 16 patches gives 16 positions in both packages."""
    cj, pj, ct, pt = model_pair(jref, "float32")
    bj, bt = batch_pair(jref, cj, s)
    want = jref.transformer._embed(pj, cj, bj["tokens"], bj)
    got = transformer._embed(pt, ct, bt["tokens"], bt)
    assert tuple(got.shape) == want.shape == (B, positions, ct.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :16].numpy(), bt["patch_embeds"])
    tokens_only = transformer._embed(pt, ct, bt["tokens"], {})
    assert tuple(tokens_only.shape) == (B, s, ct.d_model)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_equal_the_reference(dtype, jref):
    """A 24-token prompt behind 16 patches, spliced into CTX-long caches,
    then three greedy decode steps: logits, caches and tokens equal to
    the reference's."""
    cj, pj, ct, pt = model_pair(jref, dtype)
    s = 24
    bj, bt = batch_pair(jref, cj, s)
    lj, pre_j = jref.models.prefill(pj, cj, bj)
    lt, pre_t = models.prefill(pt, ct, bt)
    close(lt, lj, tol(dtype, lj))
    close_caches(jref, dtype, pre_t, pre_j)
    _, no_patches = models.prefill(pt, ct, {"tokens": bt["tokens"]})
    assert not torch.equal(no_patches["k"], pre_t["k"])

    cache_j = jref.serve.splice_caches(jref.models.empty_caches(cj, B, CTX),
                                       pre_j)
    cache_t = serve.splice_caches(models.empty_caches(ct, B, CTX,
                                                      device="cpu"), pre_t)
    for i in range(3):
        tok = np.asarray(lj[:, -1], np.float32).argmax(-1)[:, None]
        np.testing.assert_array_equal(lt[:, -1].argmax(-1).numpy(),
                                      tok[:, 0])
        pos = np.full(B, s + i)
        lj, cache_j = jref.models.decode_step(pj, cj, jref.jnp.asarray(tok),
                                              cache_j, jref.jnp.asarray(pos),
                                              CTX)
        lt, cache_t = models.decode_step(pt, ct, torch.from_numpy(tok),
                                         cache_t, torch.from_numpy(pos), CTX)
        close(lt, lj, tol(dtype, lj))
        close_caches(jref, dtype, cache_t, cache_j)


def test_train_loss_equals_the_reference(jref):
    """The float32 loss and its metrics with patch embeddings in the
    batch (labels over the whole sequence, patches included, as the
    reference takes them); the port with remat on, its backward finite."""
    cj, pj, ct, pt = model_pair(jref, "float32")
    s = 24
    rng = np.random.default_rng(2)
    labels = np.where(rng.random((B, s)) < 0.2, -1,
                      rng.integers(0, cj.vocab_size, (B, s)))
    bj, bt = batch_pair(jref, cj, s, seed=3, labels=labels)
    loss_j, met_j = jref.models.train_loss(pj, cj, bj)
    live = tree_map(lambda t: t.requires_grad_(True), pt)
    loss_t, met_t = models.train_loss(live, ct.replace(remat=True), bt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    for name in ("ce", "aux_lb", "aux_z", "ntokens"):
        np.testing.assert_allclose(float(met_t[name].detach()),
                                   float(met_j[name]), rtol=1e-6,
                                   err_msg=name)
    loss_t.backward()
    ft, _ = flat(jref, live, pj)
    for path, t in ft.items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), path


def test_data_stub_attaches_the_reference_patches(jref):
    cfg = configs.get_smoke_config(ARCH)
    cj = jref.configs.get_smoke_config(ARCH)
    tokens = np.zeros((3, 24), np.int32)
    got = pipeline.attach_modality_stub({"tokens": tokens}, cfg, seed=5)
    want = jref.pipeline.attach_modality_stub({"tokens": tokens}, cj,
                                              seed=5)
    assert sorted(got) == sorted(want) == ["patch_embeds", "tokens"]
    assert got["patch_embeds"].shape == (3, 16, 128)
    np.testing.assert_array_equal(got["patch_embeds"],
                                  np.asarray(want["patch_embeds"]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_args():
    return ["--arch", ARCH, "--smoke-config", "--batch", "2",
            "--prompt-len", "24", "--gen", "5"]


def test_serve_batch_carries_zero_patches():
    cfg = configs.get_smoke_config(ARCH)
    tokens = torch.zeros(3, 24, dtype=torch.long)
    batch = serve.model_batch(cfg, tokens)
    pe = batch["patch_embeds"]
    assert tuple(pe.shape) == (3, 16, 128) and pe.dtype == torch.bfloat16
    assert pe.device == tokens.device and not pe.any()
    dense = serve.model_batch(configs.get_smoke_config("qwen3-14b"), tokens)
    assert list(dense) == ["tokens"]


def test_served_tokens_equal_the_reference_up_to_near_ties(jref,
                                                          monkeypatch):
    """`run_serve` on the CPU with the reference's seeded weights and
    prompts carried over: its prefill batch carries the zero patches, and
    each row's greedy stream equals the reference's up to a near-tie.
    Where a row first parts from the reference's, the two tokens' logits
    of the port (on the same context: the streams were equal so far)
    must lie within the bfloat16 rule of each other; the streams may then
    run apart.  With these seeds one row parts at its fourth token,
    where the reference's top two logits are 2 bfloat16 ulps apart and
    the port's tie."""
    argv = serve_args()
    want, _ = jref.serve.run_serve(jref.serve.parse_args(argv))
    want = np.asarray(want)
    args = serve.parse_args(argv + ["--device", "cpu"])
    cfg = serve.build_cfg(args)
    key = jref.jax.random.PRNGKey(args.seed)
    pj = jref.models.init_params(key, jref.serve.build_cfg(args))
    toks = np.asarray(jref.jax.random.randint(
        jref.jax.random.fold_in(key, 1), (args.batch, args.prompt_len), 0,
        cfg.vocab_size))
    params = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), cfg,
                                device="cpu")
    seen = []
    real = serve.prefill

    def recording(p, c, batch):
        seen.append(batch)
        return real(p, c, batch)
    monkeypatch.setattr(serve, "prefill", recording)
    got, stats = serve.run_serve(args, params=params, tokens=toks)
    assert stats["arch"] == ARCH and stats["engine"] == "gpu"
    (batch,) = seen
    assert tuple(batch["patch_embeds"].shape) == (2, 16, 128)
    assert batch["patch_embeds"].dtype == torch.bfloat16
    assert not batch["patch_embeds"].any()

    # the port's logits along the reference's stream
    ctx = args.prompt_len + args.gen
    logits, pre = real(params, cfg, batch)
    caches = serve.splice_caches(models.empty_caches(
        cfg, args.batch, ctx, device="cpu"), pre)
    parted = np.zeros(args.batch, bool)
    for i in range(args.gen):
        lg = logits[:, -1].to(torch.float32).numpy()
        atol = BF16["atol"] * max(1.0, float(np.abs(lg).max()))
        for r in np.flatnonzero(~parted & (got[:, i] != want[:, i])):
            assert abs(lg[r, got[r, i]] - lg[r, want[r, i]]) <= atol, (r, i)
            parted[r] = True
        pos = torch.full((args.batch,), args.prompt_len + i)
        logits, caches = models.decode_step(
            params, cfg, torch.from_numpy(want[:, i:i + 1]).long(), caches,
            pos, ctx)
    assert not parted.all()


def test_wave_batcher_admits_llava_and_prefills_tokens_only(jref,
                                                           monkeypatch):
    """Two requests of 24 and 20 tokens, the second a wave later, into 2
    slots: each request's tokens equal the reference batcher's, and every
    admission prefills a batch of tokens only, as the reference's does."""
    cj, pj, ct, pt = model_pair(jref, "bfloat16")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cj.vocab_size, n) for n in (24, 20)]
    seen = []
    real = batching.prefill

    def recording(p, c, batch):
        seen.append(sorted(batch))
        return real(p, c, batch)
    monkeypatch.setattr(batching, "prefill", recording)
    runs = []
    for b in (jref.batching.WaveBatcher(cj, pj, n_slots=2, ctx_len=CTX),
              batching.WaveBatcher(ct, pt, n_slots=2, ctx_len=CTX,
                                   device="cpu")):
        b.submit(prompts[0], 4, arrival_wave=0)
        b.submit(prompts[1], 4, arrival_wave=1)
        runs.append(b.run())
    for r in range(2):
        np.testing.assert_array_equal(runs[1][r], runs[0][r])
    assert seen == [["tokens"], ["tokens"]]


# ---------------------------------------------------------------------------
# SiLU as XLA computes it
# ---------------------------------------------------------------------------

def silu_pair(jref, x):
    """(port, reference) SiLU of bfloat16 `x`, as float32 arrays."""
    want = jref.jax.nn.silu(jref.jnp.asarray(x.to(torch.float32).numpy(),
                                             "bfloat16"))
    return (layers.silu(x).to(torch.float32).numpy(),
            np.asarray(want, np.float32))


def test_silu_is_bit_equal_on_every_bfloat16_value(jref):
    """All 65,536 bfloat16 bit patterns through `layers.silu` and
    `jax.nn.silu`: the same bits (NaNs where the reference's are), except
    where XLA on the CPU flushes a subnormal to zero: there the
    reference's result is 0 and the port's input, logistic or result
    lies at or under the normal range's edge, 2**-126 (511 patterns).  On
    65,536 seeded normal values the same bits everywhere, where
    `torch.nn.functional.silu`, which rounds once, differs on ~40 %."""
    x = torch.from_numpy(np.arange(-2 ** 15, 2 ** 15, dtype=np.int16)) \
        .view(torch.bfloat16)
    got, want = silu_pair(jref, x)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    apart = ~nan & (got != want)
    logistic = torch.reciprocal(1 + torch.exp(-x)).to(torch.float32).numpy()
    tiny = np.stack([x.to(torch.float32).numpy(), logistic, got])
    assert (want[apart] == 0).all()
    assert (np.abs(tiny[:, apart]) <= 2.0 ** -126).any(0).all()
    assert apart.sum() == 511

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        65536).astype(np.float32)).to(torch.bfloat16)
    got, want = silu_pair(jref, x)
    np.testing.assert_array_equal(got, want)
    once = torch.nn.functional.silu(x).to(torch.float32).numpy()
    assert float(np.mean(once != want)) > 0.3
    assert float(layers.silu(torch.tensor(-0.3984375,
                                          dtype=torch.bfloat16))) \
        == -0.1591796875


def test_bfloat16_mlp_is_bit_equal_to_the_reference(jref):
    """The dense SwiGLU MLP at llava's smoke width in bfloat16, weights
    and activations carried over: the same bits."""
    cfg = configs.get_smoke_config(ARCH)
    pj = jref.layers.mlp_init(jref.jax.random.PRNGKey(1), cfg.d_model,
                              cfg.d_ff, dtype=jref.jnp.bfloat16)
    pt = tree_map(lambda a: transformer._to_torch(np.asarray(a), "cpu"),
                  jref.jax.tree.map(np.asarray, pj))
    x = np.random.default_rng(4).standard_normal(
        (B, 24, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = jref.layers.mlp(pj, jref.jnp.asarray(
        xt.to(torch.float32).numpy(), "bfloat16"))
    got = layers.mlp(pt, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))
