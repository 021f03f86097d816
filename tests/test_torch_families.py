"""The port's SSM, hybrid, MoE, audio and vlm families and the dense archs
held against the JAX reference: configs and parameter counts field for
field, parameter and cache trees, prefill plus decode on the smoke
configs of the ten archs (the reference's parameters carried over by `lm_from_jax`, the same
numpy tokens through both packages), the hybrid's long-context window,
the training loss, and serving.

Tolerances.  In float32 values are held at rtol = atol = 1e-4
(`tests/test_torch_lm.py`); bfloat16 attention caches one bfloat16 ulp
(rtol 2**-7).  In bfloat16 values are held to 4 bfloat16 ulps of their
magnitude: rtol = 1.6e-2 and atol = 1.6e-2 times the larger of 1 and
the reference's largest |value| (`tol`; keys, values and SSM conv states
reach ~4; `tests/test_torch_ssm.py` says where the packages round apart).
Greedy tokens must be equal.

The hybrid is held looser, for a measured reason.  Its scan rounds the
product operands to bfloat16 in float32 configs too (both packages, by
design), and the shared attention between the groups amplifies a
one-ulp change: nudging the port's own float32 embeddings by 1.2e-7
(relative) moves its smoke states by ~0.03 (scale 12;
`test_hybrid_float32_rounds_inside_the_scan`).  So its float32 values
are held at the bfloat16 rule.  In bfloat16 its logits are held at that
rule and its caches in relative L2 norm at 2**-3: the two packages round
apart at several places (the attention's softmax and the sums of the
products), which the scan carries on; the caches stand up to 3.3 % apart
in that norm (6.6 % while the port's SiLU rounded once, where XLA rounds
after each op of 1 / (1 + exp(-x)); `layers.silu` now rounds as XLA
does).  No bfloat16 value of these models is bit-equal to the
reference's, so none is held tighter.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.launch import batching, serve
from repro_torch.models import transformer
from repro_torch.tree import tree_map, tree_map_with_path

PORTED = ("mamba2-130m", "zamba2-1.2b", "qwen3-14b", "qwen3-32b",
          "qwen2-72b", "minitron-4b", "deepseek-v3-671b", "kimi-k2-1t-a32b",
          "whisper-medium", "llava-next-34b")
# the archs that raised until the vlm family was ported
ONCE_UNPORTED = ("llava-next-34b",)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
KV_F32 = dict(rtol=2 ** -7, atol=1e-4)
HYBRID_L2 = 2 ** -3
B, S, CTX = 2, 16, 24


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
    from repro.launch import batching as jbatching
    from repro.launch import serve as jserve
    from repro.models import transformer as jtransformer
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, serve=jserve,
                                 batching=jbatching,
                                 transformer=jtransformer)


def tol(dtype, want, family="dense"):
    """F32, or 4 bfloat16 ulps of the values' magnitude (the hybrid's
    float32 values too, see the module's docstring)."""
    if dtype == "float32" and family != "hybrid":
        return F32
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return dict(rtol=BF16["rtol"], atol=BF16["atol"] * scale)


def close(got, want, tolerance):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tolerance)


def flat_ref(jref, tree):
    return {jref.jax.tree_util.keystr(k): v for k, v in
            jref.jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree):
    out = {}
    tree_map_with_path(lambda path, t: out.__setitem__(path, t), tree)
    return out


def close_caches(jref, dtype, got, want, family="dense"):
    """Every cache leaf: in float32 configs the attention keys and values
    and MLA's latents and rope keys (bfloat16 in both) at one bfloat16 ulp, the rest at `tol`; the
    bfloat16 hybrid's in relative L2 norm."""
    fj, ft = flat_ref(jref, want), flat_port(got)
    assert sorted(ft) == sorted(fj)
    for path, t in ft.items():
        w = np.asarray(fj[path], np.float32)
        assert tuple(t.shape) == w.shape, path
        kv = path.endswith(("['k']", "['v']", "['ckv']", "['k_rope']"))
        if family == "hybrid" and dtype == "bfloat16":
            err = np.linalg.norm(t.to(torch.float32).numpy() - w)
            assert err <= HYBRID_L2 * np.linalg.norm(w), path
        elif kv and dtype == "float32" and family != "hybrid":
            close(t, w, KV_F32)
        else:
            close(t, w, tol(dtype, w, family))


def batches(jref, cfg, toks, **extra):
    """The same batch for both packages: the tokens (and `extra` arrays),
    plus seeded frame embeddings for the audio family and patch
    embeddings for the vlm family."""
    arrays = dict(tokens=toks, **extra)
    if cfg.family == "audio":
        arrays["frames"] = np.random.default_rng(9).standard_normal(
            (toks.shape[0], cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        arrays["patch_embeds"] = np.random.default_rng(10).standard_normal(
            (toks.shape[0], cfg.n_patches, cfg.d_model)).astype(np.float32)
    return ({k: jref.jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def greedy_tokens(jref, lj, lt):
    """Both packages' greedy tokens [B, 1] from their last logits, which
    must be equal, except where the reference's own logits tie exactly at
    the top: argmax then takes the first of values that one rounding in
    the last bit reorders, so the port's token need only be one of the
    tied ones (the deepseek-v3 bfloat16 smoke prefill has such a tie;
    ROADMAP Queue 3).  Both decode on from the reference's tokens."""
    want = np.asarray(lj[:, -1], np.float32)
    tok_j = want.argmax(-1)
    tok_t = lt[:, -1].argmax(-1).numpy()
    rows = np.arange(len(tok_j))
    tied = want[rows, tok_t] == want[rows, tok_j]
    np.testing.assert_array_equal(np.where(tied, tok_j, tok_t), tok_j)
    return (jref.jnp.asarray(tok_j[:, None]),
            torch.from_numpy(tok_j[:, None]))


def model_pair(jref, arch, dtype, **over):
    """(jax cfg, jax params, port cfg, port params) of an arch's smoke
    config, the reference's parameters carried over."""
    over = dict(dtype=dtype, param_dtype=dtype, **over)
    cj = jref.configs.get_smoke_config(arch).replace(remat=False, **over)
    ct = configs.get_smoke_config(arch).replace(**over)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    return cj, pj, ct, pt


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_configs_match_the_reference(arch, jref):
    for get in ("get_config", "get_smoke_config"):
        cj = getattr(jref.configs, get)(arch)
        ct = getattr(configs, get)(arch)
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), (get, f.name)
        assert ct.ssm_heads == cj.ssm_heads
        assert ct.param_count() == cj.param_count(), get
    assert arch in configs.ARCHS


@pytest.mark.parametrize("arch", ONCE_UNPORTED)
def test_other_archs_still_raise(arch, jref):
    """The last arch to be ported resolves as the reference's does, and
    the registry holds every arch of the reference's; an arch that
    neither package has still raises KeyError in both."""
    for get in ("get_config", "get_smoke_config"):
        assert getattr(configs, get)(arch).family \
            == getattr(jref.configs, get)(arch).family
    assert list(configs.ARCHS) == list(jref.configs.ARCHS)
    for get_config in (configs.get_config, jref.configs.get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get_config("no-such-arch")


def test_param_count_of_other_families_raises(jref):
    """vlm counts as the reference's dense trunk; a family that neither
    package builds raises in `param_count` and `init_params`."""
    cfg = configs.get_config("qwen3-14b")
    cj = jref.configs.get_config("qwen3-14b")
    assert cfg.replace(family="vlm").param_count() \
        == cj.replace(family="vlm").param_count() == cfg.param_count()
    with pytest.raises(ValueError, match="unknown family"):
        cfg.replace(family="vision").param_count()
    with pytest.raises(ValueError, match="unknown family"):
        models.init_params(0, cfg.replace(family="vision", n_layers=1),
                           device="cpu")


def test_published_sizes():
    """The sizes the families phase serves at: mamba2-130m ~168 M
    parameters, zamba2-1.2b ~1.17 B (the reference's formula)."""
    assert configs.get_config("mamba2-130m").param_count() == 167_497_728
    z = configs.get_config("zamba2-1.2b")
    assert z.param_count() == 1_170_066_432
    assert transformer._hybrid_layout(z) == (6, 6, 2)


# ---------------------------------------------------------------------------
# parameter and cache trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_init_params_has_the_reference_tree(arch, jref):
    cj = jref.configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    ct = configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    pj = jref.jax.eval_shape(
        lambda: jref.models.init_params(jref.jax.random.PRNGKey(0), cj))
    fj, ft = flat_ref(jref, pj), flat_port(
        models.init_params(0, ct, device="cpu"))
    assert sorted(ft) == sorted(fj)
    for path, t in ft.items():
        assert tuple(t.shape) == fj[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(fj[path].dtype), path


@pytest.mark.parametrize("arch,layers", [("mamba2-130m", 2),
                                         ("zamba2-1.2b", 5),
                                         ("zamba2-1.2b", 4)],
                         ids=["ssm", "hybrid", "hybrid-no-tail"])
def test_empty_caches_have_the_reference_layout(arch, layers, jref):
    cj = jref.configs.get_smoke_config(arch).replace(n_layers=layers)
    ct = configs.get_smoke_config(arch).replace(n_layers=layers)
    want = jref.models.empty_caches(cj, 3, CTX)
    got = models.empty_caches(ct, 3, CTX, device="cpu")
    if cj.family == "hybrid":
        assert (got["tail"] is None) == (want["tail"] is None)
    fj, ft = flat_ref(jref, want), flat_port(got)
    assert sorted(ft) == sorted(fj)
    for path, t in ft.items():
        assert tuple(t.shape) == fj[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(fj[path].dtype), path
        assert not t.any()


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_lm_from_jax_checks_the_depth(arch, jref):
    cj, pj, ct, pt = model_pair(jref, arch, "float32")
    assert transformer._depth(pt) == ct.n_layers
    with pytest.raises(ValueError, match="stacked layers"):
        models.lm_from_jax(jref.jax.tree.map(np.asarray, pj),
                           ct.replace(n_layers=ct.n_layers + 1),
                           device="cpu")
    for path, t in flat_port(pt).items():
        assert t.dtype == torch.float32, path


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_the_reference(arch, dtype, jref):
    """Prefill S tokens, splice into CTX-long caches, three greedy decode
    steps: logits, caches and tokens equal to the reference's.

    In float32 configs the attention caches are bfloat16 in both packages,
    so a float32 key or value within float32 noise of a bfloat16 midpoint
    rounds one ulp apart (`KV_F32` allows it), and a large one moves the
    next step's outputs by more than F32 (whisper-medium's smoke cross
    values 1.2695311 and 1.2695315, 3 float32 ulps apart, round to
    1.265625 and 1.2734375, and its next logits 2.1e-4 apart).  So there,
    after the port's spliced caches are held to the reference's, each
    step decodes from the reference's caches in both packages."""
    cj, pj, ct, pt = model_pair(jref, arch, dtype)
    fam = ct.family
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (B, S))
    batch_j, batch_t = batches(jref, cj, toks)
    lj, pre_j = jref.models.prefill(pj, cj, batch_j)
    lt, pre_t = models.prefill(pt, ct, batch_t)
    close(lt, lj, tol(dtype, lj, fam))
    close_caches(jref, dtype, pre_t, pre_j, fam)

    cache_j = jref.serve.splice_caches(jref.models.empty_caches(cj, B, CTX),
                                       pre_j)
    cache_t = serve.splice_caches(models.empty_caches(ct, B, CTX,
                                                      device="cpu"), pre_t)
    close_caches(jref, dtype, cache_t, cache_j, fam)
    tok_j, tok_t = greedy_tokens(jref, lj, lt)
    for i in range(3):
        if dtype == "float32":
            cache_t = tree_map(lambda a: transformer._to_torch(a, "cpu"),
                               jref.jax.tree.map(np.asarray, cache_j))
        pos = np.full(B, S + i)
        lj, cache_j = jref.models.decode_step(pj, cj, tok_j, cache_j,
                                              jref.jnp.asarray(pos), CTX)
        lt, cache_t = models.decode_step(pt, ct, tok_t, cache_t,
                                         torch.from_numpy(pos), CTX)
        close(lt, lj, tol(dtype, lj, fam))
        close_caches(jref, dtype, cache_t, cache_j, fam)
        tok_j, tok_t = greedy_tokens(jref, lj, lt)


def test_hybrid_float32_rounds_inside_the_scan():
    """Why the hybrid's float32 values are held at the bfloat16 rule: a
    1.2e-7 relative nudge of the embeddings moves the port's own states
    by more than a thousandth (the dense archs' float32 tolerance would
    not hold the port to itself)."""
    ct = configs.get_smoke_config("zamba2-1.2b").replace(
        dtype="float32", param_dtype="float32")
    params = models.init_params(0, ct, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, ct.vocab_size, (B, S)))
    _, base = models.prefill(params, ct, {"tokens": toks})
    gen = torch.Generator().manual_seed(1)
    nudged = dict(params, embed=params["embed"] * (
        1 + 1.2e-7 * torch.randn(params["embed"].shape, generator=gen)))
    _, moved = models.prefill(nudged, ct, {"tokens": toks})
    shift = (base["groups"]["state"] - moved["groups"]["state"]).abs().max()
    assert shift > 1e-3


def test_window_follows_the_context_length(jref):
    assert transformer.LONG_CTX_THRESHOLD == \
        jref.transformer.LONG_CTX_THRESHOLD
    for arch in PORTED:
        for ctx in (64, 131071, 131072, 524288):
            assert transformer._window_for(configs.get_config(arch), ctx) \
                == jref.transformer._window_for(
                    jref.configs.get_config(arch), ctx), (arch, ctx)


def test_hybrid_decode_windows_at_long_context(jref):
    """The ctx_len repair: zamba2 with an 8-token window decoding at
    position 20.  At ctx_len 131072 the shared attention is windowed, as
    in the reference; at 64 it is not, and the logits differ."""
    cj, pj, ct, pt = model_pair(jref, "zamba2-1.2b", "float32",
                                long_context_window=8)
    s0 = 20
    toks = np.random.default_rng(1).integers(0, cj.vocab_size, (B, s0))
    _, pre_j = jref.models.prefill(pj, cj, {"tokens": jref.jnp.asarray(toks)})
    _, pre_t = models.prefill(pt, ct, {"tokens": torch.from_numpy(toks)})
    cache_j = jref.serve.splice_caches(jref.models.empty_caches(cj, B, CTX),
                                       pre_j)
    cache_t = serve.splice_caches(models.empty_caches(ct, B, CTX,
                                                      device="cpu"), pre_t)
    tok = np.full((B, 1), 7)
    pos = np.full(B, s0)
    logits = {}
    for ctx_len in (131072, 64):
        lj, _ = jref.models.decode_step(pj, cj, jref.jnp.asarray(tok),
                                        cache_j, jref.jnp.asarray(pos),
                                        ctx_len)
        lt, _ = models.decode_step(pt, ct, torch.from_numpy(tok), cache_t,
                                   torch.from_numpy(pos), ctx_len)
        close(lt, lj, F32)
        logits[ctx_len] = lt
    assert (logits[131072] - logits[64]).abs().max() > 1e-3
    # the steps wrap the same decode
    from repro_torch.runtime import steps
    got, _ = steps.make_decode_step(ct, 131072)(
        pt, torch.from_numpy(tok), cache_t, torch.from_numpy(pos))
    assert torch.equal(got, logits[131072])


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b",
                                  "deepseek-v3-671b", "kimi-k2-1t-a32b",
                                  "whisper-medium"])
def test_train_loss_matches_the_reference(arch, jref):
    """The loss and its metrics at the float32 smoke config (the MoE
    archs' auxiliary losses included); the port with remat on (a
    checkpoint per layer, per group in the hybrid), its backward
    finite."""
    cj, pj, ct, pt = model_pair(jref, arch, "float32")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cj.vocab_size, (B, S))
    labels = np.where(rng.random((B, S)) < 0.2, -1,
                      rng.integers(0, cj.vocab_size, (B, S)))
    batch_j, batch_t = batches(jref, cj, toks, labels=labels)
    loss_j, met_j = jref.models.train_loss(pj, cj, batch_j)
    live = tree_map(lambda t: t.requires_grad_(True), pt)
    loss_t, met_t = models.train_loss(live, ct.replace(remat=True), batch_t)
    close(loss_t, loss_j, F32)
    for name in ("ce", "aux_lb", "aux_z", "ntokens"):
        close(met_t[name], met_j[name], F32)
    loss_t.backward()
    for path, t in flat_port(live).items():
        assert t.grad is not None and torch.isfinite(t.grad).all(), path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_args(arch):
    return ["--arch", arch, "--smoke-config", "--batch", "2",
            "--prompt-len", "16", "--gen", "5"]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_served_tokens_equal_the_reference(arch, jref):
    """`run_serve` with the reference's seeded weights and prompts carried
    over gives the reference's greedy stream."""
    argv = serve_args(arch)
    want, _ = jref.serve.run_serve(jref.serve.parse_args(argv))
    args = serve.parse_args(argv + ["--device", "cpu"])
    cfg = serve.build_cfg(args)
    key = jref.jax.random.PRNGKey(args.seed)
    pj = jref.models.init_params(key, jref.serve.build_cfg(args))
    toks = jref.jax.random.randint(jref.jax.random.fold_in(key, 1),
                                   (args.batch, args.prompt_len), 0,
                                   cfg.vocab_size)
    params = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), cfg,
                                device="cpu")
    got, stats = serve.run_serve(args, params=params,
                                 tokens=np.asarray(toks))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["arch"] == arch and stats["engine"] == "gpu"


def test_cli_serves_the_new_families_on_the_cpu():
    """The seeded port serves every new arch's smoke config, tokens inside
    the vocabulary (a DRIM engine serves the native route: no BitLinear)."""
    for arch in PORTED:
        args = serve.parse_args(serve_args(arch) + ["--device", "cpu"])
        gen, _ = serve.run_serve(args)
        assert gen.shape == (2, 5)
        assert 0 <= gen.min() and gen.max() < serve.build_cfg(args).vocab_size
    args = serve.parse_args(serve_args("mamba2-130m")
                            + ["--device", "cpu", "--engine", "resident"])
    again, _ = serve.run_serve(args)
    first, _ = serve.run_serve(serve.parse_args(
        serve_args("mamba2-130m") + ["--device", "cpu"]))
    np.testing.assert_array_equal(again, first)


def test_wave_batcher_refuses_the_hybrid(jref):
    cj, pj, ct, pt = model_pair(jref, "zamba2-1.2b", "bfloat16")
    with pytest.raises(NotImplementedError, match="nests differently"):
        jref.batching.WaveBatcher(cj, pj, n_slots=2, ctx_len=CTX)
    with pytest.raises(NotImplementedError, match="nests differently"):
        batching.WaveBatcher(ct, pt, n_slots=2, ctx_len=CTX, device="cpu")


def test_continuous_ssm_equals_the_reference(jref):
    """Two mamba2 requests of 16 and 8 tokens, the second a wave later,
    into 2 slots: each request's tokens equal the reference batcher's."""
    cj, pj, ct, pt = model_pair(jref, "mamba2-130m", "bfloat16")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cj.vocab_size, n) for n in (16, 8)]
    runs = []
    for b in (jref.batching.WaveBatcher(cj, pj, n_slots=2, ctx_len=CTX),
              batching.WaveBatcher(ct, pt, n_slots=2, ctx_len=CTX,
                                   device="cpu")):
        b.submit(prompts[0], 4, arrival_wave=0)
        b.submit(prompts[1], 4, arrival_wave=1)
        runs.append(b.run())
    for r in range(2):
        np.testing.assert_array_equal(runs[1][r], runs[0][r])


def test_cache_splice_and_insert_over_nested_caches(jref):
    """`insert_request` over SSM caches equals the reference's; over the
    hybrid's [G, per, batch, ...] groups both raise the mismatch; a None
    tail passes through `splice_caches`."""
    cj, pj, ct, pt = model_pair(jref, "mamba2-130m", "float32")
    toks = np.random.default_rng(4).integers(0, cj.vocab_size, (1, S))
    _, pre_j = jref.models.prefill(pj, cj, {"tokens": jref.jnp.asarray(toks)})
    _, pre_t = models.prefill(pt, ct, {"tokens": torch.from_numpy(toks)})
    full_t = tree_map(lambda t: t + 1.0, models.empty_caches(ct, 3, CTX,
                                                             device="cpu"))
    full_j = jref.jax.tree.map(lambda a: a + 1.0,
                               jref.models.empty_caches(cj, 3, CTX))
    got = batching.insert_request(full_t, pre_t, 1)
    want = jref.batching.insert_request(full_j, pre_j, 1)
    close_caches(jref, "float32", got, want)

    hj = jref.configs.get_smoke_config("zamba2-1.2b").replace(n_layers=4)
    ht = configs.get_smoke_config("zamba2-1.2b").replace(n_layers=4)
    one_j, one_t = (jref.models.empty_caches(hj, 1, CTX),
                    models.empty_caches(ht, 1, CTX, device="cpu"))
    many_j, many_t = (jref.models.empty_caches(hj, 3, CTX),
                      models.empty_caches(ht, 3, CTX, device="cpu"))
    with pytest.raises(ValueError, match="cache insert mismatch"):
        jref.batching.insert_request(many_j, one_j, 0)
    with pytest.raises(ValueError, match=r"cache insert mismatch at "
                       r"\['groups'\]"):
        batching.insert_request(many_t, one_t, 0)
    spliced = serve.splice_caches(many_t, many_t)
    assert spliced["tail"] is None
    assert flat_port(spliced).keys() == flat_port(many_t).keys()
