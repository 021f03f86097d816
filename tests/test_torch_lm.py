"""The port's drim-bnn LM held against the JAX reference, module by module:
the reference's SMOKE_CONFIG parameters carried over by `lm_from_jax`,
and the same numpy inputs and tokens through both packages.

Tolerances.  In float32 (`dtype` and `param_dtype` float32) everything is
held at rtol = atol = 1e-4: the two frameworks sum in other orders, and
the decode caches are bfloat16 in both (the reference's cache dtype).  In
the served bfloat16 configuration the two frameworks round at other
places (torch's softmax rounds once after float32 internals, XLA may
round between its ops; the SiLU rounds after each op in both,
`layers.silu`), so values are held to 4 bfloat16 ulps
of their magnitude (rtol = atol = 1.6e-2, |logits| < 1 here) and the
greedy tokens must be equal.  BitLinear dots are exact in both.

The reference is imported by the `jref` fixture, so the tests marked
`cuda` also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_lm.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.core import DRIM_R
from repro_torch.models import attention, blocks, layers, transformer
from repro_torch.tree import tree_map_with_path, tree_slice

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
TOL = {"float32": F32, "bfloat16": BF16}
# The decode caches are bfloat16 in both packages: a float32 key that
# differs in its last bits may round to a neighbouring bfloat16 (one ulp:
# up to 2**-7 relative, just above a power of two).
CACHE_TOL = {"float32": dict(rtol=2 ** -7, atol=1e-4), "bfloat16": BF16}
B, S, CTX = 2, 16, 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and their
    thread pools contending for the cores made the full-width engine
    routes run a hundred times slower than alone."""
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
    from repro.launch import serve as jserve
    from repro.models import attention as jattn
    from repro.models import blocks as jblocks
    from repro.models import layers as jlayers
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, attn=jattn, blocks=jblocks,
                                 layers=jlayers, serve=jserve)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def configs_for(jref, dtype):
    over = dict(dtype=dtype, param_dtype=dtype)
    return (jref.configs.get_smoke_config("drim-bnn").replace(remat=False,
                                                             **over),
            configs.get_smoke_config("drim-bnn").replace(**over))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request, jref):
    """(dtype, jax cfg, jax params, port cfg, port params)."""
    cj, ct = configs_for(jref, request.param)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    return request.param, cj, pj, ct, pt


def layer0(jref, pj, pt):
    return (jref.jax.tree.map(lambda a: a[0], pj["layers"]),
            tree_slice(pt["layers"], 0))


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def activations(jref, dtype, shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jref.jnp.asarray(xt.to(torch.float32).numpy(), dtype), xt


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------

def test_configs_match_the_reference(jref):
    for get in ("get_config", "get_smoke_config"):
        cj = getattr(jref.configs, get)("drim-bnn")
        ct = getattr(configs, get)("drim-bnn")
        for f in dataclasses.fields(ct):
            assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    assert configs.get_config("drim-bnn").activation_dtype == torch.bfloat16
    assert configs.get_config("llava-next-34b").family \
        == jref.configs.get_config("llava-next-34b").family == "vlm"
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")


def test_init_params_has_the_reference_tree(jref):
    cj, ct = configs_for(jref, "bfloat16")
    pj = jref.jax.eval_shape(
        lambda: jref.models.init_params(jref.jax.random.PRNGKey(0), cj))
    pt = models.init_params(0, ct, device="cpu")
    flat_j = {jref.jax.tree_util.keystr(k): v for k, v in
              jref.jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_t = {}
    tree_map_with_path(lambda path, t: flat_t.__setitem__(path, t), pt)
    assert sorted(flat_t) == sorted(flat_j)
    for path, t in flat_t.items():
        assert tuple(t.shape) == flat_j[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(flat_j[path].dtype), path
    # the reference's distributions: He-normal kernels, 0.01 embed/head
    w = pt["layers"]["mlp"]["up"]["bkernel"].to(torch.float32)
    assert abs(float(w.std()) * np.sqrt(ct.d_model) - 1) < 0.05
    assert abs(float(pt["embed"].to(torch.float32).std()) - 0.01) < 1e-3
    again = models.init_params(0, ct, device="cpu")
    assert torch.equal(again["head"], pt["head"])


def test_lm_from_jax_checks_the_config(jref, model):
    _, cj, pj, ct, _ = model
    pn = jref.jax.tree.map(np.asarray, pj)
    with pytest.raises(ValueError, match="stacked layers"):
        models.lm_from_jax(pn, ct.replace(n_layers=3), device="cpu")
    with pytest.raises(ValueError, match="embed"):
        models.lm_from_jax(pn, ct.replace(d_model=64), device="cpu")


# ---------------------------------------------------------------------------
# layers, attention, block
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope(jref, model):
    dtype, cj, pj, ct, pt = model
    xj, xt = activations(jref, dtype, (B, S, ct.n_heads, ct.d_head))
    scale = {"scale": np.linspace(0.5, 1.5, ct.d_head, dtype=np.float32)}
    close(layers.rmsnorm({"scale": torch.from_numpy(scale["scale"])}, xt),
          jref.layers.rmsnorm(scale, xj), TOL[dtype])
    pos = np.random.default_rng(1).integers(0, 4096, (B, S))
    close(layers.apply_rope(xt, torch.from_numpy(pos), ct.rope_theta),
          jref.layers.apply_rope(xj, jref.jnp.asarray(pos), cj.rope_theta),
          TOL[dtype])


def test_bitlinear_mlp(jref, model):
    dtype, cj, pj, ct, pt = model
    lj, lt = layer0(jref, pj, pt)
    assert "bkernel" in lt["mlp"]["up"]          # bitlinear="ffn"
    xj, xt = activations(jref, dtype, (B, S, ct.d_model))
    close(layers.mlp(lt["mlp"], xt), jref.layers.mlp(lj["mlp"], xj),
          TOL[dtype])


def test_gqa_attend_and_decode(jref, model):
    dtype, cj, pj, ct, pt = model
    lj, lt = layer0(jref, pj, pt)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S))
    oj, cache_j = jref.attn.gqa_attend(lj["attn"], cj, xj,
                                       jref.jnp.asarray(pos))
    ot, cache_t = attention.gqa_attend(lt["attn"], ct, xt,
                                       torch.from_numpy(pos.copy()))
    close(ot, oj, TOL[dtype])
    for name in ("k", "v"):
        close(cache_t[name], cache_j[name], TOL[dtype])

    empty_j = jref.attn.gqa_empty_cache(cj, B, CTX)
    empty_t = attention.gqa_empty_cache(ct, B, CTX, device="cpu")
    cj2 = {k: empty_j[k].at[:, :S].set(cache_j[k].astype(empty_j[k].dtype))
           for k in empty_j}
    ct2 = {k: empty_t[k].clone() for k in empty_t}
    for k in ct2:
        ct2[k][:, :S] = cache_t[k].to(ct2[k].dtype)
    x1j, x1t = activations(jref, dtype, (B, 1, ct.d_model), seed=2)
    at = np.array([S, S - 3])                # two positions in one batch
    dj, nj = jref.attn.gqa_decode(lj["attn"], cj, x1j, cj2,
                                  jref.jnp.asarray(at))
    dt, nt = attention.gqa_decode(lt["attn"], ct, x1t, ct2,
                                  torch.from_numpy(at))
    close(dt, dj, TOL[dtype])
    for name in ("k", "v"):
        close(nt[name], nj[name], CACHE_TOL[dtype])


def test_dense_block(jref, model):
    dtype, cj, pj, ct, pt = model
    lj, lt = layer0(jref, pj, pt)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S))
    yj, cache_j, _ = jref.blocks.dense_block(lj, cj, xj, jref.jnp.asarray(pos))
    yt, cache_t, aux_t = blocks.dense_block(lt, ct, xt,
                                            torch.from_numpy(pos.copy()))
    close(yt, yj, TOL[dtype])
    close(cache_t["v"], cache_j["v"], TOL[dtype])
    assert aux_t == blocks.ZERO_AUX


# ---------------------------------------------------------------------------
# the trunk: prefill + three decode steps
# ---------------------------------------------------------------------------

def test_prefill_and_three_decode_steps(jref, model):
    dtype, cj, pj, ct, pt = model
    toks = np.random.default_rng(0).integers(0, cj.vocab_size, (B, S))
    lj, pre_j = jref.models.prefill(pj, cj, {"tokens": jref.jnp.asarray(toks)})
    lt, pre_t = models.prefill(pt, ct, {"tokens": torch.from_numpy(toks)})
    close(lt, lj, TOL[dtype])
    for name in ("k", "v"):
        close(pre_t[name], pre_j[name], TOL[dtype])

    cache_j = jref.serve.splice_caches(jref.models.empty_caches(cj, B, CTX),
                                       pre_j)
    from repro_torch.launch.serve import splice_caches
    cache_t = splice_caches(models.empty_caches(ct, B, CTX, device="cpu"),
                            pre_t)
    tok_j = jref.jnp.argmax(lj[:, -1], -1)[:, None]
    tok_t = lt[:, -1].argmax(-1)[:, None]
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    for i in range(3):
        pos = np.full(B, S + i)
        lj, cache_j = jref.models.decode_step(pj, cj, tok_j, cache_j,
                                              jref.jnp.asarray(pos), CTX)
        lt, cache_t = models.decode_step(pt, ct, tok_t, cache_t,
                                         torch.from_numpy(pos), CTX)
        close(lt, lj, TOL[dtype])
        for name in ("k", "v"):
            close(cache_t[name], cache_j[name], CACHE_TOL[dtype])
        tok_j = jref.jnp.argmax(lj[:, -1], -1)[:, None]
        tok_t = lt[:, -1].argmax(-1)[:, None]
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    assert models.decode_step_eager is models.decode_step


def test_packed_weights_from_the_reference(jref, model):
    """The reference's `pack_model_params` output carried over (uint32
    words become the port's int32 words): the port's packed prefill
    matches the reference's, and the port's own packing of the dense
    weights gives the same words."""
    dtype, cj, pj, ct, pt = model
    from repro_torch.launch.serve import pack_model_params
    packed_j = jref.serve.pack_model_params(pj)
    packed_t = models.lm_from_jax(jref.jax.tree.map(np.asarray, packed_j),
                                  ct, device="cpu")
    words = packed_t["layers"]["mlp"]["down"]["w_packed"]
    assert words.dtype == torch.int32
    assert torch.equal(words, pack_model_params(pt)["layers"]["mlp"]["down"]
                       ["w_packed"])
    toks = np.random.default_rng(2).integers(0, cj.vocab_size, (B, S))
    lj, _ = jref.models.prefill(packed_j, cj,
                                {"tokens": jref.jnp.asarray(toks)})
    lt, _ = models.prefill(packed_t, ct, {"tokens": torch.from_numpy(toks)})
    close(lt, lj, TOL[dtype])


def test_logits_mask_the_padded_vocab(jref):
    cj, ct = configs_for(jref, "float32")
    cj, ct = cj.replace(vocab_size=500), ct.replace(vocab_size=500)
    assert transformer.padded_vocab(ct) == 512
    rng = np.random.default_rng(4)
    p = {"final_norm": {"scale": np.ones(ct.d_model, np.float32)},
         "head": rng.standard_normal((ct.d_model, 512)).astype(np.float32)}
    x = rng.standard_normal((B, 1, ct.d_model)).astype(np.float32)
    want = jref.models.transformer._logits(
        {k: jref.jax.tree.map(jref.jnp.asarray, v) for k, v in p.items()},
        cj, jref.jnp.asarray(x))
    got = transformer._logits(
        {k: {"scale": torch.from_numpy(v["scale"])} if k == "final_norm"
         else torch.from_numpy(v) for k, v in p.items()}, ct,
        torch.from_numpy(x))
    close(got, want, F32)
    assert float(got[..., 500:].max()) == float(np.float32(-1e30))


def test_use_flash_is_the_reference_rule_on_the_card():
    cfg = configs.get_config("drim-bnn")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert attention._use_flash(cfg, 256, 0, cuda)
    assert attention._use_flash(cfg, 2048, 0, "cuda")
    assert not attention._use_flash(cfg, 200, 0, cuda)       # misaligned
    assert not attention._use_flash(cfg, 256, 64, cuda)      # windowed
    assert not attention._use_flash(cfg, 256, 0, cpu)        # the CPU
    assert not attention._use_flash(cfg.replace(attention_impl="xla"), 256,
                                    0, cuda)


# ---------------------------------------------------------------------------
# the exact STE product
# ---------------------------------------------------------------------------

def test_bfloat16_dense_bitlinear_equals_reference(jref):
    """The STE product in float32, rounded once: against the reference's
    bfloat16 `bitlinear` within one bfloat16 ulp (alpha = mean|w| is a
    bfloat16 mean in both, summed in other orders)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)
                         / 16).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(
        np.float32)).to(torch.bfloat16)
    want = jref.layers.bitlinear(
        {"bkernel": jref.jnp.asarray(w.float().numpy(), "bfloat16")},
        jref.jnp.asarray(x.float().numpy(), "bfloat16"))
    got = layers.bitlinear({"bkernel": w}, x)
    assert got.dtype == torch.bfloat16
    close(got, want, dict(rtol=2 ** -8, atol=0))
    dot = (torch.where(x >= 0, 1.0, -1.0) @ torch.where(w >= 0, 1.0, -1.0))
    assert torch.equal(got, dot.to(torch.bfloat16) * w.abs().mean(0))


@pytest.mark.cuda
def test_bfloat16_ste_product_is_exact_on_the_card(cuda):
    """M=4 decode rows at K=3072 (the down projection): the dense STE
    route, the packed kernel route and the DRIM route give the same
    bfloat16 outputs bit for bit, and their gradient still flows."""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.standard_normal((3072, 768)).astype(np.float32)
                         / 55).to(cuda, torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((4, 1, 3072)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    dense = layers.bitlinear({"bkernel": w}, x)
    packed = layers.pack_bitlinear({"bkernel": w})
    native = layers.bitlinear_packed(packed, x, 3072)
    with layers.serving_engine("cuda", geom=DRIM_R):
        drim = layers.bitlinear_packed(packed, x, 3072)
    torch.cuda.synchronize()
    assert torch.equal(dense, native) and torch.equal(dense, drim)
    wg = w.detach().float().requires_grad_()
    layers.bitlinear({"bkernel": wg}, x.float()).sum().backward()
    assert float(wg.grad.abs().sum()) > 0
