"""The port's MLA, cross-attention, layernorm and the blocks that use them
(moe, whisper's encoder and xdec blocks) held against the JAX reference
on the deepseek-v3, kimi-k2 and whisper-medium smoke configs: the
reference's parameters carried over by `lm_from_jax`, the same numpy
activations through both packages.

Tolerances as `tests/test_torch_lm.py`: float32 within rtol = atol =
1e-4, except the float32 configs' decode caches, which are bfloat16 in
both packages (one bfloat16 ulp, rtol 2**-7); bfloat16 within 4 bfloat16
ulps of the values' magnitude (rtol 1.6e-2, atol 1.6e-2 times the larger
of 1 and the reference's largest |value|).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.models import attention, blocks, layers
from repro_torch.tree import tree_map, tree_slice

F32 = dict(rtol=1e-4, atol=1e-4)
CACHE_F32 = dict(rtol=2 ** -7, atol=1e-4)
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
    from repro.models import attention as jattn
    from repro.models import blocks as jblocks
    from repro.models import layers as jlayers
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, attn=jattn, blocks=jblocks,
                                 layers=jlayers)


def tol(dtype, want):
    if dtype == "float32":
        return F32
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return dict(rtol=1.6e-2, atol=1.6e-2 * scale)


def close(got, want, dtype, tolerance=None):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), w,
                               **(tolerance or tol(dtype, w)))


def layer_pair(jref, arch, dtype, stack="layers"):
    """(jax cfg, jax layer-0 params, port cfg, port layer-0 params) of an
    arch's smoke config, from the stacked tree `stack`."""
    over = dict(dtype=dtype, param_dtype=dtype)
    cj = jref.configs.get_smoke_config(arch).replace(remat=False, **over)
    ct = configs.get_smoke_config(arch).replace(**over)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    return (cj, jref.jax.tree.map(lambda a: a[0], pj[stack]), ct,
            tree_slice(pt[stack], 0))


def activations(jref, dtype, shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jref.jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def positions():
    pos = np.broadcast_to(np.arange(S), (B, S))
    return pos, torch.from_numpy(pos.copy())


def filled_cache(jref, dtype, shapes, seed):
    """The same random bfloat16 cache leaves in both packages."""
    rng = np.random.default_rng(seed)
    arrays = {k: rng.standard_normal(shp).astype(np.float32)
              for k, shp in shapes.items()}
    return ({k: jref.jnp.asarray(v).astype(jref.jnp.bfloat16)
             for k, v in arrays.items()},
            {k: torch.from_numpy(v).to(torch.bfloat16)
             for k, v in arrays.items()})


DTYPES = pytest.mark.parametrize("dtype", ["float32", "bfloat16"])


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

@DTYPES
def test_mla_attend_matches_the_reference(dtype, jref):
    cj, lj, ct, lt = layer_pair(jref, "deepseek-v3-671b", dtype)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model))
    pj, pt = positions()
    oj, cache_j = jref.attn.mla_attend(lj["attn"], cj, xj,
                                       jref.jnp.asarray(pj))
    ot, cache_t = attention.mla_attend(lt["attn"], ct, xt, pt)
    assert ot.dtype == xt.dtype
    close(ot, oj, dtype)
    assert cache_t["ckv"].shape == (B, S, ct.kv_lora_rank)
    assert cache_t["k_rope"].shape == (B, S, ct.qk_rope_dim)
    for name in ("ckv", "k_rope"):
        close(cache_t[name], cache_j[name], dtype)


@DTYPES
def test_mla_decode_matches_the_reference(dtype, jref):
    """One token at per-row positions 3 and 20 of a filled CTX cache."""
    cj, lj, ct, lt = layer_pair(jref, "deepseek-v3-671b", dtype)
    cache_j, cache_t = filled_cache(
        jref, dtype, {"ckv": (B, CTX, ct.kv_lora_rank),
                      "k_rope": (B, CTX, ct.qk_rope_dim)}, seed=1)
    xj, xt = activations(jref, dtype, (B, 1, ct.d_model), seed=2)
    at = np.array([3, 20])
    oj, new_j = jref.attn.mla_decode(lj["attn"], cj, xj, cache_j,
                                     jref.jnp.asarray(at))
    ot, new_t = attention.mla_decode(lt["attn"], ct, xt, cache_t,
                                     torch.from_numpy(at))
    close(ot, oj, dtype)
    for name in ("ckv", "k_rope"):
        assert new_t[name].dtype == torch.bfloat16
        close(new_t[name], new_j[name], dtype,
              CACHE_F32 if dtype == "float32" else None)
        # the rows other than the written positions are untouched
        keep = torch.ones(B, CTX, dtype=torch.bool)
        keep[torch.arange(B), torch.from_numpy(at)] = False
        assert torch.equal(new_t[name][keep], cache_t[name][keep])


def test_mla_windowed_decode_matches_the_reference(jref):
    cj, lj, ct, lt = layer_pair(jref, "deepseek-v3-671b", "float32")
    cache_j, cache_t = filled_cache(
        jref, "float32", {"ckv": (B, CTX, ct.kv_lora_rank),
                          "k_rope": (B, CTX, ct.qk_rope_dim)}, seed=3)
    xj, xt = activations(jref, "float32", (B, 1, ct.d_model), seed=4)
    at = np.array([12, 20])
    oj, _ = jref.attn.mla_decode(lj["attn"], cj, xj, cache_j,
                                 jref.jnp.asarray(at), window=5)
    ot, _ = attention.mla_decode(lt["attn"], ct, xt, cache_t,
                                 torch.from_numpy(at), window=5)
    close(ot, oj, "float32")


def test_mla_empty_cache_has_the_reference_layout(jref):
    cj = jref.configs.get_smoke_config("deepseek-v3-671b")
    ct = configs.get_smoke_config("deepseek-v3-671b")
    want = jref.attn.mla_empty_cache(cj, 3, CTX)
    got = attention.mla_empty_cache(ct, 3, CTX, device="cpu")
    for name in ("ckv", "k_rope"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.bfloat16 and not got[name].any()


# ---------------------------------------------------------------------------
# cross-attention, layernorm, the encoder's bidirectional block
# ---------------------------------------------------------------------------

@DTYPES
def test_cross_attend_matches_the_reference(dtype, jref):
    cj, lj, ct, lt = layer_pair(jref, "whisper-medium", dtype)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model), seed=5)
    ej, et = activations(jref, dtype, (B, ct.n_frames, ct.d_model), seed=6)
    kv_j = jref.attn.cross_kv(lj["cross"], cj, ej)
    kv_t = attention.cross_kv(lt["cross"], ct, et)
    for name in ("k", "v"):
        assert kv_t[name].shape == (B, ct.n_frames, ct.n_heads, ct.d_head)
        close(kv_t[name], kv_j[name], dtype)
    close(attention.cross_attend(lt["cross"], ct, xt, kv_t),
          jref.attn.cross_attend(lj["cross"], cj, xj, kv_j), dtype)


def test_layernorm_matches_the_reference(jref):
    rng = np.random.default_rng(7)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    init_j = jref.layers.layernorm_init(48)
    init_t = layers.layernorm_init(48)
    for name in ("scale", "bias"):
        close(init_t[name], init_j[name], "float32")
    for dtype in ("float32", "bfloat16"):
        xj, xt = activations(jref, dtype, (B, S, 48), seed=8)
        want = jref.layers.layernorm({k: jref.jnp.asarray(v)
                                      for k, v in p.items()}, xj * 3 + 1)
        got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                               xt * 3 + 1)
        assert got.dtype == xt.dtype
        close(got, want, dtype)


@DTYPES
def test_encoder_block_matches_the_reference(dtype, jref):
    """A whisper encoder layer: bidirectional attention (no mask) over the
    frames, rope on their positions."""
    cj, lj, ct, lt = layer_pair(jref, "whisper-medium", dtype,
                                stack="enc_layers")
    xj, xt = activations(jref, dtype, (B, ct.n_frames, ct.d_model), seed=9)
    pos = np.broadcast_to(np.arange(ct.n_frames), (B, ct.n_frames))
    yj, _, _ = jref.blocks.dense_block(lj, cj, xj, jref.jnp.asarray(pos),
                                       causal=False)
    yt, cache_t, aux = blocks.dense_block(lt, ct, xt,
                                          torch.from_numpy(pos.copy()),
                                          causal=False)
    close(yt, yj, dtype)
    assert aux == blocks.ZERO_AUX
    causal, _, _ = blocks.dense_block(lt, ct, xt, torch.from_numpy(pos.copy()))
    assert not torch.equal(causal, yt)


# ---------------------------------------------------------------------------
# the moe and xdec blocks
# ---------------------------------------------------------------------------

@DTYPES
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b"])
def test_moe_block_matches_the_reference(arch, dtype, jref):
    """Full sequence (output, cache, auxiliary losses), then one decode
    token against the prefill's cache spliced into CTX positions."""
    cj, lj, ct, lt = layer_pair(jref, arch, dtype)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model), seed=10)
    pj, pt = positions()
    yj, cache_j, aux_j = jref.blocks.moe_block(lj, cj, xj,
                                               jref.jnp.asarray(pj))
    yt, cache_t, aux_t = blocks.moe_block(lt, ct, xt, pt)
    close(yt, yj, dtype)
    assert sorted(cache_t) == sorted(cache_j)
    for name in cache_t:
        close(cache_t[name], cache_j[name], dtype)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]),
                                   rtol=1e-5, atol=1e-5)

    def pad(c, to_torch):
        widths = [(0, 0), (0, CTX - S)] + [(0, 0)] * (c.ndim - 2)
        a = np.pad(np.asarray(c, np.float32), widths)
        if to_torch:
            return torch.from_numpy(a).to(torch.bfloat16)
        return jref.jnp.asarray(a).astype(jref.jnp.bfloat16)
    full_j = {k: pad(v, False) for k, v in cache_j.items()}
    full_t = {k: pad(v, True) for k, v in cache_j.items()}
    x1j, x1t = activations(jref, dtype, (B, 1, ct.d_model), seed=11)
    at = np.full(B, S)
    dj, _ = jref.blocks.moe_block_decode(lj, cj, x1j, full_j,
                                         jref.jnp.asarray(at))
    dt, new_t = blocks.moe_block_decode(lt, ct, x1t, full_t,
                                        torch.from_numpy(at))
    close(dt, dj, dtype)
    assert sorted(new_t) == sorted(full_t)


@DTYPES
def test_xdec_block_matches_the_reference(dtype, jref):
    """Self- and cross-attention over encoder states: the block's output
    and caches, then one decode token against them."""
    cj, lj, ct, lt = layer_pair(jref, "whisper-medium", dtype)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model), seed=12)
    ej, et = activations(jref, dtype, (B, ct.n_frames, ct.d_model), seed=13)
    pj, pt = positions()
    yj, cache_j, _ = jref.blocks.xdec_block(lj, cj, xj, jref.jnp.asarray(pj),
                                            ej)
    yt, cache_t, aux = blocks.xdec_block(lt, ct, xt, pt, et)
    close(yt, yj, dtype)
    assert aux == blocks.ZERO_AUX
    for part in ("self", "cross"):
        for name in ("k", "v"):
            close(cache_t[part][name], cache_j[part][name], dtype)

    self_j, self_t = filled_cache(
        jref, dtype, {"k": (B, CTX, ct.n_kv_heads, ct.d_head),
                      "v": (B, CTX, ct.n_kv_heads, ct.d_head)}, seed=14)
    cross_t = tree_map(lambda t: t.to(torch.bfloat16), cache_t["cross"])
    cross_j = {k: jref.jnp.asarray(v.to(torch.float32).numpy()).astype(
        jref.jnp.bfloat16) for k, v in cross_t.items()}
    x1j, x1t = activations(jref, dtype, (B, 1, ct.d_model), seed=15)
    at = np.array([4, 17])
    dj, new_j = jref.blocks.xdec_block_decode(
        lj, cj, x1j, {"self": self_j, "cross": cross_j},
        jref.jnp.asarray(at))
    dt, new_t = blocks.xdec_block_decode(
        lt, ct, x1t, {"self": self_t, "cross": cross_t},
        torch.from_numpy(at))
    close(dt, dj, dtype)
    assert new_t["cross"] is cross_t
    for name in ("k", "v"):
        close(new_t["self"][name], new_j["self"][name], dtype,
              CACHE_F32 if dtype == "float32" else None)


# ---------------------------------------------------------------------------
# the trunk's trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b",
                                  "whisper-medium"])
def test_empty_caches_have_the_reference_layout(arch, jref):
    cj = jref.configs.get_smoke_config(arch)
    ct = configs.get_smoke_config(arch)
    want = jref.models.empty_caches(cj, 3, CTX)
    got = models.empty_caches(ct, 3, CTX, device="cpu")
    fj = {jref.jax.tree_util.keystr(k): v for k, v in
          jref.jax.tree_util.tree_flatten_with_path(want)[0]}
    ft = {}
    from repro_torch.tree import tree_map_with_path
    tree_map_with_path(lambda path, t: ft.__setitem__(path, t), got)
    assert sorted(ft) == sorted(fj)
    for path, t in ft.items():
        assert tuple(t.shape) == fj[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(fj[path].dtype), path
        assert not t.any()


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b",
                                  "whisper-medium"])
def test_lm_from_jax_carries_every_leaf(arch, jref):
    """Every leaf of the reference's bfloat16 tree (the float32 router
    included) arrives with its shape, dtype and values; a depth that does
    not match the config raises."""
    cj = jref.configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    ct = configs.get_smoke_config(arch).replace(param_dtype="bfloat16")
    pj = jref.jax.tree.map(
        np.asarray, jref.models.init_params(jref.jax.random.PRNGKey(0), cj))
    pt = models.lm_from_jax(pj, ct, device="cpu")
    fj = {jref.jax.tree_util.keystr(k): v for k, v in
          jref.jax.tree_util.tree_flatten_with_path(pj)[0]}
    ft = {}
    from repro_torch.tree import tree_map_with_path
    tree_map_with_path(lambda path, t: ft.__setitem__(path, t), pt)
    assert sorted(ft) == sorted(fj)
    for path, t in ft.items():
        assert str(t.dtype).split(".")[-1] == str(fj[path].dtype), path
        np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                      np.asarray(fj[path], np.float32))
    if ct.family == "moe":
        assert pt["layers"]["moe"]["router"]["kernel"].dtype == torch.float32
        assert pt["layers"]["moe"]["gate"].shape == (
            ct.n_layers, ct.n_experts, ct.d_model, ct.moe_d_ff)
    with pytest.raises(ValueError, match="stacked layers"):
        models.lm_from_jax(pj, ct.replace(n_layers=ct.n_layers + 1),
                           device="cpu")
    if ct.family == "audio":
        with pytest.raises(ValueError, match="encoder layers"):
            models.lm_from_jax(pj, ct.replace(encoder_layers=3),
                               device="cpu")
