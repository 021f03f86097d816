"""The port's Mamba2 mixer (`repro_torch.models.ssm`) held against the JAX
reference's (`repro.models.ssm`) on the same seeded numpy inputs, and the
chunked scan against a float64 sequential oracle.

Tolerances.  In float32 everything is held at rtol = atol = 1e-4, as
`tests/test_torch_lm.py` holds the dense LM: both packages round the SSD
products' operands to bfloat16 at the same places and sum in float32 in
other orders.  In bfloat16 the mixer's bfloat16 outputs (the causal
conv, the mixer's output and its conv window) are held bit-equal
(`EXACT`): the port's SiLU rounds as XLA computes `jax.nn.silu`, 1 / (1 +
exp(-x)) rounded to bfloat16 after each op (`layers.silu`;
`torch.nn.functional.silu` rounds once, and silu(-0.3984375) would be
-0.16015625 against the reference's -0.15917969).  The float32 SSM
states, whose sums run in other orders, stay held to 4 bfloat16 ulps of
their magnitude: rtol = 1.6e-2 and atol = 1.6e-2 times the larger of 1
and the reference's largest |value| (`tol`).  The chunked
scan against the exact recurrence, and a prefill's state against
token-by-token decode, at the reference's own 0.05
(`tests/test_ssm_equiv.py`): the scan rounds its operands to bfloat16
on purpose.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.models import ssm, transformer
from repro_torch.tree import tree_map, tree_map_with_path

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1.6e-2, atol=1.6e-2)
EQUIV = dict(rtol=0.05, atol=0.05)
EXACT = dict(rtol=0, atol=0)
B, S = 2, 16


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
    from repro.models import ssm as jssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 ssm=jssm)


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), **tol)


def tol(dtype, want):
    """F32, or 4 bfloat16 ulps of the values' magnitude (the float32
    states of a bfloat16 mixer)."""
    if dtype == "float32":
        return F32
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return dict(rtol=BF16["rtol"], atol=BF16["atol"] * scale)


def to_torch(tree):
    return tree_map(lambda a: transformer._to_torch(np.asarray(a), "cpu"),
                    tree)


def activations(jref, dtype, shape, seed=0, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    return jref.jnp.asarray(xt.to(torch.float32).numpy(), dtype), xt


def scan_inputs(s, seed=0):
    """The reference test's inputs: x [2,s,3,4], dt [2,s,3], B and C
    [2,s,5], a_log [3], d_skip [3]."""
    rng = np.random.default_rng(seed)
    bsz, h, p, n = 2, 3, 4, 5
    return (rng.standard_normal((bsz, s, h, p)).astype(np.float32),
            np.abs(rng.standard_normal((bsz, s, h))).astype(np.float32)
            * 0.5,
            np.log(np.linspace(1.0, 4.0, h)).astype(np.float32),
            rng.standard_normal((bsz, s, n)).astype(np.float32),
            rng.standard_normal((bsz, s, n)).astype(np.float32),
            np.ones((h,), np.float32))


def sequential_oracle(x, dt, a_log, b_mat, c_mat, d_skip):
    """h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t;  y_t = C_t h_t + D x_t,
    token by token in float64."""
    x, dt, b_mat, c_mat = (np.asarray(v, np.float64)
                           for v in (x, dt, b_mat, c_mat))
    a = -np.exp(np.asarray(a_log, np.float64))
    state = np.zeros((x.shape[0], x.shape[2], x.shape[3], b_mat.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        state = state * np.exp(dt[:, t] * a[None, :])[:, :, None, None] \
            + np.einsum("bn,bhp->bhpn", b_mat[:, t],
                        x[:, t] * dt[:, t][..., None])
        ys.append(np.einsum("bn,bhpn->bhp", c_mat[:, t], state)
                  + x[:, t] * np.asarray(d_skip, np.float64)[None, :, None])
    return np.stack(ys, 1), state


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_ssd_chunked_matches_the_reference(chunk, jref, monkeypatch):
    """64 tokens in 8, 2 and 1 chunks: the inter-chunk recurrence runs at
    the first two."""
    monkeypatch.setattr(ssm, "CHUNK", chunk)
    monkeypatch.setattr(jref.ssm, "CHUNK", chunk)
    args = scan_inputs(64)
    y_j, fin_j = jref.ssm._ssd_chunked(*map(jref.jnp.asarray, args))
    y_t, fin_t = ssm._ssd_chunked(*map(torch.from_numpy, args))
    close(y_t, y_j, F32)
    close(fin_t, fin_j, F32)
    y_o, fin_o = sequential_oracle(*args)
    close(y_t, y_o, EQUIV)
    close(fin_t, fin_o, EQUIV)


def test_ssd_chunked_refuses_a_ragged_length(jref):
    """The reference asserts `s % chunk == 0` (chunk = min(256, s)); the
    port raises at the same lengths."""
    args = scan_inputs(300)
    with pytest.raises(AssertionError):
        jref.ssm._ssd_chunked(*map(jref.jnp.asarray, args))
    with pytest.raises(ValueError, match="not a multiple"):
        ssm._ssd_chunked(*map(torch.from_numpy, args))


def test_ssd_masks_in_log_space():
    """Large decays: a mask after exp would give inf * 0 = nan."""
    x, dt, a_log, b_mat, c_mat, d_skip = scan_inputs(32)
    y, fin = ssm._ssd_chunked(*map(torch.from_numpy, (
        x, dt * 200.0, a_log, b_mat, c_mat, d_skip)))
    assert torch.isfinite(y).all() and torch.isfinite(fin).all()


# ---------------------------------------------------------------------------
# the mixer's pieces at the mamba2 smoke config
# ---------------------------------------------------------------------------

def smoke_cfgs(jref, dtype):
    over = dict(dtype=dtype, param_dtype=dtype)
    return (jref.configs.get_smoke_config("mamba2-130m").replace(**over),
            configs.get_smoke_config("mamba2-130m").replace(**over))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mixer(request, jref):
    """(dtype, jax cfg, jax params, port cfg, port params) of one mixer."""
    cj, ct = smoke_cfgs(jref, request.param)
    pj = jref.ssm.ssm_init(jref.jax.random.PRNGKey(0), cj,
                           dtype=jref.jnp.dtype(request.param))
    return request.param, cj, pj, ct, to_torch(pj)


def same(dtype):
    """The rule for values in the mixer's dtype: F32, or bit-equal."""
    return F32 if dtype == "float32" else EXACT


def test_causal_conv_matches_the_reference(jref, mixer):
    dtype, cj, pj, ct, pt = mixer
    c = ct.d_inner + 2 * ct.ssm_state
    xj, xt = activations(jref, dtype, (B, S, c))
    want = jref.ssm._causal_conv(xj, pj["conv_w"], pj["conv_b"])
    got = ssm._causal_conv(xt, pt["conv_w"], pt["conv_b"])
    assert got.dtype == getattr(torch, dtype)
    close(got, want, same(dtype))


def test_ssm_mix_matches_the_reference(jref, mixer):
    dtype, cj, pj, ct, pt = mixer
    xj, xt = activations(jref, dtype, (B, S, ct.d_model), scale=0.5)
    yj, cj_ = jref.ssm.ssm_mix(pj, cj, xj)
    yt, ct_ = ssm.ssm_mix(pt, ct, xt)
    close(yt, yj, same(dtype))
    for name in ("state", "conv"):
        assert ct_[name].dtype == torch.float32
    close(ct_["state"], cj_["state"], tol(dtype, cj_["state"]))
    close(ct_["conv"], cj_["conv"], same(dtype))


def test_ssm_decode_matches_the_reference(jref, mixer):
    """Three decode steps from a prefill's cache."""
    dtype, cj, pj, ct, pt = mixer
    xj, xt = activations(jref, dtype, (B, S + 3, ct.d_model), scale=0.5)
    _, cache_j = jref.ssm.ssm_mix(pj, cj, xj[:, :S])
    _, cache_t = ssm.ssm_mix(pt, ct, xt[:, :S])
    for i in range(S, S + 3):
        yj, cache_j = jref.ssm.ssm_decode(pj, cj, xj[:, i:i + 1], cache_j)
        yt, cache_t = ssm.ssm_decode(pt, ct, xt[:, i:i + 1], cache_t)
        close(yt, yj, same(dtype))
        close(cache_t["state"], cache_j["state"],
              tol(dtype, cache_j["state"]))
        close(cache_t["conv"], cache_j["conv"], same(dtype))


def test_empty_cache_matches_the_reference(jref):
    cj, ct = smoke_cfgs(jref, "float32")
    want = jref.ssm.ssm_empty_cache(cj, 3)
    got = ssm.ssm_empty_cache(ct, 3, device="cpu")
    for name in ("state", "conv"):
        assert tuple(got[name].shape) == want[name].shape
        assert got[name].dtype == torch.float32 and not got[name].any()


def test_prefill_state_equals_decoding_token_by_token():
    """The reference's cache-consistency check on the port: the mixer's
    prefill cache equals running `ssm_decode` over the same tokens."""
    cfg = configs.get_smoke_config("mamba2-130m")
    p = ssm.ssm_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32) * 0.1)
    y_full, cache_full = ssm.ssm_mix(p, cfg, x)
    cache = ssm.ssm_empty_cache(cfg, B, device="cpu")
    ys = []
    for t in range(S):
        y_t, cache = ssm.ssm_decode(p, cfg, x[:, t:t + 1], cache)
        ys.append(y_t)
    close(y_full, torch.cat(ys, 1).numpy(), dict(rtol=0.08, atol=0.08))
    close(cache_full["state"], cache["state"].numpy(), EQUIV)
    close(cache_full["conv"], cache["conv"].numpy(), F32)


def test_ssm_init_has_the_reference_tree(jref):
    cj, ct = smoke_cfgs(jref, "bfloat16")
    pj = jref.jax.eval_shape(lambda: jref.ssm.ssm_init(
        jref.jax.random.PRNGKey(0), cj, dtype=jref.jnp.bfloat16))
    pt = ssm.ssm_init(torch.Generator().manual_seed(0), ct,
                      dtype=torch.bfloat16)
    flat_j = {jref.jax.tree_util.keystr(k): v for k, v in
              jref.jax.tree_util.tree_flatten_with_path(pj)[0]}
    flat_t = {}
    tree_map_with_path(lambda path, t: flat_t.__setitem__(path, t), pt)
    assert sorted(flat_t) == sorted(flat_j)
    for path, t in flat_t.items():
        assert tuple(t.shape) == flat_j[path].shape, path
        assert str(t.dtype).split(".")[-1] == str(flat_j[path].dtype), path
    # the reference's deterministic leaves, value for value
    pv = jref.ssm.ssm_init(jref.jax.random.PRNGKey(0), cj)
    for name in ("a_log", "d_skip", "dt_bias", "conv_b"):
        close(pt[name], pv[name], F32)
