"""The port's MoE FFN (`repro_torch.models.moe`) held against the JAX
reference's (`repro.models.moe`) on the kimi-k2 and deepseek-v3 smoke
configs: the reference's parameters carried over by `lm_from_jax`, the
same numpy activations through both packages.

Exact: capacities, top-k indices (ties included), routing indices, sort
order, capacity slots, keep masks and the dispatched buffers.  Values:
float32 within rtol = atol = 1e-5; bfloat16 within 4 bfloat16 ulps of
their magnitude (rtol 1.6e-2, atol 1.6e-2 times the larger of 1 and the
reference's largest |value|).  The expert einsums sum in another order
in the two packages, so a bfloat16 expert output differs in its last bit
now and then; the port's SiLU rounds as XLA's does (`layers.silu`), and
its combine adds in the reference's order, so given the same expert
outputs it equals the reference's bit for bit.

The reference is imported by the `jref` fixture, so the tests marked
`cuda` also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_moe.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, models
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import batching
from repro_torch.models import layers, moe
from repro_torch.tree import tree_map, tree_slice

F32 = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 64


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
    from repro.models import moe as jmoe
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 models=jmodels, moe=jmoe,
                                 batching=jbatching)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tol(dtype, want):
    if dtype == "float32":
        return F32
    scale = max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))
    return dict(rtol=1.6e-2, atol=1.6e-2 * scale)


def close(got, want, dtype):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(), w,
                               **tol(dtype, w))


def equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def layer_pair(jref, arch, dtype, **over):
    """(jax cfg, jax moe params, port cfg, port moe params) of layer 0 of
    an arch's smoke config."""
    over = dict(dtype=dtype, param_dtype=dtype, **over)
    cj = jref.configs.get_smoke_config(arch).replace(remat=False, **over)
    ct = configs.get_smoke_config(arch).replace(**over)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    lj = jref.jax.tree.map(lambda a: a[0], pj["layers"]["moe"])
    return cj, lj, ct, tree_slice(pt["layers"], 0)["moe"]


def activations(jref, dtype, shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jref.jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


# ---------------------------------------------------------------------------
# routing pieces
# ---------------------------------------------------------------------------

def test_capacity_matches_the_reference(jref):
    for arch in ("kimi-k2-1t-a32b", "deepseek-v3-671b"):
        for get in (configs.get_config, configs.get_smoke_config):
            ct = get(arch)
            for cf in (1.0, 1.25, 2.0):
                c = ct.replace(capacity_factor=cf)
                for tokens in (1, 4, 16, 64, 256, 1024, 4096):
                    assert moe._capacity(tokens, c) == \
                        jref.moe._capacity(tokens, c), (arch, cf, tokens)
    kimi = configs.get_config("kimi-k2-1t-a32b")
    ds = configs.get_config("deepseek-v3-671b")
    # the card's legs: a batch-4 decode step and a 256-token prefill row
    assert moe._capacity(4, ds) == 8 and moe._capacity(256, ds) == 16
    assert moe._capacity(4, kimi) == 8 and moe._capacity(256, kimi) == 8


def test_topk_local_breaks_ties_as_the_reference(jref):
    """Probabilities with many ties (values on a coarse grid): indices
    equal, first index first, weights equal."""
    rng = np.random.default_rng(1)
    probs = (rng.integers(0, 4, (3, 5, 16)) / 4).astype(np.float32)
    probs[0, 0] = 0.5                            # a row of one value
    for k in (1, 2, 8, 16):
        wj, ej = jref.moe._topk_local(jref.jnp.asarray(probs), k)
        wt, et = moe._topk_local(torch.from_numpy(probs), k)
        equal(et, ej)
        equal(wt, wj)
    assert moe._topk_local(torch.from_numpy(probs), 4)[1][0, 0].tolist() \
        == [0, 1, 2, 3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_route_matches_the_reference(arch, dtype, jref):
    cj, lj, ct, lt = layer_pair(jref, arch, dtype)
    assert lt["router"]["kernel"].dtype == torch.float32
    xj, xt = activations(jref, dtype, (B, S, ct.d_model))
    wj, ej, aux_j = jref.moe._route(lj, cj, xj)
    wt, et, aux_t = moe._route(lt, ct, xt)
    equal(et, ej)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **F32)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux_t[name]),
                                   float(aux_j[name]), **F32)


@pytest.mark.parametrize("cf", [1.0, 1.25])
def test_sort_dispatch_matches_the_reference(cf, jref):
    """One group of B*S tokens: the sort, ranks, slots, keep mask and the
    dispatched buffer equal the reference's; capacity factor 1.0 drops
    assignments."""
    cj, lj, ct, lt = layer_pair(jref, "kimi-k2-1t-a32b", "float32",
                                capacity_factor=cf)
    xj, xt = activations(jref, "float32", (B * S, ct.d_model), seed=2)
    wj, ej, _ = jref.moe._route(lj, cj, xj)
    wt, et, _ = moe._route(lt, ct, xt)
    cap = moe._capacity(B * S, ct)
    in_j, (slot_j, st_j, sw_j, keep_j) = jref.moe._sort_dispatch(
        cj, xj, ej, wj, cap)
    in_t, (slot_t, st_t, sw_t, keep_t, _) = moe._sort_dispatch(
        ct, xt[None], et[None], wt[None], cap)
    equal(slot_t[0], slot_j)
    equal(st_t[0], st_j)
    equal(keep_t[0], keep_j)
    equal(in_t[0], in_j)
    np.testing.assert_allclose(sw_t[0].numpy(), np.asarray(sw_j), **F32)
    if cf == 1.0:
        assert not keep_t.all()


def test_combine_adds_in_the_reference_order(jref):
    """bfloat16: given the reference's expert outputs, the port's combine
    equals the reference's bit for bit (each token's k terms added one at
    a time in the sorted order)."""
    cj, lj, ct, lt = layer_pair(jref, "kimi-k2-1t-a32b", "bfloat16")
    xj, xt = activations(jref, "bfloat16", (B, S, ct.d_model), seed=3)
    wj, ej, _ = jref.moe._route(lj, cj, xj)
    wt, et, _ = moe._route(lt, ct, xt)
    cap = moe._capacity(S, ct)
    in_j, ctx_j = jref.jax.vmap(
        lambda a, b, c: jref.moe._sort_dispatch(cj, a, b, c, cap))(xj, ej, wj)
    _, ctx_t = moe._sort_dispatch(ct, xt, et, wt, cap)
    out_j = jref.moe._expert_mlps(lj, xj.dtype, in_j)
    y_j = jref.jax.vmap(lambda eo, c: jref.moe._combine(cj, eo, c, S))(
        out_j, ctx_j)
    out_t = torch.from_numpy(np.asarray(out_j, np.float32)).to(
        torch.bfloat16)
    equal(moe._combine(ct, out_t, ctx_t, S).to(torch.float32),
          np.asarray(y_j, np.float32))


def test_silu_rounds_as_the_reference(jref):
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 4
    for dtype in ("float32", "bfloat16"):
        want = jref.jax.nn.silu(jref.jnp.asarray(x).astype(dtype))
        got = layers.silu(torch.from_numpy(x).to(getattr(torch, dtype)))
        if dtype == "bfloat16":
            equal(got.to(torch.float32), np.asarray(want, np.float32))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_dispatch_mode_resolves_as_the_reference():
    ct = configs.get_smoke_config("kimi-k2-1t-a32b")
    assert ct.moe_dispatch == "ep"
    assert moe.dispatch_mode(ct, 16) == "grouped"
    assert moe.dispatch_mode(ct, 1) == "global"
    for mode in ("grouped", "global"):
        assert moe.dispatch_mode(ct.replace(moe_dispatch=mode), 1) == "global"
    assert moe.dispatch_mode(ct.replace(moe_dispatch="global"), 16) \
        == "global"


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [1.0, 1.25], ids=["drops", "cf1.25"])
@pytest.mark.parametrize("dispatch", ["global", "grouped", "ep"])
def test_moe_ffn_matches_the_reference(dispatch, cf, dtype, jref):
    """y and both auxiliary losses, kimi-k2's smoke layer (with its shared
    expert), B x S tokens; "ep" off a mesh is "grouped" in both."""
    cj, lj, ct, lt = layer_pair(jref, "kimi-k2-1t-a32b", dtype,
                                moe_dispatch=dispatch, capacity_factor=cf)
    xj, xt = activations(jref, dtype, (B, S, ct.d_model), seed=5)
    yj, aux_j = jref.moe.moe_ffn(lj, cj, xj)
    yt, aux_t = moe.moe_ffn(lt, ct, xt)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape
    close(yt, yj, dtype)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux_t[name]), float(aux_j[name]),
                                   **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_decode_step_matches_the_reference(dtype, jref):
    """S == 1 takes the global dispatch at capacity 8 (deepseek-v3's
    layer, no shared-expert difference: it has one too)."""
    cj, lj, ct, lt = layer_pair(jref, "deepseek-v3-671b", dtype)
    xj, xt = activations(jref, dtype, (4, 1, ct.d_model), seed=6)
    yj, _ = jref.moe.moe_ffn(lj, cj, xj)
    yt, _ = moe.moe_ffn(lt, ct, xt)
    close(yt, yj, dtype)


def test_moe_ffn_backward_is_finite(jref):
    cj, lj, ct, lt = layer_pair(jref, "kimi-k2-1t-a32b", "float32")
    live = {k: v for k, v in lt.items()}
    leaves = [live["gate"], live["up"], live["down"],
              live["router"]["kernel"]]
    for t in leaves:
        t.requires_grad_(True)
    _, xt = activations(jref, "float32", (B, S, ct.d_model), seed=7)
    y, aux = moe.moe_ffn(live, ct, xt)
    (y.square().mean() + aux["load_balance"] + aux["router_z"]).backward()
    for t in leaves:
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert live["router"]["kernel"].grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# initialisation and parameter counts
# ---------------------------------------------------------------------------

def test_expert_banks_do_not_depend_on_the_thread_count():
    """A bank drawn on 1 and on 4 threads, and the trunk's banks (drawn
    on one thread per core) against the same layer drawn again from a
    replayed generator on 1 thread: equal bit for bit."""
    from repro_torch.models import blocks
    ct = configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        param_dtype="bfloat16")
    bank = moe.moe_init(torch.Generator().manual_seed(3), ct,
                        dtype=torch.bfloat16)["gate"]
    assert isinstance(bank, moe.ExpertBank)
    assert bank.shape == (ct.n_experts, ct.d_model, ct.moe_d_ff)

    def draw(b, threads):
        return b.draw_into(torch.empty(b.shape, dtype=b.dtype), threads)
    one = draw(bank, 1)
    assert one.dtype == torch.bfloat16 and torch.equal(one, draw(bank, 4))
    assert torch.equal(one[5], bank.expert(5))
    with pytest.raises(ValueError, match="bank"):
        bank.draw_into(torch.empty(1, 2, 3, dtype=torch.bfloat16))

    got = models.init_params(0, ct, device="cpu")["layers"]["moe"]
    gen = torch.Generator().manual_seed(0)
    torch.randn(ct.vocab_size, ct.d_model, generator=gen)     # embed
    torch.randn(ct.d_model, ct.vocab_size, generator=gen)     # head
    for layer in range(ct.n_layers):
        want = blocks.moe_block_init(gen, ct, dtype=torch.bfloat16)["moe"]
        for name in ("gate", "up", "down"):
            assert torch.equal(got[name][layer], draw(want[name], 1)), name
    g = got["gate"]                     # every expert of every layer apart
    assert not torch.equal(g[0, 0], g[1, 0])
    assert not torch.equal(g[0, 0], g[0, 1])


def test_router_stays_float32_under_bfloat16_params():
    ct = configs.get_smoke_config("deepseek-v3-671b").replace(
        param_dtype="bfloat16")
    p = models.init_params(0, ct, device="cpu")["layers"]["moe"]
    assert p["router"]["kernel"].dtype == torch.float32
    assert p["gate"].dtype == p["shared"]["gate"]["kernel"].dtype \
        == torch.bfloat16
    assert p["down"].shape == (ct.n_layers, ct.n_experts, ct.moe_d_ff,
                               ct.d_model)


def test_init_keeps_the_dense_weights():
    """Moving each layer to the device as it is drawn keeps the draw
    order: the stacked weights equal the ones drawn layer by layer from
    one generator."""
    from repro_torch.models import blocks
    from repro_torch.tree import tree_stack
    ct = configs.get_smoke_config("qwen3-14b")
    got = models.init_params(0, ct, device="cpu")
    gen = torch.Generator().manual_seed(0)
    torch.randn(*got["embed"].shape, generator=gen)
    torch.randn(*got["head"].shape, generator=gen)
    want = tree_stack([blocks.dense_block_init(gen, ct)
                       for _ in range(ct.n_layers)])
    assert torch.equal(got["layers"]["attn"]["wq"]["kernel"],
                       want["attn"]["wq"]["kernel"])
    assert torch.equal(got["layers"]["mlp"]["down"]["kernel"],
                       want["mlp"]["down"]["kernel"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_match_the_reference(arch, jref):
    for get in ("get_config", "get_smoke_config"):
        ct = getattr(configs, get)(arch)
        cj = getattr(jref.configs, get)(arch)
        assert ct.param_count() == cj.param_count(), get
        assert ct.active_param_count() == cj.active_param_count(), get


def test_published_moe_sizes():
    ds = configs.get_config("deepseek-v3-671b")
    kimi = configs.get_config("kimi-k2-1t-a32b")
    assert ds.param_count() == 703_796_805_632
    assert kimi.param_count() == 1_044_859_977_728
    assert ds.active_param_count() < ds.param_count() // 10
    one = ds.replace(n_layers=1)
    experts = 3 * ds.n_experts * ds.d_model * ds.moe_d_ff
    assert experts == 11_274_289_152
    assert one.param_count() - 2 * ds.vocab_size * ds.d_model \
        == 11_507_269_632


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_wave_batcher_serves_kimi_smoke(jref):
    """Two kimi-k2 requests of 16 and 8 tokens, the second a wave later,
    into 2 slots: each request's tokens equal the reference batcher's."""
    over = dict(dtype="float32", param_dtype="float32")
    cj = jref.configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        remat=False, **over)
    ct = configs.get_smoke_config("kimi-k2-1t-a32b").replace(**over)
    pj = jref.models.init_params(jref.jax.random.PRNGKey(0), cj)
    pt = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj), ct,
                            device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cj.vocab_size, n) for n in (16, 8)]
    runs = []
    for b in (jref.batching.WaveBatcher(cj, pj, n_slots=2, ctx_len=24),
              batching.WaveBatcher(ct, pt, n_slots=2, ctx_len=24,
                                   device="cpu")):
        b.submit(prompts[0], 4, arrival_wave=0)
        b.submit(prompts[1], 4, arrival_wave=1)
        runs.append(b.run())
    for r in range(2):
        np.testing.assert_array_equal(runs[1][r], runs[0][r])


def test_wave_batcher_refuses_audio():
    ct = configs.get_smoke_config("whisper-medium")
    with pytest.raises(NotImplementedError, match="nests differently"):
        batching.WaveBatcher(ct, None, n_slots=2, ctx_len=24, device="cpu")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_on_the_card_equals_the_cpu(dtype, cuda):
    """Seeded kimi-k2 smoke layer: the card's routing indices equal the
    CPU's (no near-tie at this seed) and y within the module's
    tolerances; two card runs are bitwise equal."""
    ct = configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        dtype=dtype, param_dtype=dtype)
    p = tree_slice(models.init_params(0, ct, device="cpu")["layers"],
                   0)["moe"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, ct.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    torch.backends.cuda.matmul.allow_tf32 = False
    y_cpu, aux_cpu = moe.moe_ffn(p, ct, x)
    p_card = tree_map(lambda t: t.to(cuda), p)
    _, e_cpu, _ = moe._route(p, ct, x)
    _, e_card, _ = moe._route(p_card, ct, x.to(cuda))
    assert torch.equal(e_card.cpu(), e_cpu)
    y1, aux1 = moe.moe_ffn(p_card, ct, x.to(cuda))
    y2, _ = moe.moe_ffn(p_card, ct, x.to(cuda))
    assert torch.equal(y1, y2)
    close(y1.cpu(), y_cpu.to(torch.float32).numpy(), dtype)
    for name in aux_cpu:
        np.testing.assert_allclose(float(aux1[name]), float(aux_cpu[name]),
                                   rtol=1e-4, atol=1e-5)
