"""The port's expert-parallel MoE dispatch (`moe._ep_shard_map` under an
ambient mesh) held against the reference's, as
`tests/test_moe_dispatch.py` sets it up: kimi-k2's smoke config with the
capacity factor raised to the expert count, so that nothing drops, B=4,
S=16 float32 activations and the reference's own `moe_init` weights.

Bounds: the reference's own, 2e-5 on the outputs against its global
dispatch and 1e-3 on the gradients.  The port's meshes are explicit
device lists (`[cpu] * 8` is a real 2x4 split run block by block), so
no test here depends on how many host devices jax sees.  With one model
shard the EP output is the grouped dispatch's bit for bit.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core.mesh import abstract_mesh, make_named_mesh
from repro_torch.models import moe

CPU = torch.device("cpu")
B, S = 4, 16
TOL = dict(rtol=2e-5, atol=2e-5)


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
    from jax.sharding import AbstractMesh

    from repro import configs as jconfigs
    from repro.models import moe as jmoe
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=jconfigs,
                                 moe=jmoe, AbstractMesh=AbstractMesh)


@pytest.fixture(scope="module")
def setup(jref):
    """(jax cfg, jax params, jax x, port cfg, port params, port x), as
    the reference's `_setup`."""
    cj = jref.configs.get_smoke_config("kimi-k2-1t-a32b")
    cj = cj.replace(capacity_factor=float(cj.n_experts))
    ct = configs.get_smoke_config("kimi-k2-1t-a32b")
    ct = ct.replace(capacity_factor=float(ct.n_experts))
    key = jref.jax.random.PRNGKey(0)
    pj = jref.moe.moe_init(key, cj)
    xj = jref.jax.random.normal(jref.jax.random.fold_in(key, 1),
                                (B, S, cj.d_model), jref.jnp.float32)
    pt = jref.jax.tree.map(lambda a: torch.from_numpy(np.array(a)), pj)
    xt = torch.from_numpy(np.array(xj))
    return cj, pj, xj, ct, pt, xt


def test_ep_on_a_2x4_mesh_equals_the_reference_global(setup, jref):
    cj, pj, xj, ct, pt, xt = setup
    y_g, _ = jref.moe.moe_ffn(pj, cj.replace(moe_dispatch="global"), xj)
    calls = []
    inner = moe._ep_shard_map

    def spy(*args):
        calls.append(dict(args[-1].shape))
        return inner(*args)
    moe._ep_shard_map = spy
    try:
        with make_named_mesh((2, 4), ("data", "model"), [CPU] * 8):
            y_ep, _ = moe.moe_ffn(pt, ct.replace(moe_dispatch="ep"), xt)
    finally:
        moe._ep_shard_map = inner
    assert calls == [{"data": 2, "model": 4}]
    np.testing.assert_allclose(y_ep.numpy(), np.asarray(y_g), **TOL)


def test_ep_gradients_match_the_reference_global(setup, jref):
    cj, pj, xj, ct, pt, xt = setup

    def loss(pp, xx):
        return jref.moe.moe_ffn(pp, cj.replace(moe_dispatch="global"),
                                xx)[0].sum()
    g_ref = jref.jax.grad(loss)(pj, xj)
    live = jref.jax.tree.map(lambda a: a, pt)
    leaves = {"router": live["router"]["kernel"], "gate": live["gate"],
              "up": live["up"], "down": live["down"]}
    for name, t in leaves.items():
        t.requires_grad_(True)
    with make_named_mesh((2, 4), ("data", "model"), [CPU] * 8):
        y, _ = moe.moe_ffn(live, ct.replace(moe_dispatch="ep"), xt)
    grads = torch.autograd.grad(y.sum(), list(leaves.values()))
    want = {"router": g_ref["router"]["kernel"], "gate": g_ref["gate"],
            "up": g_ref["up"], "down": g_ref["down"]}
    worst = max(float(np.abs(g.numpy() - np.asarray(want[name])).max())
                for name, g in zip(leaves, grads))
    assert worst < 1e-3, worst


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "deepseek-v3-671b"])
def test_ep_on_one_model_shard_is_the_grouped_dispatch(arch, dtype):
    """Under a 1x1 mesh (the host mesh of one device) the EP output and
    auxiliary losses equal the grouped dispatch's bit for bit, at the
    smoke configs' own capacity (tokens drop)."""
    ct = configs.get_smoke_config(arch).replace(dtype=dtype,
                                                param_dtype=dtype)
    from repro_torch.models import init_params
    from repro_torch.tree import tree_slice
    p = tree_slice(init_params(0, ct, device="cpu")["layers"], 0)["moe"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, 32, ct.d_model)).astype(np.float32)).to(getattr(torch, dtype))
    y_grouped, aux_g = moe.moe_ffn(p, ct, x)
    with make_named_mesh((1, 1), ("data", "model"), [CPU]):
        assert moe.dispatch_mode(ct, 32, B) == "ep"
        y_ep, aux_e = moe.moe_ffn(p, ct, x)
    assert torch.equal(y_ep, y_grouped)
    for name in aux_g:
        assert torch.equal(aux_e[name], aux_g[name])


def test_ep_partials_sum_in_model_order(setup):
    """Two runs under the 1x8 mesh give equal outputs (the partials are
    summed in model-index order, not as they finish)."""
    *_, ct, pt, xt = setup
    with make_named_mesh((1, 8), ("data", "model"), [CPU] * 8):
        runs = [moe.moe_ffn(pt, ct, xt)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


MESH_GRID = [None, ((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
             ((8, 1), ("data", "model")), ((1, 8), ("data", "model")),
             ((1, 3), ("data", "model")), ((2, 2, 2), ("pod", "data",
                                                        "model")),
             ((4,), ("data",)), ((2, 2), ("chips", "model"))]


@pytest.mark.parametrize("dispatch", ["ep", "grouped", "global"])
def test_dispatch_mode_follows_ep_applicable(dispatch, jref):
    """On a grid of (mesh, b, s) the port's dispatch is "ep" exactly where
    the reference's `_ep_applicable` holds and "ep" is asked for, else
    "grouped" (s > 1) or "global", as the reference's `moe_ffn`
    resolves it."""
    cj = jref.configs.get_smoke_config("kimi-k2-1t-a32b")
    ct = configs.get_smoke_config("kimi-k2-1t-a32b").replace(
        moe_dispatch=dispatch)
    for spec in MESH_GRID:
        mj = None if spec is None else jref.AbstractMesh(*spec)
        mt = None if spec is None else abstract_mesh(*spec)
        for b in (1, 2, 3, 4, 8):
            for s in (1, 2, 16):
                ep = dispatch == "ep" and jref.moe._ep_applicable(
                    cj, mj, b, s)
                want = "ep" if ep else "grouped" if (
                    dispatch in ("ep", "grouped") and s > 1) else "global"
                if mt is None:
                    assert moe.dispatch_mode(ct, s, b) == want
                else:
                    with mt:
                        assert moe.dispatch_mode(ct, s, b) == want, \
                            (spec, b, s)
    assert moe.dispatch_mode(ct, 16) in ("grouped", "global")


def _within_ulps(e, g) -> bool:
    """Each logit within a bf16 ulp (2**-7) of its own |value| plus the
    logits' RMS: the card's EP x8 check (`chip_smoke.py`
    `ep_logits_check`)."""
    rms = float(g.pow(2).mean().sqrt())
    return bool(((e - g).abs() <= 2 ** -7 * (g.abs() + rms)).all())


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "kimi-k2-1t-a32b"])
def test_ep_over_8_shards_moves_bf16_logits_by_one_ulp(arch):
    """bf16, top-8 of 64 experts, d_model 512, one layer, 4 x 256 tokens:
    a prefill under a 1x8 mesh (partials summed per shard, then in model
    order) against the grouped dispatch.  The logits move by at most one
    bf16 ulp of the largest |logit|, and each by at most a ulp of its own
    value plus the logits' RMS (the card's EP x8 check, `chip_smoke.py`
    `EP_LOGIT_RTOL`); a share of them under a quarter moves (the sums
    round apart); greedy tokens are equal and the caches, which come
    before the layer's MoE, are equal.  Shard 0's partial dropped, or
    added twice, fails the per-logit bound and moves over a quarter."""
    from repro_torch.models import init_params, prefill
    from repro_torch.tree import tree_leaves
    full = configs.get_config(arch)
    cfg = configs.get_smoke_config(arch).replace(
        n_experts=64, top_k=full.top_k, n_layers=1, d_model=512,
        moe_d_ff=256, vocab_size=32768)
    assert cfg.dtype == "bfloat16"
    p = init_params(0, cfg.replace(param_dtype="bfloat16"), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 256)))
    g, g_caches = prefill(p, cfg, {"tokens": toks})
    with make_named_mesh((1, 8), ("data", "model"), [CPU] * 8):
        e, e_caches = prefill(p, cfg, {"tokens": toks})
    scale = max(1.0, float(g.abs().max()))
    assert float((e - g).abs().max()) <= 2 ** -7 * scale
    assert _within_ulps(e, g)
    moved = float((e != g).float().mean())
    assert 0 < moved < 0.25, moved
    assert torch.equal(e[:, -1].argmax(-1), g[:, -1].argmax(-1))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(e_caches),
                                                  tree_leaves(g_caches)))

    inner = moe._combine
    for factor in (0, 2):
        calls = []

        def planted(*args, factor=factor, calls=calls):
            calls.append(1)
            out = inner(*args)
            return out * factor if len(calls) % 8 == 1 else out
        moe._combine = planted
        try:
            with make_named_mesh((1, 8), ("data", "model"), [CPU] * 8):
                f, _ = prefill(p, cfg, {"tokens": toks})
        finally:
            moe._combine = inner
        assert len(calls) == 8
        assert not _within_ulps(f, g)
        assert float((f != g).float().mean()) > 0.25
