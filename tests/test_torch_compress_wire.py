"""The port's EF-compressed all-reduce (`optim.compress.compressed_allreduce`)
over `torch.distributed`, held against the reference's
(`repro.optim.compress.compressed_allreduce` under `shard_map`).

  * One rank (a gloo group over a `FileStore`): the result equals the
    reference's under a one-device `shard_map`, and every sign payload
    that reaches `dist.all_reduce` is int8 (a spy).
  * Eight ranks, spawned with `torch.multiprocessing` (gloo, their own
    60 s timeout): each rank's mean equals the reference's formula,
    mean(signs) * mean(scales) over the reference's `compress_grad` of
    each row of `tests/test_compress_wire.py`'s data, and each rank keeps
    its own residual.
  * No process group: the call raises, naming `init_process_group`.

Bounds: the reference test's rtol = atol = 1e-5 (the two packages take
the float32 mean |g| in other orders).
"""
import os
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.optim import compress

TOL = dict(rtol=1e-5, atol=1e-5)
WORLD = 8
SPAWN_TIMEOUT_S = 60


@pytest.fixture(scope="module")
def jref():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.optim import compress as jcompress
    return types.SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh, P=P,
                                 compress=jcompress)


def wire_data():
    """The reference test's gradient rows and zero residuals."""
    g = np.arange(64, dtype=np.float32).reshape(8, 8) - 30.0
    return g, np.zeros((8, 8), np.float32)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_equals_the_reference_shard_map(one_rank_group, jref,
                                                 monkeypatch):
    rng = np.random.default_rng(0)
    grads = {"w": rng.standard_normal((16, 8)).astype(np.float32),
             "b": {"c": rng.standard_normal(8).astype(np.float32)}}
    errs = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.1,
            "b": {"c": np.zeros(8, np.float32)}}
    mesh = jref.Mesh(np.array(jref.jax.devices()[:1]), ("data",))
    P = jref.P

    def body(g, e):
        return jref.compress.compressed_allreduce(g, e, ("data",))
    spec = jref.jax.tree.map(lambda _: P(), grads)
    want_mean, want_err = jref.jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec))(
        jref.jax.tree.map(jref.jnp.asarray, grads),
        jref.jax.tree.map(jref.jnp.asarray, errs))

    seen = []
    inner = dist.all_reduce

    def spy(t, *args, **kw):
        seen.append((t.dtype, tuple(t.shape)))
        return inner(t, *args, **kw)
    monkeypatch.setattr(dist, "all_reduce", spy)
    as_t = {"w": torch.from_numpy(grads["w"]),
            "b": {"c": torch.from_numpy(grads["b"]["c"])}}
    es_t = {"w": torch.from_numpy(errs["w"]),
            "b": {"c": torch.from_numpy(errs["b"]["c"])}}
    mean, new_err = compress.compressed_allreduce(as_t, es_t, ("data",))
    for got, want in ((mean["w"], want_mean["w"]),
                      (mean["b"]["c"], want_mean["b"]["c"]),
                      (new_err["w"], want_err["w"]),
                      (new_err["b"]["c"], want_err["b"]["c"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = [(d, s) for d, s in seen if s in ((16, 8), (8,))]
    assert sorted(full) == [(torch.int8, (8,)), (torch.int8, (16, 8))]
    assert [d for d, s in seen if (d, s) not in full] == [torch.float32]
    # one rank: the mean is the single-rank decode exactly
    signs, scales, errs_t = compress.compress_tree(as_t, es_t)
    dec = compress.decompress_tree(signs, scales)
    assert torch.equal(mean["w"], dec["w"])
    assert torch.equal(mean["b"]["c"], dec["b"]["c"])
    assert torch.equal(new_err["w"], errs_t["w"])


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    """One rank of the spawned world: its row of the wire data through
    `compressed_allreduce`, the result saved for the parent."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        g, e = wire_data()
        mean, new_err = compress.compressed_allreduce(
            {"g": torch.from_numpy(g[rank])},
            {"g": torch.from_numpy(e[rank])}, ("data",))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 mean=mean["g"].numpy(), err=new_err["g"].numpy())
    finally:
        dist.destroy_process_group()


def test_eight_ranks_equal_the_reference_formula(tmp_path, jref):
    ctx = mp.start_processes(_rank_main, args=(str(tmp_path / "store"),
                                               str(tmp_path)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the {WORLD}-rank world took over "
                                     f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    g, e = wire_data()
    signs, scales = [], []
    for i in range(WORLD):
        s_, sc_, e_ = jref.compress.compress_grad(jref.jnp.asarray(g[i]),
                                                  jref.jnp.asarray(e[i]))
        signs.append(np.asarray(s_, np.float32))
        scales.append(float(sc_))
        got = np.load(tmp_path / f"rank{i}.npz")
        np.testing.assert_allclose(got["err"], np.asarray(e_), **TOL)
    want = np.mean(signs, 0) * np.mean(scales)
    for i in range(WORLD):
        np.testing.assert_allclose(np.load(tmp_path / f"rank{i}.npz")["mean"],
                                   want, **TOL)


def test_without_a_process_group_it_raises():
    assert not dist.is_initialized()
    g = {"g": torch.ones(4)}
    with pytest.raises(RuntimeError, match="init_process_group"):
        compress.compressed_allreduce(g, compress.init_errors(g), ("data",))
