"""The serving modes over ranks: the continuous batcher (`--continuous`),
the prefill / insert / generate split (`--microbench`) and the retrying
decode (`--resilient`) under a mesh of gloo ranks, held against one
process.

Ranks are spawned with `test_torch_ranks`' harness, one world of 2 ranks
that runs the (1, 2) and (2, 1) meshes:
  * --continuous: three requests (prompts of 32, 21 and 32 tokens, one a
    wave, into 2 slots, so the third waits for a freed slot and the
    21-token prefill is whole on every rank of a model axis) give one
    process's request tokens, bit for bit on the (2, 1) data mesh, on
    drim-bnn's "gpu --packed" and "resident --packed" routes, and, in
    float32 activations, on deepseek-v3's MLA latent cache; every rank
    returns the same results.
  * --microbench at (1, 2): all three stages on every rank, each
    figure's `per_rank` list in rank order and its `max`.
  * --resilient at (1, 2) on "resident --packed", with a fake `make_fn`
    whose decode fn fails on rank 1 alone from its third step on (after
    running the step, so the ranks' collectives stay matched) and a fake
    `sleep`: both ranks book the same retry, retry and fallback
    incidents but for each rank's own `error`, switch to "gpu" together
    and give the tokens of the run with no failure; a fake that fails on
    "gpu" too makes both ranks abort, neither left waiting.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import batching, serve

from test_torch_moe_ranks import float32_serving
from test_torch_ranks import result, run_world

SMALL = ["--smoke-config", "--device", "cpu", "--prompt-len", "32", "--gen",
         "5"]
PROMPT_LENS = (32, 21, 32)
CONTINUOUS = {
    "drim-bnn gpu packed": ["--arch", "drim-bnn", "--packed"],
    "drim-bnn resident packed": ["--arch", "drim-bnn", "--packed",
                                 "--engine", "resident"],
    "deepseek-v3 float32": ["--arch", "deepseek-v3-671b"],
}
RESILIENT = ["--arch", "drim-bnn", "--packed", "--engine", "resident",
             "--batch", "2", *SMALL]
FAIL_FROM = 3                   # the failing rank's first failed step
SHAPES = ((1, 2), (2, 1))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def prompts(vocab: int):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in PROMPT_LENS]


def continuous(leg: str, extra=()):
    """`serve.run_continuous` of the leg (2 slots, a request a wave):
    {rid: tokens}."""
    args = serve.parse_args([*CONTINUOUS[leg], *SMALL, "--batch", "2",
                             "--continuous", str(len(PROMPT_LENS)),
                             *extra])
    vocab = serve.build_cfg(args).vocab_size
    if leg.endswith("float32"):
        with float32_serving(serve):
            return serve.run_continuous(args, prompts=prompts(vocab))[0]
    return serve.run_continuous(args, prompts=prompts(vocab))[0]


def failing_make_fn(rank: int, on_gpu: bool = False):
    """A `make_fn` whose decode fns fail on `rank` from their FAIL_FROM-th
    step on, after running the step; on "gpu" only where `on_gpu`."""
    def make_fn(cfg, ctx_len, temperature, engine, n_queues):
        inner = batching.make_decode_fn(cfg, ctx_len, temperature, engine,
                                        n_queues)
        calls = [0]

        def dec(*args):
            out = inner(*args)
            calls[0] += 1
            if dist.get_rank() == rank and calls[0] >= FAIL_FROM \
                    and (on_gpu or engine != batching.NATIVE_ENGINE):
                raise RuntimeError(f"planted failure at step {calls[0]}")
            return out
        return dec
    return make_fn


# --- the rank side -----------------------------------------------------------

def scenario_continuous(out):
    return {(leg, shape): continuous(leg, ["--model-axis", str(shape[1])])
            for leg in CONTINUOUS for shape in SHAPES}


def scenario_microbench(out):
    args = serve.parse_args(["--arch", "drim-bnn", "--packed", "--batch",
                             "2", *SMALL, "--model-axis", "2",
                             "--microbench"])
    return serve.run_microbench(args)[1]


def scenario_resilient(out):
    args = serve.parse_args(RESILIENT + ["--resilient", "--model-axis", "2"])
    res, waits = {}, []
    res["plain"] = serve.run_serve(args)
    res["fallback"] = serve.run_serve(args, make_fn=failing_make_fn(1),
                                      sleep=waits.append)
    res["waits"] = list(waits)
    try:
        serve.run_serve(args, make_fn=failing_make_fn(1, on_gpu=True),
                        sleep=waits.append)
        res["abort"] = "ran"
    except RuntimeError as err:
        res["abort"] = str(err)
    return res


def _rank_entry(rank, world, store, out_dir, names):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    results = {}
    try:
        for name in names:
            out = {"dir": out_dir, "world": world}
            try:
                results[name] = globals()[f"scenario_{name}"](out)
            except Exception:   # noqa: BLE001 -- reported by the parent
                import traceback
                results[name] = {"error": traceback.format_exc()}
    finally:
        torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


# --- the parent side ---------------------------------------------------------

@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(2, ["continuous", "microbench", "resilient"],
                     tmp_path_factory.mktemp("serve_ranks"),
                     entry=_rank_entry)


@pytest.fixture(scope="module")
def one_process():
    return {leg: continuous(leg) for leg in CONTINUOUS}


@pytest.mark.parametrize("leg", list(CONTINUOUS))
@pytest.mark.parametrize("shape", SHAPES)
def test_continuous_batcher_over_ranks_gives_one_process_tokens(
        shape, leg, world2, one_process):
    """Three staggered requests through the wave batcher over the mesh:
    every request's tokens one process's, on every rank."""
    want = one_process[leg]
    assert sorted(want) == [0, 1, 2]
    for r in range(2):
        got = result(world2, "continuous", r)[(leg, shape)]
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid], want[rid],
                                          err_msg=f"rank {r} request {rid}")


def test_microbench_over_ranks_runs_every_stage(world2):
    """--microbench over (1, 2): the prefill, insert and generate stages
    on both ranks, each figure with every rank's value in rank order and
    their maximum."""
    got = [result(world2, "microbench", r) for r in range(2)]
    for r, stats in enumerate(got):
        split = stats["microbench"]
        assert set(split) == {"prefill", "insert", "generate"}
        for stage, fig in split.items():
            for k, every in fig["per_rank"].items():
                assert len(every) == 2
                assert every[r] == fig[k]
                assert fig["max"][k] == max(every)
                assert every == got[0]["microbench"][stage]["per_rank"][k]
        assert split["generate"]["tok_per_s"] > 0


def test_resilient_decode_over_ranks_takes_one_decision(world2):
    """A decode fn failing on rank 1 alone: both ranks book retry, retry,
    fallback (the same records but each rank's `error`), both switch to
    "gpu", the tokens are the run's with no failure, and the backoffs
    are the same; failing on "gpu" too, both ranks abort."""
    recs = [result(world2, "resilient", r) for r in range(2)]
    books = []
    for r, rec in enumerate(recs):
        plain, _ = rec["plain"]
        gen, stats = rec["fallback"]
        np.testing.assert_array_equal(gen, plain)
        assert stats["engine"] == "gpu"
        assert [i["action_kind"] for i in stats["incidents"]] \
            == ["retry", "retry", "fallback"]
        assert all(i["failed_ranks"] == [1] for i in stats["incidents"])
        err = stats["incidents"][0]["error"]
        assert ("planted failure" in err) == (r == 1), err
        books.append([{k: v for k, v in i.items()
                       if k not in ("error", "t_s")}
                      for i in stats["incidents"]])
        assert stats["failure_flag"]["calls"] >= 3
        assert rec["waits"][:2] == [0.05, 0.1]
        assert "planted failure" in rec["abort"] or "rank(s) [1]" \
            in rec["abort"]
    assert books[0] == books[1]
    assert recs[0]["waits"] == recs[1]["waits"]
