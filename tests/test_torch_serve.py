"""Serving the port's drim-bnn LM: the counterparts of the reference's
`tests/test_serve.py` invariants, on the CPU, plus token identity with the
reference for carried-over weights.

The load-bearing guarantee: at temperature 0 the greedy token stream is
IDENTICAL whichever route executes the BitLinear decode matmuls -- the
dense STE product, the packed XNOR-popcount kernel and the DRIM fleet all
give the same exact integer, rounded once -- so "gpu", "resident" and the
packed forms must agree token for token.

The reference is imported by the `jref` fixture, so the tests marked
`cuda` also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_serve.py
"""
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch import models
from repro_torch.launch import batching, serve
from repro_torch.models import layers, transformer
from repro_torch.tree import tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]

# tiny drim-bnn geometry (the reference test's): K in {32, 64} keeps the
# carry-save lowerings single-chunk and fast on the CPU
TINY = ["--arch", "drim-bnn", "--smoke-config", "--layers", "2",
        "--d-model", "32", "--d-ff", "64", "--heads", "2",
        "--kv-heads", "1", "--d-head", "16", "--vocab", "128",
        "--prompt-len", "8", "--gen", "5", "--batch", "2"]
CPU = ["--device", "cpu"]


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

    from repro.launch import serve as jserve
    from repro.models import init_params
    return types.SimpleNamespace(jax=jax, jnp=jnp, serve=jserve,
                                 init_params=init_params)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _serve(*extra):
    return serve.run_serve(serve.parse_args(TINY + CPU + list(extra)))


@pytest.fixture(scope="module")
def gpu_run():
    return _serve("--engine", "gpu")


# --- cross-route token identity ----------------------------------------------

@pytest.mark.parametrize("extra", [
    ("--engine", "resident"), ("--engine", "gpu", "--packed"),
    ("--engine", "resident", "--packed"),
    ("--engine", "queued", "--n-queues", "2", "--packed")],
    ids=["resident", "packed", "packed-resident", "packed-queued-2"])
def test_routes_match_native_dense_tokens(gpu_run, extra):
    gen_g, stats_g = gpu_run
    gen, stats = _serve(*extra)
    assert gen.shape == (2, 5)
    np.testing.assert_array_equal(gen, gen_g)
    assert stats["sample_ids"] == stats_g["sample_ids"]
    assert stats["packed"] is ("--packed" in extra)


def test_stats_report_steady_state_apart_from_warmup(gpu_run):
    _, stats = gpu_run
    assert stats["device"] == "cpu" and stats["engine"] == "gpu"
    assert stats["compile_s"] > 0 and stats["prefill_s"] > 0
    assert stats["decode_tok_per_s"] > 0
    assert 0 < stats["decode_p50_ms"] <= stats["decode_p99_ms"]


def test_port_tokens_equal_reference_tokens(jref):
    """The reference's seeded weights and prompts, carried over: the
    port's greedy stream equals the reference's, native and packed."""
    want, _ = jref.serve.run_serve(jref.serve.parse_args(TINY))
    args = serve.parse_args(TINY + CPU)
    key = jref.jax.random.PRNGKey(args.seed)
    pj = jref.init_params(key, jref.serve.build_cfg(args))
    toks = jref.jax.random.randint(jref.jax.random.fold_in(key, 1),
                                   (args.batch, args.prompt_len), 0,
                                   serve.build_cfg(args).vocab_size)
    params = models.lm_from_jax(jref.jax.tree.map(np.asarray, pj),
                                serve.build_cfg(args), device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    for extra in ([], ["--packed"]):
        got, _ = serve.run_serve(serve.parse_args(TINY + CPU + extra),
                                 params=params, tokens=np.asarray(toks))
        np.testing.assert_array_equal(got, np.asarray(want))


def test_packed_check_catches_divergence():
    args = serve.parse_args(TINY + CPU)
    cfg = serve.build_cfg(args)
    dense = models.init_params(0, cfg, device="cpu")
    packed = serve.pack_model_params(dense)
    assert "w_packed" in packed["layers"]["mlp"]["up"]
    assert packed["layers"]["mlp"]["up"]["w_packed"].shape[0] == cfg.n_layers
    tok = torch.zeros(2, 1, dtype=torch.long)
    caches = models.empty_caches(cfg, 2, 8, device="cpu")
    pos = torch.zeros(2, dtype=torch.long)
    serve._assert_packed_bit_exact(cfg, dense, packed, tok, caches, pos, 8)
    flipped = tree_map(lambda t: t, packed)
    flipped["head"] = -packed["head"]
    with pytest.raises((RuntimeError, AssertionError)):
        serve._assert_packed_bit_exact(cfg, dense, flipped, tok, caches, pos,
                                       8)


# --- the CLI and its boundaries -------------------------------------------------

def test_cli_serves_on_the_cpu_without_jax():
    code = (
        "import json, runpy, sys; "
        f"sys.argv = ['serve'] + {TINY + CPU + ['--engine', 'resident']!r}; "
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__'); "
        "print(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'drim')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin",
                              # as `one_torch_thread`, for the child
                              "OMP_NUM_THREADS": "1"})
    stats_line, modules = out.stdout.strip().splitlines()[-2:]
    assert modules == "[]"
    assert len(__import__("json").loads(stats_line)["sample_ids"]) == 5


def test_temperature_sampling_is_seeded():
    a, _ = _serve("--temperature", "1.5", "--seed", "3")
    b, _ = _serve("--temperature", "1.5", "--seed", "3", "--packed")
    c, _ = _serve("--temperature", "1.5", "--seed", "4")
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.min() >= 0 and a.max() < 128


def test_engines_are_gpu_and_the_registry():
    """--engine takes the registry's names ("queued" since the per-bank
    queues are ported); "gpu" (now the registered comparator) stays the
    default and is the native route."""
    for engine in ("tpu", "pallas"):
        with pytest.raises(SystemExit):
            serve.parse_args(TINY + ["--engine", engine])
    assert serve.parse_args(TINY).engine == "gpu"
    for engine in ("cuda", "baseline", "gpu", "queued"):
        assert serve.parse_args(TINY + ["--engine", engine]).engine == engine
    with layers.serving_engine("gpu"):
        assert layers.serving_engine_name() is None


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(TINY)
    cfg = serve.build_cfg(args)
    params = models.init_params(0, cfg, device="cpu")
    numpy_tree = tree_map(lambda t: t.float().numpy(), params)
    calls = [
        lambda: models.init_params(0, cfg),
        lambda: models.lm_from_jax(numpy_tree, cfg),
        lambda: models.empty_caches(cfg, 1, 8),
        lambda: serve.run_serve(args),
        lambda: serve.run_continuous(serve.parse_args(TINY +
                                                      ["--continuous", "2"])),
        lambda: batching.WaveBatcher(cfg, params, n_slots=1, ctx_len=8),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --- cache splice / insert strictness --------------------------------------------

def test_splice_caches_exact_and_growing():
    full = {"k": torch.zeros(2, 3, 8, 4), "v": torch.zeros(2, 3, 8, 4)}
    pre = {"k": torch.ones(2, 3, 5, 4), "v": torch.ones(2, 3, 8, 4)}
    out = serve.splice_caches(full, pre)
    assert float(out["k"][:, :, :5].min()) == 1.0
    assert float(out["k"][:, :, 5:].max()) == 0.0
    assert float(out["v"].min()) == 1.0
    assert float(full["k"].max()) == 0.0          # inputs are not changed


@pytest.mark.parametrize("pre_shape,match", [
    ((3, 8, 4), r"\['layers'\]\['kcache'\]"),    # ndim mismatch
    ((2, 3, 9, 4), "cache splice mismatch")])     # oversized prefill
def test_splice_caches_raises_naming_the_path(pre_shape, match):
    full = {"layers": {"kcache": torch.zeros(2, 3, 8, 4)}}
    pre = {"layers": {"kcache": torch.ones(pre_shape)}}
    with pytest.raises(ValueError, match=match):
        serve.splice_caches(full, pre)


def test_insert_request_raises_naming_the_path():
    full = {"kcache": torch.zeros(2, 4, 8, 4)}
    bad = {"kcache": torch.ones(2, 8, 4)}          # missing batch axis
    with pytest.raises(ValueError, match=r"kcache"):
        batching.insert_request(full, bad, 0)


def test_insert_request_zeroes_the_slot():
    full = {"k": torch.full((2, 3, 6, 4), 7.0)}
    one = {"k": torch.ones(2, 1, 4, 4)}
    out = batching.insert_request(full, one, 1)["k"]
    assert float(out[:, 1, :4].min()) == 1.0
    assert float(out[:, 1, 4:].abs().max()) == 0.0
    assert float(out[:, 0].min()) == 7.0 and float(out[:, 2].min()) == 7.0


# --- continuous batching -----------------------------------------------------------

def _tiny_model():
    cfg = serve.build_cfg(serve.parse_args(TINY))
    return cfg, models.init_params(0, cfg, device="cpu")


def _solo_tokens(cfg, params, prompt, max_new, ctx_len=32, engine=None):
    b = batching.WaveBatcher(cfg, params, n_slots=1, ctx_len=ctx_len,
                             engine=engine, device="cpu")
    b.submit(prompt, max_new)
    return b.run()[0]


@pytest.fixture(scope="module")
def cont():
    """3 requests into 2 slots: r0/r1 at wave 0, r2 arrives at wave 2."""
    cfg, params = _tiny_model()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(3)]
    b = batching.WaveBatcher(cfg, params, n_slots=2, ctx_len=32,
                             device="cpu")
    b.submit(prompts[0], 6, arrival_wave=0)
    b.submit(prompts[1], 4, arrival_wave=0)
    b.submit(prompts[2], 4, arrival_wave=2)
    results = b.run()
    solo = {r: _solo_tokens(cfg, params, prompts[r], [6, 4, 4][r])
            for r in range(3)}
    return b, results, solo


def test_wave0_admits_both_initial_requests(cont):
    b, _, _ = cont
    assert b.wave_log[0]["admitted"] == [0, 1]
    assert b.wave_log[0]["n_active"] == 2


def test_late_arrival_joins_next_shared_wave(cont):
    b, _, _ = cont
    admit = next(w for w in b.wave_log if 2 in w["admitted"])
    assert admit["wave"] >= 2
    assert admit["n_active"] >= 2 and 0 in admit["decoded"]


def test_positions_advance_independently(cont):
    b, _, _ = cont
    pos = {0: [], 1: [], 2: []}
    for w in b.wave_log:
        for rid, p in w["positions"].items():
            pos[rid].append(p)
    for rid, ps in pos.items():
        assert ps == list(range(ps[0], ps[0] + len(ps))), (rid, ps)
    shared = next(w for w in b.wave_log if len(w["positions"]) >= 2
                  and 2 in w["positions"])
    assert shared["positions"][2] != shared["positions"][0]


def test_token_budgets_respected(cont):
    _, results, _ = cont
    assert [len(results[r]) for r in range(3)] == [6, 4, 4]


def test_no_cross_request_cache_leakage(cont):
    """Batched-with-strangers tokens == solo-run tokens, including r2
    reusing the slot r1 freed (the zeroed-slot insert)."""
    _, results, solo = cont
    for rid in range(3):
        np.testing.assert_array_equal(results[rid], solo[rid],
                                      err_msg=f"request {rid}")


def test_queued_until_slot_frees():
    cfg, params = _tiny_model()
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, 8) for _ in range(3)]
    b = batching.WaveBatcher(cfg, params, n_slots=2, ctx_len=32,
                             device="cpu")
    for p in prompts:
        b.submit(p, 3, arrival_wave=0)      # 3 requests, 2 slots
    results = b.run()
    admit = next(w for w in b.wave_log if 2 in w["admitted"])
    assert admit["wave"] >= 2
    np.testing.assert_array_equal(results[2],
                                  _solo_tokens(cfg, params, prompts[2], 3))


def test_continuous_through_drim_engine():
    """The wave scheduler composes with the DRIM decode path: same tokens
    as the native route for the same request."""
    cfg, params = _tiny_model()
    prompt = np.arange(8) % cfg.vocab_size
    np.testing.assert_array_equal(
        _solo_tokens(cfg, params, prompt, 4, engine="resident"),
        _solo_tokens(cfg, params, prompt, 4))


def test_run_continuous_with_prompts_of_two_lengths():
    args = serve.parse_args(TINY + CPU + ["--engine", "resident", "--packed",
                                          "--continuous", "2", "--gen", "3",
                                          "--ctx", "16"])
    cfg, params = _tiny_model()
    prompts = [np.arange(8) % 128, np.arange(5) * 7 % 128]
    results, stats = serve.run_continuous(args, params=params,
                                          prompts=prompts)
    assert stats["n_requests"] == 2 and stats["total_tokens"] == 6
    for r, prompt in enumerate(prompts):
        np.testing.assert_array_equal(
            results[r], _solo_tokens(cfg, params, prompt, 3, ctx_len=16))


def test_submit_rejects_overlong_request():
    cfg, params = _tiny_model()
    b = batching.WaveBatcher(cfg, params, n_slots=1, ctx_len=16,
                             device="cpu")
    with pytest.raises(ValueError, match="ctx_len"):
        b.submit(np.zeros(10, np.int32), 10)


# --- --microbench, --resilient, --telemetry / --trace-out -----------------------

def _fake_decode_factory(fail_plan):
    """make_fn stand-in (`make_decode_fn`'s signature, the reference's
    too): `fail_plan[engine]` is how many times a decode step on that
    engine raises before succeeding."""
    made = []

    def build(engine):
        made.append(engine)
        remaining = {"n": fail_plan.get(engine, 0)}

        def dec(*args):
            if remaining["n"] > 0:
                remaining["n"] -= 1
                raise RuntimeError(f"{engine} queue wedged")
            return ("tok", engine)
        return dec

    return (lambda cfg, ctx_len, temperature, engine, n_queues:
            build(engine)), made


def _port_view(incidents):
    """Incident records without `t_s`, the fallback engine named "gpu"."""
    out = []
    for rec in incidents:
        rec = {k: v for k, v in rec.items() if k != "t_s"}
        out.append({k: v.replace("tpu", "gpu") if isinstance(v, str) else v
                    for k, v in rec.items()})
    return out


# (engine, fail plan by engine, max_retries, backoff_s): retry-then-recover,
# fallback, abort (the fallback engine fails too)
RESILIENT = {
    "retry_then_recover": ("resident", {"resident": 2}, 2, 0.01),
    "fallback": ("queued", {"queued": 99}, 1, 0.0),
    "abort": ("resident", {"resident": 99, "gpu": 99, "tpu": 99}, 1, 0.0),
}


@pytest.mark.parametrize("case", sorted(RESILIENT))
def test_resilient_incidents_equal_reference(case, jref):
    """The same failures give the reference's incident records (but `t_s`
    and the fallback engine's name), naps, rebuilt engines and
    ``serve.incident:*`` counters."""
    from repro.runtime import telemetry as ref_telemetry
    from repro_torch.runtime import telemetry
    engine, plan, retries, backoff = RESILIENT[case]
    runs = []
    for pkg, reg in ((serve, telemetry), (jref.serve, ref_telemetry)):
        make_fn, made = _fake_decode_factory(plan)
        naps = []
        with reg.fresh():
            dec, state, incidents = pkg.make_resilient_decode(
                None, 16, 0.0, engine, 4, max_retries=retries,
                backoff_s=backoff, sleep=naps.append, make_fn=make_fn)
            try:
                out = [dec(), dec()]
            except RuntimeError as err:
                out = [str(err)]
            counters = dict(reg.REGISTRY.counters("serve"))
        assert all(i["t_s"] >= 0 for i in incidents)
        runs.append((out, state["engine"], made, naps, incidents, counters))
    (out, eng, made, naps, inc, cnt), (r_out, r_eng, r_made, r_naps, r_inc,
                                       r_cnt) = runs
    def gpu(x):
        return json.loads(json.dumps(x).replace("tpu", "gpu"))

    assert gpu(out) == gpu(r_out) and eng == gpu(r_eng)
    assert made == gpu(r_made)
    assert naps == r_naps and cnt == r_cnt
    assert [{k: v for k, v in i.items() if k != "t_s"} for i in inc] == \
        _port_view(r_inc)
    assert inc and {i["action_kind"] for i in inc} <= {"retry", "fallback",
                                                      "abort"}


def test_resilient_serve_on_a_healthy_engine_is_a_no_op(gpu_run):
    gen_g, _ = gpu_run
    gen, stats = _serve("--engine", "resident", "--resilient")
    np.testing.assert_array_equal(gen, gen_g)
    assert stats["requested_engine"] == "resident"
    assert stats["engine"] == "resident" and stats["incidents"] == []


def test_resilient_serve_falls_back_to_the_native_route(gpu_run):
    """A DRIM decode fn that always raises: two retries, then the "gpu"
    route serves the native tokens."""
    gen_g, _ = gpu_run

    def make_fn(cfg, ctx_len, temperature, engine, n_queues):
        if engine == "resident":
            def broken(*args):
                raise RuntimeError("resident queue wedged")
            return broken
        return batching.make_decode_fn(cfg, ctx_len, temperature, engine,
                                       n_queues)

    args = serve.parse_args(TINY + CPU + ["--engine", "resident",
                                          "--resilient"])
    gen, stats = serve.run_serve(args, make_fn=make_fn)
    np.testing.assert_array_equal(gen, gen_g)
    assert stats["engine"] == "gpu" and stats["requested_engine"] == "resident"
    assert [i["action"] for i in stats["incidents"]] == [
        "retry(backoff=0.05s)", "retry(backoff=0.1s)", "fallback:gpu"]


def test_microbench_reports_the_reference_key_set(jref):
    args = TINY + ["--microbench"]
    _, want = jref.serve.run_microbench(jref.serve.parse_args(args))
    _, got = serve.run_microbench(serve.parse_args(args + CPU))
    assert set(got) == set(want) | {"device"}
    assert {k: set(v) for k, v in got["microbench"].items()} == \
        {k: set(v) for k, v in want["microbench"].items()}
    mb = got["microbench"]
    for stage in mb.values():
        assert stage["compile_s"] > 0
    assert 0 < mb["prefill"]["avg_s"] and 0 < mb["insert"]["avg_s"]
    assert mb["generate"]["tok_per_s"] > 0
    assert 0 < mb["generate"]["p50_ms"] <= mb["generate"]["p99_ms"]


def test_microbench_tokens_follow_the_serving_route():
    """The generate stage decodes on the chosen engine: a DRIM engine's
    lowerings are booked, the native route's are not."""
    from repro_torch.runtime import telemetry
    for engine, lowered in (("gpu", False), ("resident", True)):
        with telemetry.fresh():
            serve.run_microbench(serve.parse_args(
                TINY + CPU + ["--microbench", "--engine", engine]))
            hits = sum(telemetry.REGISTRY.counters("lower_cache").values())
        assert (hits > 0) is lowered, engine


def test_main_trace_out_writes_decode_spans(tmp_path, capsys):
    from repro_torch.runtime import telemetry
    path = tmp_path / "trace.json"
    with telemetry.armed(False):
        telemetry.clear_trace()
        gen = serve.main(TINY + CPU + ["--engine", "resident",
                                       "--trace-out", str(path)])
        telemetry.clear_trace()
    assert not telemetry.enabled()
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["trace_out"] == str(path)
    assert stats["telemetry"]["armed"] is True
    assert stats["telemetry"]["counters"]["lower_cache.hits"] > 0
    with open(path) as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    decode = [e for e in spans if e["name"] == "decode:token"]
    assert [e["args"]["token"] for e in decode] == list(range(gen.shape[1] - 1))
    runs = [e for e in spans if e["name"] == "Lowered.run"]
    # every decode step of the 2 layers runs gate, up and down
    assert len(runs) == 3 * 2 * gen.shape[1]
    assert {e["name"] for e in spans} >= {"stage", "dispatch", "readback"}


def test_disarmed_serve_folds_no_telemetry(gpu_run):
    _, stats = gpu_run
    assert "telemetry" not in stats and "incidents" not in stats


def test_microbench_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_microbench(serve.parse_args(TINY + ["--microbench"]))


# --- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_routes_agree_on_the_card(cuda):
    """The smoke config at a 128-token prompt (flash prefill) on the card:
    native dense, native packed and DRIM packed give the same tokens, and
    the prefill went through the flash kernel."""
    from repro_torch.kernels import flash_attention
    args = ["--arch", "drim-bnn", "--smoke-config", "--prompt-len", "128",
            "--gen", "4", "--batch", "2"]
    before = flash_attention.flash_fwd.launches
    runs = [serve.run_serve(serve.parse_args(args + extra))[0]
            for extra in (["--engine", "gpu"], ["--engine", "gpu", "--packed"],
                          ["--engine", "cuda", "--packed"])]
    assert flash_attention.flash_fwd.launches >= before + 3 * 2
    for gen in runs[1:]:
        np.testing.assert_array_equal(gen, runs[0])
    assert transformer.padded_vocab(serve.build_cfg(
        serve.parse_args(args))) == 512
