"""The port's "gpu" comparator engine (the reference's "tpu"), its cost,
and the paper's platform and timing models, held against the JAX
reference.

The comparator evaluates an op or a graph natively, one bulk bit-wise
call per node, so its words must equal the reference "tpu" engine's (the
reference's oracle semantics) for every Table-2 op, a traced function,
the carry-save serving dot and hardened graphs, with faults ignored.  Its
cost prices the same boundary bytes as the reference's `tpu_cost`, with
the card's constants.  Inputs come from seeded numpy generators; every
comparison is exact.  The tests marked `cuda` run the engine on the card
and count its kernel launches; they skip without one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_comparator.py
"""
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.core import DRIM_R, DRIM_S, FaultModel
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.pim import compile as tcompile
from repro_torch.pim import compiler, jit, offload, xnor
from repro_torch.pim.bnn import bnn_dot_graph_carrysave
from repro_torch.pim.scheduler import OP_ARITY

OPS = ("copy", "not", "xnor2", "xor2", "maj3", "add")
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)
SCHEMES = ("ecc", "tmr", "tmr+ecc")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def rand_words(rng, n) -> np.ndarray:
    return rng.integers(0, 1 << 32, n, dtype=np.uint32)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: pipeline, BNN graphs, offload and models."""
    import drim
    from repro.core import platforms, timing
    from repro.pim import offload as ref_offload
    from repro.pim.bnn import bnn_dot_graph_carrysave as ref_carrysave
    return types.SimpleNamespace(drim=drim, platforms=platforms,
                                 timing=timing, offload=ref_offload,
                                 carrysave=ref_carrysave)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def carrysave_feeds(graph, n_words, seed):
    rng = np.random.default_rng(seed)
    return {n: (np.zeros(n_words, np.uint32) if n == "zero"
                else rand_words(rng, n_words)) for n in graph.input_names}


def assert_same_outputs(got, want):
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(u32(got[name]), np.asarray(want[name]))


# ---------------------------------------------------------------------------
# Words: the "gpu" engine equals the reference's "tpu"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", OPS)
def test_gpu_engine_equals_reference_tpu(jref, op):
    rng = np.random.default_rng(OPS.index(op))
    args = [rand_words(rng, 1001) for _ in range(OP_ARITY[op])]
    n_bits = 1001 * 32 - 5
    ref_low = jref.drim.compile(op).lower("tpu")
    want = ref_low.run(*args, n_bits=n_bits)
    low = tcompile(op).lower("gpu")
    got = low.run(*args, n_bits=n_bits, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), np.asarray(w))
    assert low.schedule == low.cost(n_bits)
    assert low.schedule.boundary_bytes == ref_low.schedule.boundary_bytes


def test_gpu_engine_runs_a_traced_function(jref):
    """The traced function of tests/test_frontend.py's pipeline test."""
    @jit
    def fn(a, b):
        return xnor(a, b) ^ a

    @jref.drim.jit
    def ref_fn(a, b):
        return jref.drim.xnor(a, b) ^ a

    rng = np.random.default_rng(1)
    a, b = rand_words(rng, 513), rand_words(rng, 513)
    want = jref.drim.compile(ref_fn).lower(engine="tpu").run(a, b)
    low = tcompile(fn).lower(engine="gpu")
    got = low.run(a, b, device="cpu")
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    np.testing.assert_array_equal(u32(got), (~(a ^ b)) ^ a)
    assert low.cost(513 * 32) == low.schedule


def test_gpu_engine_runs_the_carrysave_serving_dot(jref):
    graph, nbits = bnn_dot_graph_carrysave(32)
    ref_graph, ref_nbits = jref.carrysave(32)
    assert nbits == ref_nbits
    feeds = carrysave_feeds(graph, 300, seed=5)
    want = jref.drim.compile(ref_graph).lower("tpu").run(feeds)
    low = tcompile(graph).lower("gpu")
    got = low.run(feeds, device="cpu")
    assert_same_outputs(got, want)
    # and the DRIM fleet agrees with both
    assert_same_outputs(tcompile(graph).lower("resident").run(
        feeds, device="cpu"), want)


def test_the_gpu_engine_ignores_faults(jref):
    """The comparator is the clean answer: faults never apply, whether set
    at lowering or per run (tests/test_faults.py's comparator test)."""
    rng = np.random.default_rng(4)
    a, b = rand_words(rng, 13), rand_words(rng, 13)
    low = tcompile("xnor2").lower("gpu", faults=FaultModel(**HOT))
    (res,) = low.run(a, b, device="cpu")
    np.testing.assert_array_equal(u32(res), ~(a ^ b))
    (res,) = tcompile("xnor2").lower("gpu").run(
        a, b, device="cpu", faults=FaultModel(**HOT))
    np.testing.assert_array_equal(u32(res), ~(a ^ b))
    assert low._resolve_faults(FaultModel(**HOT)) is None
    graph, _ = bnn_dot_graph_carrysave(4)
    feeds = carrysave_feeds(graph, 40, seed=6)
    want = jref.drim.compile(jref.carrysave(4)[0]).lower(
        "tpu", faults=jref.drim.FaultModel(**HOT)).run(feeds)
    got = tcompile(graph).lower("gpu", faults=FaultModel(**HOT)).run(
        feeds, device="cpu")
    assert_same_outputs(got, want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_gpu_engine_runs_hardened_graphs(jref, scheme):
    """A hardened lowering keeps the ECC check on the comparator: its
    words and its (clean) parity verdict equal the reference's."""
    graph, _ = bnn_dot_graph_carrysave(4)
    feeds = carrysave_feeds(graph, 64, seed=7)
    ref_low = jref.drim.compile(jref.carrysave(4)[0]).lower(
        "tpu", harden=scheme)
    want = ref_low.run(feeds)
    low = tcompile(graph).lower("gpu", harden=scheme)
    got = low.run(feeds, device="cpu")
    assert_same_outputs(got, want)
    if "ecc" in scheme:
        assert low.last_ecc.mismatch_bits == ref_low.last_ecc.mismatch_bits == 0
        assert low.last_ecc.words == ref_low.last_ecc.words == 64
    else:
        assert low.last_ecc is None
    assert low.cost(64 * 32).boundary_bytes == \
        ref_low.cost(64 * 32).boundary_bytes


def test_gpu_engine_launches_one_op_per_node(monkeypatch):
    """One `ops.bitwise` call per non-copy node, with the node's op."""
    graph, _ = bnn_dot_graph_carrysave(8)
    calls = []
    real = ops.bitwise

    def spy(op, *args):
        calls.append(op)
        return real(op, *args)

    monkeypatch.setattr(compiler.kops, "bitwise", spy)
    tcompile(graph).lower("gpu").run(carrysave_feeds(graph, 8, seed=8),
                                     device="cpu")
    want = [compiler.NATIVE_OP[op] for op, _, _ in graph.nodes
            if op != "copy"]
    assert calls == want
    calls.clear()
    tcompile("add").lower("gpu").run(*[np.ones(4, np.uint32)] * 3,
                                     device="cpu")
    assert calls == ["fa"]


# ---------------------------------------------------------------------------
# Cost
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src", OPS + ("carrysave",))
def test_gpu_cost_prices_the_reference_boundary(jref, src):
    if src == "carrysave":
        low = tcompile(bnn_dot_graph_carrysave(32)[0]).lower("gpu")
        ref_low = jref.drim.compile(jref.carrysave(32)[0]).lower("tpu")
    else:
        low, ref_low = (tcompile(src).lower("gpu"),
                        jref.drim.compile(src).lower("tpu"))
    for n_bits in (1, 4096, 1 << 29):
        cost = low.cost(n_bits)
        want = jref.offload.tpu_cost(ref_low, n_bits)
        assert cost == offload.gpu_cost(low, n_bits)
        assert cost.boundary_bytes == want.boundary_bytes
        assert cost.dma_s == cost.boundary_bytes / 3.35e12
        n_io, n_ops = offload._boundary_planes(low)
        assert cost.compute_s == n_ops * n_bits / (67e12 / 4 * 32)
        assert cost.latency_s == max(cost.compute_s, cost.dma_s)
        assert cost.energy_j == cost.latency_s * 700.0
    with pytest.raises(ValueError):
        low.cost(0)


def test_verdict_waits_for_the_queued_engine():
    """A verdict prices DRIM against the comparator, so a Table-2 op
    lowered on the comparator itself raises ValueError naming the device
    engines (the reference crashes there with an AttributeError); the op
    on a device engine, and a graph on the comparator, are priced."""
    with pytest.raises(ValueError, match="device engine"):
        tcompile("xnor2").lower("gpu").verdict(1 << 20)
    v = tcompile("xnor2").lower("queued").verdict(1 << 20)
    assert [r.contender for r in v.rows] == ["DRIM-queued", "GPU"]
    g = bnn_dot_graph_carrysave(4)[0]
    v = tcompile(g).lower("gpu").verdict(1 << 20)
    assert [r.contender for r in v.rows] == ["DRIM-fused", "DRIM-unfused",
                                             "GPU"]
    assert v.row("GPU").latency_s == tcompile(g).lower("gpu").cost(
        1 << 20).latency_s


def test_gpu_is_the_native_serving_route():
    with layers.serving_engine("gpu"):
        assert layers.serving_engine_name() is None
    with layers.serving_engine("cuda", geom=DRIM_R):
        assert layers.serving_engine_name() == "cuda"
    assert not compiler.get_engine("gpu").device
    assert all(compiler.get_engine(e).device
               for e in ("resident", "baseline", "cuda"))


# ---------------------------------------------------------------------------
# Platforms and timing: the reference's floats
# ---------------------------------------------------------------------------

def test_platforms_equal_the_reference(jref):
    ref = jref.platforms
    got, want = core.all_platforms(), ref.all_platforms()
    assert list(got) == list(want)
    for name in want:
        assert got[name].kind == want[name].kind
        for op in ("not", "xnor2", "add"):
            assert got[name].throughput_bits(op) == \
                want[name].throughput_bits(op)
    assert core.PIM_CYCLES == ref.PIM_CYCLES
    assert core.PAPER_CLAIMS == ref.PAPER_CLAIMS
    assert core.CONTEXT_CLAIMS == ref.CONTEXT_CLAIMS


def test_timing_equals_the_reference(jref):
    ref = jref.timing
    assert core.T_CMD_S == ref.T_CMD_S
    assert core.CMD_SLOTS_PER_AAP == ref.CMD_SLOTS_PER_AAP == 108
    assert core.area_report() == ref.area_report()
    for geom, ref_geom in ((DRIM_R, ref.DRIM_R), (DRIM_S, ref.DRIM_S)):
        for op in ("copy", "not", "maj3", "xnor2", "xor2", "add"):
            assert core.drim_throughput_bits(geom, op) == \
                ref.drim_throughput_bits(ref_geom, op)
            for n_bits in (1, 1 << 21, (1 << 29) + 7):
                assert core.drim_latency_s(geom, op, n_bits) == \
                    ref.drim_latency_s(ref_geom, op, n_bits)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("op", OPS)
def test_gpu_engine_on_the_card(cuda, op):
    """One kernel launch per op run (none for copy), and the CPU's words."""
    kern = importlib.import_module("repro_torch.kernels.bitwise")
    counters = {"not": kern.not_kernel, "xnor2": kern.binary_kernel,
                "xor2": kern.binary_kernel, "maj3": kern.ternary_kernel,
                "add": kern.ternary_kernel}
    rng = np.random.default_rng(OPS.index(op))
    args = [rand_words(rng, 100003) for _ in range(OP_ARITY[op])]
    before = {k: f.launches for k, f in counters.items()}
    got = tcompile(op).lower("gpu").run(*args, device=cuda)
    torch.cuda.synchronize()
    for k, f in counters.items():
        extra = 1 if counters.get(op) is f else 0
        assert f.launches == before[k] + extra
    want = tcompile(op).lower("gpu").run(*args, device="cpu")
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_gpu_engine_graph_on_the_card_equals_cuda_engine(cuda):
    graph, _ = bnn_dot_graph_carrysave(32)
    feeds = carrysave_feeds(graph, DRIM_R.n_subarrays * 8, seed=9)
    on_card = {n: torch.from_numpy(a.view(np.int32)).to(cuda)
               for n, a in feeds.items()}
    got = tcompile(graph).lower("gpu").run(on_card, device=cuda)
    want = tcompile(graph).lower("cuda").run(on_card, device=cuda)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
