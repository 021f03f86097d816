"""The port's placement `Verdict` (`repro_torch.pim.offload`: `Verdict`,
`build_verdict`, `serving_verdict`, `plan_model_payloads`, and
`Lowered.verdict`) held against the JAX reference's `repro.pim.offload`.

Every DRIM row must equal the reference's field for field (float ``==``),
over op, fused, partitioned and hardened lowerings, priced in closed form
and simulated on the CPU, on both sides of `SIMULATE_MAX_BITS`.  The two
differences are names: the port's "cuda" engine stands where the
reference's "pallas" stands (so its op row is "DRIM-cuda"), and the
comparator row is the card's "GPU" row (`gpu_cost`, an H100 at 700 W),
never the reference's TPU model.  A Table-2 op lowered on the comparator
raises ValueError in the port; the reference crashes there with an
AttributeError (ROADMAP Queue 3, closed).
"""
import dataclasses
import types

import numpy as np
import pytest

import drim
from repro.configs import drim_bnn as ref_drim_bnn
from repro.core import DRIM_R as REF_DRIM_R
from repro.core import DrimGeometry as RefGeometry
from repro.core import FaultModel as RefFaultModel
from repro.pim import bnn as ref_bnn
from repro.pim import offload as ref_offload
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import DRIM_R, DrimGeometry, FaultModel
from repro_torch.pim import bnn, offload
from repro_torch.pim import compile as tcompile
from repro_torch.pim.offload import SIMULATE_MAX_BITS

SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
GEOM, REF_GEOM = DrimGeometry(**SHAPE), RefGeometry(**SHAPE)
REF_ENGINE = {"resident": "resident", "baseline": "baseline",
              "queued": "queued", "cuda": "pallas", "gpu": "tpu"}
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)
# a ragged payload of two waves of the small geometry
RAGGED = 2 * GEOM.parallel_bits - 9


def port_name(ref_contender):
    return {"DRIM-pallas": "DRIM-cuda", "TPU": "GPU"}.get(ref_contender,
                                                           ref_contender)


def assert_rows_equal(v, v_ref, low=None):
    """The DRIM rows equal the reference's exactly, the GPU row stands
    where the TPU row stands and equals the card's roofline."""
    assert (v.workload, v.n_bits, v.n_nodes, v.simulated) == \
        (v_ref.workload, v_ref.n_bits, v_ref.n_nodes, v_ref.simulated)
    assert [r.contender for r in v.rows] == \
        [port_name(r.contender) for r in v_ref.rows]
    for r, r_ref in zip(v.rows, v_ref.rows):
        if r.contender == "GPU":
            n_io, n_ops = offload._boundary_planes(low)
            assert r == offload._gpu_row(n_io, n_ops, v.n_bits)
            continue
        assert dataclasses.astuple(r)[1:] == dataclasses.astuple(r_ref)[1:]
    if low is not None:
        cost = offload.gpu_cost(low, v.n_bits)
        gpu = v.row("GPU")
        assert (gpu.latency_s, gpu.compute_s, gpu.dma_s, gpu.energy_j) == \
            (cost.latency_s, cost.compute_s, cost.dma_s, cost.energy_j)


@pytest.fixture(autouse=True)
def default_verify(monkeypatch):
    monkeypatch.delenv("DRIM_VERIFY", raising=False)


# (source, engine, lowering kwargs): every kind of lowering a Verdict
# prices, on each engine that can run it
def carrysave(k):
    return (bnn.bnn_dot_graph_carrysave(k)[0],
            ref_bnn.bnn_dot_graph_carrysave(k)[0])


LOWERINGS = {
    "op xnor2 resident": ("xnor2", "resident", {}),
    "op add cuda": ("add", "cuda", {}),
    "op maj3 baseline": ("maj3", "baseline", {}),
    "op not queued": ("not", "queued", dict(n_queues=2)),
    "fused resident": ("cs4", "resident", {}),
    "fused cuda": ("cs4", "cuda", {}),
    "fused queued": ("cs4", "queued", {}),
    "partition queued": ("cs4", "queued", dict(partition=GEOM.banks)),
    "partition cuda": ("cs4", "cuda", dict(partition=2)),
    "tmr resident": ("cs4", "resident", dict(harden="tmr")),
    "ecc cuda": ("cs4", "cuda", dict(harden="ecc")),
    "tmr+ecc cuda": ("cs4", "cuda", dict(harden="tmr+ecc")),
    "partition tmr+ecc queued": ("cs4", "queued",
                                 dict(partition=2, harden="tmr+ecc")),
    "graph on gpu": ("cs4", "gpu", {}),
}


def lower_both(case):
    src, engine, kw = LOWERINGS[case]
    srcs = carrysave(4) if src == "cs4" else (src, src)
    low = tcompile(srcs[0], geom=GEOM).lower(engine, **kw)
    low_ref = drim.compile(srcs[1], geom=REF_GEOM).lower(REF_ENGINE[engine],
                                                         **kw)
    return low, low_ref


@pytest.mark.parametrize("case", LOWERINGS)
@pytest.mark.parametrize("n_bits", [1, RAGGED, SIMULATE_MAX_BITS,
                                    SIMULATE_MAX_BITS + 1, 1 << 29])
def test_closed_form_rows_equal_reference(case, n_bits):
    low, low_ref = lower_both(case)
    v = low.verdict(n_bits)
    assert_rows_equal(v, low_ref.verdict(n_bits), low)
    assert not v.simulated
    assert v == offload.build_verdict(low, n_bits)


@pytest.mark.parametrize("case", [c for c in LOWERINGS
                                  if LOWERINGS[c][1] != "gpu"])
def test_simulated_rows_equal_reference(case):
    """simulate=True runs the lowering on the CPU with the reference's
    seeded operands: the measured schedule prices the same rows as the
    closed form and as the reference's own simulated verdict."""
    low, low_ref = lower_both(case)
    v = low.verdict(RAGGED, simulate=True, device="cpu")
    assert v.simulated
    assert low.schedule is not None
    assert_rows_equal(v, low_ref.verdict(RAGGED, simulate=True), low)
    closed = low.verdict(RAGGED)
    assert v.rows == closed.rows and v.workload == closed.workload


def test_simulate_cap_and_comparator_fall_back_to_closed_form():
    """At SIMULATE_MAX_BITS an op is simulated, above it priced in closed
    form; a graph on the comparator is never simulated."""
    low = tcompile("xnor2", geom=GEOM).lower("cuda")
    at = low.verdict(SIMULATE_MAX_BITS, simulate=True, device="cpu")
    assert at.simulated and at.rows == low.verdict(SIMULATE_MAX_BITS).rows
    low.schedule = None
    above = low.verdict(SIMULATE_MAX_BITS + 1, simulate=True, device="cpu")
    assert not above.simulated and low.schedule is None
    gpu = tcompile(carrysave(4)[0], geom=GEOM).lower("gpu")
    assert not gpu.verdict(RAGGED, simulate=True, device="cpu").simulated
    assert gpu.schedule is None


def test_simulated_faulted_lowering_prices_the_closed_form():
    """A tmr+ecc lowering with a default fault model runs faulted under
    simulate=True; faults move words, never the schedule."""
    src, src_ref = carrysave(5)
    low = tcompile(src, geom=GEOM).lower("cuda", harden="tmr+ecc",
                                         faults=FaultModel(**HOT))
    low_ref = drim.compile(src_ref, geom=REF_GEOM).lower(
        "resident", harden="tmr+ecc", faults=RefFaultModel(**HOT))
    v = low.verdict(RAGGED, simulate=True, device="cpu")
    assert low.last_ecc is not None and low.last_ecc.corrupted
    assert_rows_equal(v, low_ref.verdict(RAGGED, simulate=True), low)


def test_measured_operands_are_the_references(monkeypatch):
    """The simulated run feeds the reference's seeded words: numpy's
    default_rng(n_bits & 0xFFFF) uint32 planes, constant planes zero."""
    from repro_torch.pim import xnor, jit
    seen = {}

    @jit
    def kernel(a, b):
        return xnor(a, b) & a

    low = tcompile(kernel, geom=GEOM).lower("resident")
    run = type(low).run

    def spy(self, feeds, **kw):
        seen.update(feeds)
        return run(self, feeds, **kw)

    monkeypatch.setattr(type(low), "run", spy)
    low.verdict(RAGGED, simulate=True, device="cpu")
    n_words = -(-RAGGED // 32)
    rng = np.random.default_rng(RAGGED & 0xFFFF)
    for name in low.graph.input_names:
        want = (np.zeros(n_words, np.uint32) if name in
                low.traced.const_names else
                rng.integers(0, 1 << 32, n_words, dtype=np.uint32))
        assert seen[name].dtype == np.uint32
        np.testing.assert_array_equal(seen[name], want)


def test_comparator_op_raises_value_error():
    """The port refuses a verdict of a Table-2 op lowered on the
    comparator, naming the device engines; the reference crashes there
    (`TpuCost` has no `tiles`)."""
    with pytest.raises(ValueError, match="device engine"):
        tcompile("xnor2").lower("gpu").verdict(1 << 20)
    with pytest.raises(AttributeError, match="tiles"):
        drim.compile("xnor2").lower("tpu").verdict(1 << 20)
    with pytest.raises(ValueError, match="positive"):
        tcompile("xnor2").lower("cuda").verdict(0)


def test_verdict_accessors():
    low = tcompile(carrysave(4)[0], geom=GEOM).lower(partition=2)
    v = low.verdict(1 << 27)
    assert [r.contender for r in v.rows] == [
        "DRIM-queued", "DRIM-fused", "DRIM-unfused", "GPU"]
    assert v.winner == min(v.rows, key=lambda r: r.latency_s).contender
    assert v.speedup("DRIM-fused", "DRIM-unfused") == \
        v.row("DRIM-unfused").latency_s / v.row("DRIM-fused").latency_s
    with pytest.raises(KeyError, match="TPU"):
        v.row("TPU")
    assert v.as_dict()["rows"][3]["contender"] == "GPU"


# ---------------------------------------------------------------------------
# serving_verdict and plan_model_payloads
# ---------------------------------------------------------------------------

SMOKE = get_smoke_config("drim-bnn")
FULL = get_config("drim-bnn")


@pytest.mark.parametrize("engine,n_queues", [
    ("resident", None), ("cuda", None), ("queued", 8)])
@pytest.mark.parametrize("m,n,k", [
    (4, SMOKE.d_ff, SMOKE.d_model), (4, SMOKE.d_model, SMOKE.d_ff),
    (4, FULL.d_ff, FULL.d_model), (4, FULL.d_model, FULL.d_ff),
    (3, 5, 200)])
def test_serving_verdict_equals_reference(engine, n_queues, m, n, k):
    """The decode FFN pair at batch 4 (up and down) at smoke and at
    drim-bnn's full widths on DRIM-R, and a ragged K, priced over the
    serving path's cached lowerings, K chunk by K chunk."""
    v = offload.serving_verdict(m, n, k, geom=DRIM_R, engine=engine,
                                n_queues=n_queues)
    v_ref = ref_offload.serving_verdict(m, n, k, geom=REF_DRIM_R,
                                        engine=REF_ENGINE[engine],
                                        n_queues=n_queues)
    chunks = bnn.k_chunks(k)
    low = bnn.serving_lowering(chunks[0], engine=engine, geom=DRIM_R,
                               n_queues=n_queues)
    assert (v.workload, v.n_bits, v.n_nodes, v.simulated) == \
        (v_ref.workload, v_ref.n_bits, v_ref.n_nodes, v_ref.simulated)
    assert [r.contender for r in v.rows] == \
        [port_name(r.contender) for r in v_ref.rows]
    for r, r_ref in zip(v.rows, v_ref.rows):
        if r.contender != "GPU":
            assert dataclasses.astuple(r)[1:] == \
                dataclasses.astuple(r_ref)[1:]
    if len(set(chunks)) == 1:
        gpu = offload.gpu_cost(low, m * n)
        assert v.row("GPU").latency_s == gpu.latency_s * len(chunks)
        assert v.row("GPU").energy_j == gpu.energy_j * len(chunks)


@pytest.mark.parametrize("which", ["CONFIG", "SMOKE_CONFIG"])
def test_param_count_and_payloads_equal_reference(which):
    cfg = FULL if which == "CONFIG" else SMOKE
    cfg_ref = getattr(ref_drim_bnn, which)
    assert cfg.param_count() == cfg_ref.param_count()
    got = offload.plan_model_payloads(cfg)
    want = ref_offload.plan_model_payloads(cfg_ref)
    assert list(got) == list(want)
    for name, v in got.items():
        op = {"grad_sign_reduce(add)": "add",
              "bitlinear_weight_xnor": "xnor2",
              "weight_sign_copy": "copy"}[name]
        assert_rows_equal(v, want[name], tcompile(op).lower())
    assert cfg.replace(family="vlm").param_count() \
        == cfg_ref.replace(family="vlm").param_count()


def test_exports():
    import repro_torch.pim as pim
    for name in ("Verdict", "build_verdict", "serving_verdict",
                 "plan_model_payloads", "verify", "VerifyError",
                 "VerifyReport"):
        assert hasattr(pim, name), name
    assert pim.verify.VerifyError is pim.VerifyError
    assert types.ModuleType is type(pim.verify)
