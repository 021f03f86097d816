"""The port's legacy shims, held to `tests/test_deprecation.py` case for
case and to the reference's shims.

`compiler._warn_deprecated` issues one shared warning for every
`execute*`/`plan*` shim with `stacklevel=3` (caller -> shim -> helper),
so the warning's reported file must be the caller's (this file), never
`compiler.py` or the shim's own module.  Each shim's result must equal
the reference shim's: the words exactly, and the schedules and the
`plan*` reports' DRIM fields field for field (the comparator fields are
the card's GPU row, `gpu_latency_s` / `gpu_energy_j` / `speedup_vs_gpu`
with winner "GPU", where the reference prices a TPU)."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import DrimGeometry as RefGeometry
from repro.pim import (execute as ref_execute,
                       execute_graph as ref_execute_graph,
                       execute_oplist as ref_execute_oplist,
                       execute_partitioned as ref_execute_partitioned,
                       plan as ref_plan, plan_fused as ref_plan_fused,
                       plan_queued as ref_plan_queued)
from repro.pim import bnn as ref_bnn
from repro.pim.frontend import jit as ref_jit, xnor as ref_xnor
from repro_torch.core import DrimGeometry
from repro_torch.pim import (bnn, execute, execute_graph, execute_oplist,
                             execute_partitioned, plan, plan_fused,
                             plan_queued, random_operands, xnor)
from repro_torch.pim.frontend import jit

from test_torch_graph import u32

# the reports' comparator fields: the GPU row in the port, the TPU in the
# reference; every other field is DRIM's and must be equal
COMPARATOR = {"gpu_latency_s", "gpu_energy_j", "speedup", "speedup_vs_gpu",
              "winner"}
REF_COMPARATOR = {"tpu_latency_s", "tpu_energy_j", "speedup",
                  "speedup_vs_tpu", "winner"}
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(fe=None):
    fe_jit, fe_xnor = (jit, xnor) if fe is None else fe

    @fe_jit
    def f(a, b):
        return fe_xnor(a, b)
    return f.trace().graph


def _ref_graph():
    return _graph((ref_jit, ref_xnor))


def _assert_warns_here(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    deps = [w for w in caught
            if issubclass(w.category, DeprecationWarning)
            and "staged pipeline" in str(w.message)]
    assert deps, "shim raised no DeprecationWarning"
    for w in deps:
        assert w.filename == __file__, (
            f"warning blamed {w.filename}:{w.lineno}, not the caller")
    return out


def _quiet(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn()


def _drim_fields(report, ref_report):
    got = {k: v for k, v in report.as_dict().items() if k not in COMPARATOR}
    want = {k: v for k, v in ref_report.as_dict().items()
            if k not in REF_COMPARATOR}
    return got, want


@pytest.fixture(scope="module")
def ab():
    return random_operands("xnor2", 6, seed=1)


@pytest.fixture(scope="module")
def geoms():
    return DrimGeometry(**SHAPE), RefGeometry(**SHAPE)


def test_execute_names_caller(geoms, ab):
    geom, geom_ref = geoms
    a, b = ab
    res, sched = _assert_warns_here(
        lambda: execute("xnor2", a, b, geom=geom, device="cpu"))
    want, sched_ref = _quiet(lambda: ref_execute("xnor2", a, b,
                                                 geom=geom_ref))
    np.testing.assert_array_equal(u32(res[0]), np.asarray(want[0]))
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)


def test_execute_oplist_names_caller(geoms, ab):
    geom, geom_ref = geoms
    a, b = ab
    got = _assert_warns_here(
        lambda: execute_oplist([("xnor2", (a, b)), ("maj3", (a, b, a))],
                               geom=geom, device="cpu"))
    want = _quiet(lambda: ref_execute_oplist(
        [("xnor2", (a, b)), ("maj3", (a, b, a))], geom=geom_ref))
    assert len(got) == len(want) == 2
    for (res, sched), (res_ref, sched_ref) in zip(got, want):
        np.testing.assert_array_equal(u32(res[0]), np.asarray(res_ref[0]))
        assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)


def test_execute_graph_names_caller(geoms, ab):
    geom, geom_ref = geoms
    a, b = ab
    res, sched = _assert_warns_here(
        lambda: execute_graph(_graph(), {"a": a, "b": b}, geom=geom,
                              engine="queued", n_queues=2, device="cpu"))
    want, sched_ref = _quiet(lambda: ref_execute_graph(
        _ref_graph(), {"a": a, "b": b}, geom=geom_ref, engine="queued",
        n_queues=2))
    assert set(res) == set(want)
    for name in want:
        np.testing.assert_array_equal(u32(res[name]), np.asarray(want[name]))
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)


def test_execute_partitioned_names_caller(ab):
    shape = dict(chips=1, banks=2, subarrays_per_bank=2, row_bits=64)
    a, b = ab
    res, sched = _assert_warns_here(
        lambda: execute_partitioned(_graph(), {"a": a, "b": b},
                                    geom=DrimGeometry(**shape), n_queues=2,
                                    device="cpu"))
    want, sched_ref = _quiet(lambda: ref_execute_partitioned(
        _ref_graph(), {"a": a, "b": b}, geom=RefGeometry(**shape),
        n_queues=2))
    for name in want:
        np.testing.assert_array_equal(u32(res[name]), np.asarray(want[name]))
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)


@pytest.mark.parametrize("in_dram", [True, False])
def test_plan_names_caller(in_dram):
    """The DRIM fields equal the reference's, closed form and simulated;
    staged operands (`operands_in_dram=False`) pay the same energy, and
    their extra latency is the boundary bytes at the comparator's memory
    rate (the card's HBM, the reference's TPU HBM)."""
    from repro.pim import offload as ref_offload
    from repro_torch.pim import offload
    for simulate in (False, True):
        rep = _assert_warns_here(lambda: plan(
            "xnor2", 1024, operands_in_dram=in_dram, simulate=simulate,
            device="cpu"))
        want = _quiet(lambda: ref_plan("xnor2", 1024,
                                       operands_in_dram=in_dram,
                                       simulate=simulate))
        got, want_f = _drim_fields(rep, want)
        if not in_dram:
            staged = 3 * 1024 / 8.0
            assert got.pop("drim_latency_s") - staged / offload.GPU_HBM_BW \
                == pytest.approx(want_f.pop("drim_latency_s")
                                 - staged / ref_offload.TPU_HBM_BW,
                                 rel=1e-12)
        assert got == want_f
        assert rep.simulated is want.simulated is simulate
        gpu = offload._gpu_row(3, 1, 1024)
        assert (rep.gpu_latency_s, rep.gpu_energy_j) == (gpu.latency_s,
                                                         gpu.energy_j)
        assert rep.winner == ("DRIM" if rep.drim_latency_s < gpu.latency_s
                              else "GPU")


def test_plan_fused_names_caller():
    g, g_ref = bnn.bnn_dot_graph(4), ref_bnn.bnn_dot_graph(4)
    for simulate in (False, True):
        rep = _assert_warns_here(lambda: plan_fused(
            g, 1 << 12, simulate=simulate, device="cpu"))
        want = _quiet(lambda: ref_plan_fused(g_ref, 1 << 12,
                                             simulate=simulate))
        got, want_f = _drim_fields(rep, want)
        assert got == want_f and rep.simulated is simulate
        assert rep.winner in ("DRIM-fused", "DRIM-unfused", "GPU")
    assert _assert_warns_here(lambda: plan_fused(_graph(), 1024)).n_nodes \
        == 1


def test_plan_queued_names_caller():
    g, g_ref = bnn.bnn_dot_graph_carrysave(8)[0], \
        ref_bnn.bnn_dot_graph_carrysave(8)[0]
    for simulate in (False, True):
        rep = _assert_warns_here(lambda: plan_queued(
            g, 1 << 12, n_queues=2, simulate=simulate, device="cpu"))
        want = _quiet(lambda: ref_plan_queued(g_ref, 1 << 12, n_queues=2,
                                              simulate=simulate))
        got, want_f = _drim_fields(rep, want)
        assert got == want_f and rep.simulated is simulate
        assert rep.speedup_vs_gpu == rep.gpu_latency_s / rep.queued_latency_s
    rep = _assert_warns_here(lambda: plan_queued(_graph(), 1024, n_queues=2))
    assert rep.n_queues == 2
