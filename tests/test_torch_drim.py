"""The `drim` import surface as `drim_torch`, held against `drim`.

Every name of `drim.__all__` is in `drim_torch.__all__` but the
comparator's cost (`TpuCost`/`tpu_cost` become `GpuCost`/`gpu_cost`: the
comparator is the card); the README's "Write a kernel in 10 lines" kernel
gives `drim`'s words on every engine ("cuda" in the place of "pallas",
"gpu" of "tpu"); `drim_torch.lower(x)` is `compile(x).lower()`; and a
fleet mesh with "cuda", with the comparator or with active faults raises
the reference's errors, word for word ("pallas" read as "cuda", "tpu" as
"gpu").  Tolerance: exact equality (words are integers)."""
import dataclasses

import numpy as np
import pytest
import torch

import drim
import drim_torch
from repro.pim import queue as ref_queue
from repro.pim import scheduler as ref_scheduler
from repro_torch.core import device as tdev
from repro_torch.pim import queue, scheduler
from repro_torch.runtime import telemetry

from test_torch_graph import u32

CPU8 = [torch.device("cpu")] * 8
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def readme_kernel(pkg):
    """The README's kernel, written against either package."""
    @pkg.jit
    def kernel(a, b, c):
        x = pkg.xnor(a, b)                 # 1 AAP fused (3 unfused)
        s, carry = pkg.full_add(x, c, b)   # Table-2 adder slice, 7 AAPs
        return {"sum": s, "carry": carry}
    return kernel


@pytest.fixture(scope="module")
def kernels():
    return readme_kernel(drim_torch), readme_kernel(drim)


@pytest.fixture(scope="module")
def geoms():
    return drim_torch.DrimGeometry(**SHAPE), drim.DrimGeometry(**SHAPE)


@pytest.fixture(scope="module")
def abc():
    rng = np.random.default_rng(23)
    return rng.integers(0, 1 << 32, (3, 200), dtype=np.uint32)


def test_all_names_of_drim_are_exported():
    """`drim.__all__` name for name, the comparator's cost renamed."""
    renamed = {"TpuCost": "GpuCost", "tpu_cost": "gpu_cost"}
    want = {renamed.get(n, n) for n in drim.__all__}
    assert set(drim_torch.__all__) == want
    assert len(drim_torch.__all__) == len(drim.__all__)
    for name in drim_torch.__all__:
        assert hasattr(drim_torch, name), name
    for name in renamed:
        assert not hasattr(drim_torch, name)
    assert "GpuCost" in drim_torch.__doc__ and "TpuCost" in drim_torch.__doc__
    assert drim_torch.obs is telemetry
    assert drim_torch.verify.VerifyError is drim_torch.VerifyError
    assert drim_torch.gpu_cost.__module__ == "repro_torch.pim.offload"
    assert drim_torch.engines() == ("resident", "baseline", "queued",
                                    "cuda", "gpu")
    assert drim_torch.DRIM_S == drim_torch.DrimGeometry(
        **dataclasses.asdict(drim.DRIM_S))
    assert drim_torch.ENGINE_REGISTRY.device_names() == \
        ("resident", "baseline", "queued", "cuda")


@pytest.mark.parametrize("engine,ref_engine,kw", [
    ("resident", "resident", {}), ("baseline", "baseline", {}),
    ("queued", "queued", {"n_queues": 4}), ("cuda", "pallas", {}),
    ("gpu", "tpu", {}), (None, None, {"partition": True}),
    ("cuda", "pallas", {"partition": 2})],
    ids=["resident", "baseline", "queued", "cuda", "gpu", "partitioned",
         "partitioned-cuda"])
def test_readme_kernel_words_equal_drim(engine, ref_engine, kw, kernels,
                                        geoms, abc):
    """The README's kernel through `drim_torch.compile(...).lower(...)`:
    the reference's words and measured schedule on every engine."""
    k, k_ref = kernels
    geom, geom_ref = geoms
    low = drim_torch.compile(k, geom=geom).lower(engine, **kw)
    low_ref = drim.compile(k_ref, geom=geom_ref).lower(ref_engine, **kw)
    got = low.run(*abc, device="cpu")
    want = low_ref.run(*abc)
    assert set(got) == set(want) == {"sum", "carry"}
    for name in want:
        np.testing.assert_array_equal(u32(got[name]), np.asarray(want[name]))
    assert low.kind == low_ref.kind and low.aaps == low_ref.aaps
    if engine != "gpu":
        assert dataclasses.asdict(low.schedule) == \
            dataclasses.asdict(low_ref.schedule)


def test_readme_call_and_schedule(kernels, abc):
    """`kernel(A, B, C)`: trace, compile, lower and run in one call, with
    the reference's words and `last_schedule` (2 nodes, 9 AAPs a tile)."""
    k, k_ref = kernels
    out = k(*abc, device="cpu")
    want = k_ref(*abc)
    for name in want:
        np.testing.assert_array_equal(u32(out[name]), np.asarray(want[name]))
    assert k.last_schedule.aaps_per_tile == \
        k_ref.last_schedule.aaps_per_tile == 9
    assert k.trace().n_nodes == k_ref.trace().n_nodes == 2
    low = drim_torch.compile(k).lower(engine="queued", n_queues=4)
    low_ref = drim.compile(k_ref).lower(engine="queued", n_queues=4)
    assert dataclasses.asdict(low.cost(1 << 27)) == \
        dataclasses.asdict(low_ref.cost(1 << 27))
    v, v_ref = low.verdict(1 << 27), low_ref.verdict(1 << 27)
    assert [dataclasses.asdict(r) for r in v.rows[:-1]] == \
        [dataclasses.asdict(r) for r in v_ref.rows[:-1]]
    assert (v.rows[-1].contender, v_ref.rows[-1].contender) == ("GPU", "TPU")


@pytest.mark.parametrize("src", ["xnor2", "graph", "partition"])
def test_lower_is_compile_then_lower(src, kernels, geoms):
    """`drim_torch.lower(x, ...)` is `compile(x).lower(...)`: the same
    program, readback, rows, AAPs and partition."""
    k, _ = kernels
    geom, _ = geoms
    kw = {"partition": True, "n_queues": 2} if src == "partition" else {}
    x = "xnor2" if src == "xnor2" else k
    a = drim_torch.lower(x, geom=geom, **kw)
    b = drim_torch.compile(x, geom=geom).lower(**kw)
    for field in ("kind", "program", "result_rows", "n_rows", "aaps",
                  "n_queues", "partition", "mesh"):
        assert getattr(a, field) == getattr(b, field), field
    assert a.engine is b.engine
    if src == "partition":
        assert [(s.part, s.stage, s.node_ids, s.fp) for s in a.gp.segments] \
            == [(s.part, s.stage, s.node_ids, s.fp) for s in b.gp.segments]


def _ref_mesh(geom_ref):
    return drim.fleet_mesh(geom_ref)


def _messages(fn, fn_ref, exc=ValueError):
    with pytest.raises(exc) as got:
        fn()
    with pytest.raises(exc) as want:
        fn_ref()
    return str(got.value), str(want.value)


def test_cuda_and_comparator_refuse_a_mesh(geoms):
    """A mesh on "cuda" (the reference's "pallas": at lower time and at
    dispatch) and on the comparator raises the reference's ValueError."""
    geom, geom_ref = geoms
    mesh, mesh_ref = drim_torch.fleet_mesh(geom, devices=CPU8), \
        _ref_mesh(geom_ref)
    got, want = _messages(
        lambda: drim_torch.compile("xnor2").lower("cuda", mesh=mesh),
        lambda: drim.compile("xnor2").lower("pallas", mesh=mesh_ref))
    assert got == want.replace("pallas", "cuda")
    got, want = _messages(
        lambda: drim_torch.lower(readme_kernel(drim_torch),
                                 engine="cuda", partition=True, mesh=mesh),
        lambda: drim.lower(readme_kernel(drim), engine="pallas",
                           partition=True, mesh=mesh_ref))
    assert got == want.replace("pallas", "cuda")
    w = [np.zeros(8, np.uint32)] * 2
    got, want = _messages(
        lambda: scheduler.dispatch_waves(
            "cuda", [torch.zeros(8, dtype=torch.int32)] * 2,
            scheduler.build_program("xnor2"), (2,), n_rows=16, geom=geom,
            mesh=mesh),
        lambda: ref_scheduler.dispatch_waves(
            "pallas", w, ref_scheduler.build_program("xnor2"), (2,),
            n_rows=16, geom=geom_ref, mesh=mesh_ref))
    assert got == want.replace("pallas", "cuda")
    got, want = _messages(
        lambda: drim_torch.compile("xnor2").lower("gpu", mesh=mesh),
        lambda: drim.compile("xnor2").lower("tpu", mesh=mesh_ref))
    assert got == want.replace("tpu", "gpu")
    got, want = _messages(
        lambda: scheduler.dispatch_waves("gpu", [], (), (), n_rows=0,
                                         geom=geom),
        lambda: ref_scheduler.dispatch_waves("tpu", [], (), (), n_rows=0,
                                             geom=geom_ref))
    assert got == want.replace("tpu", "gpu")


def v020(message: str) -> str:
    """The reference's V020 text as the port words it: the port's shards
    are fleet-mesh blocks, not `shard_map` shards, and its interpreter
    engine is "cuda"."""
    return message.replace("shard_map shard", "fleet-mesh shard") \
        .replace("pallas", "cuda")


def test_faults_under_a_mesh_raise_as_the_reference(geoms):
    """Active faults with a mesh: the verifier's V020 at lower and at run
    time, and the sharded device and queue runners' ValueErrors, word for
    word; an inactive model lowers and runs."""
    geom, geom_ref = geoms
    mesh, mesh_ref = drim_torch.fleet_mesh(geom, devices=CPU8), \
        _ref_mesh(geom_ref)
    hot, hot_ref = drim_torch.FaultModel(**HOT), drim.FaultModel(**HOT)
    got, want = _messages(
        lambda: drim_torch.compile("xnor2", geom=geom).lower(
            "resident", mesh=mesh, faults=hot),
        lambda: drim.compile("xnor2", geom=geom_ref).lower(
            "resident", mesh=mesh_ref, faults=hot_ref))
    assert got == v020(want) and got.startswith(
        drim_torch.verify.V020_FAULTS_UNSUPPORTED_ON_MESH)
    low = drim_torch.compile("xnor2", geom=geom).lower("resident", mesh=mesh)
    low_ref = drim.compile("xnor2", geom=geom_ref).lower("resident",
                                                         mesh=mesh_ref)
    a = np.arange(geom.n_subarrays * 2, dtype=np.uint32)
    got, want = _messages(
        lambda: low.run(a, a, device="cpu", faults=hot),
        lambda: low_ref.run(a, a, faults=hot_ref))
    assert got == v020(want)
    (out,) = low.run(a, a, device="cpu", faults=drim_torch.FaultModel())
    np.testing.assert_array_equal(u32(out), ~(a ^ a))

    dev = tdev.make_device(geom, n_data=4, device="cpu")
    got, want = _messages(
        lambda: tdev.device_run_program_sharded(dev, (), mesh, faults=hot),
        lambda: __import__("repro.core.device", fromlist=["x"])
        .device_run_program_sharded(None, None, mesh_ref, faults=hot_ref))
    assert got == want
    st = torch.zeros(1, 2, 2, 2, 8, 2, dtype=torch.int32)
    prog = scheduler.build_program("xnor2")
    got, want = _messages(
        lambda: queue.run_waves_queued([st], [prog], [(2,)], [16],
                                       mesh=mesh, faults=hot),
        lambda: ref_queue.run_waves_queued(
            [np.zeros((1, 2, 2, 2, 8, 2), np.uint32)], [prog], [(2,)], [16],
            mesh=mesh_ref, faults=hot_ref))
    assert got == want


def test_mesh_lowerings_are_memoized_per_mesh(geoms):
    """`lower_cached` keys on the mesh: the same mesh hits, another
    misses."""
    from repro_torch.pim import compiler
    geom, _ = geoms
    m8 = drim_torch.fleet_mesh(geom, devices=CPU8)
    m2 = drim_torch.fleet_mesh(geom, devices=CPU8[:2])
    a = compiler.lower_cached("xnor2", geom=geom, mesh=m8)
    assert compiler.lower_cached("xnor2", geom=geom,
                                 mesh=drim_torch.fleet_mesh(
                                     geom, devices=CPU8)) is a
    assert compiler.lower_cached("xnor2", geom=geom, mesh=m2) is not a
    assert a.mesh == m8
