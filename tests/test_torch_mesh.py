"""The port's meshes (`core.mesh`, `launch.mesh`, `pim.mesh`, the sharded
runners of `core.device`, `pim.scheduler` and `pim.queue`) held against the
JAX reference and against the unsharded runs: the mirror of
`tests/test_mesh_sharded.py`.

The reference's CI forces eight CPU devices on JAX; here a mesh is an
explicit device list, and `[torch.device("cpu")] * 8` gives the real 2x4
split of `small_geom` (2 chips x 4 banks x 8 sub-arrays of 64 bits) in
one process.  Every sharded run must equal the unsharded one and the
reference's bit for bit, with identical schedules.  Tolerance: exact
equality everywhere (all values are integers)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DrimGeometry as RefGeometry
from repro.core import device as ref_dev
from repro.kernels.ref import pack_signs_ref, xnor_gemm_ref
from repro.pim import bnn as ref_bnn
from repro.pim import mesh as ref_mesh
from repro.pim import scheduler as ref_scheduler
from repro_torch.core import DrimGeometry, encode
from repro_torch.core.subarray import N_XROWS
from repro_torch.core import device as tdev
from repro_torch.core import mesh as core_mesh
from repro_torch.launch import mesh as lmesh
from repro_torch.pim import (OP_ARITY, STAGED_SPEC, bnn, build_program,
                             fleet_mesh, fleet_shape, graph_ref_results,
                             queue_mesh, random_operands, scheduler,
                             shard_device, shard_staged, stage_rows)
from repro_torch.pim import compile as tcompile

from test_graph import GEOMS, random_graph
from test_torch_graph import geom_of, port_graph, u32

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geom(small_geom):
    return DrimGeometry(**dataclasses.asdict(small_geom))


def words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---------------------------------------------------------------------------
# Mesh construction
# ---------------------------------------------------------------------------

def test_fleet_shape_divides_geometry():
    """The mesh shape always divides (chips, banks), never exceeds the
    device count, and equals the reference's (ties prefer banks)."""
    shapes = [dict(chips=2, banks=4, subarrays_per_bank=8),
              dict(chips=1, banks=3), dict(chips=1, banks=256),
              dict(chips=4, banks=6), dict(chips=3, banks=1)]
    for shape in shapes:
        g, g_ref = DrimGeometry(**shape), RefGeometry(**shape)
        for n_dev in (1, 2, 3, 4, 6, 8, 16):
            mc, mb = fleet_shape(g, n_dev)
            assert g.chips % mc == 0 and g.banks % mb == 0
            assert mc * mb <= n_dev
            assert (mc, mb) == ref_mesh.fleet_shape(g_ref, n_dev)
    g = DrimGeometry(chips=2, banks=4, subarrays_per_bank=8)
    assert fleet_shape(g, 1) == (1, 1)
    assert fleet_shape(g, 8) == (2, 4)
    assert fleet_shape(g, 4) == (1, 4)
    assert fleet_shape(DrimGeometry(chips=1, banks=3), 2) == (1, 1)
    assert fleet_shape(DrimGeometry(chips=1, banks=3), 3) == (1, 3)


def test_fleet_mesh_axes_and_fallback(geom, monkeypatch):
    """One device is the 1x1 mesh; eight give the 2x4 split; without a
    device list the mesh takes the visible CUDA devices and raises
    without one."""
    mesh = fleet_mesh(geom, devices=[torch.device("cpu")])
    assert mesh.axis_names == ("chips", "banks") == tdev.MESH_AXES
    assert dict(mesh.shape) == {"chips": 1, "banks": 1}
    mesh = fleet_mesh(geom, devices=CPU8)
    assert dict(mesh.shape) == {"chips": 2, "banks": 4}
    assert list(mesh.devices.flat) == CPU8
    assert mesh == fleet_mesh(geom, devices=CPU8)
    assert hash(mesh) == hash(fleet_mesh(geom, devices=CPU8))
    assert mesh != fleet_mesh(geom, devices=CPU8[:4])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_mesh(geom)


def test_named_host_and_production_meshes():
    mesh = lmesh.make_named_mesh((2, 2), ("data", "model"), CPU8)
    assert mesh.shape == {"data": 2, "model": 2}
    assert list(mesh.devices.flat) == CPU8[:4]
    with pytest.raises(ValueError, match="needs 4 devices"):
        lmesh.make_named_mesh((2, 2), ("data", "model"), CPU8[:3])
    host = lmesh.make_host_mesh(2, devices=CPU8)
    assert host.shape == {"data": 4, "model": 2}
    assert lmesh.dp_axes(host) == ("data",)
    with pytest.raises(ValueError):
        lmesh.make_host_mesh(3, devices=CPU8)
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} devices"):
            lmesh.make_production_mesh(multi_pod=multi_pod, devices=CPU8)
    prod = lmesh.make_production_mesh(multi_pod=True, devices=CPU8 * 64)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    assert lmesh.dp_axes(prod) == ("pod", "data")
    assert repr(STAGED_SPEC) == repr(ref_mesh.STAGED_SPEC)


# ---------------------------------------------------------------------------
# Sharded execution
# ---------------------------------------------------------------------------

def test_device_run_program_sharded_matches_unsharded(geom, small_geom):
    """Same encoded stream on a 2x4 split: the full post-state (data AND
    dcc) equals the unsharded run's and the reference's."""
    rng = np.random.default_rng(0xD1)
    ref = ref_dev.make_device(small_geom, n_data=8)
    data = rng.integers(0, 1 << 32, ref.data.shape, dtype=np.uint32)
    dcc = rng.integers(0, 1 << 32, ref.dcc.shape, dtype=np.uint32)
    ref = ref_dev.DrimDevice(data=jnp.asarray(data), dcc=jnp.asarray(dcc))
    dev = shard_device(tdev.DrimDevice(data=words(data), dcc=words(dcc)),
                       fleet_mesh(geom, devices=CPU8))
    mesh = fleet_mesh(geom, devices=CPU8)
    for op in ("xnor2", "add"):
        enc = encode(build_program(op))
        plain = tdev.device_run_program(dev, enc)
        out = tdev.device_run_program_sharded(dev, enc, mesh)
        want = ref_dev.device_run_program(
            ref, ref_scheduler.encoded_program(op)[0])
        assert torch.equal(out.data, plain.data)
        assert torch.equal(out.dcc, plain.dcc)
        np.testing.assert_array_equal(u32(out.data), np.asarray(want.data))
        np.testing.assert_array_equal(u32(out.dcc), np.asarray(want.dcc))


@pytest.mark.parametrize("op", sorted(OP_ARITY))
def test_run_waves_sharded_bit_exact(op, geom, small_geom):
    """Every Table-2 op over a ragged multi-wave payload: the 2x4 sharded
    waves equal the unsharded ones and the reference's `run_waves`, and
    the pipeline's sharded run equals the baseline engine's, schedules
    included."""
    mesh = fleet_mesh(geom, devices=CPU8)
    row_w = geom.row_bits // 32
    n_words = 2 * geom.n_subarrays * row_w + 3
    args = random_operands(op, n_words, seed=sum(map(ord, op)))
    _, prog, _ = scheduler.encoded_program(op)
    rr, n_rows = scheduler.RESULT_ROWS[op], scheduler.N_DATA_ROWS + N_XROWS
    staged, _, _ = stage_rows([words(a) for a in args], geom=geom,
                              mesh=mesh)
    got = scheduler.run_waves(staged, prog, rr, n_rows=n_rows, mesh=mesh)
    plain = scheduler.run_waves(staged, prog, rr, n_rows=n_rows)
    ref_staged, _, _ = ref_scheduler.stage_rows(args, geom=small_geom)
    want = ref_scheduler.run_waves(ref_staged, prog, rr, n_rows=n_rows)
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(u32(got), np.asarray(want))

    low_m = tcompile(op, geom=geom).lower("resident", mesh=mesh)
    low_b = tcompile(op, geom=geom).lower("baseline", mesh=mesh)
    res_m = low_m.run(*args, device="cpu")
    res_b = low_b.run(*args, device="cpu")
    assert low_m.schedule == low_b.schedule
    for got, base, want in zip(res_m, res_b,
                               ref_scheduler.expected_results(op, args)):
        np.testing.assert_array_equal(u32(got), np.asarray(want))
        np.testing.assert_array_equal(u32(base), np.asarray(want))


def test_shard_staged_alignment(geom):
    """stage_rows(mesh=...) stages exactly the unsharded payload (the
    blocks are cut at dispatch) and only on a mesh that divides it."""
    mesh = fleet_mesh(geom, devices=CPU8)
    a, b = (words(x) for x in random_operands("xnor2", 64, seed=5))
    staged, _, _ = stage_rows([a, b], geom=geom, mesh=mesh)
    assert torch.equal(staged, stage_rows([a, b], geom=geom)[0])
    assert shard_staged(staged, mesh) is staged
    odd = DrimGeometry(chips=1, banks=3, subarrays_per_bank=2, row_bits=64)
    with pytest.raises(ValueError, match="does not divide"):
        stage_rows([a, b], geom=odd, mesh=mesh)


def test_shard_device_rejects_indivisible():
    geom = DrimGeometry(chips=1, banks=3, subarrays_per_bank=2, row_bits=32)
    dev = tdev.make_device(geom, n_data=4, device="cpu")
    mesh = fleet_mesh(DrimGeometry(chips=2, banks=4, subarrays_per_bank=2),
                      devices=CPU8)
    with pytest.raises(ValueError, match="does not divide array shape "
                       r"\(1, 3, 2, 12, 1\) under spec "
                       r"PartitionSpec\('chips', 'banks'\)"):
        shard_device(dev, mesh)
    with pytest.raises(ValueError, match="does not divide"):
        tdev.device_run_program_sharded(dev, encode(build_program("not")),
                                        mesh)


def test_random_dag_sharded_differential(n_examples):
    """The random-DAG suite of tests/test_graph.py through the sharded
    "resident" and "queued" engines: bit-exact against the unsharded
    baseline, the numpy oracle and the reference's pipeline, with
    identical measured schedules."""
    import drim
    for seed in range(n_examples):
        rng = np.random.default_rng(0x5EED + seed)
        g_ref = random_graph(rng)
        geom_ref = GEOMS[int(rng.integers(0, len(GEOMS)))]
        g, geom = port_graph(g_ref), geom_of(geom_ref)
        mesh = fleet_mesh(geom, devices=CPU8)
        row_w = geom.row_bits // 32
        n_words = int(rng.integers(1, 2 * geom.n_subarrays * row_w + 4))
        feeds = {name: rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
                 for name in g.input_names}
        oracle = graph_ref_results(g_ref, feeds)
        want = drim.compile(g_ref, geom=geom_ref).lower("resident").run(feeds)
        low_b = tcompile(g, geom=geom).lower("baseline")
        base = low_b.run(feeds, device="cpu")
        for engine in ("resident", "queued"):
            low = tcompile(g, geom=geom).lower(engine, mesh=mesh)
            got = low.run(feeds, device="cpu")
            assert set(got) == set(oracle) == set(base)
            for name in oracle:
                np.testing.assert_array_equal(u32(got[name]), oracle[name])
                np.testing.assert_array_equal(u32(got[name]),
                                              np.asarray(want[name]))
                np.testing.assert_array_equal(u32(base[name]), oracle[name])
            assert (low.schedule.aaps_per_tile, low.schedule.tiles,
                    low.schedule.waves) == (low_b.schedule.aaps_per_tile,
                                            low_b.schedule.tiles,
                                            low_b.schedule.waves)
        assert tcompile(g, geom=geom).lower(
            "resident", mesh=mesh).cost(n_words * 32) == \
            low_b.cost(n_words * 32)


# ---------------------------------------------------------------------------
# Queues under a mesh
# ---------------------------------------------------------------------------

def test_queue_mesh_reshapes_for_the_queue_blocks(geom):
    """A queue's payload carries banks / n_queues banks: the queue mesh is
    the largest split of that block over the same devices (the
    reference's rule), and None stays None."""
    mesh = fleet_mesh(geom, devices=CPU8)
    assert queue_mesh(geom, 2, None) is None
    for nq, shape in ((1, (2, 4)), (2, (2, 2)), (4, (2, 1))):
        qm = queue_mesh(geom, nq, mesh)
        geom_q = RefGeometry(chips=geom.chips, banks=geom.banks // nq,
                             subarrays_per_bank=geom.subarrays_per_bank)
        assert tuple(qm.shape.values()) == shape == \
            ref_mesh.fleet_shape(geom_q, 8)
        assert list(qm.devices.flat) == CPU8[:shape[0] * shape[1]]


def test_partitioned_k5_dot_under_a_1x2_mesh():
    """The carry-save K=5 dot partitioned over 2 queues under a 1x2 mesh
    (each queue's 2-bank block cut in two): the dots equal the unsharded
    run's, `xnor_gemm_ref`'s and the reference's partitioned run's, with
    the same QueueSchedule."""
    shape = dict(chips=1, banks=4, subarrays_per_bank=2, row_bits=64)
    geom, geom_ref = DrimGeometry(**shape), RefGeometry(**shape)
    mesh = fleet_mesh(geom, devices=CPU8[:2])
    assert mesh.shape == {"chips": 1, "banks": 2}
    assert queue_mesh(geom, 2, mesh).shape == {"chips": 1, "banks": 2}
    rng = np.random.default_rng(55)
    a = rng.integers(0, 2, (7, 5), dtype=np.uint8)
    b = rng.integers(0, 2, (9, 5), dtype=np.uint8)
    got, sched = bnn.bnn_dot_partitioned(a, b, geom=geom, n_queues=2,
                                         mesh=mesh, device="cpu")
    plain, sched_p = bnn.bnn_dot_partitioned(a, b, geom=geom, n_queues=2,
                                             device="cpu")
    want, sched_ref = ref_bnn.bnn_dot_partitioned(a, b, geom=geom_ref,
                                                  n_queues=2)
    sign = lambda x: np.where(x, 1.0, -1.0).astype(np.float32)
    pad = lambda x: np.pad(sign(x), ((0, 0), (0, 27)), constant_values=-1.0)
    oracle = np.asarray(xnor_gemm_ref(pack_signs_ref(pad(a)),
                                      pack_signs_ref(pad(b)), 5))
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), oracle)
    assert dataclasses.asdict(sched) == dataclasses.asdict(sched_p) == \
        dataclasses.asdict(sched_ref)
    for engine in ("resident", "queued"):
        c, _ = bnn.bnn_dot_drim(a, b, geom=geom, accumulate="carrysave",
                                engine=engine, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(c.numpy(), oracle)
    served = bnn.serve_bnn_matmul(a, b, geom=geom, mesh=mesh, device="cpu")
    np.testing.assert_array_equal(served.numpy(), oracle)


def test_mesh_runs_cut_the_blocks(geom, monkeypatch):
    """A mesh is not ignored: "resident" runs its wave function once per
    block of the 2x4 mesh (each block a quarter of the banks and half the
    chips), "queued" once per block of each queue's mesh, a partition
    once per block of each segment's run; "baseline" drops the mesh."""
    from repro_torch.pim import queue
    seen = []

    def spy(mesh, fn, tensors, spec):
        dims = [spec.index(axis) for axis in mesh.axis_names]

        def block(*ts):
            seen.append(tuple(ts[0].shape[d] for d in dims))
            return fn(*ts)
        return core_mesh.map_blocks(mesh, block, tensors, spec)
    monkeypatch.setattr(scheduler, "map_blocks", spy)
    monkeypatch.setattr(queue, "map_blocks", spy)
    mesh = fleet_mesh(geom, devices=CPU8)
    a, b = random_operands("xnor2", 200, seed=3)
    for engine, kw, want in (
            ("resident", {}, [(1, 1)] * 8),
            ("queued", {"n_queues": 2}, [(1, 1)] * 8),
            ("baseline", {}, [])):
        seen.clear()
        (got,) = tcompile("xnor2", geom=geom).lower(
            engine, mesh=mesh, **kw).run(a, b, device="cpu")
        np.testing.assert_array_equal(u32(got), ~(a ^ b))
        assert seen == want, engine
    seen.clear()
    g, _ = bnn.bnn_dot_graph_carrysave(3)
    low = tcompile(g, geom=geom).lower(partition=True, n_queues=2,
                                       mesh=mesh)
    feeds = {n: np.full(40, 0xF0F0F0F0, np.uint32) for n in g.input_names}
    low.run(feeds, device="cpu")
    assert len(seen) == 4 * len(low.gp.segments)
    assert set(seen) == {(1, 1)}
