"""The port's sub-array state, encoded-stream interpreter and device stack
(`core.subarray`, `core.isa.run_program`, `core.device`) held against the
JAX reference on the Table-2 microprograms and on random AAP soups over
every word-line, DCC aliases included: every data row and DCC cell of
every slot word-equal, fault-free and under injected faults.  Tolerance:
exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device as ref_dev
from repro.core import faults as ref_faults
from repro.core import isa as ref_isa
from repro.core import subarray as ref_sa
from repro.core import DrimGeometry as RefGeometry
from repro_torch.core import DrimGeometry, FaultModel
from repro_torch.core import device as tdev
from repro_torch.core import isa, subarray

N_DATA = 8
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)
SHAPE = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)

# name -> (program builder over a template, its operand rows)
MICROPROGRAMS = {
    "copy": (lambda m, t: m.microprogram_copy(t, 0, 1), 1),
    "not": (lambda m, t: m.microprogram_not(t, 0, 1), 1),
    "xnor2": (lambda m, t: m.microprogram_xnor2(t, 0, 1, 2), 2),
    "xor2": (lambda m, t: m.microprogram_xor2(t, 0, 1, 2), 2),
    "maj3": (lambda m, t: m.microprogram_maj3(t, 0, 1, 2, 3), 3),
    "min3": (lambda m, t: m.microprogram_min3(t, 0, 1, 2, 3), 3),
    "add": (lambda m, t: m.microprogram_add(t, 0, 1, 2, 3, 4), 3),
    "and2": (lambda m, t: m.microprogram_and2(t, 0, 1, 2, 3), 3),
    "or2": (lambda m, t: m.microprogram_or2(t, 0, 1, 2, 3), 3),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers, and their
    thread pools contending for the cores made the full-width engine
    routes run a hundred times slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def assert_state_equal(got, want, what=""):
    np.testing.assert_array_equal(u32(got.data), np.asarray(want.data),
                                  err_msg=f"{what} data")
    np.testing.assert_array_equal(u32(got.dcc), np.asarray(want.dcc),
                                  err_msg=f"{what} dcc")


@pytest.fixture(scope="module")
def devices():
    """The same randomly filled 2 x 4 x 8 stack in both packages: every
    data row and both DCC cells random, so the DCC aliases are live."""
    rng = np.random.default_rng(42)
    ref = ref_dev.make_device(RefGeometry(**SHAPE), n_data=N_DATA)
    data = rng.integers(0, 1 << 32, ref.data.shape, dtype=np.uint32)
    dcc = rng.integers(0, 1 << 32, ref.dcc.shape, dtype=np.uint32)
    ref = ref_dev.DrimDevice(data=jnp.asarray(data), dcc=jnp.asarray(dcc))
    port = tdev.DrimDevice(data=words(data), dcc=words(dcc))
    return port, ref


def random_program(rng, mod, n_rows, n_ins):
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    ops_ = [int(rng.integers(0, 4)) for _ in range(n_ins)]
    return tuple(mod.AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                                   for _ in range(arity[op])))
                 for op in ops_)


def test_make_device_and_template_match_reference():
    port = tdev.make_device(DrimGeometry(**SHAPE), n_data=N_DATA,
                            device="cpu")
    ref = ref_dev.make_device(RefGeometry(**SHAPE), n_data=N_DATA)
    assert port.data.shape == ref.data.shape
    assert port.dcc.shape == ref.dcc.shape
    assert port.data.dtype == torch.int32 and not port.data.any()
    for name in ("chips", "banks", "subarrays", "n_slots", "n_rows",
                 "words", "row_bits"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.wl_x(1), port.wl_dcc(4)) == (ref.wl_x(1), ref.wl_dcc(4))
    t, rt = tdev.device_template(port), ref_dev.device_template(ref)
    assert (t.n_rows, t.words, t.row_bits) == (rt.n_rows, rt.words,
                                               rt.row_bits)
    small = tdev.make_device(chips=1, banks=2, subarrays=3, n_data=4,
                             row_bits=96, device="cpu")
    assert small.data.shape == (1, 2, 3, 12, 3)


def test_make_device_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdev.make_device()


def test_load_and_read_helpers_match_reference(devices):
    port, ref = devices
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 1 << 32, (2, 4, 8, 3, 2), dtype=np.uint32)
    got = tdev.device_load_rows(port, 2, rows)
    want = ref_dev.device_load_rows(ref, 2, jnp.asarray(rows))
    assert_state_equal(got, want, "load")
    assert not torch.equal(got.data, port.data)       # input untouched
    block = rng.integers(0, 1 << 32, (2, 2), dtype=np.uint32)
    assert_state_equal(tdev.device_broadcast_rows(port, 5, block),
                       ref_dev.device_broadcast_rows(ref, 5,
                                                     jnp.asarray(block)),
                       "broadcast")
    np.testing.assert_array_equal(u32(tdev.device_read_row(port, 3)),
                                  np.asarray(ref_dev.device_read_row(ref, 3)))
    np.testing.assert_array_equal(
        u32(tdev.device_read_rows(port, (7, 0, 7))),
        np.asarray(ref_dev.device_read_rows(ref, (7, 0, 7))))
    np.testing.assert_array_equal(
        u32(tdev.device_read_row_window(port, 1, 4)),
        np.asarray(ref_dev.device_read_row_window(ref, 1, 4)))
    assert_state_equal(port.slot(1, 2, 3), ref.slot(1, 2, 3), "slot")


@pytest.mark.parametrize("name", sorted(MICROPROGRAMS))
@pytest.mark.parametrize("faulted", [False, True])
def test_device_run_program_matches_reference(devices, name, faulted):
    """Every slot's whole post-state (data rows and DCC cells) after a
    Table-2 microprogram, fault-free and under HOT faults."""
    port, ref = devices
    build, _ = MICROPROGRAMS[name]
    prog = build(isa, tdev.device_template(port))
    ref_prog = build(ref_isa, ref_dev.device_template(ref))
    assert [(i.op, i.args) for i in prog] == \
        [(i.op, i.args) for i in ref_prog]
    got = tdev.device_run_program(
        port, isa.encode(prog),
        faults=FaultModel(**HOT) if faulted else None)
    want = ref_dev.device_run_program(
        ref, ref_isa.encode(ref_prog),
        faults=ref_faults.FaultModel(**HOT) if faulted else None)
    assert_state_equal(got, want, name)
    assert_state_equal(port, ref, "input")      # the input is untouched


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_run_program_random_soup_matches_reference(seed):
    """A random program over every word-line, stuck rows and protected
    ops, on one sub-array with a slot id, and on a batch of slots."""
    rng = np.random.default_rng(seed)
    n_data, w = 6, 3
    ref_prog = random_program(rng, ref_isa, n_data + 8, 120)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    kw = dict(p_dra=0.3, p_tra=0.4, seed=seed,
              stuck_rows=((1, 1), (n_data + 2, 0)),
              protected_ops=tuple(range(0, 120, 5)))
    data = rng.integers(0, 1 << 32, (n_data + 8, w), dtype=np.uint32)
    dcc = rng.integers(0, 1 << 32, (2, w), dtype=np.uint32)
    ref = ref_sa.SubArray(data=jnp.asarray(data), dcc=jnp.asarray(dcc))
    port = subarray.SubArray(data=words(data), dcc=words(dcc))
    for faults, ref_model in ((None, None),
                              (FaultModel(**kw),
                               ref_faults.FaultModel(**kw))):
        want = ref_isa.run_program(ref, ref_isa.encode(ref_prog),
                                   faults=ref_model, slot_id=77)
        got = isa.run_program(port, isa.encode(prog), faults=faults,
                              slot_id=77)
        assert_state_equal(got, want, str(faults))
        np.testing.assert_array_equal(u32(port.data), data)   # untouched
    if seed == 0:
        # run_program_py updates its state in place: give it a copy, since
        # the reference's arrays may share `data`'s memory
        py = isa.run_program_py(subarray.SubArray(data=words(data).clone(),
                                                  dcc=words(dcc).clone()),
                                prog)
        assert_state_equal(py, ref_isa.run_program_py(ref, ref_prog), "py")


def test_subarray_primitives_match_reference():
    """Each AAP primitive on its own, DCC word-lines as sources and
    destinations included."""
    rng = np.random.default_rng(4)
    sa_j = ref_sa.make_subarray(n_data=4, row_bits=64)
    data = rng.integers(0, 1 << 32, sa_j.data.shape, dtype=np.uint32)
    dcc = rng.integers(0, 1 << 32, sa_j.dcc.shape, dtype=np.uint32)
    n = sa_j.n_rows
    cases = [("aap_copy", (0, n + 1)), ("aap_copy", (n + 1, 3)),
             ("aap_copy", (n, n + 1)), ("aap_copy2", (n, n + 1, n + 2)),
             ("aap_copy2", (2, 5, n + 3)), ("aap_dra", (0, n + 1, n + 3)),
             ("aap_dra", (1, 2, 1)), ("aap_tra", (0, 1, n + 2, n + 1)),
             ("aap_tra", (3, 3, 4, 0))]
    for name, args in cases:
        want = getattr(ref_sa, name)(
            ref_sa.SubArray(data=jnp.asarray(data), dcc=jnp.asarray(dcc)),
            *args)
        got = getattr(subarray, name)(           # in place: on a copy
            subarray.SubArray(data=words(data).clone(),
                              dcc=words(dcc).clone()), *args)
        assert_state_equal(got, want, f"{name}{args}")
    for wl in range(n + 4):
        np.testing.assert_array_equal(
            u32(subarray.activate_read(subarray.SubArray(
                data=words(data), dcc=words(dcc)), wl)),
            np.asarray(ref_sa.activate_read(ref_sa.SubArray(
                data=jnp.asarray(data), dcc=jnp.asarray(dcc)), wl)))
    rows = rng.integers(0, 1 << 32, (3, 2), dtype=np.uint32)
    assert_state_equal(
        subarray.load_rows(subarray.SubArray(data=words(data),
                                             dcc=words(dcc)), 2, rows),
        ref_sa.load_rows(ref_sa.SubArray(data=jnp.asarray(data),
                                         dcc=jnp.asarray(dcc)), 2,
                         jnp.asarray(rows)), "load_rows")


def test_make_subarray_and_bit_packing_match_reference():
    sa, ref = subarray.make_subarray(n_data=5, row_bits=96), \
        ref_sa.make_subarray(n_data=5, row_bits=96)
    assert sa.data.shape == ref.data.shape and sa.dcc.shape == ref.dcc.shape
    assert (sa.n_rows, sa.words, sa.row_bits) == (ref.n_rows, ref.words,
                                                  ref.row_bits)
    bits = np.random.default_rng(5).integers(0, 2, (3, 128), dtype=np.uint32)
    packed = subarray.pack_bits(torch.from_numpy(bits.astype(np.int32)))
    want = np.asarray(ref_sa.pack_bits(jnp.asarray(bits)))
    np.testing.assert_array_equal(u32(packed), want)
    np.testing.assert_array_equal(
        subarray.unpack_bits(packed).numpy(),
        np.asarray(ref_sa.unpack_bits(jnp.asarray(want))).astype(np.int32))


def test_donate_runs_in_place_and_copy_keeps_the_input(devices):
    port, _ = devices
    prog = MICROPROGRAMS["xnor2"][0](isa, tdev.device_template(port))
    dev = tdev.DrimDevice(data=port.data.clone(), dcc=port.dcc.clone())
    want = tdev.device_run_program(dev, isa.encode(prog))
    assert torch.equal(dev.data, port.data)
    out = tdev.device_run_program(dev, isa.encode(prog), donate=True)
    assert out.data.data_ptr() == dev.data.data_ptr()
    assert torch.equal(out.data, want.data) and torch.equal(out.dcc,
                                                            want.dcc)


def test_banked_and_sharded_runners_wait_for_item_9(devices):
    """The banked runner (Queue 1 item 9) runs a different Table-2 stream
    per bank block and equals the reference's, fault-free and faulted;
    the sharded one (Queue 1 item 12) runs every Table-2 stream over a
    2x4 fleet mesh of CPU devices and equals the reference's unsharded
    run, and refuses active faults with the reference's ValueError."""
    port, ref = devices
    blocks = [(0, 1), (1, 3), (3, 4)]
    names = ("xnor2", "add", "maj3")
    for faults in (None, HOT):
        out = tdev.device_run_program_banked(
            port, [isa.encode(MICROPROGRAMS[n][0](isa, tdev.device_template(
                port))) for n in names], blocks,
            faults=FaultModel(**faults) if faults else None)
        want = ref_dev.device_run_program_banked(
            ref, [ref_isa.encode(MICROPROGRAMS[n][0](
                ref_isa, ref_dev.device_template(ref))) for n in names],
            blocks, faults=ref_faults.FaultModel(**faults) if faults
            else None)
        assert_state_equal(out, want, f"banked {faults}")
    from repro_torch.pim import fleet_mesh
    mesh = fleet_mesh(DrimGeometry(**SHAPE),
                      devices=[torch.device("cpu")] * 8)
    assert mesh.shape == {"chips": 2, "banks": 4}
    for name in names:
        out = tdev.device_run_program_sharded(port, isa.encode(
            MICROPROGRAMS[name][0](isa, tdev.device_template(port))), mesh)
        want = ref_dev.device_run_program(ref, ref_isa.encode(
            MICROPROGRAMS[name][0](ref_isa, ref_dev.device_template(ref))))
        assert_state_equal(out, want, f"sharded {name}")
    with pytest.raises(ValueError, match="run faulted programs with "
                       "mesh=None"):
        tdev.device_run_program_sharded(port, isa.encode(()), mesh,
                                        faults=FaultModel(**HOT))


def test_serving_through_the_baseline_engine_keeps_the_tokens():
    """`launch.serve --engine baseline` routes the decode BitLinear GEMMs
    through the full-state interpreter: the greedy tokens equal the
    native dense route's (the tiny geometry of tests/test_torch_serve.py)."""
    from repro_torch.launch import serve
    tiny = ["--arch", "drim-bnn", "--smoke-config", "--layers", "2",
            "--d-model", "32", "--d-ff", "64", "--heads", "2",
            "--kv-heads", "1", "--d-head", "16", "--vocab", "128",
            "--prompt-len", "8", "--gen", "3", "--batch", "2",
            "--device", "cpu"]
    native, _ = serve.run_serve(serve.parse_args(tiny + ["--engine", "gpu"]))
    gen, stats = serve.run_serve(serve.parse_args(
        tiny + ["--engine", "baseline", "--packed"]))
    assert stats["engine"] == "baseline" and gen.shape == (2, 3)
    np.testing.assert_array_equal(gen, native)
