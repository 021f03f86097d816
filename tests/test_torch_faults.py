"""The port's Table-3 fault injection held against the JAX reference.

The contract is determinism: whether an op instance fails and which bit
it flips is a counter-based hash of (seed, op index, global sub-array
slot), so the port's "resident", "baseline" and "cuda" engines must draw
the IDENTICAL flips the reference's "resident", "baseline" and "pallas"
engines draw (Pallas in interpret mode, as the reference's own tests run
it off-TPU; the port's "cuda" engine runs the kernel's packed twin on CPU
tensors, the stuck rows folded into the packed stream, and
`aap_interp_faulted_plain` is the unpacked oracle).  Tolerance: exact
equality everywhere.

The hash is uint32 arithmetic that the port does in int64, so the edge
words (0, 0xFFFFFFFF), the largest threshold, op indices past 2**31 and a
non-power-of-two bit-position modulus are checked word for word.

The reference is imported by the `jref` fixture, not at module level, so
that the `cuda` tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_faults.py
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from repro_torch.core import DRIM_R, DrimGeometry, FaultModel, isa
from repro_torch.core import faults as tfaults
from repro_torch.kernels import aap_interpreter
from repro_torch.pim import compile as tcompile
from repro_torch.pim import scheduler
from repro_torch.pim.bnn import bnn_dot_graph_carrysave

ENGINES = ("resident", "baseline", "cuda")
REF_ENGINES = ("resident", "baseline", "pallas")
HOT = dict(p_dra=0.25, p_tra=0.35, seed=3)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.fixture(scope="module")
def jref():
    import jax.numpy as jnp

    from jax.experimental import pallas as pl

    import drim
    from repro.core import faults as ref_faults
    from repro.core import isa as ref_isa
    from repro.kernels import aap_interpreter as ref_interp
    from repro.pim import scheduler as ref_sched
    from repro.pim.bnn import bnn_dot_graph_carrysave as ref_carrysave
    return types.SimpleNamespace(
        jnp=jnp, pl=pl, drim=drim, faults=ref_faults, isa=ref_isa,
        interp=ref_interp, sched=ref_sched, carrysave=ref_carrysave,
        HOT=ref_faults.FaultModel(**HOT))


@pytest.fixture(scope="module")
def geoms(jref):
    """(port geometry, reference geometry): the reference tests' 2 chips x
    4 banks x 8 sub-arrays of 64-bit rows."""
    shape = dict(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)
    from repro.core import DrimGeometry as RefGeometry
    return DrimGeometry(**shape), RefGeometry(**shape)


@pytest.fixture(scope="module")
def corner(jref):
    """The +-15% corner from the calibrated Monte-Carlo (source="sim"),
    the reference's and the port's, which must give the same rates."""
    ref = jref.faults.FaultModel.from_corner(0.15, source="sim", seed=0)
    port = FaultModel.from_corner(0.15, source="sim", seed=0, device="cpu")
    assert (port.p_dra, port.p_tra) == (ref.p_dra, ref.p_tra)
    return ref, port


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_program(rng, mod, n_rows, n_ins):
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    ops_ = [int(rng.integers(0, 4)) for _ in range(n_ins)]
    return tuple(mod.AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                                   for _ in range(arity[op])))
                 for op in ops_)


# ---------------------------------------------------------------------------
# The hash, word for word
# ---------------------------------------------------------------------------

EDGE_WORDS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                       0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def test_mix32_matches_reference(jref):
    rng = np.random.default_rng(0)
    xs = np.concatenate([EDGE_WORDS,
                         rng.integers(0, 1 << 32, 4096, dtype=np.uint32)])
    want = np.asarray(jref.faults.mix32(xs))
    for given in (xs, words(xs), torch.from_numpy(xs.astype(np.int64))):
        got = tfaults.mix32(given)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(tfaults.mix32(0xFFFFFFFF)) == int(jref.faults.mix32(
        np.uint32(0xFFFFFFFF)))


@pytest.mark.parametrize("n_positions", [64, 96, 256])
@pytest.mark.parametrize("op_index", [0, 5, 2 ** 31 - 1, 2 ** 31 + 3,
                                      0x9E3779B9, 2 ** 32 - 1])
def test_fault_mask_matches_reference(jref, op_index, n_positions):
    """Thresholds from 0 to 2**32 - 1 against every slot of a fleet and
    every word of its rows, including the edge slot hashes."""
    jnp = jref.jnp
    grid = np.asarray(jref.faults.slot_ids_grid(2, 4, 8))
    slot_h = np.concatenate([np.asarray(jref.faults.mix32(grid ^ 3))
                             .reshape(-1), EDGE_WORDS])[:, None]
    w = n_positions // 32
    word_ids = np.arange(w, dtype=np.uint32)
    for thresh in (0, 1, 2 ** 31, FaultModel(p_tra=0.35).tra_thresh,
                   2 ** 32 - 1):
        want = np.asarray(jref.faults.fault_mask(
            jnp.uint32(thresh), op_index, jnp.asarray(slot_h),
            jnp.asarray(word_ids), n_positions))
        got = tfaults.fault_mask(thresh, op_index, words(slot_h),
                                 torch.from_numpy(word_ids.astype(np.int64)),
                                 n_positions)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(u32(got), want, err_msg=str(thresh))
        # tensor threshold and op index take the same path as ints
        got_t = tfaults.fault_mask(
            torch.tensor(thresh, dtype=torch.int64),
            torch.tensor(op_index, dtype=torch.int64),
            tfaults.as_u32(slot_h), word_ids, n_positions)
        np.testing.assert_array_equal(u32(got_t), want)
    full = tfaults.fault_mask(2 ** 32 - 1, op_index, words(slot_h),
                              word_ids, n_positions)
    # the largest threshold fails almost every slot: one bit per slot
    per_slot = np.unpackbits(u32(full).view(np.uint8)).reshape(
        len(slot_h), -1).sum(1)
    assert per_slot.max() == 1 and per_slot.sum() >= len(slot_h) - 1


@pytest.mark.parametrize("shape,bank_lo,banks_total", [
    ((2, 4, 8), 0, None), ((1, 2, 1024), 3, 8), ((3, 1, 5), 2, 7)])
def test_slot_ids_grid_matches_reference(jref, shape, bank_lo, banks_total):
    want = np.asarray(jref.faults.slot_ids_grid(
        *shape, bank_lo=bank_lo, banks_total=banks_total))
    got = tfaults.slot_ids_grid(*shape, bank_lo=bank_lo,
                                banks_total=banks_total)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


# ---------------------------------------------------------------------------
# FaultModel
# ---------------------------------------------------------------------------

def test_fault_model_validation_and_normalisation(jref):
    RefModel = jref.faults.FaultModel
    with pytest.raises(ValueError, match="p_dra"):
        FaultModel(p_dra=1.5)
    with pytest.raises(ValueError, match="p_tra"):
        FaultModel(p_tra=-0.1)
    with pytest.raises(ValueError, match="0 or 1"):
        FaultModel(stuck_rows=((3, 2),))
    kw = dict(p_dra=0.012, p_tra=0.999999, seed=7,
              stuck_rows=[(4, True), [9, 0]], dead_queues=(2, (1, 3)),
              protected_ops=(3, 1, 3))
    got, want = FaultModel(**kw), RefModel(**kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.dead_queues == ((2, 0), (1, 3))
    assert got.protected_ops == (1, 3)
    for p in (0.0, 1e-12, 0.012, 0.055, 0.5, 0.999999999999):
        a, b = FaultModel(p_dra=p, p_tra=p), RefModel(p_dra=p, p_tra=p)
        assert (a.dra_thresh, a.tra_thresh) == (b.dra_thresh, b.tra_thresh)
    assert FaultModel(p_tra=0.999999999999).tra_thresh == 2 ** 32 - 1
    hash(got)                                   # rides in lru_cache keys


def test_fault_model_flags_and_wave_model(jref):
    assert not FaultModel().active and FaultModel().wave_model() is None
    only_dead = FaultModel(dead_queues=(2,))
    assert only_dead.active and not only_dead.flips_active
    assert only_dead.wave_model() is None
    m = FaultModel(p_dra=0.1, dead_queues=((1, 0),))
    wm = m.wave_model()
    assert wm.dead_queues == () and wm.p_dra == m.p_dra
    assert FaultModel(stuck_rows=((1, 1),)).wave_model() is not None
    assert m.with_protected([5, 2]).protected_ops == (2, 5)
    rng = np.random.default_rng(3)
    ref_prog = random_program(rng, jref.isa, 12, 80)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    for kw in (HOT, dict(p_tra=0.1, protected_ops=range(0, 80, 3)),
               dict(p_dra=0.2)):
        assert FaultModel(**kw).count_faultable(prog) == \
            jref.faults.FaultModel(**kw).count_faultable(ref_prog)


def test_from_corner(jref):
    from repro_torch.core.analog import PAPER_TABLE3
    from repro.core.analog import PAPER_TABLE3 as REF_TABLE3
    assert PAPER_TABLE3 == REF_TABLE3
    for corner in PAPER_TABLE3:
        got = FaultModel.from_corner(corner, source="paper", seed=5)
        want = jref.faults.FaultModel.from_corner(corner, source="paper",
                                                  seed=5)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    paper = FaultModel.from_corner(0.15, source="paper")
    assert (paper.p_dra, paper.p_tra) == (0.012, 0.055)
    with pytest.raises(ValueError, match="Table-3 corner"):
        FaultModel.from_corner(0.17, source="paper")
    with pytest.raises(ValueError, match="unknown source"):
        FaultModel.from_corner(0.15, source="oracle")
    # source="sim" (the default) runs the port's Monte-Carlo: the
    # reference's rates; without a card, device=None raises
    got = FaultModel.from_corner(0.15, seed=5, device="cpu")
    want = jref.faults.FaultModel.from_corner(0.15, seed=5)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FaultModel.from_corner(0.15)


# ---------------------------------------------------------------------------
# Flip identity across the engines, the reference's included
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def op_case(jref, geoms):
    """xnor2 over two waves plus a ragged tail, under HOT, on the
    reference's three engines."""
    _, rgeom = geoms
    n_words = 2 * rgeom.n_subarrays * (rgeom.row_bits // 32) + 3
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 1 << 32, n_words, dtype=np.uint32)
            for _ in range(2))
    want = {}
    for eng in REF_ENGINES:
        (res,) = jref.drim.compile("xnor2", geom=rgeom).lower(
            eng, faults=jref.HOT).run(a, b)
        want[eng] = np.asarray(res)
    return a, b, want


def test_op_flip_identity(op_case, geoms):
    a, b, want = op_case
    geom, _ = geoms
    for eng in REF_ENGINES[1:]:
        np.testing.assert_array_equal(want[eng], want["resident"])
    assert np.unpackbits((want["resident"] ^ ~(a ^ b)).view(np.uint8)).sum()
    for eng in ENGINES:
        (got,) = tcompile("xnor2", geom=geom).lower(
            eng, faults=FaultModel(**HOT)).run(a, b, device="cpu")
        np.testing.assert_array_equal(u32(got), want["resident"],
                                      err_msg=eng)


@pytest.fixture(scope="module")
def graph_case(jref, geoms, corner):
    """The K=4 carry-save dot over one wave: feeds, and the reference's
    outputs under HOT on its three engines and at its +-15% corner."""
    _, rgeom = geoms
    rgraph, _ = jref.carrysave(4)
    rng = np.random.default_rng(1)
    n_words = rgeom.n_subarrays * (rgeom.row_bits // 32)
    feeds = {n: (np.zeros(n_words, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, n_words, dtype=np.uint32))
             for n in rgraph.input_names}
    want = {}
    for eng in REF_ENGINES:
        low = jref.drim.compile(rgraph, geom=rgeom).lower(
            eng, faults=jref.HOT)
        want[eng] = {k: np.asarray(v) for k, v in low.run(feeds).items()}
    low = jref.drim.compile(rgraph, geom=rgeom).lower("resident")
    want["corner"] = {k: np.asarray(v)
                      for k, v in low.run(feeds, faults=corner[0]).items()}
    return feeds, want


def test_graph_flip_identity(graph_case, geoms, corner):
    feeds, want = graph_case
    geom, _ = geoms
    graph, _ = bnn_dot_graph_carrysave(4)
    for eng in ENGINES:
        low = tcompile(graph, geom=geom).lower(eng)
        for model, key in ((FaultModel(**HOT), "resident"),
                           (corner[1], "corner")):
            got = low.run(feeds, device="cpu", faults=model)
            for name, w in want[key].items():
                np.testing.assert_array_equal(
                    u32(got[name]), w, err_msg=f"{eng} {key} {name}")
    for eng in REF_ENGINES[1:]:
        for name, w in want[eng].items():
            np.testing.assert_array_equal(w, want["resident"][name])


def test_lowering_default_and_per_run_override(geoms, op_case):
    a, b, want = op_case
    geom, _ = geoms
    low = tcompile("xnor2", geom=geom).lower("cuda",
                                             faults=FaultModel(**HOT))
    (r1,) = low.run(a, b, device="cpu")
    (r2,) = low.run(a, b, device="cpu")
    np.testing.assert_array_equal(u32(r1), want["resident"])
    np.testing.assert_array_equal(u32(r1), u32(r2))
    other = dataclasses.replace(FaultModel(**HOT), seed=4)
    (r3,) = low.run(a, b, device="cpu", faults=other)
    assert (u32(r3) != u32(r1)).any()
    with pytest.raises(TypeError, match="FaultModel"):
        tcompile("xnor2").lower("resident", faults="hot")
    with pytest.raises(TypeError, match="FaultModel"):
        tcompile("xnor2", geom=geom).lower("resident").run(
            a, b, device="cpu", faults=object())


def test_inactive_models_run_the_clean_path(geoms, monkeypatch):
    """No flips, or only dead queues (a dispatcher concern): every engine
    runs the fault-free path, the cuda engine the fault-free kernel."""
    def boom(*args, **kwargs):
        raise AssertionError("the faulted interpreter ran")
    # the unpacked oracle, and the flips of the packed twin
    monkeypatch.setattr(aap_interpreter, "aap_interp_faulted_plain", boom)
    monkeypatch.setattr(aap_interpreter, "_flipper", boom)
    geom, _ = geoms
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 1 << 32, 23, dtype=np.uint32) for _ in range(2))
    for eng in ENGINES:
        low = tcompile("xnor2", geom=geom).lower(eng)
        for model in (None, FaultModel(), FaultModel(dead_queues=(2,))):
            (res,) = low.run(a, b, device="cpu", faults=model)
            np.testing.assert_array_equal(u32(res), ~(a ^ b), err_msg=eng)


def test_stuck_rows_protected_ops_and_bank_anchor(jref):
    """`run_waves` on a payload holding banks [2, 4) of an 8-bank fleet,
    anchored there with `bank_geom`, with a stuck operand row, a stuck
    result row and a stuck row past the template, and some protected
    ops: every port engine equals the reference's three."""
    rng = np.random.default_rng(11)
    n_rows, n_in = 14, 4
    ref_prog = random_program(rng, jref.isa, n_rows, 70)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    readback = (0, 1, 5, 9, 13)
    staged = rng.integers(0, 1 << 32, (2, n_in, 1, 2, 3, 3),
                          dtype=np.uint32)
    kw = dict(p_dra=0.3, p_tra=0.4, seed=9,
              stuck_rows=((1, 1), (9, 0), (40, 1)),
              protected_ops=tuple(range(0, 70, 4)))
    bank_geom = (2, 8)
    want = {}
    for eng in REF_ENGINES:
        want[eng] = np.asarray(jref.sched.run_waves(
            jref.jnp.asarray(staged), ref_prog, readback, n_rows=n_rows,
            engine=eng, faults=jref.faults.FaultModel(**kw),
            bank_geom=bank_geom))
        np.testing.assert_array_equal(want[eng], want["resident"])
    assert (want["resident"][:, 1] == 0xFFFFFFFF).all()
    assert (want["resident"][:, 3] == 0).all()
    for eng in ENGINES:
        got = scheduler.run_waves(words(staged), prog, readback,
                                  n_rows=n_rows, engine=eng,
                                  faults=FaultModel(**kw),
                                  bank_geom=bank_geom)
        np.testing.assert_array_equal(u32(got), want["resident"],
                                      err_msg=eng)
    # without the anchor the slice draws another fleet's flips
    unanchored = scheduler.run_waves(words(staged), prog, readback,
                                     n_rows=n_rows, faults=FaultModel(**kw))
    assert (u32(unanchored) != want["resident"]).any()


def test_empty_program_honours_stuck_rows(jref):
    tiles = np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 1, 3, 4)
    readback = (0, 1, 5, 10, 11)
    kw = dict(p_dra=0.5, stuck_rows=((1, 1), (5, 0), (0, 1)))
    want = np.asarray(jref.interp.pallas_wave_fn(
        (), readback, 10, interpret=True,
        faults=jref.faults.FaultModel(**kw))(jref.jnp.asarray(tiles)))
    got = aap_interpreter.cuda_wave_fn((), readback, 10,
                                       faults=FaultModel(**kw))(
        words(tiles)[None])
    np.testing.assert_array_equal(u32(got[0]), want)
    assert (want[1] == 0xFFFFFFFF).all()


def test_faults_cli_counts_the_flips_of_every_scheme(geoms, monkeypatch,
                                                   capsys):
    """`python -m repro_torch.launch.faults` at the small geometry and K=4:
    one line per scheme whose corrupted bits and ECC mismatch bits are
    those of the "cuda" engine's run against the clean oracle."""
    from repro_torch.launch import faults as cli
    from repro_torch.pim.graph import graph_ref_results
    geom, _ = geoms
    monkeypatch.setattr(cli, "DRIM_R", geom)
    monkeypatch.setattr(cli, "K_BITS", 4)
    monkeypatch.setattr(cli, "CORNER", 0.30)
    assert cli.main(["--device", "cpu"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [line["scheme"] for line in lines] == ["none", "ecc", "tmr",
                                                  "tmr+ecc"]
    graph, _ = bnn_dot_graph_carrysave(4)
    feeds = cli.fault_feeds(graph, lines[0]["words"])
    oracle = graph_ref_results(graph, feeds)
    corner = FaultModel.from_corner(0.30, source="paper", seed=cli.SEED)
    for scheme, line in zip(cli.SCHEMES, lines):
        low = tcompile(graph, geom=geom).lower("cuda", harden=scheme)
        outs = low.run(feeds, device="cpu", faults=corner)
        assert line["aaps_per_tile"] == low.aaps
        assert line["corrupted_bits"] == cli.corrupted_bits(outs, oracle)
        assert line["ecc_mismatch_bits"] == (
            None if low.last_ecc is None else low.last_ecc.mismatch_bits)
    assert lines[0]["corrupted_bits"] > 0
    assert lines[1]["ecc_mismatch_bits"] > 0
    assert set(cli.EXPECTED) == set(cli.SCHEMES)


def test_op_thresholds_match_reference(jref):
    rng = np.random.default_rng(2)
    ref_prog = random_program(rng, jref.isa, 10, 50)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    kw = dict(p_dra=0.012, p_tra=0.999999999999, protected_ops=(1, 2, 30))
    want = jref.interp._op_thresholds(ref_prog,
                                      jref.faults.FaultModel(**kw))
    got = aap_interpreter._op_thresholds(prog, FaultModel(**kw))
    np.testing.assert_array_equal(got, want[:, 0])


def test_faulted_wrapper_checks_its_operands(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("wrapper fell back to the plain version")
    monkeypatch.setattr(aap_interpreter, "aap_interp_faulted_plain", boom)
    stream = torch.zeros(3, 19, dtype=torch.int32)
    thresh = torch.zeros(3, dtype=torch.int32)
    meta = torch.zeros(2, 40, dtype=torch.int32)
    tiles = torch.zeros(1, 2, 40, dtype=torch.int32)
    slots = torch.zeros(1, 2, dtype=torch.int32)
    stuck = torch.zeros(0, 2, dtype=torch.int32)
    call = aap_interpreter.aap_interp_faulted
    with pytest.raises(TypeError):
        call(stream, thresh.to(torch.int64), meta, tiles, slots, 5, stuck, 64)
    with pytest.raises(ValueError):
        call(stream, thresh[:2].contiguous(), meta, tiles, slots, 5, stuck,
             64)
    with pytest.raises(ValueError):
        call(stream, thresh, meta[:, :39].contiguous(), tiles, slots, 5,
             stuck, 64)
    with pytest.raises(ValueError, match="contiguous"):
        call(stream, thresh, meta, tiles.transpose(1, 2), slots, 5, stuck,
             64)
    with pytest.raises(ValueError):
        call(stream, thresh, meta, tiles, slots, 5, stuck, 0)
    with pytest.raises(ValueError):
        call(*(t.to("meta") for t in (stream, thresh, meta, tiles, slots)),
             5, stuck.to("meta"), 64)
    # a packed stream of another stream, read-back or operand count
    other = aap_interpreter.pack_stream(
        np.zeros((2, isa.KSTREAM_COLS), np.int32), [(0, 0)], 5, 2)
    with pytest.raises(ValueError, match="packed"):
        call(stream, thresh, meta, tiles, slots, 5, stuck, 64, packed=other)
    with pytest.raises(ValueError, match="packed"):
        call(stream[:2].contiguous(), thresh[:2].contiguous(), meta,
             tiles[:, :1].contiguous(), slots, 5, stuck, 64, packed=other)


# ---------------------------------------------------------------------------
# The packed faulted twin: stuck rows folded into the stream, the hash
# keyed by the program-order index
# ---------------------------------------------------------------------------

def _ref_faulted(jref, stream, meta, thresh, tiles, out_slots, n_state,
                 stuck, n_positions):
    """The reference's `_interp_kernel_faulted` in interpret mode over each
    wave of `tiles` [waves, n_in, cols] (one block of all the columns),
    as `pallas_wave_fn` calls it but with any stuck state rows, DCC
    cells included; [waves, n_out, cols] uint32."""
    import functools
    jnp, pl = jref.jnp, jref.pl
    waves, n_in, cols = tiles.shape
    n_ins, n_out = stream.shape[0], len(out_slots)
    kernel = functools.partial(
        jref.interp._interp_kernel_faulted, n_in, n_state,
        tuple(tuple(map(int, s)) for s in out_slots), n_positions,
        tuple(tuple(map(int, s)) for s in stuck))
    call = pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec((n_ins, isa.KSTREAM_COLS), lambda j: (0, 0)),
                  pl.BlockSpec((2, cols), lambda j: (0, 0)),
                  pl.BlockSpec((n_ins, 1), lambda j: (0, 0)),
                  pl.BlockSpec((n_in, cols), lambda j: (0, 0))],
        out_specs=pl.BlockSpec((n_out, cols), lambda j: (0, 0)),
        out_shape=jref.jnp.zeros((n_out, cols), jnp.uint32),
        interpret=True)
    args = (jnp.asarray(stream), jnp.asarray(u32(meta)),
            jnp.asarray(u32(thresh)[:, None]))
    return np.stack([np.asarray(call(*args, jnp.asarray(u32(tiles[v]))))
                     for v in range(waves)])


def _faulted_case(prog, n_rows, readback, waves, n_in, geom4, faults,
                  bank_lo, banks_total, rng, stuck=None):
    """CPU operands of `aap_interp_faulted` (`_kernel_operands`), with the
    stuck state rows `stuck` in place of the model's when given."""
    args = list(_kernel_operands(prog, n_rows, readback, waves, n_in, geom4,
                                 faults, bank_lo, banks_total, rng, "cpu"))
    if stuck is not None:
        args[6] = torch.tensor(stuck, dtype=torch.int32).reshape(-1, 2)
    return args


def _check_packed_twin(jref, args, *, moved_armed=False):
    """Both instruction orders of the pass: the packed twin (through the
    wrapper, as the "cuda" engine calls it on the CPU) equals the oracle
    `aap_interp_faulted_plain` and the reference's faulted kernel in
    interpret mode.  With `moved_armed`, demand order must put an armed
    instruction (nonzero threshold) at another position."""
    stream, thresh, meta, tiles, slots, n_state, stuck, n_pos = args
    want = aap_interpreter.aap_interp_faulted_plain(*args)
    np.testing.assert_array_equal(
        u32(want), _ref_faulted(jref, stream.numpy(), meta, thresh, tiles,
                                slots.tolist(), n_state, stuck.tolist(),
                                n_pos))
    for demand in (False, True):
        packed = aap_interpreter._pack(stream.numpy(), slots.tolist(),
                                       n_state, tiles.shape[1], demand,
                                       stuck.tolist())
        assert sorted(packed.order) == list(range(stream.shape[0]))
        got = aap_interpreter.aap_interp_faulted(*args, packed=packed)
        assert torch.equal(got, want), demand
        if demand and moved_armed:
            ts = thresh.numpy()[packed.order]
            assert ((packed.order != np.arange(len(ts))) & (ts != 0)).any()
    assert not torch.equal(want, aap_interpreter.aap_interp_plain(
        stream, tiles, slots, n_state)), "no flip reached the outputs"


@pytest.mark.parametrize("stuck", [
    ((2, 1), (17, 0), (21, 1)),     # an operand row, a result row, a DCC cell
    ((20, 0), (3, 1), (3, 0)),      # the other DCC cell; a row pinned twice
])
def test_packed_faulted_twin_on_the_ragged_soup(jref, stuck):
    """The chip phase's ragged soup (DCC aliases, a bank offset, protected
    ops, 9-word rows) with stuck operand, result and DCC rows, over three
    waves, in program and in demand order (which moves armed ops)."""
    rng = np.random.default_rng(13)
    n_rows = 20
    prog = random_program(rng, isa, n_rows, 300)
    faults = FaultModel(p_dra=0.3, p_tra=0.4, seed=5,
                        protected_ops=tuple(range(0, 300, 7)))
    args = _faulted_case(prog, n_rows, tuple(range(n_rows + 4)), 3, 6,
                         (1, 3, 5, 9), faults, 2, 8, rng, stuck)
    _check_packed_twin(jref, args, moved_armed=True)
    got = aap_interpreter.aap_interp_faulted(
        *args, packed=aap_interpreter.pack_stream(
            args[0].numpy(), args[4].tolist(), args[5], 6, args[6].tolist()))
    for row, bit in dict(stuck).items():        # read back as the pin
        if row < n_rows:
            assert (got[:, row] == -bit).all()


@pytest.mark.parametrize("harden", ["tmr", "ecc", "tmr+ecc"])
def test_packed_faulted_twin_on_hardened_streams(jref, harden):
    """The K=32 carry-save dot hardened, at the paper's +-15% corner with
    the lowering's protected voter/parity spans, over two waves of a small
    fleet slice, in program and in demand order.  Every word-line is read
    back (the outputs' votes would hide most flips)."""
    graph, _ = bnn_dot_graph_carrysave(32)
    low = tcompile(graph, geom=DRIM_R).lower("cuda", harden=harden)
    faults = low._resolve_faults(FaultModel.from_corner(0.15,
                                                        source="paper"))
    fp = low.fp
    readback = tuple(range(fp.template_rows + 4))
    args = _faulted_case(fp.program, fp.template_rows, readback, 2,
                         len(fp.loaded_inputs), (1, 2, 16, 4), faults, 0,
                         None, np.random.default_rng(len(harden)))
    _check_packed_twin(jref, args)


def test_stuck_rows_fold_into_the_packed_words():
    """What the pass makes of stuck rows: no copy of a stuck staged row, no
    write to one (the sink), reads of slot 0 complemented by the bit, and
    an output read back as the pin."""
    n_rows, n_in = 6, 3
    prog = (isa.AAP(isa.OP_DRA, (0, 1, 4)),      # reads stuck row 0
            isa.AAP(isa.OP_COPY, (4, 2)),        # writes stuck row 2
            isa.AAP(isa.OP_TRA, (2, 4, 1, 5)))
    stream = isa.encode_kernel_stream(prog, n_rows=n_rows)
    slots = [(r, 0) for r in (0, 2, 4, 5)] + [(2, 1)]
    n_state = isa.dcc_state_rows(n_rows)
    free = aap_interpreter._pack(stream, slots, n_state, n_in, False)
    packed = aap_interpreter._pack(stream, slots, n_state, n_in, False,
                                   ((0, 1), (2, 0)))
    assert packed.stuck == ((0, 1), (2, 0))
    staged = {int(e) & 0xFFFF for e in packed.loads[:len(packed.loads) - 4]
              .view(np.uint32)}
    assert staged == {1} and {0, 1} <= {
        int(e) & 0xFFFF for e in free.loads[:len(free.loads) - 4]}
    fields = packed.words[:3].view(np.uint32)
    flags = fields[:, 3] >> 16
    assert fields[0, 0] & 0xFFFF == 0 and flags[0] >> 2 & 1 == 1   # ~0
    assert fields[1, 1] >> 16 == 1                                  # sink
    assert fields[2, 0] & 0xFFFF == 0 and flags[2] >> 2 & 1 == 0    # 0
    assert packed.out_map.tolist()[:2] == [[0, 1], [0, 0]]
    assert packed.out_map.tolist()[4] == [0, 1]
    tiles = torch.from_numpy(np.random.default_rng(0).integers(
        -2 ** 31, 2 ** 31, (2, n_in, 5), dtype=np.int32))
    want = aap_interpreter._replay(
        torch.from_numpy(stream), tiles, torch.tensor(slots), n_state,
        pins=((0, 1), (2, 0)))
    assert torch.equal(aap_interpreter.aap_interp_packed_plain(packed, tiles),
                       want)


# ---------------------------------------------------------------------------
# On the card: the faulted kernel against its plain version
# ---------------------------------------------------------------------------

def _kernel_operands(prog, n_rows, readback, waves, n_in, geom4, faults,
                     bank_lo, banks_total, rng, device):
    c, b, s, w = geom4
    stream = torch.from_numpy(isa.encode_kernel_stream(
        prog, n_rows=n_rows)).to(device)
    thresh = torch.from_numpy(aap_interpreter._op_thresholds(
        prog, faults).view(np.int32)).to(device)
    meta = aap_interpreter.column_meta(c, b, s, w, seed=faults.seed,
                                       bank_lo=bank_lo,
                                       banks_total=banks_total,
                                       device=device)
    slots = torch.tensor([isa.kstream_slot(r, n_rows) for r in readback],
                         dtype=torch.int32, device=device)
    stuck = torch.tensor(faults.stuck_rows, dtype=torch.int32,
                         device=device).reshape(-1, 2)
    tiles = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          (waves, n_in, c * b * s * w),
                                          dtype=np.int32)).to(device)
    return (stream, thresh, meta, tiles, slots, isa.dcc_state_rows(n_rows),
            stuck, 32 * w)


@pytest.mark.cuda
@pytest.mark.parametrize("geom4,order", [
    ((1, 3, 37, 9), None),          # 999 columns: 1 word a thread
    ((1, 3, 37, 9), "demand"),
    ((1, 2, 4, 9), "program"),      # 72 columns: 4 words straddle rows
    ((1, 2, 8, 4), "demand"),       # 4 words of one sub-array: one draw
])
def test_faulted_kernel_equals_plain_ragged(cuda, geom4, order):
    """A random soup over every word-line, DCC aliases included, with stuck
    rows (an operand row, a result row, a DCC cell), protected ops and a
    bank offset, over three waves: the kernel against the oracle and the
    packed twin, packed by the wrapper or in a given order."""
    rng = np.random.default_rng(13)
    n_rows = 20
    prog = random_program(rng, isa, n_rows, 300)
    faults = FaultModel(p_dra=0.3, p_tra=0.4, seed=5,
                        stuck_rows=((2, 1), (17, 0)),
                        protected_ops=tuple(range(0, 300, 7)))
    args = list(_kernel_operands(prog, n_rows, tuple(range(n_rows + 4)), 3,
                                 6, geom4, faults, 2, 8, rng, cuda))
    args[6] = torch.tensor([(2, 1), (17, 0), (21, 1)], dtype=torch.int32,
                           device=cuda)
    packed = None if order is None else aap_interpreter._pack(
        args[0].cpu().numpy(), args[4].tolist(), args[5], 6,
        order == "demand", args[6].tolist())
    before = aap_interpreter.aap_interp_faulted.launches
    got = aap_interpreter.aap_interp_faulted(*args, packed=packed)
    torch.cuda.synchronize()
    assert aap_interpreter.aap_interp_faulted.launches == before + 1
    assert torch.equal(got, aap_interpreter.aap_interp_faulted_plain(*args))
    if packed is not None:
        assert torch.equal(got, aap_interpreter.aap_interp_packed_plain(
            packed, args[3], *args[1:3], args[7]))
    assert (got[:, 2] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("waves,stuck", [
    (4, None),                              # the faults phase's payload
    (1, ((0, 1), (100, 0), (257, 1))),      # operand, work and DCC rows
])
def test_faulted_kernel_equals_plain_tmr_full_width(cuda, waves, stuck):
    """The TMR-hardened K=128 serving dot at the Table-3 +-15% corner over
    DRIM-R waves of 65,536 word columns: the faults phase's 4 waves, and
    one wave with stuck rows."""
    graph, _ = bnn_dot_graph_carrysave(128)
    low = tcompile(graph, geom=DRIM_R).lower("cuda", harden="tmr")
    faults = low._resolve_faults(FaultModel.from_corner(0.15,
                                                        source="paper"))
    fp = low.fp
    geom4 = (DRIM_R.chips, DRIM_R.banks, DRIM_R.subarrays_per_bank,
             DRIM_R.row_bits // 32)
    args = list(_kernel_operands(
        fp.program, fp.template_rows, fp.readback_rows, waves,
        len(fp.loaded_inputs), geom4, faults, 0, None,
        np.random.default_rng(14), cuda))
    if stuck is not None:
        args[6] = torch.tensor(stuck, dtype=torch.int32, device=cuda)
    packed = aap_interpreter.pack_stream(
        args[0].cpu().numpy(), args[4].tolist(), args[5], args[3].shape[1],
        args[6].tolist())
    got = aap_interpreter.aap_interp_faulted(*args, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(got, aap_interpreter.aap_interp_faulted_plain(*args))


@pytest.mark.cuda
def test_faulted_engine_on_the_card(cuda):
    """The "cuda" engine under faults on the card: one launch of the
    faulted kernel per run, the same words as the plain replay on the
    CPU; an inactive model launches the fault-free kernel."""
    geom = DrimGeometry(chips=1, banks=2, subarrays_per_bank=4, row_bits=64)
    graph, _ = bnn_dot_graph_carrysave(4)
    rng = np.random.default_rng(15)
    n_words = 3 * geom.n_subarrays * 2 + 1
    feeds = {n: (np.zeros(n_words, np.uint32) if n == "zero"
                 else rng.integers(0, 1 << 32, n_words, dtype=np.uint32))
             for n in graph.input_names}
    low = tcompile(graph, geom=geom).lower("cuda", harden="ecc")
    hot = FaultModel(**HOT)
    faulted = aap_interpreter.aap_interp_faulted.launches
    clean = aap_interpreter.aap_interp.launches
    got = low.run(feeds, device=cuda, faults=hot)
    ecc = low.last_ecc
    assert aap_interpreter.aap_interp_faulted.launches == faulted + 1
    want = low.run(feeds, device="cpu", faults=hot)
    assert low.last_ecc == ecc and ecc.corrupted
    for name in want:
        assert torch.equal(got[name].cpu(), want[name])
    low.run(feeds, device=cuda, faults=FaultModel(dead_queues=(1,)))
    assert aap_interpreter.aap_interp.launches == clean + 1
    assert aap_interpreter.aap_interp_faulted.launches == faulted + 1
    assert low.last_ecc.mismatch_bits == 0
