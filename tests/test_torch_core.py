"""The port's core (sub-array template, AAP ISA, geometry, energy) held
against the JAX reference: Table-2 microprograms AAP-tuple-identical,
`encode` / `encode_kernel_stream` tables array-equal, and random programs
replayed by `run_program_unrolled` word-equal, DCC cells included.
Integer results must be exactly equal."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import isa as ref_isa
from repro.core import subarray as ref_sa
from repro.core import energy as ref_energy
from repro.core import timing as ref_timing
from repro_torch.core import energy, isa, subarray, timing


def tuples(program):
    return [(ins.op, tuple(ins.args)) for ins in program]


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def random_program(rng, mod, n_rows, n_ins):
    """A random AAP soup over every word-line, the four DCC aliases
    included, built with `mod.AAP`."""
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    ops = [int(rng.integers(0, 4)) for _ in range(n_ins)]
    args = [tuple(int(rng.integers(0, n_rows + 4)) for _ in range(arity[op]))
            for op in ops]
    return tuple(mod.AAP(op, a) for op, a in zip(ops, args))


def test_constants_and_geometry_match_reference():
    assert (subarray.WORD_BITS, subarray.N_XROWS, subarray.N_DCC_WL) == \
        (ref_sa.WORD_BITS, ref_sa.N_XROWS, ref_sa.N_DCC_WL)
    assert (isa.OP_COPY, isa.OP_COPY2, isa.OP_DRA, isa.OP_TRA) == \
        (ref_isa.OP_COPY, ref_isa.OP_COPY2, ref_isa.OP_DRA, ref_isa.OP_TRA)
    assert isa.KSTREAM_COLS == ref_isa.KSTREAM_COLS
    assert isa.AAP_COUNTS == ref_isa.AAP_COUNTS
    for name in ("DRIM_R", "DRIM_S"):
        assert dataclasses.asdict(getattr(timing, name)) == \
            dataclasses.asdict(getattr(ref_timing, name))
    assert timing.DRIM_R.parallel_bits == ref_timing.DRIM_R.parallel_bits
    assert timing.T_AAP_S == ref_timing.T_AAP_S
    assert timing.ddr_rows_s(123, 256) == ref_timing.ddr_rows_s(123, 256)
    for name in ("E_AAP_NJ_PER_KB", "E_ACCESS_NJ_PER_KB", "E_IO_NJ_PER_KB"):
        assert getattr(energy, name) == getattr(ref_energy, name)
    assert subarray.row_words(256) == ref_sa.row_words(256)
    with pytest.raises(ValueError):
        subarray.row_words(100)


@pytest.mark.parametrize("n_data", [1, 8, 37, 500])
def test_microprograms_tuple_identical(n_data):
    sa = subarray.make_subarray(n_data=n_data, row_bits=32)
    ref = ref_sa.make_subarray(n_data=n_data, row_bits=32)
    assert (sa.n_rows, sa.wl_x(1), sa.wl_dcc(4)) == \
        (ref.n_rows, ref.wl_x(1), ref.wl_dcc(4))
    a, b, c, d, e = 0, 1, 2, n_data - 1, max(n_data - 2, 0)
    cases = [("copy", (a, d)), ("not", (a, d)), ("xnor2", (a, b, d)),
             ("xor2", (a, b, d)), ("maj3", (a, b, c, d)),
             ("min3", (a, b, c, d)), ("and2", (a, b, c, d)),
             ("or2", (a, b, c, d)), ("add", (a, b, c, d, e))]
    for name, args in cases:
        got = getattr(isa, f"microprogram_{name}")(sa, *args)
        want = getattr(ref_isa, f"microprogram_{name}")(ref, *args)
        assert tuples(got) == tuples(want), name
        assert isa.cost(got)[0] == ref_isa.cost(want)[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoders_array_equal(seed):
    rng = np.random.default_rng(seed)
    n_rows = int(rng.integers(4, 40))
    ref_prog = random_program(rng, ref_isa, n_rows, 60)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    np.testing.assert_array_equal(isa.encode(prog).numpy(),
                                  np.asarray(ref_isa.encode(ref_prog)))
    np.testing.assert_array_equal(
        isa.encode_kernel_stream(prog, n_rows=n_rows),
        ref_isa.encode_kernel_stream(ref_prog, n_rows=n_rows))
    for wl in range(n_rows + 4):
        assert isa.kstream_slot(wl, n_rows) == ref_isa.kstream_slot(wl, n_rows)
    assert isa.dcc_state_rows(n_rows) == ref_isa.dcc_state_rows(n_rows)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_run_program_unrolled_word_equal(seed):
    """A random program over random rows: every data row and both DCC
    cells equal the reference's words."""
    rng = np.random.default_rng(seed)
    n_rows, n_in = 12, 5
    ref_prog = random_program(rng, ref_isa, n_rows, 80)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    tiles = rng.integers(0, 2 ** 32, (n_in, 3, 7), dtype=np.uint32)

    zeros_j = jnp.zeros(tiles.shape[1:], jnp.uint32)
    rows_j, dcc_j = ref_isa.run_program_unrolled(
        ref_prog, {i: jnp.asarray(tiles[i]) for i in range(n_in)}, {},
        n_rows=n_rows, zeros=zeros_j)
    t = torch.from_numpy(tiles.view(np.int32))
    zeros_t = torch.zeros(tiles.shape[1:], dtype=torch.int32)
    rows_t, dcc_t = isa.run_program_unrolled(
        prog, {i: t[i] for i in range(n_in)}, {}, n_rows=n_rows,
        zeros=zeros_t)
    for wl in range(n_rows):
        np.testing.assert_array_equal(
            u32(rows_t.get(wl, zeros_t)),
            np.asarray(rows_j.get(wl, zeros_j)), err_msg=f"row {wl}")
    for cell in (0, 1):
        np.testing.assert_array_equal(
            u32(dcc_t.get(cell, zeros_t)),
            np.asarray(dcc_j.get(cell, zeros_j)), err_msg=f"dcc {cell}")


def test_pack_bits_round_trip_matches_reference():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (3, 96)).astype(np.uint32)
    want = np.asarray(ref_sa.pack_bits(jnp.asarray(bits)))
    got = subarray.pack_bits(torch.from_numpy(bits.astype(np.int32)))
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(subarray.unpack_bits(got).numpy(),
                                  np.asarray(ref_sa.unpack_bits(want)))
    with pytest.raises(ValueError):
        subarray.pack_bits(torch.zeros(3, 33))


def test_as_words_keeps_the_32_low_bits():
    words = np.array([0, 1, 2 ** 31, 2 ** 32 - 1], np.uint32)
    for x in (words, words.astype(np.int64), torch.from_numpy(
            words.astype(np.int64)), list(words)):
        np.testing.assert_array_equal(u32(subarray.as_words(x, "cpu")),
                                      words)
    with pytest.raises(TypeError):
        subarray.as_words(np.zeros(3, np.float32), "cpu")
