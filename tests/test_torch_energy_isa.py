"""The port's Fig. 9 energy model (`repro_torch.core.energy`), the Table-1
enable bits and the N-bit ripple adder (`repro_torch.core.isa`), held to
the reference (`repro.core.energy`, `repro.core.isa`): equal tables and
claims, identical programs, and adds equal to integer addition, through
`run_program_py` and through the AAP interpreter (its plain version and
its packed twin on the CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as core
from repro.core import energy as ref_energy
from repro.core import isa as ref_isa
from repro.core import subarray as ref_subarray
from repro_torch.core import energy, isa, subarray
from repro_torch.kernels import aap_interpreter

OPS = ("not", "xnor2", "add")


def test_energy_table_equals_reference():
    assert energy.energy_table() == ref_energy.energy_table()
    for plat in ("DRIM", "Ambit", "DRISA-1T1C"):
        for op in OPS:
            assert energy.pim_energy_nj_per_kb(plat, op) == \
                ref_energy.pim_energy_nj_per_kb(plat, op)
    for op in OPS:
        assert energy.cpu_energy_nj_per_kb(op) == \
            ref_energy.cpu_energy_nj_per_kb(op)
    assert energy.ddr4_copy_energy_nj_per_kb() == \
        ref_energy.ddr4_copy_energy_nj_per_kb() == 328.0


def test_paper_energy_claims_and_ratios_equal_reference():
    """The claims, and the model's ratio for each, as
    benchmarks/fig9_energy.py forms them."""
    assert energy.PAPER_ENERGY_CLAIMS == ref_energy.PAPER_ENERGY_CLAIMS
    table, ref_table = energy.energy_table(), ref_energy.energy_table()
    for (plat, base, op), paper in energy.PAPER_ENERGY_CLAIMS.items():
        num = "copy" if plat == "DDR4-copy" else op
        got = table[plat][num] / table[base][op]
        assert got == ref_table[plat][num] / ref_table[base][op]
        assert 0.5 * paper < got < 2.0 * paper


def test_enable_bits_equal_reference():
    assert isa.ENABLE_BITS == ref_isa.ENABLE_BITS
    assert isa.ENABLE_BITS[isa.OP_DRA] == dict(En_M=0, En_x=1, En_C=1)


@pytest.mark.parametrize("nbits", [1, 4, 32])
def test_multibit_add_program_identical_to_reference(nbits):
    sa = subarray.make_subarray(n_data=4 * nbits + 1, row_bits=32)
    ref_sa = ref_subarray.make_subarray(n_data=4 * nbits + 1, row_bits=32)
    rows = (range(nbits), range(nbits, 2 * nbits), 2 * nbits,
            range(2 * nbits + 1, 3 * nbits + 1),
            range(3 * nbits + 1, 4 * nbits + 1))
    got = isa.multibit_add_program(sa, *rows)
    want = ref_isa.multibit_add_program(ref_sa, *rows)
    assert [(i.op, i.args) for i in got] == [(i.op, i.args) for i in want]
    assert isa.cost(got)[0] == 7 * nbits
    with pytest.raises(ValueError, match="equal length"):
        isa.multibit_add_program(sa, rows[0], rows[1][1:], *rows[2:])


def test_multibit_ripple_add_matches_integer_add():
    """tests/test_isa.py:126 through the port: a 4-bit ripple-carry add
    over bit-plane rows equals integer addition, carry out included."""
    template = subarray.make_subarray(n_data=20, row_bits=256)
    n_el = template.words * 32
    rng = np.random.default_rng(3)
    a = rng.integers(0, 16, n_el).astype(np.uint32)
    b = rng.integers(0, 16, n_el).astype(np.uint32)

    def plane_rows(x):
        return torch.stack([subarray.pack_bits(torch.from_numpy(
            ((x >> i) & 1).astype(np.int32))) for i in range(4)])

    sa = subarray.load_rows(template, 0, plane_rows(a))
    sa = subarray.load_rows(sa, 4, plane_rows(b))
    prog = isa.multibit_add_program(sa, [0, 1, 2, 3], [4, 5, 6, 7], 8,
                                    [9, 10, 11, 12], [13, 14, 15, 16])
    assert isa.cost(prog)[0] == 4 * 7
    out = isa.run_program_py(sa, prog)
    s_bits = np.stack([subarray.unpack_bits(out.data[9 + i]).numpy()
                       for i in range(4)]).astype(np.uint32)
    c_out = subarray.unpack_bits(out.data[16]).numpy().astype(np.uint32)
    got = sum(s_bits[i] << i for i in range(4)) + (c_out << 4)
    np.testing.assert_array_equal(got, a + b)
    # the reference's interpreter on the same program and rows
    ref_sa = ref_subarray.load_rows(
        ref_subarray.make_subarray(n_data=20, row_bits=256), 0,
        jnp.asarray(sa.data[:8].numpy().view(np.uint32)))
    ref_out = ref_isa.run_program_py(ref_sa, [ref_isa.AAP(i.op, i.args)
                                              for i in prog])
    np.testing.assert_array_equal(out.data.numpy().view(np.uint32),
                                  np.asarray(ref_out.data))


def test_multibit_add_on_the_interpreter():
    """The 32-bit adder's stream on the AAP interpreter (as the chip's
    analog phase runs it over a DRIM-R wave; here 3 waves of 40 word
    columns): the plain replay and the packed twin equal a + b."""
    nbits, cols, waves = 32, 40, 3
    sa = subarray.make_subarray(n_data=4 * nbits + 1, row_bits=32)
    sum_rows = range(2 * nbits + 1, 3 * nbits + 1)
    carry_rows = range(3 * nbits + 1, 4 * nbits + 1)
    prog = isa.multibit_add_program(sa, range(nbits), range(nbits, 2 * nbits),
                                    2 * nbits, sum_rows, carry_rows)
    stream_np = isa.encode_kernel_stream(prog, n_rows=sa.n_rows)
    slot_list = [isa.kstream_slot(r, sa.n_rows)
                 for r in (*sum_rows, carry_rows[-1])]
    n_state = isa.dcc_state_rows(sa.n_rows)
    rng = np.random.default_rng(7)
    a, b = (rng.integers(0, 1 << 32, (waves, cols * 32), dtype=np.uint64)
            for _ in range(2))
    shifts = np.arange(32, dtype=np.uint64)

    def planes(x):                    # [waves, nbits, cols] words
        bits = (x[:, None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) \
            & np.uint64(1)
        return (bits.reshape(waves, nbits, cols, 32) << shifts).sum(-1) \
            .astype(np.uint32)

    tiles = torch.from_numpy(np.concatenate([planes(a), planes(b)], 1)
                             .view(np.int32))
    stream = torch.from_numpy(stream_np)
    slots = torch.tensor(slot_list, dtype=torch.int32)
    packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state,
                                         2 * nbits)
    for out in (aap_interpreter.aap_interp(stream, tiles, slots, n_state),
                aap_interpreter.aap_interp(stream, tiles, slots, n_state,
                                           packed=packed)):
        words = out.numpy().view(np.uint32).astype(np.uint64)
        bits = (words[..., None] >> shifts) & np.uint64(1)  # [w, 33, c, 32]
        got = (bits.reshape(waves, nbits + 1, cols * 32)
               << np.arange(nbits + 1, dtype=np.uint64)[:, None]).sum(1)
        np.testing.assert_array_equal(got, a + b)


def test_core_exports_the_ported_names():
    for name in ("energy_table", "pim_energy_nj_per_kb",
                 "cpu_energy_nj_per_kb", "ddr4_copy_energy_nj_per_kb",
                 "PAPER_ENERGY_CLAIMS", "ENABLE_BITS", "multibit_add_program",
                 "AnalogParams", "dra_analog", "tra_analog",
                 "monte_carlo_error_rates", "PAPER_TABLE3"):
        assert hasattr(core, name), name
