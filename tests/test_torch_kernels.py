"""The port's three kernel modules held against the JAX reference's Pallas
kernels (interpret mode) and oracles, one block per module.  On the CPU
each wrapper runs its kernel's plain torch version; the tests marked
`cuda` hold the CUDA kernel against that plain version on the card and
skip without one.  Integer results must be exactly equal.

The reference is imported by the `jref` fixture, not at module level, so
that the `cuda` tests also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_kernels.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import DrimGeometry, isa
from repro_torch.kernels import aap_interpreter, ops, packbits, ref, \
    xnor_popcount
from repro_torch.pim import compiler, scheduler


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.fixture(scope="module")
def jref():
    """The JAX reference: Pallas kernels, oracles and pipeline."""
    import jax.numpy as jnp

    import drim
    from repro.core import isa as ref_isa
    from repro.kernels import aap_interpreter, packbits, ref, xnor_popcount
    return types.SimpleNamespace(
        jnp=jnp, drim=drim, isa=ref_isa, interp=aap_interpreter,
        packbits=packbits, oracles=ref, xnor=xnor_popcount)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def sign_input(rng, rows, k):
    x = rng.standard_normal((rows, k)).astype(np.float32)
    x[0, :4] = [-0.0, np.nan, 0.0, -1e-30]      # -0.0 >= 0; NaN packs to 0
    return x


# ---------------------------------------------------------------------------
# packbits: sign packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,k,dtype", [
    (300, 700, torch.float32), (300, 700, torch.bfloat16),
    (5, 64, torch.float32), (257, 33, torch.bfloat16)])
def test_pack_plain_equals_pallas(jref, rows, k, dtype):
    x = sign_input(np.random.default_rng(rows + k), rows, k)
    xt = torch.from_numpy(x).to(dtype)
    want = np.asarray(jref.packbits.pack_signs(
        jref.jnp.asarray(xt.to(torch.float32).numpy()), interpret=True))
    got = packbits.pack_signs(xt)
    assert got.shape == (rows, -(-k // 32)) and got.dtype == torch.int32
    np.testing.assert_array_equal(u32(got), want)
    np.testing.assert_array_equal(u32(ops.pack_signs(xt.reshape(
        1, rows, k))[0]), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype", [
    (512, 768, torch.float32), (300, 700, torch.bfloat16)])
def test_pack_kernel_equals_plain(cuda, rows, k, dtype):
    x = torch.from_numpy(sign_input(np.random.default_rng(1), rows, k))
    x = x.to(cuda, dtype)
    before = packbits.pack_signs.launches
    got = packbits.pack_signs(x)
    torch.cuda.synchronize()
    assert packbits.pack_signs.launches == before + 1
    assert torch.equal(got, packbits.pack_signs_plain(x))


# ---------------------------------------------------------------------------
# xnor_popcount: binary GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(100, 77, 700), (3, 5, 32), (17, 9, 1)])
def test_gemm_plain_equals_pallas_and_ref(jref, m, n, k):
    rng = np.random.default_rng(m * n + k)
    a_x = rng.standard_normal((m, k)).astype(np.float32)
    b_x = rng.standard_normal((n, k)).astype(np.float32)
    a = ops.pack_signs(torch.from_numpy(a_x))
    b = ops.pack_signs(torch.from_numpy(b_x))
    got = xnor_popcount.xnor_gemm_packed(a, b, k)
    jnp = jref.jnp
    want = np.asarray(jref.xnor.xnor_gemm_packed(
        jnp.asarray(u32(a)), jnp.asarray(u32(b)), k, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.oracles.xnor_gemm_dense_ref(jnp.asarray(a_x),
                                         jnp.asarray(b_x))))
    np.testing.assert_array_equal(ops.binary_matmul(
        torch.from_numpy(a_x), b, k, dtype=torch.int32).numpy(), want)

    # Garbage in the pad bits of the last word never reaches the count.
    noisy_a = a | ~ref.pack_signs_ref(torch.nn.functional.pad(
        torch.ones(k), (0, -k % 32), value=-1.0))
    np.testing.assert_array_equal(
        xnor_popcount.xnor_gemm_packed(noisy_a, b, k).numpy(),
        np.asarray(jref.oracles.xnor_gemm_ref(
            jnp.asarray(u32(noisy_a)), jnp.asarray(u32(b)), k)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(512, 3072, 768), (100, 77, 700)])
def test_gemm_kernel_equals_plain(cuda, m, n, k):
    rng = np.random.default_rng(k)
    w = -(-k // 32)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (m, w),
                                      dtype=np.int32)).to(cuda)
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, w),
                                      dtype=np.int32)).to(cuda)
    got = xnor_popcount.xnor_gemm_packed(a, b, k)
    torch.cuda.synchronize()
    assert torch.equal(got, xnor_popcount.xnor_gemm_plain(a, b, k))


# ---------------------------------------------------------------------------
# aap_interpreter: the engine "cuda" kernel
# ---------------------------------------------------------------------------

def random_program(rng, mod, n_rows, n_ins):
    arity = {0: 2, 1: 3, 2: 3, 3: 4}
    ops_ = [int(rng.integers(0, 4)) for _ in range(n_ins)]
    return tuple(mod.AAP(op, tuple(int(rng.integers(0, n_rows + 4))
                                   for _ in range(arity[op])))
                 for op in ops_)


@pytest.mark.parametrize("trial", range(4))
def test_interp_plain_equals_pallas(jref, trial):
    """Raw stream replay, DCC cells and complemented read-back included:
    the port's plain replay equals `pallas_wave_fn(interpret=True)`."""
    rng = np.random.default_rng(42 + trial)
    n_rows, n_in = 10, 4
    readback = tuple(range(n_rows + 4))
    ref_prog = random_program(rng, jref.isa, n_rows, 1 + 7 * trial)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    tiles = rng.integers(0, 2 ** 32, (n_in, 2, 3, 6), dtype=np.uint32)
    want = np.asarray(jref.interp.pallas_wave_fn(
        ref_prog, readback, n_rows, interpret=True)(jref.jnp.asarray(tiles)))
    got = aap_interpreter.cuda_wave_fn(prog, readback, n_rows)(
        words(tiles)[None])
    np.testing.assert_array_equal(u32(got[0]), want)


def test_interp_empty_program_reads_back_staged_rows(jref):
    tiles = np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 1, 3, 4)
    readback = (0, 1, 5, 10, 11)                # rows, untouched rows, DCC
    want = np.asarray(jref.interp.pallas_wave_fn(
        (), readback, 10, interpret=True)(jref.jnp.asarray(tiles)))
    got = aap_interpreter.cuda_wave_fn((), readback, 10)(words(tiles)[None])
    np.testing.assert_array_equal(u32(got[0]), want)


@pytest.mark.parametrize("op", ["add", "xor2", "not", "maj3"])
def test_cuda_engine_equals_pallas_and_resident(jref, op, small_geom):
    """Engine "cuda" (plain replay on CPU tensors) against the reference's
    "pallas" and "resident" engines on a ragged multi-wave payload."""
    geom = DrimGeometry(**dataclasses.asdict(small_geom))
    row_w = geom.row_bits // 32
    n_words = 2 * geom.n_subarrays * row_w + 3
    args = scheduler.random_operands(op, n_words, seed=len(op) + 1)
    got = compiler.compile(op, geom=geom).lower(engine="cuda").run(
        *args, device="cpu")
    for engine in ("pallas", "resident"):
        want = jref.drim.compile(op, geom=small_geom).lower(
            engine=engine).run(
            *args)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(u32(g), np.asarray(w))


def test_interp_rejects_addresses_outside_the_template():
    with pytest.raises(ValueError, match="outside"):
        aap_interpreter.cuda_wave_fn((isa.AAP(isa.OP_COPY, (0, 14)),),
                                     (1,), 10)
    with pytest.raises(ValueError, match="outside"):
        aap_interpreter.cuda_wave_fn((isa.AAP(isa.OP_COPY, (0, 1)),),
                                     (15,), 10)


def test_block_cols_fit_shared_memory():
    assert aap_interpreter.block_cols(267) == 192      # K=128 serving kernel
    assert aap_interpreter.block_cols(510) == 96       # the 500-row budget
    for n_state in (3, 267, 510, 1816):
        c = aap_interpreter.block_cols(n_state)
        assert c % 32 == 0 and 4 * n_state * c <= aap_interpreter.SMEM_BYTES
    with pytest.raises(ValueError):
        aap_interpreter.block_cols(2000)


@pytest.mark.cuda
def test_interp_kernel_equals_plain(cuda):
    rng = np.random.default_rng(5)
    n_rows = 20
    prog = random_program(rng, isa, n_rows, 300)
    stream = torch.from_numpy(isa.encode_kernel_stream(
        prog, n_rows=n_rows)).to(cuda)
    slots = torch.tensor([isa.kstream_slot(r, n_rows)
                          for r in range(n_rows + 4)],
                         dtype=torch.int32, device=cuda)
    tiles = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, 6, 1000),
                                          dtype=np.int32)).to(cuda)
    n_state = isa.dcc_state_rows(n_rows)
    got = aap_interpreter.aap_interp(stream, tiles, slots, n_state)
    torch.cuda.synchronize()
    assert torch.equal(got, aap_interpreter.aap_interp_plain(
        stream, tiles, slots, n_state))


@pytest.mark.cuda
def test_cuda_engine_on_the_card(cuda):
    """The whole "cuda" engine path on the card: staging, the interpreter
    kernel over several waves, decoding; dots equal the numpy ±1 product."""
    from repro_torch.pim.bnn import bnn_dot_drim, serve_bnn_matmul
    geom = DrimGeometry(chips=1, banks=2, subarrays_per_bank=4, row_bits=64)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2, (37, 150)).astype(np.uint8)
    b = rng.integers(0, 2, (29, 150)).astype(np.uint8)
    want = (2 * a.astype(np.int64) - 1) @ (2 * b.astype(np.int64) - 1).T
    before = aap_interpreter.aap_interp.launches
    got = serve_bnn_matmul(a, b, engine="cuda", geom=geom, k_tile=64,
                           device=cuda)
    assert aap_interpreter.aap_interp.launches == before + 3
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    got, sched = bnn_dot_drim(a[:, :20], b[:, :20], geom=geom,
                              accumulate="carrysave", engine="cuda",
                              device=cuda)
    assert sched.waves > 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        (2 * a[:, :20].astype(np.int64) - 1) @ (2 * b[:, :20].astype(np.int64) - 1).T)
