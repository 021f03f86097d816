"""The port's bulk bit-wise kernels -- `bitwise` (not, the binary and the
ternary ops), `bitplane_add` and `unpack_signs` -- held against the JAX
reference's Pallas kernels in interpret mode, as `tests/test_kernels.py`
runs them.  On the CPU each wrapper runs its kernel's plain torch
version; the tests marked `cuda` hold each CUDA kernel against that plain
version on the card (ragged lengths, a misaligned start, empty tensors)
and skip without one.  Inputs come from seeded numpy generators; every
comparison is exact (tolerance 0).

The reference is imported by the `jref` fixture, so that the `cuda` tests
also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_bitwise.py
"""
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitserial_add, ops, packbits

# `repro_torch.kernels.bitwise` is the dispatch function, as in the
# reference; the module is taken from the import system.
bitwise = importlib.import_module("repro_torch.kernels.bitwise")

OPS = bitwise.UNARY_OPS + bitwise.BINARY_OPS + bitwise.TERNARY_OPS
ARITY = {**{op: 1 for op in bitwise.UNARY_OPS},
         **{op: 2 for op in bitwise.BINARY_OPS},
         **{op: 3 for op in bitwise.TERNARY_OPS}}
EDGE = np.array([0, 0xFFFFFFFF, 0x80000000], np.uint32)


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def words(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def rand_words(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.fixture(scope="module")
def jref():
    """The JAX reference's Pallas kernels (run in interpret mode)."""
    import jax.numpy as jnp

    from repro.kernels.bitserial_add import bitplane_add
    from repro.kernels.bitwise import bitwise as ref_bitwise
    from repro.kernels.packbits import unpack_signs
    return types.SimpleNamespace(jnp=jnp, bitwise=ref_bitwise,
                                 add=bitplane_add, unpack=unpack_signs)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# bitwise: not, binary, ternary
# ---------------------------------------------------------------------------

def test_the_op_table_is_the_reference_table():
    ref_bitwise = importlib.import_module("repro.kernels.bitwise")
    assert bitwise.UNARY_OPS == ref_bitwise.UNARY_OPS
    assert bitwise.BINARY_OPS == ref_bitwise.BINARY_OPS
    assert bitwise.TERNARY_OPS == ref_bitwise.TERNARY_OPS


@pytest.mark.parametrize("shape", [(64,), (257,), (8, 1024), (3, 5, 7)])
@pytest.mark.parametrize("op", OPS)
def test_bitwise_equals_pallas(jref, op, shape):
    rng = np.random.default_rng([len(shape), int(np.prod(shape)),
                                 OPS.index(op)])
    args = [rand_words(rng, shape) for _ in range(ARITY[op])]
    want = as_tuple(jref.bitwise(op, *map(jref.jnp.asarray, args),
                                 interpret=True))
    got = as_tuple(ops.bitwise(op, *map(words, args)))
    assert len(got) == len(want) == (2 if op == "fa" else 1)
    for g, w in zip(got, want):
        assert g.shape == shape and g.dtype == torch.int32
        np.testing.assert_array_equal(u32(g), np.asarray(w))


@pytest.mark.parametrize("op", OPS)
def test_bitwise_edge_words(jref, op):
    """Every combination of 0, 0xFFFFFFFF and 0x80000000 per operand."""
    grids = np.meshgrid(*[EDGE] * ARITY[op], indexing="ij")
    args = [g.reshape(-1) for g in grids]
    want = as_tuple(jref.bitwise(op, *map(jref.jnp.asarray, args),
                                 interpret=True))
    got = as_tuple(bitwise.bitwise(op, *map(words, args)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(u32(g), np.asarray(w))


def test_bitwise_dispatch_names():
    """`xnor`, `maj3` and `full_adder` are `bitwise` with their op, and a
    uint32 tensor is read as its int32 bit pattern."""
    rng = np.random.default_rng(2)
    a, b, c = (rand_words(rng, (5, 33)) for _ in range(3))
    ta, tb, tc = map(words, (a, b, c))
    np.testing.assert_array_equal(u32(ops.xnor(ta, tb)), ~(a ^ b))
    maj = (a & b) | (a & c) | (b & c)
    np.testing.assert_array_equal(u32(ops.maj3(ta, tb, tc)), maj)
    s, cy = ops.full_adder(ta, tb, tc)
    np.testing.assert_array_equal(u32(s), a ^ b ^ c)
    np.testing.assert_array_equal(u32(cy), maj)
    np.testing.assert_array_equal(
        u32(ops.bitwise("nand", ta.view(torch.uint32), tb)), ~(a & b))


def test_bitwise_refuses_what_its_kernels_do_not_take(monkeypatch):
    monkeypatch.setattr(bitwise, "bitwise_plain", _boom)
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown op"):
        bitwise.bitwise("andnot", a, a)
    with pytest.raises(ValueError, match="operands"):
        bitwise.bitwise("xnor", a)
    with pytest.raises(ValueError, match="operands"):
        bitwise.bitwise("not", a, a)
    with pytest.raises(ValueError, match="operands"):
        bitwise.bitwise("fa", a, a)
    with pytest.raises(TypeError):
        bitwise.bitwise("xor", a, a.to(torch.int64))
    with pytest.raises(ValueError, match="shapes differ"):
        bitwise.bitwise("xor", a, a[:7])
    with pytest.raises(ValueError, match="shapes differ"):
        bitwise.bitwise("maj3", a, a, a.reshape(2, 4))
    with pytest.raises(ValueError, match="contiguous"):
        bitwise.bitwise("not", torch.zeros(4, 2, dtype=torch.int32).T)
    with pytest.raises(ValueError):
        bitwise.bitwise("not", a.to("meta"))


def _boom(*args, **kwargs):
    raise AssertionError("a wrapper reached the plain version")


# ---------------------------------------------------------------------------
# bitplane_add
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits,w", [(4, 16), (8, 100), (16, 2049), (33, 5)])
def test_bitplane_add_equals_pallas(jref, nbits, w):
    rng = np.random.default_rng([nbits, w])
    a, b = rand_words(rng, (nbits, w)), rand_words(rng, (nbits, w))
    want_s, want_c = jref.add(jref.jnp.asarray(a), jref.jnp.asarray(b),
                              interpret=True)
    s, c = ops.bitplane_add(words(a), words(b))
    assert s.shape == (nbits, w) and c.shape == (w,)
    np.testing.assert_array_equal(u32(s), np.asarray(want_s))
    np.testing.assert_array_equal(u32(c), np.asarray(want_c))


def planes_of(x: np.ndarray, nbits: int) -> np.ndarray:
    """[32 W] integers -> [nbits, W] bit-planes (lane j of word w is
    integer 32 w + j)."""
    bits = (x[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) & 1
    return np.packbits(bits.astype(np.uint8).reshape(nbits, -1, 32),
                       axis=-1, bitorder="little").view(np.uint32)[..., 0]


def lanes_of(planes: np.ndarray) -> np.ndarray:
    """[nbits, W] bit-planes -> [nbits, 32 W] {0, 1}."""
    return np.unpackbits(planes.view(np.uint8), axis=-1, bitorder="little")


@pytest.mark.parametrize("nbits", [1, 7, 33])
def test_bitplane_add_is_integer_addition(nbits):
    """Decoded, sum planes + carry-out << nbits equal x + y lane by lane."""
    rng = np.random.default_rng(nbits)
    x, y = (rng.integers(0, 1 << nbits, 32 * 9, dtype=np.uint64)
            for _ in range(2))
    s, c = ops.bitplane_add(words(planes_of(x, nbits)),
                            words(planes_of(y, nbits)))
    weights = np.uint64(1) << np.arange(nbits, dtype=np.uint64)
    total = (lanes_of(u32(s)).astype(np.uint64) * weights[:, None]).sum(0)
    total += lanes_of(u32(c)[None])[0].astype(np.uint64) << np.uint64(nbits)
    np.testing.assert_array_equal(total, x + y)


def test_bitplane_add_refuses_what_its_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(bitserial_add, "bitplane_add_plain", _boom)
    a = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        bitserial_add.bitplane_add(a, a.float())
    with pytest.raises(ValueError, match="shapes differ"):
        bitserial_add.bitplane_add(a, a[:3])
    with pytest.raises(ValueError):
        bitserial_add.bitplane_add(a.reshape(-1), a.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        bitserial_add.bitplane_add(a.T, a.T)
    with pytest.raises(ValueError):
        bitserial_add.bitplane_add(a.to("meta"), a.to("meta"))


# ---------------------------------------------------------------------------
# unpack_signs
# ---------------------------------------------------------------------------

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8}


@pytest.mark.parametrize("r,w", [(4, 2), (130, 32), (9, 40)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unpack_equals_pallas(jref, dtype, r, w):
    rng = np.random.default_rng([r, w])
    p = rand_words(rng, (r, w))
    p.reshape(-1)[:3] = EDGE
    want = jref.unpack(jref.jnp.asarray(p), getattr(jref.jnp, dtype),
                       interpret=True)
    got = ops.unpack_signs(words(p), DTYPES[dtype])
    assert got.shape == (r, 32 * w) and got.dtype == DTYPES[dtype]
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pack_unpack_round_trip(dtype):
    """unpack(pack(x)) is sign(x) (+1 where x >= 0) and packs back to the
    same words; leading dims flatten and come back."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((2, 3, 96), dtype=np.float32))
    packed = ops.pack_signs(x)
    un = ops.unpack_signs(packed, DTYPES[dtype])
    assert un.shape == (2, 3, 96) and un.dtype == DTYPES[dtype]
    want = torch.where(x >= 0, 1.0, -1.0)
    assert torch.equal(un.to(torch.float32), want)
    assert torch.equal(ops.pack_signs(un.to(torch.float32)), packed)
    assert ops.unpack_signs(packed[..., :0], DTYPES[dtype]).shape == (2, 3, 0)


def test_unpack_refuses_what_its_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(packbits, "unpack_signs_plain", _boom)
    p = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        packbits.unpack_signs(p.float())
    with pytest.raises(TypeError):
        packbits.unpack_signs(p, torch.float16)
    with pytest.raises(ValueError):
        packbits.unpack_signs(p.reshape(-1))
    with pytest.raises(ValueError, match="contiguous"):
        packbits.unpack_signs(p.T)
    with pytest.raises(ValueError):
        packbits.unpack_signs(p.to("meta"))


def test_popcount_is_the_oracle():
    rng = np.random.default_rng(4)
    a = rand_words(rng, 257)
    a[:3] = EDGE
    want = np.unpackbits(a.view(np.uint8)).reshape(-1, 32).sum(1)
    np.testing.assert_array_equal(ops.popcount(words(a)).numpy(), want)


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _card_operands(rng, n, k, dev, offset):
    """k word tensors of n words on the card, each starting `offset`
    words into its own buffer (offset 1 misaligns it)."""
    return [torch.from_numpy(rand_words(rng, n + offset).view(np.int32))
            .to(dev)[offset:] for _ in range(k)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1 << 20, 0), (1000003, 0),
                                      (1000003, 1), (2, 1), (0, 0)])
@pytest.mark.parametrize("op", OPS)
def test_bitwise_kernels_equal_plain(cuda, op, n, offset):
    rng = np.random.default_rng([n, offset])
    args = _card_operands(rng, n, ARITY[op], cuda, offset)
    kernel = {1: bitwise.not_kernel, 2: bitwise.binary_kernel,
              3: bitwise.ternary_kernel}[ARITY[op]]
    before = kernel.launches
    got = as_tuple(bitwise.bitwise(op, *args))
    torch.cuda.synchronize()
    assert kernel.launches == before + (1 if n else 0)
    want = as_tuple(bitwise.bitwise_plain(op, *args))
    for g, w in zip(got, want):
        assert g.shape == (n,) and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nbits,w,offset", [(32, 1 << 16, 0), (1, 1001, 0),
                                            (33, 1000, 0), (33, 1000, 1),
                                            (8, 0, 0)])
def test_bitplane_add_kernel_equals_plain(cuda, nbits, w, offset):
    rng = np.random.default_rng([nbits, w, offset])
    a, b = (t.view(nbits, w) for t in
            _card_operands(rng, nbits * w, 2, cuda, offset))
    before = bitserial_add.bitplane_add.launches
    s, c = bitserial_add.bitplane_add(a, b)
    torch.cuda.synchronize()
    assert bitserial_add.bitplane_add.launches == before + (1 if w else 0)
    want_s, want_c = bitserial_add.bitplane_add_plain(a, b)
    assert torch.equal(s, want_s) and torch.equal(c, want_c)


@pytest.mark.cuda
@pytest.mark.parametrize("r,w,offset", [(3072, 24, 0), (130, 33, 1),
                                        (0, 4, 0)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_unpack_kernel_equals_plain(cuda, dtype, r, w, offset):
    rng = np.random.default_rng([r, w])
    p = _card_operands(rng, r * w, 1, cuda, offset)[0].view(r, w)
    before = packbits.unpack_signs.launches
    got = packbits.unpack_signs(p, DTYPES[dtype])
    torch.cuda.synchronize()
    assert packbits.unpack_signs.launches == before + (1 if r * w else 0)
    assert torch.equal(got, packbits.unpack_signs_plain(p, DTYPES[dtype]))
