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
    x[0, :4] = [-0.0, np.nan, 0.0, -1e-30][:k]  # -0.0 >= 0; NaN packs to 0
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


# The packer at the shapes the main paths launch it with (the FFN pair's
# and the weights' float32, the serving route's bfloat16 activations at
# decode and prefill), ragged K and views one element in: the vector path
# where the data and rows start 16-byte aligned, else the scalar path.
PACK_CASES = [(512, 768, torch.float32, 0, "vector"),
              (3072, 768, torch.float32, 0, "vector"),
              (768, 3072, torch.float32, 0, "vector"),
              (4, 768, torch.bfloat16, 0, "vector"),
              (4, 3072, torch.bfloat16, 0, "vector"),
              (1024, 768, torch.bfloat16, 0, "vector"),
              (1024, 3072, torch.bfloat16, 0, "vector"),
              (300, 700, torch.float32, 0, "vector"),
              (40, 72, torch.bfloat16, 0, "vector"),
              (300, 700, torch.bfloat16, 0, "scalar"),
              (257, 33, torch.bfloat16, 0, "scalar"),
              (64, 1, torch.float32, 0, "scalar"),
              (512, 768, torch.float32, 1, "scalar"),
              (1024, 3072, torch.bfloat16, 1, "scalar")]


def offset_signs(rng, rows, k, dtype, offset, device):
    """sign_input's values as a [rows, k] view `offset` elements into a
    fresh buffer on `device`."""
    flat = np.concatenate([np.ones(offset, np.float32),
                           sign_input(rng, rows, k).ravel()])
    return torch.from_numpy(flat).to(device, dtype)[offset:].view(rows, k)


def emulate_pack(x: torch.Tensor, path: int, n_warps: int = 3) -> np.ndarray:
    """numpy model of `csrc/pack_signs.cu`, lane by lane, `n_warps` warps
    striding over rounds.  Vector (1): lane (grp, sub) loads 16-byte chunk
    `sub` of word `grp` of the round, shifts its nibble (float32) or byte
    (bfloat16) into place and OR-shuffles with the lanes of its word; the
    lanes of chunk 0 store.  Scalar (0): one word a warp, a ballot of 32
    lanes."""
    rows, k = x.shape
    sign = (x.to(torch.float32) >= 0).numpy().astype(np.uint64)
    words = -(-k // 32)
    total = rows * words
    out = np.zeros(total, np.uint64)
    lanes = np.arange(32)
    if path == 0:
        flat = sign.ravel()
        for q in range(total):
            r, w = divmod(q, words)
            col = w * 32 + lanes
            ok = col < k
            bits = np.where(ok, flat[np.where(ok, r * k + col, 0)], 0)
            out[q] = int((bits << lanes.astype(np.uint64)).sum())
        return out.astype(np.uint32).reshape(rows, words)
    per = 16 // x.element_size()              # elements (bits) a chunk
    group, row_chunks = 32 // per, k // per
    step = 32 // group
    chunk = (sign.reshape(-1, per) << np.arange(per, dtype=np.uint64)).sum(1)
    dense = row_chunks == words * group
    sub, grp = lanes % group, lanes // group
    for warp in range(n_warps):
        for base in range(warp * step, total, n_warps * step):
            q = base + grp
            if dense:
                c, ok = base * group + lanes, q < total
            else:
                r = q // words
                j = (q - r * words) * group + sub
                c, ok = r * row_chunks + j, (q < total) & (j < row_chunks)
            word = np.where(ok, chunk[np.where(ok, c, 0)]
                            << (sub * per).astype(np.uint64), 0)
            s = 1
            while s < group:
                word = word | word[lanes ^ s]
                s <<= 1
            keep = (sub == 0) & (q < total)
            out[q[keep]] = word[keep]
    return out.astype(np.uint32).reshape(rows, words)


@pytest.mark.parametrize("rows,k,dtype,offset,path", PACK_CASES)
def test_pack_kernel_emulated_equals_plain(rows, k, dtype, offset, path):
    x = offset_signs(np.random.default_rng(rows * k), rows, k, dtype, offset,
                     "cpu")
    assert packbits.pack_path(x) == path
    want = u32(packbits.pack_signs_plain(x))
    code = 1 if path == "vector" else 0
    np.testing.assert_array_equal(emulate_pack(x, code), want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,dtype,offset,path", PACK_CASES)
def test_pack_kernel_served_shapes_equal_plain(cuda, rows, k, dtype, offset,
                                               path):
    x = offset_signs(np.random.default_rng(rows * k), rows, k, dtype, offset,
                     cuda)
    assert packbits.pack_path(x) == path
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


# The kernel's arithmetic, emulated on the CPU: csrc/xnor_gemm.cu masks a's
# words to K in shared memory, fills lane t's mma fragment registers with
# 0/1 int8 from bits 8j + t (register 0) and 8j + 4 + t (register 2) of a
# word shifted right by t, j = 0..3, and turns the 0/1 product P into the
# +-1 dot with the rows' popcounts below K: 4 P - 2 pa - 2 pb + K.
GEMM_EXPAND = ("x.x &= word_mask(w, words, k);",
               "fb[ni][0] = y & kLow;", "fb[ni][1] = (y >> 4) & kLow;",
               "{x0 & kLow, x1 & kLow, (x0 >> 4) & kLow",
               "4 * acc[mi][ni][2 * h] - 2 * pa - 2 * pb0 + k")


def expand_bits(x, t, mask=0xFFFFFFFF):
    """Lane t's two fragment registers of words `x` (uint32 arrays) under
    K masks `mask`, as the kernel computes them."""
    x = (np.asarray(x, np.uint32) & np.asarray(mask, np.uint32)) \
        >> np.uint32(t)
    low = np.uint32(0x01010101)
    return x & low, (x >> np.uint32(4)) & low


@pytest.mark.parametrize("t", range(4))
def test_gemm_bit_expansion_equals_unpack(t):
    """Lane t's expansion, emulated, over all 16 patterns of its four bits
    of a register and every mask pattern (the rest of the word random):
    each int8 is the bit unpack_signs_ref unpacks (as 0/1), 0 where the
    mask is 0; the .cu computes exactly these expressions."""
    import pathlib
    src = (pathlib.Path(xnor_popcount.__file__).parents[1] / "csrc" /
           "xnor_gemm.cu").read_text()
    for expr in GEMM_EXPAND:
        assert expr in src, expr
    rng = np.random.default_rng(t)
    pats = np.arange(16, dtype=np.uint32)
    v, m = (a.reshape(-1) for a in np.meshgrid(pats, pats, indexing="ij"))
    for reg, base in ((0, t), (1, 4 + t)):
        at = [8 * j + base for j in range(4)]
        spread = lambda p: sum(((p >> j) & 1) << at[j]  # noqa: E731
                               for j in range(4)).astype(np.uint32)
        noise = rng.integers(0, 2 ** 32, (2, v.size), dtype=np.uint32)
        keep = ~np.uint32(sum(1 << b for b in at))
        x = (noise[0] & keep) | spread(v)
        mask = (noise[1] & keep) | spread(m)
        got = expand_bits(x, t, mask)[reg].view(np.int8).reshape(-1, 4)
        bits = (ref.unpack_signs_ref(words(x)[:, None], torch.int8)
                .numpy()[:, at] + 1) // 2
        mbits = (mask[:, None] >> np.array(at, np.uint32)) & 1
        np.testing.assert_array_equal(got, bits * mbits)
        assert set(np.unique(got)) <= {0, 1}


def emulate_xnor_gemm(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """csrc/xnor_gemm.cu step by step in numpy: 64 x 64 block tiles, warps
    of 64 x 32, each lane's fragment registers expanded from its bits, the
    fragments read back into 16 x 32 and 32 x 8 int8 tiles by the PTX
    layouts of mma.m16n8k32 (A: register j of lane (g, t) holds row g + 8
    (j & 1), k 4t + 16 (j >> 1) + byte; B: register j holds k 4t + 16 j +
    byte of column g; C: register j is row g + 8 (j >> 1), column 2t + (j
    & 1)), multiplied, and the popcount correction applied.  (The K groups
    only split the sum over k steps, which integer addition does not see.)
    """
    m_rows, words_ = a.shape
    n_rows = b.shape[0]
    wp = -(-words_ // 8) * 8
    mp, np_ = -(-m_rows // 64) * 64, -(-n_rows // 64) * 64
    ap = np.zeros((mp, wp), np.uint32)
    bp = np.zeros((np_, wp), np.uint32)
    ap[:m_rows, :words_], bp[:n_rows, :words_] = a, b
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    p = np.zeros((mp, np_), np.int64)
    pa = np.zeros(mp, np.int64)
    pb = np.zeros(np_, np.int64)

    def int8s(reg):                      # [32 lanes] uint32 -> [32, 4]
        return reg.astype(np.uint32).view(np.int8).reshape(32, 4)

    popc = np.vectorize(lambda x: bin(int(x)).count("1"))
    for w in range(wp):
        valid = k - 32 * w
        mask = 0 if w >= words_ or valid <= 0 else (
            0xFFFFFFFF if valid >= 32 else (1 << valid) - 1)
        pa += popc(ap[:, w] & np.uint32(mask))
        pb += popc(bp[:, w] & np.uint32(mask))
        for m0 in range(0, mp, 64):
            for n0 in range(0, np_, 64):
                for wn in (0, 32):
                    for mi in range(4):
                        rows = m0 + mi * 16 + g
                        lo0, hi0 = expand_bits(ap[rows, w], t, mask)
                        lo1, hi1 = expand_bits(ap[rows + 8, w], t, mask)
                        tile_a = np.zeros((16, 32), np.int64)
                        for j, reg in enumerate((lo0, lo1, hi0, hi1)):
                            for byte in range(4):
                                tile_a[g + 8 * (j & 1),
                                       4 * t + 16 * (j >> 1) + byte] = \
                                    int8s(reg)[:, byte]
                        for ni in range(4):
                            cols = n0 + wn + ni * 8 + g
                            tile_b = np.zeros((32, 8), np.int64)
                            for j, reg in enumerate(expand_bits(bp[cols, w],
                                                                t)):
                                for byte in range(4):
                                    tile_b[4 * t + 16 * j + byte, g] = \
                                        int8s(reg)[:, byte]
                            acc = tile_a @ tile_b
                            for j in range(4):
                                rr, cc = g + 8 * (j >> 1), 2 * t + (j & 1)
                                p[m0 + mi * 16 + rr,
                                  n0 + wn + ni * 8 + cc] += acc[rr, cc]
    c = 4 * p - 2 * pa[:, None] - 2 * pb[None, :] + k
    return c[:m_rows, :n_rows].astype(np.int32)


@pytest.mark.parametrize("m,n,k", [(17, 9, 1), (100, 77, 700), (3, 5, 32),
                                   (70, 130, 300)])
def test_gemm_kernel_emulated_equals_ref(m, n, k):
    """The kernel's tiling, fragments and expansion, emulated, equal the
    plain version with random (noisy) pad bits."""
    rng = np.random.default_rng(m + n + k)
    w = -(-k // 32)
    a = rng.integers(0, 2 ** 32, (m, w), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    np.testing.assert_array_equal(
        emulate_xnor_gemm(a, b, k),
        xnor_popcount.xnor_gemm_plain(words(a), words(b), k).numpy())


@pytest.mark.parametrize("m,n,k,kg", [
    (512, 3072, 768, 2), (512, 768, 3072, 4), (4, 3072, 768, 2),
    (4, 768, 3072, 4), (1024, 3072, 768, 1), (1024, 768, 3072, 4),
    (17, 9, 1, 1), (100, 77, 700, 1)])
def test_gemm_k_groups(m, n, k, kg):
    """The K groups the wrapper picks on 132 SMs: 12 or more k steps a
    warp, every block resident at once."""
    assert xnor_popcount.k_groups(m, n, -(-k // 32), 132) == kg


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [
    (512, 3072, 768), (4, 3072, 768), (1024, 3072, 768), (512, 768, 3072),
    (17, 9, 1), (100, 77, 700)])
def test_gemm_kernel_equals_plain(cuda, m, n, k):
    """The tensor-core kernel at the FFN pair's, decode's and prefill's
    shapes and ragged ones, random words (noisy pad bits where K is not
    a multiple of 32) against the plain version, exactly."""
    rng = np.random.default_rng(k)
    w = -(-k // 32)
    a = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (m, w),
                                      dtype=np.int32)).to(cuda)
    b = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (n, w),
                                      dtype=np.int32)).to(cuda)
    before = xnor_popcount.xnor_gemm_packed.launches
    got = xnor_popcount.xnor_gemm_packed(a, b, k)
    torch.cuda.synchronize()
    assert xnor_popcount.xnor_gemm_packed.launches == before + 1
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


@pytest.mark.parametrize("faulted", [False, True])
def test_launch_geometry_fits_shared_memory(faulted):
    """Slots, words per thread and the SM count set the block; with fault
    injection each instruction chunk carries 8 more bytes an
    instruction."""
    def geometry(*args, **kw):
        return aap_interpreter.launch_geometry(*args, **kw, faulted=faulted)
    chunks = 2 * aap_interpreter.STREAM_CHUNK * (16 + 8 * faulted)
    # the K=128 serving stream's 96 slots over one full DRIM-R wave: 4
    # words a thread, 128 blocks of 128 threads, one round on 132 SMs
    assert geometry(96, 65536, 1, 132) == (4, 128, 97 * 4 * 4 * 128 + chunks)
    assert geometry(97, 65536, 1, 132) == geometry(96, 65536, 1, 132)
    for slots in (1, 31, 95, 137, 269, 1700):
        for cols, waves in ((65536, 1), (65536, 4), (1000, 3)):
            w, t, smem = geometry(slots, cols, waves, 132)
            assert w in (1, 2, 4) and t % 32 == 0
            assert smem == (slots | 1) * 4 * w * t + chunks
            assert smem <= aap_interpreter.MAX_BLOCK_SMEM
    assert geometry(269, 65536, 1, 132, words=(1,))[0] == 1
    with pytest.raises(ValueError):
        geometry(2000, 65536, 1, 132)


# the packed stream of the fault-free kernel, held on the CPU by its
# plain twin: random soups (DCC aliases, complemented slots), staged rows
# copied before the loop and inside it, in both instruction orders
@pytest.mark.parametrize("trial", range(4))
def test_packed_twin_equals_plain_and_pallas(jref, trial):
    rng = np.random.default_rng(7 + trial)
    n_rows, n_in = 12, 5
    readback = tuple(range(n_rows + 4))
    ref_prog = random_program(rng, jref.isa, n_rows, 40 + 60 * trial)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    tiles = rng.integers(0, 2 ** 32, (n_in, 2, 1, 5), dtype=np.uint32)
    want = np.asarray(jref.interp.pallas_wave_fn(
        ref_prog, readback, n_rows, interpret=True)(jref.jnp.asarray(tiles)))
    stream = isa.encode_kernel_stream(prog, n_rows=n_rows)
    slots = [isa.kstream_slot(r, n_rows) for r in readback]
    n_state = isa.dcc_state_rows(n_rows)
    flat = words(tiles).reshape(1, n_in, -1)
    plain = aap_interpreter.aap_interp_plain(
        torch.from_numpy(stream), flat, torch.tensor(slots, dtype=torch.int32),
        n_state)
    np.testing.assert_array_equal(u32(plain[0]).reshape(want.shape), want)
    for demand in (False, True):
        packed = aap_interpreter._pack(stream, slots, n_state, n_in, demand)
        assert packed.n_slots <= n_state + 2
        assert torch.equal(aap_interpreter.aap_interp_packed_plain(
            packed, flat), plain), demand
    assert aap_interpreter.pack_stream(stream, slots, n_state, n_in).n_slots \
        == min(aap_interpreter._pack(stream, slots, n_state, n_in, d).n_slots
               for d in (False, True))


@pytest.mark.parametrize("trial", range(2))
def test_packed_twin_copies_staged_rows_inside_the_loop(jref, trial):
    """Staged rows first read past the lookahead: a soup over the rows
    that are not staged (DCC aliases included), then one TRA of three
    staged rows (three copies issued at one instruction), then a soup
    over every row.  The copies issued inside the loop land where the
    twin reads them, in both instruction orders."""
    rng = np.random.default_rng(11 + trial)
    n_rows, n_in = 12, 5
    readback = tuple(range(n_rows + 4))
    lead = 2 * aap_interpreter.LOOKAHEAD + 7 * trial
    ref_prog = tuple(
        jref.isa.AAP(i.op, tuple(a + n_in for a in i.args)) for i in
        random_program(rng, jref.isa, n_rows - n_in, lead)) + (
        jref.isa.AAP(isa.OP_TRA, (0, 1, 2, n_in)),) + random_program(
        rng, jref.isa, n_rows, 60)
    prog = tuple(isa.AAP(i.op, i.args) for i in ref_prog)
    tiles = rng.integers(0, 2 ** 32, (n_in, 1, 2, 3), dtype=np.uint32)
    want = np.asarray(jref.interp.pallas_wave_fn(
        ref_prog, readback, n_rows, interpret=True)(jref.jnp.asarray(tiles)))
    stream = isa.encode_kernel_stream(prog, n_rows=n_rows)
    slots = [isa.kstream_slot(r, n_rows) for r in readback]
    flat = words(tiles).reshape(1, n_in, -1)
    for demand in (False, True):
        packed = aap_interpreter._pack(stream, slots,
                                       isa.dcc_state_rows(n_rows), n_in,
                                       demand)
        flags = packed.words[:packed.n_ins, 3].view(np.uint32) >> 16
        assert packed.n_pre < len(packed.loads) - 4, demand
        assert (flags >> 9 & 3).max() == 3, demand
        got = aap_interpreter.aap_interp_packed_plain(packed, flat)
        np.testing.assert_array_equal(u32(got[0]).reshape(want.shape), want)


def test_packing_constants_match_the_kernel():
    """The host packs the staged-row copies LOOKAHEAD instructions ahead
    and sizes shared memory for two STREAM_CHUNK chunks; the kernel is
    built with the same kLookahead and kChunk."""
    import pathlib
    import re
    src = (pathlib.Path(aap_interpreter.__file__).parents[1] / "csrc" /
           "aap_interp.cu").read_text()
    for name, value in (("kLookahead", aap_interpreter.LOOKAHEAD),
                        ("kChunk", aap_interpreter.STREAM_CHUNK)):
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], (name, found)


def test_packed_twin_of_the_empty_program(jref):
    tiles = np.arange(2 * 3 * 4, dtype=np.uint32).reshape(2, 1, 3, 4)
    readback = (0, 1, 5, 10, 11)                # rows, untouched rows, DCC
    want = np.asarray(jref.interp.pallas_wave_fn(
        (), readback, 10, interpret=True)(jref.jnp.asarray(tiles)))
    slots = [isa.kstream_slot(r, 10) for r in readback]
    packed = aap_interpreter.pack_stream(
        np.zeros((0, isa.KSTREAM_COLS), np.int32), slots, 12, 2)
    assert packed.n_slots == 2 and packed.n_pre == 0
    got = aap_interpreter.aap_interp_packed_plain(
        packed, words(tiles).reshape(1, 2, -1))
    np.testing.assert_array_equal(u32(got[0]).reshape(want.shape), want)


@pytest.fixture(scope="module")
def carry_save_streams():
    """{label: (program, readback rows, template rows, staged rows)} of
    the carry-save dots the chip phases run: K=32, K=128 bare (the
    serving stream) and hardened."""
    from repro_torch.core import DRIM_R
    from repro_torch.pim.bnn import bnn_dot_graph_carrysave
    out = {}
    for k, harden in ((32, None), (128, None), (128, "tmr"), (128, "ecc"),
                      (128, "tmr+ecc")):
        graph, _ = bnn_dot_graph_carrysave(k)
        fp = compiler.compile(graph, geom=DRIM_R).lower(
            "cuda", harden=harden).fp
        out[f"K={k} {harden or 'bare'}"] = (
            fp.program, fp.readback_rows, fp.template_rows,
            len(fp.loaded_inputs))
    return out


@pytest.mark.parametrize("label", ["K=32 bare", "K=128 bare", "K=128 tmr",
                                   "K=128 ecc", "K=128 tmr+ecc"])
def test_packed_twin_on_carry_save_streams(jref, carry_save_streams, label):
    """The serving, bulk and faults phases' streams: the packed twin (the
    "cuda" engine's wave function on CPU tensors) equals the plain replay
    and the reference's Pallas kernel in interpret mode."""
    prog, readback, n_rows, n_in = carry_save_streams[label]
    rng = np.random.default_rng(len(prog))
    tiles = rng.integers(0, 2 ** 32, (n_in, 1, 2, 1, 3), dtype=np.uint32)
    want = np.asarray(jref.interp.pallas_wave_fn(
        tuple(jref.isa.AAP(i.op, i.args) for i in prog), readback, n_rows,
        interpret=True)(jref.jnp.asarray(tiles)))
    got = aap_interpreter.cuda_wave_fn(prog, readback, n_rows)(
        words(tiles)[None])
    np.testing.assert_array_equal(u32(got[0]), want)
    stream = isa.encode_kernel_stream(prog, n_rows=n_rows)
    slots = [isa.kstream_slot(r, n_rows) for r in readback]
    n_state = isa.dcc_state_rows(n_rows)
    plain = aap_interpreter.aap_interp_plain(
        torch.from_numpy(stream), words(tiles).reshape(1, n_in, -1),
        torch.tensor(slots, dtype=torch.int32), n_state)
    np.testing.assert_array_equal(u32(plain[0]).reshape(want.shape), want)
    packed = aap_interpreter.pack_stream(stream, slots, n_state, n_in)
    assert packed.peak_live < packed.n_slots <= n_state + 2
    # (slots with zeros and the sink, live-row peak) in program order and
    # in demand order: demand order needs fewer for the bare dots, program
    # order for the hardened streams, whose adders share the DCC rows;
    # pack_stream keeps the fewer (the serving stream: 96 of 267 rows)
    orders = {"K=32 bare": ((51, 35), (32, 25)),
              "K=128 bare": ((147, 131), (96, 89)),
              "K=128 tmr": ((138, 136), (142, 138)),
              "K=128 ecc": ((261, 259), (263, 261)),
              "K=128 tmr+ecc": ((270, 268), (272, 270))}[label]
    for demand, (n_slots, peak) in zip((False, True), orders):
        p = aap_interpreter._pack(stream, slots, n_state, n_in, demand)
        assert (p.n_slots, p.peak_live) == (n_slots, peak), demand
    assert (packed.n_slots, packed.peak_live) == min(orders)


# SHA-256 (first 16 hex digits) of words, loads and out_map as the pass
# packed these streams before it took stuck rows
UNSTUCK_PACKINGS = {"K=32 bare": "a5788675a0585d18",
                    "K=128 bare": "2f81f8284fd9a262",
                    "K=128 tmr": "9309580e5a64c2e0",
                    "K=128 ecc": "1fe6c2cb67c8a163",
                    "K=128 tmr+ecc": "8121e5be2debba15"}


@pytest.mark.parametrize("label", sorted(UNSTUCK_PACKINGS))
def test_pack_without_stuck_rows_is_unchanged(carry_save_streams, label):
    """`stuck=()` packs the fault-free streams byte for byte as before the
    pass took stuck rows, and keeps every instruction once in `order`."""
    import hashlib
    prog, readback, n_rows, n_in = carry_save_streams[label]
    stream = isa.encode_kernel_stream(prog, n_rows=n_rows)
    slots = [isa.kstream_slot(r, n_rows) for r in readback]
    n_state = isa.dcc_state_rows(n_rows)
    packed = aap_interpreter.pack_stream(stream, slots, n_state, n_in)
    same = aap_interpreter.pack_stream(stream, slots, n_state, n_in,
                                       stuck=())
    digest = hashlib.sha256()
    for a, b in ((packed.words, same.words), (packed.loads, same.loads),
                 (packed.out_map, same.out_map)):
        np.testing.assert_array_equal(a, b)
        digest.update(np.ascontiguousarray(a).tobytes())
    assert digest.hexdigest()[:16] == UNSTUCK_PACKINGS[label]
    assert packed.stuck == () and sorted(packed.order) == list(
        range(len(prog)))


def test_pack_refuses_more_rows_than_16_bits_address():
    empty = np.zeros((0, isa.KSTREAM_COLS), np.int32)
    assert aap_interpreter.pack_stream(empty, [], 65535, 0).n_slots == 2
    with pytest.raises(ValueError, match="65535"):
        aap_interpreter.pack_stream(empty, [], 65536, 0)
    with pytest.raises(ValueError, match="65535"):
        aap_interpreter.aap_interp(
            torch.zeros((0, 19), dtype=torch.int32),
            torch.zeros((1, 1, 4), dtype=torch.int32),
            torch.zeros((0, 2), dtype=torch.int32), 70000)


@pytest.mark.cuda
@pytest.mark.parametrize("cols,words_", [(1000, 4), (1002, 2), (999, 1),
                                         (65536, 4)])
def test_interp_kernel_equals_plain(cuda, cols, words_):
    """The packed kernel against the plain replay and its plain twin: a
    700-AAP soup (three shared-memory chunks of the stream) over 3 waves
    of ragged widths that give 4, 2 and 1 words a thread, and the K=128
    serving stream over one full DRIM-R wave (65,536 word columns)."""
    rng = np.random.default_rng(5 + cols)
    if cols == 65536:
        from repro_torch.core import DRIM_R
        from repro_torch.pim.bnn import serving_lowering
        fp = serving_lowering(128, engine="cuda", geom=DRIM_R).fp
        prog, readback, n_rows = (fp.program, fp.readback_rows,
                                  fp.template_rows)
        waves, n_in = 1, len(fp.loaded_inputs)
    else:
        n_rows = 20
        prog = random_program(rng, isa, n_rows, 700)
        readback = range(n_rows + 4)
        waves, n_in = 3, 6
    stream_np = isa.encode_kernel_stream(prog, n_rows=n_rows)
    stream = torch.from_numpy(stream_np).to(cuda)
    slot_list = [isa.kstream_slot(r, n_rows) for r in readback]
    slots = torch.tensor(slot_list, dtype=torch.int32, device=cuda)
    tiles = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31,
                                          (waves, n_in, cols),
                                          dtype=np.int32)).to(cuda)
    n_state = isa.dcc_state_rows(n_rows)
    packed = aap_interpreter.pack_stream(stream_np, slot_list, n_state, n_in)
    assert aap_interpreter.launch_geometry(
        packed.n_slots, cols, waves,
        torch.cuda.get_device_properties(cuda).multi_processor_count,
        aap_interpreter.words_choices(cols, tiles.data_ptr()))[0] == words_
    before = aap_interpreter.aap_interp.launches
    got = aap_interpreter.aap_interp(stream, tiles, slots, n_state,
                                     packed=packed)
    torch.cuda.synchronize()
    assert aap_interpreter.aap_interp.launches == before + 1
    assert torch.equal(got, aap_interpreter.aap_interp_packed_plain(
        packed, tiles))
    assert torch.equal(got, aap_interpreter.aap_interp_plain(
        stream, tiles, slots, n_state))
    # packed by the wrapper itself
    assert torch.equal(got, aap_interpreter.aap_interp(
        stream, tiles, slots, n_state))


@pytest.mark.cuda
@pytest.mark.parametrize("full_wave", [False, True])
def test_cuda_engine_on_the_card(cuda, full_wave):
    """The whole "cuda" engine path on the card: staging, the interpreter
    kernel over several waves (or over one full DRIM-R wave of 65,536
    word columns), decoding; dots equal the numpy ±1 product."""
    from repro_torch.core import DRIM_R
    from repro_torch.pim.bnn import bnn_dot_drim, serve_bnn_matmul
    geom = DRIM_R if full_wave else DrimGeometry(
        chips=1, banks=2, subarrays_per_bank=4, row_bits=64)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2, (37, 150)).astype(np.uint8)
    b = rng.integers(0, 2, (29, 150)).astype(np.uint8)
    want = (2 * a.astype(np.int64) - 1) @ (2 * b.astype(np.int64) - 1).T
    before = aap_interpreter.aap_interp.launches
    got = serve_bnn_matmul(a, b, engine="cuda", geom=geom, k_tile=64,
                           device=cuda)
    assert aap_interpreter.aap_interp.launches == before + 3
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if full_wave:
        return
    got, sched = bnn_dot_drim(a[:, :20], b[:, :20], geom=geom,
                              accumulate="carrysave", engine="cuda",
                              device=cuda)
    assert sched.waves > 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        (2 * a[:, :20].astype(np.int64) - 1) @ (2 * b[:, :20].astype(np.int64) - 1).T)
