"""The port's flash attention forward held against the JAX reference: the
Pallas `_flash_fwd` in interpret mode and the `sdpa_ref` oracle, at the
reference test's five CASES and its tolerances (2e-5 for float32, 2e-2
for bfloat16, `tests/test_flash_attention.py`).  The lse is held at 1e-4.
On the CPU the wrapper runs its plain version; the tests marked `cuda`
hold the CUDA kernel against that plain version on the card (bfloat16
within one bfloat16 ulp) and skip without one.  The bfloat16 kernel runs
on the tensor cores and rounds p to bfloat16 before p v; a CPU test
emulates that rounding and holds it to the same bound.  The reference is
imported by the `jref` fixture, so the `cuda` tests also run where JAX is
not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_flash_attention.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import sdpa_ref

# b, h, hkv, sq, sk, d, bq, bk, causal, dtype (the reference's CASES)
CASES = [
    (1, 1, 1, 128, 128, 64, 64, 64, True, "float32"),
    (2, 4, 2, 128, 256, 64, 64, 128, True, "float32"),
    (1, 2, 2, 256, 256, 32, 128, 64, False, "float32"),
    (2, 8, 2, 128, 128, 64, 128, 128, True, "bfloat16"),
    (1, 4, 1, 64, 192, 128, 64, 64, True, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# kernel against the plain version on the card: float32 at the reference
# test's 2e-5; bfloat16 at one bfloat16 ulp (2**-7 of the value, 4e-3 near
# zero), since each rounds a float32 result to bfloat16 once
CARD_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=2 ** -7, atol=4e-3)}
# the bfloat16 tensor-core kernel's edges (b, h, hkv, sq, sk, d, bq, bk,
# causal): every head width, Sq != Sk both ways, ragged tiles, non-causal,
# n_rep 1, 2, 3 and 4
BF16_CARD_CASES = [
    (2, 4, 2, 128, 128, 16, 64, 64, True),
    (2, 4, 2, 128, 128, 32, 64, 64, True),
    (2, 4, 2, 128, 128, 64, 64, 64, True),
    (2, 4, 2, 128, 128, 128, 64, 64, True),
    (1, 4, 1, 64, 192, 128, 64, 64, True),
    (2, 3, 1, 192, 64, 64, 64, 64, True),
    (1, 4, 2, 96, 160, 16, 32, 32, True),
    (1, 2, 2, 256, 256, 32, 128, 64, False),
    (1, 6, 2, 128, 320, 64, 64, 64, False),
    (2, 4, 4, 128, 128, 64, 64, 64, True),
]


@pytest.fixture(scope="module")
def jref():
    import importlib

    import jax.numpy as jnp

    from repro.kernels import ref
    # the package re-exports the function under the module's name
    jfa = importlib.import_module("repro.kernels.flash_attention")
    return types.SimpleNamespace(jnp=jnp, fa=jfa, ref=ref)


@pytest.fixture
def cuda():
    """The card, decided when the test runs; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_qkv(b, h, hkv, sq, sk, d, dtype, seed=0):
    """Seeded numpy inputs, rounded to `dtype` once so both packages see
    the same values; returned as float32 arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape, dtype=np.float32)
            for shape in ((b, h, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    dt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(dt).to(torch.float32).numpy()
            for a in arrs]


def to_torch(arrs, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device, getattr(torch, dtype))
            for a in arrs]


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,bq,bk,causal,dtype", CASES)
def test_plain_equals_pallas_and_sdpa_ref(jref, b, h, hkv, sq, sk, d, bq, bk,
                                          causal, dtype):
    arrs = make_qkv(b, h, hkv, sq, sk, d, dtype)
    jdt = getattr(jref.jnp, dtype)
    jq, jk, jv = (jref.jnp.asarray(a, jdt) for a in arrs)
    n_rep = h // hkv
    want, want_lse = jref.fa._flash_fwd(jq, jk, jv, causal=causal,
                                        n_rep=n_rep, bq=bq, bk=bk,
                                        interpret=True)
    want_ref = jref.ref.sdpa_ref(jq, jk, jv, causal=causal, n_rep=n_rep)
    q, k, v = to_torch(arrs, dtype)
    out, lse = fa.flash_fwd(q, k, v, causal=causal, n_rep=n_rep, bq=bq, bk=bk)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    tol = TOL[dtype]
    for w in (want, want_ref):
        np.testing.assert_allclose(out.to(torch.float32).numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=LSE_TOL, atol=LSE_TOL)
    out2 = fa.flash_attention(q, k, v, causal, n_rep, bq, bk)
    assert torch.equal(out2, out)


def test_sdpa_ref_is_the_reference_oracle(jref):
    arrs = make_qkv(2, 4, 2, 48, 80, 16, "float32", seed=3)
    for causal in (True, False):
        want = jref.ref.sdpa_ref(*(jref.jnp.asarray(a) for a in arrs),
                                 causal=causal, n_rep=2)
        got = sdpa_ref(*to_torch(arrs, "float32"), causal=causal, n_rep=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)


def test_wrapper_contract():
    q, k, v = to_torch(make_qkv(1, 4, 2, 128, 128, 32, "float32"), "float32")
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_fwd(q[:, :, :96].contiguous(), k, v, n_rep=2)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_fwd(q, k, v, n_rep=2, bk=96)
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), k.half(), v.half(), n_rep=2)
    with pytest.raises(TypeError, match="differ"):
        fa.flash_fwd(q, k.to(torch.bfloat16), v, n_rep=2)
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_fwd(q, k, v, n_rep=3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(2, 3), k, v, n_rep=2)
    # meta tensors model the card (the dry-run): the kernel's outputs
    # with no storage, and the kernel's refusal of a head width
    out, lse = fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                            n_rep=2)
    assert (out.shape, out.dtype, lse.shape, lse.dtype) == \
        (q.shape, q.dtype, q.shape[:3], torch.float32)
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_fwd(*(t[..., :24].contiguous().to("meta")
                       for t in (q, k, v)), n_rep=2)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    calls = []
    real = fa.flash_attention_plain

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(fa, "flash_attention_plain", spy)
    monkeypatch.setattr(fa, "_lib", lambda: pytest.fail("kernel on CPU"))
    before = fa.flash_fwd.launches
    q, k, v = to_torch(make_qkv(1, 2, 1, 128, 128, 32, "bfloat16"),
                       "bfloat16")
    fa.flash_attention(q, k, v, True, 2)
    assert calls == [1] and fa.flash_fwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,bq,bk,causal,dtype",
                         CASES + [(4, 12, 4, 256, 256, 64, 128, 128, True,
                                   "bfloat16"),
                                  (2, 2, 1, 128, 128, 16, 128, 128, True,
                                   "bfloat16")])
def test_kernel_equals_plain_on_the_card(cuda, b, h, hkv, sq, sk, d, bq, bk,
                                         causal, dtype):
    q, k, v = to_torch(make_qkv(b, h, hkv, sq, sk, d, dtype), dtype, cuda)
    before = fa.flash_fwd.launches
    out, lse = fa.flash_fwd(q, k, v, causal=causal, n_rep=h // hkv, bq=bq,
                            bk=bk)
    torch.cuda.synchronize()
    assert fa.flash_fwd.launches == before + 1
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, h // hkv)
    torch.testing.assert_close(out.float(), want.float(), **CARD_TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


def emulate_bf16_kernel(q, k, v, causal, n_rep, tile=64):
    """The bfloat16 kernel's numerics in plain torch: float32 scores of
    bfloat16 inputs, the online softmax over 64-key tiles, l summed from
    the float32 p, p rounded to bfloat16 before p v (float32 sums), and
    out rounded to bfloat16 once."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(n_rep, 1) for t in (k, v))
    m = torch.full((b, h, sq, 1), fa.NEG_INF)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, tile):
        s = qf @ kf[:, :, k0:k0 + tile].transpose(-1, -2) / d ** 0.5
        if causal:
            s = s.masked_fill(rows < torch.arange(k0, min(k0 + tile, sk)),
                              fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * alpha + p16 @ vf[:, :, k0:k0 + tile]
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (2, 4, 2, 128, 128, 64, True),
    (1, 4, 1, 64, 192, 128, True),
    (2, 6, 2, 128, 128, 16, True),
    (1, 3, 3, 128, 192, 32, False)])
def test_bf16_rounding_of_p_stays_within_one_ulp(b, h, hkv, sq, sk, d,
                                                 causal, seed):
    """One rounding of p to bfloat16 before p v (the tensor-core kernel's
    numerics, emulated) keeps out within one bfloat16 ulp of the float32
    plain version, so the kernel needs no hi/lo split of p."""
    q, k, v = to_torch(make_qkv(b, h, hkv, sq, sk, d, "bfloat16", seed),
                       "bfloat16")
    out, lse = emulate_bf16_kernel(q, k, v, causal, h // hkv)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, h // hkv)
    torch.testing.assert_close(out.float(), want.float(),
                               **CARD_TOL["bfloat16"])
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,bq,bk,causal", BF16_CARD_CASES)
def test_bf16_tensor_core_kernel_on_the_card(cuda, b, h, hkv, sq, sk, d, bq,
                                             bk, causal, seed):
    q, k, v = to_torch(make_qkv(b, h, hkv, sq, sk, d, "bfloat16", seed),
                       "bfloat16", cuda)
    out, lse = fa.flash_fwd(q, k, v, causal=causal, n_rep=h // hkv, bq=bq,
                            bk=bk)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal, h // hkv)
    torch.testing.assert_close(out.float(), want.float(),
                               **CARD_TOL["bfloat16"])
    torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = to_torch(make_qkv(1, 2, 1, 128, 128, 48, "float32"), "float32",
                       cuda)
    with pytest.raises(ValueError, match="head widths"):
        fa.flash_fwd(q, k, v, n_rep=2)
    # inputs that require a gradient take the kernel path too, through
    # the autograd Function (its backward is tests/test_torch_flash_backward)
    q, k, v = to_torch(make_qkv(1, 2, 1, 128, 128, 64, "float32"), "float32",
                       cuda)
    before = fa.flash_fwd.launches
    out = fa.flash_attention(q.requires_grad_(), k, v, True, 2)
    assert out.requires_grad and fa.flash_fwd.launches == before + 1
