"""The port's flash attention forward held against the JAX reference: the
Pallas `_flash_fwd` in interpret mode and the `sdpa_ref` oracle, at the
reference test's five CASES and its tolerances (2e-5 for float32, 2e-2
for bfloat16, `tests/test_flash_attention.py`).  The lse is held at 1e-4.
On the CPU the wrapper runs its plain version; the tests marked `cuda`
hold the CUDA kernel against that plain version on the card and skip
without one.  The reference is imported by the `jref` fixture, so the
`cuda` tests also run where JAX is not installed:

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
    with pytest.raises(ValueError):
        fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"), n_rep=2)


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
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
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
