"""The slice as a whole: the port's BNN dot product on the simulated DRIM
fleet and its BitLinear layer, held against the JAX reference.

Integer dots must be exactly equal.  A float32 BitLinear output loaded
from the reference's packed weights must be exactly equal too: the dot is
an exact integer and the scale is one IEEE multiply by the same alpha.
Where the port computes alpha = mean|w| itself (dense weights), its
float32 sum runs in another order than XLA's, so alpha may differ in the
last bits: there the test holds the port's output exactly to its own
exact dot times its own alpha, and to the reference within 4 float32
ulps of alpha (rtol 5e-7)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.ref import xnor_gemm_ref
from repro.models import layers as ref_layers
from repro.pim import bnn as ref_bnn
from repro_torch.configs.drim_bnn import CONFIG, SMOKE_CONFIG
from repro_torch.core import DrimGeometry
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.pim import bnn


def oracle(a_bits, b_bits):
    k = a_bits.shape[1]
    return np.asarray(xnor_gemm_ref(
        ref_ops.pack_signs(jnp.asarray(a_bits, jnp.float32) - 0.5),
        ref_ops.pack_signs(jnp.asarray(b_bits, jnp.float32) - 0.5), k))


def signs(rng, rows, k):
    return rng.integers(0, 2, (rows, k)).astype(np.uint8)


@pytest.mark.parametrize("accumulate,k", [("ripple", 9), ("carrysave", 33)])
def test_bnn_dot_drim_equals_reference(accumulate, k, small_geom):
    geom = DrimGeometry(**dataclasses.asdict(small_geom))
    rng = np.random.default_rng(k)
    a, b = signs(rng, 7, k), signs(rng, 11, k)
    want, sched_ref = ref_bnn.bnn_dot_drim(a, b, geom=small_geom,
                                           accumulate=accumulate,
                                           engine="pallas")
    np.testing.assert_array_equal(np.asarray(want), oracle(a, b))
    for engine in ("resident", "cuda"):
        got, sched = bnn.bnn_dot_drim(a, b, geom=geom, accumulate=accumulate,
                                      engine=engine, device="cpu")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert dataclasses.asdict(sched) == dataclasses.asdict(sched_ref)


def test_serve_bnn_matmul_equals_reference(small_geom):
    """k_tile < K: three chunks (16, 16, 8), each its own cached kernel."""
    geom = DrimGeometry(**dataclasses.asdict(small_geom))
    rng = np.random.default_rng(3)
    a, b = signs(rng, 6, 40), signs(rng, 9, 40)
    assert bnn.k_chunks(40, 16) == ref_bnn.k_chunks(40, 16) == (16, 16, 8)
    assert bnn.k_chunks(3072) == (128,) * 24
    want = ref_bnn.serve_bnn_matmul(a, b, geom=small_geom, k_tile=16)
    np.testing.assert_array_equal(want, oracle(a, b))
    for engine in ("resident", "cuda"):
        got = bnn.serve_bnn_matmul(a, b, engine=engine, geom=geom,
                                   k_tile=16, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)


def test_stage_and_decode_keep_lane_order():
    """Lane m*N+n is bit l%32 of word l//32, as the reference packs it."""
    rng = np.random.default_rng(4)
    a, b = signs(rng, 5, 3), signs(rng, 7, 3)
    feeds, lanes = bnn.stage_bnn_planes(a, b)
    want, lanes_ref = ref_bnn.stage_bnn_planes(a, b)
    assert lanes == lanes_ref and feeds.keys() == want.keys()
    for name, plane in feeds.items():
        np.testing.assert_array_equal(plane.numpy().view(np.uint32),
                                      want[name])
    planes = {"c0": feeds["a0"], "c1": feeds["b1"]}
    np.testing.assert_array_equal(
        bnn.decode_counts(planes, 2, lanes).numpy(),
        ref_bnn.decode_counts({"c0": want["a0"], "c1": want["b1"]}, 2, lanes))


def smoke_layer(seed, d_in, d_out, rows):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    bias = rng.standard_normal(d_out).astype(np.float32)
    x = rng.standard_normal((rows, d_in)).astype(np.float32)
    return {"bkernel": w, "bias": bias}, x


def test_drim_bnn_widths():
    assert (CONFIG.d_model, CONFIG.d_ff, CONFIG.bitlinear) == (768, 3072, "ffn")
    assert (SMOKE_CONFIG.d_model, SMOKE_CONFIG.d_ff) == (128, 256)


@pytest.mark.parametrize("d_in,d_out", [
    (SMOKE_CONFIG.d_model, SMOKE_CONFIG.d_ff),
    (SMOKE_CONFIG.d_ff, SMOKE_CONFIG.d_model)])
def test_packed_bitlinear_equals_reference(d_in, d_out, small_geom):
    """Weights packed by the reference, loaded with `packed_from_jax`: the
    native route and the DRIM route both give the reference's float32
    outputs exactly."""
    geom = DrimGeometry(**dataclasses.asdict(small_geom))
    params, x = smoke_layer(d_in + d_out, d_in, d_out, rows=6)
    packed_ref = ref_layers.pack_bitlinear(
        {k: jnp.asarray(v) for k, v in params.items()})
    want = np.asarray(ref_layers.bitlinear_packed(packed_ref, jnp.asarray(x),
                                                  d_in))
    with ref_layers.serving_engine("resident", geom=small_geom):
        want_drim = np.asarray(ref_layers.bitlinear_packed(
            packed_ref, jnp.asarray(x), d_in))
    np.testing.assert_array_equal(want_drim, want)

    layer = layers.packed_from_jax(
        {k: np.asarray(v) for k, v in packed_ref.items()}, device="cpu")
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(layer(xt).detach().numpy(), want)
    for engine in ("resident", "cuda"):
        with layers.serving_engine(engine, geom=geom):
            assert layers.serving_engine_name() == engine
            got = layer(xt).detach().numpy()
        np.testing.assert_array_equal(got, want)
    assert layers.serving_engine_name() is None


def test_dense_bitlinear_equals_reference():
    """Dense weights loaded with `bitlinear_from_jax`: the port packs them
    to the reference's words, its STE forward and packed route agree bit
    for bit with its own exact dot times its alpha, and alpha agrees with
    the reference's to float32 summation order."""
    d_in, d_out = SMOKE_CONFIG.d_model, SMOKE_CONFIG.d_ff
    params, x = smoke_layer(1, d_in, d_out, rows=5)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    packed_ref = ref_layers.pack_bitlinear(jparams)
    layer = layers.bitlinear_from_jax(params, device="cpu")
    packed = layer.pack()
    np.testing.assert_array_equal(
        packed.w_packed.numpy().view(np.uint32),
        np.asarray(packed_ref["w_packed"]))
    np.testing.assert_allclose(packed.alpha.numpy(),
                               np.asarray(packed_ref["alpha"]), rtol=5e-7)

    xt = torch.from_numpy(x)
    dot = ops.binary_matmul(xt, packed.w_packed, d_in, dtype=torch.int32)
    np.testing.assert_array_equal(dot.numpy(), oracle(
        (x >= 0).astype(np.uint8), (params["bkernel"].T >= 0).astype(np.uint8)))
    exact = dot.to(torch.float32) * packed.alpha + layer.bias
    for got in (layer(xt), packed(xt)):
        assert torch.equal(got.detach(), exact.detach())
    np.testing.assert_allclose(
        layer(xt).detach().numpy(),
        np.asarray(ref_layers.bitlinear(jparams, jnp.asarray(x))),
        rtol=5e-7, atol=1e-6)


def test_ste_gradient_flows():
    params, x = smoke_layer(2, 32, 16, rows=4)
    layer = layers.bitlinear_from_jax(params, device="cpu")
    layer(torch.from_numpy(x)).sum().backward()
    assert layer.bkernel.grad is not None
    assert float(layer.bkernel.grad.abs().sum()) > 0
