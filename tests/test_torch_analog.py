"""The port's twin of `jax.random` (`repro_torch.core.prng`), its analog
sense-amplifier model and its Table-3 Monte-Carlo
(`repro_torch.core.analog`), held to `jax.random` and `repro.core.analog`
bit for bit on the CPU.  Draws and counts must be exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as ref_analog
from repro.core import faults as ref_faults
from repro_torch.core import analog, prng
from repro_torch.core.faults import FaultModel
from repro_torch.launch import analog as launch_analog

CPU = "cpu"
SEEDS = [0, 1, 42, 2**31 - 1]


def words(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def bits32(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def ref_rates():
    """The reference's five-corner Monte-Carlo (10,000 trials, seed 0)."""
    return ref_analog.monte_carlo_error_rates()


# ---------------------------------------------------------------------------
# prng: the twin of jax.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_fold_in_equal_jax(seed):
    jk = jax.random.PRNGKey(seed)
    key = prng.PRNGKey(seed, device=CPU)
    np.testing.assert_array_equal(key.numpy(), words(jk))
    for num in (2, 5, 9):
        np.testing.assert_array_equal(prng.split(key, num).numpy(),
                                      words(jax.random.split(jk, num)))
    for data in (0, 1, 3, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                      words(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7, 9), (10_000,), (3, 4, 5)])
def test_random_bits_equal_jax(seed, shape):
    want = words(jax.random.bits(jax.random.PRNGKey(seed), shape))
    got = prng.random_bits(prng.PRNGKey(seed, device=CPU), shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.15, 0.15), (-0.6, 0.6),
                                   (2.0, 5.0), (-0.99999994, 1.0)])
def test_uniform_equal_jax(seed, lo, hi):
    want = jax.random.uniform(jax.random.PRNGKey(seed), (50_000,),
                              minval=lo, maxval=hi)
    got = prng.uniform(prng.PRNGKey(seed, device=CPU), 50_000, lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(bits32(got), bits32(want))


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("p", [0.5, 0.3])
def test_bernoulli_equal_jax(seed, p):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                           (20_000,)))
    got = prng.bernoulli(prng.PRNGKey(seed, device=CPU), p, (20_000,))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 42, 7])
def test_normal_equal_jax(seed):
    """XLA's erf_inv expansion with its log1p and fused multiply-adds: bit
    for bit, the tails (w >= 5, the sqrt branch) included."""
    want = jax.random.normal(jax.random.PRNGKey(seed), (200_000,))
    got = prng.normal(prng.PRNGKey(seed, device=CPU), 200_000)
    np.testing.assert_array_equal(bits32(got), bits32(want))


def test_fma_rounds_once():
    """a * b + c rounded once, where two roundings differ."""
    a = torch.tensor([1.0 + 2.0**-12, 3.0, 1.0 + 2.0**-23])
    b = torch.tensor([1.0 - 2.0**-12, 1.0 / 3.0, 1.0 - 2.0**-23])
    c = torch.tensor([-1.0, -1.0, -1.0])
    want = (a.double() * b.double() + c.double()).float()
    assert torch.equal(prng.fma(a, b, c), want)
    assert not torch.equal(a * b + c, want)


# ---------------------------------------------------------------------------
# analog: the sense amplifier at zero variation (tests/test_analog.py)
# ---------------------------------------------------------------------------

def test_dra_analog_truth_table_zero_variation():
    a = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    b = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    xnor_, xor_ = analog.dra_analog(a, b, variation=0.0)
    assert xnor_.tolist() == [1, 0, 0, 1]
    assert xor_.tolist() == [0, 1, 1, 0]


def test_tra_analog_truth_table_zero_variation():
    a = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], dtype=torch.int32)
    b = torch.tensor([0, 0, 1, 1, 0, 0, 1, 1], dtype=torch.int32)
    c = torch.tensor([0, 1, 0, 1, 0, 1, 0, 1], dtype=torch.int32)
    assert analog.tra_analog(a, b, c, variation=0.0).tolist() == \
        [0, 0, 0, 1, 0, 1, 1, 1]


def test_analog_equals_digital_bulk_zero_variation():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, 2, 4096).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 2, 4096).astype(np.int32))
    xnor_, xor_ = analog.dra_analog(a, b, variation=0.0)
    assert torch.equal(xnor_, 1 - (a ^ b))
    assert torch.equal(xor_, a ^ b)


# ---------------------------------------------------------------------------
# analog: against the reference under jit, at the corners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variation", [0.0, 0.15, 0.3])
def test_dra_tra_equal_jitted_reference(variation):
    """Every trial's outputs equal the reference's compiled under jit (as
    the Monte-Carlo runs it), at corners where some trials fail."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.integers(0, 2, 20_000).astype(np.uint32)
               for _ in range(3))
    jk = jax.random.PRNGKey(3)
    var = jnp.float32(variation)
    want_x, want_xor = jax.jit(ref_analog.dra_analog)(a, b, jk, var)
    want_m = jax.jit(ref_analog.tra_analog)(a, b, c, jk, var)
    ta, tb, tc = (torch.from_numpy(x.astype(np.int32)) for x in (a, b, c))
    key = prng.PRNGKey(3, device=CPU)
    got_x, got_xor = analog.dra_analog(ta, tb, key, float(var))
    got_m = analog.tra_analog(ta, tb, tc, key, float(var))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_xor.numpy(), np.asarray(want_xor))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    if variation:
        assert (got_x.numpy() != 1 - (a ^ b)).any()


@pytest.mark.parametrize("k", [2, 3])
def test_charge_share_voltage_equals_jitted_reference(k):
    rng = np.random.default_rng(k)
    v = rng.uniform(0.0, 1.3, (5000, k)).astype(np.float32)
    caps = rng.uniform(18e-15, 26e-15, (5000, k)).astype(np.float32)
    c_bl = rng.uniform(1e-15, 100e-15, 5000).astype(np.float32)
    want = jax.jit(ref_analog.charge_share_voltage, static_argnums=3)(
        v, caps, c_bl, 1.2)
    got = analog.charge_share_voltage(torch.from_numpy(v),
                                      torch.from_numpy(caps),
                                      torch.from_numpy(c_bl), 1.2)
    np.testing.assert_array_equal(bits32(got), bits32(want))


def test_monte_carlo_equals_reference(ref_rates):
    """The five corners at 10,000 trials, seed 0: the same float32
    percentages (237 / 474 wrong of 10,000 at +-15 %)."""
    assert analog.monte_carlo_error_rates(device=CPU) == ref_rates


@pytest.mark.parametrize("trials,seed", [(777, 1), (3000, 2)])
def test_monte_carlo_equals_reference_small(trials, seed):
    """Trial counts whose 1 / trials is inexact, and other seeds."""
    want = ref_analog.monte_carlo_error_rates(trials=trials, seed=seed,
                                              variations=(0.2, 0.3))
    got = analog.monte_carlo_error_rates(trials=trials, seed=seed,
                                         variations=(0.2, 0.3), device=CPU)
    assert got == want


def test_recorded_counts_equal_reference(ref_rates):
    """`launch.analog`'s constants, which the chip check holds the card
    to, are the reference's counts."""
    assert launch_analog.as_rates(launch_analog.EXPECTED) == ref_rates
    assert launch_analog.as_counts(ref_rates) == launch_analog.EXPECTED
    corner = launch_analog.CORNER
    alone = ref_analog.monte_carlo_error_rates(variations=(corner,))
    assert launch_analog.as_rates({corner: launch_analog.FROM_CORNER}) == \
        alone


@pytest.mark.parametrize("variation,kw", [
    (0.15, {}), (0.3, dict(seed=5, trials=2000, mc_seed=1))])
def test_from_corner_sim_equals_reference(variation, kw):
    got = FaultModel.from_corner(variation, source="sim", device=CPU, **kw)
    want = ref_faults.FaultModel.from_corner(variation, source="sim", **kw)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_analog_launcher_on_the_cpu(capsys):
    assert launch_analog.main(["--device", "cpu"]) == 0
    assert '"TRA": 474' in capsys.readouterr().out


def test_paper_table3_equals_reference():
    assert analog.PAPER_TABLE3 == ref_analog.PAPER_TABLE3
    assert dataclasses.asdict(analog.DEFAULT) == \
        dataclasses.asdict(ref_analog.DEFAULT)
