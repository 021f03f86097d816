"""Shared tier-1 fixtures.

Makes `src/` importable without an external PYTHONPATH, provides the
session-scoped small device geometry every device/scheduler test reuses
(2 chips x 4 banks x 8 sub-arrays — the acceptance floor — with 64-bit
rows so vmapped execution stays fast on CPU), and a fast-mode knob
(`--fast` or `REPRO_FAST_TESTS=1`) that shrinks example counts so the
whole suite finishes in well under a few minutes single-core.
"""
import os
import pathlib
import sys

import pytest

_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
if str(_SRC) not in sys.path:
    sys.path.insert(0, str(_SRC))

from repro.core import DrimGeometry  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs a CUDA kernel of src/repro_torch on the card; "
        "skips where torch.cuda.is_available() is False")


def pytest_addoption(parser):
    parser.addoption(
        "--fast", action="store_true", default=False,
        help="fast mode: fewer property-test examples / smaller operands")


@pytest.fixture(scope="session")
def fast_mode(request):
    return (request.config.getoption("--fast")
            or os.environ.get("REPRO_FAST_TESTS", "0") not in ("", "0"))


@pytest.fixture(scope="session")
def small_geom():
    """2 chips x 4 banks x 8 sub-arrays of 64-bit rows (64 SIMD lanes)."""
    return DrimGeometry(chips=2, banks=4, subarrays_per_bank=8, row_bits=64)


@pytest.fixture(scope="session")
def n_examples(fast_mode):
    """Example count for hand-rolled property loops."""
    return 2 if fast_mode else 6


@pytest.fixture
def encode_cache():
    """An EMPTY encode memo + stats counter for the duration of one
    test, restored afterwards — cache-accounting assertions become
    exact and order-independent (`scheduler.fresh_encode_cache`)."""
    from repro.pim.scheduler import fresh_encode_cache
    with fresh_encode_cache() as stats:
        yield stats
