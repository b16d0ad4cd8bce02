"""The per-test time limit of ``tests/torch_reference_fixtures.py``: an
over-limit block fails soon after its limit, and what runs after it runs
normally."""

import signal
import time

import pytest

from tests.torch_reference_fixtures import TEST_LIMIT_S, per_test_limit, time_limit  # noqa: F401 (fixtures)


def test_time_limit_interrupts_then_clears():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="a 5 s sleep ran over its 0.5 s limit"):
        with time_limit(0.5, "a 5 s sleep"):
            time.sleep(5.0)
    assert time.monotonic() - t0 < 2.0
    t0 = time.monotonic()
    time.sleep(0.75)  # past the inner limit: nothing of it is left
    assert 0.75 <= time.monotonic() - t0 < 2.0
    left, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0.0 < left < TEST_LIMIT_S  # the test's own limit resumed
