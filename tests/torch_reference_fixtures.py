"""Fixtures of the port's test modules: the reference's programs compile fast,
its distributed ``shard_map`` programs run jitted, and every test runs under
one time limit.

A port module takes the fixtures it needs by importing them; autouse, they then
apply to that module alone::

    from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401

The JAX package's own test modules import none of them.
"""

import faulthandler
import hashlib
import os
import pathlib
import signal
import sys
import tempfile
import time
from contextlib import contextmanager

import jax
import pytest
import torch

TEST_LIMIT_S = 300.0  # a test's own set-up, call and teardown together
BACKSTOP_S = 60.0  # later still, a hang in C code ends the worker (xdist reports it down)

# Each xdist worker takes its share of the cores for torch: its thread pool
# defaults to all of them, and six workers' pools on eight cores slow the
# small ops of the port's tests several times over.
torch.set_num_threads(
    max(1, len(os.sched_getaffinity(0)) // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
)


@contextmanager
def time_limit(seconds: float, what: str = "the block"):
    """TimeoutError in the block after ``seconds`` (SIGALRM: main thread only);
    the process ends ``BACKSTOP_S`` later if the interpreter never takes the
    signal.  An enclosing limit resumes afterwards with what is left of it."""

    def over(signum, frame):
        raise TimeoutError(f"{what} ran over its {seconds:g} s limit")

    def arm(s):
        signal.setitimer(signal.ITIMER_REAL, s)
        faulthandler.dump_traceback_later(s + BACKSTOP_S, exit=True, file=sys.__stderr__)

    handler, t0 = signal.signal(signal.SIGALRM, over), time.monotonic()
    outer = signal.getitimer(signal.ITIMER_REAL)[0]
    arm(seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        faulthandler.cancel_dump_traceback_later()
        signal.signal(signal.SIGALRM, handler)
        if outer:
            arm(max(outer - (time.monotonic() - t0), 1e-3))


@pytest.fixture(autouse=True)
def per_test_limit(request):
    """Every test of the module runs under :data:`TEST_LIMIT_S`.  Under xdist a
    file marks the test while it runs: when the backstop ends a worker, xdist
    hands the rest of the test's file to a new worker, this test first, which
    then fails it at once instead of hanging again."""
    nodeid = request.node.nodeid
    mark = os.environ.get("PYTEST_XDIST_WORKER") and pathlib.Path(
        tempfile.gettempdir(), f"pytest-running-{os.getppid()}-{hashlib.sha1(nodeid.encode()).hexdigest()}"
    )
    if mark and mark.exists():
        mark.unlink()
        pytest.fail(f"{nodeid} ended its worker at the time limit's backstop")
    if mark:
        mark.touch()
    try:
        with time_limit(TEST_LIMIT_S, nodeid):
            yield
    finally:
        if mark:
            mark.unlink(missing_ok=True)


@contextmanager
def xla_optimizations(enabled: bool):
    """XLA compiles with (or without) most of its optimizations inside the block
    (``jax_disable_most_optimizations``).  The arithmetic is the same either way
    (no floating-point reassociation at any level); only compile and run times
    change."""
    prev = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", not enabled)
    try:
        yield
    finally:
        jax.config.update("jax_disable_most_optimizations", prev)


@pytest.fixture(scope="module", autouse=True)
def fast_reference_compiles():
    """While a module that drives the reference runs, its programs compile
    without most optimizations: the reference's eager setup compiles hundreds
    of small programs, and at these sizes their compile time outweighs what
    optimizing them saves.  Every program compiled meanwhile also goes to the
    persistent JAX cache, not only those taking 0.5 s or more
    (``tests/conftest.py``): without optimizations most compile in less, and
    a run with a warm cache then compiles none of them (the compiled code is
    the same either way).  A long iterative solve re-enables the
    optimizations with :func:`xla_optimizations`."""
    prev = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    try:
        with xla_optimizations(False):
            yield
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", prev)


@pytest.fixture(scope="module", autouse=True)
def jitted_shard_maps():
    """The reference's ``shard_map`` programs run jitted: its ``end_assembly``
    calls one eagerly, which dispatches (and compiles) every primitive on its
    own, some 30 s per system."""
    orig = jax.shard_map
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "shard_map", lambda f, *a, **k: jax.jit(orig(f, *a, **k)))
    yield
    mp.undo()
