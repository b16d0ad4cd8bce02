"""The port's kernel contract: the constant-kernel proof and import isolation.

A constant A is baked into the z-sweep launch, so the proof must be sound:
any dataflow from the kernel inputs (position, fields, time) to A, including
through a branch or a piecewise-constant ``torch.where``, makes the kernel
non-constant.  Where a kernel runs in both packages, both must agree.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _diffusion_3d
from l3ster_tpu.algsys.system import _constant_kernel_operators as jax_const
from l3ster_tpu_torch.algsys.system import _constant_kernel_operators as port_const
from tests.torch_reference_fixtures import per_test_limit  # noqa: F401 (fixtures)


def _both(fn, n_eq=7):
    return (
        lt.wrap_domain_equation_kernel(fn, lt.KernelParams(3, n_eq, 4)),
        lp.wrap_domain_equation_kernel(fn, lp.KernelParams(3, n_eq, 4)),
    )


def test_bench_kernel_is_constant():
    kj, kp = _both(_diffusion_3d)
    A = port_const(kp, 0.0)
    assert A is not None and A.shape == (4, 7, 4)
    np.testing.assert_array_equal(A, jax_const(kj, 0.0))


def _branch(inp, out):
    ops, _ = out
    ops[0][0, 0] = 1.0 if inp.point.x > 0.5 else 2.0


def _float_of_input(inp, out):
    ops, _ = out
    ops[0][0, 0] = float(inp.point.y) + 1.0


def _time_dependent(inp, out):
    ops, _ = out
    ops[1][0, 1] = 1.0 + 0.0 * inp.point.time


def _where(inp, out):
    ops, _ = out
    ops[0][0, 0] = torch.where(inp.point.x > 0.5, 1.0, 2.0)


def _setitem_into_constant(inp):
    ops = torch.zeros(4, 1, 4, dtype=torch.float64)
    ops[0, 0, 0] = inp.point.z  # an in-place write of an input into a fresh tensor
    return ops, torch.zeros(1, 1)


def _inplace_view(inp):
    ops = torch.ones(4, 1, 4, dtype=torch.float64)
    ops[1].add_(inp.point.x * 0.0)  # writes through a view of a constant tensor
    return ops, torch.zeros(1, 1)


@pytest.mark.parametrize("fn", [_branch, _float_of_input, _time_dependent])
def test_input_dependent_kernels_are_not_constant_in_both(fn):
    kj, kp = _both(fn, n_eq=1)
    assert jax_const(kj, 0.0) is None
    assert port_const(kp, 0.0) is None


@pytest.mark.parametrize("fn", [_where, _setitem_into_constant, _inplace_view])
def test_torch_dataflow_kernels_are_not_constant(fn):
    k = lp.wrap_domain_equation_kernel(fn, lp.KernelParams(3, 1, 4))
    assert port_const(k, 0.0) is None


def test_functional_constant_kernel():
    def fn(inp):
        ops = torch.zeros(4, 1, 4, dtype=torch.float64)
        ops[1, 0, 0] = 2.0
        return ops, torch.ones(1, 1) * inp.point.x.shape.numel()

    k = lp.wrap_domain_equation_kernel(fn, lp.KernelParams(3, 1, 4))
    A = port_const(k, 0.0)
    assert A is not None and A[1, 0, 0] == 2.0 and np.count_nonzero(A) == 1


def test_import_isolation():
    """``import l3ster_tpu_torch`` pulls in neither JAX nor the JAX package."""
    code = (
        "import sys, l3ster_tpu_torch, l3ster_tpu_torch.ops.zsweep, l3ster_tpu_torch.interop;"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'l3ster_tpu.'))"
        " or m == 'l3ster_tpu'];"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
