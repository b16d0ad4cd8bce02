"""The user-facing PDE kernel contract (PyTorch port of ``l3ster_tpu.common.kernel``).

The user describes a system of first-order PDEs

    A0(x) u + sum_d A_d(x) du/dx_d = f(x)

by a pointwise callback that fills the operator matrices ``A0..AD`` (each
n_equations x n_unknowns) and the right-hand side ``f`` (n_equations x n_rhs)
at a space-time point, optionally reading previously computed fields (values
and physical gradients).  The framework maps the callback over quadrature
points x elements with ``torch.func.vmap``, so everything the callback
computes must be vmappable torch code (Python floats and indexing of the
inputs, as in the canonical kernels, are).

Two authoring styles are supported:

* **fill style**: ``fn(inputs, out)`` mutates ``out.operators[d][i, j] =
  value`` / ``out.rhs[i] = value``; the wrapper collects the entries and
  densifies them out of place (a stack, never an in-place write, so the same
  code runs under ``vmap``).
* **functional style**: ``fn(inputs) -> (operators, rhs)`` returning a
  (dim+1, n_eq, n_unk) tensor (or list of dim+1 matrices) and an
  (n_eq, n_rhs) tensor directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = [
    "KernelParams",
    "SpaceTimePoint",
    "DomainInput",
    "BoundaryInput",
    "EquationKernel",
    "ResidualKernel",
    "wrap_domain_equation_kernel",
    "wrap_boundary_equation_kernel",
    "wrap_domain_residual_kernel",
    "wrap_boundary_residual_kernel",
]


@dataclass(frozen=True)
class KernelParams:
    """Compile-time kernel signature (``common/KernelInterface.hpp:13-20``)."""

    dimension: int
    n_equations: int
    n_unknowns: int = 1
    n_fields: int = 0
    n_rhs: int = 1


class SpaceTimePoint(NamedTuple):
    """Physical-space evaluation point (``common/Structs.hpp:81``)."""

    space: torch.Tensor  # (3,)
    time: torch.Tensor  # scalar

    @property
    def x(self):
        return self.space[0]

    @property
    def y(self):
        return self.space[1]

    @property
    def z(self):
        return self.space[2]


class DomainInput(NamedTuple):
    field_vals: torch.Tensor  # (n_fields,)
    field_ders: torch.Tensor  # (dim, n_fields)
    point: SpaceTimePoint


class BoundaryInput(NamedTuple):
    field_vals: torch.Tensor  # (n_fields,)
    field_ders: torch.Tensor  # (dim, n_fields)
    point: SpaceTimePoint
    normal: torch.Tensor  # (dim,)


def _scalar(value, dtype, device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(dtype=dtype).reshape(())
    return torch.tensor(float(value), dtype=dtype, device=device)


class _Filler:
    """Mutable matrix facade collecting ``m[i, j] = value`` assignments."""

    def __init__(self, shape: tuple[int, ...]):
        self.shape = shape
        self.entries: dict[tuple[int, ...], object] = {}

    def _key(self, idx) -> tuple[int, ...]:
        if not isinstance(idx, tuple):
            idx = (idx,)
        idx = tuple(int(i) for i in idx)
        if len(idx) < len(self.shape):
            idx = idx + (0,) * (len(self.shape) - len(idx))
        if len(idx) != len(self.shape):
            raise IndexError(f"index {idx} invalid for shape {self.shape}")
        for i, n in zip(idx, self.shape):
            if not 0 <= i < n:
                raise IndexError(f"index {idx} out of bounds for shape {self.shape}")
        return idx

    def __setitem__(self, idx, value) -> None:
        self.entries[self._key(idx)] = value

    def __getitem__(self, idx):
        return self.entries.get(self._key(idx), 0.0)

    def densify(self, dtype, device) -> torch.Tensor:
        """Out-of-place dense matrix: one stack of the entries and zeros."""
        if not self.entries:
            return torch.zeros(self.shape, dtype=dtype, device=device)
        zero = torch.zeros((), dtype=dtype, device=device)
        strides = [1] * len(self.shape)
        for k in range(len(self.shape) - 2, -1, -1):
            strides[k] = strides[k + 1] * self.shape[k + 1]
        flat = [zero] * (strides[0] * self.shape[0])
        for key, value in self.entries.items():
            flat[sum(i * s for i, s in zip(key, strides))] = _scalar(value, dtype, device)
        return torch.stack(flat).reshape(self.shape)


class _EquationOutput:
    """The ``out`` object handed to fill-style equation kernels."""

    def __init__(self, params: KernelParams):
        self.operators = [
            _Filler((params.n_equations, params.n_unknowns)) for _ in range(params.dimension + 1)
        ]
        self.rhs = _Filler((params.n_equations, params.n_rhs))

    def __iter__(self):  # allow `operators, rhs = out`
        return iter((self.operators, self.rhs))


def _as_tensor(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)


def _densify_operators(ops, params: KernelParams, dtype, device) -> torch.Tensor:
    if isinstance(ops, (list, tuple)):
        mats = [
            o.densify(dtype, device) if isinstance(o, _Filler) else _as_tensor(o, dtype, device)
            for o in ops
        ]
        out = torch.stack(mats)
    else:
        out = _as_tensor(ops, dtype, device)
    expected = (params.dimension + 1, params.n_equations, params.n_unknowns)
    if tuple(out.shape) != expected:
        raise ValueError(f"kernel operators have shape {tuple(out.shape)}, expected {expected}")
    return out


@dataclass(frozen=True)
class EquationKernel:
    """A wrapped equation kernel: evaluate(input) -> (operators, rhs)."""

    fn: Callable
    params: KernelParams
    is_boundary: bool
    fill_style: bool

    def evaluate(self, inputs, dtype, device):
        p = self.params
        if self.fill_style:
            out = _EquationOutput(p)
            self.fn(inputs, out)
            ops = _densify_operators(out.operators, p, dtype, device)
            rhs = out.rhs.densify(dtype, device)
        else:
            ops_raw, rhs_raw = self.fn(inputs)
            ops = _densify_operators(ops_raw, p, dtype, device)
            rhs = _as_tensor(rhs_raw, dtype, device).reshape(p.n_equations, p.n_rhs)
        return ops, rhs

    def __call__(self, inputs, dtype=torch.float64, device=None):
        """:meth:`evaluate` with the systems' defaults: float64, on the card
        unless ``device`` names another."""
        from ..algsys.system import _resolve_device

        return self.evaluate(inputs, dtype, _resolve_device(device))


@dataclass(frozen=True)
class ResidualKernel:
    """A wrapped residual kernel: evaluate(input) -> rhs (n_eq, n_rhs)."""

    fn: Callable
    params: KernelParams
    is_boundary: bool
    fill_style: bool

    def evaluate(self, inputs, dtype, device):
        p = self.params
        if self.fill_style:
            out = _Filler((p.n_equations, p.n_rhs))
            self.fn(inputs, out)
            return out.densify(dtype, device)
        return _as_tensor(self.fn(inputs), dtype, device).reshape(p.n_equations, p.n_rhs)

    def __call__(self, inputs, dtype=torch.float64, device=None):
        """:meth:`evaluate` with the systems' defaults: float64, on the card
        unless ``device`` names another."""
        from ..algsys.system import _resolve_device

        return self.evaluate(inputs, dtype, _resolve_device(device))


def _n_args(fn: Callable) -> int:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return 2
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return 2
    return n


def wrap_domain_equation_kernel(fn: Callable, params: KernelParams) -> EquationKernel:
    return EquationKernel(fn, params, is_boundary=False, fill_style=_n_args(fn) >= 2)


def wrap_boundary_equation_kernel(fn: Callable, params: KernelParams) -> EquationKernel:
    return EquationKernel(fn, params, is_boundary=True, fill_style=_n_args(fn) >= 2)


def wrap_domain_residual_kernel(fn: Callable, params: KernelParams) -> ResidualKernel:
    return ResidualKernel(fn, params, is_boundary=False, fill_style=_n_args(fn) >= 2)


def wrap_boundary_residual_kernel(fn: Callable, params: KernelParams) -> ResidualKernel:
    return ResidualKernel(fn, params, is_boundary=True, fill_style=_n_args(fn) >= 2)
