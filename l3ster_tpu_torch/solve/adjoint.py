"""Differentiable linear solves by the adjoint method (PyTorch port of
``l3ster_tpu.solve.adjoint``).

The implicit-function-theorem rule for ``K(theta) u = b(theta)``:

    dL/d theta = - lambda^T (dK/d theta) u + lambda^T db/d theta,
    K^T lambda = (dL/du)^T

so one extra linear solve (the adjoint solve) per backward pass, plus one
vector-Jacobian product of the operator apply with respect to its consts
(``torch.autograd`` on ``fn(u, *consts)``).  For the LSFEM normal equations
K = A^T A is symmetric, so the adjoint solve reuses the forward operator and
CG; a nonsymmetric operator gets its exact transpose from ``torch.autograd``
with respect to x, and GMRES.

Usage, with gradients with respect to any tensor inside the consts and the
right-hand side::

    fn, consts = system.operator_parts()
    u = linear_solve(fn, consts, b(theta), tol=1e-12)
    objective(u).backward()

The consts may be nested tuples, lists and dicts (a matrix-free system's
operator data); their tensor leaves are the differentiable inputs.  The
preconditioner and the initial guess change only the iteration path, never
the converged solution, so their cotangents are zero.

The right-hand side, the initial guess and the solution travel as pytree
leaves, so a distributed system's vectors placed on several devices
(``parallel/sharded.py:ShardedStack``, a pytree of its parts) solve and
differentiate like one tensor.

The hand-written CUDA kernels have no backward, but for the node-row gather
and scatter of the gather apply, each the other's transpose
(``ops/rows.py``).  When a const that requires grad reaches an operator kind
that launches one without a backward, ``linear_solve`` raises before it
solves (``ops/_cuda.py:no_autograd``), rather than return a gradient that
silently leaves out the kernel's part.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from ..parallel.sharded import ShardedStack  # noqa: F401  (registers it as a pytree node)
from .krylov import cg_solve, gmres_solve

__all__ = ["linear_solve"]


class _Spec:
    """The non-tensor parts of a solve: operator, preconditioner, the pytree
    structures of their consts (tensor leaves travel as autograd inputs) and
    the options."""

    def __init__(self, fn, consts, precond, precond_consts, opts):
        self.fn, self.precond, self.opts = fn, precond, opts
        leaves, self.tree = tree_flatten(tuple(consts))
        mleaves, self.mtree = tree_flatten(tuple(precond_consts))
        self.leaves, self.is_t = leaves, [isinstance(v, torch.Tensor) for v in leaves]
        self.mleaves, self.mis_t = mleaves, [isinstance(v, torch.Tensor) for v in mleaves]

    def tensors(self):
        return [v for v, t in zip(self.leaves, self.is_t) if t], [
            v for v, t in zip(self.mleaves, self.mis_t) if t
        ]

    @staticmethod
    def _rebuild(leaves, is_t, tree, tensors):
        it = iter(tensors)
        return tree_unflatten([next(it) if t else v for v, t in zip(leaves, is_t)], tree)

    def consts(self, tensors):
        return self._rebuild(self.leaves, self.is_t, self.tree, tensors)

    def precond_fn(self, mtensors):
        if self.precond is None:
            return None
        mc = self._rebuild(self.mleaves, self.mis_t, self.mtree, mtensors)
        return lambda r: self.precond(r, *mc)


def _krylov(op, b, x0, M, opts):
    tol, max_iters, symmetric, restart = opts
    if symmetric:
        return cg_solve(op, b, x0=x0, precond=M, tol=tol, max_iters=max_iters)[0]
    return gmres_solve(op, b, x0=x0, precond=M, tol=tol, max_iters=max_iters, restart=restart)[0]


class _LinearSolve(torch.autograd.Function):
    """Inputs: the spec, the number of operator const tensors, the vectors'
    pytree structure, then the leaves of b and of x0, the operator's and the
    preconditioner's const tensors; outputs: the leaves of u."""

    @staticmethod
    def forward(ctx, spec: _Spec, n_c: int, vtree, *tensors):
        n_v = vtree.num_leaves
        b, x0 = (tree_unflatten(list(tensors[i * n_v : (i + 1) * n_v]), vtree) for i in range(2))
        cts, mts = list(tensors[2 * n_v : 2 * n_v + n_c]), list(tensors[2 * n_v + n_c :])
        consts = spec.consts(cts)
        u = tree_leaves(_krylov(lambda v: spec.fn(v, *consts), b, x0, spec.precond_fn(mts), spec.opts))
        ctx.spec, ctx.n_c, ctx.vtree = spec, n_c, vtree
        ctx.save_for_backward(*u, *tensors[2 * n_v :])
        return tuple(u)

    @staticmethod
    def backward(ctx, *gbar):
        spec, n_c, vtree = ctx.spec, ctx.n_c, ctx.vtree
        n_v = vtree.num_leaves
        saved = ctx.saved_tensors
        u_l, tensors = [t.detach() for t in saved[:n_v]], saved[n_v:]
        cts, mts = list(tensors[:n_c]), list(tensors[n_c:])
        consts = spec.consts([t.detach() for t in cts])
        M = spec.precond_fn(mts)
        if spec.opts[2]:  # symmetric: K^T = K
            op_T = lambda v: spec.fn(v, *consts)  # noqa: E731
        else:
            with torch.enable_grad():
                xv = [t.requires_grad_() for t in u_l]
                y = tree_leaves(spec.fn(tree_unflatten(xv, vtree), *consts))

            def op_T(v):  # the exact transpose of the linear apply at u
                return tree_unflatten(list(torch.autograd.grad(y, xv, tree_leaves(v), retain_graph=True)), vtree)

        # the forward preconditioner approximates K, not K^T; for GMRES it only
        # changes the path, not the answer, so it is reused
        lam = tree_leaves(_krylov(op_T, tree_unflatten(list(gbar), vtree), None, M, spec.opts))
        need = [ctx.needs_input_grad[3 + 2 * n_v + i] for i in range(n_c)]
        d_c = [None] * n_c
        if any(need):
            # d consts = -lambda^T (dK/d consts) u: one vector-Jacobian product
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() if nd else t.detach() for t, nd in zip(cts, need)]
                y = tree_leaves(spec.fn(tree_unflatten([t.detach() for t in u_l], vtree), *spec.consts(ins)))
                wrt = [t for t, nd in zip(ins, need) if nd]
                grads = iter(torch.autograd.grad(y, wrt, lam, allow_unused=True))
            for i, (t, nd) in enumerate(zip(ins, need)):
                if nd:
                    g = next(grads)
                    d_c[i] = -g if g is not None else torch.zeros_like(t)
        d_m = [torch.zeros_like(t) if ctx.needs_input_grad[3 + 2 * n_v + n_c + i] else None for i, t in enumerate(mts)]
        d_x0 = [torch.zeros_like(t) if ctx.needs_input_grad[3 + n_v + i] else None for i, t in enumerate(u_l)]
        return (None, None, None, *lam, *d_x0, *d_c, *d_m)


def linear_solve(
    fn,
    consts,
    b: torch.Tensor,
    *,
    x0: torch.Tensor | None = None,
    precond=None,
    precond_consts=(),
    tol: float = 1e-10,
    max_iters: int = 1000,
    symmetric: bool = True,
    restart: int = 50,
) -> torch.Tensor:
    """Solve ``fn(u, *consts) = b`` for ``u``, differentiably.

    ``fn(x, *consts)`` is the (constrained) operator apply and ``consts`` its
    data, exactly what ``system.operator_parts()`` returns.  Gradients flow to
    ``b`` and to the tensor leaves of ``consts`` by the adjoint method (one
    extra solve per backward pass); ``precond`` (``precond(r, *precond_consts)``,
    a ``setup_parts``-style pair) and ``x0`` get zero cotangents.
    ``symmetric=True`` (the LSFEM normal equations) runs CG both ways;
    ``symmetric=False`` runs GMRES(``restart``) forward and, backward, GMRES on
    the transpose of ``fn`` from ``torch.autograd``.

    Raises ``NotImplementedError`` when a const that requires grad reaches a
    hand-written CUDA kernel without a backward (ROADMAP.md).
    """
    squeeze = b.dim() == 1
    b2 = b[:, None] if squeeze else b
    x0 = torch.zeros_like(b2) if x0 is None else (x0[:, None] if squeeze else x0)
    spec = _Spec(fn, consts, precond, precond_consts, (float(tol), int(max_iters), bool(symmetric), int(restart)))
    cts, mts = spec.tensors()
    if torch.is_grad_enabled() and any(t.requires_grad for t in cts):
        with torch.enable_grad():  # a kernel that would take such a const raises here
            spec.fn(b2.detach(), *spec.consts(cts))
    b_l, vtree = tree_flatten(b2)
    u = tree_unflatten(list(_LinearSolve.apply(spec, len(cts), vtree, *b_l, *tree_leaves(x0), *cts, *mts)), vtree)
    return u[:, 0] if squeeze else u
