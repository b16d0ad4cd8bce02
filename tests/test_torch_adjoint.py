"""The port's differentiable solve (``linear_solve``) against the JAX package's,
in f64 on the CPU.

The five cases of ``tests/test_adjoint.py``: seeded numpy inputs go through
``jax.grad`` of the reference's ``linear_solve`` and through
``torch.autograd`` of the port's, and the gradients agree to 1e-10 relative
(both adjoint solves converge to 1e-14, far below that).  The last case
differentiates through a matrix-free LSFEM operator of each package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.solve.adjoint import linear_solve as linear_solve_j
from l3ster_tpu_torch.solve.adjoint import linear_solve as linear_solve_p
from tests.test_torch_system import _port_mesh
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

TOL = 1e-10


def _spd(n, rng):
    B = rng.normal(size=(n, n))
    return B @ B.T + n * np.eye(n)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(g_p, g_j):
    g_p, g_j = np.asarray(g_p), np.asarray(g_j)
    assert np.abs(g_p - g_j).max() <= TOL * max(1.0, np.abs(g_j).max())


def test_grad_theta_spd():
    """d loss / d theta for K(theta) u = b(theta), CG both ways."""
    rng = np.random.default_rng(0)
    n = 12
    K0, D = _spd(n, rng), _spd(n, rng)
    b0, w = rng.normal(size=n), rng.normal(size=n)

    def loss_j(theta):
        K = jnp.asarray(K0) + theta * jnp.asarray(D)
        u = linear_solve_j(lambda x, K: K @ x, (K,), jnp.asarray(b0) * (1.0 + theta), tol=1e-14, max_iters=500)
        return jnp.sum(jnp.asarray(w) * u) + jnp.sum(u**2)

    theta = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    K = _t(K0) + theta * _t(D)
    u = linear_solve_p(lambda x, K: K @ x, (K,), _t(b0) * (1.0 + theta), tol=1e-14, max_iters=500)
    loss = torch.sum(_t(w) * u) + torch.sum(u**2)
    loss.backward()
    _close(theta.grad.item(), jax.grad(loss_j)(0.3))
    assert abs(loss.item() - float(loss_j(0.3))) < 1e-10


def test_grad_rhs():
    """d(w.u)/db is the adjoint solution K^-T w."""
    rng = np.random.default_rng(1)
    n = 10
    K, b, w = _spd(n, rng), rng.normal(size=n), rng.normal(size=n)
    g_j = jax.grad(
        lambda bb: jnp.sum(jnp.asarray(w) * linear_solve_j(lambda x, K: K @ x, (jnp.asarray(K),), bb, tol=1e-14))
    )(jnp.asarray(b))
    bp = _t(b).requires_grad_()
    torch.sum(_t(w) * linear_solve_p(lambda x, K: K @ x, (_t(K),), bp, tol=1e-14)).backward()
    _close(bp.grad.numpy(), g_j)


def test_grad_nonsymmetric_gmres():
    """symmetric=False: GMRES forward, the transpose of the apply backward."""
    rng = np.random.default_rng(2)
    n = 9
    A = _spd(n, rng) + 2.0 * rng.normal(size=(n, n))
    b = rng.normal(size=n)
    kw = dict(tol=1e-13, max_iters=400, symmetric=False, restart=20)
    g_j = jax.grad(
        lambda K: jnp.sum(linear_solve_j(lambda x, K: K @ x, (K,), jnp.asarray(b), **kw) ** 3)
    )(jnp.asarray(A))
    Ap = _t(A).requires_grad_()
    torch.sum(linear_solve_p(lambda x, K: K @ x, (Ap,), _t(b), **kw) ** 3).backward()
    g_j = np.asarray(g_j)
    assert np.abs(Ap.grad.numpy() - g_j).max() <= TOL * np.abs(g_j).max()


def test_precond_and_x0_get_zero_cotangent():
    """The preconditioner's consts and x0 get exactly zero gradients."""
    rng = np.random.default_rng(3)
    n = 8
    K, b = _spd(n, rng), rng.normal(size=n)
    dinv = _t(1.0 / np.diag(K)).requires_grad_()
    x0 = torch.zeros(n, dtype=torch.float64, requires_grad=True)
    perm = torch.arange(n)
    u = linear_solve_p(
        lambda x, K: K @ x, (_t(K),), _t(b), x0=x0,
        precond=lambda r, d, p: d[p][:, None] * r, precond_consts=(dinv, perm), tol=1e-14,
    )
    u_j = linear_solve_j(lambda x, K: K @ x, (jnp.asarray(K),), jnp.asarray(b), tol=1e-14)
    _close(u.detach().numpy(), u_j)
    g_d, g_x0 = torch.autograd.grad(torch.sum(u**2), (dinv, x0))
    assert g_d.abs().max().item() == 0.0 and g_x0.abs().max().item() == 0.0


def _kern(inp, out):
    ops, _ = out
    A0, Ax, Ay = ops
    Ax[0, 1] = -1.0
    Ay[0, 2] = -1.0
    A0[1, 1] = -1.0
    Ax[1, 0] = 1.0
    A0[2, 2] = -1.0
    Ay[2, 0] = 1.0
    Ax[3, 2] = 1.0
    Ay[3, 1] = -1.0


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _system(pkg, mesh):
    """The reference test's matrix-free 2D diffusion: T = x on left/right."""
    problem = pkg.ProblemDefinition(3, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([3, 4], [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
    else:
        system = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
    kd = pkg.wrap_domain_equation_kernel(_kern, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
    system.set_dirichlet_bc_values(
        pkg.wrap_boundary_residual_kernel(_t_equals_x, pkg.KernelParams(dimension=2, n_equations=1)), [3, 4], [0]
    )
    system.begin_assembly()
    system.assemble_problem(kd, [0])
    system.end_assembly()
    return system


def test_system_operator_parts_differentiable():
    """The gradient of ||u(s) - u*||^2, with the free part of the rhs scaled
    by s, through each package's matrix-free operator (the port's runs the 2D
    lattice chain), against the reference's and the closed form."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 4)), order=2)
    sj, sp = _system(lt, mesh), _system(lp, mesh)
    assert [d[0] for _, d in sp._operators()[1]] == ["lattice_sf_const"]

    fn_j, cj = sj.operator_parts()
    b_j = sj.effective_rhs()
    g_dir_j = b_j * (1.0 - sj.free_mask[:, None])
    u1_j = jax.jit(lambda b: linear_solve_j(fn_j, cj, b, tol=1e-14, max_iters=2000))(b_j)
    u_star_j = 0.75 * (u1_j - g_dir_j) + g_dir_j
    g_j = jax.jit(
        jax.grad(
            lambda s: jnp.sum(
                (linear_solve_j(fn_j, cj, s * (b_j - g_dir_j) + g_dir_j, tol=1e-14, max_iters=2000) - u_star_j) ** 2
            )
        )
    )(1.2)

    fn_p, cp = sp.operator_parts()
    b_p = sp.effective_rhs()
    g_dir_p = b_p * (1.0 - sp.free_mask[:, None])
    u1_p = linear_solve_p(fn_p, cp, b_p, tol=1e-14, max_iters=2000)
    _close(u1_p.numpy(), u1_j)
    u_star_p = 0.75 * (u1_p - g_dir_p) + g_dir_p
    s = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    u = linear_solve_p(fn_p, cp, s * (b_p - g_dir_p) + g_dir_p, tol=1e-14, max_iters=2000)
    torch.sum((u - u_star_p) ** 2).backward()
    g_ref = 2.0 * (1.2 - 0.75) * float(torch.sum((u1_p - g_dir_p) ** 2))
    assert abs(s.grad.item() - float(g_j)) <= TOL * abs(float(g_j))
    assert abs(s.grad.item() - g_ref) <= 1e-8 * abs(g_ref)


def test_consts_gradient_of_plain_kind():
    """A gradient with respect to a tensor inside a matrix-free system's
    operator data (the 2D lattice chain's weights w, plain torch): against
    central differences of the solve."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 3)), order=2)
    sp = _system(lp, mesh)
    fn, (ops,) = sp.operator_parts()
    c, d = ops[0]
    b = sp.effective_rhs()

    def loss(scale):
        ops_s = [(c, d[:4] + (d[4] * scale,))]
        return torch.sum(linear_solve_p(fn, (ops_s,), b, tol=1e-14, max_iters=2000) ** 2)

    s = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    loss(s).backward()
    h = 1e-5
    fd = (loss(torch.tensor(1.1 + h, dtype=torch.float64)) - loss(torch.tensor(1.1 - h, dtype=torch.float64))) / (2 * h)
    assert abs(s.grad.item() - fd.item()) <= 1e-6 * abs(fd.item())


if __name__ == "__main__":
    pytest.main([__file__, "-v"])
