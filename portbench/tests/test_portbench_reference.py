"""The plain reference against the program's own outputs, on the CPU at tiny sizes (float64)."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import l3ster_tpu_torch as lp
from portbench.problems.diffusion3d import Case
from portbench.reference import cylinder3d_p4_mf, diffusion3d_p6_mf
from portbench.tests._tiny import REPO, TINY

CASES = {
    "diffusion3d_p6_mf": (diffusion3d_p6_mf, "constants", [5, 6], [1, 2, 3, 4]),
    "cylinder3d_p4_mf": (cylinder3d_p4_mf, "kernel", [3, 4, 5], [1, 2, 6, 7]),
}


def _cfg(name, order=None, derivative_order=None):
    """The configuration's tiny copy in float64, with its own quadrature
    (``value_order``, ``derivative_order``) unless one is given."""
    mod, how, dirichlet, adiabatic = CASES[name]
    with open(os.path.join(REPO, "portbench", "configs", f"{name}.json")) as f:
        real = json.load(f)
    cfg = dict(TINY[name], problem="diffusion3d", dtype="float64", eval_strategy="AUTO", adiabatic=adiabatic,
               dirichlet={"boundaries": dirichlet, "how": how}, value_order=real["value_order"],
               derivative_order=real["derivative_order"] if derivative_order is None else derivative_order)
    if order is not None:
        cfg.update(order=order)
    return mod, cfg


def _spans(name):
    return contextlib.nullcontext()


@pytest.mark.parametrize("name,order,derivative_order", [("diffusion3d_p6_mf", 2, None), ("diffusion3d_p6_mf", 3, None),
                                                          ("diffusion3d_p6_mf", 3, 1), ("cylinder3d_p4_mf", 2, None)])
def test_reference_operator_matches_program(name, order, derivative_order):
    """The reference's float64 operator equals the program's unconstrained
    operator on a random vector, under the configuration's quadrature and
    another, and both hold the same Dirichlet nodes."""
    mod, cfg = _cfg(name, order, derivative_order)
    case = Case(lp, cfg, torch.device("cpu"), _spans)
    judge = mod.build(cfg, "cpu")
    coords, node_dof = case.answer_labels()
    perm = torch.as_tensor(judge.match(coords))
    x = torch.as_tensor(np.random.default_rng(7).normal(size=(case.system.n_dofs, 1)))
    y = case.system.raw_operator()(x)[:, 0]
    X = torch.empty((judge.n, 4), dtype=torch.float64)
    Y = torch.empty_like(X)
    X[perm], Y[perm] = x[torch.as_tensor(node_dof), 0], y[torch.as_tensor(node_dof)]
    assert float((judge.op.apply(X) - Y).abs().max() / Y.abs().max()) < 1e-12
    program_dir = set(np.asarray(case.system.dirichlet_dofs).tolist())
    ref_dir = set(node_dof[np.argsort(judge.match(coords))][judge.dir.numpy(), 0].tolist())
    assert program_dir == ref_dir


@pytest.mark.parametrize("name", sorted(CASES))
def test_exact_solution_has_zero_reference_residual(name):
    """T = a + b x, q = (b, 0, 0) solves the reference's own normal equations."""
    mod, cfg = _cfg(name)
    judge = mod.build(cfg, "cpu")
    got = judge.judge(judge.exact(0.3, 1.7), 0.3, 1.7)
    assert got["err"] == 0.0 and got["res"] < 1e-12


@pytest.mark.parametrize("name", sorted(CASES))
def test_program_solve_judged_sound(name):
    """A float64 solve of the program to a tight tolerance reads err and res near rounding."""
    mod, cfg = _cfg(name)
    case = Case(lp, cfg, torch.device("cpu"), _spans)
    case.set_request(-0.4, 1.3)
    r = case.system.solve(lp.CG(lp.IterSolverOpts(tol=1e-12, max_iters=20000), precond=lp.Jacobi()))
    assert r.converged
    judge = mod.build(cfg, "cpu")
    coords, node_dof = case.answer_labels()
    X = torch.empty((judge.n, 4), dtype=torch.float64)
    X[torch.as_tensor(judge.match(coords))] = case.system.x[torch.as_tensor(node_dof), 0]
    got = judge.judge(X, -0.4, 1.3)
    assert got["err"] < 1e-8 and got["res"] < 1e-8


def test_match_refuses_a_moved_node():
    mod, cfg = _cfg("diffusion3d_p6_mf")
    judge = mod.build(cfg, "cpu")
    coords = judge.coords.copy()
    coords[5] += 1e-6
    with pytest.raises(ValueError):
        judge.match(coords)
