"""The Karman study's Picard sweeps in float32 on the CPU, in either package, with the reference's solver settings.

The steady Picard start of ``strouhal_study(matrix_free=True)``
(``examples/karman_2d.py:131-250``): the Strouhal configuration at a given
``refine``, p = 3, Re = 100, a matrix-free float32 system, and each sweep
solved with CG + Jacobi at the reference's settings (tol 1e-6, max_iters
6,000, chunk 1,024; ``examples/karman_2d.py:233``).  Each run imports one
package only, so the reference and the port are two runs of this script::

    python3 tools/karman_picard_witness.py --impl jax   [--refine 1]
    python3 tools/karman_picard_witness.py --impl torch [--refine 1]

Prints one JSON line per sweep (8 of them):
the iterations, CG's recursive relative residual, the true relative
residual ||b - A x|| / ||b|| in float32 (what a restart sees), the same in
float64 (a float64 twin of the system assembled from the same fields, applied
to the float32 solution), and whether the sweep hit its cap; then one summary
line.  Everything runs on the CPU, the port with ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

RE, Y_B, Y_T = 100.0, -2.0, 2.1
SWEEPS, TOL, MAX_ITERS, CHUNK = 8, 1e-6, 6000, 1024
DOMAIN, BOTTOM, TOP, INLET, OUTLET, CYLINDER = 0, 1, 2, 3, 4, 5


def mesh_kw(refine: int) -> dict:
    """``make_cylinder_in_channel_2d`` arguments of ``strouhal_study(refine=...)``."""
    rf = int(refine)
    return dict(
        r_outer=1.2, left_offset=2.0, right_offset=10.0, bottom_offset=-Y_B, top_offset=Y_T,
        n_circumf=32 * rf, n_radial=7 * rf, n_left=3 * rf, n_right=17 * rf, n_bottom=3 * rf, n_top=3 * rf,
        q_radial=1.28 ** (1.0 / rf), q_right=1.06 ** (1.0 / rf),
    )


def _package(impl: str):
    """(package, kernels module, make_system(mesh, dtype), make_manager(mesh),
    float32, float64, to_f64_numpy)."""
    if impl == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        import jax.numpy as jnp

        import l3ster_tpu as pkg
        from l3ster_tpu.models import kernels

        def make_system(mesh, problem, bcs, params, dtype):
            return pkg.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype)

        def make_manager(mesh):
            return pkg.SolutionManager(mesh, 6)

        return pkg, kernels, make_system, make_manager, jnp.float32, jnp.float64, lambda a: np.asarray(a, np.float64)
    import torch

    import l3ster_tpu_torch as pkg
    from l3ster_tpu_torch.models import kernels

    def make_system(mesh, problem, bcs, params, dtype):
        return pkg.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device="cpu")

    def make_manager(mesh):
        return pkg.SolutionManager(mesh, 6, device="cpu")

    return (pkg, kernels, make_system, make_manager, torch.float32, torch.float64,
            lambda a: a.detach().cpu().double().numpy())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("jax", "torch"), required=True)
    ap.add_argument("--refine", type=int, default=1)
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    pkg, kernels, make_system, make_manager, f32, f64, to_np = _package(args.impl)

    mesh = pkg.generate_mesh(pkg.make_cylinder_in_channel_2d(**mesh_kw(args.refine)), order=3)
    problem = pkg.ProblemDefinition(4, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([INLET, BOTTOM, TOP, CYLINDER], [0, 1])
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)

    def inlet_profile(inp, out):
        y = inp.point.y
        out[0] = 6.0 * (y - Y_B) * (Y_T - y) / (Y_T - Y_B) ** 2
        out[1] = 0.0

    k_inlet = pkg.wrap_boundary_residual_kernel(inlet_profile, pkg.KernelParams(dimension=2, n_equations=2))
    systems = []
    for dtype in (f32, f64):
        s = make_system(mesh, problem, bcs, params, dtype)
        s.set_dirichlet_bc_values([0.0, 0.0], [BOTTOM, TOP, CYLINDER], [0, 1])
        s.set_dirichlet_bc_values(k_inlet, [INLET], [0, 1])
        systems.append(s)
    s32, s64 = systems
    man = make_manager(mesh)
    nu = 1.0 / RE
    k_steady, k_outlet = kernels.navier_stokes_uvop_2d(nu), kernels.navier_stokes_outlet_bc(nu)
    opts = pkg.AssemblyOptions(value_order=1, derivative_order=1)
    solver = pkg.CG(pkg.IterSolverOpts(tol=TOL, max_iters=MAX_ITERS, chunk=CHUNK), precond=pkg.Jacobi())

    def rel(system, x):
        b = to_np(system.effective_rhs())
        r = b - to_np(system.operator()(x))
        return float(np.linalg.norm(r) / np.linalg.norm(b))

    n_capped, t0 = 0, time.perf_counter()
    for k in range(SWEEPS):
        for s in systems:
            s.begin_assembly()
            s.assemble_problem(k_steady, [DOMAIN], man.field_access([0, 1]), options=opts)
            s.assemble_problem(k_outlet, [OUTLET], dof_inds=(0, 1, 3))
            s.end_assembly()
        t1 = time.perf_counter()
        r = s32.solve(solver)
        x32 = s32.solution_vector()
        x64 = x32.astype(f64) if args.impl == "jax" else x32.to(f64)
        n_capped += bool(r.capped)
        print(json.dumps(dict(
            impl=args.impl, sweep=k + 1, iterations=int(r.num_iters), cg_rel_residual=float(r.tol),
            true_rel_residual_f32=rel(s32, x32), true_rel_residual_f64=rel(s64, x64),
            converged=bool(r.converged), capped=bool(r.capped), solve_s=time.perf_counter() - t1,
        )), flush=True)
        s32.update_solution([0, 1], man, [0, 1])
    print(json.dumps(dict(
        script="tools/karman_picard_witness.py", impl=args.impl, device="cpu", refine=args.refine,
        n_dofs=int(s32.n_dofs), dtype="float32", tol=TOL, max_iters=MAX_ITERS, chunk=CHUNK,
        sweeps=SWEEPS, capped=n_capped, total_s=time.perf_counter() - t0,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
