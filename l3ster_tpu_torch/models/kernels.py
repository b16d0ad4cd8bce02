"""Canonical PDE kernel library (PyTorch port of ``l3ster_tpu.models.kernels``).

Ready-made first-order LSFEM systems mirroring the reference's example and
test kernels (``tests/Kernels.hpp``, ``examples/02..07``): diffusion (2D/3D,
constant and field-dependent conductivity), linear advection, and
incompressible Navier-Stokes in velocity-vorticity-pressure form.  Each
factory returns wrapped kernels ready for ``assemble_problem``.
"""

from __future__ import annotations

from ..common.kernel import (
    KernelParams,
    wrap_boundary_equation_kernel,
    wrap_boundary_residual_kernel,
    wrap_domain_equation_kernel,
)

__all__ = [
    "diffusion_2d",
    "diffusion_2d_variable",
    "diffusion_3d",
    "adiabatic_bc_2d",
    "adiabatic_bc_3d",
    "advection_bdf_2d",
    "navier_stokes_uvop_2d",
    "navier_stokes_outlet_bc",
    "flow_rate_bc",
]


def diffusion_2d(conductivity: float = 1.0, source: float = 0.0):
    """First-order Poisson system: unknowns (T, qx, qy); 4 equations."""

    def fn(inp, out):
        ops, rhs = out
        A0, Ax, Ay = ops
        Ax[0, 1] = -conductivity
        Ay[0, 2] = -conductivity
        rhs[0] = source
        A0[1, 1] = -1.0
        Ax[1, 0] = 1.0
        A0[2, 2] = -1.0
        Ay[2, 0] = 1.0
        Ax[3, 2] = 1.0
        Ay[3, 1] = -1.0

    return wrap_domain_equation_kernel(fn, KernelParams(dimension=2, n_equations=4, n_unknowns=3))


def diffusion_2d_variable():
    """Variable-conductivity diffusion: lambda supplied as external field 0
    (``tests/Kernels.hpp`` diffusion_kernel_2D_var)."""

    def fn(inp, out):
        lam = inp.field_vals[0]
        dl_dx = inp.field_ders[0, 0]
        dl_dy = inp.field_ders[1, 0]
        ops, rhs = out
        A0, Ax, Ay = ops
        A0[0, 1] = -dl_dx
        A0[0, 2] = -dl_dy
        Ax[0, 1] = -lam
        Ay[0, 2] = -lam
        A0[1, 1] = -1.0
        Ax[1, 0] = 1.0
        A0[2, 2] = -1.0
        Ay[2, 0] = 1.0
        Ax[3, 2] = 1.0
        Ay[3, 1] = -1.0

    return wrap_domain_equation_kernel(
        fn, KernelParams(dimension=2, n_equations=4, n_unknowns=3, n_fields=1)
    )


def diffusion_3d(conductivity: float = 1.0, source: float = 0.0):
    """3D first-order Poisson system: (T, qx, qy, qz); 7 equations."""

    def fn(inp, out):
        ops, rhs = out
        A0, Ax, Ay, Az = ops
        Ax[0, 1] = -conductivity
        Ay[0, 2] = -conductivity
        Az[0, 3] = -conductivity
        rhs[0] = source
        A0[1, 1] = -1.0
        Ax[1, 0] = 1.0
        A0[2, 2] = -1.0
        Ay[2, 0] = 1.0
        A0[3, 3] = -1.0
        Az[3, 0] = 1.0
        Ay[4, 3] = 1.0
        Az[4, 2] = -1.0
        Ax[5, 3] = -1.0
        Az[5, 1] = 1.0
        Ax[6, 2] = 1.0
        Ay[6, 1] = -1.0

    return wrap_domain_equation_kernel(fn, KernelParams(dimension=3, n_equations=7, n_unknowns=4))


def adiabatic_bc_2d():
    def fn(inp, out):
        ops, _ = out
        ops[0][0, 1] = inp.normal[0]
        ops[0][0, 2] = inp.normal[1]

    return wrap_boundary_equation_kernel(fn, KernelParams(dimension=2, n_equations=1, n_unknowns=3))


def adiabatic_bc_3d():
    def fn(inp, out):
        ops, _ = out
        ops[0][0, 1] = inp.normal[0]
        ops[0][0, 2] = inp.normal[1]
        ops[0][0, 3] = inp.normal[2]

    return wrap_boundary_equation_kernel(fn, KernelParams(dimension=3, n_equations=1, n_unknowns=4))


def advection_bdf_2d(velocity, dt: float, bdf_leading: float, bdf_coefs):
    """Implicit advection step (BDF time stepping); history in fields 0..k-1."""
    u, v = velocity
    k = len(bdf_coefs)

    def fn(inp, out):
        ops, rhs = out
        A0, Ax, Ay = ops
        A0[0, 0] = bdf_leading
        Ax[0, 0] = u * dt
        Ay[0, 0] = v * dt
        acc = 0.0
        for i, c in enumerate(bdf_coefs):
            acc = acc + c * inp.field_vals[i]
        rhs[0] = acc

    return wrap_domain_equation_kernel(
        fn, KernelParams(dimension=2, n_equations=1, n_unknowns=1, n_fields=k)
    )


def navier_stokes_uvop_2d(nu: float, dt: float | None = None):
    """Incompressible Navier-Stokes, velocity-vorticity-pressure form.

    Unknowns (u, v, omega, p); Newton/Picard linearization around the field
    velocities.  Steady variant (dt None, 2 fields: u, v) or BDF2 transient
    (dt given, 4 fields: u1, v1, u2, v2 with extrapolated advection velocity),
    mirroring ``examples/07-karman-2D/source.cpp``.
    """
    IU, IV, IO, IP = 0, 1, 2, 3

    def fill_steady(ops, rhs, u, v, du_dx, dv_dx, du_dy, dv_dy):
        A0, Ax, Ay = ops
        A0[0, IU] = du_dx
        A0[0, IV] = du_dy
        Ax[0, IU] = u
        Ax[0, IP] = 1.0
        Ay[0, IU] = v
        Ay[0, IO] = nu
        rhs[0] = u * du_dx + v * du_dy

        A0[1, IU] = dv_dx
        A0[1, IV] = dv_dy
        Ax[1, IV] = u
        Ax[1, IO] = -nu
        Ay[1, IV] = v
        Ay[1, IP] = 1.0
        rhs[1] = u * dv_dx + v * dv_dy

        Ax[2, IU] = 1.0
        Ay[2, IV] = 1.0

        A0[3, IO] = 1.0
        Ax[3, IV] = -1.0
        Ay[3, IU] = 1.0

    if dt is None:

        def fn(inp, out):
            u, v = inp.field_vals[0], inp.field_vals[1]
            du_dx, dv_dx = inp.field_ders[0, 0], inp.field_ders[0, 1]
            du_dy, dv_dy = inp.field_ders[1, 0], inp.field_ders[1, 1]
            ops, rhs = out
            fill_steady(ops, rhs, u, v, du_dx, dv_dx, du_dy, dv_dy)

        return wrap_domain_equation_kernel(
            fn, KernelParams(dimension=2, n_equations=4, n_unknowns=4, n_fields=2)
        )

    def fn(inp, out):
        u1, v1, u2, v2 = (inp.field_vals[i] for i in range(4))
        du1_dx, dv1_dx, du2_dx, dv2_dx = (inp.field_ders[0, i] for i in range(4))
        du1_dy, dv1_dy, du2_dy, dv2_dy = (inp.field_ders[1, i] for i in range(4))
        u, v = 2 * u1 - u2, 2 * v1 - v2
        du_dx, dv_dx = 2 * du1_dx - du2_dx, 2 * dv1_dx - dv2_dx
        du_dy, dv_dy = 2 * du1_dy - du2_dy, 2 * dv1_dy - dv2_dy
        ops, rhs = out
        fill_steady(ops, rhs, u, v, du_dx, dv_dx, du_dy, dv_dy)
        # BDF2 time derivative on the momentum equations
        ops[0][0, IU] = ops[0][0, IU] + 1.5 / dt
        ops[0][1, IV] = ops[0][1, IV] + 1.5 / dt
        rhs[0] = rhs[0] + (2 * u1 - 0.5 * u2) / dt
        rhs[1] = rhs[1] + (2 * v1 - 0.5 * v2) / dt
        # scale the momentum equations by dt for conditioning
        for op in ops:
            for unk in range(4):
                for eq in range(2):
                    op[eq, unk] = op[eq, unk] * dt
        rhs[0] = rhs[0] * dt
        rhs[1] = rhs[1] * dt

    return wrap_domain_equation_kernel(
        fn, KernelParams(dimension=2, n_equations=4, n_unknowns=4, n_fields=4)
    )


def navier_stokes_outlet_bc(nu: float):
    """Open-outlet traction BC on (u, v, p) -- assemble with dof_inds (0,1,3)."""

    def fn(inp, out):
        nx, ny = inp.normal[0], inp.normal[1]
        ops, _ = out
        A0, Ax, Ay = ops
        A0[0, 2] = -nx
        Ax[0, 0] = nu * nx
        Ay[0, 0] = nu * ny
        A0[1, 2] = -ny
        Ax[1, 1] = nu * nx
        Ay[1, 1] = nu * ny

    return wrap_boundary_equation_kernel(fn, KernelParams(dimension=2, n_equations=2, n_unknowns=3))


def flow_rate_bc():
    """Boundary flux integrand u.n (fields 0, 1 = velocity)."""

    def fn(inp, out):
        out[0] = inp.field_vals[0] * inp.normal[0] + inp.field_vals[1] * inp.normal[1]

    return wrap_boundary_residual_kernel(fn, KernelParams(dimension=2, n_equations=1, n_fields=2))
