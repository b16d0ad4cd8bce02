"""The port's field-coupled stack against the JAX package, in f64 on the CPU.

The reference's small Karman case (``tests/test_pmg.py:_cyl_mesh(order=2)``,
288 quads at p = 2, ``tests/test_karman.py::test_karman_mini``'s physics):
the Navier-Stokes kernels of ``models/kernels.py`` evaluated with fields,
field interpolation to the QPs, ``update_solution`` and ``set_values``, the
assembled K and F with field access and their ``Klu2`` solve, the
matrix-free variable-coefficient ``dense`` (reference forced to DENSE_MXU,
the algorithm the port's AUTO picks) and ``sumfact`` (both SUM_FACT)
applies, ``compute_integral``/``compute_norm_l2``, and a mini Karman run (2
Picard and 2 BDF2 steps with ``Klu2``).  Fields are seeded numpy arrays
handed to both packages (``interop.solution_manager_from_numpy``); the mesh
is one mesh for both (``_port_mesh``).  The reference's matrix-free system
is built once per module and reassembled by the tests that need it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.algsys import local as lj
from l3ster_tpu.models import kernels as kj
from l3ster_tpu_torch.algsys import local as lpl
from l3ster_tpu_torch.models import kernels as kp
from tests.test_pmg import _cyl_mesh
from tests.test_torch_system import _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

DOMAIN, BOTTOM, TOP, INLET, OUTLET, CYLINDER = 0, 1, 2, 3, 4, 5
NU, DT = 1.0 / 50.0, 0.2
KERNEL_TOL = 1e-12  # kernels, fields, K, F, integrals: relative to max |reference|
APPLY_TOL = 1e-11  # matrix-free apply, diagonal, effective rhs


def flow_fields(mesh, seed: int) -> np.ndarray:
    """(n_nodes, 6) seeded fields: two velocity levels near the inlet's
    parabola, vorticity and pressure noise."""
    rng = np.random.default_rng(seed)
    y = mesh.node_coords[:, 1]
    H = y.max()
    u = 1.5 * (1.0 - (y / H) ** 2)
    vals = rng.normal(scale=0.05, size=(mesh.n_nodes, 6))
    vals[:, 0] += u
    vals[:, 2] += u
    return vals


def managers(mesh, pmesh, values):
    """The same (n_nodes, n_slots) fields in a reference and a port manager."""
    mj = lt.SolutionManager(mesh, values.shape[1])
    mj.values = jnp.asarray(values)
    return mj, lp.interop.solution_manager_from_numpy(pmesh, values, device="cpu")


def karman_system(pkg, mesh, strategy=None):
    """The mini Karman problem (``tests/test_karman.py::test_karman_mini``):
    Dirichlet u, v on the inlet (parabola), walls and cylinder."""
    H = float(np.max(mesh.node_coords[:, 1]))
    problem = pkg.ProblemDefinition(4, [DOMAIN])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([INLET, BOTTOM, TOP, CYLINDER], [0, 1])
    params = pkg.AlgebraicSystemParams() if strategy is None else pkg.AlgebraicSystemParams(eval_strategy=strategy)
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
    else:
        system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device="cpu")

    def prof(i, o):
        o[0] = 1.5 * (1.0 - (i.point.y / H) ** 2)
        o[1] = 0.0

    ki = pkg.wrap_boundary_residual_kernel(prof, pkg.KernelParams(dimension=2, n_equations=2))
    system.set_dirichlet_bc_values([0.0, 0.0], [BOTTOM, TOP, CYLINDER], [0, 1])
    system.set_dirichlet_bc_values(ki, [INLET], [0, 1])
    return system


def _ns_kernels(pkg):
    """(steady, BDF2, outlet) kernels of a package, made once, as a stepping
    loop makes them (the reference's operator caches key on the kernel)."""
    kmod = kj if pkg is lt else kp
    return kmod.navier_stokes_uvop_2d(NU), kmod.navier_stokes_uvop_2d(NU, dt=DT), kmod.navier_stokes_outlet_bc(NU)


NS_KERNELS = {lt: _ns_kernels(lt), lp: _ns_kernels(lp)}


def assemble(pkg, system, man, slots, transient, local_strategy=None):
    """The steady (fields u, v) or BDF2 (fields u1, v1, u2, v2) operator and the outlet."""
    steady, bdf2, outlet = NS_KERNELS[pkg]
    kw = {} if local_strategy is None else dict(eval_strategy=getattr(pkg.LocalEvalStrategy, local_strategy))
    system.begin_assembly()
    system.assemble_problem(
        bdf2 if transient else steady, [DOMAIN], man.field_access(slots),
        options=pkg.AssemblyOptions(value_order=1, derivative_order=1, **kw),
    )
    system.assemble_problem(outlet, [OUTLET], dof_inds=(0, 1, 3))
    system.end_assembly()


@pytest.fixture(scope="module")
def meshes():
    mesh = _cyl_mesh(order=2)
    return mesh, _port_mesh(mesh)


@pytest.fixture(scope="module")
def mf_pair(meshes):
    """The matrix-free mini Karman system in both packages (Dirichlet values
    set, nothing assembled): tests reassemble it."""
    mesh, pmesh = meshes
    return (
        karman_system(lt, mesh, lt.OperatorEvaluationStrategy.MATRIX_FREE),
        karman_system(lp, pmesh, lp.OperatorEvaluationStrategy.MATRIX_FREE),
    )


# -------------------------------------------------------------- kernels, fields


def _bucket(mesh, boundary):
    """(tables pair, vertices, nodes) of the first 12 elements of the volume
    block, or of the outlet's first boundary view."""
    blk = mesh.domains[DOMAIN][0]
    qo = lt.AssemblyOptions(value_order=1, derivative_order=1).quadrature_order(blk.order)
    if boundary:
        bv = mesh.boundary_views[OUTLET][0]
        sel, parent = bv.element_indices[:12], bv.parent_block
        args = (parent.element_type, parent.order, bv.side, qo)
        return (lj.side_tables(*args), lpl.side_tables(*args)), parent.vertices[sel], parent.nodes[sel]
    args = (blk.element_type, blk.order, qo)
    return (lj.domain_tables(*args), lpl.domain_tables(*args)), blk.vertices[:12], blk.nodes[:12]


KERNELS = {
    "steady": (lambda m: m.navier_stokes_uvop_2d(NU), False, 2),
    "transient": (lambda m: m.navier_stokes_uvop_2d(NU, dt=DT), False, 4),
    "outlet": (lambda m: m.navier_stokes_outlet_bc(NU), True, 0),
    "flow_rate": (lambda m: m.flow_rate_bc(), True, 2),
    "diffusion_2d_variable": (lambda m: m.diffusion_2d_variable(), False, 1),
    "advection_bdf_2d": (lambda m: m.advection_bdf_2d((1.0, 0.5), DT, 1.5, (2.0, -0.5)), False, 2),
}


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernels_with_fields_match_reference(meshes, name):
    """Each kernel of ``models/kernels.py`` at the QPs of 12 elements (or
    outlet sides) with the same nodal fields: field values and gradients
    (``eval_fields``), A and f (or the residual), to 1e-12."""
    factory, boundary, n_fields = KERNELS[name]
    mesh, _ = meshes
    (tj, tp), verts, nodes = _bucket(mesh, boundary)
    nodal = np.random.default_rng(len(name)).normal(size=nodes.shape + (max(n_fields, 1),))[:, :, :n_fields]
    kj_, kp_ = factory(kj), factory(kp)
    residual = name == "flow_rate"

    def ref(v, f):
        g = lj.element_geometry(tj, v)
        fv, fd = lj.eval_fields(tj, g, f) if n_fields else (None, None)
        if residual:
            out = (lj.eval_residual_kernel(kj_, g, fv, fd, 0.0, jnp.float64),)
        else:
            out = lj.eval_equation_kernel(kj_, g, fv, fd, 0.0, jnp.float64)
        return ((fv, fd) if n_fields else ()) + tuple(out)

    g = lpl.element_geometry(tp, torch.as_tensor(verts))
    fv, fd = lpl.eval_fields(tp, g, torch.as_tensor(nodal)) if n_fields else (None, None)
    got = ((fv, fd) if n_fields else ()) + (
        (lpl.eval_residual_kernel(kp_, g, fv, fd, 0.0),) if residual else lpl.eval_equation_kernel(kp_, g, fv, fd, 0.0)
    )
    want = jax_run(ref, verts, nodal)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= KERNEL_TOL * np.abs(b).max()  # exact where the reference is 0


def test_update_solution_and_set_values_exact(meshes, mf_pair):
    """``update_solution`` copies solution components into manager slots,
    ``set_values`` sets solution values and ``set_fields_from_kernel``
    manager slots from a domain kernel at nodes: the same values as the
    reference, exactly."""
    mesh, pmesh = meshes
    sj, sp = mf_pair
    x = np.random.default_rng(5).normal(size=(sj.n_dofs, 1))
    sj.set_solution_vector(jnp.asarray(x))
    sp.set_solution_vector(torch.as_tensor(x))
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 6))
    for pkg_sys, man in ((sj, mj), (sp, mp)):
        pkg_sys.update_solution([0, 1, 2, 3], man, [2, 3, 4, 5])
    np.testing.assert_array_equal(mp.values.numpy(), np.asarray(mj.values))

    def init(i, o):
        o[0] = i.point.x + 2.0 * i.point.y
        o[1] = i.point.x * i.point.y

    for pkg, s, man in ((lt, sj, mj), (lp, sp, mp)):
        k = pkg.wrap_domain_residual_kernel(init, pkg.KernelParams(2, 2))
        s.set_values(k, [DOMAIN], [0, 3])
        man.set_fields_from_kernel(k, [DOMAIN], [1, 5])
    np.testing.assert_array_equal(sp.x.numpy(), np.asarray(sj.x))
    np.testing.assert_array_equal(mp.values.numpy(), np.asarray(mj.values))


# ----------------------------------------------------------- assembled, Klu2


@pytest.fixture(scope="module")
def assembled_pair(meshes):
    """The steady operator with field access, assembled in both packages."""
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 7))
    sj, sp = karman_system(lt, mesh), karman_system(lp, pmesh)
    assemble(lt, sj, mj, [0, 1], transient=False)
    assemble(lp, sp, mp, [0, 1], transient=False)
    return sj, sp


def test_assembled_with_fields_matches_reference(assembled_pair):
    """K (the CSR values) and F of the field-coupled steady operator, to 1e-12."""
    sj, sp = assembled_pair
    assert isinstance(sp, lp.AssembledSystem) and sp.nnz == sj.nnz
    assert _rel(sp.data, sj.data) < KERNEL_TOL
    assert _rel(sp.rhs, sj.rhs) < KERNEL_TOL


def test_klu2_matches_reference(assembled_pair):
    """``Klu2`` (host SuperLU) on the eliminated system: x to 1e-10; the
    port's ``Lapack`` (host dense solve) gives the same x."""
    sj, sp = assembled_pair
    rj, rp = sj.solve(lt.Klu2()), sp.solve(lp.Klu2())
    assert rp.tol < 1e-10 and rj.tol < 1e-10
    assert _rel(sp.x, sj.x) < 1e-10
    assert sp.solve(lp.Lapack()).tol < 1e-10
    assert _rel(sp.x, sj.x) < 1e-10


# ------------------------------------------------------- matrix-free var kinds


@pytest.mark.parametrize(
    "ref_strategy,port_strategy,kind", [("DENSE_MXU", "AUTO", "dense"), ("SUM_FACT", "SUM_FACT", "sumfact")]
)
def test_matrix_free_var_apply_matches_reference(meshes, mf_pair, ref_strategy, port_strategy, kind):
    """The BDF2 operator with four fields, matrix-free: the port takes the
    variable-coefficient ``dense``/``sumfact`` kind; apply, diagonal and
    effective rhs (the field-carrying rhs pass) to 1e-11."""
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 8))
    sj, sp = mf_pair
    assemble(lt, sj, mj, [0, 1, 2, 3], transient=True, local_strategy=ref_strategy)
    assemble(lp, sp, mp, [0, 1, 2, 3], transient=True, local_strategy=port_strategy)
    assert [d[0] for _, d in sp._operators()[1]] == [kind, "direct"]
    x = np.random.default_rng(9).normal(size=(sj.n_dofs, 2))
    fn, consts = sj.operator_parts()
    assert _rel(sp.operator()(torch.as_tensor(x)), jax_run(fn, x, *consts)) < APPLY_TOL
    assert _rel(sp.diagonal(), sj.diagonal()) < APPLY_TOL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < APPLY_TOL


# --------------------------------------------------------------- integrals


def test_integrals_match_reference(meshes):
    """Flow rates through inlet and outlet (``flow_rate_bc`` with field
    access), a domain integral and an L2 norm, to 1e-12."""
    mesh, pmesh = meshes
    mj, mp = managers(mesh, pmesh, flow_fields(mesh, 10))

    def speed2(i, o):
        o[0] = i.field_vals[0] ** 2 + i.field_vals[1] ** 2
        o[1] = i.field_ders[0, 0] + i.field_ders[1, 1]

    for ids in ([INLET], [OUTLET]):
        got = lp.compute_integral(kp.flow_rate_bc(), pmesh, ids, mp.field_access([0, 1]))
        assert got.device.type == "cpu"
        assert _rel(got, lt.compute_integral(kj.flow_rate_bc(), mesh, ids, mj.field_access([0, 1]))) < KERNEL_TOL
    kpj = lt.wrap_domain_residual_kernel(speed2, lt.KernelParams(2, 2, n_fields=2))
    kpp = lp.wrap_domain_residual_kernel(speed2, lp.KernelParams(2, 2, n_fields=2))
    for fj, fp in ((lt.compute_integral, lp.compute_integral), (lt.compute_norm_l2, lp.compute_norm_l2)):
        want = jax_run(lambda v: fj(kpj, mesh, [DOMAIN], lt.FieldAccess(v, (2, 3))), mj.values)
        assert _rel(fp(kpp, pmesh, [DOMAIN], mp.field_access([2, 3])), want) < KERNEL_TOL


# ---------------------------------------------------------------- mini run


def test_karman_mini_run_matches_reference(meshes, assembled_pair):
    """``test_karman_mini``'s loop, shortened: 2 Picard and 2 BDF2 steps
    with the assembled system (the module's, reassembled) and ``Klu2``; all
    six fields to 1e-9."""
    mesh, pmesh = meshes
    out = []
    for pkg, m, system in ((lt, mesh, assembled_pair[0]), (lp, pmesh, assembled_pair[1])):
        man = pkg.SolutionManager(m, 6) if pkg is lt else lp.SolutionManager(m, 6, device="cpu")
        vel1, vel2 = [0, 1], [2, 3]
        for _ in range(2):
            assemble(pkg, system, man, vel1, transient=False)
            system.solve(pkg.Klu2())
            system.update_solution([0, 1], man, vel1)
        system.update_solution([0, 1, 2, 3], man, vel2 + [4, 5])
        for _ in range(2):
            assemble(pkg, system, man, vel1 + vel2, transient=True)
            system.solve(pkg.Klu2())
            system.update_solution([0, 1, 2, 3], man, vel2 + [4, 5])
            vel1, vel2 = vel2, vel1
        out.append(np.asarray(man.values))
    assert np.isfinite(out[1]).all()
    assert _rel(out[1], out[0]) < 1e-9
