"""The port's gather-based matrix-free path on an unstructured mesh, against the JAX package.

3D diffusion (4 unknowns, 7 equations, constant coefficients) on a small
cylinder-in-channel mesh (304 hexes, p = 2, 13,320 dofs): Dirichlet T = x
from a boundary residual kernel on the inlet (3), the outlet (4) and the
cylinder (5), value-only adiabatic walls (1, 2) and caps (6, 7), in f64 on
the CPU.  The hexes are distorted (full J^-1), and the boundary kernels take
the direct path with the restricted node subsets.  The port's AUTO takes the
dense apply (``dense_const``) as the reference's does on its accelerator, so
it is held against the reference's DENSE_MXU.  Each reference system is
built once per module: its setup and first apply cost seconds.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d, _diffusion_3d
from tests.test_torch_system import jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit, xla_optimizations  # noqa: F401 (fixtures)

REL = 1e-11  # apply / diagonal / rhs, relative to max |reference| (the reference's oracles)

CYL = dict(
    distz=np.linspace(-1, 1, 3), left_offset=4.0, right_offset=6.0, bottom_offset=3.0,
    top_offset=3.0, n_circumf=16, n_radial=4, n_left=3, n_right=6, n_bottom=2, n_top=2,
)


def _diffusion_src(inp, out):
    _diffusion_3d(inp, out)
    _, rhs = out
    rhs[0] = 1.0  # a constant source, so the rhs pass has work
    rhs[5] = 0.5


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _rel(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _port_mesh(mesh):
    return lp.mesh_from_numpy(
        mesh.dim, mesh.n_nodes, mesh.node_coords,
        {did: [(b.element_type.name, b.order, b.nodes, b.vertices) for b in blks] for did, blks in mesh.domains.items()},
        mesh.boundary_ids,
    )


def build(pkg, mesh, strategy, dtype=torch.float64, device="cpu", dirichlet_values=True):
    """The cylinder problem in either package; the reference's AUTO maps to DENSE_MXU.
    ``dirichlet_values=False`` leaves the Dirichlet values at zero (the values
    kernel costs the reference seconds; the operator does not read them)."""
    problem = pkg.ProblemDefinition(4, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([3, 4, 5], [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
        strategy = "DENSE_MXU" if strategy == "AUTO" else strategy
    else:
        system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    kd = pkg.wrap_domain_equation_kernel(_diffusion_src, pkg.KernelParams(3, 7, 4))
    kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4))
    if dirichlet_values:
        kdir = pkg.wrap_boundary_residual_kernel(_t_equals_x, pkg.KernelParams(3, 1))
        system.set_dirichlet_bc_values(kdir, [3, 4, 5], [0])
    system.begin_assembly()
    system.assemble_problem(
        kd, [0], options=pkg.AssemblyOptions(eval_strategy=getattr(pkg.LocalEvalStrategy, strategy))
    )
    system.assemble_problem(kn, [1, 2, 6, 7])
    system.end_assembly()
    return system


def _jax_apply(system, x):
    fn, consts = system.operator_parts()
    return np.asarray(jax_run(fn, x, *consts))


@pytest.fixture(scope="module")
def meshes():
    mj = lt.generate_mesh(lt.make_cylinder_in_channel_3d(**CYL), order=2)
    mp = lp.generate_mesh(lp.make_cylinder_in_channel_3d(**CYL), order=2)
    return mj, mp


@pytest.fixture(scope="module")
def sumfact_pair(meshes):
    mj, mp = meshes
    return build(lt, mj, "SUM_FACT"), build(lp, mp, "SUM_FACT")


def test_cylinder_mesh_matches_reference(meshes):
    """The port's generator and generate_mesh (a silent lattice_renumber no-op
    here) give the reference's mesh array for array."""
    mj, mp = meshes
    assert mp.n_nodes == mj.n_nodes == 3330
    np.testing.assert_array_equal(mp.node_coords, mj.node_coords)
    assert sorted(mp.domains) == sorted(mj.domains) and mp.boundary_ids == mj.boundary_ids
    for did in mj.domains:
        for bj, bp in zip(mj.domains[did], mp.domains[did], strict=True):
            np.testing.assert_array_equal(bp.nodes, bj.nodes)
            np.testing.assert_array_equal(bp.vertices, bj.vertices)
    for bid in mj.boundary_ids:
        for vj, vp in zip(mj.boundary_views[bid], mp.boundary_views[bid], strict=True):
            assert (vp.parent_domain, vp.side) == (vj.parent_domain, vj.side)
            np.testing.assert_array_equal(vp.element_indices, vj.element_indices)
        np.testing.assert_array_equal(mp.boundary_nodes_of([bid]), mj.boundary_nodes_of([bid]))


def test_carried_mesh_gives_the_same_system(meshes):
    """A JAX-generated mesh rebuilt through interop.mesh_from_numpy gives the
    same port system as the port's own generator, dof for dof."""
    mj, mp = meshes
    s_own = build(lp, mp, "AUTO")
    s_carried = build(lp, _port_mesh(mj), "AUTO")
    assert s_own.n_dofs == s_carried.n_dofs == 13320
    np.testing.assert_array_equal(s_own.dirichlet_dofs, s_carried.dirichlet_dofs)
    for co, cc in zip(s_own._contribs, s_carried._contribs, strict=True):
        np.testing.assert_array_equal(co.elem_dofs, cc.elem_dofs)
    x = torch.as_tensor(np.random.default_rng(3).normal(size=(s_own.n_dofs, 1)))
    assert torch.equal(s_own.operator()(x), s_carried.operator()(x))
    assert torch.equal(s_own.effective_rhs(), s_carried.effective_rhs())


def test_kernel_dirichlet_values_match_reference(sumfact_pair):
    """T = x from a boundary residual kernel, averaged at the nodes shared by
    the cylinder, the inlet/outlet and the caps."""
    sj, sp = sumfact_pair
    np.testing.assert_array_equal(sp.dirichlet_dofs, sj.dirichlet_dofs)
    np.testing.assert_allclose(sp.dirichlet_values.numpy(), np.asarray(sj.dirichlet_values), rtol=0, atol=1e-14)
    nodes = sp.dofmap.node_dof[:, 0]
    on = np.isin(nodes, sp.dirichlet_dofs)
    x_at = sp.mesh.node_coords[on, 0]
    order = np.argsort(nodes[on])
    np.testing.assert_allclose(sp.dirichlet_values[:, 0].numpy(), x_at[order], rtol=0, atol=1e-14)


def test_boundary_values_at_nodes_device(meshes, monkeypatch):
    """compute_boundary_values_at_nodes runs on the card unless told otherwise:
    without CUDA and without a device it raises; with device="cpu" it gives
    T = x on exactly the nodes of the three boundaries."""
    from l3ster_tpu_torch.algsys.values_at_nodes import compute_boundary_values_at_nodes

    mp = meshes[1]
    kdir = lp.wrap_boundary_residual_kernel(_t_equals_x, lp.KernelParams(3, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_boundary_values_at_nodes(kdir, mp, [3, 4, 5])
    vals, mask = compute_boundary_values_at_nodes(kdir, mp, [3, 4, 5], device="cpu")
    assert vals.device.type == mask.device.type == "cpu" and tuple(vals.shape) == (mp.n_nodes, 1, 1)
    on = np.zeros(mp.n_nodes, bool)
    on[mp.boundary_nodes_of([3, 4, 5])] = True
    np.testing.assert_array_equal(mask.numpy(), on)
    np.testing.assert_allclose(vals[:, 0, 0].numpy()[on], mp.node_coords[on, 0], rtol=0, atol=1e-14)


@pytest.fixture(scope="module")
def dense_ref(meshes):
    """The reference's DENSE_MXU system, shared by the AUTO and DENSE_MXU cases."""
    return build(lt, meshes[0], "DENSE_MXU")


@pytest.mark.parametrize("strategy", ["AUTO", "DENSE_MXU", "SUM_FACT"])
def test_apply_diagonal_rhs_match_reference(request, meshes, sumfact_pair, strategy):
    """Operator apply, diagonal, rhs and effective rhs at 1e-11 with the kinds
    of the reference's ladder."""
    if strategy == "SUM_FACT":
        sj, sp = sumfact_pair
    else:
        sj, sp = request.getfixturevalue("dense_ref"), build(lp, meshes[1], strategy)
    kind = "sumfact_const" if strategy == "SUM_FACT" else "dense_const"
    assert [d[0] for _, d in sp._operators()[1]] == [kind] + ["direct"] * 4
    assert sp.lattice_layout_key() is None
    with pytest.raises(ValueError, match="lattice layout"):
        sp.operator_parts(layout="lattice")
    x = np.random.default_rng(1).normal(size=(sj.n_dofs, 1))
    assert _rel(sp.operator()(torch.as_tensor(x)), _jax_apply(sj, x)) < REL
    assert _rel(sp.diagonal(), sj.diagonal()) < REL
    assert _rel(sp.rhs, sj.rhs) < REL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < REL


def test_cg_jacobi_solve_matches_reference(sumfact_pair):
    """CG + Jacobi to a 1e-8 relative residual: the same iteration count
    within one, and the same solution."""
    sj, sp = sumfact_pair
    opts = dict(tol=1e-8, max_iters=5000)
    with xla_optimizations(True):  # hundreds of iterations of one compiled loop
        rj = sj.solve(lt.CG(lt.IterSolverOpts(**opts), precond=lt.Jacobi()))
    rp = sp.solve(lp.CG(lp.IterSolverOpts(**opts), precond=lp.Jacobi()))
    assert rp.converged and not rp.capped and rp.tol <= 1e-8
    assert abs(rp.num_iters - rj.num_iters) <= 1, (rp.num_iters, rj.num_iters)
    assert _rel(sp.x, sj.x) < 1e-7


def test_direct_volume_apply_and_variable_coefficients(meshes, sumfact_pair):
    """DIRECT runs the volume through the direct apply, which equals the
    sum-factorized one; a variable-coefficient kernel takes the dense and
    sum-factorized kinds with A stored per QP (``dense``, ``sumfact``), and
    each equals the direct apply of the same kernel."""
    _, sp = sumfact_pair
    sd = build(lp, meshes[1], "DIRECT")
    assert [d[0] for _, d in sd._operators()[1]] == ["direct"] * 5
    x = torch.as_tensor(np.random.default_rng(4).normal(size=(sp.n_dofs, 1)))
    assert _rel(sd.operator()(x), sp.operator()(x)) < REL

    def varying(inp, out):
        _diffusion_3d(inp, out)
        out.operators[0][1, 1] = -1.0 - 0.1 * inp.point.x

    problem = lp.ProblemDefinition(4, [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    ys = {}
    for strategy in ("DIRECT", "AUTO", "SUM_FACT"):
        s = lp.make_algebraic_system(meshes[1], problem, None, params, dtype=torch.float64, device="cpu")
        s.begin_assembly()
        s.assemble_problem(
            lp.wrap_domain_equation_kernel(varying, lp.KernelParams(3, 7, 4)), [0],
            options=lp.AssemblyOptions(eval_strategy=getattr(lp.LocalEvalStrategy, strategy)),
        )
        s.end_assembly()
        kind = s._operators()[1][0][1][0]
        assert kind == {"DIRECT": "direct", "AUTO": "dense", "SUM_FACT": "sumfact"}[strategy]
        ys[strategy] = s.operator()(x)
    assert _rel(ys["AUTO"], ys["DIRECT"]) < REL
    assert _rel(ys["SUM_FACT"], ys["DIRECT"]) < REL
