"""The port's mesh IO, domain splitting, VTK and native IO against the JAX
package, on the CPU.

* ``read_gmsh`` on the reference tests' meshes (``tests/test_io.py``: MSH 2.2
  and 4.1, ASCII and binary, and the orientation-fix case): node
  coordinates, blocks and boundary views equal; a solve on the imported mesh
  within 1e-10 of the reference's.
* ``split_domain`` as ``tests/test_multidomain.py``: the same split, and the
  piecewise-quadratic solve on it, exact to 1e-8 and within 1e-10 of the
  reference's, assembled and matrix-free.
* VTK: one field set gives byte-identical .vtu/.pvtu files in both packages,
  single-piece and sharded (a parts dict from ``partition_mesh_elements``).
* Native IO: a checkpoint written by either package loads in the other, with
  the mesh and the fields exactly equal.
* ``make_half_cylinder_in_channel_2d`` gives the reference's mesh.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.mesh.split import split_domain as split_domain_j
from l3ster_tpu.parallel.partition import partition_mesh_elements as partition_j
from l3ster_tpu_torch.parallel.partition import partition_mesh_elements as partition_p
from tests.test_io import GMSH_V2, GMSH_V4, _write_gmsh_v2_binary, _write_gmsh_v4_binary
from tests.test_multidomain import DOM_R
from tests.test_torch_system import _port_mesh
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)


def _same_mesh(mp, mj):
    assert (mp.dim, mp.n_nodes) == (mj.dim, mj.n_nodes)
    np.testing.assert_array_equal(mp.node_coords, mj.node_coords)
    assert tuple(mp.boundary_ids) == tuple(mj.boundary_ids)
    assert sorted(mp.domains) == sorted(mj.domains)
    for did in mj.domains:
        for bp, bj in zip(mp.domains[did], mj.domains[did], strict=True):
            assert (bp.element_type.name, bp.order) == (bj.element_type.name, bj.order)
            np.testing.assert_array_equal(bp.nodes, bj.nodes)
            np.testing.assert_array_equal(bp.vertices, bj.vertices)
    assert sorted(mp.boundary_views) == sorted(mj.boundary_views)
    for bid in mj.boundary_views:
        for vp, vj in zip(mp.boundary_views[bid], mj.boundary_views[bid], strict=True):
            assert (vp.parent_domain, vp.side) == (vj.parent_domain, vj.side)
            np.testing.assert_array_equal(vp.element_indices, vj.element_indices)


def _write_msh(case, path):
    if case == "v2":
        path.write_text(GMSH_V2)
    elif case == "v4":
        path.write_text(GMSH_V4)
    elif case == "v2_binary":
        _write_gmsh_v2_binary(path)
    elif case == "v4_binary":
        _write_gmsh_v4_binary(path)
    else:  # a negatively oriented quad, which the reader flips
        path.write_text(GMSH_V2.replace("1 3 2 10 1 1 2 5 4", "1 3 2 10 1 1 4 5 2"))


@pytest.mark.parametrize("case", ["v2", "v4", "v2_binary", "v4_binary", "flipped"])
def test_read_gmsh_matches_reference(tmp_path, case):
    p = tmp_path / "square.msh"
    _write_msh(case, p)
    _same_mesh(lp.read_gmsh(str(p), boundary_ids=[1, 2, 3, 4]), lt.read_gmsh(str(p), boundary_ids=[1, 2, 3, 4]))


def _diffusion2(pkg, source=0.0):
    def fn(inp, out):
        ops, rhs = out
        A0, Ax, Ay = ops
        Ax[0, 1] = -1.0
        Ay[0, 2] = -1.0
        rhs[0] = source
        A0[1, 1] = -1.0
        Ax[1, 0] = 1.0
        A0[2, 2] = -1.0
        Ay[2, 0] = 1.0
        Ax[3, 2] = 1.0
        Ay[3, 1] = -1.0

    return pkg.wrap_domain_equation_kernel(fn, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))


def _flux_bc(pkg):
    def fn(inp, out):
        ops, _ = out
        ops[0][0, 1] = inp.normal[0]
        ops[0][0, 2] = inp.normal[1]

    return pkg.wrap_boundary_equation_kernel(fn, pkg.KernelParams(dimension=2, n_equations=1, n_unknowns=3))


def _system(pkg, mesh, problem, bcs, strategy=None):
    params = pkg.AlgebraicSystemParams(
        eval_strategy=strategy or pkg.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY
    )
    if pkg is lt:
        return lt.make_algebraic_system(mesh, problem, bcs, params)
    return lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")


def test_gmsh_solve_matches_reference(tmp_path):
    """The reference's end-to-end solve on the imported MSH 2.2 square at p =
    2 (T = x/2 on left/right, adiabatic top/bottom, Klu2)."""
    p = tmp_path / "square.msh"
    p.write_text(GMSH_V2)
    mesh = lt.generate_mesh(lt.read_gmsh(str(p), boundary_ids=[1, 2, 3, 4]), order=2)
    _same_mesh(lp.generate_mesh(lp.read_gmsh(str(p), boundary_ids=[1, 2, 3, 4]), order=2), mesh)
    xs = []
    for pkg in (lt, lp):
        problem = pkg.ProblemDefinition(3, [10])
        bcs = pkg.BCDefinition(problem)
        bcs.define_dirichlet([3, 4], [0])
        system = _system(pkg, mesh, problem, bcs)
        kdir = pkg.wrap_boundary_residual_kernel(
            lambda i, o: o.__setitem__(0, i.point.x / 2.0), pkg.KernelParams(dimension=2, n_equations=1)
        )
        system.set_dirichlet_bc_values(kdir, [3, 4], [0])
        system.begin_assembly()
        system.assemble_problem(
            _diffusion2(pkg), [10], options=pkg.AssemblyOptions(value_order=1, derivative_order=0)
        )
        system.assemble_problem(_flux_bc(pkg), [1, 2])
        system.end_assembly()
        system.solve(pkg.Klu2())
        xs.append(np.asarray(system.x))
    assert np.abs(xs[1] - xs[0]).max() < 1e-10
    T = xs[1].reshape(-1, 3)[:, 0]
    assert np.abs(T - mesh.node_coords[:, 0] / 2.0).max() < 1e-10


@pytest.mark.parametrize("strategy", ["GLOBAL_ASSEMBLY", "MATRIX_FREE"])
def test_split_domain_matches_reference(strategy):
    """``tests/test_multidomain.py``: x = 0.5 splits the square; the solve
    with sources 0 and 2 hits the piecewise quadratic exactly."""
    base = lt.make_square_mesh(np.linspace(0, 1, 5))
    mj = split_domain_j(base, 0, lambda c: c[:, 0] > 0.5, DOM_R)
    mp = lp.split_domain(_port_mesh(base), 0, lambda c: c[:, 0] > 0.5, DOM_R)
    _same_mesh(mp, mj)
    mesh = lt.generate_mesh(mj, order=2)
    _same_mesh(lp.generate_mesh(mp, order=2), mesh)
    xs = []
    for pkg in (lt, lp):
        problem = pkg.ProblemDefinition(3)
        problem.define([0, DOM_R])
        bcs = pkg.BCDefinition(problem)
        bcs.define_dirichlet([3], [0])
        system = _system(pkg, mesh, problem, bcs, getattr(pkg.OperatorEvaluationStrategy, strategy))
        system.set_dirichlet_bc_values([0.0], [3], [0])
        system.begin_assembly()
        system.assemble_problem(_diffusion2(pkg, 0.0), [0])
        system.assemble_problem(_diffusion2(pkg, 2.0), [DOM_R])
        system.assemble_problem(_flux_bc(pkg), [1, 2, 4])
        system.end_assembly()
        assert system.solve(pkg.CG(pkg.IterSolverOpts(tol=1e-13, max_iters=4000), precond=pkg.Jacobi())).converged
        xs.append(np.asarray(system.x))
    assert np.abs(xs[1] - xs[0]).max() < 1e-10
    x = mesh.node_coords[:, 0]
    T = xs[1].reshape(-1, 3)[:, 0]
    assert np.abs(T - np.where(x <= 0.5, x, 2 * x - x * x - 0.25)).max() < 1e-8


def _managers(mesh, n_slots=2):
    mj = lt.SolutionManager(mesh, n_slots)
    mp = lp.SolutionManager(_port_mesh(mesh), n_slots, device="cpu")
    vals = np.stack([mesh.node_coords[:, 0] ** 2 + 0.1 * mesh.node_coords[:, 1], np.full(mesh.n_nodes, 3.0)], 1)
    for m in (mj, mp):
        m.set_field([0, 1], vals[:, :n_slots])
    return mj, mp


def test_vtk_payloads_match_reference(tmp_path):
    """Single-piece .pvtu + .vtu, and a sharded export on 4 parts from each
    package's partitioner: the files are byte-identical."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0, 1, 5)), order=2)
    mj, mp = _managers(mesh)
    for pkg, man, tag in ((lt, mj, "j"), (lp, mp, "p")):
        d = pkg.ExportDefinition(str(tmp_path / tag / "out.pvtu"))
        d.define_field("xsq", [0]).define_field("pair", [0, 1])
        pkg.PvtuExporter(man.mesh).export_solution(d, man)
        ds = pkg.ExportDefinition(str(tmp_path / tag / "sharded.pvtu")).define_field("xsq", [0])
        parts = (partition_j if pkg is lt else partition_p)(man.mesh, 4)
        pkg.PvtuExporter(man.mesh).export_solution_sharded(ds, man, partition=parts)
    names = sorted(f.name for f in (tmp_path / "j").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "p").iterdir())
    assert len(names) == 2 + 1 + 4
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n
    txt = (tmp_path / "p" / "out.vtu").read_text()
    assert 'NumberOfCells="64"' in txt  # 16 quads at p = 2: 64 linear subcells


def test_native_io_cross_package(tmp_path):
    """Each package loads the other's checkpoint: mesh and fields exactly."""
    mesh = lt.generate_mesh(lt.make_cube_mesh(np.linspace(0, 1, 3)), order=2)
    mj, mp = _managers(mesh)
    pj = lt.save(str(tmp_path / "by_jax"), mesh, mj, field_names=["xsq", "three"])
    pp = lp.save(str(tmp_path / "by_torch"), mp.mesh, mp, field_names=["xsq", "three"])
    for path in (pj, pp):
        mesh_p, man_p = lp.load(path, device="cpu")
        mesh_j, man_j = lt.load(path)
        _same_mesh(mesh_p, mesh)
        _same_mesh(mesh_j, mesh)
        assert lp.Loader(path).field_names == ["xsq", "three"]
        assert man_p.values.dtype == torch.float64 and man_p.device.type == "cpu"
        np.testing.assert_array_equal(man_p.values.numpy(), np.asarray(mj.values))
        np.testing.assert_array_equal(np.asarray(man_j.values), mp.values.numpy())
    man32 = lp.Loader(pp).solution_manager(dtype=torch.float32, device="cpu")
    assert man32.values.dtype == torch.float32


def test_half_cylinder_mesh_matches_reference():
    _same_mesh(lp.make_half_cylinder_in_channel_2d(), lt.make_half_cylinder_in_channel_2d())
    _same_mesh(
        lp.make_half_cylinder_in_channel_2d(n_circumf=16, n_radial=3, n_left=2, n_right=4, n_top=2),
        lt.make_half_cylinder_in_channel_2d(n_circumf=16, n_radial=3, n_left=2, n_right=4, n_top=2),
    )
