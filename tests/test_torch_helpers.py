"""The port's last public helpers against the JAX package, in f64 on the CPU.

``local_apply_sumfact`` (pack, then the packed sum-factorized apply),
``corner_map_tables``, ``map_to_physical``, ``physical_basis_derivatives``,
``lagrange_diff_matrix``, ``required_quadrature_order``, ``raw_operator`` of
the matrix-free and assembled systems (and its raise on a
``DistributedSystem``), and the call form of the wrapped kernels.  Inputs are
made with numpy from a seed; every comparison is at 1e-12 of max |reference|.
"""

import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from tests.test_torch_system import _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-12


def _verts(et, E: int, seed: int) -> np.ndarray:
    """Perturbed unit elements of type et, corners in lexicographic order (x
    fastest): (E, n_verts, 3)."""
    dim = 3 if et == lt.ElementType.HEX else 2
    corners = np.array([[(i >> a) & 1 for a in range(dim)] for i in range(2**dim)], dtype=float)
    rng = np.random.default_rng(seed)
    v = np.zeros((E, len(corners), 3))
    v[:, :, :dim] = corners + 0.1 * rng.normal(size=(E,) + corners.shape)
    return v


@pytest.mark.parametrize("dim", [2, 3])
def test_local_apply_sumfact_matches_reference(dim):
    """Per-QP A (E, Q, d1, n_eq, c) through pack + packed apply, both packages."""
    from l3ster_tpu.algsys.local import domain_tables as dt_j, element_geometry as eg_j
    from l3ster_tpu.algsys.local import local_apply_sumfact as ref_apply
    from l3ster_tpu_torch.algsys.local import domain_tables, element_geometry, local_apply_sumfact

    order, E, c, n_eq = 2, 3, 2, 3
    qo = lp.AssemblyOptions().quadrature_order(order)
    et = lt.ElementType.HEX if dim == 3 else lt.ElementType.QUAD
    verts = _verts(et, E, dim)
    rng = np.random.default_rng(dim)
    Q = (qo // 2 + 1) ** dim
    A = rng.normal(size=(E, Q, dim + 1, n_eq, c))
    x = rng.normal(size=(E, (order + 1) ** dim, c))
    geom_j = eg_j(dt_j(et, order, qo), verts, with_phys_ders=False)
    ref = jax_run(lambda A, x: ref_apply(A, geom_j, order, qo, dim, x), A, x)
    geom = element_geometry(domain_tables(lp.ElementType[et.name], order, qo), torch.as_tensor(verts), False)
    got = local_apply_sumfact(torch.as_tensor(A), geom, order, qo, dim, torch.as_tensor(x))
    assert got.shape == x.shape and _rel(got, ref) < REL


@pytest.mark.parametrize("name", ["HEX", "QUAD"])
def test_geometry_helpers_match_reference(name):
    """corner_map_tables, map_to_physical and physical_basis_derivatives."""
    from l3ster_tpu.mapping import geometry as gj
    from l3ster_tpu_torch.mapping import geometry as gp

    dim = 3 if name == "HEX" else 2
    rng = np.random.default_rng(dim)
    pts = rng.uniform(-1.0, 1.0, (5, dim))
    key = (np.ascontiguousarray(pts).tobytes(), pts.shape)
    (N1j, dN1j), (N1p, dN1p) = gj.corner_map_tables(lt.ElementType[name], key), gp.corner_map_tables(
        lp.ElementType[name], key
    )
    np.testing.assert_array_equal(N1p, N1j)
    np.testing.assert_array_equal(dN1p, dN1j)
    verts = _verts(lt.ElementType[name], 1, dim)[0, :, :dim]
    assert _rel(gp.map_to_physical(N1p, torch.as_tensor(verts)), gj.map_to_physical(N1j, verts)) < REL
    J = np.einsum("qjv,vi->qij", dN1j, verts)  # (n_pts, dim, dim), dx_i/dxi_j
    ref_ders = rng.normal(size=(5, dim, 7))
    ref = gj.physical_basis_derivatives(J, ref_ders)
    assert _rel(gp.physical_basis_derivatives(torch.as_tensor(J), ref_ders), ref) < REL


def test_lagrange_and_quadrature_helpers_match_reference():
    from l3ster_tpu.math.lagrange import lagrange_diff_matrix as ldm_j
    from l3ster_tpu.quadrature.rules import required_quadrature_order as rqo_j
    from l3ster_tpu_torch.math.lagrange import lagrange_diff_matrix
    from l3ster_tpu_torch.quadrature.rules import required_quadrature_order

    nodes = np.cos(np.linspace(np.pi, 0.0, 6))
    np.testing.assert_array_equal(lagrange_diff_matrix(nodes), ldm_j(nodes))
    for p in range(0, 8):
        for vo, do in ((1, 1), (2, 1), (1, 0), (0, 2)):
            assert required_quadrature_order(p, vo, do) == rqo_j(p, vo, do)


def _diffusion_2d(inp, out):
    ops, _ = out
    A0, Ax, Ay = ops
    Ax[0, 1] = Ay[0, 2] = Ax[1, 0] = Ay[2, 0] = Ax[3, 2] = 1.0
    A0[1, 1] = A0[2, 2] = Ay[3, 1] = -1.0


def _square_system(pkg, mesh, strategy):
    problem = pkg.ProblemDefinition(3, [0])
    bcs = pkg.BCDefinition(problem)
    bcs.define_dirichlet([3, 4], [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=strategy(pkg))
    kw = {} if pkg is lt else dict(dtype=torch.float64, device="cpu")
    system = pkg.make_algebraic_system(mesh, problem, bcs, params, **kw)
    system.begin_assembly()
    system.assemble_problem(pkg.wrap_domain_equation_kernel(_diffusion_2d, pkg.KernelParams(2, 4, 3)), [0])
    system.end_assembly()
    return system


@pytest.mark.parametrize("strategy", ["MATRIX_FREE", "GLOBAL_ASSEMBLY"])
def test_raw_operator_matches_reference(strategy):
    """raw_operator of both systems on a 3^2-quad p = 2 square: the
    unconstrained operator, against the reference's and the port's raw_parts."""
    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 4)), order=2)
    pick = lambda pkg: getattr(pkg.OperatorEvaluationStrategy, strategy)  # noqa: E731
    sj, sp = _square_system(lt, mesh, pick), _square_system(lp, _port_mesh(mesh), pick)
    x = np.random.default_rng(3).normal(size=(sj.n_dofs, 1))
    got = sp.raw_operator()(torch.as_tensor(x))
    fn, consts = sp.raw_parts()
    assert torch.equal(got, fn(torch.as_tensor(x), *consts))
    assert _rel(got, jax_run(sj.raw_operator(), x)) < REL


def test_raw_operator_raises_on_distributed_system():
    mesh = lp.generate_mesh(lp.make_square_mesh(np.linspace(0.0, 1.0, 5)), order=1)
    problem = lp.ProblemDefinition(3, [0])
    dist = lp.make_distributed_system(mesh, problem, n_shards=2, dtype=torch.float64, device="cpu")
    with pytest.raises(NotImplementedError):
        dist.raw_operator()


def test_kernel_call_form_matches_evaluate():
    """EquationKernel and ResidualKernel calls: evaluate with float64 on the
    named device, as the reference's call is its evaluate."""

    def residual(inp, out):
        out[0] = inp.point.x * 2.0

    kd = lp.wrap_domain_equation_kernel(_diffusion_2d, lp.KernelParams(2, 4, 3))
    kr = lp.wrap_domain_residual_kernel(residual, lp.KernelParams(2, 1))
    kd_j = lt.wrap_domain_equation_kernel(_diffusion_2d, lt.KernelParams(2, 4, 3))
    kr_j = lt.wrap_domain_residual_kernel(residual, lt.KernelParams(2, 1))
    pt = np.array([0.5, 0.25, 0.0])
    inp = lp.DomainInput(torch.zeros(1), torch.zeros(2, 1), lp.SpaceTimePoint(torch.as_tensor(pt), torch.tensor(0.0)))
    inp_j = lt.DomainInput(np.zeros(1), np.zeros((2, 1)), lt.SpaceTimePoint(pt, 0.0))
    (ops, rhs), (ref_ops, ref_rhs) = kd(inp, device="cpu"), kd_j(inp_j)
    assert ops.dtype == torch.float64 and _rel(ops, ref_ops) < REL
    np.testing.assert_array_equal(rhs, ref_rhs)
    assert all(torch.equal(a, b) for a, b in zip((ops, rhs), kd.evaluate(inp, torch.float64, "cpu")))
    got = kr(inp, torch.float32, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, kr.evaluate(inp, torch.float32, "cpu"))
    assert _rel(kr(inp, device="cpu"), kr_j(inp_j)) < REL
