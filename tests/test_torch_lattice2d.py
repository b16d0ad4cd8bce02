"""The port's 2D lattice path and the non-fused lattice chain against the JAX
package, in f64 on the CPU.

* 2D: the reference's Diffusion2D problem (T, qx, qy; 4 equations; T = x on
  left/right, adiabatic top/bottom) on 3 x 2 quads at p = 3, with constant
  and with variable coefficients (k = 1 + x*y on the conservation row).  The
  port's AUTO takes ``lattice_sf_const`` / ``lattice_sf_var`` with ``direct``
  faces; the reference runs ``LATTICE_SF`` forced (its CPU AUTO never takes
  the lattice).  Applies in the dof and the lattice layout, the diagonal and
  the effective rhs, by default and with the per-QP kernel's lattice layout
  (``L3STER_TPU_LATTICE_PALLAS_QP=1``, its plain version here).
* 3D without the fused z-sweep (``L3STER_TPU_FUSED_Z=0``): the bench system
  at p = 2 on 2^3 hexes, constant and variable A.  The reference's CPU path
  is that chain too.
* The per-QP kernel's lattice layout (``ops/qp.py:qp_algebra_const_lattice``,
  plain version) against the TPU kernel ``qp_algebra_const_pallas`` in
  interpret mode, in 2D and 3D.

Tolerances: 1e-11 relative to max |reference| (tests/test_lattice_sf.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from bench import _adiabatic_3d, _diffusion_3d
from l3ster_tpu_torch.ops import lattice_sumfact as lsp
from l3ster_tpu_torch.ops.qp import qp_algebra_const_lattice
from tests.test_torch_system import _jax_apply, _port_mesh, _rel, jax_run
from tests.test_torch_var import _var_diffusion
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)

REL = 1e-11


def _diffusion2(inp, out, k=1.0):
    ops, _ = out
    A0, Ax, Ay = ops
    Ax[0, 1] = -k
    Ay[0, 2] = -k
    A0[1, 1] = -1.0
    Ax[1, 0] = 1.0
    A0[2, 2] = -1.0
    Ay[2, 0] = 1.0
    Ax[3, 2] = 1.0
    Ay[3, 1] = -1.0


def _diffusion2_var(inp, out):
    _diffusion2(inp, out, 1.0 + inp.point.x * inp.point.y)


def _adiabatic2(inp, out):
    ops, _ = out
    ops[0][0, 1] = inp.normal[0]
    ops[0][0, 2] = inp.normal[1]


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _source2(inp, out):
    _diffusion2(inp, out)
    _, rhs = out
    rhs[0] = 1.0  # a constant source, so the rhs pass has work


def _build(pkg, mesh, kernel):
    """2D (T = x on left/right, adiabatic top/bottom) or 3D (the bench's
    boundaries) matrix-free system; the reference forces LATTICE_SF."""
    dim = mesh.dim
    problem = pkg.ProblemDefinition(dim + 1, [0])
    bcs = pkg.BCDefinition(problem)
    dsides, nsides = ([3, 4], [1, 2]) if dim == 2 else ([5, 6], [1, 2, 3, 4])
    bcs.define_dirichlet(dsides, [0])
    params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
    if dim == 2:
        kd = pkg.wrap_domain_equation_kernel(kernel, pkg.KernelParams(2, 4, 3))
        kn = pkg.wrap_boundary_equation_kernel(_adiabatic2, pkg.KernelParams(2, 1, 3))
    else:
        kd = pkg.wrap_domain_equation_kernel(kernel, pkg.KernelParams(3, 7, 4))
        kn = pkg.wrap_boundary_equation_kernel(_adiabatic_3d, pkg.KernelParams(3, 1, 4))
    kdir = pkg.wrap_boundary_residual_kernel(_t_equals_x, pkg.KernelParams(dim, 1))
    if pkg is lt:
        system = lt.make_algebraic_system(mesh, problem, bcs, params)
        opts = lt.AssemblyOptions(eval_strategy=lt.LocalEvalStrategy.LATTICE_SF)
    else:
        system = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
        opts = lp.AssemblyOptions()
    system.set_dirichlet_bc_values(kdir, dsides, [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0], options=opts)
    system.assemble_problem(kn, nsides)
    system.end_assembly()
    return system


_MESH2 = lt.generate_mesh(
    lt.make_square_mesh(np.linspace(0.0, 1.0, 4), np.linspace(0.0, 0.8, 3)), order=3
)
_MESH3 = lt.generate_mesh(lt.make_cube_mesh(np.linspace(0.0, 1.0, 3)), order=2)
_KERNELS = {"const2": _source2, "var2": _diffusion2_var, "const3": _diffusion_3d, "var3": _var_diffusion}


@pytest.fixture(scope="module")
def reference():
    """The reference systems, one per kernel, built once."""
    return {k: _build(lt, _MESH2 if k.endswith("2") else _MESH3, f) for k, f in _KERNELS.items()}


@pytest.mark.parametrize(
    "case, env, kinds",
    [
        ("const2", {}, ["lattice_sf_const", "direct", "direct"]),
        ("const2", {"L3STER_TPU_LATTICE_PALLAS_QP": "1"}, ["lattice_sf_const", "direct", "direct"]),
        ("var2", {}, ["lattice_sf_var", "direct", "direct"]),
        ("const3", {"L3STER_TPU_FUSED_Z": "0"}, ["lattice_sf_const"] + ["face_banded"] * 4),
        (
            "const3",
            {"L3STER_TPU_FUSED_Z": "0", "L3STER_TPU_LATTICE_PALLAS_QP": "1"},
            ["lattice_sf_const"] + ["face_banded"] * 4,
        ),
        ("var3", {"L3STER_TPU_FUSED_Z": "false"}, ["lattice_sf_var"] + ["face_banded"] * 4),
    ],
)
def test_lattice_chain_matches_reference(reference, monkeypatch, case, env, kinds):
    """The operator in both layouts (two rhs columns), the diagonal and the
    effective rhs; the non-fused chain is the pipeline and the lattice key
    equals the reference's."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sj = reference[case]
    sp = _build(lp, _MESH2 if case.endswith("2") else _MESH3, _KERNELS[case])
    assert [d[0] for _, d in sp._operators()[1]] == kinds
    want = "chain_qp" if env.get("L3STER_TPU_LATTICE_PALLAS_QP") else "chain"
    assert sp._variant == want
    assert sp.lattice_layout_key() == sj.lattice_layout_key() is not None
    x = np.random.default_rng(7).standard_normal((sp.n_dofs, 2))
    fn, consts = sp.operator_parts()
    assert _rel(fn(torch.as_tensor(x), *consts), _jax_apply(sj, jnp.asarray(x))) < REL
    xl = np.array(sj.to_lattice_layout(jnp.asarray(x)))
    fl, cl = sp.operator_parts(layout="lattice")
    assert _rel(fl(torch.as_tensor(xl), *cl), _jax_apply(sj, jnp.asarray(xl), layout="lattice")) < REL
    assert _rel(sp.diagonal(), sj.diagonal()) < REL
    assert _rel(sp.effective_rhs(), sj.effective_rhs()) < REL


def test_lattice_qp_perm_and_sweeps_match_reference():
    """The 2D and 3D interleaved QP permutation, and the global interpolation
    and its transpose, against the reference's functions."""
    from l3ster_tpu.ops import lattice_sumfact as lsj

    rng = np.random.default_rng(3)
    for ne, order, qo in (((3, 2), 3, 4), ((2, 3, 2), 2, 3)):
        q1 = qo // 2 + 1
        E = int(np.prod(ne))
        inv = rng.permutation(E)
        np.testing.assert_array_equal(lsp.lattice_qp_perm(ne, q1, inv), lsj.lattice_qp_perm(ne, q1, inv))
        n1 = tuple(a * order + 1 for a in ne)
        t = rng.standard_normal((2,) + tuple(reversed(n1)))
        tabs_p = lsp._tabs(order, qo, ne, torch.float64, torch.device("cpu"))
        tabs_j = lsj._tabs(order, qo, ne, jnp.float64)
        v_p, d_p = lsp.lattice_interp(torch.as_tensor(t), tabs_p)
        v_j, d_j = jax_run(lambda t: lsj.lattice_interp(t, tabs_j), jnp.asarray(t))
        for a, b in zip((v_p,) + tuple(d_p), (v_j,) + tuple(d_j)):
            assert _rel(a, b) < REL
        qs = [rng.standard_normal(v_p.shape) for _ in range(len(ne) + 1)]
        y_p = lsp.lattice_transpose(torch.as_tensor(qs[0]), [torch.as_tensor(q) for q in qs[1:]], tabs_p)
        y_j = jax_run(lambda *q: lsj.lattice_transpose(q[0], q[1:], tabs_j), *(jnp.asarray(q) for q in qs))
        assert _rel(y_p, y_j) < REL


@pytest.mark.parametrize("dim, c, n_eq", [(2, 3, 4), (3, 4, 7)])
def test_qp_lattice_layout_matches_pallas(dim, c, n_eq):
    """The per-QP kernel's plain version on the (d1*c, EQ) lattice layout
    against the TPU kernel in interpret mode, with ~half of A zero."""
    from l3ster_tpu.ops.pallas_qp import qp_algebra_const_pallas

    rng = np.random.default_rng(dim)
    d1, EQ = dim + 1, 1000
    A = rng.standard_normal((d1, n_eq, c)) * (rng.uniform(size=(d1, n_eq, c)) > 0.5)
    g = rng.standard_normal((d1 * c, EQ))
    ji = rng.standard_normal((dim * dim, EQ)) * 0.2 + np.eye(dim).reshape(-1, 1)
    w = rng.uniform(0.5, 1.0, EQ)
    ref = jax_run(
        lambda g, ji, w: qp_algebra_const_pallas(A, g, ji, w, dim, c, block=256, interpret=True),
        *(jnp.asarray(a) for a in (g, ji, w)),
    )
    got = qp_algebra_const_lattice(A, *(torch.as_tensor(a) for a in (g, ji, w)))
    assert got.shape == (d1 * c, EQ)
    assert _rel(got, ref) < REL
