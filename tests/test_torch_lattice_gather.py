"""The port's lattice slicing gathers against the JAX package's (``ops/lattice.py``).

In f64 on the CPU, on random values: ``lattice_gather`` and its transpose
``lattice_scatter_add`` on 2D and 3D lattices at p = 1-3, with the canonical
element order and a shuffled one; the face gathers of every side of a 3D and
a 2D lattice (``face_gather``/``face_scatter_pad`` on node rows,
``face_gather_tensor``/``face_scatter_tensor_add`` on the channel-leading
tensor, and a named plane as the box decomposition's windows use); and the
matrix-free systems' use of them (a lattice block under DENSE_MXU, the 2D
lattice's direct faces in both layouts) within 1e-11 of the reference's
apply.  The gathers move values without arithmetic, so they agree exactly;
the overlap-adds sum two values per shared node in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import l3ster_tpu as lt
import l3ster_tpu_torch as lp
from l3ster_tpu.ops import lattice as lj
from l3ster_tpu_torch.ops import lattice as lpt
from tests.test_torch_system import _port_mesh, _rel, jax_run
from tests.torch_reference_fixtures import fast_reference_compiles, per_test_limit  # noqa: F401 (fixtures)


def _jit(fn, x, *static):
    """The reference's ``fn(x, *static)``, jitted (eager dispatch costs seconds)."""
    return jax.jit(lambda v: fn(v, *static))(jnp.asarray(x))


def _plan(ne, order, shuffle):
    """A lattice plan of ``ne`` elements per axis, its element order shuffled
    (a non-canonical block order) or canonical."""
    n1 = tuple(e * order + 1 for e in ne)
    E = int(np.prod(ne))
    if not shuffle:
        return n1, tuple(ne), None, None
    eidx = np.random.default_rng(E).permutation(E).astype(np.int32)
    inv = np.empty(E, dtype=np.int32)
    inv[eidx] = np.arange(E)
    return n1, tuple(ne), eidx, inv


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("ne,order", [((3, 2), 1), ((2, 3), 3), ((2, 3, 2), 2), ((3, 2, 2), 3)])
def test_lattice_gather_and_scatter_match_reference(ne, order, shuffle):
    plan = _plan(ne, order, shuffle)
    rng = np.random.default_rng(order)
    x = rng.normal(size=(int(np.prod(plan[0])), 3))
    got = lpt.lattice_gather(torch.as_tensor(x), plan, order)
    ref = np.asarray(_jit(lj.lattice_gather, x, plan, order))
    np.testing.assert_array_equal(got.numpy(), ref)
    y = rng.normal(size=ref.shape)
    got = lpt.lattice_scatter_add(torch.as_tensor(y), plan, order)
    ref = np.asarray(_jit(lj.lattice_scatter_add, y, plan, order))
    np.testing.assert_array_equal(got.numpy(), ref)


def _face_plans(ne, order):
    """The slicing plan of every full side of a lattice of ``ne`` elements."""
    dim = len(ne)
    n = order + 1
    vol = _plan(ne, order, False)
    lat = np.arange(n**dim)
    coords = (lat % n, (lat // n) % n, lat // (n * n)) if dim == 3 else (lat % n, lat // n)
    E = int(np.prod(ne))
    ex = np.arange(E) % ne[0]
    rest = np.arange(E) // ne[0]
    ecoords = (ex, rest % ne[1], rest // ne[1]) if dim == 3 else (ex, rest)
    out = []
    for side in range(2 * dim):
        axis, hi = side // 2, side % 2
        ns = np.nonzero(coords[axis] == (order if hi else 0))[0]
        sel = np.nonzero(ecoords[axis] == (ne[axis] - 1 if hi else 0))[0]
        fp = lj.detect_face_plan(vol, order, dim, side, sel, ns, n**dim)
        assert fp is not None and fp == lpt.detect_face_plan(vol, order, dim, side, sel, ns, n**dim)
        out.append(fp)
    return vol, out


@pytest.mark.parametrize("ne,order", [((2, 3), 2), ((2, 2, 3), 2), ((3, 2, 2), 3)])
def test_face_gathers_match_reference(ne, order):
    vol, fps = _face_plans(ne, order)
    n1 = vol[0]
    c = 2
    rng = np.random.default_rng(len(ne) + order)
    x = rng.normal(size=(int(np.prod(n1)), c))
    t = x.T.reshape((c,) + tuple(reversed(n1)))
    for fp in fps + [dict(fps[-1], plane=1)]:
        xf = lpt.face_gather(torch.as_tensor(x), fp, order)
        ref = np.asarray(_jit(lj.face_gather, x, fp, order))
        np.testing.assert_array_equal(xf.numpy(), ref)
        np.testing.assert_array_equal(lpt.face_gather_tensor(torch.as_tensor(t), fp, order).numpy(), ref)
        y = rng.normal(size=ref.shape)
        got = lpt.face_scatter_pad(torch.as_tensor(y), fp, order)
        np.testing.assert_array_equal(got.numpy(), np.asarray(_jit(lj.face_scatter_pad, y, fp, order)))
        acc = rng.normal(size=t.shape)
        got = lpt.face_scatter_tensor_add(torch.as_tensor(y), fp, order, torch.as_tensor(acc.copy()))
        ref = _jit(lambda v: lj.face_scatter_tensor_add(v, fp, order, jnp.asarray(acc)), y)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _square_pair(strategy):
    """The 2D diffusion problem on 4x3 quads at p = 2 (faces: adiabatic top and
    bottom, direct on the lattice sides), in both packages."""
    from tests.test_distributed import _adiabatic, _diffusion

    mesh = lt.generate_mesh(lt.make_square_mesh(np.linspace(0.0, 1.0, 5), np.linspace(0.0, 1.0, 4)), order=2)
    out = []
    for pkg in (lt, lp):
        problem = pkg.ProblemDefinition(3, [0])
        bcs = pkg.BCDefinition(problem)
        bcs.define_dirichlet([3, 4], [0])
        params = pkg.AlgebraicSystemParams(eval_strategy=pkg.OperatorEvaluationStrategy.MATRIX_FREE)
        if pkg is lt:
            s = lt.make_algebraic_system(mesh, problem, bcs, params)
        else:
            s = lp.make_algebraic_system(_port_mesh(mesh), problem, bcs, params, dtype=torch.float64, device="cpu")
        kd = pkg.wrap_domain_equation_kernel(_diffusion, pkg.KernelParams(dimension=2, n_equations=4, n_unknowns=3))
        kn = pkg.wrap_boundary_equation_kernel(_adiabatic, pkg.KernelParams(dimension=2, n_equations=1, n_unknowns=3))
        s.begin_assembly()
        s.assemble_problem(kd, [0], options=pkg.AssemblyOptions(eval_strategy=getattr(pkg.LocalEvalStrategy, strategy)))
        s.assemble_problem(kn, [1, 2])
        s.end_assembly()
        out.append(s)
    return out


@pytest.mark.parametrize("strategy", ["DENSE_MXU", "LATTICE_SF"])
def test_system_gathers_match_reference(strategy):
    """A lattice block under DENSE_MXU takes its element values by slicing
    (``("lattice", ...)``); the adiabatic faces of the 2D lattice are direct
    and take one plane of the lattice tensor (``("face", ...)``), also on the
    channel-major layout under LATTICE_SF.  Applies within 1e-11."""
    sj, sp_ = _square_pair(strategy)
    ops = sp_._operators()[1]
    vol = ops[0][1][-1][0] if strategy == "DENSE_MXU" else ops[0][1][0]
    assert vol == {"DENSE_MXU": "lattice", "LATTICE_SF": "lattice_sf_const"}[strategy]
    assert [d[0] for _, d in ops[1:]] == ["direct"] * 2 and [d[-1][0] for _, d in ops[1:]] == ["face"] * 2
    x = np.random.default_rng(5).normal(size=(sj.n_dofs, 1))
    fj, cj = sj.operator_parts()
    fp, cp = sp_.operator_parts()
    assert _rel(fp(torch.as_tensor(x), *cp), jax_run(fj, x, *cj)) < 1e-11
    if strategy == "LATTICE_SF":
        assert sp_.lattice_layout_key() == sj.lattice_layout_key()
        fj, cj = sj.operator_parts(layout="lattice")
        fp, cp = sp_.operator_parts(layout="lattice")
        xl = sj.to_lattice_layout(x)
        assert _rel(fp(torch.as_tensor(np.asarray(xl)), *cp), jax_run(fj, xl, *cj)) < 1e-11
