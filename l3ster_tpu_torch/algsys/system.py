"""Matrix-free algebraic system (PyTorch port of ``l3ster_tpu.algsys.system``).

Two families of :class:`MatrixFreeSystem` operator contributions are ported:

* the lattice family: a constant-coefficient 3D volume kernel on a
  structured lattice block runs as global banded sweeps around the fused
  z-sweep (``ops/lattice_sumfact.py``), and value-only boundary kernels on
  full lattice sides run as banded face sweeps;
* the gather family, for any mesh: element values are gathered through the
  dof map, a local apply runs per element batch, and ``index_add_`` scatters
  the result.  Constant-coefficient volume kernels take the dense-basis
  apply (``dense_const``: two matmuls around the per-QP kernel), the
  sum-factorized one (``sumfact_const``) or the fused sum-factorized kernel
  (``pallas``); boundary kernels and order-1 volumes take the direct apply.

The local evaluation strategy follows the reference's ladder, on every
device: AUTO takes the lattice kinds when the volume block is a lattice,
else the dense apply at order >= 2.  Variable-coefficient volume kernels on
the lattice, dense and sum-factorized paths raise ``NotImplementedError``
and name their ``ROADMAP.md`` entry.

Strong Dirichlet conditions are imposed **by masking, outside the operator**
(SPD-preserving): ``y = free * A(free * x) + dir * x`` and
``b_eff = free * (b - A(g_ext)) + g_ext``.

Everything runs eagerly on ``self.device``; x-independent operator data is
computed once per assembly, on first use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..bcs.dirichlet import collect_dirichlet_dofs
from ..common.enums import CondensationPolicy, LocalEvalStrategy, OperatorEvaluationStrategy
from ..common.problem import AlgebraicSystemParams, AssemblyOptions, BCDefinition, ProblemDefinition
from ..dofs.dofmap import build_dof_map
from ..interop import from_lattice_layout, to_lattice_layout
from ..mesh.core import Mesh
from .local import (
    _basis_stack,
    _const,
    domain_tables,
    element_geometry,
    eval_equation_kernel,
    local_diagonal,
    local_diagonal_sumfact,
    local_rhs,
    local_rhs_sumfact,
    side_tables,
)

__all__ = ["MatrixFreeSystem", "make_algebraic_system"]

_LATTICE_KINDS = ("lattice_sf_const", "lattice_sf_const_diag")


@dataclass
class _Contribution:
    """One registered (kernel, element bucket) assembly contribution."""

    kernel: object
    tables: object
    verts: np.ndarray  # (E, n_verts, 3)
    elem_dofs: np.ndarray  # (E, n_nodes, n_unk) int64
    time: float
    options: AssemblyOptions
    block: object = None  # source ElementBlock
    elem_sel: np.ndarray | None = None  # indices into the block (boundary views)
    dof_inds: tuple = ()
    op_data: tuple | None = None  # x-independent operator data, built on first use


# -------------------------------------------------------------- constant kernels


class _Dependent(Exception):
    """A value derived from the kernel inputs left torch (bool, float, item...)."""


class _TaintMode(torch.overrides.TorchFunctionMode):
    """Conservative dataflow taint through every torch call.

    Storages reachable from the kernel inputs are tainted; any call with a
    tainted argument taints the storages of its tensor outputs (an in-place
    method returns the tensor it wrote, so views share the taint).  A call
    with a tainted argument that returns anything but tensors raises
    :class:`_Dependent`: a Python value (``__bool__``, ``float()``,
    ``.item()``, ``.tolist()``, numpy) means the kernel branched on or copied
    out input-dependent data, and ``None`` comes from ``__setitem__`` writing
    it into another tensor.  Shape and dtype queries are not value dependent
    and pass.
    """

    _META = {
        "shape", "size", "dim", "ndim", "numel", "dtype", "device", "layout", "__len__",
        "is_floating_point", "is_complex", "requires_grad", "is_cuda",
    }

    def __init__(self, inputs):
        super().__init__()
        self._keep: list = []  # keeps tainted storages alive so ids are never reused
        self._tainted: set = set()
        for t in inputs:
            self._mark(t)

    def _key(self, t: torch.Tensor):
        return t.untyped_storage().data_ptr(), t.device

    def _mark(self, t) -> None:
        if isinstance(t, torch.Tensor) and t.numel():
            self._tainted.add(self._key(t))
            self._keep.append(t)

    def _is_tainted(self, t) -> bool:
        return isinstance(t, torch.Tensor) and t.numel() > 0 and self._key(t) in self._tainted

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tainted = any(self._is_tainted(a) for a in tree_leaves((args, kwargs)))
        out = func(*args, **kwargs)
        if not tainted:
            return out
        name = getattr(func, "__name__", "")
        if name == "__get__":  # a property such as Tensor.shape
            name = getattr(getattr(func, "__self__", None), "__name__", name)
        if name in self._META:
            return out
        outs = tree_leaves(out)
        if not outs or any(not isinstance(o, torch.Tensor) for o in outs):
            raise _Dependent(name)
        for o in outs:
            self._mark(o)
        return out


def _constant_kernel_operators(kernel, time: float):
    """A (dim+1, n_eq, n_unk) numpy matrix when the domain kernel's operators
    are independent of position, fields, and time; None otherwise.

    Constancy is PROVEN by evaluating ``kernel.evaluate`` once under
    :class:`_TaintMode` with tainted inputs and checking that A carries no
    taint (value probing would mis-classify piecewise-constant kernels).  A
    constant A is baked into the z-sweep launch, with zeros skipped.
    """
    if kernel.is_boundary:
        return None
    from ..common.kernel import DomainInput, SpaceTimePoint

    p = kernel.params
    dt, dev = torch.float64, torch.device("cpu")
    inputs = (
        torch.zeros((p.n_fields,), dtype=dt),
        torch.zeros((p.dimension, p.n_fields), dtype=dt),
        torch.zeros((3,), dtype=dt),
        torch.tensor(float(time), dtype=dt),
    )
    mode = _TaintMode(inputs)
    try:
        with mode:
            A, _ = kernel.evaluate(
                DomainInput(inputs[0], inputs[1], SpaceTimePoint(inputs[2], inputs[3])), dt, dev
            )
    except _Dependent:
        return None
    except Exception:  # a kernel that cannot be evaluated at a single probe point
        return None
    if mode._is_tainted(A):
        return None
    A = A.numpy().copy()
    return A if np.isfinite(A).all() else None


# ------------------------------------------------------------------- the system


def _resolve_device(device) -> torch.device:
    """The CUDA device unless the caller names one; no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available: pass device="cpu" to run the system on the CPU'
            )
        device = "cuda"
    return torch.device(device)


class MatrixFreeSystem:
    """Operator-only system (``algsys/MatrixFreeSystem.hpp``): lattice and gather families."""

    def __init__(
        self,
        mesh: Mesh,
        problem: ProblemDefinition,
        bc_def: BCDefinition | None = None,
        params: AlgebraicSystemParams = AlgebraicSystemParams(),
        dtype=torch.float32,
        device=None,
    ):
        if params.cond_policy != CondensationPolicy.NONE:
            raise NotImplementedError("static condensation is not ported (ROADMAP.md queue A8)")
        if bc_def is not None and (bc_def.periodic or bc_def.normalized_dofs):
            raise NotImplementedError(
                "periodic and normalization conditions are not ported (ROADMAP.md queue A1)"
            )
        self.mesh = mesh
        self.problem = problem
        self.bc_def = bc_def
        self.params = params
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.dofmap = build_dof_map(mesh, problem)
        self.n_dofs = self.dofmap.n_dofs
        self.n_rhs = params.n_rhs
        self.dirichlet_dofs = collect_dirichlet_dofs(mesh, self.dofmap, bc_def)
        free = np.ones(self.n_dofs, dtype=bool)
        free[self.dirichlet_dofs] = False
        self.free_mask = self._tensor(free.astype(np.float64))
        self.dirichlet_values = self._tensor(np.zeros((len(self.dirichlet_dofs), self.n_rhs)))
        self.rhs = self._zeros((self.n_dofs, self.n_rhs))
        self.x = self._zeros((self.n_dofs, self.n_rhs))
        self._open = False
        self._effective_rhs = None
        self._contribs: list[_Contribution] = []
        self._diag = None
        self._ops = None  # (lattice_key, [(contribution, op_data)]) once built
        self._last_solve_result = None

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype, device=self.device)

    def _zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # -- assembly state machine (``AssembledSystem.hpp:99-108``) -------------

    def begin_assembly(self) -> None:
        self._open = True
        self._effective_rhs = None
        self.rhs = self._zeros((self.n_dofs, self.n_rhs))
        self._contribs = []
        self._diag = None
        self._ops = None

    def assemble_problem(
        self,
        kernel,
        domain_ids,
        field_access=None,
        dof_inds=None,
        options: AssemblyOptions = AssemblyOptions(),
        time: float = 0.0,
    ) -> None:
        """Register an equation kernel over domains or boundaries."""
        if not self._open:
            raise RuntimeError("assemble_problem requires an open assembly (call begin_assembly)")
        if field_access is not None:
            raise NotImplementedError("field access is not ported (ROADMAP.md queue A5)")
        p = kernel.params
        if p.n_rhs != self.n_rhs:
            raise ValueError(f"kernel n_rhs={p.n_rhs} != system n_rhs={self.n_rhs}")
        dof_inds = tuple(range(p.n_unknowns)) if dof_inds is None else tuple(dof_inds)
        if len(dof_inds) != p.n_unknowns:
            raise ValueError("dof_inds length must equal kernel n_unknowns")
        for tables, verts, nodes, block, sel in self._buckets(kernel, domain_ids, options):
            elem_dofs = self.dofmap.element_dofs(nodes, dof_inds)
            if not (elem_dofs >= 0).all():
                raise ValueError(
                    f"kernel dof indices {dof_inds} not all active on the assembled domains"
                )
            self._contribs.append(
                _Contribution(
                    kernel=kernel, tables=tables, verts=verts, elem_dofs=elem_dofs, time=time,
                    options=options, block=block, elem_sel=sel, dof_inds=dof_inds,
                )
            )

    def _buckets(self, kernel, domain_ids, options: AssemblyOptions):
        """Yield (tables, verts, nodes, block, sel) for each bucket to assemble."""
        if kernel.is_boundary:
            found = False
            for bid in domain_ids:
                views = self.mesh.boundary_views.get(bid)
                if views is None:
                    raise ValueError(f"domain {bid} is not a boundary of the mesh")
                for bv in views:
                    blk = bv.parent_block
                    qo = options.quadrature_order(blk.order)
                    tab = side_tables(blk.element_type, blk.order, bv.side, qo)
                    sel = bv.element_indices
                    yield tab, blk.vertices[sel], blk.nodes[sel], blk, sel
                    found = True
            if not found:
                raise ValueError(f"no boundary facets in domains {list(domain_ids)}")
        else:
            blocks = self.mesh.blocks(domain_ids)
            if not blocks:
                raise ValueError(f"no elements in domains {list(domain_ids)}")
            for did, blk in blocks:
                if blk.dim != kernel.params.dimension:
                    raise ValueError(
                        f"domain kernel of dimension {kernel.params.dimension} cannot run on "
                        f"{blk.dim}D elements of domain {did}"
                    )
                qo = options.quadrature_order(blk.order)
                yield domain_tables(blk.element_type, blk.order, qo), blk.vertices, blk.nodes, blk, None

    def end_assembly(self) -> None:
        """The rhs and operator diagonal in one pass (``MatrixFreeSystem.hpp:887-941``);
        large contributions run in element chunks to bound the (E, Q, ...) intermediates."""
        if not self._open:
            raise RuntimeError("end_assembly without begin_assembly")
        rhs = self._zeros((self.n_dofs, self.n_rhs))
        diag = self._zeros((self.n_dofs,))
        for c in self._contribs:
            use_sf = self._use_sumfact(c)
            E = c.verts.shape[0]
            chunk = int(max(1, (1 << 25) // max(c.tables.n_qp * 128, 1)))
            q_order = c.options.quadrature_order(c.tables.order)
            for s in range(0, E, chunk):
                geom = element_geometry(
                    c.tables, self._tensor(c.verts[s : s + chunk]), with_phys_ders=not use_sf
                )
                A, f = eval_equation_kernel(c.kernel, geom, c.time)
                if use_sf:
                    F = local_rhs_sumfact(A, geom, c.tables.order, q_order, c.tables.dim, f)
                    d = local_diagonal_sumfact(A, geom, c.tables.order, q_order, c.tables.dim)
                else:
                    B = _basis_stack(c.tables, geom)
                    F = local_rhs(A, B, geom.weights, f)
                    d = local_diagonal(A, B, geom.weights)
                idx = torch.as_tensor(c.elem_dofs[s : s + chunk].reshape(-1), device=self.device)
                rhs.index_add_(0, idx, F.reshape(-1, self.n_rhs))
                diag.index_add_(0, idx, d.reshape(-1))
        self.rhs, self._diag = rhs, diag
        self._open = False

    @staticmethod
    def _use_sumfact(c: _Contribution) -> bool:
        """Sum-factorized rhs/diagonal (and apply, on the sum-factorized kinds) for
        volume Quad/Hex contributions: forced by SUM_FACT / SUM_FACT_PALLAS, else
        at p >= 2 unless DIRECT is asked for; boundaries are direct."""
        from ..ops.sumfact import supports_sumfact

        strat = c.options.eval_strategy
        if c.tables.side is not None or strat == LocalEvalStrategy.DIRECT:
            return False
        if strat in (LocalEvalStrategy.SUM_FACT, LocalEvalStrategy.SUM_FACT_PALLAS):
            if not supports_sumfact(c.tables.element_type):
                raise ValueError("sum factorization requires tensor-product Quad/Hex elements")
            return True
        return supports_sumfact(c.tables.element_type) and c.tables.order >= 2

    def _use_lattice_sf(self, c: _Contribution) -> bool:
        """Global banded sweeps: LATTICE_SF (which requires a lattice block), or
        AUTO when the volume block is a lattice."""
        strat = c.options.eval_strategy
        if c.tables.side is not None or strat not in (LocalEvalStrategy.AUTO, LocalEvalStrategy.LATTICE_SF):
            return False
        plan = self._lattice_plan(c)
        if plan is None and strat == LocalEvalStrategy.LATTICE_SF:
            raise ValueError("LATTICE_SF requires a structured-lattice mesh block")
        return plan is not None

    @staticmethod
    def _use_dense(c: _Contribution) -> bool:
        """Dense basis-matrix apply: DENSE_MXU, or AUTO at p >= 2 (the
        reference's AUTO on its accelerator, taken here on every device)."""
        strat = c.options.eval_strategy
        if c.tables.side is not None:
            return False
        return strat == LocalEvalStrategy.DENSE_MXU or (
            strat == LocalEvalStrategy.AUTO and c.tables.order >= 2
        )

    # -- Dirichlet values (``AssembledSystem.hpp:158-286`` analog) ------------

    def set_dirichlet_bc_values(self, values, boundaries=None, dof_inds=None, time=0.0):
        """Set Dirichlet values from a boundary residual kernel (averaged at
        shared nodes), from per-dof constants on given boundaries, or directly
        from an array matching the Dirichlet dof list."""
        if boundaries is None:  # raw array aligned with the Dirichlet dof list
            vals = torch.as_tensor(values, dtype=self.dtype, device=self.device).reshape(-1, self.n_rhs)
            if vals.shape[0] != len(self.dirichlet_dofs):
                raise ValueError("value array length != number of Dirichlet dofs")
            self.dirichlet_values = vals.clone()
            self._effective_rhs = None
            return
        if callable(getattr(values, "evaluate", None)):
            self._set_dirichlet_from_kernel(values, boundaries, dof_inds, time)
            return
        consts = np.asarray(values, dtype=np.float64).reshape(-1)
        dof_inds = tuple(dof_inds) if dof_inds is not None else tuple(range(len(consts)))
        if len(consts) != len(dof_inds):
            raise ValueError("need one constant per dof index")
        if not len(self.dirichlet_dofs):
            raise ValueError(
                "set_dirichlet_bc_values: the system has no Dirichlet dofs "
                "(declare them via BCDefinition.define_dirichlet)"
            )
        nodes = self.mesh.boundary_nodes_of(boundaries)
        vals = self.dirichlet_values.clone()
        for val, di in zip(consts, dof_inds):
            dofs = self.dofmap.node_dof[nodes, di]
            dofs = dofs[dofs >= 0]
            pos = np.searchsorted(self.dirichlet_dofs, dofs)
            posc = np.minimum(pos, len(self.dirichlet_dofs) - 1)
            ok = (pos < len(self.dirichlet_dofs)) & (self.dirichlet_dofs[posc] == dofs)
            if not ok.all():
                # the reference asserts every requested (node, dof) pair is Dirichlet
                raise ValueError(
                    f"set_dirichlet_bc_values: dof {di} on boundaries "
                    f"{list(boundaries)} includes non-Dirichlet dofs"
                )
            vals[torch.as_tensor(pos, device=self.device)] = float(val)
        self.dirichlet_values = vals
        self._effective_rhs = None

    def _set_dirichlet_from_kernel(self, kernel, boundaries, dof_inds, time) -> None:
        """Kernel equation i gives the value of dof ``dof_inds[i]`` at each node
        of the boundaries; nodes whose dof is not Dirichlet are skipped."""
        from .values_at_nodes import compute_boundary_values_at_nodes

        n_eq = kernel.params.n_equations
        dof_inds = tuple(dof_inds) if dof_inds is not None else tuple(range(n_eq))
        vals, mask = compute_boundary_values_at_nodes(
            kernel, self.mesh, boundaries, time, self.dtype, self.device
        )  # (n_nodes, n_eq, n_rhs)
        nodes = np.nonzero(mask.cpu().numpy())[0]
        out = self.dirichlet_values.clone()
        for i, di in enumerate(dof_inds):
            dofs = self.dofmap.node_dof[nodes, di]
            ok = dofs >= 0
            pos = np.searchsorted(self.dirichlet_dofs, dofs[ok])
            valid = pos < len(self.dirichlet_dofs)
            pos = pos[valid]
            sel = np.nonzero(ok)[0][valid]
            hit = self.dirichlet_dofs[pos] == dofs[ok][valid]
            src = torch.as_tensor(nodes[sel][hit], device=self.device)
            out[torch.as_tensor(pos[hit], device=self.device)] = vals[src, i, :]
        self.dirichlet_values = out
        self._effective_rhs = None

    # -- operator data ----------------------------------------------------------

    def _row_plan(self, c: _Contribution):
        """(row_idx, n_rows) when every node's kernel dofs are consecutive and
        row-aligned; None otherwise."""
        E, n_nodes, n_unk = c.elem_dofs.shape
        if n_unk > 1 and self.n_dofs % n_unk == 0:
            starts = c.elem_dofs[:, :, 0]
            consec = (c.elem_dofs == starts[:, :, None] + np.arange(n_unk)).all()
            if consec and (starts % n_unk == 0).all():
                return starts // n_unk, self.n_dofs // n_unk
        return None

    def _lattice_plan(self, c: _Contribution):
        """(n1, ne, eidx, inv_eidx) when the volume contribution's node rows form
        a full tensor-product lattice; None otherwise."""
        from ..ops.lattice import detect_lattice_plan

        rows = self._row_plan(c)
        if rows is None or c.tables.side is not None:
            return None
        return detect_lattice_plan(rows[0], rows[1], c.tables.order, c.tables.dim)

    def _face_plan(self, c: _Contribution, ns):
        """Slicing plan of a boundary bucket covering one full side of a lattice
        block, restricted to the side's surface nodes ``ns``; None otherwise."""
        from ..ops.lattice import detect_face_plan, detect_lattice_plan

        n_unk = len(c.dof_inds)
        if self.n_dofs % n_unk:
            return None
        full_dofs = self.dofmap.element_dofs(c.block.nodes, c.dof_inds)
        starts = full_dofs[:, :, 0]
        consec = (full_dofs == starts[:, :, None] + np.arange(n_unk)).all()
        if not (consec and (starts % n_unk == 0).all()):
            return None
        vol_plan = detect_lattice_plan(
            starts // n_unk, self.n_dofs // n_unk, c.tables.order, c.tables.dim
        )
        if vol_plan is None:
            return None
        return detect_face_plan(
            vol_plan, c.tables.order, c.tables.dim, c.tables.side, c.elem_sel, ns,
            c.block.nodes.shape[1],
        )

    def _geometry_packed(self, c: _Contribution):
        """(Ji_t (dim, dim, EQ), w_t (EQ,)) in block element-major order and in
        float64 whatever the system dtype: the separable-geometry check needs
        exact zeros and per-axis constants that float32 rounding would break.
        Built in element chunks so the (E, Q, dim, dim) intermediates stay bounded."""
        E, Q = c.verts.shape[0], c.tables.n_qp
        chunk = max(1, (1 << 22) // max(Q, 1))
        dim = c.tables.dim
        ji, w = [], []
        for s in range(0, E, chunk):
            verts = self._tensor(c.verts[s : s + chunk], torch.float64)
            g = element_geometry(c.tables, verts, with_phys_ders=False)
            ji.append(g.jac_inv.reshape(-1, dim, dim))
            w.append(g.weights.reshape(-1))
        return torch.cat(ji).permute(1, 2, 0), torch.cat(w)

    def _operator_data(self, c: _Contribution):
        """x-independent operator data of one contribution, built on first use."""
        if c.op_data is None:
            c.op_data = (
                self._boundary_data(c) if c.tables.side is not None else self._volume_data(c)
            )
        return c.op_data

    def _volume_data(self, c: _Contribution):
        """Operator data of a volume contribution, by the reference's strategy
        ladder: lattice kinds, else dense, sum-factorized or fused, else direct."""
        if self._use_lattice_sf(c):
            return self._lattice_data(c)
        use_dense = self._use_dense(c)
        if not (use_dense or self._use_sumfact(c)):
            return self._direct_data(c)
        A_const = _constant_kernel_operators(c.kernel, c.time)
        if A_const is None:
            kind = "dense" if use_dense else "sumfact"
            raise NotImplementedError(
                f"variable-coefficient {kind} apply is not ported (ROADMAP.md queue A4)"
            )
        dim = c.tables.dim
        Ji_t, w_t = self._geometry_packed(c)
        gather = self._gather(c)
        if use_dense:
            from ..ops.dense_eval import dense_basis_matrix

            Ball = self._tensor(dense_basis_matrix(c.tables))
            return ("dense_const", A_const, Ji_t.to(self.dtype).contiguous(), w_t.to(self.dtype), Ball, gather)
        if c.options.eval_strategy == LocalEvalStrategy.SUM_FACT_PALLAS:
            # the fused kernel computes in float32 whatever the system dtype, as
            # the reference's does; it takes J^-1 as (E, Q, dim, dim)
            E, Q = c.verts.shape[0], c.tables.n_qp
            ji = Ji_t.permute(2, 0, 1).reshape(E, Q, dim, dim).to(torch.float32).contiguous()
            return ("pallas", A_const, ji, w_t.reshape(E, Q).to(torch.float32), gather)
        return ("sumfact_const", A_const, Ji_t.to(self.dtype).contiguous(), w_t.to(self.dtype), gather)

    def _lattice_data(self, c: _Contribution):
        from ..ops.lattice_sumfact import lattice_qp_perm
        from ..ops.zsweep import detect_diag_geometry

        plan = self._lattice_plan(c)
        if c.tables.dim != 3:
            raise NotImplementedError("2D lattice apply is not ported (ROADMAP.md queue A4)")
        A_const = _constant_kernel_operators(c.kernel, c.time)
        if A_const is None:
            raise NotImplementedError(
                "variable-coefficient lattice apply (lattice_sf_var) is not ported "
                "(ROADMAP.md queue B1, var mode)"
            )
        n1, ne, _, inv = plan
        q1 = c.options.quadrature_order(c.tables.order) // 2 + 1
        perm = torch.as_tensor(lattice_qp_perm(ne, q1, inv), device=self.device)
        Ji_t, w_t = self._geometry_packed(c)
        Ji_l, w_l = Ji_t[:, :, perm], w_t[perm]
        # axis-aligned separable geometry (every generated box mesh): five
        # per-axis vectors instead of the (3,3,EQ)+(EQ) tensors
        g = detect_diag_geometry(Ji_l.cpu().numpy(), w_l.cpu().numpy(), ne[2] * q1)
        if g is not None:
            return ("lattice_sf_const_diag", A_const, plan) + tuple(self._tensor(v) for v in g[1:])
        return ("lattice_sf_const", A_const, plan, Ji_l.to(self.dtype), w_l.to(self.dtype))

    def _boundary_data(self, c: _Contribution):
        """A value-only kernel on a full lattice side runs as a banded face sweep;
        every other boundary contribution is direct."""
        from ..ops.lattice_sumfact import pack_face_banded

        geom = element_geometry(c.tables, self._tensor(c.verts), with_phys_ders=False)
        A, _ = eval_equation_kernel(c.kernel, geom, c.time)
        dmask = (A.abs().amax(dim=(0, 1, 3, 4)) > 0).cpu().numpy()
        if not dmask.any():
            return ("zero",)  # contributes nothing to the operator
        fp = None
        if not dmask[1:].any():  # value-only: touches only the side's surface nodes
            ns = np.nonzero(np.abs(c.tables.values).max(axis=0) > 0.0)[0]
            if 0 < len(ns) < c.tables.values.shape[1]:
                fp = self._face_plan(c, ns)
        if fp is None:
            return self._direct_data(c, geom, A, dmask)
        q_order = c.options.quadrature_order(c.tables.order)
        A_l, w_l = pack_face_banded(
            A[:, :, :1].cpu().numpy(), geom.weights.cpu().numpy(), fp, c.tables.order, q_order
        )
        return ("face_banded", self._tensor(A_l), self._tensor(w_l), fp)

    def _direct_data(self, c: _Contribution, geom=None, A=None, dmask=None):
        """("direct", A, B, w, gather) with the reference's structural
        restriction: identically-zero derivative blocks of A are dropped, and
        basis columns with no support (off-face nodes of a value-only boundary
        kernel) are dropped together with their dofs in the gather."""
        if geom is None:
            geom = element_geometry(c.tables, self._tensor(c.verts), with_phys_ders=False)
            A, _ = eval_equation_kernel(c.kernel, geom, c.time)
            dmask = (A.abs().amax(dim=(0, 1, 3, 4)) > 0).cpu().numpy()
        E, Q = geom.weights.shape
        n = c.tables.values.shape[1]
        rows = [_const(c.tables.values, geom.weights)[None, :, None, :].expand(E, Q, 1, n)]
        if dmask[1:].any():  # physical derivatives (J^-T refD) only where A needs them
            rows.append(torch.einsum("eqji,qjn->eqin", geom.jac_inv, _const(c.tables.ref_ders, geom.weights)))
        B = torch.cat(rows, dim=2)
        keep_d = np.nonzero(dmask)[0]
        if 0 < len(keep_d) < A.shape[2]:
            A = A[:, :, keep_d]
            B = B[:, :, torch.as_tensor(keep_d, device=self.device)]
        ns = None
        if len(keep_d):
            support = (B.abs().amax(dim=(0, 1, 2)) > 0).cpu().numpy()
            if not support.all() and support.any():
                ns = np.nonzero(support)[0]
                B = B[..., torch.as_tensor(ns, device=self.device)]
        return ("direct", A, B, geom.weights, self._gather(c, ns))

    def _gather(self, c: _Contribution, ns=None):
        """(idx, n_rows) moving the contribution's element values: row_idx
        (E, n_nodes) into an (n_rows, n_unk) view when every node's kernel dofs
        are consecutive and row-aligned, else scalar dof indices (E, n_sel*n_unk)
        with n_rows None; ``ns`` restricts to a subset of local nodes."""
        rows = self._row_plan(c) if ns is None else None
        if rows is not None:
            return torch.as_tensor(rows[0], device=self.device), rows[1]
        dofs = c.elem_dofs if ns is None else c.elem_dofs[:, ns]
        return torch.as_tensor(dofs.reshape(dofs.shape[0], -1), device=self.device), None

    def _operators(self):
        """(lattice_key, [(contribution, op_data)]): the lattice key (n1, n_rows,
        n_unk) when every contribution is of the lattice family and all share
        one lattice (the operator then runs on channel-major vectors too);
        None otherwise."""
        if self._ops is None:
            if self._open or self._diag is None:
                raise RuntimeError("the operator is available after end_assembly")
            ops, keys = [], set()
            for c in self._contribs:
                d = self._operator_data(c)
                if d[0] == "zero":
                    continue
                n_unk = c.elem_dofs.shape[2]
                if d[0] in _LATTICE_KINDS or d[0] == "face_banded":
                    n1 = d[2][0] if d[0] in _LATTICE_KINDS else d[3]["n1"]
                    keys.add((tuple(int(a) for a in n1), self.n_dofs // n_unk, n_unk))
                else:
                    keys.add(None)
                ops.append((c, d))
            self._ops = (keys.pop() if len(keys) == 1 else None, ops)
        return self._ops

    def lattice_layout_key(self):
        """(n1, n_rows, n_unk) when every operator contribution runs on one
        shared channel-leading lattice tensor; None otherwise."""
        return self._operators()[0]

    def to_lattice_layout(self, v: torch.Tensor) -> torch.Tensor:
        """dof-major (node*n_unk+u) -> channel-major (u*n_rows+node) rows."""
        key = self.lattice_layout_key()
        if key is None:
            raise ValueError("system has no lattice layout")
        return to_lattice_layout(v, key[2])

    def from_lattice_layout(self, v: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`to_lattice_layout`."""
        key = self.lattice_layout_key()
        if key is None:
            raise ValueError("system has no lattice layout")
        return from_lattice_layout(v, key[2])

    def _local_apply(self, c: _Contribution, d, x_loc: torch.Tensor) -> torch.Tensor:
        """y_loc (E, n_sel, n_unk) of one gather-family contribution."""
        dim, order = c.tables.dim, c.tables.order
        q_order = c.options.quadrature_order(order)
        if d[0] == "dense_const":
            from .local import local_apply_dense_const

            return local_apply_dense_const(d[1], d[2], d[3], d[4], dim, x_loc)
        if d[0] == "sumfact_const":
            from .local import local_apply_sumfact_const

            return local_apply_sumfact_const(d[1], d[2], d[3], x_loc.shape[0], order, q_order, dim, x_loc)
        if d[0] == "pallas":
            from ..ops.sumfact_fused import sumfact_const_apply

            y = sumfact_const_apply(d[1], d[2], d[3], order, q_order, dim, x_loc.to(torch.float32))
            return y.to(x_loc.dtype)
        from .local import local_apply_direct

        return local_apply_direct(d[1], d[2], d[3], x_loc)

    def _apply(self, x: torch.Tensor, lattice_io: bool) -> torch.Tensor:
        """Unconstrained operator on (n_dofs, n_rhs) vectors.  Lattice-family
        contributions work on one channel-leading tensor per rhs column;
        gather-family ones gather element values per column and scatter-add
        into one flat accumulator per column."""
        from ..ops.lattice_sumfact import face_apply_banded, local_apply_lattice

        _, ops = self._operators()
        tacc: dict = {}
        flat: dict = {}

        def t_in(key, r):
            n1t, n_rows, n_unk = key
            col = x[:, r]
            if not lattice_io:
                col = col.reshape(n_rows, n_unk).T
            return col.reshape((n_unk,) + tuple(reversed(n1t)))

        def acc(key, r, val):
            prev = tacc.get((key, r))
            tacc[(key, r)] = val if prev is None else prev + val

        r_n = x.shape[1]
        for c, d in ops:
            n_unk = c.elem_dofs.shape[2]
            q_order = c.options.quadrature_order(c.tables.order)
            if d[0] in _LATTICE_KINDS:
                A_c, plan = d[1], d[2]
                key = (tuple(int(a) for a in plan[0]), self.n_dofs // n_unk, n_unk)
                if d[0] == "lattice_sf_const":
                    Ji_l, w_l, geom = d[3], d[4], None
                else:
                    Ji_l = w_l = None
                    geom = ("diag",) + tuple(d[3:])
                if 1 < r_n <= 4:
                    # multi-RHS lane stacking: rhs columns ride as extra channels
                    # with a block-diagonal A -- ONE sweep instead of r_n
                    n_eq_c = A_c.shape[1]
                    A_eff = np.zeros((A_c.shape[0], n_eq_c * r_n, n_unk * r_n))
                    for rr in range(r_n):
                        A_eff[:, rr * n_eq_c : (rr + 1) * n_eq_c, rr * n_unk : (rr + 1) * n_unk] = A_c
                    t_st = torch.cat([t_in(key, rr) for rr in range(r_n)], dim=0)
                    yt = local_apply_lattice(
                        A_eff, Ji_l, w_l, c.tables.order, q_order, plan[0], plan[1], t_st,
                        geom=geom, tensor_io=True,
                    )
                    for rr in range(r_n):
                        acc(key, rr, yt[rr * n_unk : (rr + 1) * n_unk])
                    continue
                for r in range(r_n):
                    yt = local_apply_lattice(
                        A_c, Ji_l, w_l, c.tables.order, q_order, plan[0], plan[1], t_in(key, r),
                        geom=geom, tensor_io=True,
                    )
                    acc(key, r, yt)
                continue
            if d[0] == "face_banded":
                _, A_l, w_l, fp = d
                key = (tuple(fp["n1"]), self.n_dofs // n_unk, n_unk)
                pos = 1 + (len(fp["n1"]) - 1 - fp["axis"])
                pidx = fp["n1"][fp["axis"]] - 1 if fp["hi"] else 0
                for r in range(r_n):
                    t = t_in(key, r)
                    yp = face_apply_banded(A_l, w_l, fp, c.tables.order, q_order, t.select(pos, pidx))
                    if (key, r) not in tacc:
                        tacc[(key, r)] = torch.zeros_like(t)
                    # accumulators are fresh tensors owned here: add the plane in place
                    tacc[(key, r)].select(pos, pidx).add_(yp)
                continue
            idx, n_rows = d[-1]
            E = idx.shape[0]
            for r in range(r_n):
                if r not in flat:
                    flat[r] = torch.zeros(self.n_dofs, dtype=x.dtype, device=x.device)
                if n_rows is not None:  # node-row gather / scatter
                    x_loc = x[:, r].reshape(n_rows, n_unk)[idx]
                    y_loc = self._local_apply(c, d, x_loc)
                    flat[r].view(n_rows, n_unk).index_add_(0, idx.reshape(-1), y_loc.reshape(-1, n_unk))
                else:  # scalar dof indices (restricted node subsets)
                    x_loc = x[idx, r].reshape(E, -1, n_unk)
                    y_loc = self._local_apply(c, d, x_loc)
                    flat[r].index_add_(0, idx.reshape(-1), y_loc.reshape(-1))
        y = torch.zeros_like(x)
        for (key, r), t in tacc.items():
            y[:, r] += t.reshape(-1) if lattice_io else t.reshape(key[2], -1).T.reshape(-1)
        for r, v in flat.items():
            y[:, r] += v
        return y

    def raw_parts(self, layout: str = "dof"):
        """(fn, consts): the unconstrained operator as fn(x, *consts); the port
        keeps its operator data on the system, so consts is empty."""
        if layout not in ("dof", "lattice"):
            raise ValueError(f"unknown layout {layout!r}")
        lattice_io = layout == "lattice"
        if lattice_io and self.lattice_layout_key() is None:
            raise ValueError("lattice layout unavailable for this operator")
        return (lambda x, *consts: self._apply(x, lattice_io)), ()

    def operator_parts(self, layout: str = "dof"):
        """(fn, consts): constrained SPD operator as fn(x, *consts).

        ``layout="lattice"`` runs on CHANNEL-MAJOR vectors (dof' = unknown *
        n_nodes + node), which the lattice apply views as its tensor without a
        transpose; callers own the layout conversion (once per solve)."""
        fn, consts = self.raw_parts(layout)
        free = self.to_lattice_layout(self.free_mask) if layout == "lattice" else self.free_mask
        fixed = 1.0 - free

        def apply(x, *consts):
            return fn(x * free[:, None], *consts) * free[:, None] + x * fixed[:, None]

        return apply, consts

    def operator(self):
        """Constrained SPD operator: y = free*A(free*x) + dir*x (dof layout)."""
        fn, consts = self.operator_parts()
        return lambda x: fn(x, *consts)

    def dirichlet_extension(self) -> torch.Tensor:
        """g_ext: zeros with Dirichlet values on Dirichlet dofs; (n_dofs, n_rhs)."""
        g = self._zeros((self.n_dofs, self.n_rhs))
        if len(self.dirichlet_dofs):
            g[torch.as_tensor(self.dirichlet_dofs, device=self.device)] = self.dirichlet_values
        return g

    def effective_rhs(self) -> torch.Tensor:
        """b_eff = free * (rhs - A(g_ext)) + g_ext."""
        if self._effective_rhs is None:
            g = self.dirichlet_extension()
            self._effective_rhs = self.free_mask[:, None] * (self.rhs - self._apply(g, False)) + g
        return self._effective_rhs

    def diagonal(self) -> torch.Tensor:
        if self._diag is None:
            raise RuntimeError("diagonal available after end_assembly")
        return self._diag * self.free_mask + (1.0 - self.free_mask)

    def solution_vector(self) -> torch.Tensor:
        return self.x

    def set_solution_vector(self, x: torch.Tensor) -> None:
        self.x = x.reshape(self.n_dofs, self.n_rhs)

    def solve(self, solver):
        """Run a solver object; returns its IterSolveResult."""
        return solver.solve(self)

    def describe(self) -> str:
        s = (
            f"MatrixFreeSystem: {self.n_dofs} dofs, {self.n_rhs} rhs, "
            f"{len(self.dirichlet_dofs)} Dirichlet dofs, dtype={self.dtype}, "
            f"device={self.device}, {len(self._contribs)} matrix-free contributions"
        )
        r = self._last_solve_result
        if r is not None:
            state = "converged" if r.converged else ("CAPPED (max_iters)" if r.capped else "NOT converged")
            s += f"; last solve: {r.num_iters} iters, res {r.tol:.2e}, {state}"
        return s


def make_algebraic_system(
    mesh: Mesh,
    problem: ProblemDefinition,
    bc_def: BCDefinition | None = None,
    params: AlgebraicSystemParams = AlgebraicSystemParams(),
    dtype=torch.float32,
    device=None,
):
    """Factory (``algsys/MakeAlgebraicSystem.hpp:9-46``).  Runs on the CUDA
    device unless ``device`` says otherwise; without CUDA it raises rather
    than fall back to the CPU."""
    if params.eval_strategy != OperatorEvaluationStrategy.MATRIX_FREE:
        raise NotImplementedError(
            "the assembled system is not ported (ROADMAP.md queue A8): "
            "use OperatorEvaluationStrategy.MATRIX_FREE"
        )
    return MatrixFreeSystem(mesh, problem, bc_def, params, dtype, device)
