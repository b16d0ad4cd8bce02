"""Algebraic systems (PyTorch port of ``l3ster_tpu.algsys.system``).

:class:`_SystemBase` holds what every system shares: the dof map, the
Dirichlet dofs and values, the assembly state machine and its registered
contributions, SPD-preserving Dirichlet masking around the raw operator,
and the layout helpers.  Two systems build on it:

* :class:`AssembledSystem` holds an explicit CSR matrix: local LSFEM
  matrices (``local_system``) are scattered with ``index_add_`` into the
  values of a host-built sparsity pattern, and the SpMV is a sparse CSR
  product.  Under ELEMENT_BOUNDARY static condensation the element-interior
  nodes are left out of the dof numbering: their couplings accumulate per
  element block, and ``end_assembly`` adds each element's Schur complement
  (batched Cholesky of the interior block) into the boundary system;
  ``recover_condensed_solution`` gives the interior values back after a
  solve;
* :class:`MatrixFreeSystem` keeps the contributions and applies them
  without a matrix, in two families:

  - the lattice family: a volume kernel on a structured lattice block runs
    as global banded sweeps (``ops/lattice_sumfact.py``): in 3D around the
    fused z-sweep, in 2D (and in 3D under ``L3STER_TPU_FUSED_Z=0``) as the
    non-fused chain, with its constant A baked into the kernel
    (``lattice_sf_const[_diag]``) or, when A varies in space, its nonzero
    (d, i, u) planes streamed per QP (``lattice_sf_var``); value-only
    boundary kernels on full sides of a 3D lattice run as banded face sweeps;
  - the gather family, for any mesh: element values are gathered through
    the dof map, a local apply runs per element batch, and ``index_add_``
    scatters the result.  Constant-coefficient volume kernels take the
    dense-basis apply (``dense_const``: two matmuls around the per-QP
    kernel), the sum-factorized one (``sumfact_const``) or the fused
    sum-factorized kernel (``pallas``); variable-coefficient ones (A varies
    in space or reads fields) take the same two applies with A stored per
    QP (``dense``, ``sumfact``: plain torch, as the reference's XLA chains);
    boundary kernels and order-1 volumes take the direct apply.

The matrix-free local evaluation strategy follows the reference's ladder, on
every device: AUTO takes the lattice kinds when the volume block is a 2D or
3D lattice, else the dense apply at order >= 2.  The lattice pipeline
(``"v2"``, the reference's opt-in ``"v1"`` and ``"xy"``, or the non-fused
``"chain"``/``"chain_qp"``) is read from the environment once, when the
operator is built (``ops.lattice_sumfact.lattice_variant``).

Kernels may read fields (``post/solution.py``): a contribution keeps the
:class:`FieldAccess` it was assembled with (a snapshot of the manager's
values) and the element nodes, and the fields are interpolated to the QPs
wherever the kernel is evaluated.

Strong Dirichlet conditions are imposed **by masking, outside the operator**
(SPD-preserving): ``y = free * A(free * x) + dir * x`` and
``b_eff = free * (b - A(g_ext)) + g_ext``.

Everything runs eagerly on ``self.device``; x-independent operator data is
computed once per assembly, on first use.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from ..bcs.dirichlet import collect_dirichlet_dofs
from ..bcs.periodic import match_periodic_nodes
from ..common.enums import CondensationPolicy, LocalEvalStrategy, OperatorEvaluationStrategy
from ..common.problem import AlgebraicSystemParams, AssemblyOptions, BCDefinition, ProblemDefinition
from ..dofs.dofmap import build_dof_map
from ..interop import from_lattice_layout, to_lattice_layout
from ..mesh.core import Mesh
from ..mesh.traits import boundary_node_indices, internal_node_indices
from .local import (
    _basis_stack,
    _const,
    domain_tables,
    element_geometry,
    eval_equation_kernel,
    eval_fields,
    local_diagonal,
    local_diagonal_sumfact,
    local_rhs,
    local_rhs_sumfact,
    local_system,
    side_tables,
)

__all__ = ["AssembledSystem", "MatrixFreeSystem", "make_algebraic_system"]

_LATTICE_KINDS = ("lattice_sf_const", "lattice_sf_const_diag", "lattice_sf_var")
# kinds whose local apply takes and gives channel-major element blocks (E, n_unk,
# n_nodes), the dense basis matmuls' operand and result (``ops/dense_eval.py``)
_CHANNEL_MAJOR_KINDS = ("dense_const", "dense")
_MODES = ("both", "rhs", "operator")


@dataclass
class _Contribution:
    """One registered (kernel, element bucket) assembly contribution."""

    kernel: object
    tables: object
    verts: np.ndarray  # (E, n_verts, 3)
    elem_dofs: np.ndarray  # (E, n_nodes, n_unk) int64
    field_access: tuple | None  # (FieldAccess, element nodes (E, n_nodes)) or None
    time: float
    options: AssemblyOptions
    block: object = None  # source ElementBlock
    elem_sel: np.ndarray | None = None  # indices into the block (boundary views)
    mode: str = "both"  # "both" | "rhs" | "operator"
    dof_inds: tuple = ()
    domain_id: int = -1  # volume domain (parent domain for boundary buckets)
    boundary_id: int | None = None  # the boundary id the bucket came from
    op_data: tuple | None = None  # matrix-free: x-independent operator data, built on first use


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


def _last_solve_suffix(system) -> str:
    """"; last solve: ..." for a system's ``describe``, or "" before any solve."""
    r = getattr(system, "_last_solve_result", None)
    if r is None:
        return ""
    state = "converged" if r.converged else ("CAPPED (max_iters)" if r.capped else "NOT converged")
    return f"; last solve: {r.num_iters} iters, res {r.tol:.2e}, {state}"


class _SystemBase:
    """State and behaviour shared by the assembled, matrix-free and distributed systems."""

    def __init__(
        self,
        mesh: Mesh,
        problem: ProblemDefinition,
        bc_def: BCDefinition | None = None,
        params: AlgebraicSystemParams = AlgebraicSystemParams(),
        dtype=torch.float32,
        device=None,
    ):
        self.mesh = mesh
        self.problem = problem
        self.bc_def = bc_def
        self.params = params
        self.dtype = dtype
        self.device = _resolve_device(device)
        periodic_pairs, periodic_masks = match_periodic_nodes(
            mesh, bc_def, max_dofs=problem.max_dofs_per_node
        )
        self.dofmap = build_dof_map(
            mesh, problem, periodic_pairs, condensed_nodes=self._condensed_nodes(),
            periodic_dof_masks=periodic_masks,
        )
        self.n_dofs = self.dofmap.n_dofs
        self.n_rhs = params.n_rhs
        self.dirichlet_dofs = collect_dirichlet_dofs(mesh, self.dofmap, bc_def)
        free = np.ones(self.n_dofs, dtype=bool)
        free[self.dirichlet_dofs] = False
        self._free_np = free
        self.free_mask = self._tensor(free.astype(np.float64))
        self.dirichlet_values = self._tensor(np.zeros((len(self.dirichlet_dofs), self.n_rhs)))
        self.rhs = self._zeros((self.n_dofs, self.n_rhs))
        self.x = self._zeros((self.n_dofs, self.n_rhs))
        self._open = False
        self._effective_rhs = None
        self._contribs: list[_Contribution] = []
        self._assembly_epoch = 0  # bumped by end_assembly; keys preconditioner setups
        self._last_solve_result = None

    def _condensed_nodes(self) -> np.ndarray | None:
        """The interior nodes of every top-dimension volume block under
        ELEMENT_BOUNDARY condensation (left out of the dof numbering), else None."""
        if self.params.cond_policy != CondensationPolicy.ELEMENT_BOUNDARY:
            return None
        parts = []
        for did, blk in self.mesh.blocks():
            if blk.dim == self.mesh.dim and did not in self.mesh.boundary_ids:
                inn = internal_node_indices(blk.element_type, blk.order)
                if len(inn):
                    parts.append(blk.nodes[:, inn].reshape(-1))
        return np.unique(np.concatenate(parts)) if parts else None

    def _dofs_valid(self, elem_dofs: np.ndarray, block) -> bool:
        """Every dof of the contribution is numbered; on a condensed block only
        its element-boundary nodes need to be."""
        if self.params.cond_policy == CondensationPolicy.ELEMENT_BOUNDARY and block.dim == self.mesh.dim:
            bn = boundary_node_indices(block.element_type, block.order)
            return bool((elem_dofs[:, bn, :] >= 0).all())
        return bool((elem_dofs >= 0).all())

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
        self._begin_impl()

    def end_assembly(self) -> None:
        if not self._open:
            raise RuntimeError("end_assembly without begin_assembly")
        self._end_impl()
        self._open = False
        # operator values changed: preconditioner setups keyed on the old
        # epoch are stale (solve/krylov.py:_precond_parts)
        self._assembly_epoch += 1

    def assemble_problem(
        self,
        kernel,
        domain_ids,
        field_access=None,
        dof_inds=None,
        options: AssemblyOptions = AssemblyOptions(),
        time: float = 0.0,
        mode: str = "both",
    ) -> None:
        """Register (and, assembled, add) an equation kernel over domains or
        boundaries; ``mode`` "rhs" or "operator" contributes only that part."""
        if not self._open:
            raise RuntimeError("assemble_problem requires an open assembly (call begin_assembly)")
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        p = kernel.params
        if p.n_rhs != self.n_rhs:
            raise ValueError(f"kernel n_rhs={p.n_rhs} != system n_rhs={self.n_rhs}")
        dof_inds = tuple(range(p.n_unknowns)) if dof_inds is None else tuple(dof_inds)
        if len(dof_inds) != p.n_unknowns:
            raise ValueError("dof_inds length must equal kernel n_unknowns")
        if field_access is not None and field_access.n_fields != p.n_fields:
            raise ValueError(
                f"kernel expects {p.n_fields} fields, field access provides {field_access.n_fields}"
            )
        for tables, verts, nodes, block, sel, did, bid in self._buckets(kernel, domain_ids, options):
            elem_dofs = self.dofmap.element_dofs(nodes, dof_inds)
            if not self._dofs_valid(elem_dofs, block):
                raise ValueError(
                    f"kernel dof indices {dof_inds} not all active on the assembled domains"
                )
            c = _Contribution(
                kernel=kernel, tables=tables, verts=verts, elem_dofs=elem_dofs,
                field_access=(field_access, nodes) if field_access is not None else None, time=time,
                options=options, block=block, elem_sel=sel, mode=mode, dof_inds=dof_inds,
                domain_id=did, boundary_id=bid,
            )
            self._contribs.append(c)
            self._add_contribution(c)

    def init_problem(self, kernel, domain_ids, field_access=None, dof_inds=None,
                     options: AssemblyOptions = AssemblyOptions(), time: float = 0.0) -> None:
        """Contribute only the right-hand side (``initProblem`` analog)."""
        self.assemble_problem(kernel, domain_ids, field_access, dof_inds, options, time, mode="rhs")

    def define_operator(self, kernel, domain_ids, field_access=None, dof_inds=None,
                        options: AssemblyOptions = AssemblyOptions(), time: float = 0.0) -> None:
        """Contribute only the operator (``defineOperator`` analog)."""
        self.assemble_problem(kernel, domain_ids, field_access, dof_inds, options, time, mode="operator")

    def _buckets(self, kernel, domain_ids, options: AssemblyOptions):
        """Yield (tables, verts, nodes, block, sel, domain id, boundary id) for
        each bucket to assemble."""
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
                    yield tab, blk.vertices[sel], blk.nodes[sel], blk, sel, bv.parent_domain, bid
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
                yield domain_tables(blk.element_type, blk.order, qo), blk.vertices, blk.nodes, blk, None, did, None

    def _fields(self, c: _Contribution, geom, sel=slice(None)):
        """(values, gradients) of the contribution's fields at the QPs of its
        elements ``sel`` (``geom`` must carry physical derivatives), or
        (None, None) for a field-free contribution."""
        if c.field_access is None:
            return None, None
        fa, nodes = c.field_access
        nodal = fa.gather(nodes[sel]).to(dtype=geom.weights.dtype, device=geom.weights.device)
        return eval_fields(c.tables, geom, nodal)

    def _eval_operators(self, c: _Contribution, geom, sel=slice(None)):
        """(A, f) of a contribution's kernel at the QPs of its elements ``sel``."""
        fv, fd = self._fields(c, geom, sel)
        return eval_equation_kernel(c.kernel, geom, fv, fd, c.time)

    # -- gather-family operator data and local assembly (the matrix-free,
    # assembled and distributed systems) -------------------------------------

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

    @staticmethod
    def _const_operators(c: _Contribution):
        """The proven-constant A of a field-free volume kernel, else None (a
        kernel that reads fields takes the variable-coefficient kinds, as in
        the reference)."""
        if c.field_access is not None:
            return None
        return _constant_kernel_operators(c.kernel, c.time)

    def _geometry_packed(self, c: _Contribution, with_operators: bool = False):
        """(Ji_t (dim, dim, EQ), w_t (EQ,)) in block element-major order and in
        float64 whatever the system dtype: the separable-geometry check needs
        exact zeros and per-axis constants that float32 rounding would break.
        Built in element chunks so the (E, Q, dim, dim) intermediates stay bounded.

        ``with_operators`` also evaluates the kernel's A at the same points and
        appends (nz, A_em): the (d, i, u) indices of A's planes that are nonzero
        somewhere (``np.argwhere`` order, as the reference finds them, in float64;
        ``((0, 0, 0),)`` when A is zero) and those planes as A_em (EQ, K) in the
        system dtype.  Only the planes nonzero in a chunk are kept from it."""
        E, Q = c.verts.shape[0], c.tables.n_qp
        chunk = max(1, (1 << (19 if with_operators else 22)) // max(Q, 1))
        dim = c.tables.dim
        ji, w, pieces, amax = [], [], [], None
        for s in range(0, E, chunk):
            sel = slice(s, s + chunk)
            verts = self._tensor(c.verts[sel], torch.float64)
            g = element_geometry(
                c.tables, verts, with_phys_ders=with_operators and c.field_access is not None
            )
            ji.append(g.jac_inv.reshape(-1, dim, dim))
            w.append(g.weights.reshape(-1))
            if with_operators:
                A, _ = self._eval_operators(c, g, sel)
                shape = A.shape[2:]
                A = A.reshape(A.shape[0] * A.shape[1], -1)
                m = A.abs().amax(dim=0).cpu()
                amax = m if amax is None else torch.maximum(amax, m)
                sel = torch.nonzero(m > 0).flatten()
                pieces.append((sel.tolist(), A[:, sel.to(A.device)].to(self.dtype)))
        Ji_t, w_t = torch.cat(ji).permute(1, 2, 0), torch.cat(w)
        if not with_operators:
            return Ji_t, w_t
        mx = amax.reshape(shape).numpy()
        nz = tuple(tuple(int(v) for v in ix) for ix in np.argwhere(mx > 0.0)) or ((0, 0, 0),)
        col = {int(np.ravel_multi_index(ix, mx.shape)): k for k, ix in enumerate(nz)}
        A_em = self._zeros((w_t.shape[0], len(nz)))
        off = 0
        for sel, vals in pieces:
            A_em[off : off + vals.shape[0], [col[f] for f in sel]] = vals
            off += vals.shape[0]
        return Ji_t, w_t, nz, A_em

    def _packed_operators(self, c: _Contribution):
        """(A_t (dim+1, n_eq, n_unk, EQ), Ji_t (dim, dim, EQ), w_t (EQ,)) of a
        variable-coefficient volume contribution: the reference's per-epoch
        value pass (``_op_value_builder``), in the system dtype, element-major,
        built in element chunks."""
        from .local import pack_sumfact_operator

        E, Q = c.verts.shape[0], c.tables.n_qp
        chunk = max(1, (1 << 19) // max(Q, 1))
        parts = []
        for s in range(0, E, chunk):
            sel = slice(s, s + chunk)
            geom = element_geometry(
                c.tables, self._tensor(c.verts[sel]), with_phys_ders=c.field_access is not None
            )
            A, _ = self._eval_operators(c, geom, sel)
            parts.append(pack_sumfact_operator(A, geom, c.tables.dim))
        return tuple(torch.cat([p[i] for p in parts], dim=-1).contiguous() for i in range(3))

    def _local_apply(self, c: _Contribution, d, x_loc: torch.Tensor, channel_major: bool = False) -> torch.Tensor:
        """y_loc (E, n_sel, n_unk) of one gather-family contribution from x_loc
        of the same shape; with ``channel_major`` (the kinds of
        ``_CHANNEL_MAJOR_KINDS`` only), both (E, n_unk, n_sel)."""
        dim, order = c.tables.dim, c.tables.order
        q_order = c.options.quadrature_order(order)
        if d[0] == "dense_const":
            from .local import local_apply_dense_const

            return local_apply_dense_const(d[1], d[2], d[3], d[4], dim, x_loc, channel_major)
        if d[0] == "dense":
            from .local import local_apply_dense_packed

            return local_apply_dense_packed(d[1], d[2], d[3], d[4], dim, x_loc, channel_major)
        if d[0] == "sumfact":
            from .local import local_apply_sumfact_packed

            return local_apply_sumfact_packed(d[1], d[2], d[3], order, q_order, dim, x_loc)
        if d[0] == "sumfact_const":
            from .local import local_apply_sumfact_const

            return local_apply_sumfact_const(d[1], d[2], d[3], x_loc.shape[0], order, q_order, dim, x_loc)
        if d[0] == "pallas":
            from ..ops.sumfact_fused import sumfact_const_apply

            y = sumfact_const_apply(d[1], d[2], d[3], order, q_order, dim, x_loc.to(torch.float32))
            return y.to(x_loc.dtype)
        from .local import local_apply_direct

        return local_apply_direct(d[1], d[2], d[3], x_loc)

    def _direct_parts(self, c: _Contribution, geom=None, A=None, dmask=None):
        """(A, B, w, ns) of the direct apply with the reference's structural
        restriction: identically-zero derivative blocks of A are dropped, and
        basis columns with no support (off-face nodes of a value-only
        boundary kernel) too; ``ns`` lists the local nodes kept (None: all)."""
        if geom is None:
            geom = element_geometry(
                c.tables, self._tensor(c.verts), with_phys_ders=c.field_access is not None
            )
            A, _ = self._eval_operators(c, geom)
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
        return A, B, geom.weights, ns

    def _local_kf(self, c: _Contribution, sel: slice):
        """(K (E, L, L) or None, F (E, L, n_rhs) or None) of the elements
        ``sel`` of a contribution, as its mode asks."""
        geom = element_geometry(c.tables, self._tensor(c.verts[sel], _ASM_DTYPE))
        if c.mode == "rhs":
            A, f = self._eval_operators(c, geom, sel)
            F = local_rhs(A, _basis_stack(c.tables, geom), geom.weights, f)
            return None, F.reshape(F.shape[0], -1, self.n_rhs)
        fv, fd = self._fields(c, geom, sel)
        K, F = local_system(c.kernel, c.tables, geom, fv, fd, c.time)
        return K, (None if c.mode == "operator" else F)

    @staticmethod
    def _chunk(c: _Contribution) -> int:
        """Elements per local assembly chunk (bounds the M tensor, ``_M_ENTRIES``)."""
        n_loc = c.elem_dofs.shape[1] * c.elem_dofs.shape[2]
        return max(1, _M_ENTRIES // max(c.tables.n_qp * c.kernel.params.n_equations * n_loc, 1))

    # subclass hooks
    def _begin_impl(self) -> None:
        raise NotImplementedError

    def _add_contribution(self, c: _Contribution) -> None:
        """Called for each registered contribution (the matrix-free system
        only keeps it, in ``_contribs``)."""

    def _end_impl(self) -> None:
        raise NotImplementedError

    def raw_parts(self, layout: str = "dof"):
        raise NotImplementedError

    def raw_operator(self):
        """The unconstrained operator as one callable x -> A x, over :meth:`raw_parts`."""
        fn, consts = self.raw_parts()
        return lambda x: fn(x, *consts)

    def diagonal(self) -> torch.Tensor:
        raise NotImplementedError

    # -- Dirichlet values (``AssembledSystem.hpp:158-286`` analog) ------------

    def set_dirichlet_bc_values(self, values, boundaries=None, dof_inds=None, field_access=None, time=0.0):
        """Set Dirichlet values from a boundary residual kernel (averaged at
        shared nodes, reading fields if given), from per-dof constants on
        given boundaries, or directly from an array matching the Dirichlet
        dof list."""
        if boundaries is None:  # raw array aligned with the Dirichlet dof list
            vals = torch.as_tensor(values, dtype=self.dtype, device=self.device).reshape(-1, self.n_rhs)
            if vals.shape[0] != len(self.dirichlet_dofs):
                raise ValueError("value array length != number of Dirichlet dofs")
            self.dirichlet_values = vals.clone()
            self._effective_rhs = None
            return
        if callable(getattr(values, "evaluate", None)):
            self._set_dirichlet_from_kernel(values, boundaries, dof_inds, field_access, time)
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

    def _set_dirichlet_from_kernel(self, kernel, boundaries, dof_inds, field_access, time) -> None:
        """Kernel equation i gives the value of dof ``dof_inds[i]`` at each node
        of the boundaries; nodes whose dof is not Dirichlet are skipped."""
        from .values_at_nodes import compute_boundary_values_at_nodes

        n_eq = kernel.params.n_equations
        dof_inds = tuple(dof_inds) if dof_inds is not None else tuple(range(n_eq))
        vals, mask = compute_boundary_values_at_nodes(
            kernel, self.mesh, boundaries, field_access, time, self.dtype, self.device
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


    # -- solve-side interface --------------------------------------------------

    def lattice_layout_key(self):
        """(n1, n_rows, n_unk) when the operator can run on channel-major
        vectors (see MatrixFreeSystem); None otherwise."""
        return None

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
            fn, consts = self.raw_parts()
            g = self.dirichlet_extension()
            self._effective_rhs = self.free_mask[:, None] * (self.rhs - fn(g, *consts)) + g
        return self._effective_rhs

    def solution_vector(self) -> torch.Tensor:
        return self.x

    def set_solution_vector(self, x: torch.Tensor) -> None:
        self.x = x.reshape(self.n_dofs, self.n_rhs)

    def set_values(self, kernel, domain_ids, dof_inds=None, field_access=None, time=0.0) -> None:
        """Set solution-vector values from a residual kernel evaluated at
        nodes (averaged at shared nodes): initial conditions, the analog of
        ``AssembledSystem::setValues`` (``algsys/AssembledSystem.hpp:158-286``)."""
        from .values_at_nodes import compute_values_at_nodes

        dof_inds = tuple(dof_inds) if dof_inds is not None else tuple(range(kernel.params.n_equations))
        vals, mask = compute_values_at_nodes(
            kernel, self.mesh, domain_ids, field_access, time, self.dtype, self.device
        )  # (n_nodes, n_eq, n_rhs)
        nodes = np.nonzero(mask.cpu().numpy())[0]
        x = self.x.clone()
        for i, di in enumerate(dof_inds):
            dofs = self.dofmap.node_dof[nodes, di]
            ok = dofs >= 0
            x[torch.as_tensor(dofs[ok], device=self.device)] = vals[
                torch.as_tensor(nodes[ok], device=self.device), i, :
            ]
        self.x = x

    def update_solution(self, dof_inds, solution_manager, slot_inds, rhs_index: int = 0) -> None:
        """Copy solution components into SolutionManager slots (nodal layout);
        nodes where a component is not active get zero.  The manager's values
        are replaced, not written in place, so a FieldAccess taken earlier
        keeps the values it was taken with."""
        dof_inds = [int(d) for d in dof_inds]
        slot_inds = [int(s) for s in slot_inds]
        if len(dof_inds) != len(slot_inds):
            raise ValueError("dof_inds and slot_inds must have equal length")
        nd = self.dofmap.node_dof[:, dof_inds]  # (n_nodes, k)
        has = torch.as_tensor(nd >= 0, device=self.device)
        safe = torch.as_tensor(np.where(nd >= 0, nd, 0), device=self.device)
        vals = torch.where(has, self.x[safe, rhs_index], torch.zeros((), dtype=self.dtype, device=self.device))
        new = solution_manager.values.clone()
        new[:, slot_inds] = vals.to(dtype=new.dtype, device=new.device)
        solution_manager.values = new

    def solve(self, solver):
        """Run a solver object; returns its IterSolveResult."""
        return solver.solve(self)

    def _describe_extra(self) -> str:
        return ""

    def describe(self) -> str:
        s = (
            f"{type(self).__name__}: {self.n_dofs} dofs, {self.n_rhs} rhs, "
            f"{len(self.dirichlet_dofs)} Dirichlet dofs, dtype={self.dtype}, "
            f"device={self.device}{self._describe_extra()}"
        )
        return s + _last_solve_suffix(self)


class MatrixFreeSystem(_SystemBase):
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
            raise ValueError("matrix-free evaluation cannot be combined with static condensation")
        super().__init__(mesh, problem, bc_def, params, dtype, device)
        self._diag = None
        self._ops = None  # (lattice_key, [(contribution, op_data)]) once built
        self._variant = "v2"  # lattice pipeline, read from the environment with the operator

    def _begin_impl(self) -> None:
        self._diag = None
        self._ops = None

    def _end_impl(self) -> None:
        """The rhs and operator diagonal in one pass (``MatrixFreeSystem.hpp:887-941``),
        each only where the contribution's mode asks for it; large contributions
        run in element chunks to bound the (E, Q, ...) intermediates."""
        rhs = self._zeros((self.n_dofs, self.n_rhs))
        diag = self._zeros((self.n_dofs,))
        for c in self._contribs:
            use_sf = self._use_sumfact(c)
            E = c.verts.shape[0]
            chunk = int(max(1, (1 << 25) // max(c.tables.n_qp * 128, 1)))
            q_order = c.options.quadrature_order(c.tables.order)
            for s in range(0, E, chunk):
                sel = slice(s, s + chunk)
                geom = element_geometry(
                    c.tables, self._tensor(c.verts[sel]),
                    with_phys_ders=not use_sf or c.field_access is not None,
                )
                A, f = self._eval_operators(c, geom, sel)
                B = None if use_sf else _basis_stack(c.tables, geom)
                idx = torch.as_tensor(c.elem_dofs[sel].reshape(-1), device=self.device)
                if c.mode != "operator":
                    if use_sf:
                        F = local_rhs_sumfact(A, geom, c.tables.order, q_order, c.tables.dim, f)
                    else:
                        F = local_rhs(A, B, geom.weights, f)
                    rhs.index_add_(0, idx, F.reshape(-1, self.n_rhs))
                if c.mode != "rhs":
                    if use_sf:
                        d = local_diagonal_sumfact(A, geom, c.tables.order, q_order, c.tables.dim)
                    else:
                        d = local_diagonal(A, B, geom.weights)
                    diag.index_add_(0, idx, d.reshape(-1))
        self.rhs, self._diag = rhs, diag

    def _use_lattice_sf(self, c: _Contribution) -> bool:
        """Global banded sweeps: LATTICE_SF (which requires a lattice block), or
        AUTO when the volume block is a 2D or 3D lattice (the reference's AUTO
        on its accelerator, taken here on every device)."""
        strat = c.options.eval_strategy
        if c.tables.side is not None or strat not in (LocalEvalStrategy.AUTO, LocalEvalStrategy.LATTICE_SF):
            return False
        plan = self._lattice_plan(c)
        if plan is None and strat == LocalEvalStrategy.LATTICE_SF:
            raise ValueError("LATTICE_SF requires a structured-lattice mesh block")
        return plan is not None

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
        """Slicing plan of a boundary bucket covering one full side of a 2D or
        3D lattice block, restricted to the side's surface nodes ``ns``; None
        otherwise."""
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

    def _operator_data(self, c: _Contribution):
        """x-independent operator data of one contribution, built on first use."""
        if c.op_data is None:
            c.op_data = (
                self._boundary_data(c) if c.tables.side is not None else self._volume_data(c)
            )
        return c.op_data

    def _volume_data(self, c: _Contribution):
        """Operator data of a volume contribution, by the reference's strategy
        ladder: lattice kinds, else dense, sum-factorized or fused (A constant)
        or their variable-coefficient kinds, else direct."""
        if self._use_lattice_sf(c):
            return self._lattice_data(c)
        use_dense = self._use_dense(c)
        if not (use_dense or self._use_sumfact(c)):
            return self._direct_data(c)
        A_const = self._const_operators(c)
        if A_const is None:
            A_t, Ji_t, w_t = self._packed_operators(c)
            if use_dense:
                from ..ops.dense_eval import dense_basis_matrix

                Ball = self._tensor(dense_basis_matrix(c.tables))
                return ("dense", A_t, Ji_t, w_t, Ball, self._gather(c))
            return ("sumfact", A_t, Ji_t, w_t, self._gather(c))
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
        """("lattice_sf_const_diag", A, plan, jx, jy, jz, wyx, wz),
        ("lattice_sf_const", A, plan, Ji_l, w_l) or, when the constancy proof
        fails, ("lattice_sf_var", (nz, n_eq), plan, A_nz (K, EQ), Ji_l, w_l);
        per-QP tensors in interleaved lattice QP order."""
        from ..ops.lattice_sumfact import lattice_qp_perm
        from ..ops.zsweep import detect_diag_geometry

        plan = self._lattice_plan(c)
        A_const = self._const_operators(c)
        n1, ne, _, inv = plan
        q1 = c.options.quadrature_order(c.tables.order) // 2 + 1
        perm = torch.as_tensor(lattice_qp_perm(ne, q1, inv), device=self.device)
        if A_const is None:
            Ji_t, w_t, nz, A_em = self._geometry_packed(c, with_operators=True)
        else:
            Ji_t, w_t = self._geometry_packed(c)
        Ji_l, w_l = Ji_t[:, :, perm], w_t[perm]
        if A_const is None:
            # variable coefficients: only the nonzero (d, i, u) planes of A,
            # streamed per QP through the z-sweep
            A_nz = A_em[perm].T.contiguous()
            n_eq = c.kernel.params.n_equations
            return ("lattice_sf_var", (nz, n_eq), plan, A_nz, Ji_l.to(self.dtype), w_l.to(self.dtype))
        # axis-aligned separable geometry (every generated box mesh): five
        # per-axis vectors instead of the (3,3,EQ)+(EQ) tensors; the v1
        # z-sweep and the non-fused chain take full geometry only
        if self._variant in ("v2", "xy"):
            g = detect_diag_geometry(Ji_l.cpu().numpy(), w_l.cpu().numpy(), ne[2] * q1)
            if g is not None:
                return ("lattice_sf_const_diag", A_const, plan) + tuple(self._tensor(v) for v in g[1:])
        return ("lattice_sf_const", A_const, plan, Ji_l.to(self.dtype), w_l.to(self.dtype))

    def _boundary_data(self, c: _Contribution):
        """A value-only kernel on a full side of a 3D lattice runs as a banded
        face sweep (a 2D lattice's sides are lines: ``pack_face_banded`` takes
        none); every other boundary contribution is direct.  A direct one on a
        full lattice side also runs on the lattice layout, by its gather."""
        from ..ops.lattice_sumfact import pack_face_banded

        geom = element_geometry(c.tables, self._tensor(c.verts), with_phys_ders=c.field_access is not None)
        A, _ = self._eval_operators(c, geom)
        dmask = (A.abs().amax(dim=(0, 1, 3, 4)) > 0).cpu().numpy()
        if not dmask.any():
            return ("zero",)  # contributes nothing to the operator
        fp = None
        if not dmask[1:].any():  # value-only: touches only the side's surface nodes
            ns = np.nonzero(np.abs(c.tables.values).max(axis=0) > 0.0)[0]
            if 0 < len(ns) < c.tables.values.shape[1]:
                fp = self._face_plan(c, ns)
        packed = None
        if fp is not None:
            q_order = c.options.quadrature_order(c.tables.order)
            packed = pack_face_banded(
                A[:, :, :1].cpu().numpy(), geom.weights.cpu().numpy(), fp, c.tables.order, q_order
            )
        if packed is None:
            return self._direct_data(c, geom, A, dmask, face=fp)
        return ("face_banded", self._tensor(packed[0]), self._tensor(packed[1]), fp)

    def _direct_data(self, c: _Contribution, geom=None, A=None, dmask=None, face=None):
        """("direct", A, B, w, gather) of :meth:`_SystemBase._direct_parts`,
        the dofs of the dropped basis columns left out of the gather.
        ``face``: the slicing plan of a full lattice side the contribution
        covers (see :meth:`_gather`)."""
        A, B, w, ns = self._direct_parts(c, geom, A, dmask)
        return ("direct", A, B, w, self._gather(c, ns, face))

    def _gather(self, c: _Contribution, ns=None, face=None):
        """How the contribution's element values move, one of:

        - ``("face", fp)``: a bucket covering a full lattice side (``face``,
          restricted to its surface nodes): one plane of the channel-leading
          lattice tensor, cut into element windows (``ops.lattice.
          face_gather_tensor``), in either layout;
        - ``("lattice", plan, n_rows)``: a volume bucket whose node rows form
          a full lattice (a kind other than the lattice ones): element
          windows sliced from the (n_rows, n_unk) view (``lattice_gather``);
        - ``("rows", row_idx (E, n_nodes) int32, n_rows)``: node rows of an
          (n_rows, n_unk) view, when every node's kernel dofs are
          consecutive and row-aligned (``ops/rows.py``);
        - ``("dofs", idx (E, n_sel*n_unk))``: scalar dof indices, ``ns``
          restricting to a subset of local nodes."""
        if face is not None:
            return ("face", face)
        rows = self._row_plan(c) if ns is None else None
        if rows is not None:
            plan = self._lattice_plan(c)
            if plan is not None:
                return ("lattice", plan, rows[1])
            return ("rows", torch.as_tensor(rows[0], dtype=torch.int32, device=self.device), rows[1])
        dofs = c.elem_dofs if ns is None else c.elem_dofs[:, ns]
        return ("dofs", torch.as_tensor(dofs.reshape(dofs.shape[0], -1), device=self.device))

    def _operators(self):
        """(lattice_key, [(contribution, op_data)]): the lattice key (n1, n_rows,
        n_unk) when every contribution is of the lattice family and all share
        one lattice (the operator then runs on channel-major vectors too);
        None otherwise."""
        if self._ops is None:
            if self._open or self._diag is None:
                raise RuntimeError("the operator is available after end_assembly")
            from ..ops.lattice_sumfact import lattice_variant

            self._variant = lattice_variant(self.mesh.dim)
            ops, keys = [], set()
            for c in self._contribs:
                if c.mode == "rhs":
                    continue
                d = self._operator_data(c)
                if d[0] == "zero":
                    continue
                n_unk = c.elem_dofs.shape[2]
                if d[0] in _LATTICE_KINDS or d[0] == "face_banded":
                    n1 = d[2][0] if d[0] in _LATTICE_KINDS else d[3]["n1"]
                    keys.add((tuple(int(a) for a in n1), self.n_dofs // n_unk, n_unk))
                elif d[0] == "direct" and d[-1][0] == "face":  # a full lattice side
                    keys.add((tuple(d[-1][1]["n1"]), self.n_dofs // n_unk, n_unk))
                else:
                    keys.add(None)
                ops.append((c, d))
            self._ops = (keys.pop() if len(keys) == 1 else None, ops)
        return self._ops

    def lattice_layout_key(self):
        """(n1, n_rows, n_unk) when every operator contribution runs on one
        shared channel-leading lattice tensor; None otherwise."""
        return self._operators()[0]

    def _apply(self, x: torch.Tensor, lattice_io: bool, ops) -> torch.Tensor:
        """Unconstrained operator of the (contribution, op_data) list ``ops``
        on (n_dofs, n_rhs) vectors.  Lattice-family contributions work on one
        channel-leading tensor per rhs column; gather-family ones gather
        element values per column and scatter-add into one flat accumulator
        per column."""
        from ..ops.lattice import face_gather_tensor, face_scatter_tensor_add, lattice_gather, lattice_scatter_add
        from ..ops.lattice_sumfact import face_apply_banded, local_apply_lattice
        from ..ops.rows import gather_rows, scatter_rows_add

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
                A_c, plan, var = d[1], d[2], None
                key = (tuple(int(a) for a in plan[0]), self.n_dofs // n_unk, n_unk)
                if d[0] == "lattice_sf_var":
                    (nz, n_eq), A_c = d[1], None
                    var, Ji_l, w_l, geom = (nz, d[3], n_eq), d[4], d[5], None
                elif d[0] == "lattice_sf_const":
                    Ji_l, w_l, geom = d[3], d[4], None
                else:
                    Ji_l = w_l = None
                    geom = ("diag",) + tuple(d[3:])
                if A_c is not None and 1 < r_n <= 4:
                    # multi-RHS lane stacking: rhs columns ride as extra channels
                    # with a block-diagonal A -- ONE sweep instead of r_n
                    n_eq_c = A_c.shape[1]
                    A_eff = np.zeros((A_c.shape[0], n_eq_c * r_n, n_unk * r_n))
                    for rr in range(r_n):
                        A_eff[:, rr * n_eq_c : (rr + 1) * n_eq_c, rr * n_unk : (rr + 1) * n_unk] = A_c
                    t_st = torch.cat([t_in(key, rr) for rr in range(r_n)], dim=0)
                    yt = local_apply_lattice(
                        A_eff, Ji_l, w_l, c.tables.order, q_order, plan[0], plan[1], t_st,
                        geom=geom, tensor_io=True, variant=self._variant,
                    )
                    for rr in range(r_n):
                        acc(key, rr, yt[rr * n_unk : (rr + 1) * n_unk])
                    continue
                for r in range(r_n):
                    yt = local_apply_lattice(
                        A_c, Ji_l, w_l, c.tables.order, q_order, plan[0], plan[1], t_in(key, r),
                        geom=geom, tensor_io=True, var=var, variant=self._variant,
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
            how = d[-1]
            order = c.tables.order
            if how[0] == "face":  # one plane of the shared lattice tensor, either layout
                fp = how[1]
                key = (tuple(fp["n1"]), self.n_dofs // n_unk, n_unk)
                for r in range(r_n):
                    y_loc = self._local_apply(c, d, face_gather_tensor(t_in(key, r), fp, order))
                    if (key, r) not in tacc:
                        tacc[(key, r)] = x.new_zeros((n_unk,) + tuple(reversed(fp["n1"])))
                    face_scatter_tensor_add(y_loc, fp, order, tacc[(key, r)])
                continue
            for r in range(r_n):
                if r not in flat:
                    flat[r] = torch.zeros(self.n_dofs, dtype=x.dtype, device=x.device)
                if how[0] == "lattice":  # element windows sliced from the node-row view
                    _, plan, n_rows = how
                    y_loc = self._local_apply(c, d, lattice_gather(x[:, r].reshape(n_rows, n_unk), plan, order))
                    flat[r] += lattice_scatter_add(y_loc, plan, order).reshape(-1)
                elif how[0] == "rows":  # node-row gather / scatter, in the local apply's layout
                    _, idx, n_rows = how
                    cm = d[0] in _CHANNEL_MAJOR_KINDS
                    x_loc = gather_rows(x[:, r].view(n_rows, n_unk), idx, cm)
                    scatter_rows_add(flat[r].view(n_rows, n_unk), idx, self._local_apply(c, d, x_loc, cm), cm)
                else:  # scalar dof indices (restricted node subsets)
                    idx = how[1]
                    y_loc = self._local_apply(c, d, x[idx, r].reshape(idx.shape[0], -1, n_unk))
                    flat[r].index_add_(0, idx.reshape(-1), y_loc.reshape(-1))
        y = torch.zeros_like(x)
        for (key, r), t in tacc.items():
            y[:, r] += t.reshape(-1) if lattice_io else t.reshape(key[2], -1).T.reshape(-1)
        for r, v in flat.items():
            y[:, r] += v
        return y

    def raw_parts(self, layout: str = "dof"):
        """(fn, (ops,)): the unconstrained operator as fn(x, ops), with ops
        the current assembly's list of (contribution, operator data).  A
        caller that keeps the consts keeps that assembly's operator after a
        reassembly, as the reference's consts do (a lagged preconditioner
        smooths with the operator of its setup)."""
        if layout not in ("dof", "lattice"):
            raise ValueError(f"unknown layout {layout!r}")
        lattice_io = layout == "lattice"
        key, ops = self._operators()
        if lattice_io and key is None:
            raise ValueError("lattice layout unavailable for this operator")
        return (lambda x, ops: self._apply(x, lattice_io, ops)), (ops,)

    def diagonal(self) -> torch.Tensor:
        if self._diag is None:
            raise RuntimeError("diagonal available after end_assembly")
        return self._diag * self.free_mask + (1.0 - self.free_mask)

    def _describe_extra(self) -> str:
        return f", {len(self._contribs)} matrix-free contributions"


# local assembly bounds the (E, Q * n_eq, n_loc) M tensor of a chunk of
# elements to this many entries
_M_ENTRIES = 1 << 26
# the assembled system's local matrices, data, rhs and Schur step, whatever
# its dtype (cast to it at end_assembly): a float32 p = 6 local matrix sums
# 12,096 products per entry and carries ~1e-5 relative rounding on the
# card, which the condensed system's solution amplified to 4e-3 in T
_ASM_DTYPE = torch.float64


def _csr_apply(x, A):
    return A @ x


@dataclass
class _CondensationAgg:
    """Per-block accumulator for ELEMENT_BOUNDARY static condensation
    (``algsys/StaticCondensationManager.hpp:152-207`` analog): every
    contribution touching the block's elements adds its interior-coupled
    sub-blocks here; the Schur complement is formed once at end_assembly and
    the interior solution recovered after the solve."""

    block: object
    act: np.ndarray  # active dof components on this block's domain
    b_nodes: np.ndarray
    i_nodes: np.ndarray
    b_dofs: np.ndarray  # (E, nb) global dof ids of the boundary space
    Kbi: torch.Tensor  # (E, nb, ni)
    Kii: torch.Tensor  # (E, ni, ni)
    Fi: torch.Tensor  # (E, ni, n_rhs)
    Y: torch.Tensor | None = None  # Kii^-1 Kib
    Z: torch.Tensor | None = None  # Kii^-1 Fi


def _cond_selectors(act, b_nodes, i_nodes, n_nodes, dof_inds):
    """Split a contribution's local (node-major) dof layout into boundary and
    interior selections plus their positions in the block aggregate's
    boundary/interior spaces (``StaticCondensationManager.hpp`` index maps).

    Returns (b_sel, tb, i_sel, ti): ``K[:, b_sel][:, :, i_sel]`` adds into
    aggregate coordinates ``(tb, ti)``."""
    n_unk = len(dof_inds)
    n_act = len(act)
    apos = np.searchsorted(act, np.asarray(dof_inds))
    if not np.array_equal(act[np.minimum(apos, n_act - 1)], np.asarray(dof_inds)):
        raise ValueError("kernel dof indices not active on the condensed block's domain")
    i_rank = {int(n): r for r, n in enumerate(i_nodes)}
    b_rank = {int(n): r for r, n in enumerate(b_nodes)}
    b_sel, tb, i_sel, ti = [], [], [], []
    for n in range(n_nodes):
        for u in range(n_unk):
            j = n * n_unk + u
            if n in i_rank:
                i_sel.append(j)
                ti.append(i_rank[n] * n_act + apos[u])
            else:
                b_sel.append(j)
                tb.append(b_rank[n] * n_act + apos[u])
    return tuple(np.asarray(a, dtype=np.int64) for a in (b_sel, tb, i_sel, ti))


def _schur_solve(Kii, Kib, Fi):
    """Batched Schur factor solves: Y = Kii^-1 Kib, Z = Kii^-1 Fi.

    LSFEM interior blocks are SPD (weighted A^T A), so the solves go through
    batched Cholesky.  Elements whose interior was never assembled (all
    diagonal entries zero) are substituted by the identity and their Y, Z
    zeroed, so they contribute nothing.  A partly assembled interior (some
    diagonal entries zero: singular) raises, as the reference does
    (``StaticCondensationManager.hpp:152-207`` asserts the condensed space
    is fully covered), and so does a block whose Cholesky factorization
    fails in the working dtype (the reference's would be NaN)."""
    row_ok = Kii.diagonal(dim1=1, dim2=2).abs() > 0
    all_zero = ~row_ok.any(dim=1)
    partial = ~all_zero & ~row_ok.all(dim=1)
    if bool(partial.any()):
        raise RuntimeError(
            "static condensation: element interiors only partially assembled "
            "(kernel dof_inds must cover all active dofs of the condensed domain)"
        )
    eye = torch.eye(Kii.shape[1], dtype=Kii.dtype, device=Kii.device)
    L, info = torch.linalg.cholesky_ex(torch.where(all_zero[:, None, None], eye, Kii))
    n_failed = int((info != 0).sum())
    if n_failed:
        raise RuntimeError(
            f"static condensation: the Cholesky factorization of {n_failed} element "
            f"interior block(s) failed in {Kii.dtype} (not positive definite at this precision)"
        )
    ok = (~all_zero).to(Kii.dtype)[:, None, None]
    return torch.cholesky_solve(Kib, L) * ok, torch.cholesky_solve(Fi, L) * ok


class AssembledSystem(_SystemBase):
    """Explicit CSR system (``algsys/AssembledSystem.hpp``).  The sparsity
    pattern and the scatter positions are built on the host in numpy; local
    matrices are computed on the device in element chunks (the reference
    takes a block at once) and scattered into ``data`` with ``index_add_``;
    the SpMV is the CSR product ``A @ x``.  Under ELEMENT_BOUNDARY
    condensation a volume block's element-boundary block goes to ``data`` and
    its interior couplings to the block's :class:`_CondensationAgg`.  Local
    matrices are formed, and ``data``, ``rhs`` and the Schur step
    accumulated, in float64 (``_ASM_DTYPE``); ``end_assembly`` casts ``data``
    and ``rhs`` to the system's dtype, in which the solves run (the
    reference assembles in the system's dtype)."""

    def __init__(
        self,
        mesh: Mesh,
        problem: ProblemDefinition,
        bc_def: BCDefinition | None = None,
        params: AlgebraicSystemParams = AlgebraicSystemParams(),
        dtype=torch.float32,
        device=None,
    ):
        super().__init__(mesh, problem, bc_def, params, dtype, device)
        self._build_sparsity()
        self.data = self._asm_zeros((self.nnz,))
        self._pos_cache: OrderedDict[bytes, np.ndarray] = OrderedDict()
        self._csr = None
        self._cond_aggs: dict[int, _CondensationAgg] = {}

    # -- sparsity (``algsys/SparsityGraph.hpp`` analog, host-side) ------------

    def _build_sparsity(self) -> None:
        """The diagonal and every pair of dofs of one element: the pattern of
        B^T B for each block's element-dof incidence B (a SciPy sparse
        product, which forms each row's columns without sorting all the
        pairs), the reference's set of keys (``row * n + col``) in order."""
        import scipy.sparse as sp

        n = self.n_dofs
        pattern = sp.identity(n, dtype=np.int32, format="csr")
        for domain_ids, mask in self.problem.entries:
            dof_cols = np.nonzero(mask)[0]
            for _, blk in self.mesh.blocks(domain_ids):
                dofs = self.dofmap.node_dof[blk.nodes][:, :, dof_cols].reshape(blk.n_elements, -1)
                dofs = dofs[:, (dofs >= 0).all(axis=0)] if (dofs < 0).any() else dofs
                E, L = dofs.shape
                B = sp.csr_matrix(
                    (np.ones(E * L, np.int32), dofs.reshape(-1), np.arange(0, E * L + 1, L)), shape=(E, n)
                )
                pattern = pattern + (B.T @ B).tocsr()
        pattern.sort_indices()
        self._indptr = pattern.indptr.astype(np.int64)
        self._rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(self._indptr))
        self._cols = pattern.indices.astype(np.int64)
        keys = self._rows * n + self._cols
        self._keys = keys
        self.nnz = len(keys)
        self._diag_pos = np.searchsorted(keys, np.arange(self.n_dofs, dtype=np.int64) * (self.n_dofs + 1))
        dev = self.device
        self._cols_dev = torch.as_tensor(self._cols, device=dev)
        self._indptr_dev = torch.as_tensor(self._indptr, device=dev)
        self._diag_pos_dev = torch.as_tensor(self._diag_pos, device=dev)

    def _scatter_positions(self, elem_dofs: np.ndarray) -> np.ndarray:
        """(E, L, L) positions in ``data`` of each element's local matrix;
        a bounded LRU keyed by the element dofs."""
        key = elem_dofs.tobytes()
        hit = self._pos_cache.get(key)
        if hit is not None:
            self._pos_cache.move_to_end(key)
            return hit
        E = elem_dofs.shape[0]
        flat = elem_dofs.reshape(E, -1)
        L = flat.shape[1]
        k = flat[:, :, None] * self.n_dofs + flat[:, None, :]
        pos = np.searchsorted(self._keys, k.reshape(-1)).reshape(E, L, L)
        if not np.array_equal(self._keys[np.minimum(pos.reshape(-1), self.nnz - 1)], k.reshape(-1)):
            raise RuntimeError("element couples dofs outside the sparsity pattern")
        while len(self._pos_cache) >= 16:
            self._pos_cache.popitem(last=False)
        self._pos_cache[key] = pos
        return pos

    def _asm_zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=_ASM_DTYPE, device=self.device)

    def _begin_impl(self) -> None:
        self.data = self._asm_zeros((self.nnz,))
        self.rhs = self._asm_zeros((self.n_dofs, self.n_rhs))
        self._csr = None
        self._cond_aggs = {}

    def _add_contribution(self, c: _Contribution) -> None:
        if (
            self.params.cond_policy == CondensationPolicy.ELEMENT_BOUNDARY
            and c.block.dim == self.mesh.dim
            and len(internal_node_indices(c.block.element_type, c.block.order))
        ):
            self._add_condensed(c)
            return
        E = c.elem_dofs.shape[0]
        chunk = self._chunk(c)
        pos = None if c.mode == "rhs" else self._scatter_positions(c.elem_dofs)
        for s in range(0, E, chunk):
            sel = slice(s, s + chunk)
            K, F = self._local_kf(c, sel)
            if K is not None:
                idx = torch.as_tensor(pos[sel].reshape(-1), device=self.device)
                self.data.index_add_(0, idx, K.reshape(-1))
            if F is not None:
                idx = torch.as_tensor(c.elem_dofs[sel].reshape(-1), device=self.device)
                self.rhs.index_add_(0, idx, F.reshape(-1, self.n_rhs))

    # -- static condensation (``StaticCondensationManager.hpp`` analog) ----------

    def _get_cond_agg(self, c: _Contribution) -> _CondensationAgg:
        blk = c.block
        agg = self._cond_aggs.get(id(blk))
        if agg is None:
            act = np.nonzero(self.problem.active_mask(c.domain_id))[0]
            b_nodes = boundary_node_indices(blk.element_type, blk.order)
            i_nodes = internal_node_indices(blk.element_type, blk.order)
            E = blk.n_elements
            nb, ni = len(b_nodes) * len(act), len(i_nodes) * len(act)
            agg = _CondensationAgg(
                block=blk, act=act, b_nodes=b_nodes, i_nodes=i_nodes,
                b_dofs=self.dofmap.node_dof[blk.nodes[:, b_nodes]][:, :, act].reshape(E, nb),
                Kbi=self._asm_zeros((E, nb, ni)), Kii=self._asm_zeros((E, ni, ni)),
                Fi=self._asm_zeros((E, ni, self.n_rhs)),
            )
            self._cond_aggs[id(blk)] = agg
        return agg

    def _add_condensed(self, c: _Contribution) -> None:
        """A contribution on a condensed block, in element chunks: its
        boundary-boundary block goes to ``data`` and the boundary rhs to
        ``rhs``; its boundary-interior and interior blocks and the interior
        rhs add into the block's aggregate (``c.elem_sel`` places a boundary
        bucket's elements in the block)."""
        agg = self._get_cond_agg(c)
        E, n_nodes, _ = c.elem_dofs.shape
        b_sel, tb, i_sel, ti = _cond_selectors(agg.act, agg.b_nodes, agg.i_nodes, n_nodes, c.dof_inds)
        dev = self.device
        b_sel_t, i_sel_t = torch.as_tensor(b_sel, device=dev), torch.as_tensor(i_sel, device=dev)
        tb_t, ti_t = torch.as_tensor(tb, device=dev), torch.as_tensor(ti, device=dev)
        rows_all = np.asarray(c.elem_sel if c.elem_sel is not None else np.arange(E), dtype=np.int64)
        bdofs = c.elem_dofs.reshape(E, -1)[:, b_sel]
        pos = None if c.mode == "rhs" else self._scatter_positions(bdofs)
        chunk = self._chunk(c)
        for s in range(0, E, chunk):
            sel = slice(s, s + chunk)
            K, F = self._local_kf(c, sel)
            rows = torch.as_tensor(rows_all[sel], device=dev)
            if K is not None:
                Kb = K[:, b_sel_t]
                idx = torch.as_tensor(pos[sel].reshape(-1), device=dev)
                self.data.index_add_(0, idx, Kb[:, :, b_sel_t].reshape(-1))
                if len(i_sel):
                    Kbi, Kii = Kb[:, :, i_sel_t], K[:, i_sel_t][:, :, i_sel_t]
                    agg.Kbi.index_put_((rows[:, None, None], tb_t[None, :, None], ti_t[None, None, :]), Kbi,
                                       accumulate=True)
                    agg.Kii.index_put_((rows[:, None, None], ti_t[None, :, None], ti_t[None, None, :]), Kii,
                                       accumulate=True)
            if F is not None:
                idx = torch.as_tensor(bdofs[sel].reshape(-1), device=dev)
                self.rhs.index_add_(0, idx, F[:, b_sel_t].reshape(-1, self.n_rhs))
                if len(i_sel):
                    agg.Fi.index_put_((rows[:, None], ti_t[None, :]), F[:, i_sel_t], accumulate=True)

    def _end_impl(self) -> None:
        """Form each condensed block's Schur complement and add it to the
        system (``StaticCondensationManager::endAssembly`` analog); ``data``
        and ``rhs`` are rebound only once every aggregate has succeeded, so a
        failed end_assembly can be retried without adding Schur terms twice."""
        data, rhs, yz = self.data, self.rhs, []
        for agg in self._cond_aggs.values():
            Y, Z = _schur_solve(agg.Kii, agg.Kbi.transpose(1, 2), agg.Fi)
            pos = torch.as_tensor(self._scatter_positions(agg.b_dofs).reshape(-1), device=self.device)
            data = data.index_add(0, pos, torch.bmm(agg.Kbi, Y).reshape(-1), alpha=-1)
            b_idx = torch.as_tensor(agg.b_dofs.reshape(-1), device=self.device)
            rhs = rhs.index_add(0, b_idx, torch.bmm(agg.Kbi, Z).reshape(-1, self.n_rhs), alpha=-1)
            yz.append((agg, Y, Z))
        self.data, self.rhs = data.to(self.dtype), rhs.to(self.dtype)
        for agg, Y, Z in yz:
            agg.Y, agg.Z = Y.to(self.dtype), Z.to(self.dtype)
        self._csr = torch.sparse_csr_tensor(
            self._indptr_dev, self._cols_dev, self.data, size=(self.n_dofs, self.n_dofs),
            check_invariants=False,
        )

    def recover_condensed_solution(self, rhs_index: int = 0):
        """[(aggregate, interior node ids (E, n_i), values (E, n_i, n_act))]:
        each condensed block's interior values from the current solution,
        u_i = Kii^-1 (F_i - Kib u_b)."""
        out = []
        for agg in self._cond_aggs.values():
            if agg.Y is None:
                continue
            ub = self.x[torch.as_tensor(agg.b_dofs, device=self.device), rhs_index]  # (E, nb)
            ui = agg.Z[..., rhs_index] - torch.bmm(agg.Y, ub[:, :, None])[..., 0]
            vals = ui.reshape(ub.shape[0], len(agg.i_nodes), len(agg.act))
            out.append((agg, agg.block.nodes[:, agg.i_nodes], vals))
        return out

    def update_solution(self, dof_inds, solution_manager, slot_inds, rhs_index: int = 0) -> None:
        """The boundary values as in the base class, then each condensed
        block's recovered interior values into the same slots."""
        super().update_solution(dof_inds, solution_manager, slot_inds, rhs_index)
        if not self._cond_aggs:
            return
        new = solution_manager.values.clone()
        for agg, nodes, vals in self.recover_condensed_solution(rhs_index):
            idx = torch.as_tensor(nodes.reshape(-1), device=new.device)
            for di, si in zip(dof_inds, slot_inds):
                hit = np.nonzero(agg.act == int(di))[0]
                if len(hit):
                    new[idx, int(si)] = vals[:, :, int(hit[0])].reshape(-1).to(dtype=new.dtype, device=new.device)
        solution_manager.values = new

    def raw_parts(self, layout: str = "dof"):
        """(fn, (A,)): the unconstrained operator as the CSR product A @ x."""
        if layout != "dof":
            raise ValueError("AssembledSystem supports only the dof layout")
        if self._csr is None:
            raise RuntimeError("the operator is available after end_assembly")
        return _csr_apply, (self._csr,)

    def diagonal(self) -> torch.Tensor:
        """The constrained operator's diagonal (unit on Dirichlet dofs)."""
        d = self.data[self._diag_pos_dev]
        return d * self.free_mask + (1.0 - self.free_mask)

    def eliminated_csr(self):
        """(data, indices, indptr, n): CSR of the Dirichlet-eliminated matrix,
        data on the device, the structure as host numpy arrays."""
        free = torch.as_tensor(self._free_np, device=self.device)
        keep = free[torch.as_tensor(self._rows, device=self.device)] & free[self._cols_dev]
        data = torch.where(keep, self.data, torch.zeros_like(self.data))
        data = data.index_add(0, self._diag_pos_dev, 1.0 - self.free_mask)
        return data, self._cols, self._indptr, self.n_dofs

    def eliminated_dense(self) -> np.ndarray:
        """The Dirichlet-eliminated matrix as a dense host float64 array (n, n)."""
        data, indices, indptr, n = self.eliminated_csr()
        dense = np.zeros((n, n))
        dense[np.repeat(np.arange(n), np.diff(indptr)), indices] = data.cpu().numpy()
        return dense

    def _describe_extra(self) -> str:
        return f", nnz={self.nnz}"


def make_algebraic_system(
    mesh: Mesh,
    problem: ProblemDefinition,
    bc_def: BCDefinition | None = None,
    params: AlgebraicSystemParams = AlgebraicSystemParams(),
    dtype=torch.float32,
    device=None,
):
    """Factory (``algsys/MakeAlgebraicSystem.hpp:9-46``) dispatching on the
    evaluation strategy.  Runs on the CUDA device unless ``device`` says
    otherwise; without CUDA it raises rather than fall back to the CPU."""
    if params.eval_strategy == OperatorEvaluationStrategy.MATRIX_FREE:
        return MatrixFreeSystem(mesh, problem, bc_def, params, dtype, device)  # raises under condensation
    return AssembledSystem(mesh, problem, bc_def, params, dtype, device)
