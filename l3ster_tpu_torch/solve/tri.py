"""Level-scheduled sparse triangular solves (PyTorch port of ``l3ster_tpu.solve.tri``).

Support for the SGS and ILU(0)/ILUT preconditioners, with ``ilu0_factor``
(the host zero-fill factorization, ``hostops.ilu0_factor_csr``)
(``solve/Ifpack2Preconditioners.hpp:97,148``).  A host analysis groups the
rows into levels with no dependencies inside a level (``hostops.tri_levels``);
the solve then walks the levels in order, each level one batched gather,
multiply and ``index_add_`` segment sum on the device.

The reference runs the walk as one ``lax.fori_loop`` over levels padded to
common widths.  Here it is a Python loop over unpadded levels, on vectors
permuted so that each level's rows are contiguous: the solve starts from
``x = D^-1 b`` (permuted once), and level ``l`` adds ``-D^-1 T x`` over its
rows' entries into its own slice of x, so a level costs three launches
(gather, multiply, ``index_add_``) and writes no scatter.  The host loop over
levels is the cost at thousands of levels (``PERF.md``).

The shard-stacked solves of a distributed system's additive-Schwarz
preconditioners (:func:`build_tri_solve_stacked`) run as one solve of the
block-diagonal matrix of all shards, its levels the shards' levels merged
(the reference pads the shards' schedules to common shapes and runs them
as one batch).
"""

from __future__ import annotations

import numpy as np
import torch

from .hostops import ilu0_factor_csr as ilu0_factor  # re-exported under the reference's name
from .hostops import tri_levels

__all__ = ["build_tri_solve", "build_tri_solve_stacked", "ilu0_factor", "tri_schedule"]


def tri_schedule(data, indices, indptr, n: int, lower: bool, unit_diag: bool):
    """Host level schedule of one triangular solve, T = the strictly lower or
    upper part of the CSR plus its diagonal (or a unit diagonal).

    Returns ``(rows, dinv, row_off, cols, vals, seg, ent_off)``: the rows
    grouped by level (level ``l`` is ``rows[row_off[l]:row_off[l + 1]]``,
    increasing within a level) with their inverted diagonal, and the
    triangular entries grouped by level in CSR order (``cols``, ``vals``, and
    ``seg``, the position of the entry's row within its level; level ``l`` is
    ``[ent_off[l], ent_off[l + 1])``).  These are the reference's
    ``_tri_consts_np`` maps without their padding to common widths."""
    data = np.asarray(data, dtype=np.float64)
    indices = np.asarray(indices, dtype=np.int64)
    indptr = np.asarray(indptr, dtype=np.int64)
    rows_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    tri_mask = (indices < rows_all) if lower else (indices > rows_all)
    tri_rows, tri_cols, tri_vals = rows_all[tri_mask], indices[tri_mask], data[tri_mask]
    if unit_diag:
        dinv = np.ones(n)
    else:
        dmask = indices == rows_all
        dvals = np.zeros(n)
        dvals[rows_all[dmask]] = data[dmask]
        if (dvals == 0).any():
            raise ValueError("triangular solve requires nonzero diagonal entries")
        dinv = 1.0 / dvals
    level = tri_levels(indices, indptr, n, lower)
    n_lv = int(level.max()) + 1 if n else 1
    rows = np.argsort(level, kind="stable")
    row_off = np.searchsorted(level[rows], np.arange(n_lv + 1))
    slot = np.empty(n, dtype=np.int64)
    slot[rows] = np.arange(n, dtype=np.int64) - row_off[level[rows]]
    ent_lv = level[tri_rows]
    order = np.argsort(ent_lv, kind="stable")
    ent_off = np.searchsorted(ent_lv[order], np.arange(n_lv + 1))
    return (
        rows, dinv[rows], row_off, tri_cols[order], tri_vals[order], slot[tri_rows[order]], ent_off,
    )


def build_tri_solve(data, indices, indptr, n: int, lower: bool, unit_diag: bool, dtype, device):
    """A solver for T x = b, T = the triangular part (plus diagonal) of the
    given CSR, on ``device`` in ``dtype``.

    Returns ``(apply, consts)`` with ``apply(b, *consts) -> x`` for ``b``
    (n, n_rhs); ``apply.n_levels`` is the number of levels and
    ``apply.launches`` the device launches of one call."""
    rows, dinv, row_off, cols, vals, seg, ent_off = tri_schedule(data, indices, indptr, n, lower, unit_diag)
    pos = np.empty(n, dtype=np.int64)
    pos[rows] = np.arange(n, dtype=np.int64)  # row -> its place in level order
    # x_r = dinv_r b_r - sum_c (dinv_r v_rc) x_c, with every x_c of an earlier level
    at = row_off[np.repeat(np.arange(len(row_off) - 1), np.diff(ent_off))] + seg  # entry's row, level order
    scaled = -vals * dinv[at]
    levels = [
        (int(row_off[lv]), int(row_off[lv + 1]), int(ent_off[lv]), int(ent_off[lv + 1]))
        for lv in range(len(row_off) - 1)
        if ent_off[lv + 1] > ent_off[lv]
    ]
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    consts = (
        t(rows, torch.int64), t(pos, torch.int64), t(dinv, dtype),
        t(pos[cols], torch.int64), t(scaled, dtype), t(seg, torch.int64),
    )

    def apply(b, rows, pos, dinv, cols, vals, seg):
        x = b[rows] * dinv[:, None]
        for r0, r1, e0, e1 in levels:
            x[r0:r1].index_add_(0, seg[e0:e1], vals[e0:e1, None] * x[cols[e0:e1]])
        return x[pos]

    apply.n_levels = len(row_off) - 1
    apply.launches = 3 + 3 * len(levels)
    return apply, consts



def build_tri_solve_stacked(csrs, n: int, lower: bool, unit_diag: bool, dtype, device):
    """Shard-stacked triangular solves for additive Schwarz: ``csrs`` is a
    list of per-shard ``(data, indices, indptr)`` over a common local size
    ``n``, solved with no communication (Ifpack2's per-rank local solves,
    ``solve/Ifpack2Preconditioners.hpp:85-192``).  The shards' matrices form
    one block-diagonal matrix, whose level schedule is the shards' own levels
    merged: level l holds every shard's level-l rows, so a solve walks the
    deepest shard's levels once for all shards.

    Returns ``(apply, consts)`` with ``apply(b, *consts) -> x`` for ``b``
    (P, n, n_rhs); ``apply.n_levels`` and ``apply.launches`` as in
    :func:`build_tri_solve`."""
    P = len(csrs)
    data = np.concatenate([np.asarray(d, dtype=np.float64) for d, _, _ in csrs])
    indices = np.concatenate([np.asarray(i, dtype=np.int64) + p * n for p, (_, i, _) in enumerate(csrs)])
    offs = np.cumsum([0] + [int(pp[-1]) for _, _, pp in csrs])
    indptr = np.concatenate([[0]] + [np.asarray(pp[1:], dtype=np.int64) + offs[p] for p, (_, _, pp) in enumerate(csrs)])
    fn, consts = build_tri_solve(data, indices, indptr, P * n, lower, unit_diag, dtype, device)

    def apply(b, *cs):
        return fn(b.reshape(P * n, -1), *cs).reshape(b.shape)

    apply.n_levels, apply.launches = fn.n_levels, fn.launches
    return apply, consts
