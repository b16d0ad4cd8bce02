"""Element partitioning across shards.

The METIS stand-in (``mesh/PartitionMesh.hpp:480-516`` analog): recursive
coordinate bisection (RCB) on element centroids with optional per-element
weights and heterogeneity-aware target fractions (the analog of the
reference's node-throughput weighting,
``comm/GatherNodeThroughputs.hpp:12-33``).  For the tensor-product meshes the
framework targets, RCB yields compact, well-balanced parts with small halos.
Copied from ``l3ster_tpu.parallel.partition`` (numpy only), with the facet
join on the port's numpy row matcher.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "partition_rcb",
    "partition_rcb_grid",
    "partition_graph",
    "partition_mesh_elements",
]


def partition_graph(
    corner_nodes: np.ndarray,
    n_parts: int,
    weights: np.ndarray | None = None,
    part_fractions: np.ndarray | None = None,
) -> np.ndarray:
    """Greedy graph-growing partition with one FM-style refinement pass.

    The graph-partitioner analog of the reference's METIS path
    (``mesh/PartitionMesh.hpp:480-516``) for unstructured imports where
    coordinate bisection cuts through thin features: parts grow by BFS over
    the element-connectivity graph (elements sharing corner nodes), then one
    boundary sweep moves elements to the neighbor part with the largest cut
    reduction subject to balance.
    """
    import scipy.sparse as sp

    E = len(corner_nodes)
    w = np.ones(E) if weights is None else np.asarray(weights, dtype=np.float64)
    fr = (
        np.full(n_parts, 1.0 / n_parts)
        if part_fractions is None
        else np.asarray(part_fractions, dtype=np.float64) / np.sum(part_fractions)
    )
    if n_parts <= 1 or E == 0:
        return np.zeros(E, dtype=np.int64)
    flat = np.asarray(corner_nodes).reshape(E, -1)
    k = flat.shape[1]
    rows = np.repeat(np.arange(E), k)
    inc = sp.csr_matrix(
        (np.ones(E * k, dtype=np.int8), (rows, flat.reshape(-1))),
        shape=(E, int(flat.max()) + 1),
    )
    adj = (inc @ inc.T).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()
    indptr, indices = adj.indptr, adj.indices

    part = np.full(E, -1, dtype=np.int64)
    total_w = w.sum()
    seed = 0
    for p in range(n_parts):
        target = fr[p] * total_w
        free = np.nonzero(part < 0)[0]
        if not len(free):
            break
        if p == n_parts - 1:
            part[free] = p
            break
        # seed: a peripheral unassigned element (farthest from the previous
        # region by a short BFS), falling back to the first free one
        seed = int(free[0]) if part[seed] >= 0 else seed
        grown = 0.0
        frontier = [seed]
        in_front = np.zeros(E, dtype=bool)
        in_front[seed] = True
        while frontier and grown < target:
            e = frontier.pop(0)
            if part[e] >= 0:
                continue
            part[e] = p
            grown += w[e]
            for nb in indices[indptr[e] : indptr[e + 1]]:
                if part[nb] < 0 and not in_front[nb]:
                    in_front[nb] = True
                    frontier.append(int(nb))
        nxt = np.nonzero(part < 0)[0]
        if len(nxt):
            seed = int(nxt[0])

    # one FM-style boundary refinement sweep: move boundary elements to the
    # neighbor part with the largest cut gain, within a 10% balance slack
    part_w = np.array([w[part == p].sum() for p in range(n_parts)])
    cap = 1.1 * fr * total_w
    for e in range(E):
        nbs = indices[indptr[e] : indptr[e + 1]]
        if not len(nbs):
            continue
        pe = part[e]
        nb_parts, counts = np.unique(part[nbs], return_counts=True)
        if len(nb_parts) == 1 and nb_parts[0] == pe:
            continue
        own = counts[nb_parts == pe].sum()
        order = np.argsort(-counts)
        for oi in order:
            q = int(nb_parts[oi])
            if q == pe or counts[oi] <= own:
                break
            if part_w[q] + w[e] <= cap[q] and part_w[pe] - w[e] > 0:
                part[e] = q
                part_w[q] += w[e]
                part_w[pe] -= w[e]
                break
    return part


def partition_rcb(
    centroids: np.ndarray,
    n_parts: int,
    weights: np.ndarray | None = None,
    part_fractions: np.ndarray | None = None,
) -> np.ndarray:
    """Part id (0..n_parts-1) per element by recursive coordinate bisection."""
    n = len(centroids)
    weights = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    fractions = (
        np.full(n_parts, 1.0 / n_parts)
        if part_fractions is None
        else np.asarray(part_fractions, dtype=np.float64) / np.sum(part_fractions)
    )
    out = np.empty(n, dtype=np.int64)

    def recurse(idx: np.ndarray, parts: range) -> None:
        if len(parts) == 1:
            out[idx] = parts.start
            return
        if len(idx) == 0:  # more parts than elements: empty shards are fine
            return
        k = len(parts) // 2
        frac_left = fractions[parts.start : parts.start + k].sum()
        frac_total = fractions[parts.start : parts.stop].sum()
        c = centroids[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        w = weights[idx][order]
        cum = np.cumsum(w)
        target = frac_left / frac_total * cum[-1]
        # side='right': keep exact-tie elements left of the cut (see
        # partition_rcb_grid.split_sorted)
        split = int(np.searchsorted(cum, target, side="right"))
        split = max(0, min(split, len(idx)))
        left = idx[order[:split]]
        right = idx[order[split:]]
        recurse(left, range(parts.start, parts.start + k))
        recurse(right, range(parts.start + k, parts.stop))

    recurse(np.arange(n, dtype=np.int64), range(n_parts))
    return out


def partition_rcb_grid(
    centroids: np.ndarray,
    grid: tuple[int, int],
    weights: np.ndarray | None = None,
    part_fractions: np.ndarray | None = None,
) -> np.ndarray:
    """RCB onto a 2D shard GRID (Pa, Pb): Pa weighted strips along the
    longest coordinate axis, each split into Pb parts along the next-longest.
    Rank = a * Pb + b (row-major), so halo exchanges land on the controlled
    ring offsets {±1, ±Pb, ±(Pb∓1)} — one ppermute per offset — instead of
    the data-dependent offsets of blind 1D RCB.  The 2D analog of the
    reference's topology-aware re-ranking (``comm/DistributeMesh.hpp:207-227``)
    for multi-axis device meshes (ICI rings per axis).
    """
    Pa, Pb = int(grid[0]), int(grid[1])
    n_parts = Pa * Pb
    n = len(centroids)
    w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
    fr = (
        np.full(n_parts, 1.0 / n_parts)
        if part_fractions is None
        else np.asarray(part_fractions, dtype=np.float64) / np.sum(part_fractions)
    )
    fr2 = fr.reshape(Pa, Pb)
    out = np.empty(n, dtype=np.int64)
    c = np.asarray(centroids)
    span = c.max(axis=0) - c.min(axis=0) if n else np.zeros(c.shape[1])
    ax_a = int(np.argmax(span))
    span2 = span.copy()
    span2[ax_a] = -1.0
    ax_b = int(np.argmax(span2))

    def split_sorted(idx, axis, fracs):
        """Contiguous weighted splits of idx along axis; returns list of idx."""
        order = np.argsort(c[idx, axis], kind="stable")
        sidx = idx[order]
        cum = np.cumsum(w[sidx])
        total = cum[-1] if len(cum) else 0.0
        # side='right': an element whose cumulative weight EQUALS the target
        # belongs to the left part — side='left' leaks it across the cut on
        # exact ties (uniform grids always tie), producing ragged strips and
        # uncontrolled halo offsets
        bounds = np.searchsorted(
            cum, np.cumsum(fracs)[:-1] / fracs.sum() * total, side="right"
        )
        return np.split(sidx, bounds)

    strips = split_sorted(np.arange(n, dtype=np.int64), ax_a, fr2.sum(axis=1))
    for a, strip in enumerate(strips):
        for b, part in enumerate(split_sorted(strip, ax_b, fr2[a])):
            out[part] = a * Pb + b
    return out


def partition_mesh_elements(
    mesh, n_parts: int, problem=None, part_fractions=None, method: str = "rcb",
    grid: tuple[int, int] | None = None,
) -> dict[int, np.ndarray]:
    """Part assignment for every block keyed by id(block).

    Volume (top-dimensional) blocks are partitioned globally by ``method``
    ("rcb": coordinate bisection on centroids — compact parts on the
    structured meshes the framework targets; "graph": greedy graph growing
    over element connectivity — the METIS analog for unstructured imports),
    weighted by active dofs per element when a ProblemDefinition is given;
    boundary facet blocks follow their parent volume element.
    """
    parts: dict[int, np.ndarray] = {}
    vol_dim = mesh.dim
    # gather all volume elements across blocks for one global partition
    blocks = [
        (did, blk)
        for did, blk in mesh.blocks()
        if blk.dim == vol_dim and did not in mesh.boundary_ids
    ]
    cents, weights, owners = [], [], []
    for did, blk in blocks:
        cents.append(blk.vertices.mean(axis=1))
        if problem is not None:
            w = np.full(blk.n_elements, blk.nodes.shape[1] * problem.active_mask(did).sum(), float)
        else:
            w = np.ones(blk.n_elements)
        weights.append(w)
        owners.append(np.full(blk.n_elements, len(owners)))
    if not cents:
        raise ValueError("mesh has no volume elements to partition")
    allc = np.concatenate(cents)
    if method == "graph":
        corners = np.concatenate([blk.corner_nodes for _, blk in blocks])
        p = partition_graph(corners, n_parts, np.concatenate(weights), part_fractions)
    elif method == "rcb":
        p = partition_rcb(allc, n_parts, np.concatenate(weights), part_fractions)
    elif method == "rcb2d":
        if grid is None or int(grid[0]) * int(grid[1]) != n_parts:
            raise ValueError(
                f"method='rcb2d' needs grid=(Pa, Pb) with Pa*Pb == {n_parts}"
            )
        p = partition_rcb_grid(allc, grid, np.concatenate(weights), part_fractions)
    else:
        raise ValueError(f"unknown partition method {method!r} (rcb | rcb2d | graph)")
    off = 0
    for (did, blk), c in zip(blocks, cents):
        parts[id(blk)] = p[off : off + blk.n_elements]
        off += blk.n_elements

    # facet blocks (boundary domains & any lower-dim domains): follow parent
    # via the boundary views where available, else RCB independently
    from ..mesh.traits import side_corner_indices
    from ..mesh.core import _match_rows as match_rows

    for did, blk in mesh.blocks():
        if id(blk) in parts:
            continue
        assigned = np.full(blk.n_elements, -1, dtype=np.int64)
        if did in mesh.boundary_ids:
            # recover per-facet parts from the parent element partition by
            # a vectorized corner-row join against the boundary views
            rows, pvals = [], []
            for bv in mesh.boundary_views.get(did, []):
                sc = side_corner_indices(bv.parent_block.element_type, bv.side)
                rows.append(
                    np.sort(bv.parent_block.corner_nodes[bv.element_indices][:, sc], axis=1)
                )
                pvals.append(parts[id(bv.parent_block)][bv.element_indices])
            if rows:
                table = np.concatenate(rows)
                pvals = np.concatenate(pvals)
                hit = match_rows(table, np.sort(blk.corner_nodes, axis=1))
                assigned = np.where(hit >= 0, pvals[np.maximum(hit, 0)], -1)
        if (assigned < 0).any():
            assigned = partition_rcb(blk.vertices.mean(axis=1), n_parts)
        parts[id(blk)] = assigned
    return parts
