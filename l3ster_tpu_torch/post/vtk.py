"""ParaView (.vtu / .pvtu) export.

Analog of ``post/VtkExport.hpp``: XML VTK unstructured-grid output with
base64-encoded appended binary payloads.  High-order elements are subdivided
into linear sub-cells on the GLL lattice (values at nodes are exact; ParaView
renders the refined geometry), volume and facet domains alike.  A .pvtu
master file referencing per-piece .vtu files is written when requested.
Copied from ``l3ster_tpu.post.vtk``; field values are read back from the
SolutionManager's device, so both packages write the same bytes.
"""

from __future__ import annotations

import base64
import os
import struct

import numpy as np

from ..mesh.core import Mesh
from ..mesh.traits import ElementType, native_dim, node_lattice

__all__ = ["ExportDefinition", "PvtuExporter"]

_VTK_CELL = {ElementType.LINE: 3, ElementType.QUAD: 9, ElementType.HEX: 12}


def _host_values(solution_manager) -> np.ndarray:
    """The manager's (n_nodes, n_slots) values as a host numpy array."""
    v = solution_manager.values
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _subcell_corners(et: ElementType, order: int) -> np.ndarray:
    """Local node indices of the order^dim linear sub-cells, VTK corner order."""
    p1 = order + 1
    dim = native_dim(et)
    lat = node_lattice(et, order)
    idx = {tuple(c): i for i, c in enumerate(lat)}
    cells = []
    rng = range(order)
    if dim == 1:
        for i in rng:
            cells.append([idx[(i,)], idx[(i + 1,)]])
    elif dim == 2:
        for j in rng:
            for i in rng:
                cells.append(
                    [idx[(i, j)], idx[(i + 1, j)], idx[(i + 1, j + 1)], idx[(i, j + 1)]]
                )
    else:
        for k in rng:
            for j in rng:
                for i in rng:
                    cells.append(
                        [
                            idx[(i, j, k)],
                            idx[(i + 1, j, k)],
                            idx[(i + 1, j + 1, k)],
                            idx[(i, j + 1, k)],
                            idx[(i, j, k + 1)],
                            idx[(i + 1, j, k + 1)],
                            idx[(i + 1, j + 1, k + 1)],
                            idx[(i, j + 1, k + 1)],
                        ]
                    )
    return np.asarray(cells, dtype=np.int64)


def _b64(data: bytes) -> str:
    header = struct.pack("<I", len(data))
    return base64.b64encode(header + data).decode("ascii")


def _data_array(name: str, arr: np.ndarray, n_comp: int = 1) -> str:
    dtype_map = {
        np.dtype(np.float64): "Float64",
        np.dtype(np.float32): "Float32",
        np.dtype(np.int64): "Int64",
        np.dtype(np.int32): "Int32",
        np.dtype(np.uint8): "UInt8",
    }
    vt = dtype_map[arr.dtype]
    payload = _b64(np.ascontiguousarray(arr).tobytes())
    comp = f' NumberOfComponents="{n_comp}"' if n_comp > 1 else ""
    return f'<DataArray type="{vt}" Name="{name}"{comp} format="binary">{payload}</DataArray>'


class ExportDefinition:
    """Which fields (by name -> SolutionManager slots) go into the export."""

    def __init__(self, path: str):
        self.path = str(path)
        self.fields: list[tuple[str, tuple[int, ...]]] = []

    def define_field(self, name: str, slots) -> "ExportDefinition":
        self.fields.append((name, tuple(int(s) for s in slots)))
        return self


class PvtuExporter:
    """Writes .vtu (one piece) or .pvtu + piece files for sharded export."""

    def __init__(self, mesh: Mesh, domain_ids=None, include_boundaries: bool = False):
        self.mesh = mesh
        ids = domain_ids
        if ids is None:
            ids = [
                d
                for d in sorted(mesh.domains)
                if include_boundaries or d not in mesh.boundary_ids
            ]
        self.domain_ids = list(ids)

    def export_solution(self, export_def: ExportDefinition, solution_manager=None) -> str:
        mesh = self.mesh
        points = np.asarray(mesh.node_coords, dtype=np.float64)
        conn_parts, types_parts = [], []
        for _, blk in mesh.blocks(self.domain_ids):
            sub = _subcell_corners(blk.element_type, blk.order)
            cells = blk.nodes[:, sub].reshape(-1, sub.shape[1])
            conn_parts.append(cells)
            types_parts.append(
                np.full(cells.shape[0], _VTK_CELL[blk.element_type], dtype=np.uint8)
            )
        sizes = [c.shape[1] for c in conn_parts]
        connectivity = np.concatenate([c.reshape(-1) for c in conn_parts])
        offsets = np.concatenate(
            [
                np.arange(1, c.shape[0] + 1) * c.shape[1]
                + (0 if i == 0 else sum(cp.size for cp in conn_parts[:i]))
                for i, c in enumerate(conn_parts)
            ]
        ).astype(np.int64)
        types = np.concatenate(types_parts)
        n_cells = len(types)

        point_data = []
        for name, slots in export_def.fields:
            if solution_manager is None:
                raise ValueError("field export requires a SolutionManager")
            vals = _host_values(solution_manager)[:, list(slots)]
            if len(slots) == 1:
                vals = vals[:, 0]
                point_data.append(_data_array(name, vals.astype(np.float64)))
            else:
                point_data.append(
                    _data_array(name, vals.astype(np.float64), n_comp=len(slots))
                )

        xml = [
            '<?xml version="1.0"?>',
            '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
            "<UnstructuredGrid>",
            f'<Piece NumberOfPoints="{len(points)}" NumberOfCells="{n_cells}">',
            "<Points>",
            _data_array("Points", points, n_comp=3),
            "</Points>",
            "<Cells>",
            _data_array("connectivity", connectivity.astype(np.int64)),
            _data_array("offsets", offsets),
            _data_array("types", types),
            "</Cells>",
            "<PointData>",
            *point_data,
            "</PointData>",
            "</Piece>",
            "</UnstructuredGrid>",
            "</VTKFile>",
        ]
        path = export_def.path
        if path.endswith(".pvtu"):
            path = path[:-5] + ".vtu"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(xml))
        if export_def.path.endswith(".pvtu"):
            self._write_pvtu(export_def, [os.path.basename(path)])
            return export_def.path
        return path

    def export_solution_sharded(
        self, export_def: ExportDefinition, solution_manager=None, partition=None, n_pieces=None
    ) -> str:
        """Write one .vtu piece per shard + a .pvtu master referencing them
        (``post/VtkExport.hpp:41-80``: one piece per rank).

        ``partition`` is either a DistributedSystem (its element partition is
        reused) or a dict ``{id(block): (n_elements,) part array}``
        (``parallel.partition.partition_mesh_elements`` makes one); each piece
        holds only its shard's elements with a compacted point list.
        """
        if not export_def.path.endswith(".pvtu"):
            raise ValueError("sharded export requires a .pvtu path")
        if partition is None:
            raise ValueError("sharded export requires a partition (system or parts dict)")
        if hasattr(partition, "_parts"):
            n_pieces = n_pieces or partition.n_shards
            parts = partition._parts
        else:
            parts = partition
            if n_pieces is None:
                n_pieces = 1 + max(int(p.max()) for p in parts.values() if len(p))
        mesh = self.mesh
        base = export_def.path[:-5]
        os.makedirs(os.path.dirname(os.path.abspath(export_def.path)) or ".", exist_ok=True)
        piece_files = []
        field_vals = {}
        for name, slots in export_def.fields:
            if solution_manager is None:
                raise ValueError("field export requires a SolutionManager")
            field_vals[name] = _host_values(solution_manager)[:, list(slots)]
        for p in range(n_pieces):
            conn_parts, types_parts = [], []
            for did, blk in mesh.blocks(self.domain_ids):
                part = parts.get(id(blk))
                if part is None:
                    continue
                sel = np.nonzero(part == p)[0]
                if not len(sel):
                    continue
                sub = _subcell_corners(blk.element_type, blk.order)
                cells = blk.nodes[sel][:, sub].reshape(-1, sub.shape[1])
                conn_parts.append(cells)
                types_parts.append(
                    np.full(cells.shape[0], _VTK_CELL[blk.element_type], dtype=np.uint8)
                )
            if conn_parts:
                conn_g = np.concatenate([c.reshape(-1) for c in conn_parts])
                piece_nodes = np.unique(conn_g)
            else:
                piece_nodes = np.empty(0, dtype=np.int64)
            points = np.asarray(mesh.node_coords, dtype=np.float64)[piece_nodes]
            # piece-local point ids: positions in the sorted piece node list
            connectivity = (
                np.searchsorted(piece_nodes, conn_g).astype(np.int64) if conn_parts else np.empty(0, dtype=np.int64)
            )
            offsets_l, off = [], 0
            for c in conn_parts:
                offsets_l.append(np.arange(1, c.shape[0] + 1) * c.shape[1] + off)
                off += c.size
            offsets = (
                np.concatenate(offsets_l).astype(np.int64)
                if offsets_l
                else np.empty(0, dtype=np.int64)
            )
            types = (
                np.concatenate(types_parts) if types_parts else np.empty(0, dtype=np.uint8)
            )
            point_data = []
            for name, slots in export_def.fields:
                vals = field_vals[name][piece_nodes]
                if len(slots) == 1:
                    point_data.append(_data_array(name, vals[:, 0].astype(np.float64)))
                else:
                    point_data.append(
                        _data_array(name, vals.astype(np.float64), n_comp=len(slots))
                    )
            xml = [
                '<?xml version="1.0"?>',
                '<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">',
                "<UnstructuredGrid>",
                f'<Piece NumberOfPoints="{len(points)}" NumberOfCells="{len(types)}">',
                "<Points>",
                _data_array("Points", points.reshape(-1, points.shape[-1]), n_comp=3),
                "</Points>",
                "<Cells>",
                _data_array("connectivity", connectivity),
                _data_array("offsets", offsets),
                _data_array("types", types),
                "</Cells>",
                "<PointData>",
                *point_data,
                "</PointData>",
                "</Piece>",
                "</UnstructuredGrid>",
                "</VTKFile>",
            ]
            fname = f"{base}_p{p}.vtu"
            with open(fname, "w") as f:
                f.write("\n".join(xml))
            piece_files.append(os.path.basename(fname))
        self._write_pvtu(export_def, piece_files)
        return export_def.path

    def _write_pvtu(self, export_def: ExportDefinition, pieces: list[str]) -> None:
        lines = [
            '<?xml version="1.0"?>',
            '<VTKFile type="PUnstructuredGrid" version="0.1" byte_order="LittleEndian">',
            '<PUnstructuredGrid GhostLevel="0">',
            "<PPoints>",
            '<PDataArray type="Float64" Name="Points" NumberOfComponents="3"/>',
            "</PPoints>",
            "<PPointData>",
            *(
                f'<PDataArray type="Float64" Name="{name}"'
                + (f' NumberOfComponents="{len(slots)}"' if len(slots) > 1 else "")
                + "/>"
                for name, slots in export_def.fields
            ),
            "</PPointData>",
            *(f'<Piece Source="{p}"/>' for p in pieces),
            "</PUnstructuredGrid>",
            "</VTKFile>",
        ]
        with open(export_def.path, "w") as f:
            f.write("\n".join(lines))
