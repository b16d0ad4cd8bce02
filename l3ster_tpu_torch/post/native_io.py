"""Native checkpoint format: mesh + result save/load.

Analog of ``post/NativeIO.hpp``: a self-describing on-disk snapshot of the
mesh (all element blocks, coordinates, boundary ids) and any number of nodal
result fields.  The format is shard-count independent by construction -- the
mesh is stored globally and any distribution is re-derived on load (the
re-shard-on-load analog of ``post/NativeIO.hpp:265-266`` /
``examples/08-native-io``).  Storage is a single .npz with a JSON manifest.
Copied from ``l3ster_tpu.post.native_io``: the two packages read and write
the same files.  A checkpoint saved from a distributed system's solution at
one shard count loads into one at another: the mesh is rebuilt, a new
``make_distributed_system`` re-partitions it, and the nodal fields go back
through its ``_set_solution_global``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..mesh.core import ElementBlock, Mesh
from ..mesh.traits import ElementType

__all__ = ["save", "Loader", "load"]

_FORMAT_VERSION = 1


def save(path: str, mesh: Mesh, solution_manager=None, field_names=None) -> str:
    """Save mesh (and optionally the SolutionManager fields) to ``path``."""
    arrays: dict[str, np.ndarray] = {"node_coords": np.asarray(mesh.node_coords)}
    manifest = {
        "version": _FORMAT_VERSION,
        "dim": mesh.dim,
        "n_nodes": mesh.n_nodes,
        "boundary_ids": list(mesh.boundary_ids),
        "domains": {},
        "fields": [],
    }
    for did in sorted(mesh.domains):
        blocks = []
        for i, blk in enumerate(mesh.domains[did]):
            key = f"d{did}_b{i}"
            arrays[key + "_nodes"] = blk.nodes
            arrays[key + "_verts"] = blk.vertices
            blocks.append({"et": int(blk.element_type), "order": blk.order, "key": key})
        manifest["domains"][str(did)] = blocks
    if solution_manager is not None:
        vals = solution_manager.values
        vals = vals.detach().cpu().numpy() if hasattr(vals, "detach") else np.asarray(vals)
        arrays["fields"] = vals
        names = field_names or [f"field_{i}" for i in range(vals.shape[1])]
        manifest["fields"] = list(names)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(path, **arrays)
    return path


class Loader:
    """Reload a checkpoint: mesh, fields, and metadata
    (``post/NativeIO.hpp:229-275`` analog)."""

    def __init__(self, path: str):
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        self._data = np.load(path)
        self.manifest = json.loads(bytes(self._data["__manifest__"]).decode())
        if self.manifest["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {self.manifest['version']}")

    def mesh(self) -> Mesh:
        m = self.manifest
        domains: dict[int, list[ElementBlock]] = {}
        for did_s, blocks in m["domains"].items():
            did = int(did_s)
            domains[did] = [
                ElementBlock(
                    ElementType(b["et"]),
                    b["order"],
                    self._data[b["key"] + "_nodes"],
                    self._data[b["key"] + "_verts"],
                )
                for b in blocks
            ]
        return Mesh(
            dim=m["dim"],
            n_nodes=m["n_nodes"],
            node_coords=self._data["node_coords"],
            domains=domains,
            boundary_ids=tuple(m["boundary_ids"]),
        )

    @property
    def field_names(self) -> list[str]:
        return list(self.manifest["fields"])

    def fields(self) -> np.ndarray:
        if "fields" not in self._data:
            raise KeyError("checkpoint contains no result fields")
        return self._data["fields"]

    def solution_manager(self, mesh: Mesh | None = None, dtype=None, device=None):
        """A SolutionManager holding the saved fields, in ``dtype`` (the saved
        one by default) on ``device``, resolved as the manager resolves it
        (CUDA unless named)."""
        import torch

        from .solution import SolutionManager

        mesh = mesh or self.mesh()
        vals = torch.from_numpy(np.ascontiguousarray(self.fields()))
        man = SolutionManager(mesh, vals.shape[1], dtype or vals.dtype, device=device)
        man.values = vals.to(dtype=man.dtype, device=man.device)
        return man


def load(path: str, device=None) -> tuple[Mesh, "object"]:
    """Convenience: (mesh, solution_manager or None), the manager on ``device``."""
    loader = Loader(path)
    mesh = loader.mesh()
    man = loader.solution_manager(mesh, device=device) if loader.manifest["fields"] else None
    return mesh, man
