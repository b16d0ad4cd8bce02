"""Node-major field storage and access (PyTorch port of ``l3ster_tpu.post.solution``).

Analogs of ``post/SolutionManager.hpp`` and ``post/FieldAccess.hpp``: computed
fields live in a (n_nodes, n_slots) tensor, one column per scalar field;
kernels read them through a FieldAccess (a slot-index view) which the
assembler gathers per element block.  Every update replaces the manager's
tensor instead of writing into it, so a FieldAccess keeps the values it was
taken with, as the reference's immutable arrays do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mesh.core import Mesh

__all__ = ["SolutionManager", "FieldAccess"]


@dataclass
class FieldAccess:
    """A view of selected solution-manager slots; gathered at element nodes."""

    values: torch.Tensor  # (n_nodes, n_slots_total)
    slots: tuple[int, ...]

    @property
    def n_fields(self) -> int:
        return len(self.slots)

    def gather(self, nodes: np.ndarray) -> torch.Tensor:
        """(n_elem, n_nodes_el, n_fields) nodal field values for a block."""
        idx = torch.as_tensor(nodes, device=self.values.device)
        return self.values[:, list(self.slots)][idx]


class SolutionManager:
    """Holds n_slots scalar nodal fields (``post/SolutionManager.hpp:12``),
    float64 by default, on ``device``: the CUDA device unless the caller
    names one (without CUDA, no device raises; pass ``device="cpu"``)."""

    def __init__(self, mesh: Mesh, n_slots: int, dtype=torch.float64, device=None):
        from ..algsys.system import _resolve_device

        self.mesh = mesh
        self.n_slots = int(n_slots)
        self.dtype = dtype
        self.device = _resolve_device(device)
        self.values = torch.zeros((mesh.n_nodes, self.n_slots), dtype=dtype, device=self.device)

    @property
    def n_nodes(self) -> int:
        return self.values.shape[0]

    def field_access(self, slots) -> FieldAccess:
        slots = tuple(int(s) for s in slots)
        for s in slots:
            if not 0 <= s < self.n_slots:
                raise IndexError(f"slot {s} out of range [0, {self.n_slots})")
        return FieldAccess(self.values, slots)

    def get_field_view(self, slot: int) -> torch.Tensor:
        return self.values[:, int(slot)]

    def set_field(self, slots, value) -> None:
        """Set slots to a constant or an (n_nodes,) / (n_nodes, len(slots)) array."""
        slots = [int(s) for s in (np.atleast_1d(slots))]
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.ndim == 0:
            value = value.expand(self.n_nodes, len(slots))
        elif value.ndim == 1:
            value = value[:, None].expand(self.n_nodes, len(slots))
        new = self.values.clone()
        new[:, slots] = value
        self.values = new

    def set_fields_from_kernel(self, kernel, domain_ids, slots, field_access=None, time=0.0) -> None:
        """Evaluate a residual kernel at nodes (averaged at shared nodes) into slots.

        The analog of ``SolutionManager::setFields`` via
        ``algsys/ComputeValuesAtNodes.hpp``.
        """
        from ..algsys.values_at_nodes import compute_values_at_nodes

        vals, mask = compute_values_at_nodes(
            kernel, self.mesh, domain_ids, field_access, time, self.dtype, self.device
        )
        slots = [int(s) for s in slots]
        if vals.shape[1] < len(slots):
            raise ValueError("kernel produces fewer components than slots requested")
        new = self.values.clone()
        new[:, slots] = torch.where(mask[:, None], vals[:, : len(slots), 0], self.values[:, slots])
        self.values = new
