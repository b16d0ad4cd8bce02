"""Dense basis-matrix evaluation of the local apply (PyTorch port of ``l3ster_tpu.ops.dense_eval``).

The nodes <-> QPs maps of any element run as one large matmul per direction
with the full reference-basis matrix B_all ((dim+1) * Q, n_nodes) = [N; D_1; ...]:

    G (E*c, (dim+1) Q) = X (E*c, n_nodes) @ B_all^T            (nodes -> QPs)
    Y (E*c, n_nodes)   = T (E*c, (dim+1) Q) @ B_all            (QPs -> nodes)

Both are plain ``torch.matmul`` in full precision (the reference computes
them outside any Pallas kernel, at f32-grade precision; float32 products run
without TF32 on the card).  The reference hands the per-QP step lists of
per-channel (E*Q,) vectors; here G and T stay one (E, c, dim+1, Q) tensor
each, the layout the per-QP kernel (``ops/qp.py``) reads and writes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dense_basis_matrix", "dense_interpolate_channels", "dense_transpose_channels"]


def dense_basis_matrix(tables) -> np.ndarray:
    """B_all ((dim+1)*Q, n_nodes): basis values then per-axis ref derivatives."""
    V = np.asarray(tables.values, np.float64)  # (Q, n)
    D = np.moveaxis(np.asarray(tables.ref_ders, np.float64), 1, 0)  # (dim, Q, n)
    return np.concatenate([V[None], D], axis=0).reshape(-1, V.shape[1])


def dense_interpolate_channels(x_loc: torch.Tensor, Ball: torch.Tensor, dim: int) -> torch.Tensor:
    """Nodes -> QPs via one matmul: G (E, c, dim+1, Q) from x_loc (E, n_nodes, c),
    with G[:, u, 0] the values and G[:, u, 1 + j] the reference derivatives
    along axis j of channel u."""
    E, n, c = x_loc.shape
    G = torch.matmul(x_loc.transpose(1, 2).reshape(E * c, n), Ball.T)  # (E*c, d1*Q)
    return G.reshape(E, c, dim + 1, -1)


def dense_transpose_channels(T: torch.Tensor, Ball: torch.Tensor) -> torch.Tensor:
    """QPs -> nodes: exact transpose of :func:`dense_interpolate_channels`;
    T (E, c, dim+1, Q) -> y (E, n_nodes, c)."""
    E, c = T.shape[:2]
    y2 = torch.matmul(T.reshape(E * c, -1), Ball)  # (E*c, n)
    return y2.reshape(E, c, -1).transpose(1, 2)
