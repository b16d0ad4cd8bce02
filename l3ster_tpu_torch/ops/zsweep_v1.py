"""The v1 fused z-sweep: the reference's first z-sweep kernel, served by the port's CUDA kernel.

Counterpart of the Pallas TPU kernel ``l3ster_tpu/ops/pallas_zsweep.py:fused_z_sweep``
(v1): the math of ``ops/zsweep.py`` restricted to full geometry, constant A
and the (n1z, c, RQ) ``"zc"`` tensors, with v1's signature.  It is the
lattice apply's z stage under ``L3STER_TPU_ZSWEEP=v1``.  On a CUDA tensor
:func:`fused_z_sweep` launches ``csrc/zsweep.cu`` in its const+full, ``"zc"``
mode (and raises if it cannot); on a CPU tensor it runs
:func:`fused_z_sweep_plain`.  ``launch_count`` counts this wrapper's launches
(``ops.zsweep.launch_count`` does not include them).
"""

from __future__ import annotations

from . import zsweep

__all__ = ["fused_z_sweep", "fused_z_sweep_plain"]

launch_count = 0  # kernel launches through this wrapper


def fused_z_sweep_plain(A_const, b, bdy, bdx, ji, w, NzT, DzT):
    """Plain torch version: (a, ady, adx), each (n1z, c, RQ)."""
    return zsweep.fused_z_sweep_plain(A_const, b, bdy, bdx, ("full", ji, w), NzT, DzT, layout="zc")


def fused_z_sweep(A_const, b, bdy, bdx, ji, w, NzT, DzT, tabs: zsweep.ZSweepTables | None = None):
    """(a, ady, adx), each (n1z, c, RQ), the pre-y-transpose tensors.

    A_const (4, n_eq, c) numpy; b, bdy, bdx (n1z, c, RQ); ji (9, S, RQ) with
    plane j*3+i = Ji[j, i]; w (S, RQ); NzT, DzT (n1z, S) banded z tables.
    ``tabs`` is their device copy with its element layers (``zsweep.zsweep_tables``),
    made once by a caller that applies repeatedly; without it a CUDA launch
    makes one from NzT and DzT."""
    global launch_count
    if b.device.type == "cpu":
        return fused_z_sweep_plain(A_const, b, bdy, bdx, ji, w, NzT, DzT)
    if tabs is None:
        tabs = zsweep.zsweep_tables(NzT.cpu().numpy(), DzT.cpu().numpy(), b.dtype, b.device)
    out = zsweep.launch(A_const, b, bdy, bdx, ("full", ji, w), tabs, layout="zc")
    launch_count += 1
    return out
