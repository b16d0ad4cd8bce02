"""The control fails the limits of ``correct``: on the card, at each cell's own size.

The control is the program with its own TF32 matmul path switched on, the
nearest precision below the configurations' float32 with TF32 off.  Three
seeds, one solve each (the first answer of a window counts however late).
Run on the card: ``python -m pytest portbench/tests -m cuda``.
"""

import pytest

from portbench.tests._tiny import REPO

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["cyl3d_jacobi"])
def test_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    from portbench.harness import Run
    from portbench.readings import readings

    run = Run(REPO, cell, "cuda")
    limits = run.spec["limits"]
    ref = run.reference()
    for got in readings(run, ref, SEEDS, 1.0, "tf32"):
        assert got["unconverged"] > 0 or any(got[k] > limit for k, limit in limits.items()), got
