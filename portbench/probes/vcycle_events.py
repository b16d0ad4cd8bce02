"""Milliseconds per preconditioner application (one V-cycle of LowOrderMG): CUDA
events around 5 back-to-back applications, median of 10.  The preconditioner's
parts are those its ``setup_parts`` returned to the solver during the warm-up."""

from portbench import yardstick
from portbench.probes._common import operator_and_vector


def run(ctx):
    parts = ctx["precond_parts"]
    if parts is None:
        return None
    M, consts = parts
    _, r = operator_and_vector(ctx)
    return yardstick.cuda_ms(lambda: M(r, *consts), reps=10, batch=5)
