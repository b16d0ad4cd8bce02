"""Milliseconds per operator apply: CUDA events around 10 back-to-back applies, median of 20."""

from portbench import yardstick
from portbench.probes._common import operator_and_vector


def run(ctx):
    apply, x = operator_and_vector(ctx)
    return yardstick.cuda_ms(lambda: apply(x), reps=20, batch=10)
