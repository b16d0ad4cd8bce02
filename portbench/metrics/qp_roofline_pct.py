"""The per-QP kernel B2's (``csrc/qp_algebra.cu``) share of its roofline on the
apply, in percent: the least time of one call on the (E, c, d1, Q) layout from
its shapes (``yardstick.qp_bytes_flops``) over its device time per apply, taken
from 10 profiled applies by the kernel-name patterns below."""

from portbench import yardstick

PROBES = ("apply_profile",)
PATTERNS = ("qp_kernel",)


def read(ctx):
    p = ctx["probes"]["apply_profile"]
    secs = sum(t - s for s, t, n in p["dev"] if any(q in n for q in PATTERNS)) / 1e9 / p["n"]
    if secs <= 0:
        return None
    sh = ctx["reference"].shapes(ctx["cfg"])
    nbytes, flops = yardstick.qp_bytes_flops(sh["n_elements"], sh["q1"], sh["n_unk"], sh["nnz"], sh["n_eq"])
    least, _ = yardstick.bound(nbytes, flops)
    return 100.0 * least / secs
