"""The z-sweep kernel B1's (``csrc/zsweep.cu``) share of its roofline on the fine
level's apply, in percent: the least time of one call from its shapes
(``yardstick.zsweep_bytes_flops``) over its device time per apply, taken from
10 profiled applies by the kernel-name patterns below."""

from portbench import yardstick

PROBES = ("apply_profile",)
PATTERNS = ("zsweep_kernel",)


def read(ctx):
    p = ctx["probes"]["apply_profile"]
    secs = sum(t - s for s, t, n in p["dev"] if any(q in n for q in PATTERNS)) / 1e9 / p["n"]
    sh = ctx["reference"].shapes(ctx["cfg"])
    if secs <= 0 or "elements_per_side" not in sh:
        return None
    nbytes, flops = yardstick.zsweep_bytes_flops(sh["elements_per_side"], sh["order"], sh["q1"], sh["n_unk"], sh["nnz"])
    least, _ = yardstick.bound(nbytes, flops)
    return 100.0 * least / secs
