"""The whole operator apply's share of its roofline, in percent.

The least time is the larger of the sum-factorized FLOPs at the float32 peak
and the apply's own bytes (vector in and out, the mesh as given) at the
HBM peak (``yardstick.flops_per_apply`` and ``yardstick.apply_bytes``, from
the configuration's shapes); the time is the device's busy time per apply
over 10 profiled applies."""

from portbench import yardstick

PROBES = ("apply_profile",)


def read(ctx):
    from portbench import tracing

    p = ctx["probes"]["apply_profile"]
    if not p["dev"]:
        return None
    sh = ctx["reference"].shapes(ctx["cfg"])
    lo, hi = min(s for s, _, _ in p["dev"]), max(t for _, t, _ in p["dev"])
    iv = tracing.union(p["dev"], lo, hi)
    busy = float((iv[:, 1] - iv[:, 0]).sum()) / 1e9 / p["n"]
    nbytes = yardstick.apply_bytes(sh["n_dofs"], sh["n_elements"], sh["n_elem_nodes"], sh["unstructured"])
    flops = yardstick.flops_per_apply(sh["order"], sh["n_elements"], sh["n_unk"], sh["n_eq"], sh["q1"])
    least, _ = yardstick.bound(nbytes, flops)
    return 100.0 * least / busy
