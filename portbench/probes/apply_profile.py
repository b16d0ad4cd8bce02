"""Device time per operator apply and by kernel: ``torch.profiler`` over 10
back-to-back applies, after a warm-up step of the profiler itself (its first
step can lose the earliest launches)."""

import statistics
import sys
from collections import defaultdict

from portbench.probes._common import operator_and_vector

N = 10


def run(ctx):
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from portbench import tracing

    apply, x = operator_and_vector(ctx)
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in range(2):
            for _ in range(N):
                apply(x)
            torch.cuda.synchronize()
            prof.step()
    dev, _ = tracing.events(prof)
    by = defaultdict(list)
    for s, t, n in dev:
        by[n[:80]].append((t - s) / 1e6)
    for n, d in sorted(by.items(), key=lambda kv: -sum(kv[1]))[:8]:  # what each apply ran, for the log
        print(f"probe apply_profile: {len(d) / N:g} x {statistics.median(d):.4f} ms  {n}", file=sys.stderr)
    return {"n": N, "dev": dev}
