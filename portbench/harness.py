"""The benchmark's engine: one run of one cell, driven by data.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name that ``BENCHMARK.json`` gives it:

* ``configs/<config>.json`` (the file ``BENCHMARK.json`` names): sizes, dtype,
  boundary ids and the ``problem`` that builds it on the program,
  ``problems/<problem>.py``;
* ``reference/<config>.py``: the plain reference that judges its answers;
* ``traffic/<mix>.json``: the loop, the solver and the request data;
* ``limits/<cell>.json``: the limit of each number ``correct`` compares;
* ``metrics/<metric>.py``: a reader ``read(ctx) -> float | None`` of one
  metric, with the names of the ``probes/<probe>.py`` it needs.

A run: set-up (imports, mesh, assembly, a capped warm-up solve that builds
the preconditioner and every kernel shape), then closed-loop solves back to
back for ``seconds``, then (``trace``) the probes, then the program's state
is freed and the reference judges a seeded sample of the window's answers.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import sys
import time
import warnings

FORBIDDEN = ("jax", "jaxlib", "flax", "l3ster_tpu")  # compared with whole top-level module names


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_cell(root: str, workload: str) -> dict:
    """The cell's entries and files, by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(pkg, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    with open(os.path.join(pkg, "limits", workload + ".json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]
    return dict(cell=cell, config=entry["name"], cfg=cfg, mix=mix, limits=limits, end_to_end=e2e, per_layer=layer)


def set_tf32(torch, on: bool) -> None:
    """The program's TF32 matmul path on or off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Spans:
    """Host-clock spans of the harness around calls into the program's layers."""

    def __init__(self, device):
        self.s: dict[str, float] = {}
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        self.s[name] = self.s.get(name, 0.0) + time.perf_counter() - t0


def _capture(obj, attr: str, store: list):
    """Wrap ``obj.attr`` on the instance so its calls' arguments and results land in ``store``."""
    orig = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        store.append((args, kwargs, out))
        return out

    object.__setattr__(obj, attr, wrapped)
    return lambda: object.__delattr__(obj, attr)


def _solve_one(torch, case, solver, req, sync):
    """One request: its Dirichlet data, the solution set to 0, the solve, a synchronize."""
    case.set_request(req["a"], req["b"])
    case.system.set_solution_vector(torch.zeros_like(case.system.x))
    r = case.system.solve(solver)
    sync()
    return r


def run_window(torch, case, solver, gen, seconds: float, sync, keep: int, rng):
    """Closed-loop solves back to back.  The window runs from the first
    solve's start to the end of the last solve that ends inside ``seconds``
    (or of the first solve, however late); a solve that would end past it,
    by the mean so far, is not started.  Returns (window seconds,
    [(request, result)] of every solve, [(request, result, answer)] of a
    uniform sample of at most ``keep`` of them, drawn with ``rng``)."""
    done, sample = [], []
    t0 = time.perf_counter()
    last = t0
    while True:
        if done and (last - t0) + (last - t0) / len(done) > seconds:
            break
        req = next(gen)
        r = _solve_one(torch, case, solver, req, sync)
        end = time.perf_counter()
        if end - t0 > seconds and done:
            break  # due after the window: not its answer
        done.append((req, r))  # the first answer counts even when late
        if len(sample) < keep:  # reservoir sampling: answers held on the device stay <= keep
            sample.append((req, r, case.system.x))
        elif (j := int(rng.integers(len(done)))) < keep:
            sample[j] = (req, r, case.system.x)
        last = end
    return last - t0, done, sample


def judge_answers(ref, labels, done, sample, limits: dict) -> tuple[dict, int]:
    """Every solve of the window that did not converge fails; the reference
    judges the sampled answers: for each number the limits file names, the
    worst reading beside its limit.  Returns (checks, answers failed)."""
    import math

    import torch

    coords, node_dof = labels
    perm = torch.as_tensor(ref.match(coords), device=ref.device)
    nd = torch.as_tensor(node_dof, device=ref.device)
    worst = {k: 0.0 for k in limits}
    unconverged = sum(not r.converged for _, r in done)
    failed = unconverged
    for req, r, x in sample:
        X = torch.empty((ref.n, nd.shape[1]), dtype=torch.float64, device=ref.device)
        X[perm] = x.to(device=ref.device, dtype=torch.float64)[nd, 0]
        got = ref.judge(X, req["a"], req["b"])
        got = {k: (v if math.isfinite(v) else math.inf) for k, v in got.items()}
        failed += r.converged and any(got[k] > limits[k] for k in worst)
        for k in worst:
            worst[k] = max(worst[k], got[k])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in worst.items()}
    checks["unconverged"] = {"value": unconverged, "limit": 0}
    return checks, failed


class Run:
    """One cell's program, set up: imports, mesh, assembly and the capped
    warm-up solve, each a span; ``setup_s`` counts from ``t_start``."""

    def __init__(self, root: str, workload: str, device: str = "cuda", t_start: float | None = None):
        t_start = time.perf_counter() if t_start is None else t_start
        self.spec = spec = load_cell(root, workload)
        import torch

        import l3ster_tpu_torch as lp
        from portbench import traffic

        self.torch = torch
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.sync = torch.cuda.synchronize if self.cuda else (lambda: None)
        set_tf32(torch, False)  # float32 with TF32 off, as the configurations state
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.spans = Spans(self.dev)
        self.spans.s["imports_s"] = time.perf_counter() - t_start
        problem = importlib.import_module(f"portbench.problems.{spec['cfg']['problem']}")
        self.case = problem.Case(lp, spec["cfg"], self.dev, self.spans)
        self.solver, precond = traffic.solver(lp, spec["mix"])
        # the warm-up shares the preconditioner object, whose set-up the solver caches
        opts = dataclasses.replace(self.solver.opts, max_iters=spec["mix"]["warmup_iters"])
        warm = dataclasses.replace(self.solver, opts=opts)
        layer_calls, precond_calls = [], []
        undo = [_capture(self.case.system, "operator_parts", layer_calls),
                _capture(precond, "setup_parts", precond_calls)]
        try:
            with self.spans("warmup_s"), warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # the capped warm-up stops short by design
                _solve_one(torch, self.case, warm, {"a": 0.0, "b": 1.0}, self.sync)
        finally:
            for u in undo:
                u()
        self.setup_s = time.perf_counter() - t_start
        args, kwargs, _ = layer_calls[0] if layer_calls else ((), {}, None)  # the solver's own call comes first
        self.layout = kwargs.get("layout", args[0] if args else "dof")
        self.precond_parts = precond_calls[0][2] if precond_calls else None

    def window(self, seed: int, seconds: float, trace: bool):
        """(window seconds, solves, sampled answers, profiler or None) of one measured window."""
        import numpy as np

        from portbench import traffic

        gen = traffic.requests(self.spec["mix"], seed)
        rng = np.random.default_rng([int(seed), 1])  # apart from the requests' stream
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU])
            prof.__enter__()
        try:
            window_s, done, sample = run_window(self.torch, self.case, self.solver, gen, seconds, self.sync,
                                                self.spec["mix"]["answers_judged"], rng)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return window_s, done, sample, prof

    def context(self, window_s: float, done: list) -> dict:
        """What the metric readers and probes read."""
        return dict(cfg=self.spec["cfg"], mix=self.spec["mix"], spans=self.spans.s, setup_s=self.setup_s,
                    window_s=window_s, results=[r for _, r in done], device=self.dev, probes={},
                    reference=importlib.import_module(f"portbench.reference.{self.spec['config']}"),
                    layout=self.layout, precond_parts=self.precond_parts, case=self.case, x=self.case.system.x)

    def reference(self):
        """The configuration's plain reference, built on this run's device."""
        return build_reference(self.spec, self.dev)


def build_reference(spec: dict, device):
    return importlib.import_module(f"portbench.reference.{spec['config']}").build(spec["cfg"], device)


def read_metrics(entries: list, ctx: dict) -> dict:
    """Each metric's reader (``metrics/<name>.py``), after the probes it names;
    a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in entries:
        reader = importlib.import_module(f"portbench.metrics.{m['name']}")
        for p in getattr(reader, "PROBES", ()):
            if p not in ctx["probes"]:
                ctx["probes"][p] = importlib.import_module(f"portbench.probes.{p}").run(ctx)
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
            if "roofline" in m["name"] and "power_limit" in ctx:
                out[m["name"]]["power_limit"] = ctx["power_limit"]
    return out


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of one cell; returns the result line's object (``checks`` last)."""
    run = Run(root, workload, device, t_start)
    torch = run.torch
    window_s, done, sample, prof = run.window(seed, seconds, trace)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        raise SystemExit(3)
    device_info = {"platform": "gpu" if run.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated() if run.cuda else 0)}
    ctx = run.context(window_s, done)
    breakdown = None
    if trace and run.cuda:
        from portbench import tracing, yardstick

        ctx["trace"] = red = tracing.reduce_trace(prof)
        device_info["busy_s"], device_info["window_s"] = red["busy_s"], red["window_s"]
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        ctx["power_limit"] = device_info["power_limit"] = yardstick.power_limit()
    prof = None
    metrics = read_metrics(run.spec["per_layer"] if trace else run.spec["end_to_end"], ctx)

    # the program's state is freed before the reference runs
    labels, spec, dev = run.case.answer_labels(), run.spec, run.dev
    del ctx, run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = judge_answers(build_reference(spec, dev), labels, done, sample, spec["limits"])
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": len(done), "failed": int(failed), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
