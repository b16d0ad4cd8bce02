"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``l3ster_tpu_torch`` (never JAX, never ``l3ster_tpu``) through its
main paths, matrix-free 3D diffusion (4 unknowns, 7 equations, float32),
each solved with CG + Jacobi:

* the lattice path at the bench configuration: a p=6 cube of 6^3 hexes
  (202,612 dofs), value-only adiabatic faces on sides 1-4 and Dirichlet T on
  sides 5-6, the operator taken as ``operator_parts(layout="lattice")``;
  constant coefficients (``lattice_sf_const_diag``), then the same system
  under each of the reference's opt-in pipelines (``L3STER_TPU_ZSWEEP=v1``:
  the v1 z-sweep; ``L3STER_TPU_XY_PALLAS=1``: the x/y stage kernel);
* the variable-coefficient lattice path (``lattice_sf_var``): the bench
  kernel with its conservation row times k = 1 + x*y, Dirichlet T = x from a
  boundary kernel, at the bench size and on a 12^3-hex p=6 cube (1,556,068
  dofs);
* the unstructured path on the cylinder-in-channel mesh at its default size
  (``make_cylinder_in_channel_3d()``, 17,456 hexes) at p = 4 (4,789,376
  dofs): Dirichlet T = x from a boundary residual kernel on the inlet (3),
  the outlet (4) and the cylinder (5), value-only adiabatic walls (1, 2) and
  caps (6, 7).  AUTO takes the dense apply (``dense_const``, the per-QP
  kernel between two matmuls) with direct boundary contributions;
  ``SUM_FACT_PALLAS`` takes the fused sum-factorized kernel.

Phases, each reported on its own line:

1. environment (torch, CUDA, nvcc, the card and its power limit);
2. build of every kernel from the sources in the checkout, one nvcc each,
   all started together;
3. each kernel against its plain torch version at its main path's shapes,
   f64 and f32, with CUDA-event times on the card (host enqueueing hidden
   behind a sleep kernel) of kernel, plain version and a cuBLAS-matmul chain
   of the same function (``library_ms``): the z-sweep const (diag, full) and
   var (full, diag, K = 15 planes) at the bench shapes, its ``"zc"`` layout,
   var+full at the 12^3 shapes, the v1 wrapper, the stage kernel in the six
   stage shapes of an x/y-pipeline apply (single and K-concat forms, each
   with its band descriptor built before the timed calls) and their sums, then
   the per-QP and fused sum-factorized kernels at the cylinder's shapes; the
   redesigned kernels' lines carry their launch shape and resident blocks
   per SM, and the build phase each kernel's registers and spills;
4. the lattice main path: the bench system's operator apply (f32) against
   the same system in f64 on the card, and a small system against the CPU
   path; apply time, GFLOP/s, device-busy time and idle share;
5. CG + Jacobi on the manufactured T = x problem at the bench size;
6. the bench system under each opt-in pipeline: its apply against the
   default one, its time, device-busy time and kernel launches;
7. the variable-coefficient path at the bench size and at 12^3 hexes: f32
   apply against the f64 system on the card (and, at the bench size, a small
   f64 system against the CPU path), apply time, device-busy time, idle
   share and the costliest kernels, then CG + Jacobi with its nodal errors;
8. the unstructured main path: the cylinder system's apply (f32, AUTO)
   against the same system in f64 on the card, a small cylinder system
   against the CPU path, apply time, device-busy time and idle share; the
   same system under SUM_FACT_PALLAS against the f64 apply, and its time;
9. CG + Jacobi on the cylinder problem.

Each kernel's launch count is set to 0 just before the path it is counted
on and read just after it: the z-sweep's const mode on phases 4-5, its var
mode on the bench-size phase 7, the v1 wrapper and the stage kernel on their
phase 6 systems, the per-QP kernel on phases 8-9 (after its comparison
systems ran), the fused one on the SUM_FACT_PALLAS system.  The
second-to-last lines are the kernels' JSON record and the nvidia-smi line;
the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.  Run: ``python3 chip_smoke.py`` (one card).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

# card peaks used for bounds (NVIDIA H100 SXM data sheet, 700 W): HBM bytes/s
# and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12

F32_KERNEL_TOL = 2e-5  # f32 kernel vs f64 plain: max abs error / max |ref|
F64_KERNEL_TOL = 1e-11  # f64 kernel vs f64 plain
F32_APPLY_TOL = 1e-4  # f32 bench apply vs the f64 system on the card
F64_APPLY_TOL = 1e-11  # f64 small system on the card vs the CPU path
CG_TOL, CG_MAX_ITERS = 1e-6, 20000  # f32 solve at the bench size
CYL_ORDER = 4  # the order examples/karman_2d.py uses for the full Karman mesh
# f32 CG + Jacobi on the cylinder, to the bench's relative residual.  The
# tolerance is on CG's recursively updated residual, which keeps falling in
# f32 while the true residual |b - A x| / |b| levels off near f32 rounding of
# the operator (the phase reports both); the graded mesh (cells from ~0.03
# at the cylinder to ~1.5 in the far field) at p = 4 is far worse conditioned
# than the bench cube, so the cap allows some 4x the iterations expected
# (PERF.md) before the run fails
CYL_CG_TOL, CYL_CG_MAX_ITERS = 1e-6, 20000


def _flops_per_apply(order: int, n_elems: int, n_unk: int, n_eq: int, q1: int) -> int:
    """Useful FLOPs of one sum-factorized constrained apply (3D); bench.py's count."""
    n = order + 1
    c = n_unk
    f = 0
    f += 2 * (2 * n * n * q1 * c * n)  # x-stage
    f += 3 * (2 * n * q1 * q1 * c * n)  # y-stage
    f += 4 * (2 * q1 * q1 * q1 * c * n)  # z-stage
    Q = q1**3
    f += 2 * Q * 9 * c  # J^-T transform of derivatives
    f += 2 * Q * 4 * n_eq * c  # r = A g
    f += Q * n_eq  # weighting
    f += 2 * Q * 4 * n_eq * c  # t = A^T r
    f += 2 * Q * 9 * c  # J^-1 transform back
    f += 4 * (2 * q1 * q1 * n * c * q1)
    f += 3 * (2 * q1 * n * n * c * q1)
    f += 2 * (2 * n * n * n * c * q1)
    return f * n_elems


def _diffusion_3d(inp, out):
    ops, rhs = out
    A0, Ax, Ay, Az = ops
    Ax[0, 1] = -1.0
    Ay[0, 2] = -1.0
    Az[0, 3] = -1.0
    A0[1, 1] = -1.0
    Ax[1, 0] = 1.0
    A0[2, 2] = -1.0
    Ay[2, 0] = 1.0
    A0[3, 3] = -1.0
    Az[3, 0] = 1.0
    Ay[4, 3] = 1.0
    Az[4, 2] = -1.0
    Ax[5, 3] = -1.0
    Az[5, 1] = 1.0
    Ax[6, 2] = 1.0
    Ay[6, 1] = -1.0


def _adiabatic_3d(inp, out):
    ops, _ = out
    ops[0][0, 1] = inp.normal[0]
    ops[0][0, 2] = inp.normal[1]
    ops[0][0, 3] = inp.normal[2]


def _say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def _cuda_ms(fn, reps: int = 20, batch: int = 10, warm: int = 3, queued: bool = False) -> float:
    """Milliseconds per fn() call: the median over reps runs of one CUDA-event
    pair around ``batch`` back-to-back calls, after warm-up.  Back-to-back
    calls let the device run ahead of the host where the host is faster, so
    this is device time for device-bound calls and host time otherwise.
    ``queued``: the stream first runs a sleep kernel that outlasts the host's
    enqueueing of the batch (twice its measured time), so the events time the
    device's work alone: a kernel's time on the card even where its wrapper's
    host work is longer."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    cycles = 0
    if queued:
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        cycles = int(2 * (time.perf_counter() - t0) * 2e9) + 1_000_000  # at most 2 GHz
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _var_diffusion_3d(inp, out):
    """The bench kernel with its conservation row times k(x, y) = 1 + x*y (the
    reference's variable-coefficient oracle, tests/test_lattice_sf.py:_var_3d);
    the exact solution stays T = x, q = (1, 0, 0)."""
    _diffusion_3d(inp, out)
    ops, _ = out
    k = 1.0 + inp.point.x * inp.point.y
    ops[1][0, 1] = -k
    ops[2][0, 2] = -k
    ops[3][0, 3] = -k


def _build_system(lp, order, n_1d, dtype, device, kernel=_diffusion_3d):
    """The bench configuration on an order-``order`` cube of (n_1d - 1)^3 hexes.
    The constant kernel takes T = 0 and T = 1 on sides 5 and 6; the variable
    one T = x from a boundary kernel (the same values on the unit cube)."""
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, n_1d)), order=order)
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    kd = lp.wrap_domain_equation_kernel(kernel, lp.KernelParams(3, 7, 4))
    kn = lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4))
    if kernel is _diffusion_3d:
        system.set_dirichlet_bc_values([0.0], [5], [0])  # T = x: 0 on the left ...
        system.set_dirichlet_bc_values([1.0], [6], [0])  # ... and 1 on the right
    else:
        kdir = lp.wrap_boundary_residual_kernel(_t_equals_x, lp.KernelParams(3, 1))
        system.set_dirichlet_bc_values(kdir, [5, 6], [0])
    system.begin_assembly()
    system.assemble_problem(kd, [0])
    system.assemble_problem(kn, [1, 2, 3, 4])
    system.end_assembly()
    return mesh, system


def _library_zsweep(A, b, bdy, bdx, geom, NzT, DzT, var=None):
    """The z-sweep's function as cuBLAS matmuls and elementwise torch (a
    variable A through index_add_ over its planes): the yardstick for
    ``library_ms``; the port never calls it."""
    import torch

    c, n1z, RQ = b.shape
    S = NzT.shape[1]
    TND = torch.cat([NzT, DzT], dim=1).T.contiguous()  # (2S, n1z)
    X = torch.stack([b, bdy, bdx])  # (3, c, n1z, RQ)
    Y = torch.matmul(TND, X)  # (3, c, 2S, RQ)
    v, dz, dy, dx = Y[0, :, :S], Y[0, :, S:], Y[1, :, :S], Y[2, :, :S]
    d1 = 4
    if geom[0] == "diag":
        _, jx, jy, jz, wyx, wz = geom
        g = torch.stack([v, jx * dx, jy * dy, jz * dz])
        w = wz * wyx
    else:
        _, ji, w = geom
        J = ji.reshape(3, 3, S, RQ)
        g = torch.cat([v[None], torch.einsum("jisq,jcsq->icsq", J, torch.stack([dx, dy, dz]))])
    if var is None:
        Am = torch.as_tensor(A, dtype=b.dtype, device=b.device)
        n_eq = Am.shape[1]
        M = Am.permute(1, 0, 2).reshape(n_eq, d1 * c)  # (n_eq, 4c)
        r = torch.matmul(M, g.reshape(d1 * c, S * RQ)) * w.reshape(1, S * RQ)
        t = torch.matmul(M.T, r).reshape(d1, c, S, RQ)
    else:
        nz, A_nz, n_eq = var
        slot = torch.as_tensor([d * c + u for d, _, u in nz], device=b.device)
        eq = torch.as_tensor([i for _, i, _ in nz], device=b.device)
        gk = g.reshape(d1 * c, S, RQ)[slot] * A_nz
        r = torch.zeros((n_eq, S, RQ), dtype=b.dtype, device=b.device).index_add_(0, eq, gk) * w
        t = torch.zeros((d1 * c, S, RQ), dtype=b.dtype, device=b.device)
        t = t.index_add_(0, slot, A_nz * r[eq]).reshape(d1, c, S, RQ)
    if geom[0] == "diag":
        tx, ty, tz = jx * t[1], jy * t[2], jz * t[3]
    else:
        tx, ty, tz = torch.einsum("jisq,icsq->jcsq", J, t[1:])
    NT = NzT.contiguous()
    a = torch.matmul(torch.cat([NT, DzT], dim=1), torch.cat([t[0], tz], dim=1))
    return a, torch.matmul(NT, ty), torch.matmul(NT, tx)


def phase_environment() -> tuple[str, str]:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this smoke test needs a GPU")
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = subprocess.run(
            [f"{CUDA_HOME}/bin/nvcc", "--version"], capture_output=True, text=True
        ).stdout.strip().splitlines()[-1]
    except (OSError, IndexError, TypeError):
        nvcc = "nvcc not found"
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    _say(
        "environment", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=nvcc, nvidia_smi=smi, device=kind,
        device_count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
    )
    return smi, kind


def phase_build() -> None:
    from l3ster_tpu_torch.ops import _cuda, qp, stages, sumfact_fused, zsweep

    names = ("zsweep", "qp_algebra", "sumfact_fused", "stage_matmul")
    t0 = time.perf_counter()
    paths = _cuda.build(*names)  # one nvcc per source, all at once
    zsweep._library()
    stages._library()
    _cuda.load("qp_algebra", qp._declare)
    _cuda.load("sumfact_fused", sumfact_fused._declare)
    seconds = round(time.perf_counter() - t0, 3)
    for n in names:
        _say("build", kernel=n, seconds=seconds, library=paths[n], ptxas=_ptxas_summary(_cuda.build_logs.get(n, "")))


def _ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas=-v report: its
    (demangled-enough) name, registers, static shared memory and spills."""
    out, fn, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.split(",", 1)[1].strip()
        elif "Used" in ln and "registers" in ln and fn is not None:
            out.append(f"{fn}: {ln.split('Used', 1)[1].strip()}; {spill}")
            fn, spill = None, ""
    return out


def _bench_kernel_inputs(lp, seed: int, ne: int = 6):
    """Bench shapes (p = 6, ne^3 hexes: 6^3 the bench, 12^3 the var 12^3 box)
    and random inputs of the z-sweep: the constant A of the bench kernel, the
    nonzero planes of its variable form and both geometries, made with numpy
    from a seed."""
    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables

    order, q_order = 6, lp.AssemblyOptions().quadrature_order(6)
    q1 = q_order // 2 + 1
    S = ne * q1
    RQ = S * S
    c, n1z = 4, ne * order + 1
    A = _constant_kernel_operators(lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4)), 0.0)
    nz = tuple(tuple(int(v) for v in ix) for ix in np.argwhere(A != 0))  # the var kernel's 15 planes
    rng = np.random.default_rng(seed)
    host = {
        "b": rng.normal(size=(3, c, n1z, RQ)),
        "A_nz": np.stack([A[d, i, u] * rng.uniform(1.0, 2.0, (S, RQ)) for d, i, u in nz]),
        "jx": rng.uniform(0.5, 1.5, (1, RQ)), "jy": rng.uniform(0.5, 1.5, (1, RQ)),
        "jz": rng.uniform(0.5, 1.5, (S, 1)), "wyx": rng.uniform(0.5, 1.0, (1, RQ)),
        "wz": rng.uniform(0.5, 1.0, (S, 1)),
        "ji": rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1),
        "w": rng.uniform(0.5, 1.0, (S, RQ)),
    }
    Ng, Dg = banded_tables(order, q_order, ne)
    return dict(A=A, nz=nz, host=host, Ng=Ng, Dg=Dg, c=c, n1z=n1z, S=S, RQ=RQ)


def _bench_args(inp, dt, mode: str, layout: str = "cz"):
    """(b, bdy, bdx, geom, tabs, A_nz) on the card in dtype dt: the b tensors
    in the given layout, the geometry of the given mode, the z tables."""
    import torch

    from l3ster_tpu_torch.ops.zsweep import zsweep_tables

    d = {k: torch.as_tensor(v, dtype=dt, device="cuda") for k, v in inp["host"].items()}
    b = [d["b"][i] for i in range(3)]
    if layout == "zc":
        b = [x.transpose(0, 1).contiguous() for x in b]
    if mode == "diag":
        geom = ("diag", d["jx"], d["jy"], d["jz"], d["wyx"], d["wz"])
    else:
        geom = ("full", d["ji"], d["w"])
    return (*b, geom, zsweep_tables(inp["Ng"].T, inp["Dg"].T, dt, "cuda"), d["A_nz"])


def _zsweep_bound(inp, tabs, mode: str, K: int, nnz: int) -> tuple[float, str, int, int]:
    """(bound ms, bound by, bytes, flops) of one z-sweep call in f32: the six
    b/a tensors, the geometry, the tables and K streamed planes each moved
    once; the FMAs of the nonzero table band and of the per-QP algebra."""
    c, n1z, S, RQ = inp["c"], inp["n1z"], inp["S"], inp["RQ"]
    lay = tabs.layers
    band = int((lay[:, 1] * lay[:, 3]).sum())  # nonzero band entries of a table, by column or by row
    geo = (3 * RQ + 2 * S) if mode == "diag" else 10 * S * RQ
    flops = (
        8 * c * RQ * band  # z interpolation: 4 FMAs per band entry
        + 8 * c * RQ * band  # z transpose: 4 FMAs per band entry
        + S * RQ * (4 * nnz + 7 + (6 if mode == "diag" else 30) * c)  # per-QP algebra
    )
    nbytes = 4 * (6 * c * n1z * RQ + geo + K * S * RQ + tabs.blk.numel()) + 4 * lay.size
    return _bound(nbytes, flops) + (nbytes, flops)


def _compare_call(kernel, plain, library, args64, args32) -> dict:
    """Kernel (f64 and f32) against the plain version (f64), and the times of
    kernel, plain version and library chain in f32."""
    import torch

    ref = plain(*args64)
    k64, k32, lib = kernel(*args64), kernel(*args32), library(*args32)
    torch.cuda.synchronize()
    ref = ref if isinstance(ref, tuple) else (ref,)
    k64, k32, lib = ((x if isinstance(x, tuple) else (x,)) for x in (k64, k32, lib))
    scale = max(float(r.abs().max()) for r in ref)
    err64 = max(float((k - r).abs().max()) for k, r in zip(k64, ref)) / scale
    abs32 = max(float((k.double() - r).abs().max()) for k, r in zip(k32, ref))
    lib_err = max(float((x.double() - r).abs().max()) for x, r in zip(lib, ref)) / scale
    return dict(
        f64_rel_err=err64, f32_rel_err=abs32 / scale, f32_abs_err=abs32, library_rel_err=lib_err,
        ms=_cuda_ms(lambda: kernel(*args32), queued=True), plain_ms=_cuda_ms(lambda: plain(*args32), queued=True),
        library_ms=_cuda_ms(lambda: library(*args32), queued=True),
        ok=err64 < F64_KERNEL_TOL and abs32 / scale < F32_KERNEL_TOL,
    )


def _zsweep_record(name, replaces, res, bound_ms, bound_by, source="l3ster_tpu_torch/csrc/zsweep.cu") -> dict:
    return dict(
        name=name, route="cuda", source=source, replaces=replaces, launches=None,
        max_abs_err=res["f32_abs_err"], ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=bound_ms,
        bound_by=bound_by, library_ms=res["library_ms"],
    )


def phase_kernels(lp) -> tuple[dict, dict]:
    """The z-sweep against its plain version at the bench shapes: the constant
    modes (diag, the bench's, and full), then the variable mode with the
    K = 15 planes of the var bench kernel (full geometry, the var path's, and
    diag) and its "zc" layout; returns the records of B1 const and B1 var."""
    import torch

    from l3ster_tpu_torch.ops.zsweep import fused_z_sweep, fused_z_sweep_plain, kernel_occupancy, plane_table

    records = {}
    for var, mode, layout, ne in (
        (False, "diag", "cz", 6), (False, "full", "cz", 6), (True, "full", "cz", 6), (True, "diag", "cz", 6),
        (True, "full", "zc", 6), (True, "full", "cz", 12),  # the last: the var 12^3 apply's shapes
    ):
        inp = _bench_kernel_inputs(lp, seed=0, ne=ne)
        A, nz = inp["A"], inp["nz"]
        args = {}
        for dt in (torch.float64, torch.float32):
            *xs, A_nz = _bench_args(inp, dt, mode, layout)
            args[dt] = (*xs, (nz, A_nz, 7) if var else None)
        A_c = None if var else A

        def kern(b, bdy, bdx, geom, tabs, v, layout=layout, A_c=A_c):
            return fused_z_sweep(A_c, b, bdy, bdx, geom, tabs, var=v, layout=layout)

        def plain(b, bdy, bdx, geom, tabs, v, layout=layout, A_c=A_c):
            return fused_z_sweep_plain(A_c, b, bdy, bdx, geom, tabs.NzT, tabs.DzT, var=v, layout=layout)

        def lib(b, bdy, bdx, geom, tabs, v, layout=layout, A_c=A_c):
            if layout == "cz":
                return _library_zsweep(A_c, b, bdy, bdx, geom, tabs.NzT, tabs.DzT, var=v)
            t = (x.transpose(0, 1) for x in (b, bdy, bdx))
            return tuple(x.transpose(0, 1) for x in _library_zsweep(A_c, *t, geom, tabs.NzT, tabs.DzT, var=v))

        res = _compare_call(kern, plain, lib, args[torch.float64], args[torch.float32])
        K, nnz = (len(nz), len(nz)) if var else (0, int((A != 0).sum()))
        tabs32 = args[torch.float32][4]
        bound_ms, bound_by, nbytes, flops = _zsweep_bound(inp, tabs32, mode, K, nnz)
        A_k = plane_table(nz, 7, inp["c"]) if var else A
        occ = kernel_occupancy(torch.float32, mode == "diag", A_k, K, tabs32, inp["RQ"])
        name = "zsweep_var" if var else "zsweep"
        _say(
            "kernel_vs_plain", kernel=name, mode=mode, layout=layout, planes=K, ne_z=ne,
            shape=[inp["c"], inp["n1z"], inp["S"], inp["RQ"]], f64_tol=F64_KERNEL_TOL,
            f32_tol=F32_KERNEL_TOL, bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / res["ms"], launch_shape=occ, **res,
        )
        if not res["ok"]:
            raise SystemExit(f"chip_smoke: {name} disagrees with its plain version ({mode} {layout} ne_z={ne})")
        if name not in records:  # the first mode of each is its path's: const diag, var full
            records[name] = _zsweep_record(name, "l3ster_tpu/ops/pallas_zsweep2.py:402", res, bound_ms, bound_by)
        del args, inp
        torch.cuda.empty_cache()
    return records["zsweep"], records["zsweep_var"]


def phase_kernels_v1(lp) -> dict:
    """The v1 wrapper (const A, full geometry, (n1z, c, RQ)) at the bench
    shapes; returns B5's record."""
    import torch

    from l3ster_tpu_torch.ops import zsweep_v1

    inp = _bench_kernel_inputs(lp, seed=6)
    A = inp["A"]
    args = {}
    for dt in (torch.float64, torch.float32):
        b, bdy, bdx, (_, ji, w), tabs, _ = _bench_args(inp, dt, "full", "zc")
        args[dt] = (b, bdy, bdx, ji, w, tabs.NzT, tabs.DzT, tabs)

    def lib(b, bdy, bdx, ji, w, NzT, DzT, tabs):
        t = (x.transpose(0, 1) for x in (b, bdy, bdx))
        return tuple(x.transpose(0, 1) for x in _library_zsweep(A, *t, ("full", ji, w), NzT, DzT))

    res = _compare_call(
        lambda *a: zsweep_v1.fused_z_sweep(A, *a), lambda *a: zsweep_v1.fused_z_sweep_plain(A, *a[:-1]),
        lib, args[torch.float64], args[torch.float32],
    )
    nnz = int((A != 0).sum())
    bound_ms, bound_by, nbytes, flops = _zsweep_bound(inp, args[torch.float32][-1], "full", 0, nnz)
    _say(
        "kernel_vs_plain", kernel="zsweep_v1", mode="full", layout="zc",
        shape=[inp["n1z"], inp["c"], inp["S"], inp["RQ"]], f64_tol=F64_KERNEL_TOL, f32_tol=F32_KERNEL_TOL,
        bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by, **res,
    )
    if not res["ok"]:
        raise SystemExit("chip_smoke: the v1 z-sweep disagrees with its plain version")
    return _zsweep_record(
        "zsweep_v1", "l3ster_tpu/ops/pallas_zsweep.py:138", res, bound_ms, bound_by,
        source="l3ster_tpu_torch/csrc/zsweep.cu (ops/zsweep_v1.py)",
    )


def phase_kernels_stages(lp) -> dict:
    """The stage kernel in the six stage shapes of one x/y-pipeline apply at
    the bench (single and K-concat forms), each with its band descriptor
    built before the comparison and the timed calls, and beside it the
    floor of any kernel that moves the stage's bytes: a torch copy of as
    many bytes (``copy_same_bytes_ms``) and, once, an empty kernel
    (``empty_kernel_ms``), timed the same way; returns B4's record, whose
    times and bound are the sums over the six shapes (one apply's
    stages)."""
    import torch

    from l3ster_tpu_torch.ops.stages import (
        band_descriptor, kernel_occupancy, kstacked_matmul, kstacked_matmul_plain, stage_tables,
    )

    order, ne, q_order = 6, 6, lp.AssemblyOptions().quadrature_order(6)
    q1 = q_order // 2 + 1
    n1, Qa, c = ne * order + 1, ne * q1, 4
    czy, czQ = c * n1 * n1, c * n1 * Qa
    stages_ = [  # (stage, rows, table kind, K-concat pair)
        ("x_interp", czy, "ND", False), ("y_interp_ND", czQ, "ND", False), ("y_interp_N", czQ, "N", False),
        ("y_transpose_NDT", czQ, "NDT", True), ("y_transpose_NT", czQ, "NT", False),
        ("x_transpose_NDT", czy, "NDT", True),
    ]
    rng = np.random.default_rng(7)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, copy_same_bytes_ms=0.0, bound_ms=0.0, bytes=0, flops=0)
    max_abs = 0.0
    for name, M, kind, pair in stages_:
        T = stage_tables(order, q_order, ne, kind)
        KT, N = T.shape
        K1 = KT // 2 if pair else KT
        host = [rng.normal(size=(M, K1)) for _ in range(2 if pair else 1)]
        args = {}
        for dt in (torch.float64, torch.float32):
            xs = [torch.as_tensor(h, dtype=dt, device="cuda") for h in host]
            band = band_descriptor(T, K1, "cuda", dt)
            args[dt] = (xs[0], xs[1] if pair else None, band.table, band)

        def lib(x, x2, Tt, band, K1=K1):  # cuBLAS: one matmul, or two for the pair
            out = torch.matmul(x, Tt[:K1])
            return out if x2 is None else torch.addmm(out, x2, Tt[K1:])

        res = _compare_call(
            lambda x, x2, Tt, band, N=N: kstacked_matmul(x, x2, Tt, N, band),
            lambda x, x2, Tt, band, N=N: kstacked_matmul_plain(x, x2, Tt, N), lib,
            args[torch.float64], args[torch.float32],
        )
        nbytes = 4 * (M * KT + KT * N + M * N)
        flops = 2 * M * int((T != 0).sum())  # the table's nonzero band
        bound_ms, bound_by = _bound(nbytes, flops)
        src = torch.empty(nbytes // 8, device="cuda")  # read and written: nbytes in all
        dst = torch.empty_like(src)
        copy_ms = _cuda_ms(lambda: dst.copy_(src), queued=True)
        del src, dst
        occ = kernel_occupancy(torch.float32, M, K1, KT - K1, args[torch.float32][3])
        _say(
            "kernel_vs_plain", kernel="stage_matmul", stage=name, shape=[M, KT, N], pair=pair,
            band_span=list(band.span), f64_tol=F64_KERNEL_TOL, f32_tol=F32_KERNEL_TOL, bytes=nbytes,
            flops=flops, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / res["ms"],
            copy_same_bytes_ms=copy_ms, launch_shape=occ, **res,
        )
        if not res["ok"]:
            raise SystemExit(f"chip_smoke: the stage kernel disagrees with its plain version ({name})")
        tot["copy_same_bytes_ms"] += copy_ms
        for k in ("ms", "plain_ms", "library_ms"):
            tot[k] += res[k]
        tot["bound_ms"] += bound_ms
        tot["bytes"] += nbytes
        tot["flops"] += flops
        max_abs = max(max_abs, res["f32_abs_err"])
    bound_by = "bytes" if tot["bytes"] / PEAK_BYTES >= tot["flops"] / PEAK_F32_FLOPS else "operations"
    _say(
        "kernel_stage_totals", kernel="stage_matmul", stages=len(stages_),
        share_of_bound=tot["bound_ms"] / tot["ms"],
        empty_kernel_ms=_cuda_ms(lambda: torch.cuda._sleep(0), queued=True), **tot,
    )
    return dict(
        name="stage_matmul", route="cuda", source="l3ster_tpu_torch/csrc/stage_matmul.cu",
        replaces="l3ster_tpu/ops/pallas_stages.py:166", launches=None, max_abs_err=max_abs,
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=bound_by,
        library_ms=tot["library_ms"],
    )


def phase_main_path(lp) -> dict:
    import torch

    from l3ster_tpu_torch.ops import zsweep

    # an independent check at a small size: the f64 system on the card (the
    # kernel) against the same system on the CPU (the plain version)
    _, small_gpu = _build_system(lp, 3, 3, torch.float64, "cuda")
    _, small_cpu = _build_system(lp, 3, 3, torch.float64, "cpu")
    xs = torch.as_tensor(np.random.default_rng(1).normal(size=(small_cpu.n_dofs, 1)))
    fg, cg = small_gpu.operator_parts(layout="lattice")
    fc, cc = small_cpu.operator_parts(layout="lattice")
    yg = fg(small_gpu.to_lattice_layout(xs.cuda()), *cg).cpu()
    yc = fc(small_cpu.to_lattice_layout(xs), *cc)
    small_err = float((yg - yc).abs().max() / yc.abs().max())

    # the f64 reference of the bench apply, made before the main path's count
    # starts: its kernel launches are a comparison, not the main path
    _, sys64 = _build_system(lp, 6, 7, torch.float64, "cuda")
    x64 = torch.as_tensor(np.random.default_rng(2).normal(size=(sys64.n_dofs, 1)), device="cuda")
    f64, c64 = sys64.operator_parts(layout="lattice")
    y64 = f64(sys64.to_lattice_layout(x64), *c64)
    del sys64, f64, c64

    zsweep.launch_count = 0  # the main path starts here
    t0 = time.perf_counter()
    mesh, system = _build_system(lp, 6, 7, torch.float32, "cuda")
    fn, consts = system.operator_parts(layout="lattice")
    xl = system.to_lattice_layout(x64.float())
    y32 = fn(xl, *consts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches_first = zsweep.launch_count
    apply_err = float((y32.double() - y64).abs().max() / y64.abs().max())
    finite = bool(torch.isfinite(y32).all())
    del y64
    apply_ms = _cuda_ms(lambda: fn(xl, *consts))
    busy_ms, top = _profile_apply(lambda x: fn(x, *consts), xl)
    q1 = lp.AssemblyOptions().quadrature_order(6) // 2 + 1
    flops = _flops_per_apply(6, 6**3, 4, 7, q1)
    ok = finite and apply_err < F32_APPLY_TOL and small_err < F64_APPLY_TOL and launches_first > 0
    _say(
        "main_path_apply", n_dofs=system.n_dofs, layout="lattice", dtype="float32",
        setup_s=setup_s, zsweep_launches_first_apply=launches_first,
        rel_err_vs_f64_on_card=apply_err, tol=F32_APPLY_TOL, small_f64_rel_err_vs_cpu=small_err,
        small_tol=F64_APPLY_TOL, shape=list(y32.shape), finite=finite, apply_ms=apply_ms,
        gflops=flops / (apply_ms * 1e-3) / 1e9, flops_per_apply=flops, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / apply_ms, top_device_ms_per_apply=top, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: main-path apply failed its checks")
    return {"system": system, "mesh": mesh, "xl": xl, "y32": y32, "apply_ms": apply_ms}


def phase_solve(lp, state: dict, phase: str = "solve") -> None:
    import torch

    from l3ster_tpu_torch.ops import zsweep

    system, mesh = state["system"], state["mesh"]
    before = zsweep.launch_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = system.solve(lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=lp.Jacobi()))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    X = system.x[:, 0].reshape(-1, 4).double().cpu().numpy()
    err_T = float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())
    err_q = float(max(np.abs(X[:, 1] - 1.0).max(), np.abs(X[:, 2:]).max()))
    _say(
        phase, n_dofs=system.n_dofs, solver="CG+Jacobi", dtype="float32", tol=CG_TOL, max_iters=CG_MAX_ITERS,
        iterations=r.num_iters, achieved_rel_residual=r.tol, converged=r.converged,
        solve_s=solve_s, ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1),
        max_nodal_err_T_minus_x=err_T, max_nodal_err_q_minus_1_0_0=err_q,
        zsweep_launches=zsweep.launch_count - before,
    )
    if not r.converged:
        raise SystemExit(f"chip_smoke: CG + Jacobi did not reach its tolerance ({phase})")


def phase_switches(lp, state: dict) -> dict:
    """The bench system (f32) under each of the reference's opt-in lattice
    pipelines, set in-process before the system is built and unset after:
    its apply against the default pipeline's, its time and device-busy time,
    and the launches of its kernels (counts set to 0 just before the system
    is built, read after its applies).  Returns {kernel name: launches}."""
    import os

    import torch

    from l3ster_tpu_torch.ops import stages, zsweep, zsweep_v1

    xl, y_default = state["xl"], state["y32"]
    launches = {}
    for env, value, kind, variant in (
        ("L3STER_TPU_ZSWEEP", "v1", "lattice_sf_const", "v1"),
        ("L3STER_TPU_XY_PALLAS", "1", "lattice_sf_const_diag", "xy"),
    ):
        zsweep.launch_count = zsweep_v1.launch_count = stages.launch_count = 0
        os.environ[env] = value
        try:
            _, system = _build_system(lp, 6, 7, torch.float32, "cuda")
            fn, consts = system.operator_parts(layout="lattice")
        finally:
            del os.environ[env]
        kinds = [d[0] for _, d in system._operators()[1]]
        y = fn(xl, *consts)
        torch.cuda.synchronize()
        err = float((y - y_default).abs().max() / y_default.abs().max())
        ms = _cuda_ms(lambda: fn(xl, *consts))
        busy_ms, top = _profile_apply(lambda x: fn(x, *consts), xl)
        counts = dict(zsweep=zsweep.launch_count, zsweep_v1=zsweep_v1.launch_count, stage_matmul=stages.launch_count)
        ok = (
            kinds == [kind] + ["face_banded"] * 4 and system._variant == variant
            and bool(torch.isfinite(y).all()) and err < F32_APPLY_TOL
            and (counts["zsweep_v1"] > 0 if variant == "v1" else counts["stage_matmul"] > 0 and counts["zsweep"] > 0)
        )
        _say(
            "bench_apply_opt_in", env=f"{env}={value}", kinds=kinds, variant=system._variant,
            rel_err_vs_default_apply=err, tol=F32_APPLY_TOL, apply_ms=ms, default_apply_ms=state["apply_ms"],
            device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / ms, top_device_ms_per_apply=top,
            launches=counts, ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: the bench apply under {env}={value} failed its checks")
        launches["zsweep_v1" if variant == "v1" else "stage_matmul"] = (
            counts["zsweep_v1"] if variant == "v1" else counts["stage_matmul"]
        )
        del system, fn, consts, y
        torch.cuda.empty_cache()
    return launches


def phase_var_path(lp, n_1d: int, phase: str) -> dict:
    """The variable-coefficient lattice path at p = 6 on (n_1d - 1)^3 hexes:
    the f32 apply against the same system in f64 on the card (and, at the
    bench size, a small f64 system on the card against the CPU path), its
    time, device-busy time, idle share and costliest kernels.  The z-sweep's
    launch count is set to 0 just before the f32 system is built."""
    import torch

    from l3ster_tpu_torch.ops import zsweep

    small_err = None
    if n_1d == 7:
        _, small_gpu = _build_system(lp, 3, 3, torch.float64, "cuda", _var_diffusion_3d)
        _, small_cpu = _build_system(lp, 3, 3, torch.float64, "cpu", _var_diffusion_3d)
        xs = torch.as_tensor(np.random.default_rng(11).normal(size=(small_cpu.n_dofs, 1)))
        fg, cg = small_gpu.operator_parts(layout="lattice")
        fc, cc = small_cpu.operator_parts(layout="lattice")
        yc = fc(small_cpu.to_lattice_layout(xs), *cc)
        small_err = float((fg(small_gpu.to_lattice_layout(xs.cuda()), *cg).cpu() - yc).abs().max() / yc.abs().max())
        del small_gpu, small_cpu
    t0 = time.perf_counter()
    _, sys64 = _build_system(lp, 6, n_1d, torch.float64, "cuda", _var_diffusion_3d)
    f64, c64 = sys64.operator_parts(layout="lattice")
    x64 = torch.as_tensor(np.random.default_rng(12).normal(size=(sys64.n_dofs, 1)), device="cuda")
    y64 = f64(sys64.to_lattice_layout(x64), *c64)
    torch.cuda.synchronize()
    setup64_s = time.perf_counter() - t0
    del sys64, f64, c64
    torch.cuda.empty_cache()

    zsweep.launch_count = 0  # the var path starts here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mesh, system = _build_system(lp, 6, n_1d, torch.float32, "cuda", _var_diffusion_3d)
    kinds = [d[0] for _, d in system._operators()[1]]
    nz = system._operators()[1][0][1][1][0]
    fn, consts = system.operator_parts(layout="lattice")
    xl = system.to_lattice_layout(x64.float())
    y32 = fn(xl, *consts)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    launches_first = zsweep.launch_count
    err = float((y32.double() - y64).abs().max() / y64.abs().max())
    finite = bool(torch.isfinite(y32).all())
    del y64, x64
    ms = _cuda_ms(lambda: fn(xl, *consts))
    busy_ms, top = _profile_apply(lambda x: fn(x, *consts), xl)
    # the byte bound of this size's z-sweep call: b/a tensors, full geometry
    # and the K planes, each moved once, in f32
    n1z, S = 6 * (n_1d - 1) + 1, 12 * (n_1d - 1)
    zs_bytes = 4 * (6 * 4 * n1z * S * S + (10 + len(nz)) * S**3 + 2 * n1z * S)
    ok = (
        kinds == ["lattice_sf_var"] + ["face_banded"] * 4 and len(nz) == 15 and finite
        and err < F32_APPLY_TOL and (small_err is None or small_err < F64_APPLY_TOL) and launches_first > 0
    )
    _say(
        phase, n_elements=(n_1d - 1) ** 3, order=6, n_dofs=system.n_dofs, kinds=kinds, planes=len(nz),
        dtype="float32", setup_s=setup_s, f64_setup_s=setup64_s, zsweep_launches_first_apply=launches_first,
        rel_err_vs_f64_on_card=err, tol=F32_APPLY_TOL, small_f64_rel_err_vs_cpu=small_err,
        small_tol=F64_APPLY_TOL, finite=finite, apply_ms=ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / ms, top_device_ms_per_apply=top,
        zsweep_var_bytes=zs_bytes, zsweep_var_bound_ms=zs_bytes / PEAK_BYTES * 1e3,
        peak_device_memory_bytes=torch.cuda.max_memory_allocated(), ok=ok,
    )
    if not ok:
        raise SystemExit(f"chip_smoke: the variable-coefficient apply failed its checks ({phase})")
    return {"system": system, "mesh": mesh}


# ------------------------------------------------------------ unstructured path


def _t_equals_x(inp, out):
    out[0] = inp.point.x


def _cylinder_mesh(lp, order: int, small: bool):
    """The default cylinder-in-channel mesh, or the small one of the tests."""
    kw = {}
    if small:
        kw = dict(
            distz=np.linspace(-1, 1, 3), left_offset=4.0, right_offset=6.0, bottom_offset=3.0,
            top_offset=3.0, n_circumf=16, n_radial=4, n_left=3, n_right=6, n_bottom=2, n_top=2,
        )
    return lp.generate_mesh(lp.make_cylinder_in_channel_3d(**kw), order=order)


def _build_cylinder(lp, mesh, strategy, dtype, device):
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4, 5], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    kn = lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4))
    kdir = lp.wrap_boundary_residual_kernel(_t_equals_x, lp.KernelParams(3, 1))
    system.set_dirichlet_bc_values(kdir, [3, 4, 5], [0])
    system.begin_assembly()
    opts = lp.AssemblyOptions(eval_strategy=getattr(lp.LocalEvalStrategy, strategy))
    system.assemble_problem(kd, [0], options=opts)
    system.assemble_problem(kn, [1, 2, 6, 7])
    system.end_assembly()
    return system


def _library_qp(A, G, Ji_t, w):
    """The per-QP chain on the reference's (d1*c, EQ) layout: J^-T and J^-1 as
    broadcast multiply-adds over the (dim, dim, EQ) planes, A and A^T as cuBLAS
    matmuls.  The yardstick for ``library_ms``; the port never calls it."""
    import torch

    E, c, d1, Q = G.shape
    EQ, n_eq = E * Q, A.shape[1]
    g = G.permute(2, 1, 0, 3).reshape(d1, c, EQ)
    J = Ji_t[:, :, None]  # (j, i, 1, EQ)
    gp = torch.cat([g[:1], (J * g[1:, None]).sum(0)])  # sum_j Ji[j, i] g[j]
    M = torch.as_tensor(A, dtype=G.dtype, device=G.device).permute(1, 0, 2).reshape(n_eq, d1 * c)
    r = torch.matmul(M, gp.reshape(d1 * c, EQ)) * w
    t = torch.matmul(M.T, r).reshape(d1, c, EQ)
    T = torch.cat([t[:1], (J * t[None, 1:]).sum(1)])  # sum_i Ji[j, i] t[i]
    return T.reshape(d1, c, E, Q).permute(2, 1, 0, 3)


def _library_sumfact(A, ji, w, Ball, x):
    """The fused apply's function as the dense chain: cuBLAS matmuls with the
    full basis matrix around :func:`_library_qp`; the port never calls it."""
    import torch

    E, n, c = x.shape
    dim = ji.shape[-1]
    G = torch.matmul(x.transpose(1, 2).reshape(E * c, n), Ball.T).reshape(E, c, dim + 1, -1)
    Ji_t = ji.reshape(-1, dim, dim).permute(1, 2, 0).contiguous()  # planes, as the dense path packs them
    T = _library_qp(A, G, Ji_t, w.reshape(-1))
    return torch.matmul(T.reshape(E * c, -1), Ball).reshape(E, c, n).transpose(1, 2)


def _qp_flops(EQ: int, dim: int, c: int, nnz: int, n_eq: int) -> int:
    """J^-T and J^-1 (dim^2 c FMAs each), r = A g and t = A^T r (nnz FMAs each), w r."""
    return EQ * (4 * dim * dim * c + 4 * nnz + n_eq)


def _sumfact_flops(E: int, n1: int, q1: int, dim: int, c: int, nnz: int, n_eq: int) -> int:
    """FMAs of the 1D sweeps over their table entries (both directions), plus the per-QP chain."""
    if dim == 3:
        fwd = 2 * n1 * n1 * q1 * c * n1 + 3 * n1 * q1 * q1 * c * n1 + 4 * q1**3 * c * n1
        bwd = 4 * n1 * q1 * q1 * c * q1 + 3 * n1 * n1 * q1 * c * q1 + 2 * n1**3 * c * q1
    else:
        fwd = 2 * n1 * q1 * c * n1 + 3 * q1 * q1 * c * n1
        bwd = 3 * n1 * q1 * c * q1 + 2 * n1 * n1 * c * q1
    return E * 2 * (fwd + bwd) + _qp_flops(E * q1**dim, dim, c, nnz, n_eq)


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _errs(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    scale = float(ref.abs().max())
    err = float((got.double() - ref).abs().max())
    return err, err / scale


def phase_kernels_unstructured(lp) -> list:
    """The per-QP kernel and the fused sum-factorized kernel against their
    plain versions at the cylinder's p = 4 shapes (f64 and f32), plus a small
    dim-2 case of each; returns their JSON records."""
    import torch

    from l3ster_tpu_torch.algsys.local import domain_tables
    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.ops.dense_eval import dense_basis_matrix
    from l3ster_tpu_torch.ops.qp import qp_algebra_const, qp_algebra_const_plain
    from l3ster_tpu_torch.ops import sumfact_fused
    from l3ster_tpu_torch.ops.sumfact_fused import sumfact_const_apply, sumfact_const_apply_plain

    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    A3 = _constant_kernel_operators(kd, 0.0)
    order, E, c = CYL_ORDER, 17456, 4  # the p = 4 cylinder: 17,456 hexes, 4 unknowns
    q_order = lp.AssemblyOptions().quadrature_order(order)
    n1, q1 = order + 1, q_order // 2 + 1
    records = []
    for dim in (3, 2):
        # dim 3: the main path's shapes; dim 2: a small case with 3 unknowns
        # and 4 equations, the shape of 2D diffusion
        rng = np.random.default_rng(dim)
        if dim == 3:
            A, Ed, cd = A3, E, c
        else:
            A = rng.normal(size=(3, 4, 3)) * (rng.uniform(size=(3, 4, 3)) > 0.4)
            Ed, cd = 500, 3
        Q = q1**dim
        host = {
            "G": rng.normal(size=(Ed, cd, dim + 1, Q)),
            "ji": rng.normal(size=(Ed, Q, dim, dim)) * 0.1 + np.eye(dim),
            "w": rng.uniform(0.5, 1.0, (Ed, Q)),
            "x": rng.normal(size=(Ed, n1**dim, cd)),
        }
        nnz, n_eq = int((A != 0).sum()), A.shape[1]
        for name in ("qp_algebra", "sumfact_fused"):
            out = {}
            for dt in (torch.float64, torch.float32):
                d = {k: torch.as_tensor(v, dtype=dt, device="cuda") for k, v in host.items()}
                Ji_t = d["ji"].reshape(-1, dim, dim).permute(1, 2, 0).contiguous()
                if name == "qp_algebra":
                    args = (A, d["G"], Ji_t, d["w"].reshape(-1))
                    kern = lambda a=args: qp_algebra_const(*a)  # noqa: E731
                    plain = lambda a=args: qp_algebra_const_plain(*a)  # noqa: E731
                    lib = lambda a=args: _library_qp(*a)  # noqa: E731
                else:
                    args = (A, d["ji"], d["w"], order, q_order, dim, d["x"])
                    Ball = torch.as_tensor(
                        dense_basis_matrix(domain_tables(lp.ElementType.HEX if dim == 3 else lp.ElementType.QUAD, order, q_order)),
                        dtype=dt, device="cuda",
                    )
                    kern = lambda a=args: sumfact_const_apply(*a)  # noqa: E731
                    plain = lambda a=args: sumfact_const_apply_plain(*a)  # noqa: E731
                    lib = lambda d=d, B=Ball: _library_sumfact(A, d["ji"], d["w"], B, d["x"])  # noqa: E731
                out[dt] = (kern(), kern, plain, lib, args)
            ref = out[torch.float64][2]()
            torch.cuda.synchronize()
            _, err64 = _errs(out[torch.float64][0], ref)
            abs32, err32 = _errs(out[torch.float32][0], ref)
            _, kern32, plain32, lib32, args32 = out[torch.float32]
            _, lib_err = _errs(lib32(), ref)
            del ref, out
            ok = err64 < F64_KERNEL_TOL and err32 < F32_KERNEL_TOL
            ms, plain_ms, library_ms = (_cuda_ms(f, queued=True) for f in (kern32, plain32, lib32))
            if name == "qp_algebra":
                G, Ji_t, w = args32[1:]
                nbytes = 4 * (2 * G.numel() + Ji_t.numel() + w.numel())
                flops = _qp_flops(w.numel(), dim, cd, nnz, n_eq)
                shape = list(G.shape)
                replaces, src = "l3ster_tpu/ops/pallas_qp.py:94", "l3ster_tpu_torch/csrc/qp_algebra.cu"
            else:
                ji, w, x = args32[1], args32[2], args32[6]
                nbytes = 4 * (2 * x.numel() + ji.numel() + w.numel() + 2 * q1 * n1)
                flops = _sumfact_flops(Ed, n1, q1, dim, cd, nnz, n_eq)
                shape = [Ed, n1**dim, cd, Q]
                replaces, src = "l3ster_tpu/ops/pallas_sumfact.py:195", "l3ster_tpu_torch/csrc/sumfact_fused.cu"
            bound_ms, bound_by = _bound(nbytes, flops)
            occ = None
            if name == "sumfact_fused":
                occ = sumfact_fused.kernel_occupancy(torch.float32, A, order, q_order, dim)
            _say(
                "kernel_vs_plain", kernel=name, dim=dim, shape=shape, f64_rel_err=err64,
                f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32, f32_tol=F32_KERNEL_TOL,
                library_rel_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, launch_shape=occ, ok=ok,
            )
            if not ok:
                raise SystemExit(f"chip_smoke: {name} kernel disagrees with its plain version (dim {dim})")
            if dim == 3:
                records.append(dict(
                    name=name, route="cuda", source=src, replaces=replaces, launches=None,
                    max_abs_err=abs32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=library_ms,
                ))
            torch.cuda.empty_cache()
    return records


def _profile_apply(fn, x, n: int = 10) -> tuple[float, dict]:
    """(device-busy ms per apply, the 8 costliest device kernels' ms per apply):
    the CUDA kernels' time summed by torch.profiler.  Also reports, in the
    second dict under "host", the 6 host-side operations with the most self
    CPU time per apply (CUDA runtime calls included; the closing device
    synchronize left out), with their calls per apply."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.key != "cudaDeviceSynchronize"]
    host_top = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:6]
    out = {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top}
    out["host"] = {f"{e.key[:40]} x{e.count // n}": e.self_cpu_time_total / 1e3 / n for e in host_top}
    return busy, out


def phase_unstructured_main_path(lp) -> dict:
    import torch

    from l3ster_tpu_torch.ops import qp, sumfact_fused

    t0 = time.perf_counter()
    mesh = _cylinder_mesh(lp, CYL_ORDER, small=False)
    mesh_s = time.perf_counter() - t0

    # independent checks, made before the main path's counts start: a small
    # f64 cylinder system on the card against the CPU path, and the f64
    # reference of the full-size apply
    small = _cylinder_mesh(lp, 2, small=True)
    sg = _build_cylinder(lp, small, "AUTO", torch.float64, "cuda")
    sc = _build_cylinder(lp, small, "AUTO", torch.float64, "cpu")
    xs = torch.as_tensor(np.random.default_rng(3).normal(size=(sc.n_dofs, 1)))
    ys = sc.operator()(xs)
    small_err = float((sg.operator()(xs.cuda()).cpu() - ys).abs().max() / ys.abs().max())
    del sg, sc
    sys64 = _build_cylinder(lp, mesh, "AUTO", torch.float64, "cuda")
    x64 = torch.as_tensor(np.random.default_rng(4).normal(size=(sys64.n_dofs, 1)), device="cuda")
    y64 = sys64.operator()(x64)
    del sys64
    torch.cuda.empty_cache()

    qp.launch_count = 0  # the unstructured main path (AUTO) starts here
    t0 = time.perf_counter()
    system = _build_cylinder(lp, mesh, "AUTO", torch.float32, "cuda")
    kinds = [d[0] for _, d in system._operators()[1]]
    fn = system.operator()
    x32 = x64.float()
    y32 = fn(x32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    qp_launches_first = qp.launch_count
    apply_err = float((y32.double() - y64).abs().max() / y64.abs().max())
    finite = bool(torch.isfinite(y32).all())
    apply_ms = _cuda_ms(lambda: fn(x32))
    busy_ms, top = _profile_apply(fn, x32)
    ok = (
        kinds == ["dense_const"] + ["direct"] * 4 and finite and apply_err < F32_APPLY_TOL
        and small_err < F64_APPLY_TOL and system.n_dofs == 4789376 and qp_launches_first > 0
    )
    _say(
        "unstructured_apply", mesh="make_cylinder_in_channel_3d()", order=CYL_ORDER,
        n_elements=int(mesh.domains[0][0].n_elements), n_dofs=system.n_dofs, kinds=kinds,
        dtype="float32", mesh_s=mesh_s, setup_s=setup_s, rel_err_vs_f64_on_card=apply_err,
        tol=F32_APPLY_TOL, small_f64_rel_err_vs_cpu=small_err, small_tol=F64_APPLY_TOL,
        finite=finite, apply_ms=apply_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / apply_ms, top_device_ms_per_apply=top,
        qp_launches_first_apply=qp_launches_first, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: unstructured apply failed its checks")

    sumfact_fused.launch_count = 0  # the SUM_FACT_PALLAS path starts here
    t0 = time.perf_counter()
    spal = _build_cylinder(lp, mesh, "SUM_FACT_PALLAS", torch.float32, "cuda")
    pkinds = [d[0] for _, d in spal._operators()[1]]
    fp = spal.operator()
    yp = fp(x32)
    torch.cuda.synchronize()
    psetup_s = time.perf_counter() - t0
    perr = float((yp.double() - y64).abs().max() / y64.abs().max())
    pms = _cuda_ms(lambda: fp(x32))
    pbusy_ms, ptop = _profile_apply(fp, x32)
    ok = pkinds == ["pallas"] + ["direct"] * 4 and bool(torch.isfinite(yp).all()) and perr < F32_APPLY_TOL
    _say(
        "unstructured_apply_sum_fact_pallas", kinds=pkinds, setup_s=psetup_s,
        rel_err_vs_f64_auto_on_card=perr, tol=F32_APPLY_TOL, apply_ms=pms,
        auto_apply_ms=apply_ms, device_busy_ms=pbusy_ms, device_idle_share=1.0 - pbusy_ms / pms,
        top_device_ms_per_apply=ptop, sumfact_launches=sumfact_fused.launch_count, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: SUM_FACT_PALLAS apply failed its checks")
    del spal, fp, yp, y64
    torch.cuda.empty_cache()
    return {"system": system, "mesh": mesh}


def phase_unstructured_solve(lp, state: dict) -> None:
    import torch

    from l3ster_tpu_torch.ops import qp

    system, mesh = state["system"], state["mesh"]
    before = qp.launch_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opts = lp.IterSolverOpts(tol=CYL_CG_TOL, max_iters=CYL_CG_MAX_ITERS)
    r = system.solve(lp.CG(opts, precond=lp.Jacobi()))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = qp.launch_count - before
    b = system.effective_rhs()
    true_res = float((b - system.operator()(system.x)).norm() / b.norm())
    X = system.x[:, 0].reshape(-1, 4).double().cpu().numpy()
    err_T = float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())
    err_q = float(max(np.abs(X[:, 1] - 1.0).max(), np.abs(X[:, 2:]).max()))
    _say(
        "unstructured_solve", solver="CG+Jacobi", dtype="float32", n_dofs=system.n_dofs,
        tol=CYL_CG_TOL, max_iters=CYL_CG_MAX_ITERS, iterations=r.num_iters,
        achieved_rel_residual=r.tol, true_rel_residual=true_res, converged=r.converged,
        solve_s=solve_s,
        ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1),
        max_nodal_err_T_minus_x=err_T, max_nodal_err_q_minus_1_0_0=err_q, qp_launches=launches,
    )
    if not r.converged:
        raise SystemExit("chip_smoke: cylinder CG + Jacobi did not reach its tolerance")


def main() -> int:
    import torch

    import l3ster_tpu_torch as lp
    from l3ster_tpu_torch.ops import qp, sumfact_fused, zsweep

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls (the default, stated)
    torch.backends.cudnn.allow_tf32 = False
    smi, kind = phase_environment()
    if "jax" in sys.modules or "l3ster_tpu" in sys.modules:
        raise SystemExit("chip_smoke: the port imported JAX or the JAX package")
    phase_build()
    record, var_record = phase_kernels(lp)
    v1_record = phase_kernels_v1(lp)
    stage_record = phase_kernels_stages(lp)
    records = phase_kernels_unstructured(lp)
    state = phase_main_path(lp)
    phase_solve(lp, state)
    record["launches"] = zsweep.launch_count  # lattice main path: phases 4 and 5
    launches = phase_switches(lp, state)  # phase 6
    v1_record["launches"] = launches["zsweep_v1"]
    stage_record["launches"] = launches["stage_matmul"]
    del state
    torch.cuda.empty_cache()
    state = phase_var_path(lp, 7, "var_apply")
    phase_solve(lp, state, "var_solve")
    var_record["launches"] = zsweep.launch_count  # the var path at the bench size
    del state
    torch.cuda.empty_cache()
    state = phase_var_path(lp, 13, "var_apply_12x12x12")
    phase_solve(lp, state, "var_solve_12x12x12")
    del state
    torch.cuda.empty_cache()
    state = phase_unstructured_main_path(lp)
    phase_unstructured_solve(lp, state)
    records[0]["launches"] = qp.launch_count  # unstructured main path: phases 8 and 9
    records[1]["launches"] = sumfact_fused.launch_count
    kernels = [record, var_record, v1_record, stage_record] + records
    for rec in kernels:
        if rec["launches"] <= 0:
            raise SystemExit(f"chip_smoke: the main path never launched the {rec['name']} kernel")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
