"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``l3ster_tpu_torch`` (never JAX, never ``l3ster_tpu``) through its
two main paths, matrix-free 3D diffusion (4 unknowns, 7 equations, constant
coefficients, float32), each solved with CG + Jacobi:

* the lattice path at the bench configuration: a p=6 cube of 6^3 hexes
  (202,612 dofs), value-only adiabatic faces on sides 1-4 and Dirichlet T on
  sides 5-6, the operator taken as ``operator_parts(layout="lattice")``;
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
   f64 and f32, with CUDA-event times of kernel, plain version and a
   cuBLAS-matmul chain of the same function (``library_ms``);
4. the lattice main path: the bench system's operator apply (f32) against
   the same system in f64 on the card, and a small system against the CPU
   path; apply time and GFLOP/s;
5. CG + Jacobi on the manufactured T = x problem at the bench size;
6. the unstructured main path: the cylinder system's apply (f32, AUTO)
   against the same system in f64 on the card, a small cylinder system
   against the CPU path, apply time, device-busy time and idle share; the
   same system under SUM_FACT_PALLAS against the f64 apply, and its time;
7. CG + Jacobi on the cylinder problem.

Each kernel's launch count is set to 0 just before its main path (phase 4
for the z-sweep; phase 6 for the per-QP kernel, after its comparison systems
ran, and just before the SUM_FACT_PALLAS system for the fused one) and read
just after it (phases 5 and 7).  The second-to-last lines are
the kernels' JSON record and the nvidia-smi line; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Run: ``python3 chip_smoke.py`` (one card); ``--profile`` adds a
torch.profiler breakdown of one bench apply.
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


def _cuda_ms(fn, reps: int = 20, batch: int = 10, warm: int = 3) -> float:
    """Milliseconds per fn() call: the median over reps runs of one CUDA-event
    pair around ``batch`` back-to-back calls, after warm-up.  Back-to-back
    calls let the device run ahead of the host where the host is faster, so
    this is device time for device-bound calls and host time otherwise."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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


def _build_system(lp, order, n_1d, dtype, device):
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, n_1d)), order=order)
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    kn = lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4))
    system.set_dirichlet_bc_values([0.0], [5], [0])  # T = x: 0 on the left ...
    system.set_dirichlet_bc_values([1.0], [6], [0])  # ... and 1 on the right
    system.begin_assembly()
    system.assemble_problem(kd, [0])
    system.assemble_problem(kn, [1, 2, 3, 4])
    system.end_assembly()
    return mesh, system


def _library_zsweep(A, b, bdy, bdx, geom, NzT, DzT):
    """The z-sweep's function as cuBLAS matmuls and elementwise torch: the
    yardstick for ``library_ms``; the port never calls it."""
    import torch

    c, n1z, RQ = b.shape
    S = NzT.shape[1]
    TND = torch.cat([NzT, DzT], dim=1).T.contiguous()  # (2S, n1z)
    X = torch.stack([b, bdy, bdx])  # (3, c, n1z, RQ)
    Y = torch.matmul(TND, X)  # (3, c, 2S, RQ)
    v, dz, dy, dx = Y[0, :, :S], Y[0, :, S:], Y[1, :, :S], Y[2, :, :S]
    Am = torch.as_tensor(A, dtype=b.dtype, device=b.device)
    d1, n_eq, _ = Am.shape
    if geom[0] == "diag":
        _, jx, jy, jz, wyx, wz = geom
        g = torch.stack([v, jx * dx, jy * dy, jz * dz])
        w = wz * wyx
    else:
        _, ji, w = geom
        J = ji.reshape(3, 3, S, RQ)
        g = torch.cat([v[None], torch.einsum("jisq,jcsq->icsq", J, torch.stack([dx, dy, dz]))])
    M = Am.permute(1, 0, 2).reshape(n_eq, d1 * c)  # (n_eq, 4c)
    r = torch.matmul(M, g.reshape(d1 * c, S * RQ)) * w.reshape(1, S * RQ)
    t = torch.matmul(M.T, r).reshape(d1, c, S, RQ)
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
    from l3ster_tpu_torch.ops import _cuda, qp, sumfact_fused, zsweep

    names = ("zsweep", "qp_algebra", "sumfact_fused")
    t0 = time.perf_counter()
    paths = _cuda.build(*names)  # one nvcc per source, all at once
    zsweep._library()
    _cuda.load("qp_algebra", qp._declare)
    _cuda.load("sumfact_fused", sumfact_fused._declare)
    seconds = round(time.perf_counter() - t0, 3)
    for n in names:
        log = _cuda.build_logs.get(n, "")
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        _say("build", kernel=n, seconds=seconds, library=paths[n], ptxas=ptxas)


def phase_kernels(lp) -> dict:
    """Kernel vs plain at the bench shape; returns the kernel's JSON record."""
    import torch

    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables
    from l3ster_tpu_torch.ops.zsweep import fused_z_sweep, fused_z_sweep_plain, zsweep_tables

    order, ne, q_order = 6, 6, lp.AssemblyOptions().quadrature_order(6)
    q1 = q_order // 2 + 1
    S = R = Q = ne * q1
    RQ = R * Q
    c, n1z = 4, ne * order + 1
    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    A = _constant_kernel_operators(kd, 0.0)
    Ng, Dg = banded_tables(order, q_order, ne)
    rng = np.random.default_rng(0)
    host = {
        "b": rng.normal(size=(3, c, n1z, RQ)),
        "jx": rng.uniform(0.5, 1.5, (1, RQ)), "jy": rng.uniform(0.5, 1.5, (1, RQ)),
        "jz": rng.uniform(0.5, 1.5, (S, 1)), "wyx": rng.uniform(0.5, 1.0, (1, RQ)),
        "wz": rng.uniform(0.5, 1.0, (S, 1)),
        "ji": rng.normal(size=(9, S, RQ)) * 0.1 + np.eye(3).reshape(9, 1, 1),
        "w": rng.uniform(0.5, 1.0, (S, RQ)),
    }
    record = None
    for mode in ("diag", "full"):
        out = {}
        for dt in (torch.float64, torch.float32):
            dev = {k: torch.as_tensor(v, dtype=dt, device="cuda") for k, v in host.items()}
            b = [dev["b"][i] for i in range(3)]
            geom = (
                ("diag", dev["jx"], dev["jy"], dev["jz"], dev["wyx"], dev["wz"])
                if mode == "diag" else ("full", dev["ji"], dev["w"])
            )
            tabs = zsweep_tables(Ng.T, Dg.T, dt, "cuda")
            out[dt] = (b, geom, tabs, fused_z_sweep(A, *b, geom, tabs))
        b64, g64, t64, k64 = out[torch.float64]
        ref = fused_z_sweep_plain(A, *b64, g64, t64.NzT, t64.DzT)
        torch.cuda.synchronize()
        scale = max(float(r.abs().max()) for r in ref)
        err64 = max(float((k - r).abs().max()) for k, r in zip(k64, ref)) / scale
        b32, g32, t32, k32 = out[torch.float32]
        abs32 = max(float((k.double() - r).abs().max()) for k, r in zip(k32, ref))
        err32 = abs32 / scale
        ok = err64 < F64_KERNEL_TOL and err32 < F32_KERNEL_TOL
        ms = _cuda_ms(lambda: fused_z_sweep(A, *b32, g32, t32))
        plain_ms = _cuda_ms(lambda: fused_z_sweep_plain(A, *b32, g32, t32.NzT, t32.DzT))
        lib = _library_zsweep(A, *b32, g32, t32.NzT, t32.DzT)
        lib_err = max(float((x.double() - r).abs().max()) for x, r in zip(lib, ref)) / scale
        library_ms = _cuda_ms(lambda: _library_zsweep(A, *b32, g32, t32.NzT, t32.DzT))
        # least work the function needs on these inputs: each input read once,
        # each output written once; the arithmetic of the nonzero table band
        band = t32.band.cpu().numpy()
        zlo, zhi, slo, shi = np.split(band, [S, 2 * S, 2 * S + n1z])
        nnz = int((A != 0).sum())
        geo_flops_per_u = 6 if mode == "diag" else 30
        flops = (
            8 * c * RQ * int((zhi - zlo + 1).sum())  # z interpolation: 4 FMAs per band entry
            + 8 * c * RQ * int((shi - slo + 1).sum())  # z transpose: 4 FMAs per band entry
            + S * RQ * (4 * nnz + 7 + 1 + geo_flops_per_u * c)  # per-QP algebra
        )
        geo = sum(x.numel() for x in g32[1:])
        nbytes = 4 * (6 * c * n1z * RQ + geo + 2 * n1z * S) + 4 * band.size
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
        _say(
            "kernel_vs_plain", kernel="zsweep", mode=mode, shape=[c, n1z, S, RQ],
            f64_rel_err=err64, f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32,
            f32_tol=F32_KERNEL_TOL, library_rel_err=lib_err, ms=ms, plain_ms=plain_ms,
            library_ms=library_ms, bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations", ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: z-sweep kernel disagrees with its plain version ({mode})")
        if mode == "diag":  # the main path's mode
            record = dict(
                name="zsweep", route="cuda", source="l3ster_tpu_torch/csrc/zsweep.cu",
                replaces="l3ster_tpu/ops/pallas_zsweep2.py:402", launches=None,
                max_abs_err=abs32, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms,
            )
    return record


def phase_main_path(lp, profile: bool) -> dict:
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
    q1 = lp.AssemblyOptions().quadrature_order(6) // 2 + 1
    flops = _flops_per_apply(6, 6**3, 4, 7, q1)
    ok = finite and apply_err < F32_APPLY_TOL and small_err < F64_APPLY_TOL and launches_first > 0
    _say(
        "main_path_apply", n_dofs=system.n_dofs, layout="lattice", dtype="float32",
        setup_s=setup_s, zsweep_launches_first_apply=launches_first,
        rel_err_vs_f64_on_card=apply_err, tol=F32_APPLY_TOL, small_f64_rel_err_vs_cpu=small_err,
        small_tol=F64_APPLY_TOL, shape=list(y32.shape), finite=finite, apply_ms=apply_ms,
        gflops=flops / (apply_ms * 1e-3) / 1e9, flops_per_apply=flops, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: main-path apply failed its checks")
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        n = 10
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(xl, *consts)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        events = prof.key_averages()
        print(events.table(sort_by="self_cuda_time_total", row_limit=15), flush=True)
        # device kernels only: the aten:: rows carry their kernels' time again
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        _say(
            "apply_profile", applies=n, wall_ms_per_apply_profiled=wall_ms,
            device_busy_ms_per_apply=device_ms, apply_ms=apply_ms,
            device_idle_share=1.0 - device_ms / apply_ms,
            top_device_ms_per_apply={e.key[:60]: e.self_device_time_total / 1e3 / n for e in top},
        )
    return {"system": system, "mesh": mesh}


def phase_solve(lp, state: dict) -> None:
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
        "solve", solver="CG+Jacobi", dtype="float32", tol=CG_TOL, max_iters=CG_MAX_ITERS,
        iterations=r.num_iters, achieved_rel_residual=r.tol, converged=r.converged,
        solve_s=solve_s, ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1),
        max_nodal_err_T_minus_x=err_T, max_nodal_err_q_minus_1_0_0=err_q,
        zsweep_launches=zsweep.launch_count - before,
    )
    if not r.converged:
        raise SystemExit("chip_smoke: CG + Jacobi did not reach its tolerance")


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
            ms, plain_ms, library_ms = _cuda_ms(kern32), _cuda_ms(plain32), _cuda_ms(lib32)
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
            _say(
                "kernel_vs_plain", kernel=name, dim=dim, shape=shape, f64_rel_err=err64,
                f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32, f32_tol=F32_KERNEL_TOL,
                library_rel_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by, ok=ok,
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
    the CUDA kernels' time summed by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    return busy, {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top}


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
    record = phase_kernels(lp)
    records = phase_kernels_unstructured(lp)
    state = phase_main_path(lp, profile="--profile" in sys.argv)
    phase_solve(lp, state)
    record["launches"] = zsweep.launch_count  # lattice main path: phases 4 and 5
    del state
    torch.cuda.empty_cache()
    state = phase_unstructured_main_path(lp)
    phase_unstructured_solve(lp, state)
    records[0]["launches"] = qp.launch_count  # unstructured main path: phases 6 and 7
    records[1]["launches"] = sumfact_fused.launch_count
    for rec in [record] + records:
        if rec["launches"] <= 0:
            raise SystemExit(f"chip_smoke: the main path never launched the {rec['name']} kernel")
    print(json.dumps({"kernels": [record] + records}))
    print(smi)
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
