"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``l3ster_tpu_torch`` (never JAX, never ``l3ster_tpu``) through its
main path at the bench configuration: matrix-free 3D diffusion, 4 unknowns
and 7 equations, a p=6 cube of 6^3 hexes (202,612 dofs), value-only
adiabatic faces on sides 1-4 and Dirichlet T on sides 5-6, float32, the
operator taken as ``operator_parts(layout="lattice")``, then solved with
CG + Jacobi.  Phases, each reported on its own line:

1. environment (torch, CUDA, nvcc, the card and its power limit);
2. build of every kernel from the sources in the checkout;
3. each kernel against its plain torch version at the main path's shapes,
   f64 and f32, with CUDA-event times of kernel, plain version and a
   cuBLAS-matmul chain of the same function (``library_ms``);
4. the main path: the bench system's operator apply (f32) against the same
   system in f64 on the card, and a small system against the CPU path;
   apply time and GFLOP/s; the kernels' launch counts are reset before
   phase 4 and read after phase 5;
5. CG + Jacobi on the manufactured T = x problem at the bench size.

The second-to-last lines are the kernels' JSON record and the nvidia-smi
line; the last line is ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.  Run: ``python3 chip_smoke.py`` (one card);
``--profile`` adds a torch.profiler breakdown of one apply.
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
    from l3ster_tpu_torch.ops import zsweep

    t0 = time.perf_counter()
    path = zsweep.build_library()
    zsweep._library()
    ptxas = [ln.strip() for ln in zsweep.build_log.splitlines() if "registers" in ln or "spill" in ln]
    _say("build", kernel="zsweep", seconds=round(time.perf_counter() - t0, 3), library=path, ptxas=ptxas)


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


def main() -> int:
    import torch

    import l3ster_tpu_torch as lp
    from l3ster_tpu_torch.ops import zsweep

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls (the default, stated)
    torch.backends.cudnn.allow_tf32 = False
    smi, kind = phase_environment()
    if "jax" in sys.modules or "l3ster_tpu" in sys.modules:
        raise SystemExit("chip_smoke: the port imported JAX or the JAX package")
    phase_build()
    record = phase_kernels(lp)
    state = phase_main_path(lp, profile="--profile" in sys.argv)
    phase_solve(lp, state)
    record["launches"] = zsweep.launch_count  # main path: phases 4 and 5
    if record["launches"] <= 0:
        raise SystemExit("chip_smoke: the main path never launched the z-sweep kernel")
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps(
        {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
