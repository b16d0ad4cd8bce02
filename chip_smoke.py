"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``l3ster_tpu_torch`` (never JAX, never ``l3ster_tpu``) through its
main paths: matrix-free 3D diffusion (4 unknowns, 7 equations, float32),
each solved with CG + Jacobi, the lattice ones also with CG + LowOrderMG,
and the unsteady 2D Karman vortex street:

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
* the assembled path: local LSFEM assembly (``local_system``) at the
  reference bench suite's configuration (p = 4, 4^3 hexes), and an
  ``AssembledSystem`` of the bench kernel at p = 4 on 6^3 hexes;
* the reference's own benchmark (``BASELINE.md``): the bench problem
  assembled with ELEMENT_BOUNDARY static condensation at p = 6 on 6^3
  hexes (94,612 of the 202,612 dofs remain), solved with CG + Jacobi,
  BlockJacobi and Chebyshev, its interiors recovered; and the
  preconditioner family (Richardson, Jacobi with sweeps, Chebyshev,
  BlockJacobi, SGS, ILU0 under CG; Jacobi, ILU0, ILUT under GMRES) on the
  condensed system at p = 4 on 3^3 hexes, with its level-scheduled
  triangular solves (plain torch: no CUDA kernel of the port lies on
  these two paths);
* the unstructured path on the cylinder-in-channel mesh at its default size
  (``make_cylinder_in_channel_3d()``, 17,456 hexes) at p = 4 (4,789,376
  dofs): Dirichlet T = x from a boundary residual kernel on the inlet (3),
  the outlet (4) and the cylinder (5), value-only adiabatic walls (1, 2) and
  caps (6, 7).  AUTO takes the dense apply (``dense_const``, the per-QP
  kernel between two matmuls) with direct boundary contributions;
  ``SUM_FACT_PALLAS`` takes the fused sum-factorized kernel;
* the Karman 2D transient stack at the reference's Strouhal validation
  size (``examples/karman_2d.py:strouhal_study(refine=2, mesh_order=3)``,
  80,880 dofs): Navier-Stokes in velocity-vorticity-pressure form reading
  the previous velocities as fields, matrix-free (the field-coupled
  ``dense`` kind and ``direct`` boundaries, plain torch: no CUDA kernel of
  the port lies on this path), Picard then BDF2 with CG + PMultigrid;
* the 2D lattice path: the reference's Diffusion2D problem (T, qx, qy; T = x
  on left/right, adiabatic top/bottom) at p = 6 on 128^2 quads (1,774,083
  dofs): ``lattice_sf_const``, the non-fused chain, plain and with the
  per-QP kernel on the lattice layout (``L3STER_TPU_LATTICE_PALLAS_QP=1``),
  solved with CG + LowOrderMG and CG + Jacobi; and the bench system without
  the fused z-sweep (``L3STER_TPU_FUSED_Z=0``), plain and with that kernel;
* periodic conditions and IO: ``examples/advection_periodic.py`` refined to
  256 x 128 quads at p = 4 (525,312 dofs after aliasing), its final field
  exported to VTK and checkpointed; a Gmsh 4.1 file of a 64^2 quad square
  read, promoted to p = 4 and solved; the source identification of
  ``examples/inverse_diffusion_2d.py`` at 49,923 dofs through the
  differentiable ``linear_solve``.

Phases, each reported on its own line:

1. environment (torch, CUDA, nvcc, the card and its power limit);
2. build of every kernel from the sources in the checkout, one nvcc each,
   all started together;
3. each kernel against its plain torch version at its main path's shapes,
   f64 and f32, with CUDA-event times on the card (host enqueueing hidden
   behind a sleep kernel) of kernel, plain version and a cuBLAS-matmul chain
   of the same function (``library_ms``): the z-sweep const (diag, full) and
   var (full, diag, K = 15 planes) at the bench shapes, its ``"zc"`` layout,
   var+full at the 12^3 shapes, const+diag and var+full at the shapes of
   the multigrid's order-1 levels, the v1 wrapper, the stage kernel in the six
   stage shapes of an x/y-pipeline apply (single and K-concat forms, each
   with its band descriptor built before the timed calls) and their sums, the
   fused sum-factorized kernel at the cylinder's shapes, then the per-QP
   kernel at every shape of its paths (the dense layout of the cylinder and
   of the periodic cell, the lattice rows of the 2D cell and of the bench
   under ``L3STER_TPU_FUSED_Z=0``) with a torch copy of the same bytes beside
   it, and the node-row gather and scatter-add on the cylinder's own row
   indices in both layouts (the gather bit for bit, the scatter to
   rounding), each with a copy of the same bytes; the redesigned kernels' lines carry their launch shape and resident
   blocks per SM, and the build phase each kernel's registers and spills;
4. the lattice main path: the bench system's operator apply (f32) against
   the same system in f64 on the card, and a small system against the CPU
   path; apply time, GFLOP/s, device-busy time and idle share;
5. CG + Jacobi on the manufactured T = x problem at the bench size, then
   CG + LowOrderMG on it (``mg_solve``): cold and warm solves, the setup's
   split, one V-cycle's time and idle share, the true residual, B1
   launches by multigrid level; it must take fewer iterations than Jacobi;
6. the bench system under each opt-in pipeline: its apply against the
   default one, its time, device-busy time and kernel launches;
7. the variable-coefficient path at the bench size and at 12^3 hexes: f32
   apply against the f64 system on the card (and, at the bench size, a small
   f64 system against the CPU path), apply time, device-busy time, idle
   share and the costliest kernels, then CG + Jacobi with its nodal errors,
   and at 12^3 CG + LowOrderMG as in phase 5 (``var_mg_solve_12x12x12``);
7b. the assembly rate (element assemblies/s at QO = 2p and 4p - 2, K
   symmetric and against f64) and the assembled system (build time by part,
   nnz, SpMV beside the gather form, apply against the matrix-free one, CG
   + Jacobi beside the matrix-free solve's iterations);
7c. ``condensed``: a p = 3 condensed system in f64 on the card against the
   CPU, condensed against uncondensed in f64 at p = 4 on 4^3 hexes (the
   same nodal solution), then the p = 6 condensed bench system in f32: n_dofs,
   nnz, the build split (host sparsity, local K, host scatter positions and
   their LRU hits, the Kbb scatter, Schur factors, Schur scatter), peak
   device memory and host RSS, the SpMV
   against its byte bound, CG + Jacobi, BlockJacobi and Chebyshev (setup and
   solve s, true residual), the interior recovery and the max nodal errors
   over all nodes after the Jacobi solve and after CG + Chebyshev continued
   to 1e-8, and against the matrix-free bench solution (CG + LowOrderMG);
7d. ``preconditioners``: each solver of the family on the p = 4 condensed
   system from zero (iterations, setup split into host factorization, level
   analysis and upload, solve s, true residual, triangular solves' levels,
   ms and launches per apply; CG and GMRES + ILU0 capped at a twelfth of
   their Jacobi counts and not required to converge: ILU(0) has negative
   pivots here), then the reference's bar as its test runs it; the host
   helper (``csrc/hostops.cpp``) must have built;
8. the unstructured main path: the cylinder system's apply (f32, AUTO)
   against the same system in f64 on the card, a small cylinder system
   against the CPU path, apply time, device-busy time and idle share, and
   one channel-major row gather and scatter launch in its first apply; the
   same system under SUM_FACT_PALLAS against the f64 apply, its time and
   its node-major row launches;
9. CG + Jacobi on the cylinder problem;
10. ``karman``: 8 Picard solves (CG + a PMultigrid(lag="auto") of their
   own; each with its true residual beside CG's), 3 settling and 10 timed
   BDF2 steps with CG + PMultigrid(lag="auto") from the predictor start:
   s/step, iterations, refreshes and one refresh's split (coarse Q1
   assembly, host f64 inverse, power iteration, upload), one V-cycle's time
   and idle share, the true residual beside CG's, the flow rates; one step
   also with CG + Jacobi (PMultigrid must take at most a quarter of its
   iterations), and the first step again in f64 (f32 within
   KARMAN_F32_TOL of it);
11. ``bench_nonfused`` (after phase 6): the bench under ``L3STER_TPU_FUSED_Z=0``,
   plain and with the per-QP kernel, against the fused apply, with z-sweep
   and per-QP launches counted apart;
12. ``lattice_2d``: the 2D cell's f32 apply against f64 on the card and a
   small f64 system against the CPU, apply time, device-busy time, idle
   share, top kernels; the same system with the per-QP kernel (its
   launches) against the default; CG + LowOrderMG and CG + Jacobi to 1e-6
   (MG in fewer iterations), nodal |T - x| and true residuals;
13. ``periodic``: one period of 40 BDF3 steps in f32 under the example's
   5% L2 error, s/step and iterations; the example's size in f64 on the
   card against the CPU; VTK export parsed back and a save/load round trip;
14. ``gmsh`` (nodal |T - x| < 1e-3) and ``inverse`` (the gradient against
   central differences, theta recovered by ``torch.optim.LBFGS``).
15. distribution, all shards on the one card: ``box`` (after phase 5: the
   bench through ``box_parallelize`` at 2 and 4 z slabs and a (2, 2) pencil
   grid; the apply against the single one, busy and exchange times, one
   z-sweep launch a shard, CG + Jacobi and CG + the box LowOrderMG against
   the single system's counts; the z-sweep is also checked at the windows'
   shapes in phase 3), ``distributed`` and ``restart`` (after phase 9: the
   cylinder on 4 shards, its apply against the single one, CG + Jacobi, the
   sharded ``.pvtu``; its checkpoint reloaded on 2 shards, bit for bit),
   ``distributed_assembled`` (the preconditioners phase's problem on 4
   shards: the gathered CSR against the single one, Schwarz SGS and ILUT,
   BlockJacobi, Klu2) and ``karman_distributed`` (after phase 10: its
   first three BDF2 steps on 4 shards, against the single system's);
16. ``multi_device``: shards placed with ``devices=`` on the cards (the
   first min(D, 4) of D >= 2 cards, else two placement groups on the one
   card; the phase prints how many distinct cards it used):
   ``multi_device_box`` (after ``box``: the bench at 2 z slabs, its apply
   against the one-group box's, apply ms, busy ms per card, the plane
   exchanges' ms beside the one group's, CG + box LowOrderMG within
   BOX_MG_SLACK of the one group's count) and ``multi_device_distributed``
   (after ``distributed``: its cylinder on 4 shards, B2 held against its
   plain version at each group's shape on its card, the apply against the
   one-group system's, apply ms, busy ms per card, the halo exchange's ms
   with the cross-group copies, CG + Jacobi within DIST_CG_SLACK of the one
   group's count); each fails unless its kernel (B1, B2) launched on every
   group's card.

Each kernel's launch count is set to 0 just before the path it is counted
on and read just after it: the z-sweep's const mode on phases 4-5 and then
on the bench's multigrid solve, its var mode on the bench-size phase 7 and
then on the 12^3 multigrid solve (each row sums its two paths), the v1
wrapper and the stage kernel on their
phase 6 systems, the per-QP kernel on phases 8-9 (after its comparison
systems ran), the fused one on the SUM_FACT_PALLAS system, the row gather
and scatter on phases 8-9 in both layouts (from the same point); the per-QP
kernel's lattice layout on phase 11's and phase 12's systems with the
kernel switched on (one record each), its dense layout also on phase 13's
period (a record of its own); the z-sweep's const row also counts
the ``box`` and ``multi_device_box`` phases, the per-QP kernel's the
``distributed`` and ``multi_device_distributed`` phases.  The
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


def _build_system(lp, order, n_1d, dtype, device, kernel=_diffusion_3d, assembled=False, hook=None, cond=False,
                  n_shards=0):
    """The bench configuration on an order-``order`` cube of (n_1d - 1)^3 hexes,
    matrix-free or ``assembled`` (``cond``: assembled with ELEMENT_BOUNDARY
    condensation), on ``n_shards`` shards of a DistributedSystem when given;
    ``hook(system)`` runs before the assembly.
    The constant kernel takes T = 0 and T = 1 on sides 5 and 6; the variable
    one T = x from a boundary kernel (the same values on the unit cube)."""
    mesh = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, n_1d)), order=order)
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([5, 6], [0])
    S, C = lp.OperatorEvaluationStrategy, lp.CondensationPolicy
    params = lp.AlgebraicSystemParams(
        eval_strategy=S.GLOBAL_ASSEMBLY if assembled or cond else S.MATRIX_FREE,
        cond_policy=C.ELEMENT_BOUNDARY if cond else C.NONE,
    )
    if n_shards:
        system = lp.make_distributed_system(mesh, problem, bcs, params, n_shards=n_shards, dtype=dtype, device=device)
    else:
        system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    if hook is not None:
        hook(system)
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
    from l3ster_tpu_torch.ops import _cuda, qp, rows, stages, sumfact_fused, zsweep

    names = ("zsweep", "qp_algebra", "sumfact_fused", "stage_matmul", "row_gather")
    t0 = time.perf_counter()
    paths = _cuda.build(*names)  # one nvcc per source, all at once
    zsweep._library()
    stages._library()
    rows._library()
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


def _bench_kernel_inputs(lp, seed: int, ne: int = 6, order: int = 6, ne_y: int | None = None):
    """Shapes of the z-sweep on a lattice of ne^3 elements of the given order
    (p = 6: 6^3 the bench, 12^3 the var 12^3 box; p = 1: the multigrid's
    order-1 levels), or of ne (z) x ne_y (y) x 6 (x) elements (a box
    decomposition's window of the bench), and random inputs: the constant A
    of the bench kernel, the nonzero planes of its variable form and both
    geometries, made with numpy from a seed."""
    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.ops.lattice_sumfact import banded_tables

    q_order = lp.AssemblyOptions().quadrature_order(order)
    q1 = q_order // 2 + 1
    ny, nx = (ne, ne) if ne_y is None else (ne_y, 6)
    S, RQ = ne * q1, ny * q1 * nx * q1
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
    for var, mode, layout, ne, order, ne_y in (
        (False, "diag", "cz", 6, 6, None), (False, "full", "cz", 6, 6, None), (True, "full", "cz", 6, 6, None),
        (True, "diag", "cz", 6, 6, None), (True, "full", "zc", 6, 6, None),
        (True, "full", "cz", 12, 6, None),  # the var 12^3 apply's shapes
        # the multigrid's order-1 levels: the bench's level 1 (19^3 nodes) and
        # the var 12^3 box's level 1 (37^3 nodes)
        (False, "diag", "cz", 18, 1, None), (True, "full", "cz", 36, 1, None),
        # the box phase's windows of the bench: 2 and 4 z slabs (3 and 2
        # element layers), and the (2, 2) pencils' 3 x 3 columns
        (False, "diag", "cz", 3, 6, 6), (False, "diag", "cz", 2, 6, 6), (False, "diag", "cz", 3, 6, 3),
    ):
        inp = _bench_kernel_inputs(lp, seed=0, ne=ne, order=order, ne_y=ne_y)
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
            "kernel_vs_plain", kernel=name, mode=mode, layout=layout, planes=K, ne_z=ne, ne_y=ne_y or ne, order=order,
            shape=[inp["c"], inp["n1z"], inp["S"], inp["RQ"]], f64_tol=F64_KERNEL_TOL,
            f32_tol=F32_KERNEL_TOL, bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / res["ms"], launch_shape=occ, **res,
        )
        if not res["ok"]:
            raise SystemExit(
                f"chip_smoke: {name} disagrees with its plain version ({mode} {layout} ne_z={ne} ne_y={ne_y} p={order})"
            )
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


def phase_solve(lp, state: dict, phase: str = "solve") -> int:
    import torch

    from l3ster_tpu_torch.ops import zsweep

    system, mesh = state["system"], state["mesh"]
    before = zsweep.launch_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = system.solve(lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=lp.Jacobi()))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    b = system.effective_rhs()
    true_res = float((b - system.operator()(system.x)).norm() / b.norm())
    X = system.x[:, 0].reshape(-1, 4).double().cpu().numpy()
    err_T = float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())
    err_q = float(max(np.abs(X[:, 1] - 1.0).max(), np.abs(X[:, 2:]).max()))
    _say(
        phase, n_dofs=system.n_dofs, solver="CG+Jacobi", dtype="float32", tol=CG_TOL, max_iters=CG_MAX_ITERS,
        iterations=r.num_iters, achieved_rel_residual=r.tol, true_rel_residual=true_res,
        converged=r.converged, solve_s=solve_s, ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1),
        max_nodal_err_T_minus_x=err_T, max_nodal_err_q_minus_1_0_0=err_q,
        zsweep_launches=zsweep.launch_count - before,
    )
    if not r.converged:
        raise SystemExit(f"chip_smoke: CG + Jacobi did not reach its tolerance ({phase})")
    return r.num_iters


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


def _build_cylinder(lp, mesh, strategy, dtype, device, n_shards=0, devices=None):
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4, 5], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    if n_shards:
        system = lp.make_distributed_system(
            mesh, problem, bcs, params, n_shards=n_shards, dtype=dtype, device=None if devices else device,
            devices=devices,
        )
    else:
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
    """The per-QP chain on the (E, c, d1, Q) layout: :func:`_library_qp_lattice`
    on the reference's (d1*c, EQ) layout between two permutes.  The yardstick
    for ``library_ms``; the port never calls it."""
    E, c, d1, Q = G.shape
    g = G.permute(2, 1, 0, 3).reshape(d1 * c, E * Q)
    T = _library_qp_lattice(A, g, Ji_t.reshape(-1, E * Q), w)
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


def phase_kernels_unstructured(lp) -> dict:
    """The fused sum-factorized kernel against its plain version at the
    cylinder's p = 4 shapes (f64 and f32), plus a small dim-2 case; returns
    its JSON record."""
    import torch

    from l3ster_tpu_torch.algsys.local import domain_tables
    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.ops.dense_eval import dense_basis_matrix
    from l3ster_tpu_torch.ops import sumfact_fused
    from l3ster_tpu_torch.ops.sumfact_fused import sumfact_const_apply, sumfact_const_apply_plain

    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    A3 = _constant_kernel_operators(kd, 0.0)
    order, E, c = CYL_ORDER, 17456, 4  # the p = 4 cylinder: 17,456 hexes, 4 unknowns
    q_order = lp.AssemblyOptions().quadrature_order(order)
    n1, q1 = order + 1, q_order // 2 + 1
    record = None
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
            "ji": rng.normal(size=(Ed, Q, dim, dim)) * 0.1 + np.eye(dim),
            "w": rng.uniform(0.5, 1.0, (Ed, Q)),
            "x": rng.normal(size=(Ed, n1**dim, cd)),
        }
        nnz, n_eq = int((A != 0).sum()), A.shape[1]
        out = {}
        for dt in (torch.float64, torch.float32):
            d = {k: torch.as_tensor(v, dtype=dt, device="cuda") for k, v in host.items()}
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
        ji, w, x = args32[1], args32[2], args32[6]
        nbytes = 4 * (2 * x.numel() + ji.numel() + w.numel() + 2 * q1 * n1)
        bound_ms, bound_by = _bound(nbytes, _sumfact_flops(Ed, n1, q1, dim, cd, nnz, n_eq))
        _say(
            "kernel_vs_plain", kernel="sumfact_fused", dim=dim, shape=[Ed, n1**dim, cd, Q], f64_rel_err=err64,
            f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32, f32_tol=F32_KERNEL_TOL,
            library_rel_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bytes=nbytes, flops=_sumfact_flops(Ed, n1, q1, dim, cd, nnz, n_eq), bound_ms=bound_ms,
            bound_by=bound_by, share_of_bound=bound_ms / ms,
            launch_shape=sumfact_fused.kernel_occupancy(torch.float32, A, order, q_order, dim), ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: sumfact_fused kernel disagrees with its plain version (dim {dim})")
        if dim == 3:
            record = dict(
                name="sumfact_fused", route="cuda", source="l3ster_tpu_torch/csrc/sumfact_fused.cu",
                replaces="l3ster_tpu/ops/pallas_sumfact.py:195", launches=None, max_abs_err=abs32, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            )
        torch.cuda.empty_cache()
    return record


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

    from l3ster_tpu_torch.ops import qp, rows, sumfact_fused

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
    rows.launch_count.clear()
    t0 = time.perf_counter()
    system = _build_cylinder(lp, mesh, "AUTO", torch.float32, "cuda")
    kinds = [d[0] for _, d in system._operators()[1]]
    fn = system.operator()
    x32 = x64.float()
    rows_before = dict(rows.launch_count)
    y32 = fn(x32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    qp_launches_first = qp.launch_count
    row_launches_first = {f"{op}/{layout}": v - rows_before.get((op, layout), 0)
                          for (op, layout), v in sorted(rows.launch_count.items())}
    apply_err = float((y32.double() - y64).abs().max() / y64.abs().max())
    finite = bool(torch.isfinite(y32).all())
    apply_ms = _cuda_ms(lambda: fn(x32))
    busy_ms, top = _profile_apply(fn, x32)
    ok = (
        kinds == ["dense_const"] + ["direct"] * 4 and finite and apply_err < F32_APPLY_TOL
        and small_err < F64_APPLY_TOL and system.n_dofs == 4789376 and qp_launches_first > 0
        and row_launches_first == {"gather/channel_major": 1, "scatter/channel_major": 1}
    )
    _say(
        "unstructured_apply", mesh="make_cylinder_in_channel_3d()", order=CYL_ORDER,
        n_elements=int(mesh.domains[0][0].n_elements), n_dofs=system.n_dofs, kinds=kinds,
        dtype="float32", mesh_s=mesh_s, setup_s=setup_s, rel_err_vs_f64_on_card=apply_err,
        tol=F32_APPLY_TOL, small_f64_rel_err_vs_cpu=small_err, small_tol=F64_APPLY_TOL,
        finite=finite, apply_ms=apply_ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / apply_ms, top_device_ms_per_apply=top,
        qp_launches_first_apply=qp_launches_first, row_launches_first_apply=row_launches_first, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: unstructured apply failed its checks")

    sumfact_fused.launch_count = 0  # the SUM_FACT_PALLAS path starts here
    node_major_before = sum(v for (_, layout), v in rows.launch_count.items() if layout == "node_major")
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
    node_major = sum(v for (_, layout), v in rows.launch_count.items() if layout == "node_major") - node_major_before
    ok = (
        pkinds == ["pallas"] + ["direct"] * 4 and bool(torch.isfinite(yp).all()) and perr < F32_APPLY_TOL
        and node_major > 0
    )
    _say(
        "unstructured_apply_sum_fact_pallas", kinds=pkinds, setup_s=psetup_s,
        rel_err_vs_f64_auto_on_card=perr, tol=F32_APPLY_TOL, apply_ms=pms,
        auto_apply_ms=apply_ms, device_busy_ms=pbusy_ms, device_idle_share=1.0 - pbusy_ms / pms,
        top_device_ms_per_apply=ptop, sumfact_launches=sumfact_fused.launch_count,
        node_major_row_launches=node_major, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: SUM_FACT_PALLAS apply failed its checks")
    del spal, fp, yp, y64
    torch.cuda.empty_cache()
    return {"system": system, "mesh": mesh}


def phase_unstructured_solve(lp, state: dict) -> int:
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
    return r.num_iters

# ----------------------------------------------------- assembled system and multigrid

F32_ASM_TOL = 1e-5  # f32 local K vs f64 K, and K's asymmetry, relative to max |K|
ASM_ORDER, ASM_N1D = 4, 7  # the assembled phase: p = 4 on 6^3 hexes


def _synced_timer(fn, timers: dict, key: str, after=None):
    """fn wrapped to add its wall seconds, between device synchronizes, to
    timers[key]; ``after(result)`` sees each result."""
    import torch

    def wrapped(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        timers[key] = timers.get(key, 0.0) + time.perf_counter() - t0
        if after is not None:
            after(out)
        return out

    return wrapped


def phase_assembly_rate(lp, device: str = "cuda", n_1d: int = 5) -> None:
    """Element assemblies per second of ``local_system`` (geometry, kernel and
    local K, F) at the configuration of ``benchmarks/bench_suite.py:127-178``
    (p = 4, 4^3 hexes, QO = 2p = 8, f32, ``qp_chunk=128``) and at the
    framework's default QO = 4p - 2 = 14: CUDA-event times of back-to-back
    calls, median of 20; K is checked symmetric and against the f64 K."""
    import torch

    from l3ster_tpu_torch.algsys.local import domain_tables, element_geometry, local_system

    order = 4
    blk = lp.generate_mesh(lp.make_cube_mesh(np.linspace(0.0, 1.0, n_1d)), order=order).domains[0][0]
    kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
    for qo_name, opts in (
        ("2p", lp.AssemblyOptions(value_order=1, derivative_order=0)), ("4p-2 (default)", lp.AssemblyOptions()),
    ):
        qo = opts.quadrature_order(order)
        tab = domain_tables(blk.element_type, order, qo)

        def assemble(verts, tab=tab):
            return local_system(kd, tab, element_geometry(tab, verts), qp_chunk=128)

        v32 = torch.as_tensor(blk.vertices, dtype=torch.float32, device=device)
        K32, F32 = assemble(v32)
        K64, _ = assemble(v32.double())
        scale = float(K64.abs().max())
        asym = float((K32 - K32.transpose(1, 2)).abs().max()) / scale
        err = float((K32.double() - K64).abs().max()) / scale
        finite = bool(torch.isfinite(K32).all() and torch.isfinite(F32).all())
        ms = _cuda_ms(lambda: assemble(v32))
        busy_ms, top = _profile_apply(assemble, v32)
        ok = finite and asym < F32_ASM_TOL and err < F32_ASM_TOL
        _say(
            "assembly_rate", order=order, n_elements=blk.n_elements, quadrature_order=qo, qo_rule=qo_name,
            n_qp=tab.n_qp, qp_chunk=128, dtype="float32", K_shape=list(K32.shape), ms=ms,
            elements_per_s=blk.n_elements / (ms * 1e-3), device_busy_ms=busy_ms,
            device_idle_share=1.0 - busy_ms / ms, top_device_ms_per_call=top,
            K_asymmetry_rel=asym, f32_vs_f64_K_rel_err=err, tol=F32_ASM_TOL, finite=finite, ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: local assembly failed its checks (QO = {qo})")
        del K32, F32, K64
        torch.cuda.empty_cache()


def _spmv_gather(x, data, cols, rows, n: int):
    """The reference's SpMV form (gather, multiply, ``index_add_`` by row): the
    other form beside the port's CSR product; the port never calls it."""
    import torch

    return torch.zeros((n, x.shape[1]), dtype=x.dtype, device=x.device).index_add_(0, rows, data[:, None] * x[cols])


def phase_assembled(lp, device: str = "cuda", order: int = ASM_ORDER, n_1d: int = ASM_N1D) -> None:
    """An AssembledSystem for the bench kernel at p = 4 on 6^3 hexes (f32 on
    the card): its build time split into host sparsity, local assembly,
    host scatter positions and the scatter; nnz; the SpMV (the CSR product)
    beside the gather form; its apply against the matrix-free apply of the
    same problem (f64 and f32); CG + Jacobi beside the matrix-free solve."""
    import torch

    rng = np.random.default_rng(21)
    _, mf64 = _build_system(lp, order, n_1d, torch.float64, device)
    x64 = torch.as_tensor(rng.normal(size=(mf64.n_dofs, 1)), device=device)
    y_mf = mf64.operator()(x64)
    del mf64
    _, as64 = _build_system(lp, order, n_1d, torch.float64, device, assembled=True)
    err64 = float((as64.operator()(x64) - y_mf).abs().max() / y_mf.abs().max())
    del as64
    torch.cuda.empty_cache()

    timers: dict = {}
    cls = lp.AssembledSystem
    orig_sparsity = cls._build_sparsity
    cls._build_sparsity = _synced_timer(orig_sparsity, timers, "host_sparsity_s")

    def hook(system):
        timers["constructed_at"] = time.perf_counter()
        system._local_kf = _synced_timer(system._local_kf, timers, "local_assembly_s")
        system._scatter_positions = _synced_timer(system._scatter_positions, timers, "host_positions_s")

    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, system = _build_system(lp, order, n_1d, torch.float32, device, assembled=True, hook=hook)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        cls._build_sparsity = orig_sparsity
    del system._local_kf, system._scatter_positions
    assembly_s = t1 - timers.pop("constructed_at")
    scatter_s = assembly_s - timers["local_assembly_s"] - timers["host_positions_s"]
    fn, consts = system.raw_parts()
    x32 = x64.float()
    y32 = system.operator()(x32)
    err32 = float((y32.double() - y_mf).abs().max() / y_mf.abs().max())
    n = system.n_dofs
    rows = torch.as_tensor(system._rows, device=device)
    spmv_ms = _cuda_ms(lambda: fn(x32, *consts))
    gather_ms = _cuda_ms(lambda: _spmv_gather(x32, system.data, system._cols_dev, rows, n))
    y_g = _spmv_gather(x32, system.data, system._cols_dev, rows, n)
    y_c = fn(x32, *consts)
    forms_err = float((y_g - y_c).abs().max() / y_c.abs().max())
    # the least bytes of one SpMV: values (f32) and column indices (int64)
    # once, the row pointers, x read and y written
    spmv_bytes = system.nnz * (4 + 8) + (n + 1) * 8 + 2 * 4 * n
    spmv_bound_ms, spmv_bound_by = _bound(spmv_bytes, 2 * system.nnz)
    opts = lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    r = system.solve(lp.CG(opts, precond=lp.Jacobi()))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t2
    b = system.effective_rhs()
    true_res = float((b - system.operator()(system.x)).norm() / b.norm())
    _, mf32 = _build_system(lp, order, n_1d, torch.float32, device)
    r_mf = mf32.solve(lp.CG(opts, precond=lp.Jacobi()))
    ok = (
        bool(torch.isfinite(y32).all()) and err64 < F64_APPLY_TOL and err32 < F32_APPLY_TOL
        and forms_err < F32_KERNEL_TOL and r.converged and r_mf.converged
    )
    _say(
        "assembled", order=order, n_elements=(n_1d - 1) ** 3, n_dofs=n, nnz=system.nnz, dtype="float32",
        build_s=t1 - t0, **timers, scatter_s=scatter_s,
        f64_rel_err_vs_matrix_free_on_card=err64, f64_tol=F64_APPLY_TOL,
        f32_rel_err_vs_f64_matrix_free=err32, f32_tol=F32_APPLY_TOL,
        spmv_ms=spmv_ms, spmv_form="torch.sparse_csr_tensor @ x", gather_form_ms=gather_ms,
        gather_form_rel_err=forms_err, spmv_bytes=spmv_bytes, spmv_bound_ms=spmv_bound_ms,
        spmv_bound_by=spmv_bound_by, spmv_share_of_bound=spmv_bound_ms / spmv_ms,
        cg_jacobi_iterations=r.num_iters, cg_jacobi_converged=r.converged, cg_solve_s=solve_s,
        cg_true_rel_residual=true_res, matrix_free_cg_jacobi_iterations=r_mf.num_iters, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the assembled system failed its checks")
    del system, fn, consts, mf32, rows
    torch.cuda.empty_cache()


# ------------------------------------------------- condensation, preconditioners

COND_ORDER, COND_N1D = 6, 7  # the condensed phase: the reference benchmark, p = 6 on 6^3 hexes
COND_SMALL = (3, 3)  # p = 3 on 2^3 hexes: the f64 condensed system on the card against the CPU
COND_PAIR = (4, 5)  # p = 4 on 4^3 hexes: condensed against uncondensed, f64 on the card
COND_F64_TOL = 1e-11  # small f64 condensed system (data, rhs, recovered interiors) on the card vs the CPU
# f64 condensed against uncondensed nodal solutions, each from CG + Jacobi to
# 1e-12 (both solve T = x exactly in the finite-element space)
COND_PAIR_TOL = 1e-7
# f32 condensed: max nodal |T - x|, and |T| against the matrix-free bench
# solution (its q, from a 1e-6 stop, is itself off by ~7e-3: reported only)
COND_NODAL_TOL = 1e-3
# the nodal checks' CG tolerance: a 1e-6 stop leaves CG's algebraic error
# (|q - (1, 0, 0)| near 3e-2 at this size, in f64 alike), and f32 CG keeps
# lowering its recursive residual below 1e-7
COND_CHECK_TOL = 1e-8
PRE_ORDER, PRE_N1D = 4, 4  # the preconditioners phase: p = 4 on 3^3 hexes, condensed (host-bound: sized
# to keep the script inside its time limit)
JACOBI2_DAMPING = 0.5  # two damped Jacobi sweeps stay SPD (CG-safe) while damping * lambda_max(D^-1 A) < 2
# CG and GMRES + ILU0 stop at this fraction of their Jacobi runs' iterations:
# ILU(0) has negative pivots here and converges at no cap (1.2e-2 and
# 5.8e-3 at a third); a twelfth keeps the script inside its time
ILU0_CAP = 1 / 12


def _rel(got, ref) -> float:
    import torch

    got, ref = torch.as_tensor(got).double().cpu(), torch.as_tensor(ref).double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def _launches_per_call(fn, x) -> int:
    """Kernel launches of one fn(x) call: the CUDA runtime's launch calls
    (``cudaLaunchKernel*``, libraries' included) that torch.profiler records
    on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn(x)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return sum(
        e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("cudaLaunchKernel")
    )


def _true_residual(system) -> float:
    b = system.effective_rhs()
    return float((b - system.operator()(system.x)).norm() / b.norm())


def _solve_from_zero(system, solver, device) -> tuple:
    """(result, preconditioner setup s, solve s): the setup first (cached by
    the system for the solve), then the solve from x = 0."""
    import torch

    from l3ster_tpu_torch.solve.krylov import _precond_parts

    system.set_solution_vector(torch.zeros_like(system.x))
    _sync(device)
    t0 = time.perf_counter()
    _precond_parts(solver.precond, system)
    _sync(device)
    t1 = time.perf_counter()
    r = system.solve(solver)
    _sync(device)
    return r, t1 - t0, time.perf_counter() - t1


def phase_condensed(lp, mf_nodal=None, device: str = "cuda", order: int = COND_ORDER, n_1d: int = COND_N1D,
                    small=COND_SMALL, pair=COND_PAIR) -> None:
    """The reference's benchmark: the bench problem assembled with
    ELEMENT_BOUNDARY condensation (``BASELINE.md``,
    ``benchmarks/Diffusion3D.hpp:8-24``), p = 6 on 6^3 hexes, f32, default QO.
    First a small condensed system (``small``) in f64 on the card against the
    CPU (data, rhs, recovered interiors) and condensed against uncondensed in
    f64 on the card (``pair``: the same nodal solution).  Then the bench size:
    n_dofs, nnz, the build split (host sparsity, local K, host scatter
    positions with their LRU hits, the Kbb scatter, Schur factors, Schur
    scatter; local matrices and the Schur step in float64, the solve in
    float32), peak device memory and the process's peak host RSS, the SpMV
    against its byte
    bound, CG + Jacobi, BlockJacobi and Chebyshev from zero to 1e-6 (setup and
    solve seconds, true residual), the interior recovery into a
    SolutionManager with the max nodal errors against T = x, q = (1, 0, 0)
    after the Jacobi solve and after CG + Chebyshev continued to
    COND_CHECK_TOL, and the max nodal difference from the matrix-free bench
    solution (``mf_nodal``: in T, gated, and in all four fields, reported);
    the gates read the continued solve."""
    import resource

    import torch

    from l3ster_tpu_torch.algsys import system as sysmod

    t_phase = time.perf_counter()
    # the small f64 condensed system: the card against the CPU
    _, sg = _build_system(lp, *small, torch.float64, device, cond=True)
    _, sc = _build_system(lp, *small, torch.float64, "cpu", cond=True)
    xs = torch.as_tensor(np.random.default_rng(51).normal(size=(sc.n_dofs, 1)))
    sg.set_solution_vector(xs.to(device))
    sc.set_solution_vector(xs)
    small_err = max(
        _rel(sg.data, sc.data), _rel(sg.rhs, sc.rhs),
        _rel(sg.recover_condensed_solution()[0][2], sc.recover_condensed_solution()[0][2]),
    )
    del sg, sc

    # condensed against uncondensed, f64 on the card
    nodal, pair_runs = {}, {}
    for cond in (False, True):
        mesh_p, s = _build_system(lp, *pair, torch.float64, device, assembled=True, cond=cond)
        r = s.solve(lp.CG(lp.IterSolverOpts(tol=1e-12, max_iters=CG_MAX_ITERS), precond=lp.Jacobi()))
        man = lp.SolutionManager(mesh_p, 4, device=device)
        s.update_solution(range(4), man, range(4))
        nodal[cond] = man.values.cpu().numpy()
        pair_runs["condensed" if cond else "uncondensed"] = dict(
            n_dofs=s.n_dofs, nnz=s.nnz, cg_jacobi_iterations=r.num_iters, converged=r.converged
        )
        del s
    pair_err = float(np.abs(nodal[True] - nodal[False]).max())
    torch.cuda.empty_cache()

    # the bench size, f32, its build timed by part
    timers: dict = {}
    positions: list = []
    cls = lp.AssembledSystem
    orig_sparsity, orig_schur = cls._build_sparsity, sysmod._schur_solve
    cls._build_sparsity = _synced_timer(orig_sparsity, timers, "host_sparsity_s")
    sysmod._schur_solve = _synced_timer(orig_schur, timers, "schur_factor_s")

    def hook(system):
        timers["constructed_at"] = time.perf_counter()
        system._local_kf = _synced_timer(system._local_kf, timers, "local_assembly_s")
        scatter_positions, end_assembly = system._scatter_positions, system.end_assembly

        def positions_timed(elem_dofs):
            hit = elem_dofs.tobytes() in system._pos_cache
            t0 = time.perf_counter()
            out = scatter_positions(elem_dofs)
            positions.append(dict(shape=list(elem_dofs.shape), lru_hit=hit, s=time.perf_counter() - t0,
                                  in_end_assembly="end_at" in timers))
            return out

        def end_timed():
            _sync(device)
            timers["end_at"] = time.perf_counter()
            end_assembly()
            _sync(device)
            timers["end_assembly_s"] = time.perf_counter() - timers["end_at"]

        system._scatter_positions, system.end_assembly = positions_timed, end_timed

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    try:
        _sync(device)
        t0 = time.perf_counter()
        mesh, system = _build_system(lp, order, n_1d, torch.float32, device, hook=hook, cond=True)
        _sync(device)
        build_s = time.perf_counter() - t0
    finally:
        cls._build_sparsity, sysmod._schur_solve = orig_sparsity, orig_schur
    del system._local_kf, system._scatter_positions, system.end_assembly
    assembly_s = timers.pop("end_at") - timers.pop("constructed_at")
    pos_assembly = sum(p["s"] for p in positions if not p["in_end_assembly"])
    pos_end = sum(p["s"] for p in positions if p["in_end_assembly"])
    build = dict(
        build_s=build_s, host_sparsity_s=timers["host_sparsity_s"], local_k_s=timers["local_assembly_s"],
        host_positions_s=pos_assembly, kbb_and_aggregate_scatter_s=assembly_s - timers["local_assembly_s"] - pos_assembly,
        end_assembly_s=timers["end_assembly_s"], schur_factor_s=timers["schur_factor_s"],
        schur_positions_s=pos_end, schur_scatter_s=timers["end_assembly_s"] - timers["schur_factor_s"] - pos_end,
    )
    n, nnz = system.n_dofs, system.nnz
    blk = mesh.domains[0][0]
    n_boundary_nodes = mesh.n_nodes - blk.n_elements * (order - 1) ** 3

    fn, consts = system.raw_parts()
    x32 = torch.as_tensor(np.random.default_rng(52).normal(size=(n, 1)), dtype=torch.float32, device=device)
    spmv_ms = _cuda_ms(lambda: fn(x32, *consts))
    spmv_bytes = nnz * (4 + 8) + (n + 1) * 8 + 2 * 4 * n  # values, column indices, row pointers, x, y
    spmv_bound_ms, spmv_bound_by = _bound(spmv_bytes, 2 * nnz)

    opts = lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS)
    interior = system.dofmap.node_dof[:, 0] < 0  # the condensed nodes

    def nodal_check() -> dict:
        """Interiors recovered into a SolutionManager; nodal errors against
        T = x, q = (1, 0, 0) over the element-boundary and interior nodes, and
        the difference from the matrix-free bench solution."""
        man = lp.SolutionManager(mesh, 4, device=device)
        _sync(device)
        t0 = time.perf_counter()
        system.update_solution(range(4), man, range(4))
        _sync(device)
        X = man.values.cpu().numpy()
        eT = np.abs(X[:, 0] - mesh.node_coords[:, 0])
        eq = np.maximum(np.abs(X[:, 1] - 1.0), np.abs(X[:, 2:]).max(axis=1))
        return dict(
            recovery_s=time.perf_counter() - t0, finite=bool(np.isfinite(X).all()),
            max_err_T=float(eT.max()), max_err_T_boundary_nodes=float(eT[~interior].max()),
            max_err_T_interior_nodes=float(eT[interior].max()), max_err_q=float(eq.max()),
            max_diff_T_vs_matrix_free=float(np.abs(X[:, 0] - mf_nodal[:, 0]).max()) if mf_nodal is not None else None,
            max_diff_all_vs_matrix_free=float(np.abs(X - mf_nodal).max()) if mf_nodal is not None else None,
        )

    solves, nodal = {}, {}
    for name, pc in (("Jacobi", lp.Jacobi()), ("BlockJacobi", lp.BlockJacobi()), ("Chebyshev", lp.Chebyshev())):
        r, setup_s, solve_s = _solve_from_zero(system, lp.CG(opts, precond=pc), device)
        solves[name] = dict(iterations=r.num_iters, converged=r.converged, achieved_rel_residual=r.tol,
                            true_rel_residual=_true_residual(system), setup_s=setup_s, solve_s=solve_s,
                            ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1))
        if name == "Jacobi":
            nodal[f"cg_jacobi_{CG_TOL}"] = nodal_check()
    # the nodal checks' solve: the last one continued to COND_CHECK_TOL, so
    # that the algebraic error of a 1e-6 stop does not mask the recovery's
    r = system.solve(lp.CG(lp.IterSolverOpts(tol=COND_CHECK_TOL, max_iters=CG_MAX_ITERS), precond=lp.Chebyshev()))
    check = dict(nodal_check(), iterations=r.num_iters, converged=r.converged, true_rel_residual=_true_residual(system))
    nodal[f"cg_chebyshev_continued_{COND_CHECK_TOL}"] = check
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 if torch.device(device).type == "cuda" else None
    ok = (
        small_err < COND_F64_TOL and pair_err < COND_PAIR_TOL
        and all(v["converged"] for v in pair_runs.values()) and n == 4 * n_boundary_nodes
        and all(v["converged"] for v in solves.values()) and check["converged"] and check["finite"]
        and check["max_err_T"] < COND_NODAL_TOL
        and (mf_nodal is None or check["max_diff_T_vs_matrix_free"] < COND_NODAL_TOL)
    )
    _say(
        "condensed", order=order, n_elements=blk.n_elements, n_dofs=n, nnz=nnz, dtype="float32",
        uncondensed_n_dofs=4 * mesh.n_nodes, **build,
        scatter_positions=[dict(p, s=round(p["s"], 4)) for p in positions],
        peak_device_gb=peak_gb,
        process_peak_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
        spmv_ms=spmv_ms, spmv_bytes=spmv_bytes, spmv_bound_ms=spmv_bound_ms, spmv_bound_by=spmv_bound_by,
        spmv_share_of_bound=spmv_bound_ms / spmv_ms, tol=CG_TOL, cg=solves, n_nodes=mesh.n_nodes, nodal=nodal,
        nodal_tol=COND_NODAL_TOL,
        small_f64_rel_err_vs_cpu=small_err, small_tol=COND_F64_TOL, small_order_n1d=list(small),
        pair_order_n1d=list(pair), pair=pair_runs, pair_max_nodal_diff=pair_err, pair_tol=COND_PAIR_TOL,
        phase_s=time.perf_counter() - t_phase, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the condensed system failed its checks")


def _ilu0_negative_pivots(system) -> int:
    """Negative diagonal entries of U in the host ILU(0) of the system's
    eliminated CSR: each makes the preconditioner indefinite."""
    from l3ster_tpu_torch.solve.tri import ilu0_factor

    data, indices, indptr, n = system.eliminated_csr()
    fac = ilu0_factor(data.double().cpu().numpy(), indices, indptr, n)
    return int((fac[np.repeat(np.arange(n), np.diff(indptr)) == indices] < 0).sum())


def phase_preconditioners(lp, device: str = "cuda", order: int = PRE_ORDER, n_1d: int = PRE_N1D,
                          jacobi2_damping: float = JACOBI2_DAMPING) -> None:
    """The preconditioner family on the bench problem condensed at p = 4 on
    3^3 hexes (f32): CG from zero to 1e-6 with Richardson, Jacobi, two damped
    Jacobi sweeps, Chebyshev, BlockJacobi, SGS, SGS(sweeps=2) and ILU0, then
    GMRES with Jacobi, ILU0 and ILUT(drop_tol=1e-5).  For each: iterations,
    setup seconds split into the host factorization, the level analysis and
    the rest (upload), solve seconds, the true residual; for the triangular
    solves their levels, ms per solve and launches per preconditioner apply.
    ILU(0) of this matrix has negative pivots (counted and reported), so M
    is indefinite: CG + ILU0 and GMRES + ILU0 each get ``ILU0_CAP`` of the
    iterations their solver took with Jacobi, their outcome reported and not
    required.  Then
    the reference's bar as its
    test runs it (``tests/test_solvers.py:171-211``): CG + Jacobi from zero,
    then BlockJacobi, SGS and ILU0, each from the previous solve's x; ILU0
    and SGS in at most a third of Jacobi's iterations, BlockJacobi in fewer.
    Fails unless every other solve converges, that bar holds, SGS takes fewer
    iterations than Jacobi from zero, and the host helper built (no numpy
    ILU(0) or level loop ran)."""
    import scipy.sparse.linalg as spla
    import torch

    from l3ster_tpu_torch.solve import hostops, tri
    from l3ster_tpu_torch.solve.krylov import _precond_parts

    t_phase = time.perf_counter()
    if not hostops.available():
        raise SystemExit("chip_smoke: the host helper (csrc/hostops.cpp) did not build")
    _, system = _build_system(lp, order, n_1d, torch.float32, device, cond=True)
    timers: dict = {}
    built: list = []
    orig = dict(build=tri.build_tri_solve, sched=tri.tri_schedule, ilu0=tri.ilu0_factor, spilu=spla.spilu)

    def build_recorded(*args, **kwargs):
        out = orig["build"](*args, **kwargs)
        built.append(out)
        return out

    tri.build_tri_solve = build_recorded
    tri.tri_schedule = _synced_timer(orig["sched"], timers, "level_analysis_s")
    tri.ilu0_factor = _synced_timer(orig["ilu0"], timers, "host_factorization_s")
    spla.spilu = _synced_timer(orig["spilu"], timers, "host_factorization_s")
    rv = torch.as_tensor(np.random.default_rng(53).normal(size=(system.n_dofs, 1)), dtype=system.dtype, device=device)
    opts = lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS)
    runs = (
        ("CG", "Richardson", lp.Richardson()), ("CG", "Jacobi", lp.Jacobi()),
        ("CG", f"Jacobi(sweeps=2, damping={jacobi2_damping})", lp.Jacobi(sweeps=2, damping=jacobi2_damping)),
        ("CG", "Chebyshev", lp.Chebyshev()), ("CG", "BlockJacobi", lp.BlockJacobi()), ("CG", "SGS", lp.SGS()),
        ("CG", "SGS(sweeps=2)", lp.SGS(sweeps=2)), ("CG", "ILU0", lp.ILU0()),
        ("GMRES", "Jacobi", lp.Jacobi()), ("GMRES", "ILU0", lp.ILU0()),  # each ILU0 after its solver's Jacobi
        ("GMRES", "ILUT(drop_tol=1e-5)", lp.ILUT(drop_tol=1e-5)),
    )
    out, tri_info, jacobi_its = [], {}, {}
    try:
        for solver_name, name, pc in runs:
            timers.clear()
            built.clear()
            o = opts
            if name == "ILU0":
                # ILU(0) of this LSFEM matrix has negative pivots (an indefinite
                # M): each solver gets ILU0_CAP of its Jacobi run's iterations,
                # and the outcome is reported, not required
                o = lp.IterSolverOpts(tol=CG_TOL, max_iters=int(jacobi_its[solver_name] * ILU0_CAP))
            solver = (lp.CG if solver_name == "CG" else lp.Gmres)(o, precond=pc)
            r, setup_s, solve_s = _solve_from_zero(system, solver, device)
            rec = dict(solver=solver_name, precond=name, max_iters=o.max_iters, iterations=r.num_iters,
                       converged=r.converged, capped=r.capped, achieved_rel_residual=r.tol,
                       true_rel_residual=_true_residual(system),
                       setup_s=setup_s, **{k: v for k, v in timers.items()}, solve_s=solve_s,
                       ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1))
            if timers:
                rec["upload_and_rest_s"] = setup_s - sum(timers.values())
            if built:
                tri_info[name] = dict(
                    levels=[f.n_levels for f, _ in built],
                    ms_per_tri_solve=[_cuda_ms(lambda f=f, cs=cs: f(rv, *cs), reps=3, batch=1, warm=1)
                                      for f, cs in built],
                    launches_per_tri_solve=[f.launches for f, _ in built],
                )
            M_fn, M_consts = _precond_parts(pc, system)
            rec["precond_apply_ms"] = _cuda_ms(lambda: M_fn(rv, *M_consts), reps=3, batch=1, warm=1)
            rec["launches_per_precond_apply"] = _launches_per_call(lambda v: M_fn(v, *M_consts), rv)
            if name in tri_info:
                rec.update(tri_info[name], setup_cached=not built)
            out.append(rec)
            if name == "Jacobi":
                jacobi_its[solver_name] = r.num_iters
            _say("preconditioner", n_dofs=system.n_dofs, nnz=system.nnz, **rec)
    finally:
        tri.build_tri_solve, tri.tri_schedule, tri.ilu0_factor, spla.spilu = (
            orig["build"], orig["sched"], orig["ilu0"], orig["spilu"]
        )
    its = {(o["solver"], o["precond"]): o["iterations"] for o in out}
    jac = its[("CG", "Jacobi")]
    ilu0 = next(o for o in out if (o["solver"], o["precond"]) == ("CG", "ILU0"))
    from_zero = dict(ilu0_converged_within_cap=ilu0["converged"], sgs_ratio=its[("CG", "SGS")] / jac,
                     blockjacobi_ratio=its[("CG", "BlockJacobi")] / jac)
    pivots = _ilu0_negative_pivots(system)
    # the reference's bar as its test runs it (tests/test_solvers.py:171-211):
    # Jacobi from zero, then BlockJacobi, SGS and ILU0 each from the previous x
    system.set_solution_vector(torch.zeros_like(system.x))
    seq = {}
    seq_opts = lp.IterSolverOpts(tol=CG_TOL, max_iters=jac)
    for name in ("Jacobi", "BlockJacobi", "SGS", "ILU0"):
        r = system.solve(lp.CG(seq_opts, precond=getattr(lp, name)()))
        seq[name] = dict(iterations=r.num_iters, converged=r.converged, true_rel_residual=_true_residual(system))
    sj = seq["Jacobi"]["iterations"]
    bar = dict(ilu0=seq["ILU0"]["iterations"] * 3 <= sj, sgs=seq["SGS"]["iterations"] * 3 <= sj,
               blockjacobi=seq["BlockJacobi"]["iterations"] < sj)
    native = dict(hostops.backend)
    ok = (
        all(o["converged"] and not o["capped"] for o in out if o["precond"] != "ILU0")
        and all(v["converged"] for v in seq.values()) and all(bar.values()) and from_zero["sgs_ratio"] < 1.0
        and set(native.values()) == {"native"} and len(native) == 2
    )
    _say(
        "preconditioners", order=order, n_elements=(n_1d - 1) ** 3, n_dofs=system.n_dofs, nnz=system.nnz,
        dtype="float32", tol=CG_TOL, iterations={f"{s}+{p}": i for (s, p), i in its.items()},
        from_zero_vs_jacobi=from_zero, ilu0_negative_pivots=pivots, reference_sequence=seq,
        reference_bar=bar, host_helper=native, phase_s=time.perf_counter() - t_phase, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the preconditioners phase failed its checks")


def phase_mg_solve(lp, state: dict, jacobi_iters: int, phase: str, precond=None) -> int:
    """CG + LowOrderMG() to the bench's tolerance on the state's system, from
    zero, as ``benchmarks/bench_suite.py:226-243`` runs it: the cold solve
    (setup included) with its setup split into the order-1 systems, the power
    iterations and the coarse inverse (assembled order-1 system and host
    float64 inverse), then the warm solve (setup cached by assembly epoch);
    one V-cycle alone with its device idle share; the true residual beside
    CG's recursive one; nodal errors; z-sweep launches by level (level 0's
    include CG's own applies).  Fails unless both solves converge in fewer
    iterations than CG + Jacobi.  Returns the z-sweep launches of the path
    (the launch count is set to 0 just before the cold solve)."""
    import torch

    from l3ster_tpu_torch.ops import zsweep
    from l3ster_tpu_torch.solve import lowordermg as mgmod
    from l3ster_tpu_torch.solve.krylov import _precond_parts

    system, mesh = state["system"], state["mesh"]
    timers: dict = {}
    launches: dict = {}
    level_kinds = {}

    def count_level(s, li):
        apply_ = s._apply
        level_kinds[li] = [d[0] for _, d in s._operators()[1]]

        def counted(x, lattice_io, ops):
            before = zsweep.launch_count
            y = apply_(x, lattice_io, ops)
            launches[li] = launches.get(li, 0) + zsweep.launch_count - before
            return y

        s._apply = counted

    levels = [system]

    def new_level(s):
        if s.device != system.device or s.dtype != system.dtype:
            raise SystemExit(f"chip_smoke: an order-1 level was built on {s.device} in {s.dtype}")
        levels.append(s)
        count_level(s, len(levels) - 1)

    names = ("_build_p1_system", "_lambda_max", "_assembled_dense_inv")
    orig = {k: getattr(mgmod, k) for k in names}
    mgmod._build_p1_system = _synced_timer(orig["_build_p1_system"], timers, "order1_systems_s", new_level)
    mgmod._lambda_max = _synced_timer(orig["_lambda_max"], timers, "power_iterations_s")
    mgmod._assembled_dense_inv = _synced_timer(orig["_assembled_dense_inv"], timers, "coarse_inverse_host_s")
    count_level(system, 0)
    precond = lp.LowOrderMG() if precond is None else precond
    cg = lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=precond)
    try:
        system.set_solution_vector(torch.zeros_like(system.x))
        zsweep.launch_count = 0  # the multigrid path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = system.solve(cg)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        b = system.effective_rhs()
        true_res = float((b - system.operator()(system.x)).norm() / b.norm())
        X = system.x[:, 0].reshape(-1, 4).double().cpu().numpy()
        system.set_solution_vector(torch.zeros_like(system.x))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r_warm = system.solve(cg)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        path_launches = zsweep.launch_count
        level_launches = dict(launches)  # the two solves' (setup included), not the timing below
        M_fn, M_consts = _precond_parts(precond, system, "lattice")  # the cached setup
        r_host = np.random.default_rng(31).normal(size=(system.n_dofs, 1))
        rl = system.to_lattice_layout(torch.as_tensor(r_host, dtype=system.dtype, device=system.device))
        vcycle_ms = _cuda_ms(lambda: M_fn(rl, *M_consts), reps=10, batch=5)
        busy_ms, top = _profile_apply(lambda v: M_fn(v, *M_consts), rl, n=5)
    finally:
        for k, f in orig.items():
            setattr(mgmod, k, f)
        for s in levels:
            del s._apply
    err_T = float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())
    err_q = float(max(np.abs(X[:, 1] - 1.0).max(), np.abs(X[:, 2:]).max()))
    ok = (
        r.converged and r_warm.converged and r.num_iters < jacobi_iters and r_warm.num_iters < jacobi_iters
        and np.isfinite(X).all() and path_launches > 0
        and all(level_launches.get(i, 0) > 0 for i in range(len(levels)))
    )
    _say(
        phase, n_dofs=system.n_dofs, solver=f"CG+{precond}", dtype="float32", tol=CG_TOL,
        levels=[dict(level=i, n_dofs=s.n_dofs, kinds=level_kinds[i], zsweep_launches=level_launches.get(i, 0))
                for i, s in enumerate(levels)],
        coarse_dofs=int(M_consts[-1].shape[0]), cold_solve_s=cold_s, **timers, iterations=r.num_iters,
        achieved_rel_residual=r.tol, true_rel_residual=true_res, converged=r.converged,
        warm_solve_s=warm_s, warm_iterations=r_warm.num_iters, warm_converged=r_warm.converged,
        ms_per_iteration_warm=warm_s * 1e3 / max(r_warm.num_iters, 1), vcycle_ms=vcycle_ms,
        vcycle_device_busy_ms=busy_ms, vcycle_device_idle_share=1.0 - busy_ms / vcycle_ms,
        vcycle_top_device_ms=top, cg_jacobi_iterations=jacobi_iters,
        max_nodal_err_T_minus_x=err_T, max_nodal_err_q_minus_1_0_0=err_q, zsweep_launches=path_launches, ok=ok,
    )
    if not ok:
        raise SystemExit(f"chip_smoke: CG + LowOrderMG failed its checks ({phase})")
    state["mg_iterations"] = r.num_iters
    return path_launches


# ------------------------------------------------------------ the 2D lattice path, periodic, IO, adjoint

L2D_N, L2D_ORDER = 129, 6  # the 2D lattice cell: p = 6 on 128^2 quads (1,774,083 dofs)
NONFUSED_TOL = 1e-4  # f32: the non-fused chain or its per-QP kernel vs the default apply
PER_NX, PER_NY, PER_ORDER = 257, 129, 4  # the periodic cell: 256 x 128 quads at p = 4
PER_DT, PER_STEPS, PER_ERR_PCT = 0.025, 40, 5.0  # one period; the example's 5% bound
# each step's CG + Jacobi stop (f32): a 1e-6 stop leaves 11.08% at this size on
# the H100 (4.85% at 64 x 32 quads on the CPU, in f32 and f64 alike); the
# solves' error, not f32, grows with the refinement, and 1e-8 holds 2.65%
PER_CG_TOL = 1e-8
PER_F64_TOL = 1e-10  # the example's size in f64: the card vs the CPU after the period
GMSH_N, GMSH_ORDER, GMSH_NODAL_TOL = 64, 4, 1e-3
INV_N, INV_ORDER = 33, 4  # the inverse problem: 32^2 quads at p = 4 (49,923 dofs), f64
INV_THETA = (1.5, -0.7, 0.9)
INV_CENTERS = ((0.25, 0.3), (0.6, 0.7), (0.8, 0.2))
INV_GRAD_TOL, INV_THETA_TOL = 1e-6, 1e-3
INV_CG_TOL = 1e-10  # each solve's stop (the example's 1e-12): the gradient check needs far less


def _diffusion_2d(inp, out):
    """The reference's Diffusion2D operator (T, qx, qy; 4 equations)."""
    ops, _ = out
    A0, Ax, Ay = ops
    Ax[0, 1] = -1.0
    Ay[0, 2] = -1.0
    A0[1, 1] = -1.0
    Ax[1, 0] = 1.0
    A0[2, 2] = -1.0
    Ay[2, 0] = 1.0
    Ax[3, 2] = 1.0
    Ay[3, 1] = -1.0


def _adiabatic_2d(inp, out):
    ops, _ = out
    ops[0][0, 1] = inp.normal[0]
    ops[0][0, 2] = inp.normal[1]


def _build_2d(lp, mesh, dtype, device, domain: int = 0):
    """Diffusion2D on a square mesh: T = x on left/right (3, 4), adiabatic
    top/bottom (1, 2), matrix-free, AUTO."""
    problem = lp.ProblemDefinition(3, [domain])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    system.set_dirichlet_bc_values(lp.wrap_boundary_residual_kernel(_t_equals_x, lp.KernelParams(2, 1)), [3, 4], [0])
    system.begin_assembly()
    system.assemble_problem(lp.wrap_domain_equation_kernel(_diffusion_2d, lp.KernelParams(2, 4, 3)), [domain])
    system.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_2d, lp.KernelParams(2, 1, 3)), [1, 2])
    system.end_assembly()
    return system


def _square(lp, n: int, order: int):
    return lp.generate_mesh(lp.make_square_mesh(np.linspace(0.0, 1.0, n)), order=order)


def _library_qp_lattice(A, g, ji, w):
    """The per-QP chain on the lattice layout (d1*c, EQ): J^-T and J^-1 as
    broadcast multiply-adds over the (dim, dim, EQ) planes, A and A^T as
    cuBLAS matmuls; the yardstick for ``library_ms``, never called by the
    port."""
    import torch

    d1, n_eq, c = A.shape
    dim, EQ = d1 - 1, g.shape[1]
    g3 = g.reshape(d1, c, EQ)
    J = ji.reshape(dim, dim, 1, EQ)
    gp = torch.cat([g3[:1], (J * g3[1:, None]).sum(0)])
    M = torch.as_tensor(A, dtype=g.dtype, device=g.device).permute(1, 0, 2).reshape(n_eq, d1 * c)
    r = torch.matmul(M, gp.reshape(d1 * c, EQ)) * w
    t = torch.matmul(M.T, r).reshape(d1, c, EQ)
    return torch.cat([t[:1], (J * t[None, 1:]).sum(1)]).reshape(d1 * c, EQ)


def _qp_ptxas(dtype, dim: int, c: int, lattice: bool) -> list:
    """The build's -Xptxas=-v line of the per-QP kernel's instantiation
    (registers, spills) for one dtype, dim, channel count and layout."""
    import torch

    from l3ster_tpu_torch.ops import _cuda

    f32 = dtype == torch.float32
    C = c if f32 and c in (1, 3, 4) else 0  # the compiled channel counts (f32 only); 0: run-time
    tag = f"_Z9qp_kernelI{'f' if f32 else 'd'}Li{dim}ELi{C}ELb{int(lattice)}E"
    return [ln for ln in _ptxas_summary(_cuda.build_logs.get("qp_algebra", "")) if ln.startswith(tag)]


def phase_kernels_qp(lp, device: str = "cuda", shrink: int = 1) -> dict:
    """The per-QP kernel (B2) against its plain version (f64 and f32) at the
    shapes of its paths: the dense (E, c, d1, Q) layout of the p = 4 cylinder
    (the bench kernel's A) and of the periodic cell (BDF3 advection, p = 4 on
    256 x 128 quads), and the lattice (d1*c, EQ) rows of the 2D cell
    (Diffusion2D's A, p = 6 on 128^2 quads) and of the bench under
    ``L3STER_TPU_FUSED_Z=0``; per shape the kernel's, plain and library ms, a
    torch copy of as many bytes (``copy_same_bytes_ms``), the byte bound, the
    launch shape with resident blocks per SM and the instantiation's registers
    and spills.  Returns {cell: record}.  ``shrink`` divides every shape's
    element or QP count (a rehearsal on the CPU)."""
    import torch

    from l3ster_tpu_torch.algsys.system import _constant_kernel_operators
    from l3ster_tpu_torch.models.kernels import advection_bdf_2d
    from l3ster_tpu_torch.ops import qp

    def const_A(kern, params):
        return _constant_kernel_operators(lp.wrap_domain_equation_kernel(kern, params), 0.0)

    A3 = const_A(_diffusion_3d, lp.KernelParams(3, 7, 4))
    q1_4 = lp.AssemblyOptions().quadrature_order(CYL_ORDER) // 2 + 1
    q1_6 = lp.AssemblyOptions().quadrature_order(L2D_ORDER) // 2 + 1
    A_per = _constant_kernel_operators(advection_bdf_2d((1.0, 0.0), PER_DT, 11.0 / 6.0, ()), 0.0)
    cases = {  # cell: (record name, A, layout, dim, E, Q)
        "cylinder": ("qp_algebra", A3, "dense", 3, 17456, q1_4**3),
        "periodic": ("qp_algebra_periodic", A_per, "dense", 2, (PER_NX - 1) * (PER_NY - 1), q1_4**2),
        "lattice_2d": ("qp_algebra_lattice_2d", const_A(_diffusion_2d, lp.KernelParams(2, 4, 3)), "lattice", 2, 1,
                       (L2D_N - 1) ** 2 * q1_6**2),
        "lattice_bench": ("qp_algebra_lattice_bench", A3, "lattice", 3, 1, 6**3 * q1_6**3),
    }
    records = {}
    for cell, (name, A, layout, dim, E, Q) in cases.items():
        d1, n_eq, c = A.shape
        E, Q = (-(-E // shrink), Q) if layout == "dense" else (1, -(-Q // shrink))
        EQ = E * Q
        rng = np.random.default_rng(40 + len(cell))
        host = (
            rng.normal(size=(E, c, d1, Q) if layout == "dense" else (d1 * c, EQ)),
            rng.normal(size=(dim, dim, EQ)) * 0.1 + np.eye(dim)[:, :, None],
            rng.uniform(0.5, 1.0, EQ),
        )
        if layout == "dense":
            kern, plain, lib = qp.qp_algebra_const, qp.qp_algebra_const_plain, _library_qp
        else:
            kern, plain, lib = qp.qp_algebra_const_lattice, qp.qp_algebra_const_lattice_plain, _library_qp_lattice
            host = (host[0], host[1].reshape(dim * dim, EQ), host[2])
        d64 = tuple(torch.as_tensor(h, device=device) for h in host)
        ref = plain(A, *d64)
        err64 = _errs(kern(A, *d64), ref)[1]
        d32 = tuple(t.float() for t in d64)
        abs32, err32 = _errs(kern(A, *d32), ref)
        _, lib_err = _errs(lib(A, *d32), ref)
        _sync(device)
        del d64, ref
        ms, plain_ms, library_ms = (
            _cuda_ms(f, queued=True)
            for f in (lambda: kern(A, *d32), lambda: plain(A, *d32), lambda: lib(A, *d32))
        )
        nbytes = 4 * (2 * d32[0].numel() + d32[1].numel() + d32[2].numel())
        flops = _qp_flops(EQ, dim, c, int((A != 0).sum()), n_eq)
        bound_ms, bound_by = _bound(nbytes, flops)
        src = torch.empty(nbytes // 8, device=device)  # read and written: nbytes in all
        dst = torch.empty_like(src)
        copy_ms = _cuda_ms(lambda: dst.copy_(src), queued=True)
        del src, dst
        cuda = device != "cpu"
        ok = err64 < F64_KERNEL_TOL and err32 < F32_KERNEL_TOL
        _say(
            "kernel_vs_plain", kernel="qp_algebra", layout=layout, cell=cell, shape=list(d32[0].shape), c=c,
            n_eq=n_eq, f64_rel_err=err64, f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32,
            f32_tol=F32_KERNEL_TOL, library_rel_err=lib_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            copy_same_bytes_ms=copy_ms, bytes=nbytes, flops=flops, bound_ms=bound_ms, bound_by=bound_by,
            share_of_bound=bound_ms / ms,
            launch_shape=qp.kernel_occupancy(torch.float32, A, dim, c, EQ, layout == "lattice") if cuda else None,
            ptxas=_qp_ptxas(torch.float32, dim, c, layout == "lattice"), ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: the per-QP kernel disagrees with its plain version: {cell}")
        records[cell] = dict(
            name=name, route="cuda", source="l3ster_tpu_torch/csrc/qp_algebra.cu",
            replaces="l3ster_tpu/ops/pallas_qp.py:94", launches=None, max_abs_err=abs32, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        )
        del d32
        if cuda:
            torch.cuda.empty_cache()
    return records


def phase_kernels_rows(lp, device: str = "cuda", small: bool = False) -> dict:
    """The node-row gather and scatter-add (``csrc/row_gather.cu``) against
    their plain versions on the p = 4 cylinder's node-row contribution
    (E = 17,456 elements, n = 125 nodes, c = 4, its own int32 row indices),
    in both layouts (channel-major, the AUTO path's; node-major, the
    SUM_FACT_PALLAS path's), f64 and f32: the gather bit for bit, the scatter
    to rounding (its atomics add in another order than ``index_add_``).  Per
    layout the kernel's ms, the plain version's (torch indexing into the same
    contiguous block; the transpose copy and ``index_add_``), a torch copy of
    as many bytes, the byte bound (indices, the rows once, the block; the
    scatter's accumulator read and written) and the launch shape.  Returns
    {"gather": record, "scatter": record}, each timed in the channel-major
    layout.  ``small``: the small cylinder mesh (a rehearsal on the CPU)."""
    import torch

    from l3ster_tpu_torch.ops.rows import gather_rows, gather_rows_plain, scatter_rows_add, scatter_rows_add_plain

    system = _build_cylinder(lp, _cylinder_mesh(lp, 2 if small else CYL_ORDER, small), "AUTO", torch.float32, device)
    (c_vol, d_vol), = [(c, d) for c, d in system._operators()[1] if d[-1][0] == "rows"]
    _, idx, n_rows = d_vol[-1]
    E, n = idx.shape
    c = c_vol.elem_dofs.shape[2]
    del system, d_vol
    rng = np.random.default_rng(50)
    records = {}
    for op, name in (("gather", "rows_gather"), ("scatter", "rows_scatter_add")):
        per_layout = {}
        for cm in (True, False):
            shape = (E, c, n) if cm else (E, n, c)
            if op == "gather":
                kern = lambda x, cm=cm: gather_rows(x, idx, cm)  # noqa: E731
                plain = lambda x, cm=cm: gather_rows_plain(x, idx, cm).contiguous()  # noqa: E731
                args = [torch.as_tensor(rng.normal(size=(n_rows, c)), device=device)]
                args.append(args[0].float())
                differ = [int((kern(a) != plain(a)).sum()) for a in args]
                ok, abs32 = differ == [0, 0], 0.0
                checks = dict(f64_values_differing=differ[0], f32_values_differing=differ[1], bit_exact=ok)
                nbytes = E * n * 4 + n_rows * c * 4 + E * n * c * 4
                timed = (lambda a=args[1]: kern(a), lambda a=args[1]: plain(a))
            else:
                kern = lambda flat, y, cm=cm: scatter_rows_add(flat, idx, y, cm)  # noqa: E731
                plain = lambda flat, y, cm=cm: scatter_rows_add_plain(flat, idx, y, cm)  # noqa: E731
                args = [torch.as_tensor(rng.normal(size=shape), device=device)]
                args.append(args[0].float())
                ref, got64, got32, plain32 = (
                    torch.zeros((n_rows, c), dtype=a.dtype, device=device) for a in (args[0], args[0], args[1], args[1])
                )
                plain(ref, args[0])
                kern(got64, args[0])
                kern(got32, args[1])
                plain(plain32, args[1])
                err64 = _errs(got64, ref)[1]
                abs32, err32 = _errs(got32, ref)
                ok = err64 < F64_KERNEL_TOL and err32 < F32_KERNEL_TOL
                checks = dict(f64_rel_err=err64, f64_tol=F64_KERNEL_TOL, f32_rel_err=err32, f32_abs_err=abs32,
                              f32_tol=F32_KERNEL_TOL, plain_f32_rel_err=_errs(plain32, ref)[1])
                nbytes = E * n * c * 4 + E * n * 4 + 2 * n_rows * c * 4
                # the timed calls keep adding into one accumulator
                timed = (lambda a=args[1], f=got32: kern(f, a), lambda a=args[1], f=got32: plain(f, a))
                del ref, got64, plain32
            _sync(device)
            ms, plain_ms = (_cuda_ms(f, queued=True) for f in timed)
            bound_ms, bound_by = _bound(nbytes, 0)
            src = torch.empty(nbytes // 8, device=device)  # read and written: nbytes in all
            dst = torch.empty_like(src)
            copy_ms = _cuda_ms(lambda: dst.copy_(src), queued=True)
            del src, dst, args, timed
            layout = "channel_major" if cm else "node_major"
            _say(
                "kernel_vs_plain", kernel=name, layout=layout, cell="cylinder", shape=list(shape),
                n_rows=n_rows, **checks, ms=ms, plain_ms=plain_ms, copy_same_bytes_ms=copy_ms, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                launch_shape=dict(blocks=-(-E * n // 256), threads=256), ok=ok,
            )
            if not ok:
                raise SystemExit(f"chip_smoke: the row {op} kernel disagrees with its plain version ({layout})")
            per_layout[layout] = (ms, plain_ms, bound_ms, bound_by, abs32)
        ms, plain_ms, bound_ms, bound_by, abs32 = per_layout["channel_major"]
        records[op] = dict(
            name=name, route="cuda", source="l3ster_tpu_torch/csrc/row_gather.cu", replaces=None,
            launches=0, max_abs_err=abs32, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, node_major_ms=per_layout["node_major"][0],
        )
    if device != "cpu":
        torch.cuda.empty_cache()
    return records


def _apply_with_env(lp, build, env: dict, x):
    """Build a system with the environment switches ``env`` set (unset after),
    take its lattice-layout operator and apply it once to x."""
    import os

    os.environ.update(env)
    try:
        system = build()
        fn, consts = system.operator_parts(layout="lattice")
    finally:
        for k in env:
            del os.environ[k]
    return system, fn, consts, fn(x, *consts)


def phase_bench_nonfused(lp, state: dict, device: str = "cuda", order: int = 6, n_1d: int = 7) -> int:
    """The bench system (f32) without the fused z-sweep
    (``L3STER_TPU_FUSED_Z=0``): the non-fused chain, plain and with the
    per-QP kernel (``L3STER_TPU_LATTICE_PALLAS_QP=1``), each against the
    default fused apply, with its time, device-busy time and its z-sweep
    (B1) and per-QP (B2) launches counted apart.  Returns B2's launches."""
    import torch

    from l3ster_tpu_torch.ops import qp, zsweep

    xl, y_default = state["xl"], state["y32"]
    qp_launches = 0
    for env, variant in (({"L3STER_TPU_FUSED_Z": "0"}, "chain"),
                         ({"L3STER_TPU_FUSED_Z": "0", "L3STER_TPU_LATTICE_PALLAS_QP": "1"}, "chain_qp")):
        zsweep.launch_count = qp.launch_count = 0  # this system's path starts here
        system, fn, consts, y = _apply_with_env(
            lp, lambda: _build_system(lp, order, n_1d, torch.float32, device)[1], env, xl
        )
        _sync(device)
        kinds = [d[0] for _, d in system._operators()[1]]
        err = float((y - y_default).abs().max() / y_default.abs().max())
        ms = _cuda_ms(lambda: fn(xl, *consts))
        busy_ms, top = _profile_apply(lambda v: fn(v, *consts), xl)
        counts = dict(zsweep=zsweep.launch_count, qp_algebra=qp.launch_count)
        ok = (
            kinds == ["lattice_sf_const"] + ["face_banded"] * 4 and system._variant == variant
            and bool(torch.isfinite(y).all()) and err < NONFUSED_TOL and counts["zsweep"] == 0
            and (counts["qp_algebra"] > 0) == (variant == "chain_qp" and device != "cpu")
        )
        _say(
            "bench_nonfused", env=env, kinds=kinds, variant=system._variant, rel_err_vs_fused_apply=err,
            tol=NONFUSED_TOL, apply_ms=ms, fused_apply_ms=state["apply_ms"], device_busy_ms=busy_ms,
            device_idle_share=1.0 - busy_ms / ms, top_device_ms_per_apply=top, launches=counts, ok=ok,
        )
        if not ok:
            raise SystemExit(f"chip_smoke: the non-fused bench apply ({variant}) failed its checks")
        if variant == "chain_qp":
            qp_launches = counts["qp_algebra"]
        del system, fn, consts, y
    return qp_launches


def _nodal_T_err(system, mesh) -> float:
    X = system.x[:, 0].reshape(-1, 3).double().cpu().numpy()
    return float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())


def phase_lattice_2d(lp, device: str = "cuda", n: int = L2D_N, order: int = L2D_ORDER,
                     small=(5, 3)) -> int:
    """The reference's Diffusion2D problem on ``make_square_mesh`` at p = 6 on
    128^2 quads, f32, AUTO (``lattice_sf_const``, the non-fused chain, with
    ``direct`` faces): the f32 apply against the f64 one on the card, a small
    f64 system on the card against the CPU path, apply time, device-busy
    time, idle share and the costliest kernels; the same system under
    ``L3STER_TPU_LATTICE_PALLAS_QP=1`` (the per-QP kernel on the lattice
    layout) against the default, its time and launches (the count set to 0
    just before it is built); then CG + LowOrderMG and CG + Jacobi to 1e-6
    with nodal |T - x| and true residuals.  Returns the per-QP launches."""
    import torch

    from l3ster_tpu_torch.ops import qp

    cpu = torch.device(device).type == "cpu"
    sm = _square(lp, *small)
    sg, sc = _build_2d(lp, sm, torch.float64, device), _build_2d(lp, sm, torch.float64, "cpu")
    xs = torch.as_tensor(np.random.default_rng(21).normal(size=(sc.n_dofs, 1)))
    ys = sc.operator()(xs)
    small_err = float((sg.operator()(xs.to(device)).cpu() - ys).abs().max() / ys.abs().max())
    del sg, sc
    t0 = time.perf_counter()
    mesh = _square(lp, n, order)
    mesh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    s64 = _build_2d(lp, mesh, torch.float64, device)
    x64 = torch.as_tensor(np.random.default_rng(22).normal(size=(s64.n_dofs, 1)), device=device)
    f64, c64 = s64.operator_parts(layout="lattice")
    y64 = f64(s64.to_lattice_layout(x64), *c64)
    _sync(device)
    setup64_s = time.perf_counter() - t0
    del s64, f64, c64
    t0 = time.perf_counter()
    system = _build_2d(lp, mesh, torch.float32, device)
    kinds = [d[0] for _, d in system._operators()[1]]
    fn, consts = system.operator_parts(layout="lattice")
    xl = system.to_lattice_layout(x64.float())
    y32 = fn(xl, *consts)
    _sync(device)
    setup_s = time.perf_counter() - t0
    err = float((y32.double() - y64).abs().max() / y64.abs().max())
    del y64, x64
    ms = _cuda_ms(lambda: fn(xl, *consts))
    busy_ms, top = _profile_apply(lambda v: fn(v, *consts), xl)
    q1 = lp.AssemblyOptions().quadrature_order(order) // 2 + 1
    ok = (
        kinds == ["lattice_sf_const", "direct", "direct"] and system._variant == "chain"
        and system.lattice_layout_key() is not None and bool(torch.isfinite(y32).all())
        and err < F32_APPLY_TOL and small_err < F64_APPLY_TOL
    )
    _say(
        "lattice_2d_apply", order=order, n_elements=(n - 1) ** 2, n_nodes=mesh.n_nodes, n_dofs=system.n_dofs,
        n_qp=(n - 1) ** 2 * q1 * q1, kinds=kinds, variant=system._variant, dtype="float32", mesh_s=mesh_s,
        setup_s=setup_s, f64_setup_s=setup64_s, rel_err_vs_f64_on_card=err, tol=F32_APPLY_TOL,
        small_f64_rel_err_vs_cpu=small_err, small_tol=F64_APPLY_TOL, apply_ms=ms, device_busy_ms=busy_ms,
        device_idle_share=1.0 - busy_ms / ms, top_device_ms_per_apply=top, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the 2D lattice apply failed its checks")

    qp.launch_count = 0  # the per-QP kernel's 2D lattice path starts here
    sq, fq, cq, yq = _apply_with_env(
        lp, lambda: _build_2d(lp, mesh, torch.float32, device), {"L3STER_TPU_LATTICE_PALLAS_QP": "1"}, xl
    )
    _sync(device)
    qerr = float((yq - y32).abs().max() / y32.abs().max())
    qms = _cuda_ms(lambda: fq(xl, *cq))
    qbusy, qtop = _profile_apply(lambda v: fq(v, *cq), xl)
    launches = qp.launch_count
    ok = sq._variant == "chain_qp" and qerr < NONFUSED_TOL and (cpu or launches > 0)
    _say(
        "lattice_2d_apply_qp_kernel", env="L3STER_TPU_LATTICE_PALLAS_QP=1", variant=sq._variant,
        rel_err_vs_default_apply=qerr, tol=NONFUSED_TOL, apply_ms=qms, default_apply_ms=ms,
        device_busy_ms=qbusy, device_idle_share=1.0 - qbusy / qms, top_device_ms_per_apply=qtop,
        qp_launches=launches, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the 2D lattice apply with the per-QP kernel failed its checks")
    del sq, fq, cq, yq, y32, xl
    if not cpu:
        torch.cuda.empty_cache()

    res = {}
    for name, precond in (("LowOrderMG", lp.LowOrderMG()), ("Jacobi", lp.Jacobi())):
        system.set_solution_vector(torch.zeros_like(system.x))
        _sync(device)
        t0 = time.perf_counter()
        r = system.solve(lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=precond))
        _sync(device)
        res[name] = dict(
            iterations=r.num_iters, converged=r.converged, solve_s=time.perf_counter() - t0,
            achieved_rel_residual=r.tol, true_rel_residual=_true_residual(system),
            max_nodal_err_T_minus_x=_nodal_T_err(system, mesh),
        )
    mg, jac = res["LowOrderMG"], res["Jacobi"]
    ok = mg["converged"] and jac["converged"] and mg["iterations"] < jac["iterations"]
    _say(
        "lattice_2d_solve", dtype="float32", tol=CG_TOL, n_dofs=system.n_dofs,
        **{f"cg_{k}": v for k, v in res.items()}, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the 2D lattice solves failed their checks")
    return launches


def _advection_periodic(lp, nx, ny, order, dtype, device, tol, n_steps=PER_STEPS):
    """``examples/advection_periodic.py``: a Gaussian pulse advected across
    the periodic x-direction of [-0.5, 0.5] x [0, 0.5] with BDF3, DT 0.025,
    matrix-free, CG + Jacobi to ``tol``.  Returns (system, manager, newest
    slot, normalized L2 error in %, per-step seconds and iterations)."""
    import torch

    NX, NY = np.linspace(-0.5, 0.5, nx), np.linspace(0.0, 0.5, ny)
    W, H = NX[-1] - NX[0], NY[-1] - NY[0]
    from l3ster_tpu_torch.models.kernels import advection_bdf_2d

    def analytic(inp, out):
        x_dv = (inp.point.x - inp.point.time - NX[0]) % W + NX[0]
        out[0] = torch.exp(-10.0 * x_dv * x_dv)

    mesh = lp.generate_mesh(lp.make_square_mesh(NX, NY), order=order)
    problem = lp.ProblemDefinition(1, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_periodic([3], [4], [W, 0.0, 0.0])
    bcs.define_dirichlet([1, 2])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    init_k = advection_bdf_2d((1.0, 0.0), PER_DT, 11.0 / 6.0, (3.0, -1.5, 1.0 / 3.0))
    eval_k = advection_bdf_2d((1.0, 0.0), PER_DT, 11.0 / 6.0, ())
    sol_k = lp.wrap_domain_residual_kernel(analytic, lp.KernelParams(dimension=2, n_equations=1))
    sol_bc = lp.wrap_boundary_residual_kernel(analytic, lp.KernelParams(dimension=2, n_equations=1))
    hist = [0, 1, 2]
    manager = lp.SolutionManager(mesh, 3, device=device)
    for i in hist:
        manager.set_fields_from_kernel(sol_k, [0], [i], time=-PER_DT * i)
        manager.set_fields_from_kernel(sol_bc, [1, 2, 3, 4], [i], time=-PER_DT * i)
    solver = lp.CG(lp.IterSolverOpts(tol=tol, max_iters=CG_MAX_ITERS), precond=lp.Jacobi())
    steps = []
    for step in range(1, n_steps + 1):
        _sync(device)
        t0 = time.perf_counter()
        system.set_dirichlet_bc_values(sol_bc, [1, 2], [0], time=step * PER_DT)
        system.begin_assembly()
        system.init_problem(init_k, [0], manager.field_access(hist))
        system.define_operator(eval_k, [0])
        system.end_assembly()
        r = system.solve(solver)
        system.update_solution([0], manager, [hist[-1]])
        hist = [hist[-1]] + hist[:-1]
        _sync(device)
        if not r.converged:
            raise SystemExit(f"chip_smoke: periodic advection step {step} did not converge")
        steps.append((time.perf_counter() - t0, r.num_iters))

    def err_kernel(inp, out):
        analytic(inp, out)
        out[0] = inp.field_vals[0] - out[0]

    ek = lp.wrap_domain_residual_kernel(err_kernel, lp.KernelParams(dimension=2, n_equations=1, n_fields=1))
    e = float(lp.compute_norm_l2(ek, mesh, [0], manager.field_access([hist[0]]), time=n_steps * PER_DT)[0, 0])
    return system, manager, hist[0], e / (W * H) * 100.0, steps


def phase_periodic(lp, device: str = "cuda", nx: int = PER_NX, ny: int = PER_NY, out_dir: str = "results") -> int:
    """The periodic advection example refined to 256 x 128 quads at p = 4
    (525,825 nodes, 525,312 dofs after aliasing), f32, one period of 40 BDF3
    steps with CG + Jacobi to ``PER_CG_TOL``: under the example's 5% normalized L2
    error, s/step and iterations; the example's own size (8 x 4 quads) in
    f64 on the card against the CPU path after the period (CG to 1e-13);
    then the final field exported with ``PvtuExporter`` (parsed back: 16
    subcells a p = 4 quad) and saved and loaded with ``save``/``load``
    (equal to the saved field).  Returns the per-QP kernel's launches over
    the period (``dense_const``: one an operator apply)."""
    import os
    import tempfile
    import xml.etree.ElementTree as ET

    import torch

    from l3ster_tpu_torch.ops import qp

    t0 = time.perf_counter()
    qp.launch_count = 0  # the periodic cell's path starts here
    system, man, slot, err_pct, steps = _advection_periodic(lp, nx, ny, PER_ORDER, torch.float32, device, PER_CG_TOL)
    launches = qp.launch_count
    total_s = time.perf_counter() - t0
    kinds = [d[0] for _, d in system._operators()[1]]
    step_s = [s for s, _ in steps]
    iters = [i for _, i in steps]
    small = {}
    for dev in (device, "cpu"):
        _, m, sl, e, _ = _advection_periodic(lp, 9, 5, PER_ORDER, torch.float64, dev, 1e-13)
        small[dev] = (m.values[:, sl].cpu(), e)
    f64_diff = float((small[device][0] - small["cpu"][0]).abs().max())

    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t1 = time.perf_counter()
        d = lp.ExportDefinition(os.path.join(tmp, "advection.pvtu")).define_field("u", [slot])
        lp.PvtuExporter(man.mesh).export_solution(d, man)
        export_s = time.perf_counter() - t1
        piece = next(ET.parse(os.path.join(tmp, "advection.vtu")).getroot().iter("Piece"))
        n_cells, n_points = int(piece.get("NumberOfCells")), int(piece.get("NumberOfPoints"))
        ET.parse(d.path)
        path = lp.save(os.path.join(tmp, "advection"), man.mesh, man, field_names=["u0", "u1", "u2"])
        mesh2, man2 = lp.load(path, device=device)
        same = bool(torch.equal(man2.values, man.values)) and mesh2.n_nodes == man.mesh.n_nodes
        ckpt_bytes = os.path.getsize(path)
    n_quads = (nx - 1) * (ny - 1)
    ok = bool(
        err_pct < PER_ERR_PCT and f64_diff < PER_F64_TOL and n_cells == 16 * n_quads
        and n_points == man.mesh.n_nodes and same and (launches > 0 or device == "cpu")
    )
    _say(
        "periodic", n_quads=n_quads, order=PER_ORDER, n_nodes=int(man.mesh.n_nodes), n_dofs=system.n_dofs,
        kinds=kinds, dtype="float32", dt=PER_DT, steps=len(steps), cg_tol=PER_CG_TOL, l2_err_pct=err_pct,
        err_bound_pct=PER_ERR_PCT,
        total_s=total_s, s_per_step_median=statistics.median(step_s), s_per_step_max=max(step_s),
        iterations_median=statistics.median(iters), iterations_max=max(iters),
        small_f64_card_vs_cpu_max_abs=f64_diff, small_tol=PER_F64_TOL,
        small_l2_err_pct=[small[device][1], small["cpu"][1]], vtu_cells=n_cells, vtu_points=n_points,
        export_s=export_s, checkpoint_bytes=ckpt_bytes, checkpoint_round_trip_equal=same, qp_launches=launches, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the periodic advection phase failed its checks")
    return launches


def _write_gmsh_v4_square(path: str, n: int) -> None:
    """A Gmsh 4.1 ASCII file of an n x n quad square on [0, 1]^2: physical
    curves 1-4 (bottom, top, left, right) and the physical surface 10."""
    N = n + 1
    xs = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    tag = lambda i, j: j * N + i + 1  # noqa: E731
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    quads = np.stack([tag(i, j), tag(i + 1, j), tag(i + 1, j + 1), tag(i, j + 1)], -1).reshape(-1, 4)
    k = np.arange(n)
    curves = {  # curve tag: its segments
        1: np.stack([tag(k, 0), tag(k + 1, 0)], 1),
        2: np.stack([tag(k, n), tag(k + 1, n)], 1),
        3: np.stack([tag(0, k), tag(0, k + 1)], 1),
        4: np.stack([tag(n, k), tag(n, k + 1)], 1),
    }
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities", "0 4 1 0",
             "1 0 0 0 1 0 0 1 1 0", "2 0 1 0 1 1 0 1 2 0", "3 0 0 0 0 1 0 1 3 0", "4 1 0 0 1 1 0 1 4 0",
             "1 0 0 0 1 1 0 1 10 4 1 2 3 4", "$EndEntities", "$Nodes", f"1 {N * N} 1 {N * N}", f"2 1 0 {N * N}"]
    lines += [str(t) for t in range(1, N * N + 1)]
    lines += [f"{float(x)!r} {float(y)!r} 0" for x, y in zip(X.reshape(-1), Y.reshape(-1))]
    n_el = len(quads) + 4 * n
    lines += ["$EndNodes", "$Elements", f"5 {n_el} 1 {n_el}"]
    e = 1
    for c, segs in curves.items():
        lines.append(f"1 {c} 1 {len(segs)}")
        for s in segs:
            lines.append(f"{e} {s[0]} {s[1]}")
            e += 1
    lines.append(f"2 1 3 {len(quads)}")
    for q in quads:
        lines.append(f"{e} {q[0]} {q[1]} {q[2]} {q[3]}")
        e += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def phase_gmsh(lp, device: str = "cuda", n: int = GMSH_N, out_dir: str = "results") -> None:
    """A Gmsh 4.1 ASCII file of a 64^2 quad square with physical boundary
    groups, read with ``read_gmsh``, promoted to p = 4, and the Diffusion2D
    T = x problem solved on it in f32 (CG + Jacobi to 1e-6): nodal
    |T - x| < 1e-3."""
    import os
    import tempfile

    import torch

    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        path = os.path.join(tmp, "square.msh")
        _write_gmsh_v4_square(path, n)
        t0 = time.perf_counter()
        base = lp.read_gmsh(path, boundary_ids=[1, 2, 3, 4])
        read_s = time.perf_counter() - t0
    mesh = lp.generate_mesh(base, order=GMSH_ORDER)
    system = _build_2d(lp, mesh, torch.float32, device, domain=10)
    kinds = [d[0] for _, d in system._operators()[1]]
    _sync(device)
    t0 = time.perf_counter()
    r = system.solve(lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=lp.Jacobi()))
    _sync(device)
    solve_s = time.perf_counter() - t0
    err = _nodal_T_err(system, mesh)
    ok = bool(r.converged and err < GMSH_NODAL_TOL and base.domains[10][0].n_elements == n * n)
    _say(
        "gmsh", format="MSH 4.1 ASCII", n_quads=n * n, order=GMSH_ORDER, n_dofs=system.n_dofs, kinds=kinds,
        read_s=read_s, iterations=r.num_iters, converged=r.converged, solve_s=solve_s,
        true_rel_residual=_true_residual(system), max_nodal_err_T_minus_x=err, tol=GMSH_NODAL_TOL, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the Gmsh phase failed its checks")


def phase_inverse(lp, device: str = "cuda", n: int = INV_N, order: int = INV_ORDER) -> None:
    """``examples/inverse_diffusion_2d.py``'s source identification on 32^2
    quads at p = 4, f64: T = 0 on left/right, adiabatic top/bottom, the
    source a combination of three Gaussian bumps; observe T, recover theta.
    Each T(theta) is ``linear_solve`` on the assembled system's
    ``operator_parts()`` (CG + Jacobi to ``INV_CG_TOL``, each forward solve
    from the last one's solution: x0 changes the path, not the answer); the
    gradient at theta = 0 against central differences (the loss is quadratic
    in theta, so they are exact up to the solves' rounding), then
    ``torch.optim.LBFGS`` from zero.  The system is assembled where the
    example's is matrix-free: on the card the matrix-free 2D chain's solves
    are host-bound (CG + LowOrderMG to 1e-10, 8.9 s a solve on the H100),
    and the phase took 220 s so."""
    import torch

    mesh = _square(lp, n, order)
    problem = lp.ProblemDefinition(3, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.GLOBAL_ASSEMBLY)
    system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=torch.float64, device=device)
    system.set_dirichlet_bc_values(0.0, [3, 4], [0])

    def source_kernel(cx, cy):
        def kern(inp, out):
            _diffusion_2d(inp, out)
            _, rhs = out
            rhs[0] = -torch.exp(-40.0 * ((inp.point.x - cx) ** 2 + (inp.point.y - cy) ** 2))

        return lp.wrap_domain_equation_kernel(kern, lp.KernelParams(2, 4, 3))

    basis = []
    t0 = time.perf_counter()
    for cx, cy in INV_CENTERS:
        system.begin_assembly()
        system.assemble_problem(source_kernel(cx, cy), [0])
        system.assemble_problem(lp.wrap_boundary_equation_kernel(_adiabatic_2d, lp.KernelParams(2, 1, 3)), [1, 2])
        system.end_assembly()
        basis.append(system.effective_rhs())
    _sync(device)
    build_s = time.perf_counter() - t0  # three assemblies
    B = torch.stack(basis)  # (3, n_dofs, 1)
    fn, consts = system.operator_parts()
    M_fn, M_consts = lp.Jacobi().setup_parts(system)
    t_dofs = torch.arange(system.n_dofs // 3, device=device) * 3  # T: unknown 0 of each node
    solves = [0]
    last = {}  # the last forward solution: the next forward solve starts from it

    def forward(theta, x0=None):
        solves[0] += 1
        b = torch.tensordot(theta, B, dims=1)
        x0 = last.get("u") if x0 is None else x0
        u = lp.linear_solve(
            fn, consts, b, x0=x0, precond=M_fn, precond_consts=M_consts, tol=INV_CG_TOL, max_iters=20000
        )
        last["u"] = u.detach()
        return u[t_dofs, 0]

    t_obs = forward(torch.tensor(INV_THETA, dtype=torch.float64, device=device)).detach()

    def loss(theta, x0=None):
        return torch.sum((forward(theta, x0) - t_obs) ** 2)

    t0 = time.perf_counter()
    th = torch.zeros(3, dtype=torch.float64, device=device, requires_grad=True)
    (g,) = torch.autograd.grad(loss(th), th)
    grad_s = time.perf_counter() - t0
    h = 0.1
    fd = []
    with torch.no_grad():
        for e in torch.eye(3, dtype=torch.float64, device=device):
            plus = loss(h * e)
            fd.append((plus - loss(-h * e, x0=-last["u"])) / (2 * h))  # u(-h e) = -u(h e): a warm start
    fd = torch.stack(fd)
    grad_err = float((g - fd).abs().max() / fd.abs().max())

    theta = torch.zeros(3, dtype=torch.float64, device=device, requires_grad=True)
    opt = torch.optim.LBFGS([theta], lr=1.0, max_iter=10, tolerance_grad=1e-9, tolerance_change=1e-12,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        val = loss(theta)
        val.backward()
        return val

    t0 = time.perf_counter()
    opt.step(closure)
    fit_s = time.perf_counter() - t0
    theta_err = float((theta.detach().cpu() - torch.tensor(INV_THETA, dtype=torch.float64)).abs().max())
    ok = grad_err < INV_GRAD_TOL and theta_err < INV_THETA_TOL
    _say(
        "inverse", n_quads=(n - 1) ** 2, order=order, n_dofs=system.n_dofs, system=type(system).__name__,
        nnz=system.nnz, dtype="float64",
        grad_at_0=g.tolist(), central_diff=fd.tolist(), grad_rel_err=grad_err, grad_tol=INV_GRAD_TOL,
        build_s=build_s, grad_s=grad_s, theta=theta.detach().cpu().tolist(), theta_true=list(INV_THETA),
        theta_max_err=theta_err,
        theta_tol=INV_THETA_TOL, cg_tol=INV_CG_TOL, lbfgs_s=fit_s, forward_solves=solves[0], ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the inverse problem failed its checks")


# ------------------------------------------------------------------- Karman 2D

# The reference's Strouhal validation configuration (``examples/karman_2d.py``
# ``strouhal_study(refine=2, mesh_order=3, matrix_free=True)``, run by
# ``benchmarks/run_validation.py:31-80``): Re = 100, dt = 0.15, walls at
# y = -2.0 and +2.1, the channel mesh doubled in each direction.
KARMAN_Y = (-2.0, 2.1)
KARMAN_RE, KARMAN_DT, KARMAN_ORDER = 100.0, 0.15, 3
# The Picard sweeps take the reference's restart settings (tol 1e-6, cap
# 6,000, chunk 1,024; examples/karman_2d.py:233) with a PMultigrid(lag="auto")
# of their own, as strouhal_study's ``warm_solver`` allows, not the stepper's
# (a lagged setup of the steady operator would precondition the transient
# one).  With the reference's Jacobi, 5 of 8 sweeps hit the cap in f32 at this
# size, in the reference as in the port: each restart resumes from the true
# residual, which f32 keeps above 1e-6 (an H100; and on the CPU,
# tools/karman_picard_witness.py, PERF.md §6).
KARMAN_PICARD_TOL, KARMAN_PICARD_ITERS, KARMAN_PICARD_CHUNK = 1e-6, 6000, 1024
KARMAN_STEP_TOL, KARMAN_STEP_ITERS, KARMAN_STEP_CHUNK = 1e-6, 4000, 256
KARMAN_JACOBI_ITERS = 20000  # the CG + Jacobi comparison solve
# f32 against f64 over the first BDF2 step, from the same fields: max abs
# difference of the new fields over the largest |f64 value|.  The f32 solve
# stops at a relative residual of 1e-6 (the f64 one at 1e-10) and its true
# residual sits near 7e-6 (f32 rounding), so the step carries a solve error
# of that order times the preconditioned operator's amplification; three H100
# runs read 1.3e-5 to 5.6e-5, and the bound is 4.5 times the largest (PERF.md §2)
KARMAN_F32_TOL = 2.5e-4
KARMAN_DIST_STEPS, KARMAN_DIST_SHARDS = 3, 4  # the distributed stepping: 3 BDF2 steps on 4 shards
DOMAIN, BOTTOM, TOP, INLET, OUTLET, CYLINDER = 0, 1, 2, 3, 4, 5


def karman_mesh_kw(refine: int = 2) -> dict:
    """``make_cylinder_in_channel_2d`` arguments of ``strouhal_study(refine=...)``."""
    rf = int(refine)
    return dict(
        r_outer=1.2, left_offset=2.0, right_offset=10.0, bottom_offset=-KARMAN_Y[0], top_offset=KARMAN_Y[1],
        n_circumf=32 * rf, n_radial=7 * rf, n_left=3 * rf, n_right=17 * rf, n_bottom=3 * rf, n_top=3 * rf,
        q_radial=1.28 ** (1.0 / rf), q_right=1.06 ** (1.0 / rf),
    )


def karman_setup(lp, dtype, device, mesh_kw=None, order: int = KARMAN_ORDER, mesh=None, n_shards: int = 0) -> dict:
    """The Strouhal study's matrix-free system (on ``n_shards`` shards of a
    DistributedSystem when given), kernels and solution manager (six slots:
    u, v at two time levels, vorticity, pressure)."""
    from l3ster_tpu_torch.models.kernels import flow_rate_bc, navier_stokes_outlet_bc, navier_stokes_uvop_2d

    if mesh is None:
        mesh = lp.generate_mesh(lp.make_cylinder_in_channel_2d(**(mesh_kw or karman_mesh_kw())), order=order)
    problem = lp.ProblemDefinition(4, [DOMAIN])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([INLET, BOTTOM, TOP, CYLINDER], [0, 1])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    if n_shards:
        system = lp.make_distributed_system(mesh, problem, bcs, params, n_shards=n_shards, dtype=dtype, device=device)
    else:
        system = lp.make_algebraic_system(mesh, problem, bcs, params, dtype=dtype, device=device)
    nu = 1.0 / KARMAN_RE
    y_b, y_t = KARMAN_Y

    def inlet_profile(inp, out):
        # parabola vanishing at both walls, mean velocity 1 over the channel
        y = inp.point.y
        out[0] = 6.0 * (y - y_b) * (y_t - y) / (y_t - y_b) ** 2
        out[1] = 0.0

    k_inlet = lp.wrap_boundary_residual_kernel(inlet_profile, lp.KernelParams(dimension=2, n_equations=2))
    system.set_dirichlet_bc_values([0.0, 0.0], [BOTTOM, TOP, CYLINDER], [0, 1])
    system.set_dirichlet_bc_values(k_inlet, [INLET], [0, 1])
    return dict(
        mesh=mesh, system=system, manager=lp.SolutionManager(mesh, 6, device=device),
        k_steady=navier_stokes_uvop_2d(nu), k_trans=navier_stokes_uvop_2d(nu, dt=KARMAN_DT),
        k_outlet=navier_stokes_outlet_bc(nu), k_flow=flow_rate_bc(),
        opts=lp.AssemblyOptions(value_order=1, derivative_order=1),
        vel1=[0, 1], vel2=[2, 3], x_prev=None,
    )


def karman_assemble(st: dict, steady: bool) -> None:
    """Assemble the steady (Picard) or the BDF2 operator from the current fields."""
    system, man = st["system"], st["manager"]
    system.begin_assembly()
    if steady:
        system.assemble_problem(st["k_steady"], [DOMAIN], man.field_access(st["vel1"]), options=st["opts"])
    else:
        system.assemble_problem(st["k_trans"], [DOMAIN], man.field_access(st["vel1"] + st["vel2"]), options=st["opts"])
    system.assemble_problem(st["k_outlet"], [OUTLET], dof_inds=(0, 1, 3))
    system.end_assembly()


def karman_picard(lp, st: dict, n: int = 8) -> list:
    """The steady Picard iterations with CG + PMultigrid(lag="auto"), an
    instance of their own; returns one record per solve: iterations, CG's
    recursive relative residual and the true one, ||b - A x|| / ||b|| in the
    system's dtype, converged, capped, and the PMultigrid refreshes so far."""
    pmg = lp.PMultigrid(lag="auto")
    opts = lp.IterSolverOpts(tol=KARMAN_PICARD_TOL, max_iters=KARMAN_PICARD_ITERS, chunk=KARMAN_PICARD_CHUNK)
    solver = lp.CG(opts, precond=pmg)
    system, results = st["system"], []
    for _ in range(n):
        karman_assemble(st, steady=True)
        r = system.solve(solver)
        b = system.effective_rhs()
        true_res = float((b - system.operator()(system.solution_vector())).norm() / b.norm())
        results.append(dict(iterations=r.num_iters, cg_rel_residual=r.tol, true_rel_residual=true_res,
                            converged=r.converged, capped=r.capped,
                            refreshes=system._pmg_static_cache[pmg]["refreshes"]))
        system.update_solution([0, 1], st["manager"], st["vel1"])
    system.update_solution([0, 1, 2, 3], st["manager"], st["vel2"] + [4, 5])
    return results


def karman_step_solver(lp, precond):
    return lp.CG(
        lp.IterSolverOpts(tol=KARMAN_STEP_TOL, max_iters=KARMAN_STEP_ITERS, chunk=KARMAN_STEP_CHUNK), precond=precond
    )


def karman_predict(st: dict) -> None:
    """Assemble the BDF2 operator and set the predictor start x0 = 2 u_n - u_{n-1}
    (Dirichlet rows are constant in time, so the extrapolation keeps them)."""
    karman_assemble(st, steady=False)
    system = st["system"]
    x_cur = system.solution_vector()
    if st["x_prev"] is not None:
        system.set_solution_vector(2.0 * x_cur - st["x_prev"])
    st["x_prev"] = x_cur


def karman_finish_step(st: dict) -> None:
    """Copy the step's solution into the older velocity slots, vorticity and
    pressure, then swap the time levels."""
    st["system"].update_solution([0, 1, 2, 3], st["manager"], st["vel2"] + [4, 5])
    st["vel1"], st["vel2"] = st["vel2"], st["vel1"]


def karman_flows(lp, st: dict) -> tuple[float, float]:
    """(inflow, outflow): the flux of the newest velocity through inlet and outlet."""
    access = st["manager"].field_access(st["vel1"])
    inflow = -float(lp.compute_integral(st["k_flow"], st["mesh"], [INLET], access)[0, 0])
    outflow = float(lp.compute_integral(st["k_flow"], st["mesh"], [OUTLET], access)[0, 0])
    return inflow, outflow


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_karman(lp, device: str = "cuda", mesh_kw=None, order: int = KARMAN_ORDER, n_settle: int = 3,
                 n_timed: int = 10, jacobi_step: int = 5) -> dict:
    """The Karman 2D transient stack at the reference's Strouhal validation
    size (80,880 dofs, f32, matrix-free, AUTO -> the field-coupled ``dense``
    kind): 8 Picard solves with CG + a PMultigrid(lag="auto") of their own,
    then ``n_settle`` settling and ``n_timed`` timed BDF2 steps with CG +
    PMultigrid(lag="auto") from the predictor start.  Reports s/step, iterations per step, the PMultigrid
    refreshes and one refresh's split, one V-cycle's time and idle share,
    the true residual beside CG's, the flow rates; on timed step
    ``jacobi_step`` the same operator is also solved with CG + Jacobi from
    the same start.  The first BDF2 step is repeated in f64 on the same
    device from the same fields (to a relative residual of 1e-10).  Fails
    unless every solve converged without hitting its cap, all fields are finite, PMultigrid takes at most a
    quarter of Jacobi's iterations, and f32 agrees with f64 to KARMAN_F32_TOL.
    Returns the post-Picard state (mesh, fields, solution) with the first
    ``KARMAN_DIST_STEPS`` steps' iterations and the fields after them, for
    ``phase_karman_distributed``."""
    import torch

    from l3ster_tpu_torch.solve.krylov import _precond_parts

    t_start = time.perf_counter()
    st = karman_setup(lp, torch.float32, device, mesh_kw, order)
    system, man = st["system"], st["manager"]
    setup_s = time.perf_counter() - t_start
    _sync(device)
    t0 = time.perf_counter()
    picard = karman_picard(lp, st)
    _sync(device)
    picard_s = time.perf_counter() - t0
    kinds = [d[0] for _, d in system._operators()[1]]
    fields0 = man.values.clone()
    x0 = system.solution_vector().clone()

    pmg = lp.PMultigrid(lag="auto")
    solver = karman_step_solver(lp, pmg)
    # the refresh counter sits in PMultigrid's per-system cache, keyed by the
    # (equal) configuration, so it also counts the Picard sweeps' refreshes
    refreshes0 = picard[-1]["refreshes"]
    steps, refresh_split = [], None
    jac = None
    for k in range(n_settle + n_timed):
        _sync(device)
        t0 = time.perf_counter()
        karman_predict(st)
        x_start = system.solution_vector()
        r = system.solve(solver)
        karman_finish_step(st)
        _sync(device)
        step_s = time.perf_counter() - t0
        cache = system._pmg_static_cache[pmg]
        refreshed = cache["refreshes"] - refreshes0 > sum(s["refreshed"] for s in steps)
        if refreshed and refresh_split is None:
            refresh_split = dict(cache["last_refresh"])
        steps.append(dict(step=k + 1, s=step_s, iterations=r.num_iters, converged=r.converged,
                          capped=r.capped, refreshed=bool(refreshed)))
        if k == 0:
            v32 = man.values[:, st["vel1"] + [4, 5]].clone()
        if k == KARMAN_DIST_STEPS - 1:
            fields_after = man.values.clone()
        if k == n_settle + jacobi_step - 1:
            # the same operator and start with CG + Jacobi; the trajectory keeps PMultigrid's x
            b = system.effective_rhs()
            x_pmg = system.solution_vector()
            true_res = float((b - system.operator()(x_pmg)).norm() / b.norm())
            M_fn, M_consts = _precond_parts(pmg, system)
            r_host = np.random.default_rng(41).normal(size=(system.n_dofs, 1))
            rv = torch.as_tensor(r_host, dtype=system.dtype, device=device)
            vcycle_ms = _cuda_ms(lambda: M_fn(rv, *M_consts), reps=10, batch=5)
            busy_ms, top = _profile_apply(lambda v: M_fn(v, *M_consts), rv, n=5)
            system.set_solution_vector(x_start)
            _sync(device)
            t1 = time.perf_counter()
            # one unrestarted CG, as the reference's bar runs it (tests/test_pmg.py:121-176)
            opts = lp.IterSolverOpts(tol=KARMAN_STEP_TOL, max_iters=KARMAN_JACOBI_ITERS)
            rj = system.solve(lp.CG(opts, precond=lp.Jacobi()))
            _sync(device)
            jac = dict(step=k + 1, pmg_iterations=r.num_iters, jacobi_iterations=rj.num_iters,
                       jacobi_converged=rj.converged, jacobi_capped=rj.capped,
                       jacobi_s=time.perf_counter() - t1, ratio=rj.num_iters / max(r.num_iters, 1),
                       true_rel_residual=true_res, cg_rel_residual=r.tol, vcycle_ms=vcycle_ms,
                       vcycle_device_busy_ms=busy_ms, vcycle_device_idle_share=1.0 - busy_ms / vcycle_ms,
                       vcycle_top_device_ms=top)
            system.set_solution_vector(x_pmg)
    inflow, outflow = karman_flows(lp, st)
    finite = bool(torch.isfinite(man.values).all())
    timed = [s["s"] for s in steps[n_settle:]]

    # the first BDF2 step again in f64 on the same device, from the Picard fields
    s64 = karman_setup(lp, torch.float64, device, mesh=st["mesh"], order=order)
    s64["manager"].values = fields0.clone()
    s64["system"].set_solution_vector(x0.double())
    karman_predict(s64)
    opts = lp.IterSolverOpts(tol=1e-10, max_iters=KARMAN_STEP_ITERS, chunk=KARMAN_STEP_CHUNK)
    r64 = s64["system"].solve(lp.CG(opts, precond=lp.PMultigrid(lag="auto")))
    karman_finish_step(s64)
    v64 = s64["manager"].values[:, s64["vel1"] + [4, 5]]
    f32_err = float((v32 - v64).abs().max() / v64.abs().max())
    ok = (
        all(r["converged"] and not r["capped"] for r in picard)
        and all(s["converged"] and not s["capped"] for s in steps)
        and finite and jac is not None and jac["jacobi_converged"]
        and 4 * jac["pmg_iterations"] <= jac["jacobi_iterations"]
        and r64.converged and f32_err <= KARMAN_F32_TOL
    )
    _say(
        "karman", n_dofs=system.n_dofs, n_quads=sum(b.n_elements for _, b in st["mesh"].blocks([DOMAIN])),
        order=order, dtype="float32",
        kinds=kinds, setup_s=setup_s, picard_s=picard_s, picard=picard,
        s_per_step_median=statistics.median(timed), s_per_step_min=min(timed), s_per_step_max=max(timed),
        steps=steps, refreshes=system._pmg_static_cache[pmg]["refreshes"] - refreshes0,
        refresh_steps=[s["step"] for s in steps if s["refreshed"]], refresh_split_s=refresh_split,
        coarse_dofs=system._pmg_static_cache[pmg]["s1"].n_dofs, jacobi_comparison=jac,
        inflow=inflow, outflow=outflow, imbalance_pct=abs(inflow - outflow) / inflow * 100.0,
        finite=finite, f32_vs_f64_first_step_rel=f32_err, f32_tol=KARMAN_F32_TOL,
        first_step_iterations_f32_f64=[steps[0]["iterations"], r64.num_iters], ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the Karman stepping failed its checks")
    return dict(mesh=st["mesh"], fields0=fields0, x0=x0, order=order, fields_after=fields_after,
                iterations=[s["iterations"] for s in steps[:KARMAN_DIST_STEPS]])


# ------------------------------------------------------------------ distribution

DIST_SHARDS = 4  # the distributed phases' shards, all on the one card
DIST_CG_SLACK = 0.02  # f32: the distributed dots sum in another order; CG counts may move by 2%
BOX_MG_SLACK = 2  # CG + box LowOrderMG against the single system's (tests/test_box.py:285-301)
BOX_CASES = ((2, None), (4, None), (4, (2, 2)))  # z slabs and a pencil grid of the bench
KARMAN_DIST_TOL = 2.5e-4  # f32 fields after the distributed steps against the single system's


def _off_owned_zero(dist, v) -> bool:
    return bool((v[dist._owned_mask == 0] == 0).all())


def phase_distributed(lp, state: dict, single_iters: int, device: str = "cuda", n_shards: int = DIST_SHARDS,
                      out_dir: str = "results") -> tuple[int, dict]:
    """The cylinder problem of phases 8-9 on a DistributedSystem of
    ``n_shards`` shards on the card (f32; AUTO: ``dense_const`` buckets with
    the per-QP kernel, ``direct`` faces): a small f64 system on the card
    against the CPU path; the apply against the single system's; apply ms,
    device-busy ms, idle share, the halo exchange's ms; CG + Jacobi from zero
    within DIST_CG_SLACK of the single system's iterations; the sharded
    ``.pvtu`` export of T.  The per-QP kernel's count is set to 0 just before
    the distributed system is built.  Returns (its launches, the system and
    its solution manager)."""
    import os
    import tempfile

    import torch

    from l3ster_tpu_torch.ops import qp

    small = _cylinder_mesh(lp, 2, small=True)
    sg = _build_cylinder(lp, small, "AUTO", torch.float64, device, n_shards=n_shards)
    sc = _build_cylinder(lp, small, "AUTO", torch.float64, "cpu", n_shards=n_shards)
    xs = sc._to_stacked(torch.as_tensor(np.random.default_rng(5).normal(size=(sc.n_dofs, 1))))
    fc, cc = sc.operator_parts()
    fg, cg = sg.operator_parts()
    small_err = _rel(fg(xs.to(device), *cg), fc(xs, *cc))
    del sg, sc

    single, mesh = state["system"], state["mesh"]
    xg = torch.as_tensor(np.random.default_rng(6).normal(size=(single.n_dofs, 1)), dtype=single.dtype, device=device)
    fs = single.operator()
    y_single = fs(xg)
    single_ms = _cuda_ms(lambda: fs(xg))
    single_busy_ms, _ = _profile_apply(fs, xg)

    qp.launch_count = 0  # the distributed main path starts here
    _sync(device)
    t0 = time.perf_counter()
    dist = _build_cylinder(lp, mesh, "AUTO", torch.float32, device, n_shards=n_shards)
    kinds = [d[0] for _, d, _ in dist._operators()]
    fn, consts = dist.operator_parts()
    x_st = dist._to_stacked(xg)
    y_st = fn(x_st, *consts)
    _sync(device)
    setup_s = time.perf_counter() - t0
    apply_err = _rel(dist._to_global(y_st), y_single)
    ghosts_zero = _off_owned_zero(dist, y_st)
    apply_ms = _cuda_ms(lambda: fn(x_st, *consts))
    busy_ms, top = _profile_apply(lambda v: fn(v, *consts), x_st)
    work = x_st.clone()
    halo_ms = _cuda_ms(lambda: dist._export(dist._import(work)))
    dist.set_solution_vector(torch.zeros_like(dist.x))
    _sync(device)
    t0 = time.perf_counter()
    r = dist.solve(lp.CG(lp.IterSolverOpts(tol=CYL_CG_TOL, max_iters=CYL_CG_MAX_ITERS), precond=lp.Jacobi()))
    _sync(device)
    solve_s = time.perf_counter() - t0
    launches = qp.launch_count
    X = dist._solution_global()[:, 0].reshape(-1, 4)
    err_T = float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max())
    man = lp.SolutionManager(mesh, 4, device=device)
    dist.update_solution([0, 1, 2, 3], man, [0, 1, 2, 3])
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t0 = time.perf_counter()
        lp.PvtuExporter(mesh).export_solution_sharded(
            lp.ExportDefinition(os.path.join(tmp, "cylinder.pvtu")).define_field("T", [0]), man, partition=dist
        )
        export_s = time.perf_counter() - t0
        pieces = sorted(f for f in os.listdir(tmp) if f.endswith(".vtu"))
        export_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
    iters_ok = abs(r.num_iters - single_iters) <= DIST_CG_SLACK * single_iters
    ok = (
        kinds == ["dense_const"] + ["direct"] * 4 and small_err < F64_APPLY_TOL and apply_err < F32_APPLY_TOL
        and ghosts_zero and r.converged and iters_ok and _off_owned_zero(dist, dist.x)
        and len(pieces) == n_shards and launches > 0
    )
    _say(
        "distributed", mesh="make_cylinder_in_channel_3d()", order=CYL_ORDER, n_dofs=dist.n_dofs,
        n_shards=n_shards, n_loc1=dist.n_loc1, halo_width=dist._max_send, neighbor_offsets=dist._n_neighbors,
        owned_per_shard=[len(o) for o in dist._owned], ghost_per_shard=[len(g) for g in dist._ghost],
        kinds=kinds, dtype="float32", setup_s=setup_s, small_f64_rel_err_vs_cpu=small_err,
        small_tol=F64_APPLY_TOL, rel_err_vs_single_apply=apply_err, tol=F32_APPLY_TOL,
        off_owned_slots_zero=ghosts_zero, apply_ms=apply_ms, single_apply_ms=single_ms,
        device_busy_ms=busy_ms, single_device_busy_ms=single_busy_ms, device_idle_share=1.0 - busy_ms / apply_ms,
        top_device_ms_per_apply=top, halo_exchange_ms=halo_ms, iterations=r.num_iters,
        single_iterations=single_iters, slack=DIST_CG_SLACK, converged=r.converged,
        achieved_rel_residual=r.tol, true_rel_residual=_true_residual(dist), solve_s=solve_s,
        ms_per_iteration=solve_s * 1e3 / max(r.num_iters, 1), max_nodal_err_T_minus_x=err_T,
        pvtu_pieces=len(pieces), pvtu_bytes=export_bytes, export_s=export_s, qp_launches=launches, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the distributed phase failed its checks")
    return launches, {"system": dist, "manager": man, "iterations": r.num_iters}


def _multi_devices(n: int, device: str = "cuda") -> list:
    """The placement groups of the multi-device phases: the first min(D, n)
    cards where the machine has D >= 2, else two groups on the one card
    (on the CPU rehearsal, two "cpu" groups)."""
    import torch

    if torch.device(device).type != "cuda":
        return [device, device]
    D = torch.cuda.device_count()
    return [f"cuda:{i}" for i in range(min(D, n))] if D >= 2 else ["cuda:0", "cuda:0"]


def _sync_all() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _wall_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Milliseconds per fn() call on the host clock with every card
    synchronized around the calls (a CUDA event pair times one device's
    stream only)."""
    for _ in range(warm):
        fn()
    _sync_all()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync_all()
    return (time.perf_counter() - t0) * 1e3 / reps


def _busy_by_device(fn, x, n: int = 5) -> dict:
    """Device-busy ms per fn(x) call on each card: torch.profiler's CUDA
    kernel and copy time, summed by device index."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn(x)
        _sync_all()
    busy: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy[e.device_index] = busy.get(e.device_index, 0.0) + e.self_device_time_total / 1e3 / n
    return {f"cuda:{k}": v for k, v in sorted(busy.items())}


def _launched_everywhere(by_device: dict, devices: list) -> bool:
    """Every placement group's card launched the kernel (counts by index)."""
    import torch

    want = {torch.device(d).index or 0 for d in devices if torch.device(d).type == "cuda"}
    return all(by_device.get(i, 0) > 0 for i in want)


def phase_multi_device_distributed(lp, state: dict, dist_state: dict, device: str = "cuda",
                                   n_shards: int = DIST_SHARDS) -> int:
    """``multi_device``, the distributed part: the cylinder of the
    ``distributed`` phase on ``n_shards`` shards placed with ``devices=`` over
    the cards (:func:`_multi_devices`: distinct cards where there are two or
    more, else two groups on the one card), f32, AUTO (``dense_const`` + B2 on
    each group's device).  B2 is first held against its plain version at each
    group's shape on the group's device; then the per-QP kernel's counts are
    set to 0 and the placed system runs: its apply against the one-group
    distributed system's, apply ms and the one group's beside it (host clock,
    every card synchronized), busy ms per card, the halo exchange's ms
    (import and export, the cross-group copies included) beside the one
    group's, CG + Jacobi from zero within DIST_CG_SLACK of the one group's
    iterations.  Fails unless B2 launched on every group's card.  Returns its
    launches."""
    import torch

    from l3ster_tpu_torch.ops import qp

    one, mesh = dist_state["system"], state["mesh"]
    devices = _multi_devices(n_shards, device)
    xg = torch.as_tensor(np.random.default_rng(61).normal(size=(one.n_dofs, 1)), dtype=one.dtype, device=device)
    f1, c1 = one.operator_parts()
    x1 = one._to_stacked(xg)
    y1 = one._to_global(f1(x1, *c1))
    one_ms = _wall_ms(lambda: f1(x1, *c1))
    one_halo_ms = _wall_ms(lambda: one._export(one._import(x1.clone())))
    _sync_all()
    t0 = time.perf_counter()
    placed = _build_cylinder(lp, mesh, "AUTO", torch.float32, device, n_shards=n_shards, devices=devices)
    gops = placed._group_operators()
    _sync_all()
    setup_s = time.perf_counter() - t0
    # B2 at each group's shape on its card, against the plain version (f64)
    b2 = []
    rng = np.random.default_rng(62)
    for g, ops in zip(placed._groups, gops):
        c, d, idx = next(o for o in ops if o[1][0] == "dense_const")
        A, Ji, w = d[1], d[2], d[3]
        E, Q = idx.shape[0], c.tables.n_qp
        G = torch.as_tensor(rng.normal(size=(E, A.shape[2], A.shape[0], Q)), dtype=torch.float32, device=g.device)
        got = qp.qp_algebra_const(A, G, Ji, w)
        ref = qp.qp_algebra_const_plain(A, G.double(), Ji.double(), w.double())
        err, rel = _errs(got, ref)
        b2.append(dict(device=str(g.device), shards=[g.lo, g.hi], E=E, Q=Q, max_abs_err=err, rel_err=rel,
                       ok=rel < F32_KERNEL_TOL))
    qp.launch_count = 0  # the placed main path starts here
    qp.launches_by_device.clear()
    f, cs = placed.operator_parts()
    x = placed._to_stacked(xg)
    y = f(x, *cs)
    err = _rel(placed._to_global(y), y1)
    on_entries = all(p.device == g.device for p, g in zip(y.parts, placed._groups))
    apply_ms = _wall_ms(lambda: f(x, *cs))
    busy = _busy_by_device(lambda v: f(v, *cs), x)
    halo_ms = _wall_ms(lambda: placed._export(placed._import(x.clone())))
    cross = [(xc["imp"].cross_rows, xc["exp"].cross_rows, xc["SI"][0].shape[1]) for xc in placed._xchg]
    cross_bytes = sum((a + b) * w * x.shape[-1] * x.dtype.itemsize for a, b, w in cross)
    placed.set_solution_vector(torch.zeros_like(placed.x))
    _sync_all()
    t0 = time.perf_counter()
    r = placed.solve(lp.CG(lp.IterSolverOpts(tol=CYL_CG_TOL, max_iters=CYL_CG_MAX_ITERS), precond=lp.Jacobi()))
    _sync_all()
    solve_s = time.perf_counter() - t0
    launches, by_device = qp.launch_count, dict(qp.launches_by_device)
    one_iters = dist_state["iterations"]
    X = placed._solution_global()[:, 0].reshape(-1, 4)
    ok = (
        all(b["ok"] for b in b2) and err < F32_APPLY_TOL and on_entries and r.converged
        and abs(r.num_iters - one_iters) <= DIST_CG_SLACK * one_iters and launches > 0
        and _launched_everywhere(by_device, devices)
    )
    _say(
        "multi_device_distributed", devices=devices, distinct_cards=len(set(devices)),
        peer_access=_peer_access(devices), groups=[[g.lo, g.hi, str(g.device)] for g in placed._groups],
        n_dofs=placed.n_dofs, n_shards=n_shards, kinds=[d[0] for _, d, _ in placed._operators()], setup_s=setup_s,
        b2_vs_plain_per_group=b2, rel_err_vs_one_group_apply=err, tol=F32_APPLY_TOL, parts_on_entries=on_entries,
        apply_ms=apply_ms, one_group_apply_ms=one_ms, busy_ms_by_device=busy, halo_exchange_ms=halo_ms,
        one_group_halo_exchange_ms=one_halo_ms, cross_group_copy_ms=halo_ms - one_halo_ms,
        cross_group_rows_per_offset=cross, cross_group_bytes_per_exchange=cross_bytes, iterations=r.num_iters,
        one_group_iterations=one_iters, slack=DIST_CG_SLACK, converged=r.converged, solve_s=solve_s,
        max_nodal_err_T_minus_x=float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max()),
        qp_launches=launches, qp_launches_by_device=by_device, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the multi_device distributed phase failed its checks")
    return launches


def _peer_access(devices: list) -> dict:
    """torch.cuda.can_device_access_peer between the distinct cards used."""
    import torch

    idx = sorted({torch.device(d).index or 0 for d in devices if torch.device(d).type == "cuda"})
    return {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b) for a in idx for b in idx if a != b}


def phase_multi_device_box(lp, state: dict, device: str = "cuda", n_slabs: int = 2) -> int:
    """``multi_device``, the box part: the bench (f32) through
    ``box_parallelize`` at ``n_slabs`` z slabs placed with ``devices=``
    (:func:`_multi_devices`), B1 per shard on its group's card.  The one-group
    box of the same slabs runs first (apply, CG + box LowOrderMG from zero);
    then the z-sweep's counts are set to 0 and the placed box runs: its apply
    against the one group's, apply ms beside it (host clock, every card
    synchronized), busy ms per card, the plane exchanges' ms beside the one
    group's, CG + box LowOrderMG from zero within BOX_MG_SLACK of the one
    group's iterations, nodal T = x.  Fails unless B1 launched on every
    group's card.  Returns its launches."""
    import torch

    from l3ster_tpu_torch.ops import zsweep

    single, mesh = state["system"], state["mesh"]
    devices = _multi_devices(n_slabs, device)
    xg = torch.as_tensor(np.random.default_rng(63).normal(size=(single.n_dofs, 1)), dtype=single.dtype, device=device)
    solver = lambda: lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=lp.LowOrderMG())  # noqa: E731

    def exchange(box, x_st):
        nz, ny, nx = box._n1_loc[2], box._n1_loc[1], box._n1_loc[0]
        x5 = [p.reshape(-1, nz, ny, nx * box._n_unk, 1).clone() for p in box._split(x_st)]
        return lambda: box._export_halo(box._import_halo(x5))

    one = lp.box_parallelize(single, n_shards=n_slabs)
    x1 = one._to_slabs(xg)
    y1 = one._from_slabs(one.operator()(x1))
    one_ms = _wall_ms(lambda: one.operator()(x1))
    one_halo_ms = _wall_ms(exchange(one, x1))
    single.set_solution_vector(torch.zeros_like(single.x))
    r1 = one.solve(solver())
    del one
    zsweep.launch_count = 0  # the placed box starts here
    zsweep.launches_by_device.clear()
    placed = lp.box_parallelize(single, n_shards=n_slabs, devices=devices)
    fn = placed.operator()
    x = placed._to_slabs(xg)
    y = fn(x)
    err = _rel(placed._from_slabs(y), y1)
    parts = y.parts if len(placed._groups) > 1 else [y]
    on_entries = all(p.device == g.device for p, g in zip(parts, placed._groups))
    apply_ms = _wall_ms(lambda: fn(x))
    busy = _busy_by_device(fn, x)
    halo_ms = _wall_ms(exchange(placed, x))
    single.set_solution_vector(torch.zeros_like(single.x))
    _sync_all()
    t0 = time.perf_counter()
    r = placed.solve(solver())
    _sync_all()
    solve_s = time.perf_counter() - t0
    launches, by_device = zsweep.launch_count, dict(zsweep.launches_by_device)
    X = single.x[:, 0].reshape(-1, 4).double().cpu().numpy()
    ok = (
        err < F32_APPLY_TOL and on_entries and r.converged and r1.converged
        and abs(r.num_iters - r1.num_iters) <= BOX_MG_SLACK and launches > 0
        and _launched_everywhere(by_device, devices)
    )
    _say(
        "multi_device_box", devices=devices, distinct_cards=len(set(devices)), peer_access=_peer_access(devices),
        n_slabs=n_slabs, windows_z=placed._nez_real, rel_err_vs_one_group_apply=err, tol=F32_APPLY_TOL,
        parts_on_entries=on_entries, apply_ms=apply_ms, one_group_apply_ms=one_ms, busy_ms_by_device=busy,
        halo_exchange_ms=halo_ms, one_group_halo_exchange_ms=one_halo_ms, cross_group_copy_ms=halo_ms - one_halo_ms,
        mg_iterations=r.num_iters, one_group_mg_iterations=r1.num_iters, slack=BOX_MG_SLACK,
        converged=r.converged, solve_s=solve_s, true_rel_residual=_true_residual(single),
        max_nodal_err_T_minus_x=float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max()),
        zsweep_launches=launches, zsweep_launches_by_device=by_device, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the multi_device box phase failed its checks")
    return launches


def phase_restart(lp, dist_state: dict, device: str = "cuda", n_shards: int = 2, out_dir: str = "results") -> None:
    """A checkpoint of the distributed phase's solution (``save``), loaded back
    (``load``) and set on a DistributedSystem of ``n_shards`` shards built on
    the restored mesh: its global solution must equal the saved one exactly."""
    import os
    import tempfile

    import torch

    dist, man = dist_state["system"], dist_state["manager"]
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        t0 = time.perf_counter()
        path = lp.save(os.path.join(tmp, "cylinder"), dist.mesh, man, field_names=["T", "qx", "qy", "qz"])
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(path)
        t0 = time.perf_counter()
        mesh2, man2 = lp.load(path, device=device)
        load_s = time.perf_counter() - t0
    problem = lp.ProblemDefinition(4, [0])
    bcs = lp.BCDefinition(problem)
    bcs.define_dirichlet([3, 4, 5], [0])
    params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
    t0 = time.perf_counter()
    s2 = lp.make_distributed_system(mesh2, problem, bcs, params, n_shards=n_shards, dtype=dist.dtype, device=device)
    build_s = time.perf_counter() - t0
    nd = torch.as_tensor(s2.dofmap.node_dof, device=device)
    has = nd >= 0
    xg = torch.zeros((s2.n_dofs, 1), dtype=torch.float64, device=device)
    xg[nd[has], 0] = man2.values[:, :4][has]
    s2._set_solution_global(xg)
    exact = bool(np.array_equal(s2._solution_global(), dist._solution_global()))
    ok = exact and s2.n_dofs == dist.n_dofs and _off_owned_zero(s2, s2.x)
    _say(
        "restart", saved_shards=dist.n_shards, loaded_shards=n_shards, n_dofs=s2.n_dofs, checkpoint_bytes=ckpt_bytes,
        save_s=save_s, load_s=load_s, build_s=build_s, solution_equal=exact, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the restart phase failed its checks")


def phase_distributed_assembled(lp, device: str = "cuda", order: int = PRE_ORDER, n_1d: int = PRE_N1D,
                                n_shards: int = DIST_SHARDS) -> None:
    """The preconditioners phase's problem (condensed at p = 4 on 3^3 hexes)
    as a GLOBAL_ASSEMBLY DistributedSystem of ``n_shards`` shards: its
    gathered CSR against the single system's (f64, pattern exactly, values
    within 1e-12), then in f32 CG with Jacobi, SGS (additive Schwarz,
    overlap 1) and BlockJacobi, GMRES with ILUT, and Klu2 on the gathered
    matrix, each from zero (iterations, setup and solve s, true residual;
    beside Jacobi's and BlockJacobi's the single system's iterations, which
    they must match within DIST_CG_SLACK: SGS and ILUT become one-level
    Schwarz, the preconditioners phase has their single-system counts) and
    the nodal T = x error with the recovered interiors.  Fails unless each
    converges and the CSRs agree."""
    import scipy.sparse as sp
    import torch

    t_phase = time.perf_counter()
    _, s64 = _build_system(lp, order, n_1d, torch.float64, device, cond=True)
    _, d64 = _build_system(lp, order, n_1d, torch.float64, device, cond=True, n_shards=n_shards)
    d1, i1, p1, n1 = s64.eliminated_csr()
    A1 = sp.csr_matrix((d1.cpu().numpy(), i1, p1), shape=(n1, n1))
    t0 = time.perf_counter()
    dd, di, dp, dn = d64.gathered_csr()
    gather_s = time.perf_counter() - t0
    pattern_equal = bool(np.array_equal(dp, p1) and np.array_equal(di, i1))
    csr_err = float(np.abs(dd - A1.data).max() / np.abs(A1.data).max()) if pattern_equal else float("inf")
    del s64, d64

    _, single = _build_system(lp, order, n_1d, torch.float32, device, cond=True)
    mesh, dist = _build_system(lp, order, n_1d, torch.float32, device, cond=True, n_shards=n_shards)
    opts = lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS)
    runs = (
        ("CG", "Jacobi", lambda: lp.Jacobi()), ("CG", "SGS(overlap=1)", lambda: lp.SGS(overlap=1)),
        ("CG", "BlockJacobi", lambda: lp.BlockJacobi()),
        ("GMRES", "ILUT", lambda: lp.ILUT()),
    )
    out = []
    for solver_name, name, make in runs:
        cls = lp.CG if solver_name == "CG" else lp.Gmres
        r, setup_s, solve_s = _solve_from_zero(dist, cls(opts, precond=make()), device)
        single_its = None
        if name in ("Jacobi", "BlockJacobi"):
            single_its = _solve_from_zero(single, cls(opts, precond=make()), device)[0].num_iters
        rec = dict(solver=solver_name, precond=name, iterations=r.num_iters, single_iterations=single_its,
                   converged=r.converged, capped=r.capped, achieved_rel_residual=r.tol,
                   true_rel_residual=_true_residual(dist), off_owned_slots_zero=_off_owned_zero(dist, dist.x),
                   setup_s=setup_s, solve_s=solve_s)
        out.append(rec)
        _say("distributed_assembled_solver", n_shards=n_shards, **rec)
    dist.set_solution_vector(torch.zeros_like(dist.x))
    _sync(device)
    t0 = time.perf_counter()
    rk = dist.solve(lp.Klu2())
    klu_s = time.perf_counter() - t0
    man = lp.SolutionManager(mesh, 4, device=device)
    dist.update_solution([0, 1, 2, 3], man, [0, 1, 2, 3])
    err_T = float((man.values[:, 0].cpu() - torch.as_tensor(mesh.node_coords[:, 0])).abs().max())
    ok = (
        pattern_equal and csr_err < 1e-12 and all(o["converged"] and not o["capped"] for o in out)
        and all(o["off_owned_slots_zero"] for o in out) and rk.tol < 1e-6 and err_T < COND_NODAL_TOL
        and all(abs(o["iterations"] - o["single_iterations"]) <= DIST_CG_SLACK * o["single_iterations"]
                for o in out if o["single_iterations"] is not None)
    )
    _say(
        "distributed_assembled", order=order, n_elements=(n_1d - 1) ** 3, n_dofs=dist.n_dofs, n_shards=n_shards,
        n_loc1=dist.n_loc1, condensed=True, gathered_csr_pattern_equal=pattern_equal, gathered_csr_rel_err=csr_err,
        gather_s=gather_s, iterations={f"{o['solver']}+{o['precond']}": o["iterations"] for o in out},
        single_iterations={f"{o['solver']}+{o['precond']}": o["single_iterations"] for o in out
                           if o["single_iterations"] is not None},
        klu2_rel_residual=rk.tol, klu2_s=klu_s, max_nodal_err_T_minus_x=err_T, nodal_tol=COND_NODAL_TOL,
        phase_s=time.perf_counter() - t_phase, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the distributed assembled phase failed its checks")


def phase_karman_distributed(lp, kst: dict, device: str = "cuda", n_shards: int = KARMAN_DIST_SHARDS) -> None:
    """The Karman phase's first KARMAN_DIST_STEPS BDF2 steps again on a
    DistributedSystem of ``n_shards`` shards, from the same post-Picard
    fields and solution, with CG + PMultigrid(lag="auto") (distributed: the
    restriction summed over shards, the coarse solve on the whole vector):
    per-step iterations within one of the single system's, and the fields
    after the steps within KARMAN_DIST_TOL of the single system's (largest
    difference over the largest single-system value)."""
    import torch

    t0 = time.perf_counter()
    st = karman_setup(lp, torch.float32, device, mesh=kst["mesh"], order=kst["order"], n_shards=n_shards)
    system, man = st["system"], st["manager"]
    man.values = kst["fields0"].clone()
    system._set_solution_global(kst["x0"])
    setup_s = time.perf_counter() - t0
    pmg = lp.PMultigrid(lag="auto")
    solver = karman_step_solver(lp, pmg)
    steps = []
    for k in range(KARMAN_DIST_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        karman_predict(st)
        r = system.solve(solver)
        karman_finish_step(st)
        _sync(device)
        steps.append(dict(step=k + 1, s=time.perf_counter() - t0, iterations=r.num_iters, converged=r.converged,
                          capped=r.capped))
    ref = kst["fields_after"]
    field_err = float((man.values - ref).abs().max() / ref.abs().max())
    its = [s["iterations"] for s in steps]
    ok = (
        all(s["converged"] and not s["capped"] for s in steps)
        and all(abs(a - b) <= 1 for a, b in zip(its, kst["iterations"]))
        and field_err <= KARMAN_DIST_TOL and bool(torch.isfinite(man.values).all())
        and _off_owned_zero(system, system.x)
    )
    _say(
        "karman_distributed", n_dofs=system.n_dofs, n_shards=n_shards, n_loc1=system.n_loc1,
        halo_width=system._max_send, kinds=[d[0] for _, d, _ in system._operators()], dtype="float32",
        setup_s=setup_s, steps=steps, iterations=its, single_iterations=kst["iterations"],
        coarse_dofs=system._pmg_static_cache[pmg]["s1"].n_dofs, fields_rel_err_vs_single=field_err,
        tol=KARMAN_DIST_TOL, ok=ok,
    )
    if not ok:
        raise SystemExit("chip_smoke: the distributed Karman stepping failed its checks")


def phase_box(lp, state: dict, jacobi_iters: int, device: str = "cuda", cases=BOX_CASES) -> int:
    """The bench system (f32) through ``box_parallelize`` for each (shards,
    grid) of ``cases``: the box apply against the single system's apply,
    apply ms and device-busy ms beside the single apply's, z-sweep launches
    per apply (one per shard), the plane exchanges' ms (import and export),
    then CG + Jacobi within DIST_CG_SLACK of the single system's iterations
    and CG + the box LowOrderMG within BOX_MG_SLACK of the single system's
    (``state["mg_iterations"]``), each from zero, with the nodal T = x error.
    The z-sweep's count is set to 0 just before the first box is built;
    returns its launches."""
    import torch

    from l3ster_tpu_torch.ops import zsweep

    single, mesh = state["system"], state["mesh"]
    xg = torch.as_tensor(np.random.default_rng(8).normal(size=(single.n_dofs, 1)), dtype=single.dtype, device=device)
    fs = single.operator()
    y_single = fs(xg)
    single_ms = _cuda_ms(lambda: fs(xg))
    single_busy_ms, _ = _profile_apply(fs, xg)
    mg_iters = state["mg_iterations"]
    out = []
    zsweep.launch_count = 0  # the box path starts here
    for n_shards, grid in cases:
        _sync(device)
        t0 = time.perf_counter()
        box = lp.box_parallelize(single, n_shards=n_shards, grid=grid)
        setup_s = time.perf_counter() - t0
        fn = box.operator()
        x_st = box._to_slabs(xg)
        before = zsweep.launch_count
        y = fn(x_st)
        _sync(device)
        per_apply = zsweep.launch_count - before
        err = _rel(box._from_slabs(y), y_single)
        ghosts_zero = bool((y[box._own_st == 0] == 0).all())
        apply_ms = _cuda_ms(lambda: fn(x_st))
        busy_ms, top = _profile_apply(fn, x_st)
        nz, ny, nx = box._n1_loc[2], box._n1_loc[1], box._n1_loc[0]
        x5 = [p.reshape(-1, nz, ny, nx * box._n_unk, 1).clone() for p in box._split(x_st)]
        y5 = [p.clone() for p in x5]
        import_ms = _cuda_ms(lambda: box._import_halo(x5))
        export_ms = _cuda_ms(lambda: box._export_halo(y5))
        runs = {}
        for name, make in (("Jacobi", lambda: lp.Jacobi()), ("LowOrderMG", lambda: lp.LowOrderMG())):
            single.set_solution_vector(torch.zeros_like(single.x))
            _sync(device)
            t0 = time.perf_counter()
            r = box.solve(lp.CG(lp.IterSolverOpts(tol=CG_TOL, max_iters=CG_MAX_ITERS), precond=make()))
            _sync(device)
            X = single.x[:, 0].reshape(-1, 4).double().cpu().numpy()
            runs[name] = dict(iterations=r.num_iters, converged=r.converged, solve_s=time.perf_counter() - t0,
                              true_rel_residual=_true_residual(single),
                              max_nodal_err_T_minus_x=float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max()))
        rec = dict(
            n_shards=n_shards, grid=list(box.grid), windows_z=box._nez_real, windows_y=box._ney_real,
            n1_window=list(box._n1_loc), setup_s=setup_s, rel_err_vs_single_apply=err,
            off_owned_slots_zero=ghosts_zero, apply_ms=apply_ms, single_apply_ms=single_ms,
            device_busy_ms=busy_ms, single_device_busy_ms=single_busy_ms,
            device_idle_share=1.0 - busy_ms / apply_ms, busy_vs_single=busy_ms / single_busy_ms,
            top_device_ms_per_apply=top, zsweep_launches_per_apply=per_apply, halo_import_ms=import_ms,
            halo_export_ms=export_ms, jacobi=runs["Jacobi"], lowordermg=runs["LowOrderMG"],
        )
        rec["ok"] = (
            err < F32_APPLY_TOL and ghosts_zero and per_apply == n_shards
            and all(v["converged"] for v in runs.values())
            and abs(runs["Jacobi"]["iterations"] - jacobi_iters) <= DIST_CG_SLACK * jacobi_iters
            and abs(runs["LowOrderMG"]["iterations"] - mg_iters) <= BOX_MG_SLACK
        )
        out.append(rec)
        _say("box_case", single_jacobi_iterations=jacobi_iters, single_mg_iterations=mg_iters, **rec)
        del box, fn, x5, y5
    launches = zsweep.launch_count
    ok = all(o["ok"] for o in out) and launches > 0
    _say("box", n_dofs=single.n_dofs, cases=len(out), zsweep_launches=launches, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: the box phase failed its checks")
    return launches


def main() -> int:
    import torch

    import l3ster_tpu_torch as lp
    from l3ster_tpu_torch.ops import qp, rows, sumfact_fused, zsweep

    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 matmuls (the default, stated)
    torch.backends.cudnn.allow_tf32 = False
    smi, kind = phase_environment()
    if "jax" in sys.modules or "l3ster_tpu" in sys.modules:
        raise SystemExit("chip_smoke: the port imported JAX or the JAX package")
    phase_build()
    record, var_record = phase_kernels(lp)
    v1_record = phase_kernels_v1(lp)
    stage_record = phase_kernels_stages(lp)
    sumfact_record = phase_kernels_unstructured(lp)
    qp_records = phase_kernels_qp(lp)
    row_records = phase_kernels_rows(lp)
    torch.cuda.empty_cache()
    state = phase_main_path(lp)
    jacobi_iters = phase_solve(lp, state)
    record["launches"] = zsweep.launch_count  # lattice main path: phases 4 and 5
    record["launches"] += phase_mg_solve(lp, state, jacobi_iters, "mg_solve")  # and its multigrid solve
    # the matrix-free bench solution (CG + LowOrderMG), for the condensed phase
    bench_nodal = state["system"].x[:, 0].reshape(-1, 4).double().cpu().numpy()
    record["launches"] += phase_box(lp, state, jacobi_iters)  # the bench through box_parallelize
    record["launches"] += phase_multi_device_box(lp, state)  # and placed on several groups
    launches = phase_switches(lp, state)  # phase 6
    v1_record["launches"] = launches["zsweep_v1"]
    stage_record["launches"] = launches["stage_matmul"]
    qp_records["lattice_bench"]["launches"] = phase_bench_nonfused(lp, state)
    del state
    torch.cuda.empty_cache()
    state = phase_var_path(lp, 7, "var_apply")
    phase_solve(lp, state, "var_solve")
    var_record["launches"] = zsweep.launch_count  # the var path at the bench size
    del state
    torch.cuda.empty_cache()
    state = phase_var_path(lp, 13, "var_apply_12x12x12")
    jacobi_iters = phase_solve(lp, state, "var_solve_12x12x12")
    var_record["launches"] += phase_mg_solve(lp, state, jacobi_iters, "var_mg_solve_12x12x12")
    del state
    torch.cuda.empty_cache()
    phase_assembly_rate(lp)
    phase_assembled(lp)
    phase_condensed(lp, bench_nodal)
    phase_preconditioners(lp)
    state = phase_unstructured_main_path(lp)
    cylinder_iters = phase_unstructured_solve(lp, state)
    qp_records["cylinder"]["launches"] = qp.launch_count  # unstructured main path: phases 8 and 9
    sumfact_record["launches"] = sumfact_fused.launch_count
    for (op, _), v in rows.launch_count.items():  # phases 8 and 9, both layouts
        row_records[op]["launches"] += v
    dist_launches, dist_state = phase_distributed(lp, state, cylinder_iters)
    qp_records["cylinder"]["launches"] += dist_launches  # and the distributed cylinder
    qp_records["cylinder"]["launches"] += phase_multi_device_distributed(lp, state, dist_state)  # placed
    del state
    torch.cuda.empty_cache()
    phase_restart(lp, dist_state)
    del dist_state
    torch.cuda.empty_cache()
    phase_distributed_assembled(lp)
    qp_records["lattice_2d"]["launches"] = phase_lattice_2d(lp)
    torch.cuda.empty_cache()
    qp_records["periodic"]["launches"] = phase_periodic(lp)
    phase_gmsh(lp)
    phase_inverse(lp)
    torch.cuda.empty_cache()
    karman_state = phase_karman(lp)
    phase_karman_distributed(lp, karman_state)
    del karman_state
    kernels = [record, var_record, v1_record, stage_record, qp_records["cylinder"], sumfact_record]
    kernels += [qp_records[k] for k in ("lattice_2d", "lattice_bench", "periodic")]
    kernels += [row_records["gather"], row_records["scatter"]]
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
