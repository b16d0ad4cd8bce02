"""Accuracy of the condensed bench system on one GPU: f64 against f32.

Builds the bench problem assembled with ELEMENT_BOUNDARY condensation
(``chip_smoke.py:_build_system``, default p = 6 on 6^3 hexes) three ways and
prints one JSON line per step: in f64 throughout (CG + Jacobi to 1e-10);
in f32 (the f32 system against the f64 one: ``data``, effective rhs, the
interior blocks Kii and Kbi and the Schur factor Y; CG + Jacobi to 1e-6;
then the f32 system's matrix and rhs solved in f64 to 1e-10); and in f32
with the Schur step redone in f64 from the f32 blocks.  Each solve reports
its max nodal errors against the exact T = x, q = (1, 0, 0).

``--f32-local-matrices`` forms the local matrices and accumulates the
system in float32 (the assembled system's accumulation dtype,
``algsys.system._ASM_DTYPE``, is float64 otherwise).

Run from the root of a checkout: ``python3 tools/condensed_accuracy.py
[order n_1d] [--f32-local-matrices]``.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import l3ster_tpu_torch as lp  # noqa: E402
from l3ster_tpu_torch.algsys import system as sysmod  # noqa: E402


def errors(mesh, s, tag, extra=None):
    man = lp.SolutionManager(mesh, 4, device="cuda")
    s.update_solution(range(4), man, range(4))
    X = man.values.cpu().numpy()
    out = dict(tag=tag, errT=float(np.abs(X[:, 0] - mesh.node_coords[:, 0]).max()),
               errq=float(max(np.abs(X[:, 1] - 1).max(), np.abs(X[:, 2:]).max())), true=cs._true_residual(s))
    out.update(extra or {})
    print(json.dumps(out), flush=True)


def schur64_end(system):
    """The system's end_assembly with the Schur step in float64 from its
    blocks, cast to the system dtype."""

    def end():
        data, rhs, yz = system.data.double(), system.rhs.double(), []
        for agg in system._cond_aggs.values():
            Kbi = agg.Kbi.double()
            Y, Z = sysmod._schur_solve(agg.Kii.double(), Kbi.transpose(1, 2), agg.Fi.double())
            pos = torch.as_tensor(system._scatter_positions(agg.b_dofs).reshape(-1), device=system.device)
            data = data.index_add(0, pos, torch.bmm(Kbi, Y).reshape(-1), alpha=-1)
            b_idx = torch.as_tensor(agg.b_dofs.reshape(-1), device=system.device)
            rhs = rhs.index_add(0, b_idx, torch.bmm(Kbi, Z).reshape(-1, system.n_rhs), alpha=-1)
            yz.append((agg, Y.to(system.dtype), Z.to(system.dtype)))
        system.data, system.rhs = data.to(system.dtype), rhs.to(system.dtype)
        for agg, Y, Z in yz:
            agg.Y, agg.Z = Y, Z
        system._csr = torch.sparse_csr_tensor(system._indptr_dev, system._cols_dev, system.data,
                                              size=(system.n_dofs, system.n_dofs), check_invariants=False)

    system._end_impl = end


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("condensed_accuracy: needs a CUDA device")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    order, n1d = (int(args[0]), int(args[1])) if args else (cs.COND_ORDER, cs.COND_N1D)
    f32_local = "--f32-local-matrices" in sys.argv
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    print(json.dumps(dict(device=cs._smi(), order=order, n_1d=n1d, f32_local_matrices=f32_local)), flush=True)
    mesh, s64 = cs._build_system(lp, order, n1d, torch.float64, "cuda", cond=True)
    r = s64.solve(lp.CG(lp.IterSolverOpts(tol=1e-10, max_iters=20000), precond=lp.Jacobi()))
    errors(mesh, s64, "f64 system, CG 1e-10", dict(its=r.num_iters, s=time.time() - t0))
    d64, b64 = s64.data.clone(), s64.effective_rhs().clone()
    agg64 = next(iter(s64._cond_aggs.values()))
    del s64
    torch.cuda.empty_cache()
    if f32_local:
        sysmod._ASM_DTYPE = torch.float32

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    mesh, s32 = cs._build_system(lp, order, n1d, torch.float32, "cuda", cond=True)
    agg32 = next(iter(s32._cond_aggs.values()))
    print(json.dumps(dict(tag="f32 vs f64 system", data=rel(s32.data, d64), eff_rhs=rel(s32.effective_rhs(), b64),
                          Kii=rel(agg32.Kii, agg64.Kii), Kbi=rel(agg32.Kbi, agg64.Kbi), Y=rel(agg32.Y, agg64.Y))),
          flush=True)
    r = s32.solve(lp.CG(lp.IterSolverOpts(tol=1e-6, max_iters=20000), precond=lp.Jacobi()))
    errors(mesh, s32, "f32 system, CG 1e-6", dict(its=r.num_iters))
    # the f32 system's matrix and rhs, solved in f64
    s32.data, s32.rhs, s32.dtype = s32.data.double(), s32.rhs.double(), torch.float64
    s32.free_mask, s32.dirichlet_values = s32.free_mask.double(), s32.dirichlet_values.double()
    s32.x, s32._effective_rhs, s32._precond_parts_cache = s32.x.double(), None, {}
    s32._csr = torch.sparse_csr_tensor(s32._indptr_dev, s32._cols_dev, s32.data, size=(s32.n_dofs, s32.n_dofs),
                                       check_invariants=False)
    for agg in s32._cond_aggs.values():
        agg.Y, agg.Z = agg.Y.double(), agg.Z.double()
    r = s32.solve(lp.CG(lp.IterSolverOpts(tol=1e-10, max_iters=20000), precond=lp.Jacobi()))
    errors(mesh, s32, "f32 matrix solved in f64, CG 1e-10", dict(its=r.num_iters))
    del s32
    torch.cuda.empty_cache()
    mesh, s = cs._build_system(lp, order, n1d, torch.float32, "cuda", cond=True, hook=schur64_end)
    print(json.dumps(dict(tag="f32 with f64 Schur vs f64 system", data=rel(s.data, d64),
                          eff_rhs=rel(s.effective_rhs(), b64))), flush=True)
    r = s.solve(lp.CG(lp.IterSolverOpts(tol=1e-6, max_iters=20000), precond=lp.Jacobi()))
    errors(mesh, s, "f32 system with f64 Schur, CG 1e-6", dict(its=r.num_iters))
    r = s.solve(lp.CG(lp.IterSolverOpts(tol=1e-8, max_iters=20000), precond=lp.Chebyshev()))
    errors(mesh, s, "f32 system with f64 Schur, continued 1e-8", dict(its=r.num_iters))
    print(json.dumps(dict(total_s=time.time() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
