"""Vortex-shedding validation of the port on the card: the Strouhal number of the Karman street.

Runs the path of ``chip_smoke.py``'s ``karman`` phase for the full study, as
the reference's ``strouhal_study(refine=2, mesh_order=3, matrix_free=True)``
does (``examples/karman_2d.py:131-291``, run by
``benchmarks/run_validation.py:31-80``): Re = 100, dt = 0.15, the confined
cylinder at 80,880 dofs (p = 3), float32, matrix-free; 8 Picard solves with
CG + a PMultigrid(lag="auto") of their own, then BDF2 steps with CG +
PMultigrid(lag="auto") from the predictor start x0 = 2 u_n - u_{n-1}.  The cross-flow velocity at the node
nearest (2, 0) in the near wake is the probe signal; the Strouhal number is
the FFT peak over the second half of the signal (D = 1, U_mean = 1), as the
reference measures it.  Its bins are 1 / (n_steps / 2 * dt) apart (0.053 at
250 steps), so the script also prints a finer estimate, one over the mean
period between the upward zero crossings of the same half, and the probe's
peak-to-peak range in windows of 50 steps, which shows whether the shedding
has saturated.

Run from the root of a checkout (the package and its ``chip_smoke.py`` are
imported from the current directory)::

    python3 tools/karman_strouhal.py [--steps 250] [--refine 2] [--out FILE]

Prints one JSON line: the Strouhal number, the final inlet/outlet flow-rate
imbalance in percent, the limit cycle (the probe's range over the last 60
steps, as the reference's validation records it, and over the second
half), the zero-crossing Strouhal number, the windowed peak-to-peak ranges,
the Picard solves (iterations, CG's and the true relative residual), s/step,
iterations per step, PMultigrid refreshes, capped solves, and the card's name
and power limit.  ``--out`` also writes the probe signal
and the per-step records.  Exits 1 unless 0.26 < St < 0.28 (the reference's
validation band, on the FFT estimate as the reference's validation holds
it), the imbalance is under 1% and no solve hit its cap.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np


def crossing_strouhal(sig: np.ndarray, dt: float) -> float:
    """One over the mean period between the upward zero crossings of the
    mean-free signal, each crossing placed by linear interpolation; 0.0 with
    fewer than two crossings."""
    s = sig - sig.mean()
    i = np.nonzero((s[:-1] < 0.0) & (s[1:] >= 0.0))[0]
    t = (i + s[i] / (s[i] - s[i + 1])) * dt
    return float((len(t) - 1) / (t[-1] - t[0])) if len(t) >= 2 else 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--refine", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    import l3ster_tpu_torch as lp

    if not torch.cuda.is_available():
        raise SystemExit("karman_strouhal: needs a CUDA device")
    t_start = time.perf_counter()
    st = cs.karman_setup(lp, torch.float32, "cuda", cs.karman_mesh_kw(args.refine))
    system, mesh, man = st["system"], st["mesh"], st["manager"]
    picard = cs.karman_picard(lp, st)
    torch.cuda.synchronize()
    picard_s = time.perf_counter() - t_start
    probe = int(np.argmin(np.linalg.norm(mesh.node_coords[:, :2] - np.array([2.0, 0.0]), axis=1)))
    pmg = lp.PMultigrid(lag="auto")
    solver = cs.karman_step_solver(lp, pmg)
    v_sig = np.zeros(args.steps)
    steps = []
    for k in range(args.steps):
        t0 = time.perf_counter()
        cs.karman_predict(st)
        r = system.solve(solver)
        cs.karman_finish_step(st)
        v_sig[k] = float(man.values[probe, st["vel1"][1]])
        steps.append(dict(s=time.perf_counter() - t0, iterations=r.num_iters, capped=r.capped,
                          converged=r.converged, refreshes=system._pmg_static_cache[pmg]["refreshes"]))
    inflow, outflow = cs.karman_flows(lp, st)
    imbalance = abs(inflow - outflow) / inflow * 100.0
    tail = v_sig[args.steps // 2 :]
    tail = tail - tail.mean()
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    freqs = np.fft.rfftfreq(len(tail), d=cs.KARMAN_DT)
    spec[0] = 0.0
    strouhal = float(freqs[int(np.argmax(spec))])
    strouhal_crossings = crossing_strouhal(v_sig[args.steps // 2 :], cs.KARMAN_DT)
    iters = [s["iterations"] for s in steps]
    # PMultigrid's refresh counter also counts the Picard sweeps' refreshes (an equal configuration)
    counts = [picard[-1]["refreshes"]] + [s["refreshes"] for s in steps]
    refresh_steps = [i + 1 for i in range(len(steps)) if counts[i + 1] > counts[i]]
    capped = sum(s["capped"] or not s["converged"] for s in steps) + sum(r["capped"] or not r["converged"] for r in picard)
    ok = 0.26 < strouhal < 0.28 and imbalance < 1.0 and capped == 0 and bool(np.isfinite(v_sig).all())
    rec = dict(
        script="tools/karman_strouhal.py", card=cs._smi(), n_dofs=system.n_dofs, refine=args.refine,
        order=cs.KARMAN_ORDER, dtype="float32", n_steps=args.steps, dt=cs.KARMAN_DT, probe_node=probe,
        strouhal=strouhal, strouhal_fft_bin=float(freqs[1]), strouhal_zero_crossings=strouhal_crossings,
        imbalance_pct=imbalance, inflow=inflow, outflow=outflow,
        limit_cycle_last60=[float(v_sig[-60:].min()), float(v_sig[-60:].max())],
        limit_cycle_second_half=[float(v_sig[args.steps // 2 :].min()), float(v_sig[args.steps // 2 :].max())],
        peak_to_peak_per_50_steps=[float(np.ptp(v_sig[i : i + 50])) for i in range(0, args.steps, 50)],
        picard_s=picard_s, picard=picard,
        s_per_step_median=statistics.median(s["s"] for s in steps), total_s=time.perf_counter() - t_start,
        iterations_min_median_max=[min(iters), statistics.median(iters), max(iters)],
        refreshes=len(refresh_steps), refresh_steps=refresh_steps, capped_or_unconverged=capped, ok=ok,
    )
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rec, v_signal=v_sig.tolist(), steps=steps), f)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
