"""The 3D first-order diffusion problem on the program: mesh, system and requests.

The upstream ``benchmarks/Diffusion3D.hpp`` kernel (4 unknowns T, qx, qy, qz;
7 equations), value-only adiabatic sides n . q = 0 and Dirichlet T, built
through the program's public entry points from a configuration file:

* ``mesh.generator`` "cube": ``make_cube_mesh`` on ``elements_per_side``
  equal cells of [0, 1]; "cylinder_in_channel_3d":
  ``make_cylinder_in_channel_3d(**params)``; then ``generate_mesh`` to
  ``order``;
* ``make_algebraic_system`` matrix-free in ``dtype``, the domain kernel
  and the boundary kernel on ``adiabatic``, both under
  ``AssemblyOptions(value_order, derivative_order, eval_strategy)``, so the
  quadrature is the one the configuration states;
* a request T = a + b x: ``dirichlet.how`` "constants" sets a on the first
  Dirichlet boundary and a + b on the second (the cube's x = 0 and x = 1
  sides); "kernel" evaluates a boundary residual kernel on them all.
"""

from __future__ import annotations

import numpy as np
import torch


def _diffusion_3d(inp, out):
    ops, _ = out
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


class Case:
    """One configuration's system on the program, and how a request sets its data."""

    def __init__(self, lp, cfg: dict, device, spans):
        m = cfg["mesh"]
        with spans("mesh_s"):
            if m["generator"] == "cube":
                base = lp.make_cube_mesh(np.linspace(0.0, 1.0, m["elements_per_side"] + 1))
            elif m["generator"] == "cylinder_in_channel_3d":
                base = lp.make_cylinder_in_channel_3d(**m.get("params", {}))
            else:
                raise ValueError(f"unknown mesh generator {m['generator']!r}")
            self.mesh = lp.generate_mesh(base, order=cfg["order"])
        d = cfg["dirichlet"]
        self.how, self.bids = d["how"], list(d["boundaries"])
        with spans("assembly_s"):
            problem = lp.ProblemDefinition(4, [0])
            bcs = lp.BCDefinition(problem)
            bcs.define_dirichlet(self.bids, [0])
            params = lp.AlgebraicSystemParams(eval_strategy=lp.OperatorEvaluationStrategy.MATRIX_FREE)
            dtype = getattr(torch, cfg["dtype"])
            self.system = lp.make_algebraic_system(self.mesh, problem, bcs, params, dtype=dtype, device=device)
            kd = lp.wrap_domain_equation_kernel(_diffusion_3d, lp.KernelParams(3, 7, 4))
            kn = lp.wrap_boundary_equation_kernel(_adiabatic_3d, lp.KernelParams(3, 1, 4))
            self._ab = [0.0, 1.0]
            ab = self._ab

            def dirichlet_t(inp, out):  # T = a + b x for the current request
                out[0] = ab[0] + ab[1] * inp.point.x

            self._kdir = lp.wrap_boundary_residual_kernel(dirichlet_t, lp.KernelParams(3, 1))
            self.set_request(0.0, 1.0)
            self.system.begin_assembly()
            opts = lp.AssemblyOptions(value_order=cfg["value_order"], derivative_order=cfg["derivative_order"],
                                      eval_strategy=getattr(lp.LocalEvalStrategy, cfg["eval_strategy"]))
            self.system.assemble_problem(kd, [0], options=opts)
            self.system.assemble_problem(kn, list(cfg["adiabatic"]), options=opts)
            self.system.end_assembly()

    def set_request(self, a: float, b: float) -> None:
        """Dirichlet data of one request: T = a + b x."""
        if self.how == "constants":
            left, right = self.bids
            self.system.set_dirichlet_bc_values([a], [left], [0])
            self.system.set_dirichlet_bc_values([a + b], [right], [0])
        elif self.how == "kernel":
            self._ab[0], self._ab[1] = a, b
            self.system.set_dirichlet_bc_values(self._kdir, self.bids, [0])
        else:
            raise ValueError(f"unknown Dirichlet data path {self.how!r}")

    def answer_labels(self) -> tuple[np.ndarray, np.ndarray]:
        """(node coordinates (n, 3), node_dof (n, 4)): which node and unknown
        each entry of the solution vector belongs to, to read the answer by."""
        return np.array(self.mesh.node_coords, dtype=np.float64), np.array(self.system.dofmap.node_dof)
