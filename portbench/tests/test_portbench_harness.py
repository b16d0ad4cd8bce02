"""The harness on the CPU at tiny sizes: sound runs come out correct, broken ones not."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.harness import run_cell
from portbench.tests._tiny import REPO, make_tiny_root

CELLS = ["diff3d_mg", "cyl3d_jacobi"]
SEED = 2**31 + 977  # more than 32 signed bits hold


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("portbench")))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    out = run_cell(tiny_root, cell, SEED, 1.0, False, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"solve_s", "setup_s"}
    assert list(out)[-1] == "checks" and set(out["checks"]) == {"err", "res", "unconverged"}


def _state_unchanged(monkeypatch):
    """The solve returns at once and leaves the solution as it found it."""
    from l3ster_tpu_torch.solve import krylov
    from l3ster_tpu_torch.solve.interface import IterSolveResult

    monkeypatch.setattr(krylov.CG, "solve", lambda self, system: IterSolveResult(tol=0.0, num_iters=1))


def _answer_altered(monkeypatch):
    """One entry of each answer is changed where the solve produces it."""
    from l3ster_tpu_torch.solve import krylov

    orig = krylov.CG.solve

    def solve(self, system):
        r = orig(self, system)
        x = system.x.clone()
        x[x.shape[0] // 2] += 0.05
        system.set_solution_vector(x)
        return r

    monkeypatch.setattr(krylov.CG, "solve", solve)


def _half_left_out(monkeypatch):
    """The operator sees only the first half of each vector, the rest taken as zero."""
    from l3ster_tpu_torch.algsys.system import MatrixFreeSystem

    orig = MatrixFreeSystem.operator_parts

    def operator_parts(self, layout="dof"):
        fn, consts = orig(self, layout=layout)

        def half(x, *c):
            keep = torch.zeros_like(x)
            keep[: x.shape[0] // 2] = 1.0
            return fn(x * keep, *c) * keep

        return half, consts

    monkeypatch.setattr(MatrixFreeSystem, "operator_parts", operator_parts)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered, _half_left_out])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(tiny_root, cell, fault, monkeypatch):
    """The run as the driver makes it, past the look for a chip, with the
    timed path broken underneath: ``correct`` comes out false.  (One chip:
    no exchange between chips to leave out.)"""
    fault(monkeypatch)
    out = run_cell(tiny_root, cell, SEED, 1.0, False, "cpu")
    assert not out["correct"]


def _python(code: str, root: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=root,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_no_jax_loaded(tiny_root):
    """A whole run, with every module of the harness imported, loads none of
    jax, jaxlib, flax or the JAX package (top-level names compared whole:
    the program's own name begins with the JAX package's)."""
    code = f"""
import glob, importlib, json, os, sys
import portbench.run
from portbench.harness import forbidden_modules, run_cell
for path in sorted(glob.glob(os.path.join({tiny_root!r}, "portbench", "**", "*.py"), recursive=True)):
    rel = os.path.relpath(path, {tiny_root!r})[:-3].replace(os.sep, ".")
    if ".tests." not in rel and not rel.endswith("__init__"):
        importlib.import_module(rel)
out = run_cell({tiny_root!r}, "diff3d_mg", {SEED}, 1.0, False, "cpu")
print(json.dumps({{"correct": out["correct"], "forbidden": forbidden_modules(),
                  "program": "l3ster_tpu_torch" in sys.modules}}))
"""
    got = _python(code, tiny_root)
    assert got == {"correct": True, "forbidden": [], "program": True}


def test_cli_without_a_card_prints_no_result(tiny_root):
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "diff3d_mg", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tiny_root,
                         timeout=600, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_cli_without_the_program_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the run fails."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"), tmp_path / "portbench")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "cyl3d_jacobi", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=600, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
