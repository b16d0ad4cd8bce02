"""A new configuration, traffic mix and per-layer metric take new files and entries only."""

import json
import os

from portbench.tests._tiny import make_tiny_root
from portbench.tests.test_portbench_harness import SEED, _python

NEW_FILES = {
    "portbench/configs/tiny_cube.json": json.dumps({
        "source": "a throwaway cube", "problem": "diffusion3d", "mesh": {"generator": "cube", "elements_per_side": 2},
        "order": 2, "dtype": "float64", "eval_strategy": "AUTO",
        "value_order": 1, "derivative_order": 1, "adiabatic": [1, 2, 3, 4], "dirichlet": {"boundaries": [5, 6], "how": "constants"},
    }),
    "portbench/reference/tiny_cube.py": "from .diffusion3d_p6_mf import build, shapes  # noqa: F401\n",
    "portbench/traffic/tiny_mix.json": json.dumps({
        "loop": "closed", "clients": 1, "request": "one solve", "solver": {"name": "CG", "tol": 1e-10, "max_iters": 400},
        "precond": {"name": "Jacobi", "args": {}}, "warmup_iters": 5, "answers_judged": 4,
        "data": {"a": {"uniform": [2.0, 3.0]}, "b": {"uniform": [-1.0, -0.5]}},
    }),
    "portbench/limits/tiny_cell.json": json.dumps({"err": 1e-6, "res": 1e-6}),
    "portbench/metrics/tiny_solves.py": "def read(ctx):\n    return float(len(ctx['results']))\n",
}


def test_new_files_run_without_code_edits(tmp_path):
    root = make_tiny_root(str(tmp_path))
    before = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                before[os.path.join(dirpath, f)] = fh.read()
    for rel, text in NEW_FILES.items():
        with open(os.path.join(root, rel), "w") as f:
            f.write(text)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_cube", "source": "a throwaway cube", "file": "portbench/configs/tiny_cube.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny_cell", "config": "tiny_cube", "traffic": "tiny_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "tiny_solves", "unit": "solves", "better": "higher", "source": "program_counter",
                               "layer": "solve.krylov CG", "moves": "solve_s", "workloads": ["tiny_cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    code = f"""
import json
from portbench.harness import run_cell
print(json.dumps([run_cell({root!r}, "tiny_cell", {SEED}, 1.0, t, "cpu") for t in (False, True)]))
"""
    e2e, layer = _python(code, root)
    assert e2e["correct"] and set(e2e["metrics"]) == {"solve_s", "setup_s"}
    assert layer["correct"] and set(layer["metrics"]) == {"tiny_solves"}
    assert layer["metrics"]["tiny_solves"]["value"] == layer["attempted"] >= 1
    for p, data in before.items():  # no file that was there changed
        with open(p, "rb") as fh:
            assert fh.read() == data, p
