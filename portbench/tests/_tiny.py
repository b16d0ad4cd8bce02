"""A copy of the benchmark at a size the CPU runs in seconds, for the tests."""

from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SMALL_CYLINDER = dict(distz=[-1.0, 0.0, 1.0], left_offset=4.0, right_offset=6.0, bottom_offset=3.0, top_offset=3.0,
                      n_circumf=8, n_radial=2, n_left=2, n_right=3, n_bottom=2, n_top=2)
TINY = {
    "diffusion3d_p6_mf": {"mesh": {"generator": "cube", "elements_per_side": 3}, "order": 3},
    "cylinder3d_p4_mf": {"mesh": {"generator": "cylinder_in_channel_3d", "params": SMALL_CYLINDER}, "order": 2},
}
TINY_MAX_ITERS = 400  # sound tiny solves take tens; a broken one stops here, unconverged
TINY_LIMITS = {"err": 1e-3, "res": 1e-3}  # the tiny copies' own limits: the tests judge the harness, not the sizes


def make_tiny_root(dest: str) -> str:
    """BENCHMARK.json and portbench/ copied under ``dest``, with the cells
    of ``portbench/candidates/`` added and each configuration cut to a tiny
    size; returns the copy's root."""
    root = os.path.join(dest, "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, change in TINY.items():
        path = os.path.join(root, "portbench", "configs", f"{name}.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(change)
        with open(path, "w") as f:
            json.dump(cfg, f)
    for mix in os.listdir(os.path.join(root, "portbench", "traffic")):
        path = os.path.join(root, "portbench", "traffic", mix)
        with open(path) as f:
            m = json.load(f)
        m["solver"]["max_iters"] = TINY_MAX_ITERS
        with open(path, "w") as f:
            json.dump(m, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    add_candidates(bench, os.path.join(root, "portbench", "candidates"))
    with open(path, "w") as f:
        json.dump(bench, f)
    for w in bench["workloads"]:
        with open(os.path.join(root, "portbench", "limits", w["name"] + ".json"), "w") as f:
            json.dump(TINY_LIMITS, f)
    return root


def add_candidates(bench: dict, folder: str) -> None:
    """Each ``candidates/<cell>.json``'s entries added to ``bench``: its
    configurations, cells and own metrics, and the cell in the
    ``workloads`` of the shared metrics it names."""
    for name in sorted(os.listdir(folder)):
        with open(os.path.join(folder, name)) as f:
            cand = json.load(f)
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += cand[key]
        cells = [w["name"] for w in cand["workloads"]]
        for m in bench["per_layer"]:
            if m["name"] in cand["per_layer_also"]:
                m["workloads"] = m["workloads"] + cells
