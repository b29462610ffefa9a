"""A cell, configuration, traffic mix, per-layer metric and kernel group
added as files (and manifest entries) are found with no edit to any file
that is there: a copy of the benchmark gets one of each and runs the new
cell."""

import json
import os
import shutil
import subprocess
import sys

from portbench import harness

PROGRAM = r"""
import json, sys, time
sys.path[:0] = [{copy!r}]
import portbench
assert portbench.__file__.startswith({copy!r}), portbench.__file__
sys.path.append({root!r})
import torch
from portbench import harness, timing
torch.set_num_threads(2)
r = harness.run_cell("new_cell", 5, 0.2, True, torch.device("cpu"), time.perf_counter())
print(json.dumps({{"metrics": r["metrics"], "correct": r["correct"],
                  "groups": [g["name"] for g in timing.kernel_groups()]}}))
"""


def test_new_files_are_found_by_name(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(harness.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    bench = copy / "portbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "chromegcn_gm12878.json").read_text())
    cfg["name"] = "new_config"
    (bench / "configs" / "new_config.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "chr1_nohub_graph.json").read_text())
    traffic["graph"].update(n_valid=1200, n_pairs=2000)
    (bench / "traffic" / "new_traffic.json").write_text(json.dumps(traffic))
    limits = json.loads((bench / "workloads" / "gcn_chr1_nohub_step.json").read_text())["limits"]
    why = "a small hub-free graph: a cell added as files"
    (bench / "workloads" / "new_cell.json").write_text(json.dumps(
        {"config": "new_config", "traffic": "new_traffic", "chips": 1, "why": why,
         "limits": limits}))
    (bench / "metrics" / "new_metric.py").write_text(
        "def read(session):\n    return float(session.n_valid)\n")
    (bench / "kernel_groups" / "new_group.json").write_text(
        json.dumps({"name": "new group", "priority": 1, "words": ["new_kernel"]}))
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "new_config", "source": cfg["source"],
                                "file": "portbench/configs/new_config.json",
                                "reduced": cfg["reduced"], "why": why})
    manifest["workloads"].append({"name": "new_cell", "config": "new_config",
                                  "traffic": "new_traffic", "chips": 1, "why": why})
    manifest["per_layer"].append({"name": "new_metric", "unit": "windows", "better": "higher",
                                  "source": "program_counter", "layer": "test",
                                  "moves": "train_step_ms", "workloads": ["new_cell"]})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and "gcn_chr1_nohub_step" in m["workloads"]:
            m["workloads"].append("new_cell")
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = subprocess.run([sys.executable, "-c", PROGRAM.format(copy=str(copy),
                                                               root=harness.ROOT)],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["metrics"]["new_metric"]["value"] == 1200.0
    assert got["metrics"]["step_mfu"]["value"] > 0
    assert got["groups"][0] == "new group"
    for path, body in before.items():
        assert path.read_bytes() == body, path
