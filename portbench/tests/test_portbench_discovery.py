"""A cell, configuration, traffic mix, loop, per-layer metric and kernel
group added as files (and manifest entries) are found with no edit to any
file that is there: a copy of the benchmark gets one of each and runs the
new cell, and with a new loop the benchmark's own tests take the new cell
too."""

import json
import os
import re
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


# a loop added as a file: the chromosome step under a name of its own
LOOP = '''import copy

from portbench.loops import chrome_step

TRAIN_STEP = ("chromegcn_tpu_torch.train.finetune", "chrome_train_step")


def small(cfg, traffic):
    traffic = copy.deepcopy(traffic)
    traffic["graph"].update(n_valid=1100, n_pairs=1900)
    return copy.deepcopy(cfg), traffic


class Session(chrome_step.Session):
    pass
'''

SMALL = r"""
import json, sys
sys.path.insert(0, {tests!r})
from small import small
print(json.dumps(small("new_loop_cell")))
"""

# the benchmark's own tests that run every cell of the manifest
CELL_TESTS = ["portbench/tests/test_portbench_small.py", "portbench/tests/test_portbench_nojax.py",
              "portbench/tests/test_portbench_faults.py"]


def copy_of_the_benchmark(tmp_path):
    """A checkout of the benchmark alone, and its files' bytes."""
    copy = tmp_path / "checkout"
    shutil.copytree(harness.HERE, copy / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    bench = copy / "portbench"
    return copy, bench, {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(tmp_path):
    copy, bench, before = copy_of_the_benchmark(tmp_path)

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


def test_a_new_loop_is_found_by_name(tmp_path):
    """A cell whose traffic names a loop of its own: its loop, traffic,
    configuration and cell files and manifest entries, and nothing else.
    ``small`` cuts it, and the tests that run every cell (its loop's
    declarations, no JAX loaded, a sound run, the unchanged state and the
    half batch caught) pass on it as on the cells that are there."""
    copy, bench, before = copy_of_the_benchmark(tmp_path)

    (bench / "loops" / "new_loop.py").write_text(LOOP)
    traffic = json.loads((bench / "traffic" / "chr1_nohub_graph.json").read_text())
    traffic["loop"] = "new_loop"
    (bench / "traffic" / "new_loop_traffic.json").write_text(json.dumps(traffic))
    cfg = json.loads((bench / "configs" / "chromegcn_gm12878.json").read_text())
    cfg["name"] = "new_loop_config"
    (bench / "configs" / "new_loop_config.json").write_text(json.dumps(cfg))
    limits = json.loads((bench / "workloads" / "gcn_chr1_nohub_step.json").read_text())["limits"]
    why = "a hub-free graph through a loop of its own: a loop added as files"
    (bench / "workloads" / "new_loop_cell.json").write_text(json.dumps(
        {"config": "new_loop_config", "traffic": "new_loop_traffic", "chips": 1, "why": why,
         "limits": limits}))
    manifest = json.loads((copy / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "new_loop_config", "source": cfg["source"],
                                "file": "portbench/configs/new_loop_config.json",
                                "reduced": cfg["reduced"], "why": why})
    manifest["workloads"].append({"name": "new_loop_cell", "config": "new_loop_config",
                                  "traffic": "new_loop_traffic", "chips": 1, "why": why})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m and "gcn_chr1_nohub_step" in m["workloads"]:
            m["workloads"].append("new_loop_cell")
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join([harness.ROOT] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run([sys.executable, "-c", SMALL.format(tests=str(bench / "tests"))],
                         capture_output=True, text=True, timeout=600, env=env, cwd=copy)
    assert out.returncode == 0, out.stderr[-3000:]
    cut_cfg, cut_traffic = json.loads(out.stdout.strip().splitlines()[-1])
    assert cut_cfg == cfg
    assert cut_traffic["graph"] == dict(traffic["graph"], n_valid=1100, n_pairs=1900)

    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider",
                          "-k", "new_loop_cell", *CELL_TESTS],
                         capture_output=True, text=True, timeout=600, env=env, cwd=copy)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    passed = set(re.findall(r"^PASSED \S+::(\w+)\[new_loop_cell\]", out.stdout, re.M))
    assert passed == {"test_every_loop_declares_what_the_tests_need", "test_a_run_loads_no_jax",
                      "test_a_sound_run_is_correct",
                      "test_a_step_that_leaves_the_state_unchanged_is_caught",
                      "test_half_the_batch_left_out_is_caught"}, out.stdout[-3000:]
    for path, body in before.items():
        assert path.read_bytes() == body, path
