"""No run of the benchmark loads JAX, jaxlib, flax or the JAX package:
each cell runs at a small size on the CPU in a fresh process, which then
lists the top-level names of its loaded modules (compared whole, up to the
first dot)."""

import json
import os
import subprocess
import sys

import pytest

from portbench import harness

HERE = os.path.dirname(os.path.abspath(__file__))

PROGRAM = r"""
import json, sys, time
sys.path[:0] = [{root!r}, {here!r}]
import torch
from portbench import harness
from small import small
torch.set_num_threads(2)
cfg, traffic = small({cell!r})
harness.run_cell({cell!r}, 3, 0.2, True, torch.device("cpu"), time.perf_counter(),
                 cfg=cfg, traffic=traffic)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_a_run_loads_no_jax(cell, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", PROGRAM.format(root=harness.ROOT, here=HERE,
                                                               cell=cell)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "chromegcn_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_the_harness_names_no_forbidden_module():
    names = {"portbench"}
    for dirpath, _, files in os.walk(harness.HERE):
        names |= {f[:-3] for f in files if f.endswith(".py")}
    assert not names & set(harness.FORBIDDEN)
    assert "jax" in harness.FORBIDDEN and "chromegcn_tpu" in harness.FORBIDDEN
