"""The control comes out not correct: each cell's plain reference, put in
the program's place at the precision below the configuration's (float32
with TF32 matmuls; the host metrics in float32), fails one of the numbers
the cell compares, while the program passes them. On the card, at the small
sizes of the CPU tests, with the readings ``portbench/calibrate.py`` takes
at the cells' own sizes."""

import pytest
import torch

from portbench import calibrate, harness
from portbench.loops import common

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 6, 7])
def test_the_control_fails_and_the_program_passes(cell, seed, small_cell):
    cfg, traffic = small_cell(cell)
    limits = harness.load_json("workloads", cell)["limits"]
    session = harness.session_for(cfg, traffic, seed, torch.device("cuda"))
    calibrate.drive(session)
    out = calibrate.readings(session, controls=True)
    assert common.judge(out["program"], limits)[0], out["program"]
    assert not common.judge(out["control"], limits)[0], out["control"]
