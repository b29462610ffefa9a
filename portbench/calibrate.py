#!/usr/bin/env python3
"""Readings that set a cell's limits: on each seed, the numbers its check
compares for the program (what a run compares) and, on the first
``--controls`` seeds, for the control and the planted faults, each against
the float64 reference.

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 3 ... --controls 3

- ``control``: the reference in the program's place at the precision below
  the configuration's float32 with TF32 off: float32 with TF32 matmuls
  (and, for the host metrics, float32 in place of float64);
- ``half_batch``: the float32 reference taking the loss over half of the
  rows only;
- ``float32``: the float32 reference with TF32 off, a second sound witness.

A state left unchanged reads 1 on ``change_gap`` by its definition and is
not run. One JSON line per seed; the card is required, as for ``run.py``.
"""

import argparse
import json
import os
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def drive(session, reuse=None):
    """Set-up and the steps the check follows, then the program's state
    freed: a step loop's ``setup`` (``reuse``: an earlier set-up's world of
    the same traffic), or a run with a window of 0 s. Returns the world a
    later set-up of the same traffic can reuse."""
    if hasattr(session, "setup"):
        session.setup(reuse=reuse)
        reuse = types.SimpleNamespace(edges=getattr(session, "edges", None),
                                      graph=getattr(session, "graph", None))
    else:
        session.run(0.0, False, time.perf_counter())
    session.free()
    return reuse


def readings(session, controls: bool) -> dict:
    """The program's numbers against the float64 reference, the three
    leaves whose first gradients are farthest from it, and with
    ``controls`` the control's, the half-batch fault's and the float32
    reference's numbers."""
    import numpy as np
    import torch

    from portbench.reference import train

    t0 = time.perf_counter()
    ref = session.reference(torch.float64)
    grads = train.leaf_gaps(session.program["grad1"], ref["grad1"], sorted(ref["grad1"]))
    out = {"reference_s": time.perf_counter() - t0, "program": session.numbers(ref),
           "grad_leaves": dict(sorted(grads.items(), key=lambda kv: -kv[1])[:3]),
           "losses": {"program": session.program["losses"][:3], "reference": ref["losses"]}}
    if controls:
        out["control"] = train.gaps(session.reference(torch.float32, tf32=True), ref)
        if "metrics_gap" in out["program"]:  # the host metrics in float32
            out["control"]["metrics_gap"] = session.numbers(ref, np.float32)["metrics_gap"]
        out["half_batch"] = train.gaps(session.reference(torch.float32, half_batch=True), ref)
        out["float32"] = train.gaps(session.reference(torch.float32), ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    manifest = harness.load_manifest()
    cell = harness.load_cell(manifest, args.workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    shared = None  # a step loop's world, built once for all seeds
    for i, seed in enumerate(args.seeds):
        session = harness.session_for(cfg, traffic, seed, device)
        shared = drive(session, shared)
        line = {"workload": args.workload, "seed": seed,
                **readings(session, i < args.controls)}
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
