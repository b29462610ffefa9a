"""One run of one cell: everything found by name.

- ``BENCHMARK.json`` (the repository's root) lists the cells and metrics;
- ``workloads/<cell>.json``: the cell's configuration, traffic, chips, why,
  and the limits of the numbers its check compares;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the traffic's parameters, among them the
  ``loop`` (``loops/<loop>.py``) that drives the program with it;
- ``loops/<loop>.py``: ``Session(cfg, traffic, seed, device)``, one run's
  set-up, window and check; ``small(cfg, traffic)``, copies of both cut to
  the size the CPU tests run (the widths kept); and ``TRAIN_STEP``, the
  module and name of the program's function that one step runs, which the
  tests break to see a run come out not correct;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(session)``,
  which returns nothing where it finds nothing to read;
- ``kernel_groups/<group>.json``: a group of the breakdown's device time.

A later cell, configuration, traffic, loop, metric or kernel group is a new
file and a new manifest entry; no file here or under ``tests/`` changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from typing import Optional

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "chromegcn_tpu")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def cell_entry(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise ValueError(f"BENCHMARK.json has no workload {name!r}")


def load_cell(manifest: dict, name: str) -> dict:
    """The cell's file, which has to agree with its manifest entry."""
    entry, cell = cell_entry(manifest, name), load_json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"{name}: workloads/{name}.json gives {key} {cell[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return cell


def applies(metric: dict, cell: str) -> bool:
    """Whether the end-to-end ``metric`` is reported in ``cell``: the cells
    it lists, or without a list every cell. A per-layer metric lists its
    cells always."""
    return cell in metric.get("workloads", [cell])


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", os.path.join(HERE, "metrics", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop_module(name: str):
    """``loops/<name>.py``."""
    return importlib.import_module(f"portbench.loops.{name}")


def session_for(cfg: dict, traffic: dict, seed: int, device: torch.device):
    return loop_module(traffic["loop"]).Session(cfg, traffic, seed, device)


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules' (each name
    compared whole, up to its first dot)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device: torch.device, chips: int, peak: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, manifest: Optional[dict] = None, cfg: Optional[dict] = None,
             traffic: Optional[dict] = None) -> dict:
    """Run cell ``name`` once: set-up, the measured window, with ``trace``
    the per-layer readings, then the check against the plain reference.
    ``cfg`` and ``traffic`` stand in for the cell's files (the tests' small
    sizes). Returns the result's fields, ``checks`` last."""
    manifest = manifest or load_manifest()
    cell = load_cell(manifest, name)
    cfg = cfg or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    session = session_for(cfg, traffic, seed, device)
    run = session.run(seconds, trace, t_start)

    metrics = {}
    if not trace:
        values = dict(run["metrics"], setup_s=run["setup_s"],
                      peak_mem_gib=run["peak_bytes"] / 2 ** 30)
        for m in manifest["end_to_end"]:
            if applies(m, name):
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in manifest["per_layer"]:
            if name in m["workloads"]:
                value = reader(m["name"])(session)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_fields = device_info(device, cell["chips"], run["peak_bytes"])
    result = {"attempted": run["attempted"], "failed": run["failed"], "metrics": metrics,
              "device": device_fields}
    if trace and session.trace is not None:
        device_fields["busy_s"] = session.trace.busy_s
        device_fields["window_s"] = session.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in session.trace.by_group()],
                               "idle_gaps": [list(x) for x in session.trace.idle_gaps()]}

    session.free()
    correct, rows = session.check(cell["limits"])
    return {"correct": correct, **result,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in rows}}


def report(result: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines on
    standard error; the result as the last line on standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
