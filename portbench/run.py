#!/usr/bin/env python3
"""The port's benchmark: runs one cell of ``BENCHMARK.json`` once, on the
card of the machine it runs on, and prints one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``chromegcn_tpu_torch``. It drives
that package only. With ``--trace 0`` the line holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer ones, the device's busy and traced
seconds and a breakdown. Every run checks what its timed path produced
against the plain reference under ``portbench/reference`` and prints each
number compared beside its limit. It exits non-zero, printing no result,
without a CUDA card (or with fewer than the cell asks for), where the check
cannot run, or if any JAX module was loaded.

The kernel and compiler caches live at fixed paths under ``build/`` in the
checkout, so only a checkout's first run builds.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "portbench")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if args.seed < 0:
        parser.error("--seed is a whole number of 0 or more")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from portbench import harness

    manifest = harness.load_manifest()
    chips = harness.cell_entry(manifest, args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} cards, {torch.cuda.device_count()} are here",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda"), T_START, manifest)
    found = harness.forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
