"""Readings for the limits of `correct`: the program as it stands and the
control, each over the cell's own input and window, on several seeds, in
one process (the kernels build once).

    python3 sniffbench/control.py --workload dl20_siso.loaded \
        --seeds 11 12 13 --seconds 0 [--control]

With --control, the cell's control (its workload file's `control`, a
module of `sniffbench/controls/`) is planted in the program: it breaks
one guarantee of the configuration.  Prints one JSON line per seed with
the compared numbers.
"""
import argparse
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant_of(workload: str):
    """The cell's control: `plant(core)` of its module."""
    from sniffbench.harness import drive
    name = drive.load_cell(workload)["workload"]["control"]
    return importlib.import_module(f"sniffbench.controls.{name}").plant


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", action="store_true")
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from sniffbench.harness import drive
    for seed in a.seeds:
        res = drive.run(a.workload, seed, a.seconds, False,
                        t0=time.perf_counter(),
                        program=plant_of(a.workload) if a.control else None)
        print(json.dumps(dict(workload=a.workload, seed=seed,
                              control=a.control, correct=res["correct"],
                              checked=res["checked"],
                              detail=res["detail"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
