"""Self time of each of the port's host spans over a benchmark cell's
window, in ms per 1000 subframes.

    python3 scripts/port_span_self.py <cell> <seed> [seconds]

Runs the cell as `sniffbench/run.py` does (untraced), through
`sniffbench.harness.drive.run`, and resets the port's tracer
(`ltesniffer_tpu_torch/sniffer/prof.py`) when the window's first call
starts, so the spans cover the window alone.  Prints one JSON line:
the cell's result (`sf_per_s`, `correct`) and, for every span, its self
time (`prof.report()["self"]`: less the time of its child spans), its
total time and its calls, each per 1000 subframes of the window.
Imports the port and the benchmark only, no JAX.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    name, seed = sys.argv[1], int(sys.argv[2])
    seconds = float(sys.argv[3]) if len(sys.argv) > 3 else 51.0
    from sniffbench.harness import drive
    from ltesniffer_tpu_torch.sniffer import prof
    window = {"sf": 0, "calls": 0}

    def program(core):
        run = core.run_packed

        def counted(words, *a, **k):
            window["calls"] += 1
            if window["calls"] == 2:         # the window's first call
                prof.reset()
            if window["calls"] >= 2:
                window["sf"] += len(words)
            return run(words, *a, **k)
        core.run_packed = counted
    res = drive.run(name, seed, seconds, trace=False, program=program,
                    log=open(os.devnull, "w"))
    ksf = window["sf"] / 1e3
    spans = {k: dict(self=round(v["self"] * 1e3 / ksf, 3),
                     total=round(v["s"] * 1e3 / ksf, 3),
                     calls=round(v["n"] / ksf, 3))
             for k, v in prof.report().items()}
    print(json.dumps(dict(cell=name, seed=seed, correct=res["correct"],
                          sf_per_s=res["metrics"]["sf_per_s"]["value"],
                          window_sf=window["sf"], spans=spans)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
