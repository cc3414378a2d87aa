"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 sniffbench/run.py --workload dl20_siso.loaded --seed 7 \
        --seconds 30 --trace 0

Prints progress and, last, each compared number beside its limit on
standard error, and one JSON line, last, on standard output: `correct`,
`attempted` and `failed` (transport blocks), `metrics` (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), `device`,
with --trace 1 `breakdown`, and `checked` last.  Exits 2 without a result
where the machine has fewer cards than the cell asks for, 3 where the
process loaded JAX or the JAX package.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from sniffbench.harness import drive
    try:
        res = drive.run(a.workload, a.seed, a.seconds, bool(a.trace),
                        t0=T0)
    except drive.NoCard as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    except drive.Forbidden as e:
        print(f"no result: {e}", file=sys.stderr)
        return 3
    print(json.dumps(res), flush=True)
    for k, v in res["checked"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
