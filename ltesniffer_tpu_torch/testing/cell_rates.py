"""Warm rates of the loaded cell and the MIMO cell on the card, for
comparing two source trees of the port on one machine.

    # once: build both cells' packed streams (the port's generator)
    python ltesniffer_tpu_torch/testing/cell_rates.py --pack cells.npz
    # then, in turns (A B B A), each tree in its own process:
    python ltesniffer_tpu_torch/testing/cell_rates.py --load cells.npz \
        --tree OTHER_TREE --label A

`--tree` is the root of a checkout whose `ltesniffer_tpu_torch` runs the
cells (default: this file's own tree); the script imports nothing of the
package before it has put that root first on `sys.path`, so an earlier
tree without this file works too.  Each cell runs `--passes` times
through `LTESnifferCore.run_packed` on `cuda` (the first pass pays the
one-time costs and is reported apart); the last line of the output is a
JSON object with each pass's wall time, subframes per second and the
`p2_search` / `p3_mimo` spans, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
LOADED_BATCH = 256                 # chip_smoke.py phase 4
MIMO_BATCH = 32                    # chip_smoke.py phase 5


def pack(path: str):
    import numpy as np
    sys.path.insert(0, HERE)
    from ltesniffer_tpu_torch.testing import loaded_cell, mimo_cell
    words, scales, _, _ = loaded_cell.build_packed()
    m_words, m_scales, _ = mimo_cell.build_packed()
    np.savez(path, words=words, scales=scales, m_words=m_words,
             m_scales=m_scales)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else \
        "not measured"


def rates(path: str, tree: str, passes: int) -> dict:
    import numpy as np
    sys.path.insert(0, tree)
    import torch
    from ltesniffer_tpu_torch.sniffer import core, prof
    from ltesniffer_tpu_torch.testing import loaded_cell, mimo_cell
    if not torch.cuda.is_available():
        raise SystemExit("cell_rates: no CUDA device")
    data = np.load(path)
    out = {"card": card_line(), "tree": tree}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cell, batch, w, s, span in (
                ("loaded", loaded_cell.CELL, LOADED_BATCH, data["words"],
                 data["scales"], "p2_search"),
                ("mimo", mimo_cell.CELL, MIMO_BATCH, data["m_words"],
                 data["m_scales"], "p3_mimo")):
            runs = []
            for _ in range(passes):
                prof.reset()
                c = core.LTESnifferCore(core.SnifferConfig(
                    cell=cell, batch_size=batch, device="cuda",
                    pcap_path=os.path.join(tmp, f"{name}.pcap")))
                t0 = time.perf_counter()
                c.run_packed(w, s)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                c.close()
                sp = prof.report().get(span, {"s": 0.0, "n": 0})
                runs.append({"s": dt, "sf_per_s": len(w) / dt, span: sp["s"],
                             f"{span}_n": sp["n"],
                             "pdsch_ok": c.summary()["pdsch_ok"]})
            out[name] = runs
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pack", help="write both cells' packed streams here")
    ap.add_argument("--load", help="run the cells from this .npz")
    ap.add_argument("--tree", default=HERE,
                    help="root of the checkout whose port runs the cells")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--label", default="")
    a = ap.parse_args(argv)
    if a.pack:
        pack(a.pack)
        return 0
    if not a.load:
        ap.error("give --pack or --load")
    r = rates(a.load, os.path.abspath(a.tree), a.passes)
    r["label"] = a.label
    for name in ("loaded", "mimo"):
        for k, run in enumerate(r[name]):
            print(f"{a.label} {name} pass {k}: {run['sf_per_s']:.1f} sf/s "
                  f"({run['s']:.3f} s) {json.dumps(run)}", flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
