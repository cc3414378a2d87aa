"""Randomized long-run equivalence fuzz of the port's native resolver
against its Python resolver, to run under AddressSanitizer.

The port's counterpart of `scripts/asan_resolver_fuzz.py`.  Run:

    LTESNIFFER_NATIVE_ASAN=1 ASAN_OPTIONS=detect_leaks=0 \
    LD_PRELOAD=$(g++ -print-file-name=libasan.so) \
    python -m ltesniffer_tpu_torch.testing.asan_resolver_fuzz [n_subframes]

Feeds synthetic candidate tables (no device compute): random RNTIs with
repetition bias (drives histogram validation and activation), CCE powers
straddling the power threshold, random formats and SNRs — at least 1e5
candidate decisions.  Asserts equal accepted DCIs per subframe.  The
resolver path is numpy only: this module imports no torch (checked at
the end).  Exercised by tests/test_torch_native_asan.py.
"""
import os
import sys

import numpy as np

from ltesniffer_tpu_torch import native
from ltesniffer_tpu_torch.phy import dci as dci_mod, search_space
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import dci_search, rnti_manager


def main(n_sf: int = 400) -> int:
    if os.environ.get("LTESNIFFER_NATIVE_ASAN") != "1":
        raise SystemExit("run with LTESNIFFER_NATIVE_ASAN=1")
    cell = CellConfig(n_id_cell=123, n_prb=50, nof_ports=2, nof_rx_ant=1)
    nof_cce = cell.nof_cce(2)
    locs = search_space.all_locations(nof_cce)
    sizes = dci_mod.format_sizes(cell)
    fmts = dci_search.FORMAT_ORDER
    S = len({sizes[f] + 16 for f in fmts})
    n_loc = len(locs)

    py = dci_search.DciBlindSearch(cell, rnti_manager.default_manager())
    nat = native.NativeDciBlindSearch(cell, native.default_native_manager())
    print(f"native library: {os.path.basename(native.library_path())}")

    rng = np.random.default_rng(2024)
    pool = rng.integers(0x100, 0xFFF0, 40)   # recurring RNTIs
    n_cand = 0
    n_accept = 0

    def key(a):
        return (a.rnti, a.fmt, a.l, a.ncce, a.histval)

    for t in range(n_sf):
        sf = t % 10
        recur = rng.random((n_loc, S)) < 0.3
        rnti = np.where(recur, rng.choice(pool, (n_loc, S)),
                        rng.integers(0, 0x10000, (n_loc, S)))
        bit0 = rng.integers(0, 2, (n_loc, S))
        meta = rnti | (bit0 << 16)
        cce_power = rng.uniform(0.3, 1.2, nof_cce).astype(np.float32)
        snr = np.float32(rng.uniform(-2.0, 30.0))
        out = {"cand_meta": meta[None], "cce_power": cce_power[None],
               "snr_db": np.array([snr], np.float32)}
        a_py = py.resolve_subframe(out, 0, locs, nof_cce, sf, sfn=t // 10)
        a_nat = nat.resolve_subframe(out, 0, locs, nof_cce, sf, sfn=t // 10)
        if [key(a) for a in a_py] != [key(a) for a in a_nat]:
            print(f"MISMATCH at sf {t}:")
            print(" py :", [key(a) for a in a_py])
            print(" nat:", [key(a) for a in a_nat])
            return 1
        n_cand += n_loc * S
        n_accept += len(a_py)
    if n_cand < 100_000:
        print(f"only {n_cand} candidate decisions (< 1e5)")
        return 1
    if "torch" in sys.modules:
        print("the resolver path imported torch")
        return 1
    print(f"ok: {n_sf} subframes, {n_cand} candidate decisions, "
          f"{n_accept} accepted, native == python golden")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 400))
