"""Command-line interface (offline file replay), on the CUDA card.

Counterpart of `ltesniffer_tpu/cli.py`, with the same flags and routing,
plus `--device` (default `cuda`; `cpu` is for tests — `cuda` without a
card raises, nothing falls back).  Mirrors the reference's file-mode
arguments (`src/src/ArgManager.cc:107-231`:
``-i <iq_file> -c <cell_id> -p <prb> -P <ports> ...``) with long options.

Example:
    python -m ltesniffer_tpu_torch.cli -i trace.iq -c 301 -p 50 -P 2 \
        -o out.pcap --sync
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ltesniffer_tpu_torch",
                                description=__doc__.split("\n")[0])
    p.add_argument("-i", "--input", required=True, help="IQ trace file "
                   "(interleaved complex float32)")
    p.add_argument("-c", "--cell-id", type=int, default=None,
                   help="physical cell id (omit to cell-search)")
    p.add_argument("-p", "--prb", type=int, default=50,
                   help="downlink bandwidth in PRB")
    p.add_argument("-P", "--ports", type=int, default=2,
                   help="eNB CRS antenna ports")
    p.add_argument("-A", "--rx-antennas", type=int, default=1)
    p.add_argument("-o", "--output", default="ltesniffer_dl_mode.pcap",
                   help="MAC-LTE pcap output")
    p.add_argument("-z", "--api-output", default=None,
                   help="security-API pcap output (enables api mode)")
    p.add_argument("-u", "--ul-input", default=None,
                   help="UL carrier IQ trace (enables DL+UL mode)")
    p.add_argument("--api", action="store_true",
                   help="enable the security API (identity extraction)")
    p.add_argument("-n", "--nof-subframes", type=int, default=None)
    p.add_argument("-t", "--threshold", type=int, default=5,
                   help="RNTI histogram threshold")
    p.add_argument("-B", "--batch", type=int, default=32,
                   help="subframes per device batch")
    p.add_argument("--sync", nargs="?", const="stream",
                   choices=("stream", "once"), default=None,
                   help="run PSS/SSS sync to align the trace: 'stream' "
                   "(default) tracks PSS continuously with drift correction "
                   "and re-acquire, 'once' does a one-shot alignment (else "
                   "assume the file starts at a subframe boundary)")
    p.add_argument("--no-pdsch", action="store_true",
                   help="DCI/RNTI search only (no PDSCH decode)")
    p.add_argument("--stats-json", default=None,
                   help="write summary stats to this JSON file")
    p.add_argument("--heartbeat", action="store_true",
                   help="print the per-1000-subframe progress heartbeat")
    p.add_argument("--tables", type=float, default=0.0, metavar="SEC",
                   help="print per-RNTI DL/UL tables every SEC seconds")
    p.add_argument("-D", "--dci-trace", default=None, metavar="PATH",
                   help="write tab-separated per-DCI trace lines to PATH")
    p.add_argument("--csv", default=None, metavar="PATH",
                   help="write mcs_statistic.csv-style stats to PATH on exit")
    p.add_argument("--draw", action="store_true",
                   help="print ASCII RB-allocation / UL power maps per "
                   "subframe (DCIDrawASCII/PowerDrawASCII analog)")
    p.add_argument("--live", action="store_true",
                   help="emulate real-time ingest: drop + count subframes "
                   "when processing lags the 1 ms cadence (the reference's "
                   "overload shedding); requires --sync stream mode")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DSP path (default cuda; cpu "
                   "for tests)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import os
    from ltesniffer_tpu_torch.io import iq as iq_mod
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import (core, observability,
                                              sync as sync_mod)

    if not os.path.exists(args.input):
        print(f"[cli] input file not found: {args.input}", file=sys.stderr)
        return 2
    samples = iq_mod.read_iq(args.input)
    print(f"[cli] loaded {len(samples)} samples from {args.input}")

    n_fft = CellConfig(n_id_cell=0, n_prb=args.prb).n_fft
    sf_idx0 = 0
    cell_id = args.cell_id
    use_stream = args.sync == "stream" and not args.ul_input
    if (args.sync == "once" or (args.sync and args.ul_input)
            or (cell_id is None and not use_stream)):
        # one-shot alignment: global CFO mix + fixed framing
        sr = sync_mod.find_cell(samples[:20 * 15360 * n_fft // 1024], n_fft)
        if sr is None:
            print("[cli] no cell found in trace", file=sys.stderr)
            return 2
        print(f"[cli] cell search: PCI={sr.n_id_cell} peak={sr.peak:.2f} "
              f"cfo={sr.cfo:.3f}sc offset={sr.subframe_offset}")
        if cell_id is not None and cell_id != sr.n_id_cell:
            print(f"[cli] warning: preset cell {cell_id} != found "
                  f"{sr.n_id_cell}; using preset")
        else:
            cell_id = sr.n_id_cell
        samples = sync_mod.correct_cfo(samples[sr.subframe_offset:],
                                       sr.cfo, n_fft)
        sf_idx0 = 5 if sr.is_subframe5 else 0
    elif use_stream and cell_id is None:
        sr = sync_mod.find_cell(samples[:20 * 15360 * n_fft // 1024], n_fft)
        if sr is None:
            print("[cli] no cell found in trace", file=sys.stderr)
            return 2
        print(f"[cli] cell search: PCI={sr.n_id_cell} peak={sr.peak:.2f}")
        cell_id = sr.n_id_cell

    cell = CellConfig(n_id_cell=cell_id, n_prb=args.prb,
                      nof_ports=args.ports, nof_rx_ant=args.rx_antennas)
    api_mode = 0 if (args.api or args.api_output) else -1
    cfg = core.SnifferConfig(cell=cell, batch_size=args.batch,
                             pcap_path=args.output,
                             api_pcap_path=args.api_output,
                             histogram_threshold=args.threshold,
                             decode_pdsch=not args.no_pdsch,
                             api_mode=api_mode,
                             heartbeat=args.heartbeat,
                             table_every_s=args.tables,
                             dci_trace_path=args.dci_trace,
                             mcs_csv_path=args.csv,
                             draw_maps=args.draw,
                             live_mode=args.live,
                             # file-mode parity: SFN preset unless stream
                             # sync runs (`LTESniffer_Core.cc:239`)
                             acquire_sfn=bool(use_stream),
                             device=args.device)
    t0 = time.time()
    if args.ul_input:
        if not os.path.exists(args.ul_input):
            print(f"[cli] UL input not found: {args.ul_input}",
                  file=sys.stderr)
            return 2
        ul = iq_mod.read_iq(args.ul_input)
        sniffer = core.LTESnifferCoreUL(cfg)
        run = lambda: sniffer.run_dual_samples(  # noqa: E731
            samples, ul, sf_idx0=sf_idx0, max_subframes=args.nof_subframes)
    else:
        sniffer = core.LTESnifferCore(cfg)
        if use_stream:
            # continuous PSS tracking with drift correction + re-acquire
            # (`LTESniffer_Core.cc:361-528` sync loop analog)
            run = lambda: sniffer.run_stream(  # noqa: E731
                samples, max_subframes=args.nof_subframes)
        else:
            run = lambda: sniffer.run_samples(  # noqa: E731
                samples, sf_idx0=sf_idx0, max_subframes=args.nof_subframes)

    # SIGINT -> graceful stop: drain in-flight batches, flush pcap/trace
    # (`SignalManager.cc` + `LTESniffer_Core.cc:540-556`)
    import signal

    def _on_sigint(signum, frame):
        print("\n[cli] SIGINT: stopping (second ^C force-quits)...",
              file=sys.stderr)
        sniffer.request_stop()
        signal.signal(signal.SIGINT, signal.default_int_handler)

    old_handler = signal.signal(signal.SIGINT, _on_sigint)
    try:
        run()
    finally:
        signal.signal(signal.SIGINT, old_handler)
    dt = time.time() - t0
    sniffer.close()
    s = sniffer.summary()
    s["wall_s"] = round(dt, 3)
    s["subframes_per_s"] = round(s["subframes"] / dt, 1) if dt > 0 else 0
    print(f"[cli] processed {s['subframes']} subframes in {dt:.2f}s "
          f"({s['subframes_per_s']} sf/s): {s['dcis']} DCIs, "
          f"{s['pdsch_ok']} PDSCH ok, {s['active_rntis']} active RNTIs")
    print(f"[cli] pcap written to {args.output}")
    print(observability.format_dl_table(sniffer.mcs, sniffer.rm))
    if getattr(sniffer, "ul_results", None):
        print(observability.format_ul_table(sniffer.mcs))
    if sniffer.api is not None:
        print(observability.format_api_table(sniffer.api))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(s, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
