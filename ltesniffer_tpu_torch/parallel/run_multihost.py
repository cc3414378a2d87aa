"""Multi-host runner: N OS processes, one per contiguous time block.

The port's counterpart of `scripts/run_multihost.py`.  Each "host" is a
separate process with its own `LTESnifferCore` and tracker state; the
parent performs the ownership merge (`parallel.multihost`).  On real
deployments each process runs on its own host and cards and ingests its
block of the stream; here the blocks come from one trace file.

Usage:
    python -m ltesniffer_tpu_torch.parallel.run_multihost -i trace.iq \
        -c 55 -p 50 -P 2 -n 2 -o merged.pcap [--overlap 200] \
        [--device cuda]

With `--device cuda` (the default) child k runs on
`cuda:{k % torch.cuda.device_count()}`, and the runner raises when there
is no card; `--device cpu` runs every child on the CPU.  The parent
prints each child's device, and fails if any child fails.

Child protocol (internal): --child <host_idx> runs one block on
--child-device and writes host<k>.pcap + host<k>.json (decode results)
into --workdir.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-c", "--cell-id", type=int, required=True)
    p.add_argument("-p", "--prb", type=int, default=50)
    p.add_argument("-P", "--ports", type=int, default=2)
    p.add_argument("-n", "--hosts", type=int, default=2)
    p.add_argument("-o", "--output", default="merged.pcap")
    p.add_argument("-B", "--batch", type=int, default=32)
    p.add_argument("--overlap", type=int, default=200)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (child k on cuda:{k %% cards}) or cpu")
    p.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--child-device", default=None, help=argparse.SUPPRESS)
    return p


def _cell(args):
    from ltesniffer_tpu_torch.phy.params import CellConfig
    return CellConfig(n_id_cell=args.cell_id, n_prb=args.prb,
                      nof_ports=args.ports, nof_rx_ant=1)


def child_devices(device: str, n_hosts: int):
    """The device of each child: cuda:{k % cards} for "cuda", else the
    given device for every child."""
    if device != "cuda":
        return [device] * n_hosts
    import torch
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("--device cuda but no CUDA device is available")
    return [f"cuda:{k % n}" for k in range(n_hosts)]


def run_child(args) -> int:
    from ltesniffer_tpu_torch.io import iq as iq_mod
    from ltesniffer_tpu_torch.parallel import multihost
    from ltesniffer_tpu_torch.sniffer import core

    cell = _cell(args)
    samples = iq_mod.read_iq(args.input)
    blocks = multihost.split_blocks(samples, args.hosts, cell,
                                    overlap_sf=args.overlap)
    blk = blocks[args.child]

    def factory(b):
        cfg = core.SnifferConfig(
            cell=cell, batch_size=args.batch, device=args.child_device,
            pcap_path=os.path.join(args.workdir, f"host{b.host}.pcap"))
        return core.LTESnifferCore(cfg)

    t0 = time.perf_counter()
    c = multihost.run_block(factory, blk)
    c.close()
    seconds = time.perf_counter() - t0
    from ltesniffer_tpu_torch.kernels import bcjr, pdcch_tail, turbo_decode
    from ltesniffer_tpu_torch.kernels import viterbi
    with open(os.path.join(args.workdir, f"host{args.child}.json"), "w") as f:
        json.dump({"device": args.child_device, "seconds": seconds,
                   "subframes": len(blk.samples) // cell.sf_len,
                   "launches": {"turbo_decode":
                                turbo_decode.LAUNCHES["turbo_decode"],
                                "bcjr": bcjr.LAUNCHES["bcjr"],
                                "viterbi": viterbi.LAUNCHES["viterbi"],
                                "viterbi_plain_cuda":
                                viterbi.PLAIN_CUDA["viterbi"],
                                **pdcch_tail.LAUNCHES,
                                "pdcch_tail_plain_cuda":
                                sum(pdcch_tail.PLAIN_CUDA.values())},
                   "summary": c.summary(),
                   "results": [dict(sfn=r.dci.sfn, sf_idx=r.dci.sf_idx,
                                    rnti=r.dci.rnti, fmt=r.dci.fmt,
                                    ncce=r.dci.ncce, crc_ok=r.crc_ok,
                                    tbs=r.tbs)
                               for r in c.results]}, f)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.child is not None:
        return run_child(args)

    devices = child_devices(args.device, args.hosts)
    args.workdir = args.workdir or tempfile.mkdtemp(prefix="mh_")
    os.makedirs(args.workdir, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = []
    for h, dev in enumerate(devices):
        print(f"[multihost] child {h} on {dev}", flush=True)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ltesniffer_tpu_torch.parallel."
             "run_multihost",
             "-i", args.input, "-c", str(args.cell_id), "-p", str(args.prb),
             "-P", str(args.ports), "-n", str(args.hosts),
             "-B", str(args.batch), "--overlap", str(args.overlap),
             "--workdir", args.workdir, "--child", str(h),
             "--child-device", dev], env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        print(f"[multihost] child failures: {rcs}", file=sys.stderr)
        return 1

    # ownership merge of the per-host pcaps
    from ltesniffer_tpu_torch.io import iq as iq_mod, pcap as pcap_mod
    from ltesniffer_tpu_torch.parallel import multihost
    cell = _cell(args)
    samples = iq_mod.read_iq(args.input)
    blocks = multihost.split_blocks(samples, args.hosts, cell,
                                    overlap_sf=args.overlap)
    per_host = [pcap_mod.read_pcap(os.path.join(args.workdir,
                                                f"host{h}.pcap"))
                for h in range(args.hosts)]
    merged = multihost.merge_pcap_records(per_host, blocks)
    w = pcap_mod.MacLtePcapWriter(args.output)
    for r in merged:
        w.write_pdu(r["payload"], rnti=r["rnti"], direction=r["direction"],
                    sfn=r["sfn"], sf_idx=r["sf_idx"],
                    crc_ok=r.get("crc_ok", True), retx=r.get("retx", 0))
    w.close()
    print(f"[multihost] {args.hosts} hosts -> {len(merged)} merged records "
          f"-> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
