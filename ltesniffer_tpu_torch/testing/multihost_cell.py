"""The loaded cell in time blocks: the multi-host scenario.

The loaded cell (`loaded_cell.build_stream`, 20 MHz, 512 subframes) as
complex samples, cut by `parallel.multihost.split_blocks` into N_HOSTS
contiguous blocks with OVERLAP_SF subframes of tracker replay, each run
by a fresh core through `run_block` (`run_samples`, i8 ingest, batch
BATCH), then merged.  BATCH divides both the block boundary (256) and the
replay start (256 - 200 = 56), so every batch of every block holds the
same subframes as a batch of the single-host run.

The helpers take the package's `core` and `multihost` modules as
arguments, so the JAX package's run that makes the expected record
(`multihost_expected.json`, `python -m tests.test_torch_multihost
--regen-multihost`) and the port's run on the card (`chip_smoke.py`
phase 8b) share them; this module imports neither package's core.
"""
from __future__ import annotations

import collections
import os
import time

from ltesniffer_tpu_torch.testing import loaded_cell

N_HOSTS = 2
OVERLAP_SF = 200
BATCH = 8


def params() -> dict:
    """The scenario's parameters, as the expected record stores them."""
    return dict(loaded_cell.params(), n_hosts=N_HOSTS,
                overlap_sf=OVERLAP_SF, batch_size=BATCH)


def _logged(core_mod, cfg):
    """A core whose accepted DCIs are logged as [tti, rnti, format]."""
    c = core_mod.LTESnifferCore(cfg)
    log = []

    def hook(ctx):
        for a in ctx["accepted"]:
            log.append([ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt])
    c.on_subframe = hook
    return c, log


def run_single(core_mod, cell, stream, pcap_path: str, sync=None, **kw):
    """One core over the whole stream.  Returns (core, DCI log, seconds);
    `sync` (if given) is called before the clock stops."""
    c, log = _logged(core_mod, core_mod.SnifferConfig(
        cell=cell, batch_size=BATCH, pcap_path=pcap_path, **kw))
    t0 = time.perf_counter()
    c.run_samples(stream)
    if sync is not None:
        sync()
    dt = time.perf_counter() - t0
    c.close()
    return c, log, dt


def run_hosts(core_mod, multihost_mod, cell, stream, workdir: str,
              sync=None, **kw):
    """Every block through `run_block`, one after another, each with a
    fresh core writing host<k>.pcap into `workdir`.  Returns (blocks,
    cores, per-host DCI logs, per-host seconds)."""
    blocks = multihost_mod.split_blocks(stream, N_HOSTS, cell,
                                        overlap_sf=OVERLAP_SF)
    cores, logs, secs = [], [], []
    for blk in blocks:
        def factory(b):
            c, log = _logged(core_mod, core_mod.SnifferConfig(
                cell=cell, batch_size=BATCH,
                pcap_path=os.path.join(workdir, f"host{b.host}.pcap"), **kw))
            logs.append(log)
            return c
        t0 = time.perf_counter()
        c = multihost_mod.run_block(factory, blk)
        if sync is not None:
            sync()
        secs.append(time.perf_counter() - t0)
        c.close()
        cores.append(c)
    return blocks, cores, logs, secs


def merged_dcis(multihost_mod, logs, blocks):
    """The per-host DCI logs through the ownership merge."""
    return multihost_mod.merge_accepted(
        logs, blocks, key=lambda d: divmod(d[0], 10))


def pcap_key(r: dict) -> tuple:
    return (r["sfn"], r["sf_idx"], r["rnti"], r["direction"],
            bytes(r["payload"]))


def count_differing(recs_a, recs_b) -> int:
    """Records in one list and not the other, as multisets of pcap_key."""
    a = collections.Counter(pcap_key(r) for r in recs_a)
    b = collections.Counter(pcap_key(r) for r in recs_b)
    return sum(((a - b) + (b - a)).values())


def record(dcis, results, n_single: int, n_merged: int,
           n_differ: int) -> dict:
    """Compact record of a merged run: the merged accepted-DCI list, for
    each merged PDSCH result the index of its DCI and its CRC flag, and
    the pcap record counts of the single-host and merged runs."""
    index = {}
    for i, (tti, rnti, fmt) in enumerate(dcis):
        index.setdefault((tti, rnti, fmt), i)
    pdsch_dci, ok = [], []
    for r in results:
        pdsch_dci.append(index[(r.dci.sfn * 10 + r.dci.sf_idx,
                                int(r.dci.rnti), r.dci.fmt)])
        ok.append("1" if r.crc_ok else "0")
    return {"params": params(), "dcis": [list(d) for d in dcis],
            "pdsch_dci": pdsch_dci, "pdsch_ok": "".join(ok),
            "n_records_single": n_single, "n_records_merged": n_merged,
            "n_records_differ": n_differ}
