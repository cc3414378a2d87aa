"""Seeded batches of PDSCH code blocks for the batched de-rate-match
(`kernels/cb_derm.py`) and the turbo kernel's packing entry: grant jobs of
the E-TM 3.1 and loaded shapes and an odd one (fillers, laps 1-3, rv 0-3,
an in-batch retransmission chain of depth 2, priors stored before the
batch as a `LazyRow` and as a host array), random LLR rows for them, and
the descriptor table a dispatch builds.  Used by the CPU tests, the card
tests and `chip_smoke.py` phase 2g.
"""
from __future__ import annotations

import numpy as np
import torch

from ltesniffer_tpu_torch.phy import tables, turbo as turbo_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx

CELL = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)
N_ITER = 2


def mask(lo, n):
    m = np.zeros(CELL.n_prb, bool)
    m[lo:lo + n] = True
    return m


def job(b, sf, rnti, lo, n_prb, qm, tbs, rv=0, key=None, retx=False):
    return pdsch_rx.GrantJob(b=b, sf_idx=sf, cfi=2, rnti=rnti,
                             prb_mask=mask(lo, n_prb), qm=qm, tbs=tbs,
                             rv=rv, harq_key=key, is_retx=retx)


def etm31_jobs(n_sf):
    jobs = []
    for b in range(n_sf):
        for u, mcs in enumerate((17, 20, 23, 26)):
            qm, itbs = tables.dl_mcs_to_qm_itbs(mcs, False)
            jobs.append(job(b, 1 + b % 4, 0x100 + u, 25 * u, 25, qm,
                             tables.tbs_lookup(itbs, 25),
                             key=(0x100 + u, b, 0)))
    return jobs


def loaded_jobs(n_sf):
    jobs = []
    for b in range(n_sf):
        for g in range(12):
            mcs = 2 + g % 3
            qm, itbs = tables.dl_mcs_to_qm_itbs(mcs, False)
            jobs.append(job(b, 1 + b % 4, 0x200 + g, 8 * g, 8, qm,
                             tables.tbs_lookup(itbs, 8),
                             key=(0x200 + g, b, 0)))
    return jobs


def odd_jobs():
    """Fillers (F > 0), one to three laps, rv 0-3, one and several code
    blocks, an in-batch retransmission chain of depth 2 (one key, rv 0 ->
    2 -> 3), and retransmissions of two keys stored before the batch."""
    jobs = [job(0, 1, 0x301, 0, 2, 2, 40, rv=1),          # K 64, 3 laps
            job(0, 1, 0x302, 6, 6, 4, 528, rv=2),        # F 8
            job(0, 1, 0x303, 9, 12, 4, 1544, rv=3),
            job(0, 1, 0x304, 21, 50, 6, 20616, rv=0),     # C = 4
            job(0, 1, 0x305, 71, 8, 2, 328, key=(5, 0, 0)),
            job(1, 2, 0x305, 71, 8, 2, 328, rv=2, key=(5, 0, 0),
                 retx=True),
            job(2, 3, 0x305, 71, 8, 2, 328, rv=3, key=(5, 0, 0),
                 retx=True),
            job(1, 2, 0x306, 79, 8, 2, 408, rv=2, key=(6, 0, 0),
                 retx=True),
            job(1, 2, 0x307, 87, 8, 2, 488, rv=1, key=(7, 0, 0),
                 retx=True),
            job(2, 3, 0x308, 0, 4, 6, 1800, rv=1)]
    return jobs


def batch(jobs, rng, scale=3.0, device="cpu"):
    """(rows_mat, live, n_re_of) of seeded LLR rows for `jobs`."""
    n_re = {ji: pdsch_rx._src_of(CELL, j)[0] for ji, j in enumerate(jobs)}
    wm = max(pdsch_rx._bucket(n_re[ji]) * j.qm for ji, j in enumerate(jobs))
    rows = (scale * rng.standard_normal((len(jobs), wm))).astype(np.float32)
    return torch.from_numpy(rows).to(device), list(range(len(jobs))), n_re


def stored(jobs, rng, device="cpu"):
    """Soft buffers stored before the batch: a LazyRow for key 6 (its
    parent on `device`) and a host array for key 7 (the synchronous
    route's kind)."""
    bufs = {}
    for ji, j in enumerate(jobs):
        if j.harq_key in ((6, 0, 0), (7, 0, 0)):
            K = turbo_mod.segment_sizes(j.tbs).K[0]
            d = rng.standard_normal((2, 3, K + 4)).astype(np.float32)
            bufs[(j.harq_key, 0)] = (
                pdsch_rx.LazyRow(torch.from_numpy(d).to(device), 1)
                if j.harq_key[0] == 6 else d[0])
    return bufs


BATCHES = {"etm31": lambda: etm31_jobs(3), "loaded": lambda: loaded_jobs(2),
           "odd": odd_jobs}


def table_of(rows_mat, jobs, live, n_re, bufs, n_iter=1):
    """The cb_derm table a dispatch of the batch builds (the dispatch runs,
    on rows_mat's device)."""
    return pdsch_rx._dispatch_code_blocks(rows_mat, jobs, live, n_re, bufs,
                                          n_iter).derm[0]
