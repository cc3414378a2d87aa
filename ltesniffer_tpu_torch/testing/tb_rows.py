"""Seeded fused rows for `kernels/tb_finish.py`: random transport blocks,
segmented and CRC'd as a transmitter does, their code blocks decoded
clean (fillers as 0) or with a planted fault, laid out as a dispatch
lays them out (`pdsch_rx._crc_pack` rows in sub-groups per K, shuffled).
`etm31_grants` is a batch of PDSCH grants of the same E-TM 3.1 shape
through the port's encoder, for the batched path itself.  Used by the CPU
tests, the card tests and `chip_smoke.py` phase 2e.
"""
from __future__ import annotations

import numpy as np
import torch

from ltesniffer_tpu_torch.kernels import tb_finish
from ltesniffer_tpu_torch.phy import crc, tables, turbo as turbo_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx
from ltesniffer_tpu_torch.testing import encoder

# one batch of 32 subframes of the benchmark's E-TM 3.1 cell (4 UEs of 25
# PRB at MCS 17/20/23/26: 128 blocks, 320 code blocks of K 3904-5120) and
# of its loaded cell (12 one-code-block grants a subframe: 384 blocks)
SHAPES = {
    "etm31": [7736, 9912, 12576, 15264] * 32,
    "loaded": [328, 408, 488, 552] * 96,
}


def blocks(tbs: int, rng: np.random.Generator, fault: str = None):
    """(seg, decoded code blocks (K,) u8) of a random block of `tbs` bits.
    Fillers decode as 0, except in a block of one code block, where no CB
    CRC covers them: junk there.  fault "cb": a bit of the last code block
    flipped; "tb": flipped and its CB CRC24B restored (every CB check
    holds, the TB check fails)."""
    seg, blks = turbo_mod.segment(rng.integers(0, 2, tbs).astype(np.uint8))
    blks = [np.where(b == 2, 0, b).astype(np.uint8) for b in blks]
    if seg.C == 1 and seg.F:
        blks[0][:seg.F] = rng.integers(0, 2, seg.F)
    if fault:
        last = blks[-1]
        last[int(rng.integers(0, len(last) - 24))] ^= 1
        if fault == "tb" and seg.C > 1:
            last[-24:] = crc.crc_bits(last[:-24], crc.CRC24B)
    return seg, blks


def lay_out(specs, rng: np.random.Generator, n_groups: int = 3):
    """specs [(tbs, seg, blocks)] -> (fused int64 rows on the CPU, Table):
    each K's code blocks in up to `n_groups` sub-groups, the sub-groups in
    shuffled order."""
    table = tb_finish.Table()
    by_k = {}
    for tbs, seg, blks in specs:
        t = table.add(tbs, seg)
        for r, blk in enumerate(blks):
            by_k.setdefault(len(blk), []).append((t, r, blk))
    subs = []
    for K, items in by_k.items():
        order = rng.permutation(len(items))
        for part in np.array_split(order, min(n_groups, len(items))):
            subs.append((K, [items[i] for i in part]))
    rng.shuffle(subs)
    parts, off = [], 0
    for K, items in subs:
        rows = pdsch_rx._crc_pack(
            torch.from_numpy(np.stack([b for _, _, b in items])), K)
        for r_i, (t, r, _) in enumerate(items):
            table.set_row(t, r, off + r_i * (1 + (K + 31) // 32))
        off += rows.numel()
        parts.append(rows.reshape(-1))
    return torch.cat(parts), table


def defined(out, table) -> list:
    """What a `tb_finish` output defines, for comparing two of them: the
    status words and the payload bytes of each block with bits (the
    padding before the status words and a skipped block's bytes are left
    as they were)."""
    out = out.cpu().numpy()
    return [table.status(out).tolist()] + [
        out[off:off + tbs // 8].tobytes() for tbs, _c, _f, off, _c0
        in table.tb if tbs > 0]


def shape(name: str, rng: np.random.Generator, faults: float = 0.05):
    """(specs, fused, table) of a batch of SHAPES[name], a share `faults`
    of its blocks with a planted fault (alternately "cb" and "tb")."""
    specs = []
    for i, tbs in enumerate(SHAPES[name]):
        fault = (("cb", "tb")[i % 2] if rng.random() < faults else None)
        specs.append((tbs, *blocks(tbs, rng, fault)))
    fused, table = lay_out(specs, rng)
    return specs, fused, table


ETM_CELL = CellConfig(n_id_cell=301, n_prb=100, nof_ports=2, nof_rx_ant=1)


def etm31_grants(n_sf: int, noise: float, rng: np.random.Generator):
    """n_sf subframes of the E-TM 3.1-shaped load (4 UEs of 25 PRB at MCS
    17/20/23/26: 2-3 code blocks of K 3904-5120 a block) through the
    port's encoder, the channel known to the receiver: (grids, h,
    noise_var) CPU tensors, the GrantJobs, the payloads sent."""
    grids, hs, jobs, sent = [], [], [], []
    for b in range(n_sf):
        sf = 1 + b % 4
        g = encoder.build_control_subframe(ETM_CELL, sf, 2, [])
        for u, mcs in enumerate((17, 20, 23, 26)):
            qm, itbs = tables.dl_mcs_to_qm_itbs(mcs, False)
            tbs = tables.tbs_lookup(itbs, 25)
            mask = np.zeros(ETM_CELL.n_prb, bool)
            mask[25 * u:25 * u + 25] = True
            tb = rng.integers(0, 2, tbs).astype(np.uint8)
            rnti = 0x100 + u
            encoder.add_pdsch(g, ETM_CELL, sf, 2, rnti, mask, qm, tb)
            jobs.append(pdsch_rx.GrantJob(b=b, sf_idx=sf, cfi=2, rnti=rnti,
                                          prb_mask=mask, qm=qm, tbs=tbs,
                                          harq_key=(rnti, b, 0)))
            sent.append(np.packbits(tb).tobytes())
        h = encoder.flat_channel(ETM_CELL, 1, rng)
        grids.append(encoder.apply_channel(g, h, noise, rng))
        hs.append(h)

    def ri(x):
        return torch.from_numpy(np.stack(
            [np.stack([a.real, a.imag], -1) for a in x]).astype(np.float32))
    nv = torch.full((n_sf,), noise ** 2, dtype=torch.float32)
    return ri(grids), ri(hs), nv, jobs, sent
