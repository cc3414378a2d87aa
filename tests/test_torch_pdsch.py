"""Port parity, PDSCH: single-grant decode, the batched dispatch/finish
path (fused u32 result rows), HARQ soft combining and the iteration
escalation of `ltesniffer_tpu_torch` against the JAX package, mirroring
`tests/test_pdsch_e2e.py` and `tests/test_harq.py`.

Both packages decode the same grids (the JAX frontend's).  Integer
results — fused rows, decoded bits, CRC flags — are compared for
equality.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.phy import tables
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch
from ltesniffer_tpu.sniffer import pdsch_rx as ref_pdsch
from ltesniffer_tpu.sniffer import trackers as ref_trackers
from ltesniffer_tpu.testing import encoder

from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx, trackers

torch.set_num_threads(1)

CFG = dict(n_id_cell=77, n_prb=50, nof_ports=2, nof_rx_ant=1)
REF_CELL, CELL = RefCell(**CFG), CellConfig(**CFG)
CFI = 2


def _tx(sf_idx, grants, rng, noise=0.03):
    """One subframe carrying PDSCH grants [(rnti, prb_mask, qm, tb, rv)]."""
    g = encoder.build_control_subframe(REF_CELL, sf_idx, CFI, [])
    for rnti, mask, qm, tb, rv in grants:
        encoder.add_pdsch(g, REF_CELL, sf_idx, CFI, rnti, mask, qm, tb, rv=rv)
    h = encoder.flat_channel(REF_CELL, 1, rng)
    return encoder.subframe_iq(REF_CELL,
                               encoder.apply_channel(g, h, noise, rng))


def _grids(iqs, sfs):
    """(JAX frontend outputs, the same as torch tensors)."""
    run, _ = ref_pdcch.make_pipeline(REF_CELL, CFI)
    out = run(jnp.asarray(np.stack(iqs).astype(np.complex64)),
              jnp.asarray(np.asarray(sfs, np.int32)))
    ref = (out["grids"], out["h"], out["noise_var"])
    port = tuple(torch.from_numpy(np.array(x)) for x in ref)
    return ref, port


def _mask(a, b):
    m = np.zeros(50, dtype=bool)
    m[a:b] = True
    return m


@pytest.mark.parametrize("case", ["qpsk", "16qam", "64qam", "multi_cb",
                                  "wrong_rnti"])
def test_decode_grant_matches(case):
    rng = np.random.default_rng(len(case))
    qm, i_tbs, mask, noise = {
        "qpsk": (2, 9, _mask(10, 20), 0.03),
        "16qam": (4, 14, _mask(0, 24), 0.02),
        "64qam": (6, 22, _mask(0, 24), 0.02),
        "multi_cb": (6, 26, _mask(0, 50), 0.02),
        "wrong_rnti": (2, 9, _mask(5, 15), 0.03)}[case]
    tbs = tables.tbs_lookup(i_tbs, int(mask.sum()))
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    iq = _tx(3, [(0x1234, mask, qm, tb, 0)], rng, noise)
    ref, port = _grids([iq], [3])
    rnti = 0x4321 if case == "wrong_rnti" else 0x1234
    want = ref_pdsch.decode_grant(*ref, 0, REF_CELL, 3, CFI, rnti=rnti,
                                  prb_mask=mask, qm=qm, tbs=tbs)
    got = pdsch_rx.decode_grant(*port, 0, CELL, 3, CFI, rnti=rnti,
                                prb_mask=mask, qm=qm, tbs=tbs)
    assert got.crc_ok == want.crc_ok == (case != "wrong_rnti")
    assert got.cb_crc_ok == want.cb_crc_ok
    if got.crc_ok:
        np.testing.assert_array_equal(got.tb_bits, tb)
        assert case != "multi_cb" or len(got.cb_crc_ok) > 1


def _rows(pb, host):
    """{(job, code block): fused row (1+Wk,) u32} of a finished batch."""
    out, r0 = {}, 0
    for K, Wk, n_b, rows in pb.group_rows:
        blk = host[r0:r0 + n_b * (1 + Wk)].reshape(n_b, 1 + Wk)
        r0 += n_b * (1 + Wk)
        for r_i, (ji, ci, _F) in enumerate(rows):
            out[(ji, ci)] = blk[r_i]
    return out


def _jobs(mod, grants):
    return [mod.GrantJob(b=b, sf_idx=sf, cfi=CFI, rnti=rnti, prb_mask=mask,
                         qm=qm, tbs=tbs, rv=rv) for (b, sf, rnti, mask, qm,
                                                     tbs, rv) in grants]


def test_batched_fused_rows_equal():
    """Several grants over two subframes, fast (PRB-block) and general
    (center-PRB puncture on subframe 0) eq/demap paths, one and several
    code blocks: the fused [crc | packed bits] rows are equal."""
    rng = np.random.default_rng(11)
    spec = [(0, 0, 0x101, _mask(20, 30), 2, 9), (0, 0, 0x102, _mask(0, 8), 4, 12),
            (1, 4, 0x103, _mask(0, 8), 2, 5), (1, 4, 0x104, _mask(8, 50), 6, 24),
            (1, 4, 0x105, _mask(3, 6), 2, 3)]
    grants, txs = [], {0: [], 1: []}
    for b, sf, rnti, mask, qm, itbs in spec:
        tbs = tables.tbs_lookup(itbs, int(mask.sum()))
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        txs[b].append((rnti, mask, qm, tb, 0))
        grants.append((b, sf, rnti, mask, qm, tbs, 0))
    iqs = [_tx(sf, txs[b], rng) for b, sf in ((0, 0), (1, 4))]
    ref, port = _grids(iqs, [0, 4])
    pb_r = ref_pdsch.dispatch_grants_batch(*ref, REF_CELL,
                                           _jobs(ref_pdsch, grants), n_iter=2)
    res_r = ref_pdsch.finish_grants_batch(pb_r)
    pb_p = pdsch_rx.dispatch_grants_batch(*port, CELL,
                                          _jobs(pdsch_rx, grants), n_iter=2)
    res_p = pdsch_rx.finish_grants_batch(pb_p)
    rows_r = _rows(pb_r, np.asarray(pb_r.fused_dev))
    rows_p = _rows(pb_p, pb_p.fused_dev.numpy().astype(np.uint32))
    assert rows_p.keys() == rows_r.keys() and len(rows_p) > len(spec)
    for k in rows_r:
        np.testing.assert_array_equal(rows_p[k], rows_r[k], str(k))
    assert [r.crc_ok for r in res_p] == [r.crc_ok for r in res_r]
    assert sum(r.crc_ok for r in res_p) >= 3


def test_harq_retransmission_combining_matches():
    """test_pdsch_e2e.py's rv0 -> rv2 soft combining through decode_grant,
    over the same noise ladder: both packages give the same CRC flags."""
    rng = np.random.default_rng(4)
    mask = _mask(0, 8)
    tbs = tables.tbs_lookup(15, 8)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    seen = []
    for noise in (0.35, 0.45, 0.55, 0.65):
        bufs_r, bufs_p = {}, {}
        key = (0x7777, 0, 0)
        oks = []
        for rv in (0, 2):
            iq = _tx(6, [(0x7777, mask, 4, tb, rv)], rng, noise)
            ref, port = _grids([iq], [6])
            want = ref_pdsch.decode_grant(
                *ref, 0, REF_CELL, 6, CFI, rnti=0x7777, prb_mask=mask, qm=4,
                tbs=tbs, rv=rv, soft_buffers=bufs_r, harq_key=key)
            got = pdsch_rx.decode_grant(
                *port, 0, CELL, 6, CFI, rnti=0x7777, prb_mask=mask, qm=4,
                tbs=tbs, rv=rv, soft_buffers=bufs_p, harq_key=key)
            assert got.crc_ok == want.crc_ok
            oks.append(got.crc_ok)
        assert bufs_p.keys() == bufs_r.keys()
        seen.append(tuple(oks))
    assert (False, True) in seen, seen


def test_in_batch_harq_chain_matches():
    """test_harq.py's in-batch chain: an rv0 row's combined LLRs feed the
    rv2 row's prior inside one dispatch, in both packages alike."""
    rng = np.random.default_rng(4)
    mask = _mask(0, 8)
    tbs = tables.tbs_lookup(15, 8)
    tb = rng.integers(0, 2, tbs).astype(np.uint8)
    key = (0x7777, 0, 0)
    seen = []
    for noise in (0.35, 0.45, 0.55, 0.65):
        iqs = [_tx(6, [(0x7777, mask, 4, tb, rv)], rng, noise)
               for rv in (0, 2)]
        ref, port = _grids(iqs, [6, 6])
        out = []
        for mod, grids, bufs, cell in (
                (ref_pdsch, ref, ref_trackers.SoftBufferPool(), REF_CELL),
                (pdsch_rx, port, trackers.SoftBufferPool(), CELL)):
            jobs = [mod.GrantJob(b=b, sf_idx=6, cfi=CFI, rnti=0x7777,
                                 prb_mask=mask, qm=4, tbs=tbs, rv=rv,
                                 harq_key=key, is_retx=(b == 1))
                    for b, rv in ((0, 0), (1, 2))]
            res = mod.decode_grants_batch(*grids, cell, jobs,
                                          soft_buffers=bufs)
            out.append(([r.crc_ok for r in res], len(bufs)))
        assert out[0] == out[1]
        seen.append(tuple(out[1][0]))
    assert (False, True) in seen, seen


def test_escalation_matches():
    """Primary pass at 2 iterations, CRC failures re-decoded at 12 from
    the stored combined LLRs: the same jobs flip to CRC-ok in both."""
    rng = np.random.default_rng(21)
    spec = [(0x201 + i, _mask(8 * i, 8 * i + 8), 4, 15) for i in range(6)]
    grants, txs = [], []
    for rnti, mask, qm, itbs in spec:
        tbs = tables.tbs_lookup(itbs, 8)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        txs.append((rnti, mask, qm, tb, 0))
        grants.append((0, 2, rnti, mask, qm, tbs, 0))
    iq = _tx(2, txs, rng, noise=0.35)
    ref, port = _grids([iq], [2])
    flips = []
    for mod, grids, cell in ((ref_pdsch, ref, REF_CELL),
                             (pdsch_rx, port, CELL)):
        pb = mod.dispatch_grants_batch(*grids, cell, _jobs(mod, grants),
                                       n_iter=2)
        res = mod.finish_grants_batch(pb)
        first = [r.crc_ok for r in res]
        esc = [i for i, r in enumerate(res) if not r.crc_ok]
        n = mod.escalate_finish(pb, mod.escalate_dispatch(pb, esc, 12))
        flips.append((first, n, [r.crc_ok for r in pb.results]))
    assert flips[0] == flips[1]
    assert flips[1][1] > 0, flips


def test_escalate_failures_matches():
    """The synchronous `escalate_failures` of both packages, after a
    2-iteration pass, at 12 iterations: the same jobs flip to CRC-ok, and
    the port's equals its own dispatch + finish."""
    rng = np.random.default_rng(22)
    spec = [(0x301 + i, _mask(8 * i, 8 * i + 8), 4, 15) for i in range(6)]
    grants, txs = [], []
    for rnti, mask, qm, itbs in spec:
        tbs = tables.tbs_lookup(itbs, 8)
        tb = rng.integers(0, 2, tbs).astype(np.uint8)
        txs.append((rnti, mask, qm, tb, 0))
        grants.append((0, 3, rnti, mask, qm, tbs, 0))
    iq = _tx(3, txs, rng, noise=0.35)
    ref, port = _grids([iq], [3])
    flips = []
    for mod, grids, cell, esc in (
            (ref_pdsch, ref, REF_CELL, ref_pdsch.escalate_failures),
            (pdsch_rx, port, CELL, pdsch_rx.escalate_failures),
            (pdsch_rx, port, CELL, lambda pb, idx, n: pdsch_rx.
             escalate_finish(pb, pdsch_rx.escalate_dispatch(pb, idx, n)))):
        pb = mod.dispatch_grants_batch(*grids, cell, _jobs(mod, grants),
                                       n_iter=2)
        res = mod.finish_grants_batch(pb)
        first = [r.crc_ok for r in res]
        n = esc(pb, [i for i, r in enumerate(res) if not r.crc_ok], 12)
        flips.append((first, n, [r.crc_ok for r in pb.results],
                      [None if r.tb_bits is None else r.tb_bits.tolist()
                       for r in pb.results]))
    assert flips[0] == flips[1] == flips[2]
    assert flips[1][1] > 0 and not all(flips[1][0]), flips


def test_gold_basis_built_once_per_length():
    """The PDSCH descrambler's Gold bases are cached per length without a
    bound: a loaded cell cycles through more lengths (RE bucket x Qm) than
    a small LRU holds, and a rebuild costs a Python LFSR run per call."""
    import torch
    from ltesniffer_tpu_torch.phy import sequences
    lengths = sorted({256 * k * qm for k in range(1, 7) for qm in (2, 4, 6)})
    assert len(lengths) > 8
    c_init = torch.tensor([0x1234, 0x4321], dtype=torch.int64)
    sequences.gold_basis.cache_clear()
    for _ in range(2):
        for n in lengths:
            sequences.gold_sequence_torch(c_init, n)
    info = sequences.gold_basis.cache_info()
    assert info.misses == len(lengths) and info.hits == len(lengths)
    for n in (lengths[0], lengths[-1]):
        got = sequences.gold_sequence_torch(c_init, n).numpy()
        for row, c in zip(got, (0x1234, 0x4321)):
            np.testing.assert_array_equal(row,
                                          sequences.gold_sequence(c, n))
