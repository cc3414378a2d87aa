"""The transport-block finish of the batched PDSCH path
(`kernels/tb_finish.py`): its plain version against the host's finish
(`pdsch_rx._finish_tb`, CB and TB CRCs by `crc.crc_bits`) bit for bit, a
numpy model of the CUDA kernel's per-thread work against the plain
version, and the batched path's results (primary, escalation, table
retry, the loaded cell through a core) against the host assembly the
port ran before, from the same fused rows.

Imports neither JAX nor the reference package.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.kernels import tb_finish
from ltesniffer_tpu_torch.phy import crc
from ltesniffer_tpu_torch.phy import turbo as turbo_mod
from ltesniffer_tpu_torch.sniffer import pdsch_rx, prof
from ltesniffer_tpu_torch.testing import tb_rows

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    prof.reset()
    yield
    prof.reset()


def _finish(fused, table):
    _host, desc = tb_finish.upload(table, "cpu")
    return tb_finish.finish(fused, table, desc).numpy()


def _check_against_host(out, table, specs):
    status = table.status(out)
    for t, (tbs, seg, blocks) in enumerate(specs):
        want = pdsch_rx._finish_tb(seg, blocks, [], 0, tbs, 0, None, None)
        st = int(status[t])
        assert bool(st & 1) == want.crc_ok, t
        assert [bool(st >> (1 + r) & 1) for r in range(seg.C)] \
            == want.cb_crc_ok, t
        assert st >> (1 + seg.C) == 0
        if want.crc_ok:
            off = table.offset(t)
            assert out[off:off + tbs // 8].tobytes() \
                == np.packbits(want.tb_bits).tobytes()
    return status


CASES = {
    "c1": [16, 328, 6120],
    "c1_fillers": [8, 528],
    "c2_c3": [6200, 12384, 7736, 15264],
    "mixed_k": [6136, 6128, 12256, 12224],
    "c13": [75376],
    "c16": [97896],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_host_finish(case):
    rng = np.random.default_rng(len(case))
    specs = [(tbs, *tb_rows.blocks(tbs, rng)) for tbs in CASES[case]]
    segs = [s for _, s, _ in specs]
    if case == "c1_fillers":
        assert all(s.C == 1 and s.F for s in segs)
    if case == "mixed_k":
        assert all(len(set(s.K)) == 2 for s in segs) and any(s.F for s in segs)
    if case in ("c13", "c16"):
        assert segs[0].C == int(case[1:])
    fused, table = tb_rows.lay_out(specs, rng)
    status = _check_against_host(_finish(fused, table), table, specs)
    assert all(int(s) & 1 for s in status)


@pytest.mark.parametrize("fault", ["cb", "tb"])
@pytest.mark.parametrize("tbs", [16, 528, 6128, 15264])
def test_plain_flags_a_fault_as_the_host(fault, tbs):
    """A corrupted code block clears its CB bit and the TB bit; every CB
    check holding with a wrong TB CRC clears the TB bit alone."""
    rng = np.random.default_rng(tbs)
    specs = [(tbs, *tb_rows.blocks(tbs, rng, fault)), (tbs, *tb_rows.blocks(tbs, rng))]
    fused, table = tb_rows.lay_out(specs, rng)
    status = _check_against_host(_finish(fused, table), table, specs)
    C = specs[0][1].C
    assert int(status[0]) & 1 == 0 and int(status[1]) & 1 == 1
    if C > 1:
        want_cb = (1 << C) - 1 if fault == "tb" else (1 << (C - 1)) - 1
        assert int(status[0]) >> 1 == want_cb


def test_plain_skips_blocks_without_bits():
    """A descriptor with tbs <= 0 gets status 0 and writes nothing; the
    others are as before."""
    rng = np.random.default_rng(5)
    specs = [(tbs, *tb_rows.blocks(tbs, rng)) for tbs in (6200, 328)]
    fused, table = tb_rows.lay_out(specs, rng)
    want = _finish(fused, table)
    table.tb[0][0] = 0
    _host, desc = tb_finish.upload(table, "cpu")
    got = tb_finish.finish_plain(fused, desc, table.n_tb, table.stat_off,
                                 table.n_out).numpy()
    assert int(table.status(got)[0]) == 0
    assert int(table.status(got)[1]) == int(table.status(want)[1])
    assert not got[:6200 // 8].any()
    assert got[6200 // 8:table.stat_off].tobytes() \
        == want[6200 // 8:table.stat_off].tobytes()


def test_table_refuses_what_the_kernel_cannot_take():
    t = tb_finish.Table()
    for tbs in (0, -8, 100):
        with pytest.raises(ValueError):
            t.add(tbs, turbo_mod.segment_sizes(max(tbs, 8)))
    assert t.n_tb == 0
    t.add(16, turbo_mod.segment_sizes(16))
    fused = torch.zeros(2, dtype=torch.int64)
    _host, desc = tb_finish.upload(t, "cpu")
    with pytest.raises(ValueError):          # its row was never set
        tb_finish.finish(fused, t, desc)
    t.set_row(0, 0, 1)
    with pytest.raises(ValueError):          # past the end of fused
        tb_finish.finish(fused, t, desc)


# --- a numpy model of the kernel ---------------------------------------------
def _mulmod(a, b):
    poly = 0x1864CFB
    r = 0
    for i in range(23, -1, -1):
        r = (r << 1) ^ (poly if r & 0x800000 else 0)
        r ^= a if (b >> i) & 1 else 0
    return r


def _kernel_model(fused, table):
    """The kernel's work, thread by thread: each thread's span of the
    stream's bytes gathered from the row words (bit-reversed bytes), the
    span's CRC by the byte table, shifted by the powers of x^8, XORed."""
    tab = tb_finish.crc_table().view(np.uint32).astype(np.int64)
    f = fused.numpy()
    out = np.zeros(table.n_out, np.uint8)
    status = np.zeros(table.n_tb, np.uint32)
    for t, (tbs, C, F, off, c0) in enumerate(table.tb):
        rows = [table.cb[c0 + r][0] for r in range(C)]
        nbytes = [(table.cb[c0 + r][1] - (24 if C > 1 else 0)
                   - (F if r == 0 else 0)) >> 3 for r in range(C)]
        pre = np.concatenate([[0], np.cumsum(nbytes)])
        skip = [F >> 3] + [0] * (C - 1)
        nb = int(pre[-1])
        assert 8 * nb == tbs + 24
        per = -(-nb // tb_finish.THREADS)
        total = 0
        for tid in range(tb_finish.THREADS):
            j, end, r = tid * per, min(nb, tid * per + per), 0
            if j >= end:
                continue
            for j in range(j, end):
                c = int(np.searchsorted(pre, j, side="right")) - 1
                q = skip[c] + j - int(pre[c])
                w = int(f[rows[c] + 1 + (q >> 2)]) & 0xFFFFFFFF
                v = int(f"{(w >> ((q & 3) * 8)) & 0xFF:08b}"[::-1], 2)
                if j < tbs // 8:
                    out[off + j] = v
                r = ((r << 8) & 0xFFFFFF) ^ int(tab[((r >> 16) ^ v) & 0xFF])
            n, k = nb - end, 0
            while n:
                if n & 1:
                    r = _mulmod(r, int(tab[256 + k]))
                n, k = n >> 1, k + 1
            total ^= r
        cbok = sum(1 << r for r in range(C)
                   if C == 1 or int(f[rows[r]]) == 0)
        st = cbok << 1
        if total == 0 and cbok == (1 << C) - 1:
            st |= 1
        status[t] = st
    out[table.stat_off:] = status.astype("<u4").view(np.uint8)
    return out


@pytest.mark.parametrize("case", ["c1_fillers", "mixed_k", "fault"])
def test_kernel_model_matches_plain(case):
    rng = np.random.default_rng(17)
    if case == "fault":
        specs = [(6128, *tb_rows.blocks(6128, rng, "tb")),
                 (528, *tb_rows.blocks(528, rng, "cb")),
                 (12224, *tb_rows.blocks(12224, rng, "cb"))]
    else:
        specs = [(tbs, *tb_rows.blocks(tbs, rng)) for tbs in CASES[case]]
    fused, table = tb_rows.lay_out(specs, rng)
    got = _kernel_model(fused, table)
    assert got.tobytes() == _finish(fused, table).tobytes()


def test_crc_table_powers():
    """The table's byte remainders are phy/crc.py's CRC24A of each byte,
    and its powers x^(8 2^j) mod g(x) shift a remainder as 8 2^j zero
    bits appended would."""
    tab = tb_finish.crc_table().view(np.uint32)
    for b in (0, 1, 0x80, 0xA5, 0xFF):
        bits = np.unpackbits(np.array([b], np.uint8))
        assert int(tab[b]) == crc.bits_to_int(crc.crc_bits(bits, crc.CRC24A))
    msg = np.random.default_rng(0).integers(0, 2, 40).astype(np.uint8)
    r = crc.bits_to_int(crc.crc_bits(msg, crc.CRC24A))
    for j in range(4):
        zeros = np.zeros(8 << j, np.uint8)
        want = crc.bits_to_int(crc.crc_bits(np.concatenate([msg, zeros]),
                                            crc.CRC24A))
        assert _mulmod(r, int(tab[256 + j])) == want


# --- the batched path against the host assembly ------------------------------
def _host_assembly(jobs, seg_of, rows_of):
    """ji -> (crc_ok, cb_crc_ok, payload) as the host assembled them before
    `tb_finish`: every row's bits unpacked, CB CRC24B from the row's
    remainder, TB CRC24A by `crc.crc_bits`.  rows_of: (ji, ci) -> row."""
    out = {}
    for ji, seg in seg_of.items():
        if any((ji, ci) not in rows_of for ci in range(seg.C)):
            continue
        j, cb_ok, parts = jobs[ji], [], []
        for ci, K in enumerate(seg.K):
            row = rows_of[(ji, ci)].astype(np.uint32)
            bits = ((row[1:, None] >> np.arange(32, dtype=np.uint32)) & 1)
            blk = bits.astype(np.uint8).reshape(-1)[:K]
            F = seg.F if ci == 0 else 0
            if seg.C > 1:
                cb_ok.append(int(row[0]) == 0)
                parts.append(blk[F:K - 24])
            else:
                cb_ok.append(True)
                parts.append(blk[F:])
        tb = np.concatenate(parts)[:seg.B]
        ok = all(cb_ok) and crc.crc_bits(tb, crc.CRC24A).sum() == 0
        out[ji] = (bool(ok), cb_ok,
                   np.packbits(tb[:j.tbs]).tobytes() if ok else None)
    return out


def _primary_rows(pb):
    rows, r0 = {}, 0
    host = pb.fused_dev.numpy()
    for K, Wk, n_b, items in pb.group_rows:
        blk = host[r0:r0 + n_b * (1 + Wk)].reshape(n_b, 1 + Wk)
        r0 += n_b * (1 + Wk)
        for r_i, (ji, ci, _F) in enumerate(items):
            rows[(ji, ci)] = blk[r_i]
    return rows


def _escalation_rows(pb, esc, n_iter):
    """The rows the escalation decodes: the same code blocks in the same
    decoder calls (one per K, in the same order)."""
    by_k, rows = {}, {}
    for ji in esc:
        for ci, K in enumerate(pb.seg_of[ji].K):
            by_k.setdefault(K, []).append((ji, ci))
    for K, items in by_k.items():
        d = torch.stack([pb.d_of[x].get() for x in items])
        out = pdsch_rx._turbo_only_fn(K, n_iter)(d).numpy()
        rows.update(zip(items, out))
    return rows


def _same(results, want):
    for ji, (ok, cb_ok, payload) in want.items():
        r = results[ji]
        assert (r.crc_ok, r.cb_crc_ok, r.payload) == (ok, cb_ok, payload), ji
        if ok:
            assert np.packbits(r.tb_bits).tobytes() == payload
            assert len(r.tb_bits) == r.tbs
        else:
            assert r.tb_bits is None


@pytest.fixture(scope="module")
def etm31():
    return tb_rows.etm31_grants(3, 0.12, np.random.default_rng(31))


def test_primary_and_escalation_match_host_assembly(etm31):
    grids, h, nv, jobs, sent = etm31
    bufs = {}
    pb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL, jobs,
                                        soft_buffers=bufs, n_iter=2)
    assert pb.tb.table.n_tb == len(jobs)
    want = _host_assembly(jobs, pb.seg_of, _primary_rows(pb))
    res = pdsch_rx.finish_grants_batch(pb, soft_buffers=bufs)
    _same(res, want)
    failed = [i for i, r in enumerate(res) if not r.crc_ok]
    assert 0 < len(failed) < len(jobs), [r.crc_ok for r in res]
    for i, r in enumerate(res):
        assert not r.crc_ok or r.payload == sent[i]
        # HARQ buffers dropped exactly for the blocks that passed
        assert ((jobs[i].harq_key, 0) in bufs) == (not r.crc_ok)
    esc_want = _host_assembly(jobs, {i: pb.seg_of[i] for i in failed},
                              _escalation_rows(pb, failed, 12))
    n = pdsch_rx.escalate_finish(
        pb, pdsch_rx.escalate_dispatch(pb, failed, 12), soft_buffers=bufs)
    assert n == sum(ok for ok, _, _ in esc_want.values()) > 0
    for ji, (ok, cb_ok, payload) in esc_want.items():
        if ok:
            _same(pb.results, {ji: (ok, cb_ok, payload)})
            assert payload == sent[ji]
    c = prof.counters()
    assert c["pdsch_tb_device"] == {"total": len(jobs) + len(failed),
                                    "events": 2}
    assert "pdsch_tb_host" not in c
    assert c["host_read.pf_d2h"]["events"] == 1
    assert c["host_read.escalate_join"]["events"] == 1


def test_retry_path_matches_host_assembly(etm31):
    """The table retry's dispatch (no HARQ keys, full iterations) and its
    join read the same way as the primary."""
    grids, h, nv, jobs, sent = etm31
    retry = [dataclasses.replace(j, harq_key=None) for j in jobs[:4]]
    pb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL, retry,
                                        n_iter=8)
    want = _host_assembly(retry, pb.seg_of, _primary_rows(pb))
    res = pdsch_rx.finish_grants_batch(pb, site="retry_join")
    _same(res, want)
    assert any(r.crc_ok for r in res)
    assert all(r.payload == s for r, s in zip(res, sent) if r.crc_ok)
    assert prof.counters()["host_read.retry_join"]["events"] == 1


def test_jobs_without_bits_are_left_out():
    """A grant of tbs 0 never reaches the table; the others finish."""
    rng = np.random.default_rng(8)
    grids, h, nv, jobs, sent = tb_rows.etm31_grants(1, 0.05, rng)
    jobs = [dataclasses.replace(jobs[0], tbs=0)] + jobs[1:]
    res = pdsch_rx.decode_grants_batch(grids, h, nv, tb_rows.ETM_CELL, jobs,
                                       n_iter=2)
    assert not res[0].crc_ok and res[0].payload is None
    assert [r.payload for r in res[1:]] == sent[1:]


def test_loaded_cell_core_matches_host_assembly(monkeypatch):
    """The loaded cell's first batches through a core on the CPU: every
    primary and retry finish (and escalation, where one happens) gives
    what the host assembly gives from the same rows."""
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell
    seen = {"finish": 0, "esc": 0}
    finish, esc_dispatch = (pdsch_rx.finish_grants_batch,
                            pdsch_rx.escalate_dispatch)
    esc_finish = pdsch_rx.escalate_finish

    def checked_finish(pb, *a, **k):
        want = (_host_assembly(pb.jobs, pb.seg_of, _primary_rows(pb))
                if pb.tb is not None else {})
        res = finish(pb, *a, **k)
        _same(res, want)
        seen["finish"] += len(want)
        return res

    def checked_esc_dispatch(pb, esc, n_iter):
        h = esc_dispatch(pb, esc, n_iter)
        if h is not None:
            h.want = _host_assembly(pb.jobs, {i: pb.seg_of[i] for i in esc},
                                    _escalation_rows(pb, esc, n_iter))
        return h

    def checked_esc_finish(pb, h, *a, **k):
        n = esc_finish(pb, h, *a, **k)
        if h is not None:
            for ji, w in h.want.items():
                if w[0]:
                    _same(pb.results, {ji: w})
            seen["esc"] += len(h.want)
        return n

    monkeypatch.setattr(pdsch_rx, "finish_grants_batch", checked_finish)
    monkeypatch.setattr(pdsch_rx, "escalate_dispatch", checked_esc_dispatch)
    monkeypatch.setattr(pdsch_rx, "escalate_finish", checked_esc_finish)
    words, scales, _placed, _truth = loaded_cell.build_packed(n_sf=8)
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=loaded_cell.CELL, batch_size=4, device="cpu"))
    c.run_packed(words, scales)
    c.close()
    cnt = prof.counters()
    assert seen["finish"] > 0 and cnt["host_read.retry_join"]["events"] > 0
    assert cnt["pdsch_tb_device"]["total"] == seen["finish"] + seen["esc"]
    assert sum(r.crc_ok for r in c.results) > 0
