"""The batched PDSCH de-rate-match (`kernels/cb_derm.py`) and the turbo
kernel's packing entry, on the CPU.

- The dispatch's descriptors and plain route (`pdsch_rx.
  _dispatch_code_blocks`: one table, one `cb_derm` call, one decode per
  K) against the route the dispatch ran before: `_derm_turbo_static_fn`
  (whose decode ends in `_crc_pack`) once per (prior, F, laps, rv, window
  start) sub-group, written out below as it was.  Equal fused rows,
  combined LLRs and soft buffers on seeded batches: E-TM 3.1-shaped (2-3
  code blocks of four K), loaded-shaped, fillers with laps 1-3 and rv 0-3,
  an in-batch retransmission chain of depth 2, priors from an earlier
  batch (a `LazyRow`) and from a host array.
- A NumPy model of `csrc/cb_derm.cu`'s per-thread arithmetic over the
  words `Table.array` makes (addresses resolved as the kernel resolves
  them) against the plain version, float for float.
- A NumPy model of `csrc/turbo_decode.cu`'s packing epilogue (u32 words,
  the CB CRC24B remainder as an XOR of per-word shares by powers of x mod
  g) against `_crc_pack`, at the K sizes of the cells and the extremes.
- The `pdsch_derm_cb` counter and the `derm_cb_per_launch` reader.
"""
import dataclasses
import importlib
import sys
import types

import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.kernels import cb_derm
from ltesniffer_tpu_torch.phy import crc, turbo as turbo_mod
from ltesniffer_tpu_torch.sniffer import pdsch_rx, prof
from ltesniffer_tpu_torch.testing.derm_batches import BATCHES, batch as _batch
from ltesniffer_tpu_torch.testing.derm_batches import odd_jobs as _odd_jobs
from ltesniffer_tpu_torch.testing.derm_batches import stored as _stored
from ltesniffer_tpu_torch.testing.derm_batches import table_of as _table_of

torch.set_num_threads(1)

N_ITER = 2


def _before(rows_mat, jobs, live, n_re_of, soft_buffers, n_iter):
    """The route the dispatch ran before: sub-groups of one (prior, F,
    laps, rv, window start) per K and dependency round, each through
    `_derm_turbo_static_fn`.  Returns ({(ji, ci): fused row}, {(ji, ci):
    combined LLRs}); updates soft_buffers as the dispatch did."""
    row_of = {ji: r for r, ji in enumerate(live)}
    by_k = {}
    for ji in live:
        j = jobs[ji]
        seg = turbo_mod.segment_sizes(j.tbs)
        es = pdsch_rx.pdsch_mod.cb_rate_match_sizes(n_re_of[ji] * j.qm,
                                                    seg.C, j.qm)
        off = 0
        for ci_, (K, E) in enumerate(zip(seg.K, es)):
            key = ((j.harq_key, ci_) if soft_buffers is not None
                   and j.harq_key is not None else None)
            by_k.setdefault(K, []).append(
                (ji, ci_, seg.F if ci_ == 0 else 0, E, off, j.rv, key,
                 j.is_retx))
            off += E
    fused_of, d_of, last_occ = {}, {}, {}
    for K, rows in sorted(by_k.items()):
        rows.sort(key=lambda r: (r[0], r[1]))
        occ_prev, depth_of, prior_src, rounds = {}, {}, {}, []
        for r in rows:
            key, d_ = r[6], 0
            if r[7] and key is not None:
                prev = occ_prev.get(key)
                if prev is not None:
                    d_ = depth_of[prev] + 1
                    prior_src[id(r)] = ("row", prev)
                elif (key in soft_buffers
                        and tuple(soft_buffers[key].shape) == (3, K + 4)):
                    prior_src[id(r)] = ("buf", key)
            if key is not None:
                occ_prev[key] = (r[0], r[1])
                depth_of[(r[0], r[1])] = d_
            while len(rounds) <= d_:
                rounds.append([])
            rounds[d_].append(r)
        for rnd in rounds:
            subs = {}
            for r in rnd:
                subs.setdefault((id(r) in prior_src, r[2],
                                 pdsch_rx._derm_laps(K, r[2], r[3]), r[5],
                                 r[4]), []).append(r)
            for (has_prior, F, laps, rv, off), sub in sorted(
                    subs.items(), key=lambda kv: kv[0][1:]):
                prior = None
                if has_prior:
                    prior = torch.stack([torch.as_tensor(
                        d_of[ref] if kind == "row"
                        else pdsch_rx._buffer_value(soft_buffers[ref]))
                        for kind, ref in (prior_src[id(r)] for r in sub)])
                fn = pdsch_rx._derm_turbo_static_fn(K, F, laps, rv, n_iter)
                fused, d = fn(rows_mat,
                              torch.tensor([row_of[r[0]] for r in sub]),
                              torch.tensor([r[3] for r in sub]), off, prior)
                fused = fused.reshape(len(sub), -1)
                for r_i, r in enumerate(sub):
                    fused_of[(r[0], r[1])] = fused[r_i]
                    d_of[(r[0], r[1])] = d[r_i]
        for key, jici in occ_prev.items():
            last = last_occ.get(key)
            if last is None or jici[0] >= last[0]:
                last_occ[key] = jici
    for key, jici in last_occ.items():
        soft_buffers[key] = d_of[jici]
    return fused_of, d_of


def _now(pb):
    """({(ji, ci): fused row}, {(ji, ci): combined LLRs}) of a dispatch."""
    rows, r0 = {}, 0
    for K, Wk, n, items in pb.group_rows:
        blk = pb.fused_dev[r0:r0 + n * (1 + Wk)].reshape(n, 1 + Wk)
        r0 += n * (1 + Wk)
        for r_i, (ji, ci, _F) in enumerate(items):
            rows[(ji, ci)] = blk[r_i]
    assert r0 == pb.fused_dev.numel()
    return rows, {k: v.get() for k, v in pb.d_of.items()}


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_dispatch_equals_the_sub_group_route(name):
    rng = np.random.default_rng(len(name))
    jobs = BATCHES[name]()
    rows_mat, live, n_re = _batch(jobs, rng)
    bufs = _stored(jobs, rng)
    bufs_before = dict(bufs)
    fused_b, d_b = _before(rows_mat, jobs, live, n_re, bufs_before, N_ITER)
    prof.reset()
    pb = pdsch_rx._dispatch_code_blocks(rows_mat, jobs, live, n_re, bufs,
                                        N_ITER)
    fused_n, d_n = _now(pb)
    assert fused_n.keys() == fused_b.keys() == d_n.keys()
    for k in fused_b:
        assert torch.equal(fused_n[k], fused_b[k]), k
        assert torch.equal(d_n[k], d_b[k]), k
    assert bufs.keys() == bufs_before.keys()
    for k in bufs:
        assert torch.equal(torch.as_tensor(pdsch_rx._buffer_value(bufs[k])),
                           torch.as_tensor(
                               pdsch_rx._buffer_value(bufs_before[k]))), k
    # one slab and one block of rows a K, every code block once
    ks = [g[0] for g in pb.group_rows]
    assert ks == sorted(set(ks))
    n_cb = sum(len(g[3]) for g in pb.group_rows)
    depth = 3 if name == "odd" else 1
    assert prof.counters()["pdsch_derm_cb"] == {"total": n_cb,
                                                "events": depth}
    if name == "etm31":
        assert len(ks) == 4 and {pb.seg_of[i].C for i in live} == {2, 3}
    if name == "odd":
        cb = _table_of(rows_mat, jobs, live, n_re, dict(bufs_before)).cb
        assert {c[5] for c in cb} >= {1, 2, 3}            # laps
        assert {c[9] for c in cb} == {0, 1, 2, 3}          # rv
        assert any(c[4] for c in cb)                       # F
        assert {pb.seg_of[i].C for i in live} >= {1, 4}


def test_dispatch_makes_no_blocking_upload(monkeypatch):
    """The primary dispatch calls neither `_t` nor `_gather_lazy_rows`,
    whatever its priors; its only upload is the table's."""
    def refuse(*a, **k):
        raise AssertionError("a blocking upload in the dispatch")
    monkeypatch.setattr(pdsch_rx, "_t", refuse)
    monkeypatch.setattr(pdsch_rx, "_gather_lazy_rows", refuse)
    rng = np.random.default_rng(3)
    jobs = _odd_jobs()
    rows_mat, live, n_re = _batch(jobs, rng)
    uploads = []
    real = cb_derm.upload_pinned
    monkeypatch.setattr(cb_derm, "upload_pinned",
                        lambda *a: uploads.append(1) or real(*a))
    pb = pdsch_rx._dispatch_code_blocks(rows_mat, jobs, live, n_re,
                                        _stored(jobs, rng), N_ITER)
    assert uploads == [1] and pb.derm is not None


def test_priors_by_kind_in_the_words():
    """An in-batch chain reads the output by address, a LazyRow its
    parent's row by address, a host array rides in the upload."""
    rng = np.random.default_rng(5)
    jobs = _odd_jobs()
    rows_mat, live, n_re = _batch(jobs, rng)
    bufs = _stored(jobs, rng)
    host_prior = bufs[((7, 0, 0), 0)]
    lazy = bufs[((6, 0, 0), 0)]
    tab = _table_of(rows_mat, jobs, live, n_re, dict(bufs))
    out = torch.zeros(max(c[8] + 3 * (c[3] + 4) for c in tab.cb))
    words = tab.array("cpu", out, [])
    d = words[:cb_derm.DESC_WORDS * tab.n_cb].reshape(-1, cb_derm.DESC_WORDS)
    addr = (d[:, cb_derm.PRIOR_HI].astype(np.int64) << 32) | \
        (d[:, cb_derm.PRIOR_LO].astype(np.int64) & 0xFFFFFFFF)
    pup = d[d[:, cb_derm.PUP] >= 0, cb_derm.PUP]
    assert len(pup) == 1
    np.testing.assert_array_equal(
        words[pup[0]:pup[0] + host_prior.size].view(np.float32),
        host_prior.reshape(-1))
    assert lazy.arr[lazy.i].data_ptr() in addr.tolist()
    in_out = [a for a in addr.tolist()
              if out.data_ptr() <= a < out.data_ptr() + 4 * out.numel()]
    assert len(in_out) == 2                  # the chain's two links
    assert (d[:, cb_derm.ROUND][addr == 0] == 0).all()


# ---------------------------------------------------------------------------
# a NumPy model of csrc/cb_derm.cu
# ---------------------------------------------------------------------------
def _model_derm(rows, words, first, n, memory, out):
    """The kernel, thread by thread (vectorized over a code block's
    positions), for code blocks first .. first + n - 1 of the uploaded
    words, into `out`: `memory` maps an address to the host array there
    (the output's own address to `out`, so a later round reads an earlier
    one's rows); the priors in the upload are read from the words."""
    W = cb_derm.DESC_WORDS
    up = words.view(np.float32)
    wm = rows.shape[1]

    def at(lo, hi, size):
        a = (int(hi) << 32) | (int(lo) & 0xFFFFFFFF)
        for base, arr in memory.items():
            if base <= a < base + arr.nbytes:
                o = (a - base) // arr.itemsize
                return arr.reshape(-1)[o:o + size]
        raise KeyError(a)
    for c in range(first, first + n):
        d = words[W * c:W * (c + 1)].astype(np.int64)
        kp = d[cb_derm.K] + 4
        p = np.arange(3 * kp)
        rank = at(d[cb_derm.MAP_LO], d[cb_derm.MAP_HI], 3 * kp)
        L, s0, laps = d[cb_derm.L], d[cb_derm.S0], d[cb_derm.LAPS]
        off = d[cb_derm.OFF]
        lim = min(d[cb_derm.E], wm - off)
        x = rows[d[cb_derm.ROW], off:]
        j = rank - s0
        j = np.where(j < 0, j + L, j)
        live = rank < L

        def tap(e):
            ok = live & (e < lim)
            return np.where(ok, x[np.where(ok, e, 0)], np.float32(0))
        v = tap(j)
        for lap in range(1, laps):
            v = (v + tap(j + lap * L)).astype(np.float32)
        v = np.where(live, v, np.float32(0)).astype(np.float32)
        v[(p < 2 * kp) & (p % kp < d[cb_derm.F])] = np.float32(1e4)
        if d[cb_derm.PUP] >= 0:
            v = v + up[d[cb_derm.PUP]:d[cb_derm.PUP] + 3 * kp]
        elif d[cb_derm.PRIOR_LO] or d[cb_derm.PRIOR_HI]:
            v = v + at(d[cb_derm.PRIOR_LO], d[cb_derm.PRIOR_HI], 3 * kp)
        out[d[cb_derm.OUT]:d[cb_derm.OUT] + 3 * kp] = v


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_kernel_model_equals_plain(name):
    """Round by round, as the launches run, from the dispatch's own table
    (every kind of prior in the odd batch)."""
    rng = np.random.default_rng(7 + len(name))
    jobs = BATCHES[name]()
    rows_mat, live, n_re = _batch(jobs, rng)
    tab = _table_of(rows_mat, jobs, live, n_re, _stored(jobs, rng))
    n_out = max(c[8] + 3 * (c[3] + 4) for c in tab.cb)
    out = torch.zeros(n_out)
    keep = []
    _host, desc = cb_derm.upload(tab, "cpu", out, keep)
    words = desc.numpy().copy()
    got = np.zeros(n_out, np.float32)
    memory = {t.data_ptr(): t.numpy() for t in keep}
    memory[out.data_ptr()] = got
    for first, n, _chunks in tab.rounds():
        _model_derm(rows_mat.numpy(), words, first, n, memory, got)
    want = cb_derm.derm(rows_mat, tab, desc, out).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(tab.rounds()) == (3 if name == "odd" else 1)


def test_table_words_and_rounds():
    tab = cb_derm.Table()
    tab.add(2, 100, 900, 352, 8, 1, 5000, 1, ("out", 0))
    tab.add(0, 0, 1200, 352, 0, 0, 0, 0)
    tab.add(1, 10, 4000, 6144, 0, 3, 2000, 0)
    assert tab.rounds() == [(0, 2, -(-3 * 6148 // cb_derm.THREADS)),
                            (2, 1, -(-3 * 356 // cb_derm.THREADS))]
    out = torch.zeros(6000)
    keep = []
    w = tab.array("cpu", out, keep).reshape(-1, cb_derm.DESC_WORDS)
    assert w[:, cb_derm.OUT].tolist() == [0, 2000, 5000]
    assert w[:, cb_derm.ROUND].tolist() == [0, 0, 1]
    addr = (int(w[2, cb_derm.PRIOR_HI]) << 32) | \
        (int(w[2, cb_derm.PRIOR_LO]) & 0xFFFFFFFF)
    assert addr == out.data_ptr()
    assert w[:, cb_derm.PUP].tolist() == [-1, -1, -1]
    _, INVP, L = cb_derm.static_maps(352, 8)
    assert w[2, cb_derm.L] == L == INVP.max()
    assert w[2, cb_derm.S0] == cb_derm.start_rank(352, 8, 1)
    assert w[2, cb_derm.LAPS] == cb_derm.laps(352, 8, 900) == 1
    assert w[1, cb_derm.LAPS] == cb_derm.laps(6144, 0, 4000)
    assert len(keep) == 3         # the three (K, F) maps
    assert cb_derm.bytes_moved(tab) > 4 * 3 * (6148 + 2 * 356)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    tab = cb_derm.Table()
    tab.add(3, 0, 100, 40, 0, 0, 0, 0)
    rows = torch.zeros((2, 300))
    out = torch.zeros(200)
    host, desc = cb_derm.upload(tab, "cpu", out, [])
    with pytest.raises(ValueError):
        cb_derm.derm(rows, tab, desc, out)          # row 3 of 2
    with pytest.raises(ValueError):
        cb_derm.derm(torch.zeros((4, 300)), tab, desc, torch.zeros(100))
    with pytest.raises(ValueError):
        cb_derm.derm(rows.double(), tab, desc, out)


# ---------------------------------------------------------------------------
# a NumPy model of csrc/turbo_decode.cu's packing epilogue
# ---------------------------------------------------------------------------
G24B = 0x1800063


def _mulmod(a, b):
    r = 0
    for i in range(23, -1, -1):
        r = ((r << 1) ^ (G24B if r & 0x800000 else 0)) & 0x1FFFFFF
        r ^= a if (b >> i) & 1 else 0
    return r


POWERS = [2]
for _ in range(13):
    POWERS.append(_mulmod(POWERS[-1], POWERS[-1]))


def _brev32(w):
    return int(f"{w:032b}"[::-1], 2)


def _crc_word(word, e):
    r = _brev32(word)
    for i in range(31, 23, -1):
        if (r >> i) & 1:
            r ^= G24B << (i - 24)
    for k in range(14):
        if (e >> k) & 1:
            r = _mulmod(r, POWERS[k])
    return r


def _model_pack(bits):
    """(n, K) u8 decided bits -> (n, 1 + Wk) rows as the epilogue writes
    them."""
    n, K = bits.shape
    Wk = (K + 31) // 32
    rows = np.zeros((n, 1 + Wk), np.int64)
    for b in range(n):
        rem = 0
        for w in range(Wk):
            word = 0
            for i in range(min(32, K - 32 * w)):
                word |= int(bits[b, 32 * w + i]) << i
            rows[b, 1 + w] = word
            rem ^= _crc_word(word, K - 32 * w - 8)
        rows[b, 0] = bin(rem).count("1")
    return rows


def test_crc_powers_are_x_to_the_powers_of_two():
    g = np.zeros(1 << 14, np.uint32)       # x^e mod g by shifting
    r = 1
    for e in range(len(g)):
        g[e] = r
        r = ((r << 1) ^ (G24B if r & 0x800000 else 0)) & 0xFFFFFF
    assert POWERS == [int(g[1 << k]) for k in range(14)]


@pytest.mark.parametrize("K", [40, 64, 352, 552, 1824, 3904, 5120, 6144])
def test_pack_model_equals_crc_pack(K):
    rng = np.random.default_rng(K)
    bits = rng.integers(0, 2, (3, K)).astype(np.uint8)
    # a code block that passes its CB CRC24B, as a decoded one does
    msg = rng.integers(0, 2, K - 24).astype(np.uint8)
    bits[1] = crc.attach_crc(msg, crc.CRC24B)
    bits[2] = 0
    want = pdsch_rx._crc_pack(torch.from_numpy(bits), K).numpy()
    got = _model_pack(bits)
    np.testing.assert_array_equal(got, want)
    assert got[1, 0] == 0 and got[0, 0] > 0


def test_turbo_only_fn_writes_rows_into_a_buffer():
    """The CPU route of `_turbo_only_fn`: the decoder and `_crc_pack`,
    into a buffer at a word offset when one is given."""
    rng = np.random.default_rng(1)
    K = 64
    d = torch.from_numpy(rng.standard_normal((3, 3, K + 4)).astype(
        np.float32))
    rows = pdsch_rx._turbo_only_fn(K, 2)(d)
    bits, _ = pdsch_rx.kturbo.make_decoder(K, 2)(d)
    assert torch.equal(rows, pdsch_rx._crc_pack(bits, K))
    buf = torch.full((5 + rows.numel(),), -7, dtype=torch.int64)
    pdsch_rx._turbo_only_fn(K, 2)(d, buf, 5)
    assert torch.equal(buf[5:], rows.reshape(-1))
    assert (buf[:5] == -7).all()


# ---------------------------------------------------------------------------
# the counter and the benchmark's reader
# ---------------------------------------------------------------------------
def _reader():
    return importlib.import_module(
        "sniffbench.metrics.derm_cb_per_launch").read


def test_reader_on_a_filled_tracer():
    prof.reset()
    for n in (320, 310, 330):
        prof.count("pdsch_derm_cb", n)
    rec = {"config": {}, "n_iter": 2, "span_sf": 96, "spans": {}}
    assert _reader()(rec) == pytest.approx(320.0)


def test_reader_of_an_empty_record_or_the_parent_is_none(monkeypatch):
    prof.reset()
    assert _reader()({"config": {}, "n_iter": 2}) is None
    rec = {"config": {}, "n_iter": 2, "span_sf": 96, "spans": {}}
    prof.count("pdsch_eq_grants", 12)
    assert _reader()(rec) is None           # a tracer without the counter
    old = types.ModuleType("prof")
    old.report = lambda: {}
    monkeypatch.setitem(sys.modules, "ltesniffer_tpu_torch.sniffer.prof",
                        old)
    assert _reader()(rec) is None           # a tracer without counters


def test_dispatch_counts_a_launch_a_round():
    prof.reset()
    rng = np.random.default_rng(9)
    jobs = [dataclasses.replace(j, harq_key=None, is_retx=False)
            for j in _odd_jobs()]
    rows_mat, live, n_re = _batch(jobs, rng)
    pb = pdsch_rx._dispatch_code_blocks(rows_mat, jobs, live, n_re, {},
                                        N_ITER)
    n_cb = sum(len(g[3]) for g in pb.group_rows)
    assert prof.counters()["pdsch_derm_cb"] == {"total": n_cb, "events": 1}
