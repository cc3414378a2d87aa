"""The batched single-layer PDSCH eq/demap (`kernels/pdsch_eq.py`).

- The descriptor builder (`pdsch_rx._eq_rows`) over PRB-list and table
  grants mixed in one table: through the plain version it gives the rows
  of the per-group chains the dispatch ran before, and the JAX package's
  LLRs (`sniffer/pdsch_rx.py:_eq_demap_batch_fn`) within the frontend
  tests' tolerance (rtol 1e-4 plus atol 1e-4 of the peak).
- A NumPy model of the CUDA kernel (`csrc/pdsch_eq_demap.cu`): the block
  -> grant search, RE ordinal -> grid offset and Gold word index against
  the torch gather, and its per-thread arithmetic against the plain
  version (float for float when it divides as PyTorch does on the CPU).
- The wrapper's CPU dispatch and its checks, the table, the byte count.
- The `pdsch_eq_grants` counter and the `eq_grants_per_launch` reader.
"""
import importlib
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import pdsch_rx as ref_pdsch

from ltesniffer_tpu_torch.kernels import mimo_eq, pdsch_eq
from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdsch_rx, prof
from ltesniffer_tpu_torch.testing import eq_grants

torch.set_num_threads(1)

N_PRB = eq_grants.MIXED_PRB
SFS = eq_grants.MIXED_SFS
CASES = [(1, 2), (1, 1), (2, 2), (1, 4), (2, 4), (2, 1)]     # (rx, ports)
IDS = [f"rx{rx}-p{p}" for rx, p in CASES]


def _mask(*ranges):
    m = np.zeros(N_PRB, bool)
    for a, b in ranges:
        m[a:b] = True
    return m


def rows_of(rx, ports, seed=0, name="mixed"):
    """A seeded batch through the dispatch's table builder and the
    wrapper (the plain version, here)."""
    cell, grids, h, nv, jobs, re_of = eq_grants.batch(name, rx, ports, seed)
    table, re_tab = eq_grants.table(cell, h, jobs, "cpu")
    rows, _host = pdsch_eq.eq_demap(grids, h, nv, table, re_tab, cell)
    return cell, grids, h, nv, jobs, re_of, rows, table, re_tab


def padded(re_idx):
    n_pad = pdsch_rx._bucket(len(re_idx))
    out = np.full(n_pad, re_idx[-1], np.int64)
    out[:len(re_idx)] = re_idx
    return out


# ---------------------------------------------------------------------------
# the descriptor builder through the plain version
# ---------------------------------------------------------------------------
def test_builder_mixes_both_sources_in_one_table():
    cell, grids, h, nv, jobs, re_of, rows, table, re_tab = rows_of(1, 2)
    d = np.asarray(table.desc).reshape(-1, pdsch_eq.DESC_WORDS)
    kinds = d[:, pdsch_eq.SHAPE] >= 0
    # centre PRBs at subframes 0 and 5 and the two-slot grant ride in the
    # table; the same allocation twice shares its row
    assert list(kinds) == [True, False, True, False, True, True, False,
                           True, False, True]
    # the dispatch's call gives the same rows
    got, _host = pdsch_rx._eq_rows(grids, h, nv, table, re_tab, cell)
    np.testing.assert_array_equal(got.numpy(), rows.numpy())
    # the RE counts the builder took are grant_re_indices'
    assert [pdsch_rx._src_of(cell, j)[0] for j in jobs] == \
        [len(r) for r in re_of]
    assert re_tab.shape[0] == 3 and table.n_grants == len(jobs)
    assert rows.shape == (len(jobs), table.wm)
    assert table.wm == max(pdsch_rx._bucket(len(r)) * j.qm
                           for r, j in zip(re_of, jobs))
    for g, (j, r) in enumerate(zip(jobs, re_of)):
        assert d[g, pdsch_eq.B] == j.b and d[g, pdsch_eq.QM] == j.qm
        assert d[g, pdsch_eq.NRE] == len(r)
        assert d[g, pdsch_eq.NPAD] == pdsch_rx._bucket(len(r))
        assert d[g, pdsch_eq.CINIT] == pdsch_mod.scrambling_cinit(
            j.rnti, 0, j.sf_idx, cell.n_id_cell)
        assert np.int32(d[g, pdsch_eq.PA]).view(np.float32) == \
            np.float32(j.pa)


@pytest.mark.parametrize("rx,ports", CASES, ids=IDS)
def test_plain_rows_equal_the_per_group_chains(rx, ports):
    """The rows the dispatch ran before: fast groups by (qm, PRB count,
    CFI) through `_eq_demap_prb_fn`, the others by (qm, n_pad) through
    `_eq_demap_batch_fn` on their own RE table, stacked and zero-padded."""
    cell, grids, h, nv, jobs, re_of, rows, table, _ = rows_of(rx, ports)
    center = pdsch_rx._center_prbs(cell)
    want = torch.zeros_like(rows)
    Xg, Xh = pdsch_eq._reorg(cell, grids, h)
    fast, tab = {}, {}
    for g, j in enumerate(jobs):
        n_prb = int(j.prb_mask.sum())
        if j.prb_mask_slot1 is None and not (
                j.sf_idx in (0, 5) and any(j.prb_mask[p] for p in center)):
            fast.setdefault((j.qm, n_prb, j.cfi), []).append(g)
        else:
            tab.setdefault((j.qm, pdsch_rx._bucket(len(re_of[g]))),
                           []).append(g)
    for (qm, n_prb, cfi), gs in fast.items():
        fn, n_pad = pdsch_eq._eq_demap_prb_fn(cell, qm, n_prb, cfi, ports)
        out = fn(Xg, Xh, nv, torch.tensor([jobs[g].b for g in gs]),
                 torch.tensor(np.stack([np.flatnonzero(jobs[g].prb_mask)
                                        for g in gs])),
                 torch.tensor([pdsch_mod.scrambling_cinit(
                     jobs[g].rnti, 0, jobs[g].sf_idx, cell.n_id_cell)
                     for g in gs]),
                 torch.tensor([jobs[g].pa for g in gs], dtype=torch.float32))
        want[gs, :out.shape[1]] = out
    gflat = grids.reshape(grids.shape[0], rx, -1, 2)
    hflat = h.reshape(h.shape[0], rx, ports, -1, 2)
    for (qm, n_pad), gs in tab.items():
        combos = tuple((jobs[g].sf_idx, jobs[g].cfi,
                        jobs[g].prb_mask.tobytes(),
                        None if jobs[g].prb_mask_slot1 is None
                        else jobs[g].prb_mask_slot1.tobytes()) for g in gs)
        re_tab = torch.from_numpy(pdsch_rx._re_tab(cell, n_pad, combos))
        fn = pdsch_eq._eq_demap_batch_fn(cell, qm, n_pad, ports)
        out = fn(gflat, hflat, nv, torch.tensor([jobs[g].b for g in gs]),
                 torch.arange(len(gs)), re_tab,
                 torch.tensor([pdsch_mod.scrambling_cinit(
                     jobs[g].rnti, 0, jobs[g].sf_idx, cell.n_id_cell)
                     for g in gs]),
                 torch.tensor([jobs[g].pa for g in gs], dtype=torch.float32))
        want[gs, :out.shape[1]] = out
    np.testing.assert_array_equal(rows.numpy(), want.numpy())


@pytest.mark.parametrize("rx,ports", CASES[:5], ids=IDS[:5])
def test_plain_rows_match_jax(rx, ports):
    """Each grant's row against the JAX package's eq/demap of that grant
    alone on its own RE list, and zeros past its n_pad * qm."""
    cell, grids, h, nv, jobs, re_of, rows, _, _ = rows_of(rx, ports, seed=1)
    ref_cell = RefCell(n_id_cell=cell.n_id_cell, n_prb=N_PRB,
                       nof_ports=ports, nof_rx_ant=rx)
    gflat = jnp.asarray(grids.numpy().reshape(len(SFS), rx, -1, 2))
    hflat = jnp.asarray(h.numpy().reshape(len(SFS), rx, ports, -1, 2))
    for g, (j, r) in enumerate(zip(jobs, re_of)):
        idx = padded(r)
        fn = ref_pdsch._eq_demap_batch_fn(ref_cell, j.qm, len(idx), ports)
        want = np.asarray(fn(
            gflat, hflat, jnp.asarray(nv.numpy()),
            jnp.asarray(np.array([j.b], np.int32)),
            jnp.zeros(1, jnp.int32), jnp.asarray(idx[None].astype(np.int32)),
            jnp.asarray(np.array([pdsch_mod.scrambling_cinit(
                j.rnti, 0, j.sf_idx, cell.n_id_cell)], np.uint32)),
            jnp.asarray(np.array([j.pa], np.float32))))[0]
        got = rows[g].numpy()
        n = len(idx) * j.qm
        peak = float(np.max(np.abs(want))) or 1.0
        np.testing.assert_allclose(got[:n], want, rtol=1e-4,
                                   atol=1e-4 * peak, err_msg=f"grant {g}")
        assert not got[n:].any()


# ---------------------------------------------------------------------------
# a NumPy model of the kernel
# ---------------------------------------------------------------------------
def parts(table):
    """(descriptors (G, 8), first (G + 1,), PRB lists) of table.array()."""
    arr = table.array().astype(np.int64)
    G = table.n_grants
    W = pdsch_eq.DESC_WORDS
    return (arr[:W * G].reshape(G, W), arr[W * G:W * G + G + 1],
            arr[W * G + G + 1:])


def block_grant(first, blk: int) -> int:
    """The kernel's search: the last g with first[g] <= blk."""
    lo, hi = 0, len(first) - 2
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= blk:
            lo = mid
        else:
            hi = mid - 1
    return lo


def re_at(cell, d, prbs, re_tab, i):
    """The kernel's re_at over an array of ordinals i (< n_re)."""
    shape, src = int(d[pdsch_eq.SHAPE]), int(d[pdsch_eq.SRC_W])
    if shape < 0:
        return re_tab[src, i]
    ints = pdsch_eq.cell_constants(cell)
    cnt, ksel = ints[:14], ints[14:].reshape(14, 12)
    n_prb = shape & 0xFF
    rem = np.array(i, np.int64)
    l = np.full(rem.shape, shape >> 8)
    for ll in range(shape >> 8, 13):
        move = (l == ll) & (rem >= n_prb * cnt[ll])
        rem = np.where(move, rem - n_prb * cnt[ll], rem)
        l = np.where(move, ll + 1, l)
    c = cnt[l]
    slot = rem // c
    return l * cell.n_sc + prbs[src + slot] * 12 + ksel[l, rem - slot * c]


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_model_index_arithmetic_is_the_gather(ports):
    """Every block maps to one grant and every ordinal of every grant to
    one thread; each ordinal's grid offset is the grant's padded RE index
    (`grant_re_indices`, the gather of the plain version); LLR n of a
    grant reads Gold word n."""
    cell, grids, h, nv, jobs, re_of, rows, table, re_tab = rows_of(1, ports)
    d, first, prbs = parts(table)
    n_res = pdsch_eq.res_per_thread(ports)
    seen = [np.zeros(int(x), np.int64) for x in d[:, pdsch_eq.NPAD]]
    for blk in range(int(first[-1])):
        g = block_grant(first, blk)
        assert first[g] <= blk < first[g + 1]
        chunk = blk - first[g]
        i0 = (chunk * pdsch_eq.THREADS + np.arange(pdsch_eq.THREADS)) * n_res
        i0 = i0[i0 < d[g, pdsch_eq.NPAD]]
        for k in range(n_res):
            seen[g][i0 + k] += 1
    assert all((s == 1).all() for s in seen)
    tab = re_tab.numpy()
    for g, r in enumerate(re_of):
        idx = padded(r)
        i = np.minimum(np.arange(len(idx)), len(r) - 1)
        np.testing.assert_array_equal(re_at(cell, d[g], prbs, tab, i), idx)
        # the plain version's Gold bits are word n's parity, n = i qm + j
        qm = int(d[g, pdsch_eq.QM])
        c = np.uint32((int(d[g, pdsch_eq.CINIT]) & 0x7FFFFFFF) | 1 << 31)
        x = mimo_eq.gold_words(len(idx) * qm) & c
        bits = np.zeros(len(x), np.uint32)
        for k in range(32):
            bits ^= (x >> np.uint32(k)) & np.uint32(1)
        want = pdsch_eq.descramble(torch.ones(len(x)),
                                   torch.tensor(int(d[g, pdsch_eq.CINIT])),
                                   len(x)).numpy()
        np.testing.assert_array_equal(np.where(bits == 1, -1.0, 1.0), want)


def _demap(xr, xi, qm, divide):
    s = qm // 2 - 1
    sc = pdsch_eq.FLOATS[s]
    inv = pdsch_eq.FLOATS[4 + s]
    re, im = xr * sc, xi * sc
    v = [re, im]
    if qm > 2:
        top = np.float32({4: 2.0, 6: 4.0, 8: 8.0}[qm])
        v += [top - np.abs(re), top - np.abs(im)]
        if qm >= 6:
            mid = np.float32(2.0 if qm == 6 else 4.0)
            v += [mid - np.abs(v[2]), mid - np.abs(v[3])]
        if qm == 8:
            v += [np.float32(2.0) - np.abs(v[4]),
                  np.float32(2.0) - np.abs(v[5])]
        v = [x / sc if divide else x * inv for x in v]
    return np.stack(v, -1)


def _pair(y, ha, hb, nv):
    """The kernel's pair(): lists over RX of (re, im) arrays, REs (j, j+1)
    as the two entries of y / ha / hb."""
    acc = None
    for r in range(len(y[0])):
        (y0r, y0i), (y1r, y1i) = y[0][r], y[1][r]
        (a0r, a0i), (a1r, a1i) = ha[0][r], ha[1][r]
        (b0r, b0i), (b1r, b1i) = hb[0][r], hb[1][r]
        t = [(y0r * a0r + y0i * a0i) + (b1r * y1r + b1i * y1i),
             (y0i * a0r - y0r * a0i) + (b1i * y1r - b1r * y1i),
             (y1r * a1r + y1i * a1i) - (b0r * y0r + b0i * y0i),
             (y1i * a1r - y1r * a1i) - (b0i * y0r - b0r * y0i),
             (a0r * a0r + a0i * a0i) + (b0r * b0r + b0i * b0i)]
        acc = t if acc is None else [a + b for a, b in zip(acc, t)]
    ar, ai, br, bi, nrm = acc
    nrm = nrm + nv
    return (ar / nrm, ai / nrm), (br / nrm, bi / nrm)


def kernel_model(cell, grids, h, nv, table, re_tab, divide=False):
    """pdsch_eq_demap_kernel thread by thread (vectorized over a block's
    threads) in float32 numpy, one rounding per operation as under
    --fmad=false (`divide`: divide by the demapper's scale, as PyTorch
    does on the CPU, not multiply by its reciprocal as on the card)."""
    d, first, prbs = parts(table)
    rx, ports = grids.shape[1], table.ports
    g_ = grids.numpy().reshape(grids.shape[0], rx, -1, 2)
    h_ = h.numpy().reshape(h.shape[0], rx, ports, -1, 2)
    tab = re_tab.numpy() if re_tab is not None else None
    N = pdsch_eq.res_per_thread(ports)
    T = pdsch_eq.THREADS
    wm = table.wm
    out = np.full((table.n_grants, wm), np.nan, np.float32)
    sqrt2 = pdsch_eq.FLOATS[8]
    words = mimo_eq.gold_words(wm)
    for blk in range(int(first[-1])):
        g = block_grant(first, blk)
        dg = d[g]
        chunk, n_ch = blk - first[g], first[g + 1] - first[g]
        qm, n_re, n_pad = (int(dg[k]) for k in (pdsch_eq.QM, pdsch_eq.NRE,
                                                 pdsch_eq.NPAD))
        tail = np.arange(n_pad * qm, wm)
        mine = (tail - n_pad * qm) % (n_ch * T)
        out[g, tail[(mine >= chunk * T) & (mine < chunk * T + T)]] = 0.0
        i0 = (chunk * T + np.arange(T)) * N
        i0 = i0[i0 < n_pad]
        if not len(i0):
            continue
        b = int(dg[pdsch_eq.B])
        pa = np.int32(dg[pdsch_eq.PA]).view(np.float32)
        e = [re_at(cell, dg, prbs, tab, np.minimum(i0 + k, n_re - 1))
             for k in range(N)]
        y = [[(g_[b, r, e[k], 0], g_[b, r, e[k], 1]) for r in range(rx)]
             for k in range(N)]

        def port(q, k):
            return [(h_[b, r, q, e[k], 0] * pa, h_[b, r, q, e[k], 1] * pa)
                    for r in range(rx)]
        ha = [port((k >> 1) if ports == 4 else 0, k) for k in range(N)]
        if ports == 1:
            acc = None
            for r in range(rx):
                (yr, yi), (hr, hi) = y[0][r], ha[0][r]
                t = [yr * hr + yi * hi, yi * hr - yr * hi, hr * hr + hi * hi]
                acc = t if acc is None else [a + c for a, c in zip(acc, t)]
            den = acc[2] + nv[b].numpy()
            xs = [(acc[0] / den, acc[1] / den)]
        else:
            hb = [port(2 + (k >> 1) if ports == 4 else 1, k)
                  for k in range(N)]
            xs = []
            for k in range(0, N, 2):
                xs += list(_pair(y[k:k + 2], ha[k:k + 2], hb[k:k + 2],
                                 nv[b].numpy()))
            xs = [(xr * sqrt2, xi * sqrt2) for xr, xi in xs]
        c = np.uint32((int(dg[pdsch_eq.CINIT]) & 0x7FFFFFFF) | 1 << 31)
        for k, (xr, xi) in enumerate(xs):
            v = _demap(xr, xi, qm, divide)                    # (n, qm)
            n = ((i0 + k) * qm)[:, None] + np.arange(qm)
            x = words[n] & c
            bits = np.zeros(x.shape, np.uint32)
            for s in range(32):
                bits ^= (x >> np.uint32(s)) & np.uint32(1)
            out[g, n] = np.where(bits == 1, -v, v)
    return out


@pytest.mark.parametrize(
    "name,rx,ports", [("mixed", rx, p) for rx, p in CASES]
    + [("loaded", 1, 2), ("etm31", 1, 2)],
    ids=IDS + ["loaded-rx1-p2", "etm31-rx1-p2"])
def test_kernel_model_equals_plain(name, rx, ports):
    """The model, dividing by the demapper's scale as PyTorch does on the
    CPU, equals the plain version float for float over mixed grants and
    one batch of the loaded and the E-TM 3.1 cells, and with the card's
    reciprocal multiply it stays within 2 ulp."""
    cell, grids, h, nv, jobs, re_of, rows, table, re_tab = rows_of(
        rx, ports, seed=2, name=name)
    got = kernel_model(cell, grids, h, nv, table, re_tab, divide=True)
    np.testing.assert_array_equal(got, rows.numpy())
    got = kernel_model(cell, grids, h, nv, table, re_tab)
    np.testing.assert_allclose(got, rows.numpy(), rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------------------
# the wrapper, the table, the constants
# ---------------------------------------------------------------------------
def test_wrapper_takes_plain_version_on_cpu():
    pdsch_eq.reset_launches()
    cell, grids, h, nv, jobs, re_of, rows, table, re_tab = rows_of(1, 2)
    out, host = pdsch_eq.eq_demap(grids, h, nv, table, re_tab, cell)
    np.testing.assert_array_equal(out.numpy(), rows.numpy())
    np.testing.assert_array_equal(host.numpy(), table.array())
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == 0
    assert pdsch_eq.PLAIN_CUDA["pdsch_eq_demap"] == 0


def test_wrapper_refuses_other_devices():
    cell = CellConfig(n_id_cell=1, n_prb=6)
    x = torch.zeros((1, 1, 14, 72, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pdsch_eq.eq_demap(x, x, x, pdsch_eq.Table(2), None, cell)


@pytest.mark.parametrize("what,err", [
    ("dtype", TypeError), ("strided", ValueError), ("rx", ValueError),
    ("ports", ValueError), ("noise", ValueError), ("b", ValueError),
    ("prb", ValueError), ("n_re", ValueError), ("re_tab", ValueError),
    ("empty", ValueError)])
def test_wrapper_checks_what_the_kernel_does_not_take(what, err):
    """The checks the CUDA route makes before a launch (run here on CPU
    tensors: they need no card)."""
    cell, grids, h, nv, jobs, re_of, rows, table, re_tab = rows_of(1, 2)
    args = [grids, h, nv, table, re_tab, cell]
    if what == "dtype":
        args[0] = grids.double()
    elif what == "strided":
        args[1] = torch.cat([h, h], dim=4)[:, :, :, :, ::2]
    elif what == "rx":
        args[0] = torch.cat([grids] * 3, dim=1)
        args[1] = torch.cat([h] * 3, dim=1)
    elif what == "ports":
        args[1] = h[:, :, :1].contiguous()
    elif what == "noise":
        args[2] = nv[:2]
    elif what == "b":
        table.desc[pdsch_eq.B] = len(SFS)
    elif what == "prb":
        table.prbs[0] = N_PRB
    elif what == "n_re":
        table.desc[pdsch_eq.NRE] += 1
    elif what == "re_tab":
        args[4] = re_tab[:, :256].contiguous()
    elif what == "empty":
        args[3] = pdsch_eq.Table(2)
    with pytest.raises(err):
        pdsch_eq._check(*args)
    # and the inputs as they should be pass
    if what not in ("b", "prb", "n_re"):
        assert pdsch_eq._check(grids, h, nv, table, re_tab, cell) == (1, 2)


def test_table_layout_and_refusals():
    t = pdsch_eq.Table(2)
    assert t.add_prbs(1, 4, 0xFFFFFFFF, 0.5, 1000, 1024, 2, [3, 4]) == 0
    assert t.add_row(0, 8, 7, 1.0, 1030, 1280, 5) == 1
    assert t.n_grants == 2 and t.wm == 1280 * 8 and t.n_pad_tab == 1280
    # 1024 / 2 threads' pairs over 128-thread blocks: 4; 1280 / 2: 5
    assert list(t.first) == [0, 4, 9] and t.n_blocks == 9
    arr = t.array()
    assert arr.dtype == np.int32 and len(arr) == 2 * 8 + 3 + 2
    assert list(arr[:8]) == [1, 4, -1, int(np.float32(0.5).view(np.int32)),
                             1000, 1024, 0, 2 << 8 | 2]
    assert list(arr[8:16]) == [0, 8, 7, int(np.float32(1.0).view(np.int32)),
                               1030, 1280, 5, -1]
    assert list(arr[16:]) == [0, 4, 9, 3, 4]
    for bad in (dict(qm=3), dict(n_re=0), dict(n_pad=999)):
        kw = dict(b=0, qm=2, c_init=1, pa=1.0, n_re=1000, n_pad=1024, u=0)
        kw.update(bad)
        with pytest.raises(ValueError):
            t.add_row(**kw)
    with pytest.raises(ValueError):
        pdsch_eq.Table(3)
    assert pdsch_eq.Table(4).add_row(0, 2, 0, 1.0, 1, 256, 0) == 0


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_cell_constants_count_the_prb_grants(ports):
    """The kernel's per-symbol subcarriers give a PRB-list grant's RE
    count, and its REs' subcarriers, as grant_re_indices does."""
    cell = CellConfig(n_id_cell=77, n_prb=N_PRB, nof_ports=ports)
    ints = pdsch_eq.cell_constants(cell)
    res = pdsch_mod.reserved_re_mask(cell, 3, 0)
    for l in range(14):
        ks = np.flatnonzero(~res[l, :12])
        assert ints[l] == len(ks)
        np.testing.assert_array_equal(ints[14 + 12 * l:14 + 12 * l + len(ks)],
                                      ks)
    for cfi in (1, 2, 3):
        mask = _mask((2, 7), (20, 22))
        n = len(pdsch_mod.grant_re_indices(cell, 3, cfi, mask))
        assert 7 * ints[cfi:14].sum() == n


def test_bytes_moved():
    t = pdsch_eq.Table(2)
    t.add_prbs(0, 4, 1, 1.0, 1000, 1024, 2, [3, 4, 5])
    t.add_row(0, 2, 1, 1.0, 900, 1024, 0)
    # 1 RX x (1 + 2 ports) complex values of 8 bytes per RE; 4 bytes a PRB,
    # 8 an index; noise, descriptor, first[] word and wm floats a grant
    assert pdsch_eq.bytes_moved(t, 1) == \
        3 * 8 * 1900 + 4 * 3 + 8 * 1024 + 2 * (4 + 32 + 4 + 4 * 4096)


# ---------------------------------------------------------------------------
# the counter and the metric's reader
# ---------------------------------------------------------------------------
def test_dispatch_counts_its_grants_once(monkeypatch):
    """One eq/demap call per dispatch, counted once with its grants; the
    single-grant path counts one grant."""
    cell, grids, h, nv, jobs, re_of = eq_grants.batch("mixed", 1, 2)
    calls = []
    real = pdsch_eq.eq_demap
    monkeypatch.setattr(pdsch_eq, "eq_demap",
                        lambda *a: calls.append(a[3].n_grants) or real(*a))
    jobs[3].tbs = 0                       # no bits: not dispatched
    prof.reset()
    pb = pdsch_rx.dispatch_grants_batch(grids, h, nv, cell, jobs, n_iter=2)
    assert calls == [len(jobs) - 1]
    assert prof.counters()["pdsch_eq_grants"] == {"total": len(jobs) - 1,
                                                  "events": 1}
    assert pb.eq_host is not None
    pdsch_rx.finish_grants_batch(pb)
    assert pb.eq_host is None
    j = jobs[1]
    pdsch_rx.decode_grant(grids, h, nv, j.b, cell, j.sf_idx, j.cfi, j.rnti,
                          j.prb_mask, j.qm, 600, n_iter=2)
    assert calls[-1] == 1
    assert prof.counters()["pdsch_eq_grants"] == {"total": len(jobs),
                                                  "events": 2}


def _reader():
    return importlib.import_module(
        "sniffbench.metrics.eq_grants_per_launch").read


def test_reader_on_a_filled_tracer():
    prof.reset()
    for g in (384, 380, 388):
        prof.count("pdsch_eq_grants", g)
    rec = {"config": {}, "n_iter": 2, "span_sf": 96, "spans": {}}
    assert _reader()(rec) == pytest.approx(384.0)


def test_reader_of_an_empty_record_or_the_parent_is_none(monkeypatch):
    prof.reset()
    assert _reader()({"config": {}, "n_iter": 2}) is None
    rec = {"config": {}, "n_iter": 2, "span_sf": 96, "spans": {}}
    assert _reader()(rec) is None           # no launch in the window
    old = types.ModuleType("prof")
    old.report = lambda: {}
    monkeypatch.setitem(sys.modules, "ltesniffer_tpu_torch.sniffer.prof",
                        old)
    assert _reader()(rec) is None           # a tracer without counters
