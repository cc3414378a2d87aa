"""Tests of the port that need a CUDA card (marker `cuda`); they skip
without one.  This file imports neither JAX nor the reference package, so
it also runs on the card's machine, which has no JAX (tests/conftest.py
imports JAX, hence --noconftest there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.kernels import bcjr, mimo_eq, pdcch_tail, turbo
from ltesniffer_tpu_torch.kernels import turbo_decode, viterbi
from ltesniffer_tpu_torch.testing import eq_grants, mimo_grants

torch.set_num_threads(1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [8, 16, 32])
def test_bcjr_kernel_matches_twin(card, W):
    """One pass: kernel vs plain twin on the same card tensors, and one
    launch counted per call."""
    g = torch.Generator().manual_seed(W)
    L = 1024
    ins = [(torch.randn((W, L), generator=g) * 3.0).to(card)
           for _ in range(3)]
    ins += [torch.randn((8, L), generator=g).to(card) for _ in range(2)]
    n0 = bcjr.LAUNCHES["bcjr"]
    got = bcjr.bcjr(*ins)
    torch.cuda.synchronize()
    assert bcjr.LAUNCHES["bcjr"] == n0 + 1
    for a, b in zip(got, bcjr.bcjr_plain(*ins)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def _coded(K, B, rng):
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    sent = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.stack([turbo_host.turbo_encode(b) for b in sent])
    x = 1.0 - 2.0 * d
    llr = (1.5 * x + rng.normal(size=d.shape)).astype(np.float32)
    prior = (0.8 * x + rng.normal(size=d.shape)).astype(np.float32)
    return sent, llr, prior


@pytest.mark.cuda
def test_decoder_on_card_equals_host(card):
    """The main-path decoder on the card (the fused kernel) and the lane
    decoder through the per-pass kernel decide the same bits as the
    decoder through the plain twin on the host."""
    rng = np.random.default_rng(0)
    K, B = 512, 16
    sent, llr, _ = _coded(K, B, rng)
    on_host, _ = turbo.make_decoder(K, 8)(torch.from_numpy(llr))
    np.testing.assert_array_equal(on_host.numpy(), sent)
    for dec in (turbo.make_decoder(K, 8), turbo.make_decoder_lanes(K, 8)):
        on_card, _ = dec(torch.from_numpy(llr).to(card))
        np.testing.assert_array_equal(on_card.cpu().numpy(), on_host.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [40, 512, 1824, 6144])
def test_fused_decode_equals_plain(card, K):
    """The fused whole-decode kernel against its plain version (the lane
    decoder over the plain twin, on the host): equal bits and LLRs, n_iter
    2 and 12, with and without a HARQ prior; one launch per call."""
    rng = np.random.default_rng(K)
    B = 3 if K == 6144 else 24
    sent, llr, prior = _coded(K, B, rng)
    for n_iter in (2, 12):
        for d in (llr, llr + prior):
            want_bits, want_llr = turbo.make_decoder(K, n_iter)(
                torch.from_numpy(d))
            n0 = turbo_decode.LAUNCHES["turbo_decode"]
            bits, out = turbo.make_decoder(K, n_iter)(
                torch.from_numpy(d).to(card))
            torch.cuda.synchronize()
            assert turbo_decode.LAUNCHES["turbo_decode"] == n0 + 1
            np.testing.assert_array_equal(bits.cpu().numpy(),
                                          want_bits.numpy())
            torch.testing.assert_close(out.cpu(), want_llr, rtol=0, atol=0)
        np.testing.assert_array_equal(bits.cpu().numpy(), sent)


def _mimo_block_sizes():
    """K of every codeword the MIMO cell sends, and of the 64QAM-table
    trial the sniffer makes first for a 256QAM-table UE."""
    from ltesniffer_tpu_torch.phy import tables
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    from ltesniffer_tpu_torch.testing import mimo_cell
    cases = [(m, False) for pair in mimo_cell.MIMO_MCS_64 for m in pair]
    cases += [(m, t) for m in mimo_cell.MIMO_MCS_256 for t in (False, True)]
    ks = set()
    for mcs, use256 in cases:
        _, itbs = tables.dl_mcs_to_qm_itbs(mcs, use256)
        tbs = tables.tbs_lookup(itbs, mimo_cell.N_PRB_GRANT)
        ks.update(turbo_host.segment_sizes(tbs).K)
    return sorted(ks)


@pytest.mark.cuda
def test_fused_decode_at_mimo_shapes_equals_plain(card):
    """The two-codeword path's decodes: the MIMO cell's K values, two code
    blocks per call, n_iter 8, with and without a HARQ prior — the fused
    kernel's bits and LLRs equal the plain version's."""
    rng = np.random.default_rng(8)
    ks = _mimo_block_sizes()
    assert len(ks) >= 3
    for K in ks:
        sent, llr, prior = _coded(K, 2, rng)
        for d in (llr, llr + prior):
            want_bits, want_llr = turbo.make_decoder(K, 8)(
                torch.from_numpy(d))
            n0 = turbo_decode.LAUNCHES["turbo_decode"]
            bits, out = turbo.make_decoder(K, 8)(torch.from_numpy(d).to(card))
            torch.cuda.synchronize()
            assert turbo_decode.LAUNCHES["turbo_decode"] == n0 + 1
            np.testing.assert_array_equal(bits.cpu().numpy(),
                                          want_bits.numpy())
            torch.testing.assert_close(out.cpu(), want_llr, rtol=0, atol=0)
        np.testing.assert_array_equal(bits.cpu().numpy(), sent)


@pytest.mark.cuda
def test_decode_grant_mimo_on_card_equals_host(card):
    """One two-codeword grant decoded from the same grids on the card and
    on the host (each through its own frontend): both codewords CRC-ok
    on both, with the bits that were sent."""
    from ltesniffer_tpu_torch.phy import tables
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import frontend, pdsch_rx
    from ltesniffer_tpu_torch.testing import encoder
    cell = CellConfig(n_id_cell=93, n_prb=50, nof_ports=2, nof_rx_ant=2)
    rng = np.random.default_rng(12)
    mask = np.zeros(50, bool)
    mask[5:25] = True
    tbss = (tables.tbs_lookup(12, 20), tables.tbs_lookup(14, 20))
    sent = [rng.integers(0, 2, t).astype(np.uint8) for t in tbss]
    g = encoder.build_control_subframe(cell, 2, 2, [])
    encoder.add_pdsch_mimo(g, cell, 2, 2, 0x5151, mask, (4, 4), sent, tm=4,
                           pmi=2)
    h = encoder.flat_channel(cell, 2, rng)
    iq = encoder.subframe_iq(cell, encoder.apply_channel(g, h, 0.02, rng))
    from ltesniffer_tpu_torch.kernels import cplx
    ri = torch.from_numpy(cplx.to_ri(iq[None].astype(np.complex64)))
    res = {}
    for dev in ("cpu", card):
        fe = frontend.make_frontend(cell).run_ri(
            ri.to(dev), torch.tensor([2], device=dev))
        res[str(dev)] = pdsch_rx.decode_grant_mimo(
            fe["grids"], fe["h"], fe["noise_var"], 0, cell, 2, 2,
            rnti=0x5151, prb_mask=mask, qms=(4, 4), tbss=tbss, tm=4, pmi=2)
    for q in (0, 1):
        assert res["cpu"][q].crc_ok and res[str(card)][q].crc_ok
        np.testing.assert_array_equal(res[str(card)][q].tb_bits, sent[q])


@pytest.mark.cuda
def test_fused_decode_at_ul_shape_equals_plain(card):
    """The UL cell's code blocks (K = 832, MCS 6 on 8 PRB), n_iter 2 (the
    primary pass) and 12 (the escalation), with and without a HARQ prior:
    the fused kernel's bits and LLRs equal the plain version's."""
    rng = np.random.default_rng(832)
    sent, llr, prior = _coded(832, 64, rng)
    for n_iter in (2, 12):
        for d in (llr, llr + prior):
            want_bits, want_llr = turbo.make_decoder(832, n_iter)(
                torch.from_numpy(d))
            n0 = turbo_decode.LAUNCHES["turbo_decode"]
            bits, out = turbo.make_decoder(832, n_iter)(
                torch.from_numpy(d).to(card))
            torch.cuda.synchronize()
            assert turbo_decode.LAUNCHES["turbo_decode"] == n0 + 1
            np.testing.assert_array_equal(bits.cpu().numpy(),
                                          want_bits.numpy())
            torch.testing.assert_close(out.cpu(), want_llr, rtol=0, atol=0)
    np.testing.assert_array_equal(bits.cpu().numpy(), sent)


@pytest.mark.cuda
def test_ul_frontend_and_equalizer_on_card_match_cpu(card):
    """The UL frontend (packed-int8 ingest) and `_eq_batch_ul_fn` on the
    card against the same functions on the host: grids and LLRs within
    rtol 1e-4 plus atol 1e-4 of the peak, snr_db within 1e-3 dB, ta_us
    within 1e-4 us (sums in another order on the card); the grants decode
    to the bits that were sent on both."""
    from ltesniffer_tpu_torch.kernels import cplx
    from ltesniffer_tpu_torch.phy import pdsch as pdsch_mod, tables
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import pusch_rx
    from ltesniffer_tpu_torch.testing import encoder
    cell = CellConfig(n_id_cell=147, n_prb=50, nof_ports=2, nof_rx_ant=1)
    rng = np.random.default_rng(21)
    grants = []
    for k, (n_prb, qm, itbs) in enumerate(((8, 2, 6), (10, 4, 12))):
        tbs = tables.tbs_lookup(itbs, n_prb)
        grants.append(dict(rnti=0x4100 + k, prb_start=2 + 15 * k,
                           n_prb=n_prb, qm=qm, tbs=tbs, dmrs_field=k,
                           tb_bits=rng.integers(0, 2, tbs).astype(np.uint8)))
    g = encoder.build_ul_subframe(cell, 3, grants)
    g = g + 0.02 / np.sqrt(2) * (rng.standard_normal(g.shape)
                                 + 1j * rng.standard_normal(g.shape))
    iq = encoder.ul_subframe_iq(cell, g.astype(np.complex64))
    words, scales = cplx.to_i8_packed(iq[None])
    w64 = torch.from_numpy(cplx.view_i64(words))
    sc = torch.from_numpy(scales)
    fe = pusch_rx.make_ul_frontend(cell)
    grids = {dev: fe.run_i8c64(w64.to(dev), sc.to(dev))
             for dev in ("cpu", card)}
    want = grids["cpu"].numpy()
    peak = float(np.abs(want).max())
    np.testing.assert_allclose(grids[card].cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4 * peak)
    for gr in grants:
        cinit = pdsch_mod.scrambling_cinit(gr["rnti"], 0, 3, cell.n_id_cell)
        dmrs = pusch_rx._dmrs_ri(gr["n_prb"], 3, cell.n_id_cell, 0,
                                 gr["dmrs_field"])
        run = pusch_rx._eq_batch_ul_fn(cell, gr["n_prb"], gr["qm"])
        out = {}
        for dev in ("cpu", card):
            t = lambda x: torch.tensor(x, device=dev)      # noqa: E731
            out[dev] = [x.cpu().numpy() for x in run(
                grids[dev], t([0]), t([12 * gr["prb_start"]]),
                torch.from_numpy(dmrs[None]).to(dev), t([cinit]))]
        llr_peak = float(np.abs(out["cpu"][0]).max())
        np.testing.assert_allclose(out[card][0], out["cpu"][0], rtol=1e-4,
                                   atol=1e-4 * llr_peak)
        np.testing.assert_allclose(out[card][1], out["cpu"][1], rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(out[card][2], out["cpu"][2], rtol=0,
                                   atol=1e-4)
        for dev in ("cpu", card):
            res = pusch_rx.decode_grant_ul(
                grids[dev][0], cell, 3, gr["rnti"], gr["prb_start"],
                gr["n_prb"], gr["qm"], gr["tbs"], dmrs_field=gr["dmrs_field"])
            assert res.crc_ok
            np.testing.assert_array_equal(res.tb_bits, gr["tb_bits"])


@pytest.mark.cuda
def test_run_stream_on_card_equals_cpu(card):
    """The live entry point on the card: a 50-PRB stream behind a noise
    lead, with a 300 Hz CFO and 2.5 subframes cut out (sync loss, PSS
    re-acquire, SFN re-read from the MIB), through `run_source` in odd
    blocks — the card's results, summary and pcap equal the CPU run's."""
    from ltesniffer_tpu_torch.io import sdr
    from ltesniffer_tpu_torch.mac_rrc import mac
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import scenario, stream_cell
    cell = CellConfig(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
    sb = scenario.ScenarioBuilder(cell, seed=11, noise=0.04)
    pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=3, payload=b"tail-traffic")])
    for j in range(80):
        sf = j % 10
        txs = []
        if j >= 2 and sf not in (0, 5):
            txs.append(scenario.DlTx(rnti=0x3c3c, mac_pdu=pdu, n_prb=10,
                                     prb_start=20, harq_pid=j % 8,
                                     ndi=(j // 8) % 2))
        sb.add_subframe(sf, txs, with_pbch_sfn=100 + j // 10
                        if sf == 0 else None)
    stream = stream_cell.impair(sb.stream(), cell.n_fft, cell.sf_len,
                                np.random.default_rng(1), gap_at=24)
    out = {}
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        for dev in ("cpu", "cuda"):
            path = f"{d}/{dev}.pcap"
            c = core.LTESnifferCore(core.SnifferConfig(
                cell=cell, batch_size=8, pcap_path=path, device=dev))
            c.run_source(sdr.ArraySource(stream, cell.srate,
                                         chunk_limit=3 * cell.sf_len + 777),
                         chunk_subframes=16)
            c.close()
            out[dev] = ([(r.dci.rnti, r.dci.sfn, r.dci.sf_idx, r.crc_ok,
                          r.payload) for r in c.results], c.summary(),
                        open(path, "rb").read())
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2] == out["cpu"][2]
    assert out["cuda"][1]["resyncs"] >= 1
    assert sum(1 for r in out["cuda"][0] if r[3]) >= 15


# the loaded cell's blind-search payload sizes (DCI + CRC16), the MIB's
VITERBI_SEARCH_SIZES = (31, 44, 46, 55, 64, 67)


def _viterbi_groups(case, card):
    """LLR groups of one Viterbi call for `case`, on the card."""
    rng = np.random.default_rng(31)
    if case == "search":        # 4 subframes x 157 locations per size
        shapes = [(628, d) for d in VITERBI_SEARCH_SIZES]
    elif case == "odd":         # N = 1, and N not a multiple of the warps
        shapes = [(1, 40), (7, 31), (1, 67)]
    elif case == "straddle":    # N not a multiple of 32: partial warps
        shapes = [(33, 31), (1, 67), (63, 44)]
    else:                       # the MIB: 12 codewords of D = 40
        shapes = [(12, 40)]
    out = []
    for n, d in shapes:
        x = 2.0 * rng.standard_normal((n, 3, d))
        if case == "zeros":
            x[:] = 0.0
        elif case == "constant":
            x[:] = -0.75
        out.append(torch.from_numpy(x.astype(np.float32)).to(card))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["search", "mib", "odd", "straddle",
                                  "zeros", "constant"])
def test_viterbi_kernel_equals_plain(card, case):
    """The Viterbi kernel against its plain version on the same card
    tensors: equal bits at the search's six sizes in one call, at the
    MIB's, for odd counts, for groups that end in partial warps and on
    ties; one launch per call."""
    groups = _viterbi_groups(case, card)
    want = viterbi.viterbi_decode_tb_multi_plain(groups)
    n0 = viterbi.LAUNCHES["viterbi"]
    got = viterbi.viterbi_decode_tb_multi(groups)
    torch.cuda.synchronize()
    assert viterbi.LAUNCHES["viterbi"] == n0 + 1
    for a, b in zip(got, want):
        assert a.device == groups[0].device
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    one = viterbi.viterbi_decode_tb(groups[0])
    assert viterbi.LAUNCHES["viterbi"] == n0 + 2
    np.testing.assert_array_equal(one.cpu().numpy(), want[0].cpu().numpy())


@pytest.mark.cuda
def test_viterbi_kernel_noiseless_roundtrip(card):
    """Random messages through the port's encoder decode to themselves."""
    rng = np.random.default_rng(4)
    msgs = torch.from_numpy(rng.integers(0, 2, (256, 55)).astype(np.uint8))
    coded = viterbi.conv_encode_tb(msgs.to(card))
    bits = viterbi.viterbi_decode_tb(1.0 - 2.0 * coded.to(torch.float32))
    np.testing.assert_array_equal(bits.cpu().numpy(), msgs.numpy())


@pytest.mark.cuda
def test_viterbi_kernel_refuses_oversize_codewords(card):
    """The C entry owns the shared-memory limit: the largest D its layout
    takes decodes as the plain version does; one past it, or far past it,
    is refused with cudaErrorInvalidValue, nothing launched."""
    d_max = viterbi.max_d(32)
    assert 67 < d_max < 1024
    x = torch.from_numpy((2.0 * np.random.default_rng(9).standard_normal(
        (5, 3, d_max))).astype(np.float32)).to(card)
    np.testing.assert_array_equal(
        viterbi.viterbi_decode_tb(x).cpu().numpy(),
        viterbi.viterbi_decode_tb_plain(x).cpu().numpy())
    n0 = viterbi.LAUNCHES["viterbi"]
    for d in (d_max + 1, 1024):
        with pytest.raises(RuntimeError, match="cudaError 1 "):
            viterbi.viterbi_tb_cuda([torch.zeros((4, 3, d), device=card)])
    assert viterbi.LAUNCHES["viterbi"] == n0


@pytest.mark.cuda
def test_unified_search_through_kernel_equals_plain(card, monkeypatch):
    """`make_unified_search` on the card: `cand_fused` through the Viterbi
    kernel's search entry equals `cand_fused` through the plain step loop
    (on pdcch_derm's LLRs, the three-launch route) on the same grids, word
    for word."""
    from ltesniffer_tpu_torch.mac_rrc import mac
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import frontend, pdcch_rx
    from ltesniffer_tpu_torch.testing import scenario
    cell = CellConfig(n_id_cell=55, n_prb=50, nof_ports=2, nof_rx_ant=1)
    sb = scenario.ScenarioBuilder(cell, seed=3, noise=0.04)
    pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=3, payload=b"search")])
    for j in range(10):
        sb.add_subframe(j, [scenario.DlTx(rnti=0x4000 + j, mac_pdu=pdu,
                                          n_prb=6, prb_start=10)])
    x = sb.stream().reshape(10, 1, cell.sf_len)
    sf = torch.arange(10, dtype=torch.int64, device=card)
    fe = frontend.make_frontend(cell).run(x, sf, card)
    run, _ = pdcch_rx.make_unified_search(cell)

    def search():
        return run(fe["grids"], fe["h"], fe["noise_var"], fe["snr_db"], sf,
                   fe["cfi"] - 1, fe["scalars"])["cand_fused"].cpu().numpy()
    n0 = dict(viterbi.LAUNCHES)
    got = search()
    assert viterbi.LAUNCHES == dict(n0, viterbi_search=n0["viterbi_search"]
                                    + 1)
    p0 = viterbi.PLAIN_CUDA["viterbi"]
    monkeypatch.setattr(viterbi, "viterbi_decode_tb_multi",
                        viterbi.viterbi_decode_tb_multi_plain)
    monkeypatch.setattr(pdcch_tail, "decode_tail_cuda",
                        lambda *a, **k: pdcch_tail.decode_tail_three(*a[:6]))
    want = search()
    assert viterbi.PLAIN_CUDA["viterbi"] == p0 + 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", mimo_grants.VARIANTS,
                         ids=[mimo_grants.variant_id(v)
                              for v in mimo_grants.VARIANTS])
def test_mimo_eq_kernel_matches_plain(card, variant):
    """One launch of the two-codeword eq/demap kernel per call, within
    the tolerance of the plain chain on the same card tensors and of the
    plain chain on the host, at the MIMO cell's grid width (100 PRB)."""
    tm, ports, pmi, qm0, qm1, _, _ = variant
    inp = mimo_grants.random_grant(variant, seed=5, n_sc=1200)
    ts = mimo_grants.tensors(inp, card)
    n0 = mimo_eq.LAUNCHES["mimo_eq_demap"]
    got = mimo_eq.eq_demap_mimo(*ts, *inp[4], tm, pmi, qm0, qm1)
    torch.cuda.synchronize()
    assert mimo_eq.LAUNCHES["mimo_eq_demap"] == n0 + 1
    assert got.shape == (len(inp[3]) * (qm0 + qm1),)
    for want in (mimo_eq.eq_demap_mimo_plain(*ts, *inp[4], tm, pmi, qm0,
                                             qm1),
                 mimo_eq.eq_demap_mimo(*mimo_grants.tensors(inp, "cpu"),
                                       *inp[4], tm, pmi, qm0, qm1)):
        err, ok = mimo_grants.max_err(got, want)
        assert ok, f"largest error {err}"


# the search tail's shapes: the 20 MHz cell's unified search, a 25-PRB
# 4-port cell (7 payload sizes, 31 locations, 17 CCEs: odd counts) and a
# 6-PRB cell (D = 24-47: the search entry's staging takes 3 codewords of
# D = 24 at a time)
TAIL_CELLS = {"20mhz": (301, 100, 2), "25prb_4port": (7, 25, 4),
              "6prb": (3, 6, 1)}


def _tail_inputs(name, card, B, half_integer=False, seed=0):
    """(llr, cce_power, scalars, size_consts, n_loc) of one search call of
    `name`'s unified search, seeded, on the card.  Half-integer LLRs make
    every de-rate-match sum exact in any order."""
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    n_id, n_prb, ports = TAIL_CELLS[name]
    st = pdcch_rx._static_maps(CellConfig(n_id_cell=n_id, n_prb=n_prb,
                                          nof_ports=ports), 3)
    sc = pdcch_rx._size_consts_of(st)
    rng = np.random.default_rng(seed)
    n_bits = 8 * (len(st["gather_idx"]) // 4)
    if half_integer:
        llr = rng.integers(-12, 13, (B, n_bits)) / 2.0
    else:
        llr = 3.0 * rng.standard_normal((B, n_bits))
        llr[:, ::7] *= 0.0                   # +-0, as beyond a region
    cce = np.abs(rng.standard_normal((B, st["nof_cce"])))
    scal = rng.standard_normal((B, 4))
    t = [torch.from_numpy(x.astype(np.float32)).to(card)
         for x in (llr, cce, scal)]
    return (*t, sc, len(st["locs"]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TAIL_CELLS))
def test_pdcch_derm_kernel_equals_plain(card, name):
    """pdcch_derm against its plain version: bit for bit on the card where
    every sum is exact (half-integer LLRs), within 1e-5 of the LLRs' peak
    on the card otherwise (cuBLAS orders the einsum's sums by shape), and
    bit for bit against the plain version on the host (the kernel sums in
    MKL's order); one launch per call, views of one buffer."""
    B = 64 if name == "20mhz" else 5
    for half in (True, False):
        llr, _, _, sc, n_loc = _tail_inputs(name, card, B, half)
        n0 = pdcch_tail.LAUNCHES["pdcch_derm"]
        got = pdcch_tail.derm_cuda(llr, sc, n_loc, B)
        torch.cuda.synchronize()
        assert pdcch_tail.LAUNCHES["pdcch_derm"] == n0 + 1
        assert len({g.untyped_storage().data_ptr() for g in got}) == 1
        want = pdcch_tail.derm_plain(llr, sc, n_loc, B)
        host = pdcch_tail.derm_plain(llr.cpu(), sc, n_loc, B)
        peak = float(llr.abs().max())
        for g, w, h in zip(got, want, host):
            assert g.shape == w.shape and g.is_contiguous()
            g = g.cpu().numpy()
            if half:
                np.testing.assert_array_equal(g, w.cpu().numpy())
            else:
                np.testing.assert_allclose(g, w.cpu().numpy(), rtol=0,
                                           atol=1e-5 * peak)
            np.testing.assert_array_equal(g.view(np.int32),
                                          h.numpy().view(np.int32))
            assert not np.signbit(g[g == 0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TAIL_CELLS))
def test_pdcch_crc_pack_kernel_equals_plain(card, name):
    """pdcch_crc_pack against its plain version on the same card bits:
    cand_fused (with and without the scalars), the RNTIs, meta and payload
    words word for word; without the optional outputs the same row; one
    launch per call."""
    B = 64 if name == "20mhz" else 5
    llr, cce, scal, sc, n_loc = _tail_inputs(name, card, B, seed=1)
    bits = viterbi.viterbi_decode_tb_multi(
        pdcch_tail.derm_cuda(llr, sc, n_loc, B))
    for s_ in (None, scal):
        n0 = pdcch_tail.LAUNCHES["pdcch_crc_pack"]
        got = pdcch_tail.crc_pack_cuda(bits, cce, n_loc, B, s_)
        short = pdcch_tail.crc_pack_cuda(bits, cce, n_loc, B, s_,
                                         outputs=False)
        torch.cuda.synchronize()
        assert pdcch_tail.LAUNCHES["pdcch_crc_pack"] == n0 + 2
        want = pdcch_tail.crc_pack_plain(bits, cce, tuple(sc), n_loc, B, s_)
        f = got["cand_fused"].cpu().numpy()
        np.testing.assert_array_equal(f, want["cand_fused"].cpu().numpy())
        np.testing.assert_array_equal(short["cand_fused"].cpu().numpy(), f)
        np.testing.assert_array_equal(got["cand_meta"].cpu().numpy(),
                                      want["cand_meta"].cpu().numpy())
        np.testing.assert_array_equal(
            got["cand_pay"].cpu().numpy().view(np.uint32),
            want["cand_pay"].cpu().numpy())
        for s, D in enumerate(sc):
            np.testing.assert_array_equal(
                got["rnti"][..., s].cpu().numpy(),
                want[f"rnti_{D}"].cpu().numpy())


@pytest.mark.cuda
def test_tail_through_kernels_equals_plain(card):
    """The whole tail on the card: two launches (the Viterbi's search
    entry, pdcch_pack) and no plain version; on exact-sum LLRs every
    output equals the plain tail's on the card and on the host."""
    from ltesniffer_tpu_torch.sniffer import pdcch_rx
    B = 64
    llr, cce, scal, sc, n_loc = _tail_inputs("20mhz", card, B, True, seed=2)
    pdcch_tail.reset_launches()
    viterbi.reset_launches()
    got = pdcch_rx._candidate_decode_tail(llr, cce, sc, n_loc, B,
                                          scalars=scal)
    torch.cuda.synchronize()
    assert pdcch_tail.LAUNCHES == {"pdcch_derm": 0, "pdcch_crc_pack": 0,
                                   "pdcch_pack": 1}
    assert viterbi.LAUNCHES == {"viterbi": 0, "viterbi_search": 1}
    assert not any(pdcch_tail.PLAIN_CUDA.values())
    assert not any(viterbi.PLAIN_CUDA.values())
    want = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B, scal)
    host = pdcch_tail.decode_tail_plain(llr.cpu(), cce.cpu(), sc, n_loc, B,
                                        scal.cpu())
    assert list(got) == list(want)
    for k in got:
        g = got[k].cpu().numpy()
        for w in (want[k].cpu().numpy(), host[k].numpy()):
            if k == "cand_pay":
                g, w = g.view(np.uint32), w.astype(np.uint32)
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.cuda
def test_core_runs_the_tail_through_the_kernels(card, tmp_path):
    """A core run on the card (the golden scenario): every search call's
    tail is one launch of the Viterbi's search entry and one of
    pdcch_pack, neither pdcch_derm nor pdcch_crc_pack, no plain tail on the
    card, and no constant uploaded again by a second run."""
    from ltesniffer_tpu_torch.kernels import cplx
    from ltesniffer_tpu_torch.sniffer import core, pdcch_rx
    from ltesniffer_tpu_torch.testing import stream_cell
    cell, stream, _ = stream_cell.golden_scenario()
    calls = []
    real = pdcch_rx._candidate_decode_tail

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    pdcch_rx._candidate_decode_tail = counted
    try:
        uploads = []
        for k in range(2):
            pdcch_tail.reset_launches()
            viterbi.reset_launches()
            calls.clear()
            c = core.LTESnifferCore(core.SnifferConfig(
                cell=cell, batch_size=8, device="cuda",
                pcap_path=str(tmp_path / f"g{k}.pcap"), api_mode=0))
            c.run_samples(stream)
            c.close()
            torch.cuda.synchronize()
            uploads.append(cplx.UPLOADS["n"])
            assert len(calls) > 0
            assert pdcch_tail.LAUNCHES == {"pdcch_derm": 0,
                                           "pdcch_crc_pack": 0,
                                           "pdcch_pack": len(calls)}
            assert viterbi.LAUNCHES["viterbi_search"] == len(calls)
            assert not any(pdcch_tail.PLAIN_CUDA.values())
    finally:
        pdcch_rx._candidate_decode_tail = real
    assert uploads[1] == uploads[0]


def _route_vs_three(a, B):
    """The two-launch route and the three-launch route on the same card
    inputs: every output, bits of every size included, word for word;
    the search entry's words equal compact_plain of the three-launch
    route's bits."""
    llr, cce, scal, sc, n_loc = a
    for s_ in (None, scal):
        got = pdcch_tail.decode_tail(llr, cce, sc, n_loc, B, s_)
        three = pdcch_tail.decode_tail_three(llr, cce, sc, n_loc, B, s_)
        assert list(got) == list(three)
        for k in three:
            np.testing.assert_array_equal(got[k].cpu().numpy(),
                                          three[k].cpu().numpy(), err_msg=k)
    comp, bits = viterbi.viterbi_search_cuda(llr, sc, n_loc, B, True)
    want = pdcch_tail.compact_plain(
        [three[f"bits_{D}"].reshape(B * n_loc, D) for D in sc])
    np.testing.assert_array_equal(comp.cpu().numpy(), want.cpu().numpy())
    for b, D in zip(bits, sc):
        np.testing.assert_array_equal(
            b.cpu().numpy(), three[f"bits_{D}"].reshape(-1, D).cpu().numpy())
    return comp


@pytest.mark.cuda
@pytest.mark.parametrize("half", [False, True], ids=["random", "exact"])
@pytest.mark.parametrize("name", sorted(TAIL_CELLS))
def test_viterbi_search_equals_three_launch_route(card, name, half):
    """The Viterbi's search entry and pdcch_pack against pdcch_derm, the
    plain entry and pdcch_crc_pack on the same card LLRs: bits, words and
    every tail output word for word (the staging sums in pdcch_derm's
    order); on exact sums also the plain tail's; one launch each."""
    B = 64 if name == "20mhz" else 5
    a = _tail_inputs(name, card, B, half, seed=3)
    n0, p0 = viterbi.LAUNCHES["viterbi_search"], \
        pdcch_tail.LAUNCHES["pdcch_pack"]
    comp, _ = viterbi.viterbi_search_cuda(*a[:1], a[3], a[4], B)
    pdcch_tail.pack_cuda(comp, a[1], a[4], B, a[2])
    torch.cuda.synchronize()
    assert viterbi.LAUNCHES["viterbi_search"] == n0 + 1
    assert pdcch_tail.LAUNCHES["pdcch_pack"] == p0 + 1
    assert comp.dtype == torch.int32 and tuple(comp.shape) == (
        len(a[3]), B * a[4], 3)
    _route_vs_three(a, B)
    if half:
        llr, cce, scal, sc, n_loc = a
        got = pdcch_tail.decode_tail(llr, cce, sc, n_loc, B, scal)
        want = pdcch_tail.route_plain(llr.cpu(), cce.cpu(), sc, n_loc, B,
                                      scal.cpu())
        for k in want:
            np.testing.assert_array_equal(got[k].cpu().numpy(),
                                          want[k].numpy(), err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TAIL_CELLS))
def test_pdcch_pack_kernel_equals_plain(card, name):
    """pdcch_pack against pack_plain on the same card words (the search
    entry's): cand_fused with and without the scalars, the RNTIs, meta
    and payload words word for word; without the optional outputs the
    same row."""
    B = 64 if name == "20mhz" else 5
    llr, cce, scal, sc, n_loc = _tail_inputs(name, card, B, seed=4)
    comp, _ = viterbi.viterbi_search_cuda(llr, sc, n_loc, B)
    for s_ in (None, scal):
        got = pdcch_tail.pack_cuda(comp, cce, n_loc, B, s_, outputs=True)
        short = pdcch_tail.pack_cuda(comp, cce, n_loc, B, s_)
        want = pdcch_tail.pack_plain(comp, cce, n_loc, B, s_)
        assert set(short) == {"cand_fused"}
        np.testing.assert_array_equal(short["cand_fused"].cpu().numpy(),
                                      want["cand_fused"].cpu().numpy())
        assert list(got) == ["cand_fused", "rnti", "cand_meta", "cand_pay"]
        for k in want:
            np.testing.assert_array_equal(got[k].cpu().numpy(),
                                          want[k].cpu().numpy(), err_msg=k)


@pytest.mark.cuda
def test_viterbi_search_refuses_shapes(card):
    """The search entry's C function refuses payload sizes outside 17 to
    16 + CRC_LEN, a repetition count past the tables' rows and a
    misaligned output with cudaErrorInvalidValue and launches nothing; the
    wrapper refuses the sizes before it."""
    import ctypes
    llr, _, _, sc, n_loc = _tail_inputs("25prb_4port", card, 2)
    ds = tuple(sc)
    tab, tab_off, nrep = pdcch_tail.derm_tables_t(ds)
    reps = pdcch_tail.derm_tables(ds)[2]
    from ltesniffer_tpu_torch.kernels.cplx import const
    tab_t = const(tab, card)
    loc_t = const(pdcch_tail.loc_table(sc.locs)[0], card)
    crc_t = const(pdcch_tail.crc_words(), card)
    comp = torch.zeros((len(ds), 2 * n_loc, 3), dtype=torch.int32,
                       device=card)
    lib = viterbi._search_library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(d, nrep_, out_ptr):
        ints = ctypes.c_int * len(d)
        return lib.viterbi_search_launch(
            llr.data_ptr(), loc_t.data_ptr(), tab_t.data_ptr(),
            crc_t.data_ptr(), out_ptr, None, tab_off.ctypes.data,
            nrep_.ctypes.data, ints(*d), len(d), 2, n_loc,
            int(llr.shape[1]), reps, stream)
    assert launch(ds, nrep, comp.data_ptr()) == 0
    torch.cuda.synchronize()
    before = comp.clone()
    comp.zero_()
    for d, nr, ptr in ((ds[:-1] + (16,), nrep, comp.data_ptr()),
                       (ds[:-1] + (17 + pdcch_tail.CRC_LEN,), nrep,
                        comp.data_ptr()),
                       (ds, nrep + reps, comp.data_ptr()),
                       (ds, nrep, comp.data_ptr() + 2)):
        assert launch(d, nr, ptr) == 1
    torch.cuda.synchronize()
    assert not comp.any() and before.any()
    n0 = viterbi.LAUNCHES["viterbi_search"]
    for D in (16, 17 + pdcch_tail.CRC_LEN):
        with pytest.raises(ValueError, match="payload size"):
            viterbi.viterbi_search_cuda(
                llr, pdcch_tail.SizeConsts({D: {}}, sc.locs), n_loc, 2)
    assert viterbi.LAUNCHES["viterbi_search"] == n0


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_fused_decode_on_second_card(two_cards):
    """A K=6144 decode (more than 48 KiB of shared memory per CTA) on
    cuda:1 while cuda:0 is current, after one on cuda:0: the wrapper
    launches on the tensor's card and the kernel's shared-memory limit is
    set there too; the bits equal the plain version's."""
    first, second = two_cards
    rng = np.random.default_rng(6144)
    K, B = 6144, 3
    _, llr, _ = _coded(K, B, rng)
    want, _ = turbo.make_decoder(K, 2)(torch.from_numpy(llr))
    with torch.cuda.device(first):
        for dev in (first, second):
            bits, _ = turbo.make_decoder(K, 2)(torch.from_numpy(llr).to(dev))
            torch.cuda.synchronize(dev)
            assert bits.device == dev
            np.testing.assert_array_equal(bits.cpu().numpy(), want.numpy())
        assert torch.cuda.current_device() == first.index


@pytest.mark.cuda
def test_bcjr_pass_on_second_card(two_cards):
    """One pass of the per-pass kernel on cuda:1 while cuda:0 is current
    equals the plain twin."""
    first, second = two_cards
    g = torch.Generator().manual_seed(2)
    L = 1024
    ins = [(torch.randn((16, L), generator=g) * 3.0).to(second)
           for _ in range(3)]
    ins += [torch.randn((8, L), generator=g).to(second) for _ in range(2)]
    with torch.cuda.device(first):
        got = bcjr.bcjr(*ins)
        torch.cuda.synchronize(second)
    for a, b in zip(got, bcjr.bcjr_plain(*ins)):
        assert a.device == second
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_viterbi_on_second_card(two_cards):
    """The Viterbi kernel on cuda:1 while cuda:0 is current equals the
    plain version there, after a launch on cuda:0 (the dynamic shared-
    memory attribute the search's sizes need is set per device)."""
    first, second = two_cards
    viterbi.viterbi_decode_tb_multi(_viterbi_groups("search", first))
    groups = _viterbi_groups("search", second)
    want = viterbi.viterbi_decode_tb_multi_plain(groups)
    with torch.cuda.device(first):
        got = viterbi.viterbi_decode_tb_multi(groups)
        torch.cuda.synchronize(second)
        assert torch.cuda.current_device() == first.index
    for a, b in zip(got, want):
        assert a.device == second
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.cuda
def test_mimo_eq_on_second_card(two_cards):
    """The eq/demap kernel on cuda:1 while cuda:0 is current: its output
    lies on cuda:1 and is within the tolerance of the plain chain there."""
    first, second = two_cards
    variant = mimo_grants.VARIANTS[8]          # TM3, 4 ports: the cycle
    tm, ports, pmi, qm0, qm1, _, _ = variant
    inp = mimo_grants.random_grant(variant, seed=6, n_sc=1200)
    ts = mimo_grants.tensors(inp, second)
    want = mimo_eq.eq_demap_mimo_plain(*ts, *inp[4], tm, pmi, qm0, qm1)
    with torch.cuda.device(first):
        got = mimo_eq.eq_demap_mimo(*ts, *inp[4], tm, pmi, qm0, qm1)
        torch.cuda.synchronize(second)
        assert torch.cuda.current_device() == first.index
    assert got.device == second
    err, ok = mimo_grants.max_err(got, want)
    assert ok, f"largest error {err}"


@pytest.mark.cuda
def test_pdcch_tail_on_second_card(two_cards):
    """The two-launch tail (the Viterbi's search entry, whose shared-memory
    attribute is set per device, and pdcch_pack) on cuda:1 while cuda:0 is
    current, after a call on cuda:0: outputs on cuda:1, every one equal to
    the plain versions there on exact-sum LLRs; so is the three-launch
    route's."""
    first, second = two_cards
    B = 8
    a0 = _tail_inputs("25prb_4port", first, B, True)
    pdcch_tail.decode_tail(*a0[:2], a0[3], a0[4], B, a0[2])
    llr, cce, scal, sc, n_loc = _tail_inputs("25prb_4port", second, B, True)
    want = pdcch_tail.decode_tail_plain(llr, cce, sc, n_loc, B, scal)
    n0 = viterbi.LAUNCHES["viterbi_search"]
    with torch.cuda.device(first):
        got = pdcch_tail.decode_tail(llr, cce, sc, n_loc, B, scal)
        three = pdcch_tail.decode_tail_three(llr, cce, sc, n_loc, B, scal)
        torch.cuda.synchronize(second)
        assert torch.cuda.current_device() == first.index
    assert viterbi.LAUNCHES["viterbi_search"] == n0 + 1
    for out in (got, three):
        assert list(out) == list(want)
        for k in want:
            assert out[k].device == second
            g = out[k].cpu().numpy()
            w = want[k].cpu().numpy()
            if k == "cand_pay":
                g, w = g.view(np.uint32), w.astype(np.uint32)
            np.testing.assert_array_equal(g, w, err_msg=k)


# --- tb_finish: the transport-block finish of the batched PDSCH path --------
def _tb_finish_both(card, fused, table):
    """(kernel output on the card, plain version's on the host), each as
    `tb_rows.defined`."""
    from ltesniffer_tpu_torch.kernels import tb_finish
    from ltesniffer_tpu_torch.testing import tb_rows
    _h, desc = tb_finish.upload(table, "cpu")
    want = tb_finish.finish(fused, table, desc)
    n0 = tb_finish.LAUNCHES["tb_finish"]
    host, desc = tb_finish.upload(table, card)
    got = tb_finish.finish(fused.to(card), table, desc)
    torch.cuda.synchronize()
    assert host.is_pinned()
    assert tb_finish.LAUNCHES["tb_finish"] == n0 + 1
    return tb_rows.defined(got, table), tb_rows.defined(want, table)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["etm31", "loaded", "odd"])
def test_tb_finish_kernel_equals_plain(card, name):
    """The kernel against its plain version, byte for byte (status words
    and payloads), at one batch of the E-TM 3.1 and the loaded cell with
    planted faults, and at the odd segmentations (fillers, mixed K, 13
    and 16 code blocks, a block with tbs 0 in the table)."""
    from ltesniffer_tpu_torch.testing import tb_rows
    rng = np.random.default_rng(len(name))
    if name == "odd":
        specs = [(tbs, *tb_rows.blocks(tbs, rng, fault))
                 for tbs, fault in ((8, None), (528, "cb"), (6128, None),
                                    (12224, "tb"), (75376, None),
                                    (97896, None), (97896, "cb"))]
        fused, table = tb_rows.lay_out(specs, rng)
        table.tb[1][0] = 0
    else:
        specs, fused, table = tb_rows.shape(name, rng)
    got, want = _tb_finish_both(card, fused, table)
    assert got == want
    ok = [st & 1 for st in want[0]]
    assert 0 < sum(ok) < table.n_tb


@pytest.mark.cuda
def test_tb_finish_launches_once_per_dispatch(card):
    """On the card the batched path's primary dispatch, its escalation
    and a table retry's dispatch each launch tb_finish once, and each
    output equals the plain version's over the same rows."""
    from ltesniffer_tpu_torch.kernels import tb_finish
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import tb_rows
    grids, h, nv, jobs, sent = tb_rows.etm31_grants(
        2, 0.12, np.random.default_rng(31))
    grids, h, nv = grids.to(card), h.to(card), nv.to(card)
    n0 = tb_finish.LAUNCHES["tb_finish"]
    pb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL, jobs,
                                        soft_buffers={}, n_iter=2)
    assert tb_finish.LAUNCHES["tb_finish"] == n0 + 1
    _h, desc = tb_finish.upload(pb.tb.table, "cpu")
    want = tb_finish.finish(pb.fused_dev.cpu(), pb.tb.table, desc)
    assert tb_rows.defined(pb.tb.out, pb.tb.table) \
        == tb_rows.defined(want, pb.tb.table)
    res = pdsch_rx.finish_grants_batch(pb)
    assert all(r.payload == s for r, s in zip(res, sent) if r.crc_ok)
    failed = [i for i, r in enumerate(res) if not r.crc_ok]
    assert failed
    h_esc = pdsch_rx.escalate_dispatch(pb, failed, 12)
    assert tb_finish.LAUNCHES["tb_finish"] == n0 + 2
    pdsch_rx.escalate_finish(pb, h_esc)
    assert all(r.payload == s for r, s in zip(pb.results, sent) if r.crc_ok)
    rpb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL,
                                         jobs[:4], n_iter=8)
    assert tb_finish.LAUNCHES["tb_finish"] == n0 + 3
    pdsch_rx.finish_grants_batch(rpb, site="retry_join")


@pytest.mark.cuda
def test_tb_finish_upload_does_not_synchronize(card):
    """The descriptor upload (a pinned buffer, non_blocking) and the
    launch make no synchronizing call once the CRC table is on the card."""
    import os
    import warnings
    from ltesniffer_tpu_torch.kernels import tb_finish
    from ltesniffer_tpu_torch.testing import tb_rows
    _specs, fused, table = tb_rows.shape("etm31", np.random.default_rng(2))
    fused = fused.to(card)
    tb_finish.finish(fused, table, tb_finish.upload(table, card)[1])
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            host, desc = tb_finish.upload(table, card)
            tb_finish.finish(fused, table, desc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert host.is_pinned()
    # torch's own frame switching the mode back is not the port's call
    port = os.path.dirname(tb_finish.__file__).rsplit(os.sep, 1)[0]
    syncs = [(w.filename, w.lineno) for w in caught
             if "synchroniz" in str(w.message)]
    assert not [f for f in syncs if f[0].startswith(port)], syncs


# --- pdsch_eq: the batched single-layer PDSCH eq/demap ----------------------
@pytest.mark.cuda
@pytest.mark.parametrize("variant", eq_grants.VARIANTS,
                         ids=[eq_grants.variant_id(v)
                              for v in eq_grants.VARIANTS])
def test_pdsch_eq_kernel_matches_plain(card, variant):
    """The kernel against its plain version on the same card tensors and
    on the host, within eq_grants' tolerance (expected: equal floats), in
    one launch: PRB-list and table grants of qm 2/4/6/8, 1/2/4 ports, 1
    and 2 RX, centre PRBs at subframes 0 and 5, two slot masks, p_a != 1,
    and one batch of the loaded and the E-TM 3.1 cells."""
    from ltesniffer_tpu_torch.kernels import pdsch_eq
    name, rx, ports = variant
    cell, grids, h, nv, jobs, re_of = eq_grants.batch(name, rx, ports, 5)
    table, re_tab = eq_grants.table(cell, h, jobs, card)
    ts = [x.to(card) for x in (grids, h, nv)]
    n0 = pdsch_eq.LAUNCHES["pdsch_eq_demap"]
    got, host = pdsch_eq.eq_demap(*ts, table, re_tab, cell)
    torch.cuda.synchronize()
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == n0 + 1
    assert host.is_pinned()
    _h, desc = pdsch_eq.upload(table, card)
    for where, want in (
            ("card", pdsch_eq.eq_demap_plain(*ts, desc, re_tab, cell,
                                             table.n_grants, table.wm)),
            ("host", pdsch_eq.eq_demap(
                grids, h, nv, table,
                None if re_tab is None else re_tab.cpu(), cell)[0])):
        err, rel, n_diff, ok = eq_grants.max_err(got, want)
        print(f"\n{eq_grants.variant_id(variant)} vs plain on the {where}: "
              f"max abs {err:.3g}, max rel {rel:.3g}, {n_diff} of "
              f"{got.numel()} floats differ")
        assert ok, (where, err, rel, n_diff)


@pytest.mark.cuda
def test_pdsch_eq_launches_once_per_dispatch(card):
    """On the card the primary dispatch, a table retry's dispatch and the
    single-grant path each launch the eq/demap kernel once; the
    escalation launches none; no plain chain runs on the card."""
    from ltesniffer_tpu_torch.kernels import pdsch_eq
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import tb_rows
    grids, h, nv, jobs, sent = tb_rows.etm31_grants(
        2, 0.12, np.random.default_rng(31))
    grids, h, nv = grids.to(card), h.to(card), nv.to(card)
    n0 = pdsch_eq.LAUNCHES["pdsch_eq_demap"]
    p0 = pdsch_eq.PLAIN_CUDA["pdsch_eq_demap"]
    pb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL, jobs,
                                        soft_buffers={}, n_iter=2)
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == n0 + 1
    res = pdsch_rx.finish_grants_batch(pb)
    assert all(r.payload == s for r, s in zip(res, sent) if r.crc_ok)
    failed = [i for i, r in enumerate(res) if not r.crc_ok]
    if failed:
        pdsch_rx.escalate_finish(pb, pdsch_rx.escalate_dispatch(pb, failed,
                                                                12))
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == n0 + 1
    rpb = pdsch_rx.dispatch_grants_batch(grids, h, nv, tb_rows.ETM_CELL,
                                         jobs[:4], n_iter=8)
    pdsch_rx.finish_grants_batch(rpb, site="retry_join")
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == n0 + 2
    j = jobs[0]
    r = pdsch_rx.decode_grant(grids, h, nv, j.b, tb_rows.ETM_CELL, j.sf_idx,
                              j.cfi, j.rnti, j.prb_mask, j.qm, j.tbs)
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] == n0 + 3
    if res[0].crc_ok:                 # 8 iterations where the batch ran 2
        assert r.crc_ok and r.payload == sent[0]
    assert pdsch_eq.PLAIN_CUDA["pdsch_eq_demap"] == p0


@pytest.mark.cuda
def test_pdsch_eq_upload_does_not_synchronize(card):
    """The descriptor upload (a pinned buffer, non_blocking) and the
    launch make no synchronizing call once the Gold table and the RE
    table are on the card."""
    import os
    import warnings
    from ltesniffer_tpu_torch.kernels import pdsch_eq
    cell, grids, h, nv, jobs, re_of = eq_grants.batch("loaded", 1, 2)
    table, re_tab = eq_grants.table(cell, h, jobs, card)
    ts = [x.to(card) for x in (grids, h, nv)]
    pdsch_eq.eq_demap(*ts, table, re_tab, cell)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out, host = pdsch_eq.eq_demap(*ts, table, re_tab, cell)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert host.is_pinned()
    port = os.path.dirname(pdsch_eq.__file__).rsplit(os.sep, 1)[0]
    syncs = [(w.filename, w.lineno) for w in caught
             if "synchroniz" in str(w.message)]
    assert not [f for f in syncs if f[0].startswith(port)], syncs


# --- cb_derm and the turbo kernel's packing entry ---------------------------
# The plain de-rate-match on the card sums a code block's laps with
# torch's CUDA reduction, whose order over the lap axis is not the
# kernel's (ascending, as the host sums them), so a float may move by the
# rounding of a reordered sum: at most (laps - 1) ulps of the sum of the
# laps' magnitudes.  With at most 10 laps of LLRs below 50 (the batches'
# are N(0, 3) plus priors) that is 9 * 2^-23 * 500 < 6e-4.  The kernel
# must equal the plain version on the host float for float.
DERM_ATOL = 6e-4


def _derm_on(device, name, seed):
    """(table, rows_mat, bufs, out) of a derm_batches batch on `device`,
    the table as the dispatch builds it there."""
    from ltesniffer_tpu_torch.testing import derm_batches
    rng = np.random.default_rng(seed)
    jobs = derm_batches.BATCHES[name]()
    rows_mat, live, n_re = derm_batches.batch(jobs, rng, device=device)
    bufs = derm_batches.stored(jobs, np.random.default_rng(seed + 1),
                               device=device)
    tab = derm_batches.table_of(rows_mat, jobs, live, n_re, dict(bufs))
    n_out = max(c[8] + 3 * (c[3] + 4) for c in tab.cb)
    return tab, rows_mat, bufs, n_out, (jobs, live, n_re)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["etm31", "loaded", "odd"])
def test_cb_derm_kernel_matches_plain(card, name):
    """The kernel against its plain version from the same descriptors:
    equal to the host's float for float, to the card's within DERM_ATOL;
    one launch a round."""
    from ltesniffer_tpu_torch.kernels import cb_derm
    tab, rows, _b, n_out, _ = _derm_on(card, name, 3)
    keep = []
    out = torch.full((n_out,), float("nan"), device=card)
    _h, desc = cb_derm.upload(tab, card, out, keep)
    n0 = cb_derm.LAUNCHES["cb_derm"]
    cb_derm.derm(rows, tab, desc, out)
    torch.cuda.synchronize()
    assert cb_derm.LAUNCHES["cb_derm"] == n0 + len(tab.rounds())
    plain = torch.full((n_out,), float("nan"), device=card)
    _h2, desc2 = cb_derm.upload(tab, card, plain, keep)
    cb_derm.derm_plain(rows, desc2, tab, plain)
    htab, hrows, _hb, _n, _ = _derm_on("cpu", name, 3)
    host = torch.full((n_out,), float("nan"))
    _h3, desc3 = cb_derm.upload(htab, "cpu", host, [])
    cb_derm.derm(hrows, htab, desc3, host)
    written = ~torch.isnan(host)
    assert torch.equal(~torch.isnan(out.cpu()), written)
    assert torch.equal(out.cpu()[written], host[written])
    diff = (out - plain).abs()[written.to(card)]
    print(f"\ncb_derm {name}: {tab.n_cb} code blocks, {len(tab.rounds())} "
          f"rounds; vs the card's plain version {int((diff > 0).sum())} "
          f"floats differ, max {float(diff.max()):.3g}")
    assert float(diff.max()) <= DERM_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("K", [40, 352, 560, 1824, 3904, 5120, 6144])
def test_pack_entry_matches_plain(card, K):
    """The turbo kernel's packing entry against the plain route (the
    decoder's bits through `_crc_pack`) on the card and on the host, at
    n_iter 2 and 12, into a buffer at an offset; one launch a call."""
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    rng = np.random.default_rng(K)
    B = 2 if K >= 3904 else 9
    sent, llr, prior = _coded(K, B, rng)
    Wk = (K + 31) // 32
    for n_iter in (2, 12):
        for d in (llr, llr + prior):
            dc = torch.from_numpy(d).to(card)
            buf = torch.full((7 + B * (1 + Wk),), -3, dtype=torch.int64,
                             device=card)
            n0 = turbo_decode.LAUNCHES["turbo_decode_pack"]
            rows = pdsch_rx._turbo_only_fn(K, n_iter)(dc, buf, 7)
            torch.cuda.synchronize()
            assert turbo_decode.LAUNCHES["turbo_decode_pack"] == n0 + 1
            bits, _ = turbo.make_decoder(K, n_iter)(dc)
            on_card = pdsch_rx._crc_pack(bits, K)
            on_host = pdsch_rx._turbo_only_fn(K, n_iter)(torch.from_numpy(d))
            assert torch.equal(rows.cpu(), on_card.cpu())
            assert torch.equal(rows.cpu(), on_host)
            assert (buf[:7] == -3).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["etm31", "loaded", "odd"])
def test_dispatch_on_card_equals_host(card, name):
    """The dispatch's code blocks on the card (one cb_derm launch a round,
    one packing launch a K, one tb_finish launch) against the same on the
    host: the fused rows bit for bit, the combined LLRs float for float,
    the soft buffers alike; no plain de-rate-match on the card."""
    from ltesniffer_tpu_torch.kernels import cb_derm, tb_finish
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import derm_batches, tb_rows
    got = {}
    for dev in (card, torch.device("cpu")):
        rng = np.random.default_rng(5)
        jobs = derm_batches.BATCHES[name]()
        rows, live, n_re = derm_batches.batch(jobs, rng, device=dev)
        bufs = derm_batches.stored(jobs, rng, device=dev)
        n = (cb_derm.LAUNCHES["cb_derm"],
             turbo_decode.LAUNCHES["turbo_decode_pack"],
             turbo_decode.LAUNCHES["turbo_decode"],
             tb_finish.LAUNCHES["tb_finish"], cb_derm.PLAIN_CUDA["cb_derm"])
        pb = pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re, bufs, 2)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            rounds = len(pb.derm[0].rounds())
            n_k = len(pb.group_rows)
            assert (cb_derm.LAUNCHES["cb_derm"] - n[0],
                    turbo_decode.LAUNCHES["turbo_decode_pack"] - n[1],
                    turbo_decode.LAUNCHES["turbo_decode"] - n[2],
                    tb_finish.LAUNCHES["tb_finish"] - n[3],
                    cb_derm.PLAIN_CUDA["cb_derm"] - n[4]) == \
                (rounds, n_k, n_k, 1, 0)
        got[dev.type] = (pb.fused_dev.cpu(),
                         {k: v.get().cpu() for k, v in pb.d_of.items()},
                         {k: torch.as_tensor(pdsch_rx._buffer_value(v)).cpu()
                          for k, v in bufs.items()},
                         tb_rows.defined(pb.tb.out, pb.tb.table))
    (fc, dc, bc, tc), (fh, dh, bh, th) = got["cuda"], got["cpu"]
    assert torch.equal(fc, fh)
    assert dc.keys() == dh.keys() and bc.keys() == bh.keys()
    assert all(torch.equal(dc[k], dh[k]) for k in dh)
    assert all(torch.equal(bc[k], bh[k]) for k in bh)
    assert tc == th


@pytest.mark.cuda
def test_dispatch_code_blocks_do_not_synchronize(card):
    """Once the maps are on the card, the dispatch's descriptor upload
    and its launches make no synchronizing call, priors and all."""
    import os
    import warnings
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    from ltesniffer_tpu_torch.testing import derm_batches
    rng = np.random.default_rng(2)
    jobs = derm_batches.odd_jobs()
    rows, live, n_re = derm_batches.batch(jobs, rng, device=card)
    bufs = derm_batches.stored(jobs, rng, device=card)
    pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re, dict(bufs), 2)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pb = pdsch_rx._dispatch_code_blocks(rows, jobs, live, n_re,
                                                dict(bufs), 2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert pb.derm[1].is_pinned()
    port = os.path.dirname(pdsch_rx.__file__).rsplit(os.sep, 1)[0]
    syncs = [(w.filename, w.lineno) for w in caught
             if "synchroniz" in str(w.message)]
    assert not [f for f in syncs if f[0].startswith(port)], syncs
