"""Tests of the port that need a CUDA card (marker `cuda`); they skip
without one.  This file imports neither JAX nor the reference package, so
it also runs on the card's machine, which has no JAX (tests/conftest.py
imports JAX, hence --noconftest there):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode

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
