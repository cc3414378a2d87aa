"""The frozen copies equal the port's originals: the kernels' operations
and bytes at the shapes PERF.md's kernel tables list, and the
transmitter's building blocks on seeded inputs."""
import numpy as np
import pytest

from sniffbench import work
from sniffbench.gen import mix, tx
from sniffbench.gen.lte import turbo as turbo_copy


@pytest.mark.parametrize("K,B,n_iter", [(1824, 722, 2), (1824, 722, 12),
                                        (1824, 1, 8), (832, 2048, 2)])
def test_turbo_arithmetic_equals_the_port(K, B, n_iter):
    from ltesniffer_tpu_torch.kernels import turbo_decode
    assert work.turbo_ops(K, B, n_iter) == turbo_decode.ops(K, B, n_iter)
    assert work.turbo_bytes(K, B) == turbo_decode.bytes_moved(K, B)


@pytest.mark.parametrize("shapes", [
    [(10048, d) for d in (31, 44, 46, 55, 64, 67)],      # a search call
    [(12 * 40, 40)]])                                     # the MIB's call
def test_viterbi_arithmetic_equals_the_port(shapes):
    from ltesniffer_tpu_torch.kernels import viterbi
    assert work.viterbi_ops(shapes, 32) == viterbi.ops(shapes, 32)


def test_search_space_of_the_configs():
    s = work.search_space_of(mix.load(
        f"{work.__path__[0]}/../configs/dl20_siso.json"))
    assert s["n_loc"] == 93 and s["ds"] == [31, 44, 46, 55, 64, 67]


@pytest.mark.parametrize("tbs", [328, 1544, 6200, 30576])
def test_turbo_encoder_copy_equals_the_port(tbs):
    from ltesniffer_tpu_torch.phy import turbo as turbo_port
    tb = np.random.default_rng(tbs).integers(0, 2, tbs).astype(np.uint8)
    _, blocks = turbo_copy.segment(tb)
    _, blocks2 = turbo_port.segment(tb)
    for b, b2 in zip(blocks, blocks2):
        d, d2 = turbo_copy.turbo_encode(b), turbo_port.turbo_encode(b2)
        assert (d == d2).all()
        for E in (500, 3 * len(b) + 7):
            for rv in range(4):
                assert (turbo_copy.rate_match_turbo(d, E, rv)
                        == turbo_port.rate_match_turbo(d2, E, rv)).all()
    assert [k for k in work.code_blocks(tbs)] == \
        list(turbo_port.segment_sizes(tbs).K)


def test_control_subframe_ofdm_and_packing_equal_the_port():
    from ltesniffer_tpu_torch.kernels import cplx
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.testing import encoder
    cfg = mix.load(f"{work.__path__[0]}/../configs/dl20_siso.json")
    cell = mix.cell_of(cfg)
    plans = mix.schedule(cfg, mix.load(
        f"{work.__path__[0]}/../traffic/loaded.json"))
    port_cell = CellConfig(n_id_cell=cell.n_id_cell, n_prb=cell.n_prb,
                           nof_ports=cell.nof_ports,
                           nof_rx_ant=cell.nof_rx_ant)
    txs = [tx.TxDci(dci=mix._dci_of(cell, g), L=g.L, ncce=g.ncce)
           for g in plans[5]]
    ports = [encoder.TxDci(dci=t.dci, L=t.L, ncce=t.ncce) for t in txs]
    g = tx.build_control_subframe(cell, 5, 2, txs)
    g2 = encoder.build_control_subframe(port_cell, 5, 2, ports)
    assert np.array_equal(g, g2)
    iq = tx.subframe_iq(cell, g[:1])
    assert np.array_equal(iq, encoder.subframe_iq(port_cell, g2[:1]))
    w, s = tx.to_i8_packed(iq[None])
    w2, s2 = cplx.to_i8_packed(iq[None])
    assert np.array_equal(w, w2) and np.array_equal(s, s2)
