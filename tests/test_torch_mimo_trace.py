"""The port's tracer on the two-codeword route (`pdsch_rx.decode_grant_mimo`):
its child spans under `p3_mimo` and its counters `pdsch_mimo_grant` (one
event a decode) and `pdsch_mimo_cb` (one event a turbo launch, its code
blocks the total), over the 2x2 MIMO cell (`testing/mimo_cell.py`) run
through `run_packed` on the CPU; a 1-RX cell records none of them.  The
tracing leaves the decode as it was: the run's pcap and summary are the
recorded ones, which `tests/test_torch_mimo.py::test_2rx_cell_pcaps_equal`
holds equal to the JAX package's on the same input.  This file imports
neither JAX nor the reference package."""
import hashlib
import os

import pytest
import torch

from ltesniffer_tpu_torch.phy import turbo as turbo_mod
from ltesniffer_tpu_torch.sniffer import core, pdsch_rx, prof
from ltesniffer_tpu_torch.testing import loaded_cell, mimo_cell

torch.set_num_threads(1)

N_SF = 6
# mimo_cell.build_packed(6) through the port's core at batch 4 on the CPU
PCAP_SHA256 = ("c4eb128ab5360711a9bdbd0f44e0033923a1c0a6e1a95816b5f9147eaf261"
               "d4b")
SUMMARY = {"subframes": 6, "dcis": 105, "pdsch_ok": 105, "harq_skipped": 0,
           "sf_skipped": 0, "active_rntis": 18, "sync_losses": 0,
           "resyncs": 0}
PM_SPANS = ("pm_eqdemap", "pm_derm", "pm_turbo", "pm_finish")


def _run(cell, words, scales, path, monkeypatch=None):
    """One core over packed IQ, the tracer reset first; -> (core, spans,
    counters, [(code blocks, distinct K) of each decode_grant_mimo call])."""
    calls = []
    if monkeypatch is not None:
        orig = pdsch_rx.decode_grant_mimo

        def spy(*a, **kw):
            seg = [turbo_mod.segment_sizes(t) for t in kw["tbss"] if t > 0]
            calls.append((sum(s.C for s in seg),
                          len({k for s in seg for k in s.K})))
            return orig(*a, **kw)
        monkeypatch.setattr(pdsch_rx, "decode_grant_mimo", spy)
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=cell, batch_size=4, pcap_path=path, device="cpu"))
    prof.reset()
    try:
        c.run_packed(words, scales)
        c.close()
        return c, prof.report(), prof.counters(), calls
    finally:
        prof.reset()


@pytest.fixture(scope="module")
def mimo(tmp_path_factory):
    words, scales, _truth = mimo_cell.build_packed(N_SF)
    path = str(tmp_path_factory.mktemp("mimo_trace") / "mimo.pcap")
    with pytest.MonkeyPatch.context() as mp:
        c, spans, cnt, calls = _run(mimo_cell.CELL, words, scales, path, mp)
    return dict(core=c, spans=spans, counters=cnt, calls=calls,
                pcap=open(path, "rb").read())


def test_one_grant_event_a_decode(mimo):
    calls, cnt = mimo["calls"], mimo["counters"]
    assert len(calls) > 0
    assert cnt["pdsch_mimo_grant"] == {"total": len(calls),
                                       "events": len(calls)}
    assert mimo["spans"]["p3_mimo"]["n"] == len(calls)


def test_code_blocks_and_launches_counted(mimo):
    calls, cnt = mimo["calls"], mimo["counters"]
    assert cnt["pdsch_mimo_cb"] == {"total": sum(c for c, _k in calls),
                                    "events": sum(k for _c, k in calls)}
    # at MCS (13, 11) the codewords' K differ: some decode makes 2 launches
    assert max(k for _c, k in calls) == 2


def test_route_reads_one_llr_buffer_and_one_bits_read_a_launch(mimo):
    calls, cnt = mimo["calls"], mimo["counters"]
    assert cnt["host_read.mimo_llr"]["events"] == len(calls)
    assert cnt["host_read.mimo_bits"]["events"] == sum(k for _c, k in calls)
    reads = (cnt["host_read.mimo_llr"]["events"]
             + cnt["host_read.mimo_bits"]["events"])
    assert reads == sum(1 + k for _c, k in calls)


@pytest.mark.parametrize("name", PM_SPANS)
def test_route_spans_nest_under_p3_mimo(mimo, name):
    n = len(mimo["calls"])
    s = mimo["spans"][name]
    assert s["n"] == n and s["parents"] == {"p3_mimo": n}
    assert 0 <= s["self"] <= s["s"]


def test_route_spans_fit_inside_p3_mimo(mimo):
    sp = mimo["spans"]
    assert sum(sp[k]["s"] for k in PM_SPANS) <= sp["p3_mimo"]["s"] + 1e-3


def test_tracing_leaves_the_decode_as_it_was(mimo):
    c = mimo["core"]
    assert hashlib.sha256(mimo["pcap"]).hexdigest() == PCAP_SHA256
    assert {k: v for k, v in c.summary().items()
            if k != "search_stats"} == SUMMARY
    assert {r.dci.fmt for r in c.results if r.crc_ok} == {"1A", "2", "2A"}


def test_a_1rx_cell_records_none_of_the_route(tmp_path, monkeypatch):
    """The loaded cell's format-2A DCIs stop at the 1-RX gate (wrong
    MIMO): no decode, no `pm_*` span, no `pdsch_mimo_*` counter."""
    words, scales = loaded_cell.build_packed(4)[:2]
    c, spans, cnt, calls = _run(loaded_cell.CELL, words, scales,
                                str(tmp_path / "loaded.pcap"), monkeypatch)
    assert sum(st.wrong_mimo for st in c.mcs.stats_dl.values()) > 0
    assert calls == []
    assert not {k for k in cnt if k.startswith("pdsch_mimo")
                or k.startswith("host_read.mimo")}
    assert not {k for k in spans if k.startswith("pm_") or k == "p3_mimo"}
    assert cnt["pdsch_grant"]["total"] > 0        # the batched route ran
