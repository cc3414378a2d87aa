"""The `dl20_mimo.tm34` cell on the CPU: its control is not correct, a
traced run reads the two-codeword route's metrics as numbers, and their
readers give nothing to read where the program's tracer lacks the route's
counters (a program before them)."""
import contextlib
import sys
import time
import types

import pytest
import torch

from sniffbench import control
from sniffbench.harness import drive

CELL = "dl20_mimo.tm34"
SEED = 2 ** 31 + 5
BLOCK = 20
METRICS = ("mimo_grant_ms_per_ksf", "mimo_cb_per_launch",
           "mimo_reads_per_grant")
PROF = "ltesniffer_tpu_torch.sniffer.prof"


def run(trace=False, program=None, seconds=0.0):
    torch.set_num_threads(4)
    return drive.run(CELL, SEED, seconds, trace, device="cpu",
                     block_sf=BLOCK, workers=4, program=program)


def test_control_is_not_correct():
    r = run(program=control.plant_of(CELL))
    assert not r["correct"]
    assert r["checked"]["wrong_pct"]["value"] > \
        r["checked"]["wrong_pct"]["limit"]


def test_traced_run_reads_the_route_metrics(monkeypatch):
    """A window of the two calls the harness profiles and one call the
    spans cover: the harness's clock jumps past the window's end as that
    call returns, so the window's length does not depend on this machine's
    speed.  The two calls run without the profiler: on the CPU it records
    every torch op of the 2-RX route (tens of GB), and the CPU has no
    device time for it to give."""
    jump = [0.0]
    clock = types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + jump[0])
    monkeypatch.setattr(drive, "time", clock)

    @contextlib.contextmanager
    def unprofiled(self, how):
        yield
        self.events[how] = []
    monkeypatch.setattr(drive._Tracer, "profiled", unprofiled)

    def program(core):
        orig, n = core.run_packed, [0]

        def counted(*a, **k):
            out = orig(*a, **k)
            n[0] += 1
            if n[0] == 4:            # the warm block, 2 profiled, 1 spanned
                jump[0] = 1e9
            return out
        core.run_packed = counted
    r = run(trace=True, program=program, seconds=1e6)
    assert r["correct"], r["checked"]
    assert r["detail"]["calls"] == 3
    m = r["metrics"]
    for k in METRICS:
        assert isinstance(m[k]["value"], float) and m[k]["value"] > 0, k
    assert m["mimo_grant_ms_per_ksf"]["unit"] == "ms/ksf"
    assert 1.0 <= m["mimo_cb_per_launch"]["value"] <= 2.0
    # one read of the LLRs and one of the bits a launch (1 or 2 a decode)
    assert 2.0 <= m["mimo_reads_per_grant"]["value"] <= 3.0
    assert "resolve_ms_per_ksf" in m and "pdsch_dispatch_ms_per_ksf" in m


@pytest.mark.parametrize("name", METRICS)
def test_reader_of_an_empty_record_is_none(name):
    assert drive.reader(name)({"config": {}, "n_iter": 2}) is None


@pytest.mark.parametrize("name", METRICS[1:])
def test_reader_without_the_route_counters_is_none(name, monkeypatch):
    """The tracer of a program without the route's counters: the batched
    route's counters and host reads, none of `pdsch_mimo_*`."""
    old = types.ModuleType("prof")
    old.counters = lambda: {"host_read.mimo_llr": {"total": 4, "events": 4},
                            "host_read.mimo_bits": {"total": 6, "events": 6},
                            "turbo_cb": {"total": 96, "events": 2}}
    monkeypatch.setitem(sys.modules, PROF, old)
    rec = {"config": {}, "n_iter": 2, "span_sf": 640, "spans": {}}
    assert drive.reader(name)(rec) is None


def test_span_reader_without_the_span_is_none():
    rec = {"config": {}, "n_iter": 2, "span_sf": 640,
           "spans": {"p3_handlers": 1.5}}
    assert drive.reader("mimo_grant_ms_per_ksf")(rec) is None


def test_readers_on_a_filled_tracer():
    from ltesniffer_tpu_torch.sniffer import prof
    prof.reset()
    try:
        for _ in range(4):
            prof.count("pdsch_mimo_grant")
            prof.count("host_read.mimo_llr")
        for cbs in (2, 1, 1, 2, 1, 1):       # 2 decodes of 2 launches
            prof.count("pdsch_mimo_cb", cbs)
            prof.count("host_read.mimo_bits")
        prof.count("host_read.grant_bits")   # another route's read
        rec = {"config": {}, "n_iter": 2, "span_sf": 640,
               "spans": {"p3_mimo": 3.2}}
        read = {k: drive.reader(k)(rec) for k in METRICS}
        assert read["mimo_cb_per_launch"] == pytest.approx(8 / 6)
        assert read["mimo_reads_per_grant"] == pytest.approx(10 / 4)
        assert read["mimo_grant_ms_per_ksf"] == pytest.approx(5000.0)
    finally:
        prof.reset()
