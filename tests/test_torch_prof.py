"""The port's tracer (`ltesniffer_tpu_torch/sniffer/prof.py`): spans with
parents and self time, the batch ring, counters, the host-read sites, the
factories' builds, the profiler ranges, a core's batches, and the
benchmark's readers of them.  This file imports neither JAX nor the
reference package, so its `cuda`-marked test also runs on the card's
machine:

    python -m pytest --noconftest -q -m cuda tests/test_torch_prof.py -s
"""
import ast
import collections
import os
import sys
import time
import types
import warnings

import numpy as np
import pytest
import torch

from ltesniffer_tpu_torch.sniffer import prof

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def clean():
    prof.reset()
    yield
    prof.reset()


def test_nested_spans_record_parents_and_self_time():
    with prof.span("outer"):
        time.sleep(0.02)
        for _ in range(2):
            with prof.span("inner"):
                time.sleep(0.01)
                with prof.span("leaf"):
                    pass
    with prof.span("inner"):
        pass
    r = prof.report()
    assert r["outer"]["parents"] == {None: 1}
    assert r["inner"]["parents"] == {"outer": 2, None: 1}
    assert r["leaf"]["parents"] == {"inner": 2}
    # outer's self time leaves out the inner spans under it
    assert 0.019 <= r["outer"]["self"] <= r["outer"]["s"] - 0.019
    assert r["inner"]["self"] <= r["inner"]["s"]
    assert list(r)[0] == "outer"          # the longest first


def test_self_time_is_duration_less_children():
    """Self time exactly: a parent's self ns plus its children's ns is
    its own ns (clock faked)."""
    ticks = iter(range(0, 10_000, 10))
    old = prof._now
    prof._now = lambda: next(ticks)
    try:
        with prof.span("a"):            # a: 0 .. 70
            with prof.span("b"):        # b: 10 .. 40
                with prof.span("c"):    # c: 20 .. 30
                    pass
            with prof.span("c"):        # c: 50 .. 60
                pass
    finally:
        prof._now = old
    s = prof._spans
    assert (s["a"].ns, s["b"].ns, s["c"].ns) == (70, 30, 20)
    assert (s["a"].self_ns, s["b"].self_ns, s["c"].self_ns) == (30, 20, 20)
    assert prof.report()["c"]["parents"] == {"b": 1, "a": 1}


def test_report_keeps_s_and_n():
    for _ in range(3):
        with prof.span("x"):
            pass
    r = prof.report()["x"]
    assert set(r) >= {"s", "n", "self"} and r["n"] == 3
    assert isinstance(r["s"], float) and r["s"] >= 0
    assert "x" in prof.pretty()


def test_reset_clears_spans_batches_and_counters():
    with prof.span("x"):
        prof.batch_start(0, 4)
        prof.count("c")
    prof.reset()
    assert prof.report() == {}
    assert len(prof.batches()["id"]) == 0
    assert prof.counters() == {}
    with prof.span("x"):
        pass
    assert prof.report()["x"]["n"] == 1


def test_span_open_across_reset_still_closes():
    with prof.span("outer"):
        prof.reset()
        with prof.span("inner"):
            pass
    r = prof.report()
    assert r["outer"]["n"] == 1 and r["inner"]["parents"] == {"outer": 1}
    assert prof._open == [] and prof._child == []


def test_a_span_survives_an_exception():
    with pytest.raises(ValueError):
        with prof.span("outer"):
            with prof.span("inner"):
                raise ValueError
    assert prof._open == [] and prof.report()["inner"]["n"] == 1


def test_batch_ring_is_bounded_and_keeps_the_newest():
    n = prof.RING + 10
    for k in range(n):
        prof.batch_start(32 * k, 32)
        prof.batch_dci(32 * k)
        prof.batch_out(32 * k)
    b = prof.batches()
    assert len(b["id"]) == prof.RING
    assert b["id"][0] == 32 * 10 and b["id"][-1] == 32 * (n - 1)
    assert np.all(np.diff(b["id"]) == 32) and np.all(b["n_sf"] == 32)
    assert np.all(b["t_in"] <= b["t_dci"]) and np.all(b["t_dci"] <= b["t_out"])
    assert prof._ids.nbytes == 8 * prof.RING     # fixed memory


def test_batch_marks_find_batches_in_flight():
    for bid in (0, 8, 16):
        prof.batch_start(bid, 8)
    prof.batch_dci(0)
    prof.batch_out(0)
    prof.batch_dci(8)
    prof.batch_out(99)               # not a batch: ignored
    b = prof.batches()
    assert list(b["t_dci"] > 0) == [True, True, False]
    assert list(b["t_out"] > 0) == [True, False, False]


def test_count_total_and_events():
    prof.count("turbo_cb", 64)
    prof.count("turbo_cb", 96)
    prof.count("host_read.x")
    c = prof.counters()
    assert c["turbo_cb"] == {"total": 160, "events": 2}
    assert c["host_read.x"] == {"total": 1, "events": 1}


def test_host_read_counts_one_event_per_read():
    t = torch.arange(6)
    out = prof.host_read("site", t)
    prof.host_read("site", t)
    assert torch.equal(out, t)
    assert prof.counters()["host_read.site"] == {"total": 2, "events": 2}


@prof.factory(4)
def _table(n):
    return np.arange(n)


def test_factory_miss_counts_once_and_a_hit_does_not():
    name = "build.test_torch_prof._table"
    _table.cache_clear()
    prof.reset()
    _table(3)
    _table(3)
    assert prof.counters()[name] == {"total": 1, "events": 1}
    _table(4)
    _table(3)
    assert prof.counters()[name]["events"] == 2
    prof.reset()
    _table(3)
    assert name not in prof.counters()


def test_every_port_factory_is_counted():
    """The lru-cached factories of the DL and UL paths are the tracer's."""
    from ltesniffer_tpu_torch.sniffer import (frontend, pbch_rx, pdcch_rx,
                                              pdsch_rx, pusch_rx)
    for mod in (frontend, pbch_rx, pdcch_rx, pdsch_rx, pusch_rx):
        src = open(mod.__file__).read()
        assert "lru_cache" not in src, mod.__name__
        names = [n for n in prof._factories
                 if n.startswith(f"build.{mod.__name__.rsplit('.', 1)[-1]}.")]
        assert len(names) == src.count("@prof.factory("), mod.__name__


def test_spans_appear_in_the_profiler_nested_with_the_batch_id():
    from torch.profiler import ProfilerActivity, profile
    prof.batch(96)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        with prof.span("phase3"):
            with prof.span("resolve"):
                torch.ones(2) + 1
    prof.batch(-1)
    ev = {e.name: e for e in p.events() if e.name.startswith("span:")}
    assert set(ev) == {"span:phase3", "span:resolve"}
    assert ev["span:resolve"].cpu_parent.name == "span:phase3"
    for e in ev.values():
        assert e.concrete_inputs == [96]
    a, b = ev["span:phase3"].time_range, ev["span:resolve"].time_range
    assert a.start <= b.start and b.end <= a.end
    # outside a session a span opens no range
    with prof.span("x"):
        assert prof._range[-1] is None


# --- a core on the CPU -------------------------------------------------------
@pytest.fixture(scope="module")
def loaded12():
    """The loaded cell's first 12 subframes through the port's core at
    batch 4 (3 batches, depth 3): (core, report, batches, counters)."""
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell
    words, scales, _placed, _truth = loaded_cell.build_packed(n_sf=12)
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=loaded_cell.CELL, batch_size=4, device="cpu"))
    prof.reset()
    c.run_packed(words, scales)
    out = (c, prof.report(), prof.batches(), prof.counters())
    c.close()
    return out


def test_core_batches_run_the_five_phases_in_order(loaded12):
    _c, r, b, _cnt = loaded12
    assert list(b["id"]) == [0, 4, 8] and list(b["n_sf"]) == [4, 4, 4]
    assert np.all(b["t_in"] > 0)
    assert np.all(b["t_in"] <= b["t_dci"]) and np.all(b["t_dci"] <= b["t_out"])
    for k in range(1, 6):
        assert r[f"phase{k}"]["n"] == 3 and r[f"phase{k}"]["parents"] == {
            None: 3}
    assert r["p3_join"]["parents"] == {"phase3": 3}
    assert r["resolve"]["parents"] == {"phase3": 12}


def test_core_phases_carry_the_batch_id_in_the_profiler():
    """Under torch.profiler each batch's phases and their child spans are
    ranges tagged with the batch's id, phase 1 to 5 in time order."""
    from torch.profiler import ProfilerActivity, profile
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell
    words, scales, _p, _t = loaded_cell.build_packed(n_sf=8)
    c = core.LTESnifferCore(core.SnifferConfig(
        cell=loaded_cell.CELL, batch_size=4, device="cpu",
        decode_pdsch=False))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        c.run_packed(words, scales)
    c.close()
    phases = collections.defaultdict(list)
    for e in p.events():
        if e.name.startswith("span:phase"):
            phases[e.concrete_inputs[0]].append(
                (e.time_range.start, e.name))
        elif e.name == "span:resolve":
            assert e.cpu_parent.name == "span:phase3"
            assert e.concrete_inputs == e.cpu_parent.concrete_inputs
    assert set(phases) == {0, 4}
    for bid, evs in phases.items():
        assert [n for _t0, n in sorted(evs)] == [
            f"span:phase{k}" for k in range(1, 6)], bid


def test_former_timed_sites_are_spans(loaded12):
    """p3_handlers and the PDSCH's host stretches are spans with parents
    (they were timed on their own, outside the span tree)."""
    _c, r, _b, _cnt = loaded12
    assert r["p3_handlers"]["parents"] == {"phase3": 3}
    # the primary dispatch and the 256QAM-table retry share the PDSCH code
    for name in ("pd_re_idx", "pd_collect_cb", "pd_pos_build"):
        assert set(r[name]["parents"]) == {"pdsch_dispatch",
                                           "p4_retry_dispatch"}, name
    assert set(r["pf_assemble"]["parents"]) == {"p4_results",
                                                "p5_retry_join"}
    d = r["pdsch_dispatch"]
    assert d["self"] < d["s"]


def test_core_counts_host_reads_and_pdsch_work(loaded12):
    c, _r, _b, cnt = loaded12
    # one search chunk a batch (B <= 64): one p3_join read each; one fused
    # PDSCH read per batch with jobs
    assert cnt["host_read.p3_join"] == {"total": 3, "events": 3}
    assert cnt["host_read.pf_d2h"]["events"] == 3
    assert cnt["pdsch_grant"]["events"] == 3
    assert cnt["pdsch_cb"]["total"] >= cnt["pdsch_grant"]["total"] > 0
    # the loaded cell's 256QAM-table UEs fail on the 64QAM table at first
    # sight: their grants are retried, and each retry join is one read
    assert cnt["pdsch_grant_retried"]["total"] > 0
    assert (cnt["host_read.retry_join"]["events"]
            == cnt["pdsch_grant_retried"]["events"])
    assert any(k.startswith("build.") for k in cnt)


def test_escalation_counts_code_blocks():
    from ltesniffer_tpu_torch.phy import turbo as turbo_mod
    from ltesniffer_tpu_torch.sniffer import pdsch_rx
    segs = {0: turbo_mod.segment_sizes(6200), 1: turbo_mod.segment_sizes(16)}
    assert segs[0].K == [3136, 3136] and segs[1].K == [40]
    jobs = [pdsch_rx.GrantJob(b=0, sf_idx=1, cfi=2, rnti=0x100 + ji,
                              prb_mask=np.ones(4, bool), qm=2, tbs=tbs)
            for ji, tbs in ((0, 6200), (1, 16))]
    da, db = torch.zeros((2, 3, 3140)), torch.zeros((1, 3, 44))
    pb = pdsch_rx.PendingPdschBatch(
        jobs=jobs, results=[None, None], seg_of=segs, group_rows=[],
        fused_dev=da,
        d_of={(0, 0): pdsch_rx.LazyRow(da, 0), (0, 1): pdsch_rx.LazyRow(da, 1),
              (1, 0): pdsch_rx.LazyRow(db, 0)})
    h = pdsch_rx.escalate_dispatch(pb, [0, 1], 2)
    c = prof.counters()
    assert c["pdsch_cb_escalated"] == {"total": 3, "events": 1}
    assert c["pdsch_tb_device"] == {"total": 2, "events": 1}
    # one read per escalation (here two code-block sizes), by tb_finish
    pdsch_rx.escalate_finish(pb, h)
    assert prof.counters()["host_read.escalate_join"]["events"] == 1


# --- the benchmark's readers -------------------------------------------------
def _reader(name):
    import importlib
    return importlib.import_module(f"sniffbench.metrics.{name}").read


NEW_METRICS = ("batch_latency_p50_ms", "batch_latency_p95_ms",
               "host_reads_per_ksf", "turbo_cb_per_launch",
               "escalated_cb_pct", "table_retry_pct", "table_builds_per_ksf")


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_of_an_empty_record_is_none(name):
    assert _reader(name)({"config": {}, "n_iter": 2}) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_without_the_tracer_is_none(name, monkeypatch):
    """The parent program's tracer had neither batches nor counters."""
    old = types.ModuleType("prof")
    old.report = lambda: {}
    monkeypatch.setitem(sys.modules, "ltesniffer_tpu_torch.sniffer.prof",
                        old)
    assert _reader(name)({"config": {}, "n_iter": 2, "span_sf": 640,
                          "spans": {}}) is None


def test_readers_on_a_filled_tracer(monkeypatch):
    ticks = iter(range(0, 10 ** 12, 1_000_000))      # 1 ms a clock read
    monkeypatch.setattr(prof, "_now", lambda: next(ticks))
    prof.batch_start(-32, 32)        # in flight at the reset: left out
    prof.reset()
    prof.batch_dci(-32)
    prof.batch_out(-32)
    for k in range(250):             # batch k leaves 3 + k % 10 ms later
        prof.batch_start(32 * k, 32)                     # t
        for _ in range(k % 10):
            prof._now()
        prof.batch_dci(32 * k)                           # t + 1 + k%10
        prof.batch_out(32 * k)                           # t + 2 + k%10
    prof.batch_start(32 * 250, 32)   # never left: left out
    for _ in range(8000):
        prof.count("host_read.p3_join")
    for _ in range(8000):
        prof.count("host_read.pf_d2h")
    for b in (64, 96, 32):
        prof.count("turbo_cb", b)
    prof.count("pdsch_cb", 300)
    prof.count("pdsch_cb_escalated", 9)
    prof.count("pdsch_grant", 200)
    prof.count("pdsch_grant_retried", 5)
    prof.count("build.pdsch_rx._re_tab")
    rec = {"config": {}, "n_iter": 2, "span_sf": 8000, "spans": {}}
    lat = 2 + np.arange(250) % 10
    got = {n: _reader(n)(rec) for n in NEW_METRICS}
    assert got["batch_latency_p50_ms"] == pytest.approx(np.median(lat))
    assert got["batch_latency_p95_ms"] == pytest.approx(
        np.percentile(lat, 95))
    assert got["host_reads_per_ksf"] == pytest.approx(2000.0)
    assert got["turbo_cb_per_launch"] == pytest.approx(64.0)
    assert got["escalated_cb_pct"] == pytest.approx(3.0)
    assert got["table_retry_pct"] == pytest.approx(2.5)
    assert got["table_builds_per_ksf"] == pytest.approx(0.125)


def test_p95_needs_200_batches(monkeypatch):
    for k in range(199):
        prof.batch_start(k, 1)
        prof.batch_out(k)
    rec = {"config": {}, "n_iter": 2, "span_sf": 199, "spans": {}}
    assert _reader("batch_latency_p95_ms")(rec) is None
    assert _reader("batch_latency_p50_ms")(rec) is not None


def test_ratio_readers_with_nothing_escalated_read_zero():
    prof.count("pdsch_cb", 40)
    prof.count("pdsch_grant", 12)
    rec = {"config": {}, "n_iter": 2, "span_sf": 32, "spans": {}}
    assert _reader("escalated_cb_pct")(rec) == 0.0
    assert _reader("table_retry_pct")(rec) == 0.0
    assert _reader("turbo_cb_per_launch")(rec) is None


# --- on the card ------------------------------------------------------------
# synchronizing calls on the loaded cell's path that are not host reads:
# (file relative to the repo, function) -> what.  Each is a blocking copy
# from pageable host memory to the card, after which torch synchronizes
# the stream, so the host waits for all queued device work (PERF.md §7).
HIDDEN_SYNCS = {
    ("ltesniffer_tpu_torch/sniffer/pdsch_rx.py", "_t"):
        "the escalation's gather of the failed code blocks' rows",
    ("ltesniffer_tpu_torch/sniffer/core.py", "_put_chunk"):
        "a batch's IQ words and scales, copied ahead",
    ("ltesniffer_tpu_torch/sniffer/core.py", "_phase1_chunk"):
        "the batch's subframe indices for the frontend",
    ("ltesniffer_tpu_torch/sniffer/core.py", "_phase2"):
        "the batch's subframe indices for the search",
    ("ltesniffer_tpu_torch/sniffer/frontend.py", "_derotate"):
        "the residual CFO as a 0-d tensor",
    ("ltesniffer_tpu_torch/kernels/cplx.py", "const"):
        "a constant table's first upload (cached after)",
}


def _function_at(path: str, line: int) -> str:
    tree = ast.parse(open(path).read())
    best = "<module>"
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.lineno <= line <= node.end_lineno:
            best = node.name
    return best


@pytest.mark.cuda
def test_host_read_counter_is_honest_on_the_card(monkeypatch):
    """Every synchronizing call torch reports on a few loaded batches is a
    counted host read (at `prof.host_read`, as many as the counters'
    events) or a known hidden sync of HIDDEN_SYNCS; none comes from the
    eq/demap's, the de-rate-match's or the finish's descriptor upload,
    and none from `pdsch_rx._t` or `_gather_lazy_rows` inside the primary
    DL dispatch: `_t` is left to the escalation's gathers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ltesniffer_tpu_torch.kernels import cb_derm, pdsch_eq, tb_finish
    from ltesniffer_tpu_torch.sniffer import core, pdsch_rx
    from ltesniffer_tpu_torch.testing import loaded_cell
    n_sf = 160
    words, scales, _p, _t = loaded_cell.build_packed(n_sf=n_sf)
    c = core.LTESnifferCore(core.SnifferConfig(cell=loaded_cell.CELL))
    c.run_packed(words, scales)                  # warm: builds and tables
    torch.cuda.synchronize()
    prof.reset()
    t_calls = collections.Counter()      # callers of pdsch_rx._t
    in_dispatch = collections.Counter()  # _t / gathers inside the dispatch
    real_t, real_gather = pdsch_rx._t, pdsch_rx._gather_lazy_rows
    real_dispatch = pdsch_rx.dispatch_grants_batch
    inside = []

    def counted_t(*a, **k):
        t_calls[sys._getframe(1).f_code.co_name] += 1
        in_dispatch["_t"] += bool(inside)
        return real_t(*a, **k)

    def counted_gather(*a, **k):
        in_dispatch["_gather_lazy_rows"] += bool(inside)
        return real_gather(*a, **k)

    def dispatch(*a, **k):
        inside.append(1)
        try:
            return real_dispatch(*a, **k)
        finally:
            inside.pop()
    monkeypatch.setattr(pdsch_rx, "_t", counted_t)
    monkeypatch.setattr(pdsch_rx, "_gather_lazy_rows", counted_gather)
    monkeypatch.setattr(pdsch_rx, "dispatch_grants_batch", dispatch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            c.run_packed(words, scales, sf_idx0=n_sf)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    c.close()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    reads = sum(v["events"] for k, v in prof.counters().items()
                if k.startswith("host_read."))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    at_read, hidden = 0, collections.Counter()
    for w in syncs:
        path = os.path.abspath(w.filename)
        fn = _function_at(path, w.lineno) if path.endswith(".py") else "?"
        if path == os.path.abspath(prof.__file__) and fn == "host_read":
            at_read += 1
        elif fn == "set_sync_debug_mode":
            continue            # the test's own switch back (torch's frame)
        else:
            hidden[(os.path.relpath(path, root), fn)] += 1
    print(f"\nsync debug over {n_sf} loaded subframes "
          f"({torch.cuda.get_device_name(0)}): {len(syncs)} synchronizing "
          f"calls, {at_read} at prof.host_read, {reads} host_read events")
    for (f, fn), k in hidden.most_common():
        print(f"  hidden sync {f}:{fn}: {k}")
    assert at_read == reads > 0
    assert set(hidden) <= set(HIDDEN_SYNCS), sorted(hidden)
    # the transport-block finish's descriptor upload is not a hidden sync
    # (a pinned buffer, non_blocking; `_t` above would hide it otherwise)
    assert tb_finish.LAUNCHES["tb_finish"] > 0
    assert not [k for k in hidden if k[0].endswith("kernels/tb_finish.py")]
    # nor the eq/demap's (one pinned, non_blocking copy a dispatch)
    assert pdsch_eq.LAUNCHES["pdsch_eq_demap"] > 0
    assert not [k for k in hidden if k[0].endswith("kernels/pdsch_eq.py")]
    # nor the de-rate-match's (one a dispatch, priors read by address)
    assert cb_derm.LAUNCHES["cb_derm"] > 0
    assert not [k for k in hidden if k[0].endswith("kernels/cb_derm.py")]
    # all three make it through cplx.upload_pinned
    assert not [k for k in hidden if k[0].endswith("kernels/cplx.py")
                and k[1] == "upload_pinned"]
    n_disp = prof.report()["pd_turbo_call"]["n"]
    n_t = hidden[("ltesniffer_tpu_torch/sniffer/pdsch_rx.py", "_t")]
    print(f"  pdsch_rx._t: {n_t} syncs, calls by caller {dict(t_calls)}, "
          f"inside the primary dispatch {dict(in_dispatch)}; {n_disp} "
          f"dispatches, {cb_derm.LAUNCHES['cb_derm']} de-rate-match "
          f"launches, {pdsch_eq.LAUNCHES['pdsch_eq_demap']} eq/demap "
          "launches")
    assert in_dispatch["_t"] == in_dispatch["_gather_lazy_rows"] == 0
    assert set(t_calls) <= {"_gather_lazy_rows"}
    assert n_t <= sum(t_calls.values())


@pytest.mark.cuda
def test_turbo_launches_count_their_code_blocks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ltesniffer_tpu_torch.kernels import turbo
    for K, B in ((40, 3), (6144, 2)):
        turbo.make_decoder(K, 2)(torch.zeros((B, 3, K + 4), device="cuda"))
    torch.cuda.synchronize()
    c = prof.counters()
    assert c["turbo_cb"] == {"total": 5, "events": 2}
    assert c["turbo_cb.K40"] == {"total": 3, "events": 1}
    assert c["turbo_cb.K6144"] == {"total": 2, "events": 1}
