"""Each cell's mix, from the benchmark's transmitter, through the port on
the CPU (the whole run but the look for a card, at a block of a few frames
and a window of one call), against the reference: correct.  The control
and each fault a cell can have, planted in the timed path: not correct."""
import pytest
import torch

from sniffbench import control
from sniffbench.harness import drive

SEED = 2 ** 31 + 5
# the first frames of each block; the warm block learns the UEs (etm31:
# 80 subframes, so each HARQ process's NDI turns over at the wrap)
BLOCK = {"dl20_siso.loaded": 160, "dl20_siso.quiet": 160,
         "dl20_mimo.tm34": 20, "dl20_siso.etm31": 80}


def run(name, program=None, trace=False):
    torch.set_num_threads(4)
    return drive.run(name, SEED, 0.0, trace, device="cpu",
                     block_sf=BLOCK[name], workers=4, program=program)


@pytest.mark.parametrize("name", sorted(BLOCK))
def test_cell_decodes_to_what_was_sent(name):
    r = run(name)
    assert r["correct"], r["checked"]
    assert r["attempted"] > 0 and r["checked"]["bad_payloads"]["value"] == 0
    assert set(r["metrics"]) == {"sf_per_s", "setup_s"}


def test_traced_run_reads_spans_and_no_device_numbers_on_the_cpu():
    r = run("dl20_siso.quiet", trace=True)
    assert r["correct"]
    m = r["metrics"]
    assert "resolve_ms_per_ksf" in m or r["detail"]["calls"] == 1
    for k in ("turbo_roofline", "viterbi_search_roofline",
              "device_idle_pct"):
        assert k not in m          # the CPU has no device time to read


@pytest.mark.parametrize("name", ["dl20_siso.loaded", "dl20_siso.etm31"])
def test_control_is_not_correct(name):
    r = run(name, program=control.plant_of(name))
    assert not r["correct"]
    assert r["checked"]["wrong_pct"]["value"] > \
        r["checked"]["wrong_pct"]["limit"]


def _unchanged(core):
    """A step that returns its state unchanged: the call does nothing."""
    core.run_packed = lambda *a, **k: core.results


def _half(core):
    """Half of each call's subframes left out."""
    orig = core._run_quantized

    def half(frames, scale, quant, total, sf_idx0):
        n = total // 2
        return orig(frames[:n], scale[:n], quant, n, sf_idx0)
    core._run_quantized = half


def _altered(core):
    """A decoded block's bit flipped where the PDSCH result is made."""
    from ltesniffer_tpu_torch.sniffer import core as core_mod
    orig = core_mod.pdsch_rx.finish_grants_batch

    def flipped(*a, **k):
        res = orig(*a, **k)
        for r in res:
            if r is not None and r.crc_ok and r.tb_bits is not None:
                r.tb_bits = r.tb_bits.copy()
                r.tb_bits[0] ^= 1
        return res
    core._fault_restore = (core_mod.pdsch_rx, orig)
    core_mod.pdsch_rx.finish_grants_batch = flipped


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(fault):
    cores = []

    def plant(core):
        cores.append(core)
        fault(core)
    try:
        r = run("dl20_siso.quiet", program=plant)
    finally:
        for c in cores:
            mod, orig = getattr(c, "_fault_restore", (None, None))
            if mod is not None:
                mod.finish_grants_batch = orig
    assert not r["correct"], r["checked"]
    if fault is _altered:
        assert r["checked"]["bad_payloads"]["value"] > 0


@pytest.mark.cuda
def test_loaded_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = drive.run("dl20_siso.loaded", SEED, 0.0, False)
    assert r["correct"], r["checked"]
    assert r["device"]["platform"] == "gpu"
