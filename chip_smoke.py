#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives `ltesniffer_tpu_torch` — the PyTorch port of the JAX package
`ltesniffer_tpu` — through its main path on the card and fails (non-zero
exit) if any phase fails:

1. card and build: the card's name and power limit; build the two
   hand-written CUDA kernels with nvcc, side by side: the fused
   whole-decode turbo kernel (kernels/csrc/turbo_decode.cu, the main
   path's decoder) and the per-pass BCJR kernel (kernels/csrc/bcjr.cu,
   the earlier design); their build times and ptxas registers/spills.
2. kernels vs plain version: at the K values of the loaded cell's and the
   golden scenario's grants and K = 40 and 6144, n_iter 2 and 12, with and
   without a HARQ prior, the bits decided on the card by the fused kernel
   and by the lane decoder over the pass kernel equal those of the plain
   version (the lane decoder over the plain twin, on the host), and the
   fused kernel's LLRs are compared too; one pass of the pass kernel and
   of the twin on the same card tensors agrees within 1e-4 * max(1, |x|).
   Times, in turns in one call, of a whole decode at the loaded cell's
   main shape (fused, lanes, lanes, fused; then the plain version) and of
   one pass, beside their bounds.
3. golden: the golden scenario (tests/golden/dl_mode.pcap), built by the
   port's own generator, run on the card; the pcap's sha256 must equal.
4. loaded cell at full width (20 MHz, 512 subframes, batch 256) through
   `LTESnifferCore.run_packed` on the card, held against the JAX
   package's CPU run (ltesniffer_tpu_torch/testing/dl_loaded_expected.json):
   equal accepted-DCI list, PDSCH CRC-ok sets differing in <= 0.5 % of
   grants; in this run the fused kernel must have launched and the pass
   kernel not.
5. the `kernels` JSON line, then the result line.

Imports torch, numpy, the standard library and the port only — no JAX.
Writes only under a temporary directory and ltesniffer_tpu_torch/_build/.
"""
import concurrent.futures
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PCAP = os.path.join(REPO, "tests", "golden", "dl_mode.pcap")
EXPECTED = os.path.join(REPO, "ltesniffer_tpu_torch", "testing",
                        "dl_loaded_expected.json")
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside tensor cores
BCJR_TOL = 1e-4                  # |kernel - twin| <= 1e-4 * max(1, |twin|)
CRC_DIFF_MAX = 0.005             # share of grants whose CRC-ok may differ
BCJR_REPLACES = "ltesniffer_tpu/kernels/turbo_pallas.py:125"
# the fused kernel replaces the same TPU kernel together with its caller
# ltesniffer_tpu/kernels/turbo.py:255 (_make_decoder_pallas)
TURBO_REPLACES = "ltesniffer_tpu/kernels/turbo_pallas.py:125"


def log(msg: str):
    print(msg, flush=True)


class Phase:
    """Prints a phase's name and wall time; re-raises its failure."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, typ, val, tb):
        dt = time.perf_counter() - self.t0
        log(f"== {self.name}: {'ok' if typ is None else 'FAILED'} "
            f"({dt:.2f} s)")
        return False


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# scenarios (the port's own generator)
# ---------------------------------------------------------------------------
def golden_scenario():
    """tests/test_golden_replay.py:_build_stream, through the port."""
    from ltesniffer_tpu_torch.mac_rrc import mac, rrc
    from ltesniffer_tpu_torch.phy.params import CellConfig
    from ltesniffer_tpu_torch.testing import scenario
    cell = CellConfig(n_id_cell=199, n_prb=50, nof_ports=2, nof_rx_ant=1)
    sb = scenario.ScenarioBuilder(cell, seed=20260817, noise=0.04)
    sib2 = rrc.encode_sib2(rrc.Sib2UlConfig(cyclic_shift=2))
    ue_pdu = mac.build_mac_pdu([mac.MacSubPdu(lcid=3,
                                              payload=b"golden-ue-data")])
    pg = rrc.encode_paging([rrc.PagingRecord(s_tmsi=0x1122334455)])
    for j in range(20):
        sf = j % 10
        txs = []
        if sf == 5:
            txs.append(scenario.DlTx(rnti=0xFFFF, mac_pdu=sib2, n_prb=6))
        if sf == 0:
            txs.append(scenario.DlTx(rnti=0xFFFE, mac_pdu=pg, n_prb=6,
                                     prb_start=40))
        if j >= 2:
            txs.append(scenario.DlTx(rnti=0x4D2, mac_pdu=ue_pdu, n_prb=10,
                                     prb_start=12, ndi=j % 2,
                                     harq_pid=j % 8))
        sb.add_subframe(sf, txs)
    return cell, sb.stream(), sb.truth


def code_block_sizes(truth) -> dict:
    """{K: code blocks} the decoder sees over a scenario's transport
    blocks: each TB's own size, and the 64QAM-table size the sniffer tries
    first for a UE whose table it has not learned yet."""
    from ltesniffer_tpu_torch.phy import tables, turbo as turbo_host
    out = {}
    for t in truth:
        tbss = {t["tbs"]}
        if t.get("mcs") is not None and t["tbs"] > 0:
            _, itbs = tables.dl_mcs_to_qm_itbs(t["mcs"], False)
            if itbs >= 0:
                tbss.add(tables.tbs_lookup(itbs, 8))
        for tbs in tbss:
            for K in turbo_host.segment_sizes(tbs).K:
                out[K] = out.get(K, 0) + 1
    return out


# ---------------------------------------------------------------------------
# phase 2: the BCJR kernel against its plain twin
# ---------------------------------------------------------------------------
def turbo_llrs(K: int, B: int, rng):
    """B random turbo-coded blocks of size K: (sent bits (B, K), a noisy
    observation (B, 3, K+4), and a weaker second observation of the same
    code words, the HARQ prior a retransmission combines with)."""
    import numpy as np
    from ltesniffer_tpu_torch.phy import turbo as turbo_host
    bits = rng.integers(0, 2, (B, K)).astype(np.uint8)
    d = np.stack([turbo_host.turbo_encode(b) for b in bits])
    x = 1.0 - 2.0 * d.astype(np.float32)
    noise = rng.normal(size=(2,) + x.shape).astype(np.float32)
    return (bits, (1.6 * x + noise[0]).astype(np.float32),
            (0.8 * x + noise[1]).astype(np.float32))


def time_cuda(fn, n: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bcjr_bound_ms(W: int, L: int):
    """Least time for one pass on the card: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    from ltesniffer_tpu_torch.kernels import bcjr
    t_bytes = bcjr.bytes_moved(W, L) / HBM_BYTES_PER_S * 1e3
    # per lane and step: forward 4 gammas + 16 add + 8 max + 8 sub, and
    # backward 1 add + 4 gammas + 32 add + 24 max + 2 sub + 8 sub
    ops = (36 + 71) * W * L
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_decoders(ks: dict, device, rng) -> dict:
    """Fused kernel and lane decoder over the pass kernel, both on the card,
    vs the plain version on the host: decided bits (per K, n_iter, prior),
    the fused kernel's LLRs; one pass of the pass kernel at the main-path
    shape of each K.  Returns each kernel's max |error|."""
    import numpy as np
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode
    err = {"bcjr": 0.0, "turbo_decode": 0.0}
    for K in sorted(ks):
        B = max(8, min(ks[K], 256))
        sent, llr, prior = turbo_llrs(K, B, rng)
        for n_iter in (2, 12):
            for with_prior in (False, True):
                d = llr + prior if with_prior else llr
                b_host, l_host = turbo.make_decoder(K, n_iter)(
                    torch.from_numpy(d))
                b_host = b_host.numpy()
                d_card = torch.from_numpy(d).to(device)
                b_fused, l_fused = turbo.make_decoder(K, n_iter)(d_card)
                b_lanes, _ = turbo.make_decoder_lanes(K, n_iter)(d_card)
                for name, b in (("fused kernel", b_fused),
                                ("lane decoder + pass kernel", b_lanes)):
                    b = b.cpu().numpy()
                    if not np.array_equal(b, b_host):
                        n = int((b != b_host).sum())
                        raise AssertionError(
                            f"K={K} n_iter={n_iter} prior={with_prior}: "
                            f"{n} bits of the {name} differ from the plain "
                            "version")
                e = float((l_fused.cpu() - l_host).abs().max())
                err["turbo_decode"] = max(err["turbo_decode"], e)
                ber = float((b_host != sent).mean())
                log(f"  K={K:5d} B={B:4d} n_iter={n_iter:2d} "
                    f"prior={int(with_prior)}: fused and lanes bits equal "
                    f"plain; fused max |LLR err| {e:.3e}; BER vs sent "
                    f"{ber:.2e}")
        # one pass on the card: kernel vs twin on the same card tensors
        W = turbo_decode.window_len(K)
        L = turbo._lane_consts(K, B)["L"]
        g = torch.Generator(device="cpu").manual_seed(K)
        ins = [torch.randn((W, L), generator=g) * 4.0 for _ in range(3)]
        ins += [torch.randn((8, L), generator=g) * 4.0 for _ in range(2)]
        ins = [x.to(device).contiguous() for x in ins]
        got = bcjr.bcjr_cuda(*ins)
        want = bcjr.bcjr_plain(*ins)
        for name, a, b in zip(("ext", "a_end", "b_start"), got, want):
            e = (a - b).abs()
            lim = BCJR_TOL * torch.clamp(b.abs(), min=1.0)
            if bool((e > lim).any()):
                raise AssertionError(f"K={K} pass {name}: max |err| "
                                     f"{float(e.max()):.3e} over tol")
            err["bcjr"] = max(err["bcjr"], float(e.max()))
    return err


def fused_bound_ms(K: int, B: int, n_iter: int):
    """Least time for one decode on the card: the larger of bytes over the
    memory rate and float32 operations over the float32 rate."""
    from ltesniffer_tpu_torch.kernels import turbo_decode
    t_bytes = turbo_decode.bytes_moved(K, B) / HBM_BYTES_PER_S * 1e3
    t_ops = turbo_decode.ops(K, B, n_iter) / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_decoders(K: int, B: int, device, rng) -> dict:
    """Whole-decode times at (K, B), n_iter 2 and 12: the fused kernel and
    the earlier design (lane decoder over the pass kernel) in turns (fused,
    lanes, lanes, fused), the plain version on the card, the bound."""
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo
    _, llr, _ = turbo_llrs(K, B, rng)
    d = torch.from_numpy(llr).to(device)
    out = {}
    for n_iter in (2, 12):
        fused = turbo.make_decoder(K, n_iter)
        lanes = turbo.make_decoder_lanes(K, n_iter)
        plain = turbo.make_decoder_lanes(K, n_iter, bcjr.bcjr_plain)
        t_f1 = time_cuda(lambda: fused(d), n=20)
        t_l1 = time_cuda(lambda: lanes(d), n=5)
        t_l2 = time_cuda(lambda: lanes(d), n=5)
        t_f2 = time_cuda(lambda: fused(d), n=20)
        t_p = time_cuda(lambda: plain(d), n=2)
        bound, by = fused_bound_ms(K, B, n_iter)
        out[n_iter] = dict(ms=min(t_f1, t_f2), ms_turns=[t_f1, t_f2],
                           lanes_ms=min(t_l1, t_l2),
                           lanes_turns=[t_l1, t_l2], plain_ms=t_p,
                           bound_ms=bound, bound_by=by)
    return out


def time_bcjr(K: int, B: int, device) -> dict:
    """Kernel, twin and bound times of one pass at the shape the main
    path gives K with B code blocks in one call."""
    import torch
    from ltesniffer_tpu_torch.kernels import bcjr, turbo, turbo_decode
    W = turbo_decode.window_len(K)
    L = turbo._lane_consts(K, B)["L"]
    g = torch.Generator(device="cpu").manual_seed(1)
    ins = [(torch.randn((W, L), generator=g) * 4.0).to(device)
           for _ in range(3)]
    ins += [(torch.randn((8, L), generator=g) * 4.0).to(device)
            for _ in range(2)]
    ms = time_cuda(lambda: bcjr.bcjr_cuda(*ins), n=50)
    plain_ms = time_cuda(lambda: bcjr.bcjr_plain(*ins), n=5)
    bound_ms, bound_by = bcjr_bound_ms(W, L)
    return dict(K=K, W=W, L=L, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------
def run_golden(device, tmp: str):
    from ltesniffer_tpu_torch.sniffer import core
    cell, stream, _ = golden_scenario()
    out = os.path.join(tmp, "dl_golden.pcap")
    cfg = core.SnifferConfig(cell=cell, batch_size=8, pcap_path=out,
                             api_mode=0, device=device)
    c = core.LTESnifferCore(cfg)
    c.run_samples(stream)
    c.close()
    got = hashlib.sha256(open(out, "rb").read()).hexdigest()
    want = hashlib.sha256(open(GOLDEN_PCAP, "rb").read()).hexdigest()
    log(f"  golden pcap sha256 {got} ({'equal' if got == want else 'DIFFERS'}"
        f"); summary pdsch_ok={c.summary()['pdsch_ok']}")
    if got != want:
        raise AssertionError(f"golden pcap sha256 {got} != {want}")


def run_loaded(device, words, scales, tmp: str, batch_size: int = 256):
    """The main path: run_packed over the loaded cell, logging accepted
    DCIs.  Returns (core, accepted log, seconds)."""
    import torch
    from ltesniffer_tpu_torch.sniffer import core
    from ltesniffer_tpu_torch.testing import loaded_cell
    cfg = core.SnifferConfig(cell=loaded_cell.CELL, batch_size=batch_size,
                             pcap_path=os.path.join(tmp, "loaded.pcap"),
                             device=device)
    c = core.LTESnifferCore(cfg)
    acc = []

    def hook(ctx):
        for a in ctx["accepted"]:
            acc.append([ctx["sfn"] * 10 + ctx["sf"], int(a.rnti), a.fmt])
    c.on_subframe = hook
    t0 = time.perf_counter()
    c.run_packed(words, scales)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c.close()
    return c, acc, dt


def profile_loaded(device, words, scales, tmp: str):
    """A second loaded-cell pass under torch.profiler: device time by
    kernel name, the device's busy share of the wall time, and the host
    spans of the port's stage profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ltesniffer_tpu_torch.sniffer import prof
    prof.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        _, _, dt = run_loaded(device, words, scales, tmp)
    from torch.autograd import DeviceType
    rows = []
    for e in p.key_averages():
        # kernels only: host ops carry their kernels' time as well
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0:
            rows.append((t / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  device time: not measured (the profiler saw no kernels)")
    else:
        log(f"  profiled pass {dt:.2f} s wall; device busy {busy:.1f} ms "
            f"({100 * busy / (1e3 * dt):.1f} % of wall)")
        for ms, n, name in rows[:12]:
            log(f"    {ms:9.2f} ms {n:7d}x  {name[:90]}")
        for ms, n, name in rows:
            if "turbo_decode_kernel" in name or "bcjr_kernel" in name:
                log(f"  port kernel {name[:60]}: {ms:.3f} ms over {n} "
                    f"launches ({100 * ms / busy:.2f} % of device time)")
    for line in prof.pretty().splitlines():
        log(f"  host span {line}")


def compare_loaded(rec: dict, c, acc):
    """Hold one run against the expected record: equal accepted-DCI list;
    PDSCH CRC-ok sets within CRC_DIFF_MAX of the grants."""
    want = [list(x) for x in rec["dcis"]]
    if acc != want:
        missing = [x for x in want if x not in acc][:10]
        extra = [x for x in acc if x not in want][:10]
        raise AssertionError(f"accepted DCIs differ: {len(acc)} vs "
                             f"{len(want)}; missing {missing}, extra {extra}")
    ok_want = {tuple(want[i]) for i, f in zip(rec["pdsch_dci"],
                                             rec["pdsch_ok"]) if f == "1"}
    ok_got = {(r.dci.sfn * 10 + r.dci.sf_idx, int(r.dci.rnti), r.dci.fmt)
              for r in c.results if r.crc_ok}
    diff = sorted(ok_want ^ ok_got)
    n_grants = len(rec["pdsch_dci"])
    for d in diff:
        log(f"  CRC-ok differs: tti={d[0]} rnti={d[1]} fmt={d[2]} "
            f"({'expected only' if d in ok_want else 'card only'})")
    share = len(diff) / max(1, n_grants)
    log(f"  CRC-ok set: {len(ok_got)} on the card, {len(ok_want)} expected, "
        f"{len(diff)} differ ({100 * share:.3f} % of {n_grants} grants)")
    if share > CRC_DIFF_MAX:
        raise AssertionError(f"CRC-ok sets differ in {100 * share:.3f} % "
                             f"of grants (limit {100 * CRC_DIFF_MAX} %)")


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from ltesniffer_tpu_torch.kernels import bcjr, nvcc_build, turbo_decode
    from ltesniffer_tpu_torch.testing import loaded_cell
    device = "cuda"
    kind = torch.cuda.get_device_name(0)
    rng = np.random.default_rng(20260817)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("1 card and build"):
            card = card_line()
            log(card)
            log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
                f"device {kind}")
            # one nvcc for each source, both started together
            with concurrent.futures.ThreadPoolExecutor(2) as ex:
                builds = {m.__name__.rsplit(".", 1)[1]: ex.submit(m.build)
                          for m in (turbo_decode, bcjr)}
            for name, f in builds.items():
                log(f"  nvcc build of kernels/csrc/{name}.cu: "
                    f"{f.result():.2f} s")
                sass = nvcc_build.sass_counts(name)
                for fn, regs, st, ld in nvcc_build.ptxas_report(name):
                    log(f"  ptxas {name}: {regs} registers, {st} bytes "
                        f"spill stores, {ld} bytes spill loads, "
                        f"{sass.get(fn, 'n/a')} SASS instructions ({fn})")
        with Phase("scenarios (port generator)"):
            _, _, golden_truth = golden_scenario()
            t0 = time.perf_counter()
            words, scales, placed, loaded_truth = loaded_cell.build_packed()
            log(f"  loaded cell: {loaded_cell.N_SF} subframes, {placed} "
                f"placed TBs, built in {time.perf_counter() - t0:.1f} s")
            rec = json.load(open(EXPECTED))
            if rec["params"] != loaded_cell.params() or \
                    rec["placed"] != placed:
                raise AssertionError("expected record does not match the "
                                     "scenario")
        with Phase("2 kernels vs plain version"):
            ks_loaded = code_block_sizes(loaded_truth)
            ks = dict(ks_loaded)
            for K, m in code_block_sizes(golden_truth).items():
                ks.setdefault(K, m)
            # the smallest block and the largest shared-memory case
            ks.setdefault(40, 8)
            ks.setdefault(6144, 8)
            log(f"  K values: {sorted(ks)}")
            err = check_decoders(ks, device, rng)
            # timing at the loaded cell's most common K, with the code
            # blocks one batch of 256 subframes carries
            K_main = max(ks_loaded, key=ks_loaded.get)
            B_main = ks_loaded[K_main] * 256 // loaded_cell.N_SF
            td = time_decoders(K_main, B_main, device, rng)
            geo = turbo_decode.launch_geometry(K_main, B_main)
            for n_iter, t in td.items():
                log(f"  whole decode at K={K_main}, B={B_main}, n_iter="
                    f"{n_iter} on {card}: fused kernel {t['ms']:.4f} ms "
                    f"(turns {t['ms_turns'][0]:.4f}, {t['ms_turns'][1]:.4f})"
                    f"; lane decoder + pass kernel {t['lanes_ms']:.4f} ms "
                    f"(turns {t['lanes_turns'][0]:.4f}, "
                    f"{t['lanes_turns'][1]:.4f}); plain version "
                    f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}: max(ops / 67 TFLOP/s, bytes / "
                    f"3.35 TB/s))")
            log(f"  fused launch at that shape: {geo['ctas']} CTAs x "
                f"{geo['threads']} threads ({geo['G']} code blocks of "
                f"{geo['NW']} windows, W={geo['W']}, S={geo['S']}), "
                f"{geo['smem']} bytes of shared memory each")
            tm = time_bcjr(K_main, B_main, device)
            log(f"  one pass at K={K_main} (W={tm['W']}, L={tm['L']}) on "
                f"{card}: kernel {tm['ms']:.4f} ms, plain twin "
                f"{tm['plain_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
                f"({tm['bound_by']}: (4W+32)*L*4 B over 3.35 TB/s); no "
                "single PyTorch call computes a BCJR pass or a turbo "
                "decode, so there is no library time")
        with Phase("3 golden scenario on the card"):
            run_golden(device, tmp)
        with Phase("4 loaded cell, 20 MHz, 512 subframes, batch 256"):
            bcjr.reset_launches()
            turbo_decode.reset_launches()
            c, acc, dt = run_loaded(device, words, scales, tmp)
            n_fused = turbo_decode.LAUNCHES["turbo_decode"]
            n_pass = bcjr.LAUNCHES["bcjr"]
            s = c.summary()
            log(f"  summary: subframes {s['subframes']}, dcis {s['dcis']}, "
                f"pdsch_ok {s['pdsch_ok']}, placed {placed} "
                f"(pdsch_ok/placed {s['pdsch_ok'] / placed:.4f})")
            log(f"  {loaded_cell.N_SF / dt:.1f} subframes/s on {card} "
                f"({dt:.2f} s wall, first reading, not a target)")
            log(f"  launches in this run: turbo_decode (fused) {n_fused}, "
                f"bcjr (pass kernel) {n_pass}")
            compare_loaded(rec, c, acc)
            if n_fused <= 0:
                raise AssertionError("the main path launched no fused "
                                     "turbo kernel")
            if n_pass != 0:
                raise AssertionError(f"the main path launched the pass "
                                     f"kernel {n_pass} times")
        with Phase("4b where the time goes (profiled second pass)"):
            profile_loaded(device, words, scales, tmp)
        t2, t12 = td[2], td[12]
        line = {"kernels": [{
            "name": "turbo_decode", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/turbo_decode.cu",
            "replaces": TURBO_REPLACES, "launches": n_fused,
            "max_abs_err": err["turbo_decode"], "ms": t2["ms"],
            "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
            "bound_by": t2["bound_by"], "library_ms": None,
            "shape": {"K": K_main, "B": B_main, "n_iter": 2},
            "lanes_ms": t2["lanes_ms"],
            "n_iter_12": {k: t12[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by", "lanes_ms")},
        }, {
            "name": "bcjr", "route": "cuda",
            "source": "ltesniffer_tpu_torch/kernels/csrc/bcjr.cu",
            "replaces": BCJR_REPLACES, "launches": n_pass,
            "max_abs_err": err["bcjr"], "ms": tm["ms"],
            "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
            "bound_by": tm["bound_by"], "library_ms": None}]}
        log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
