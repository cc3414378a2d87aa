"""One run of one cell: make the input, set up the program, warm it up on
the first input block, replay the block through the timed entry of the
configuration's mode (`sniffbench/modes/`; downlink: `LTESnifferCore.
run_packed`) for the window, check what it produced against the
reference, and reduce the window to the cell's metrics.

Set-up (`setup_s`) runs from process start to the end of the warm block:
making the input, importing the program, building its kernels (the first
run in a checkout), the core, and the warm block.  The window then hands
the same core one input block per call, the subframe labels continuing,
so it keeps its HARQ, RNTI-manager and SFN state as in a long capture;
it ends with the first call that returns after `seconds`.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "sniffbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "ltesniffer_tpu")
SFN_WRAP = 10240


class NoCard(RuntimeError):
    """The run asked for more cards than the machine has."""


class Forbidden(RuntimeError):
    """The process loaded JAX or the JAX package."""


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell's workload, configuration, traffic mix and metrics, found
    by name under `sniffbench/` and in `BENCHMARK.json`."""
    wl = _json(os.path.join(HERE, "workloads", f"{name}.json"))
    bench = _json(os.path.join(ROOT, "BENCHMARK.json"))

    def mine(ms):
        return [m for m in ms if name in m.get("workloads", [name])]
    return dict(name=name, workload=wl,
                config=_json(os.path.join(HERE, "configs",
                                          f"{wl['config']}.json")),
                mix=_json(os.path.join(HERE, "traffic",
                                       f"{wl['traffic']}.json")),
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]))


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(metric: str) -> Callable:
    return importlib.import_module(f"sniffbench.metrics.{metric}").read


def device_info(torch, device: str, n: int) -> dict:
    if not device.startswith("cuda"):
        return dict(platform="cpu", kind="cpu", count=1)
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=n)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20).stdout.strip()
        info["power_limit_w"] = float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def mode_of(config: dict):
    """The configuration's mode module (`sniffbench/modes/<mode>.py`)."""
    mode = config.get("mode")
    try:
        return importlib.import_module(f"sniffbench.modes.{mode}")
    except ModuleNotFoundError as e:
        raise ValueError(f"configuration {config.get('name')!r}: no entry "
                         f"for mode {mode!r} (sniffbench/modes/)") from e


def run(name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t0: Optional[float] = None,
        block_sf: Optional[int] = None, workers: Optional[int] = None,
        program: Optional[Callable] = None, log=sys.stderr) -> dict:
    """One run; returns the result line as a dict.  `block_sf` cuts the
    input block to its first subframes and `program` wraps the core after
    it is built (both for the tests and the control, never in the
    benchmark's own runs)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(name)
    mode = mode_of(cell["config"])
    chips = cell["workload"]["chips"]
    import torch
    if device.startswith("cuda") and (not torch.cuda.is_available()
                                      or torch.cuda.device_count() < chips):
        raise NoCard(f"{name} needs {chips} CUDA device(s); "
                     f"torch.cuda.is_available() = "
                     f"{torch.cuda.is_available()}, device_count() = "
                     f"{torch.cuda.device_count()}")
    sync = (torch.cuda.synchronize if device.startswith("cuda")
            else (lambda: None))

    # --- the input --------------------------------------------------------
    from sniffbench.reference import pcap as pcap_ref
    t = time.perf_counter()
    inputs, truth = mode.build_input(
        cell["config"], cell["mix"], seed,
        workers or min(8, os.cpu_count() or 1), block_sf)
    L = len(truth)
    if SFN_WRAP % L or L % 10:
        raise ValueError(f"a block of {L} subframes must be whole frames "
                         f"and divide the SFN wrap of {SFN_WRAP}")
    gen_s = time.perf_counter() - t
    print(f"input: {L} subframes made in {gen_s:.3f} s", file=log,
          flush=True)

    # --- the program ------------------------------------------------------
    from ltesniffer_tpu_torch.sniffer import prof
    fd, pcap_path = tempfile.mkstemp(prefix="sniffbench-", suffix=".pcap")
    os.close(fd)
    try:
        core = mode.make_core(cell["config"], device, pcap_path)
        if program is not None:
            program(core)
        rec = mode.Recorder(core)
        mode.call(core, inputs, 0)                        # the warm block
        sync()
        setup_s = time.perf_counter() - t0
        print(f"set-up: {setup_s:.3f} s (input {gen_s:.3f} s)", file=log,
              flush=True)
        core.pcap.flush()
        pcap_offset = os.path.getsize(pcap_path)

        # --- the window ---------------------------------------------------
        tracer = _Tracer(core, prof, torch, mode.PHASES) if trace else None
        call_s: List[float] = []
        gc_s = [0.0, 0]          # seconds and count of the collector's runs
        gc_t = [0.0]

        def gc_clock(phase, _info):
            if phase == "start":
                gc_t[0] = time.perf_counter()
            else:
                gc_s[0] += time.perf_counter() - gc_t[0]
                gc_s[1] += 1
        gc.callbacks.append(gc_clock)
        tw0 = time.perf_counter()

        def one_call() -> bool:
            k = len(call_s) + 1
            rec.start_call(k)
            t = time.perf_counter()
            mode.call(core, inputs, k * L)
            sync()
            call_s.append(time.perf_counter() - t)
            return time.perf_counter() - tw0 >= seconds

        over = False
        if tracer is not None:
            for how in tracer.HOW:
                with tracer.profiled(how):
                    over = one_call()
                    t_stop = time.perf_counter()
                # the profiler's teardown (it parses every event) is not
                # the program's time: the window's clock stops for it
                tw0 += time.perf_counter() - t_stop
                tracer.took(how, call_s[-1])
                if over:
                    break
            over = time.perf_counter() - tw0 >= seconds
            tracer.spans_from_here(len(call_s) * L)
        while not over:
            over = one_call()
        tw1 = time.perf_counter()
        gc.callbacks.remove(gc_clock)
        window_sf = len(call_s) * L
        print(f"window: {len(call_s)} calls, {window_sf} subframes in "
              f"{tw1 - tw0:.3f} s", file=log, flush=True)
        mem = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
               else None)
        core.close()
        found = forbidden_modules()
        if found:
            raise Forbidden("the run loaded " + ", ".join(found))

        # --- the check (after the window) ---------------------------------
        out_calls = rec.calls()
        bodies = pcap_ref.read_bodies(pcap_path, pcap_offset)
    finally:
        os.remove(pcap_path)
    cmp = mode.compare(truth, out_calls, bodies)
    limits = cell["workload"]["limits"]
    checked = {k: dict(value=cmp[k], limit=limits[k]) for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checked.values())

    record = dict(setup_s=setup_s, gen_s=gen_s, window_sf=window_sf,
                  window_wall_s=tw1 - tw0, config=cell["config"],
                  n_iter=core.cfg.turbo_iters)
    if tracer is not None:
        record.update(tracer.record(L, mode.work_tbs(truth)))
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    dev = device_info(torch, device, chips)
    if mem is not None:
        dev["memory_peak_bytes"] = int(mem)
    result = dict(correct=correct, attempted=cmp["n_tb"],
                  failed=cmp["tb_missed"], metrics=metrics, device=dev)
    if tracer is not None:
        dev["busy_s"] = record.get("busy_s")
        dev["window_s"] = record.get("window_s")
        result["breakdown"] = record.get("breakdown")
    result["detail"] = dict(missed_by=cmp["missed_by"],
                            extra_by=cmp["extra_by"],
                            dci_examples=cmp["dci_examples"],
                            calls=len(call_s), call_s=call_s, gc_s=gc_s[0],
                            gc_n=gc_s[1], block_sf=L, gen_s=gen_s, seed=seed)
    result["checked"] = checked
    return result


class _Tracer:
    """The traced run: the window's first call under torch.profiler with
    device activity alone (device time by kernel, the union of device
    activity over the call's own wall time), its second with host
    activity too and host ranges around the program's stage spans and the
    core's phases (to name the idle gaps: host activity and the ranges
    stretch that call, so it gives only the names), then the program's
    stage spans over the rest of the window."""

    HOW = ("device", "host")

    def __init__(self, core, prof, torch, phases):
        self.core, self.prof, self.torch = core, prof, torch
        self.phases = phases
        self.events = {}
        self.wall = {}
        self.span_sf0 = None

    @contextlib.contextmanager
    def profiled(self, how: str):
        torch, prof, core = self.torch, self.prof, self.core
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [])
        if how == "host" or not acts:
            acts.append(ProfilerActivity.CPU)
        orig_span = prof.span
        if how == "host":
            @contextlib.contextmanager
            def span(name):
                with record_function("span:" + name), orig_span(name):
                    yield

            def wrap(fn, name):
                def phase(*a, **kw):
                    with record_function("span:" + name):
                        return fn(*a, **kw)
                return phase
            prof.span = span
            for ph in self.phases:
                setattr(core, ph, wrap(getattr(core, ph), ph.strip("_")))
        try:
            with profile(activities=acts) as p:
                with record_function("span:window"):
                    yield
        finally:
            prof.span = orig_span
            for ph in self.phases:
                core.__dict__.pop(ph, None)
        self.events[how] = _events(p)

    def took(self, how: str, wall_s: float):
        self.wall[how] = wall_s

    def spans_from_here(self, sf_done: int):
        self.prof.reset()
        self.span_sf0 = sf_done

    def record(self, L: int, tbs: List[int]) -> dict:
        from sniffbench.harness import reduce
        rec = {}
        dev = reduce.device_side(self.events.get("device", ()))
        if dev:
            rec.update(busy_s=dev["busy_s"], kernels=dev["kernels"],
                       window_s=self.wall["device"], profiled_sf=L,
                       profiled_tbs=list(tbs),
                       breakdown=dict(device_ops=dev["device_ops"],
                                      idle_gaps=reduce.idle_gaps(
                                          self.events.get("host", ()))))
        if self.span_sf0 is not None:
            done = self.core.processed - L       # the warm block's
            span_sf = done - self.span_sf0
            if span_sf > 0:
                rec["spans"] = {k: v["s"] for k, v in
                                self.prof.report().items()}
                rec["span_sf"] = span_sf
        return rec


def _events(p) -> List[tuple]:
    """(name, on_device, start_us, end_us) of every profiled event."""
    from torch.autograd import DeviceType
    out = []
    for e in p.events():
        dev = e.device_type == DeviceType.CUDA
        out.append((e.name, dev, float(e.time_range.start),
                    float(e.time_range.end)))
    return out
