"""Time the Viterbi kernel against variants of its design on one card.

    python -m ltesniffer_tpu_torch.kernels.viterbi_variants \
        [--earlier PATH] [--out FILE]

Builds, beside `csrc/viterbi_tb.cu` as it is, variants made from it by
one textual change each, and times their plain entry (the search entry's
staging is not varied) in turns in one process at the two shapes the
main paths give the kernel: one blind-search call of the
loaded cell (`core.LTESnifferCore.SEARCH_CHUNK` subframes, every location
at every payload size) and the MIB's call (12 x 40).

  kernel     the source as it is
  warps2     blocks of 2 warps (kWarps = 2)
  warps4     blocks of 4 warps (kWarps = 4)
  unsorted   the groups' warps in the caller's order, not longest T first
  l1         no staging: each lane reads its codeword's LLRs from device
             memory through L1 at every step, and the slot keeps only the
             decisions and the bytes of the traceback
  earlier    the source at PATH (`--earlier`), an earlier revision with
             the same C entry, e.g. the one-warp-per-codeword design:
             `git show 7ec34ef:ltesniffer_tpu_torch/kernels/csrc/viterbi_tb.cu`

Every variant's bits must equal the kernel's at both shapes.  Each time is
CUDA events over 20 back-to-back launches through the C entry with the
outputs allocated once (no wrapper in the loop), in two turns: the
variants in order, then in reverse.  Prints, and writes to `--out`, one
JSON line: the card, per shape and variant both turns' ms, and per variant
its ptxas registers and spills and, where it reports them, shared memory
per block and warps per SM at each shape.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

from ltesniffer_tpu_torch.kernels import nvcc_build, viterbi

WRAP = 32
MIB_SHAPE = (12, 40)


def _patch(src: str, old: str, new: str, count: int = 1) -> str:
    if src.count(old) != count:
        raise RuntimeError(f"viterbi_variants: {old!r} occurs "
                           f"{src.count(old)} times in the source, expected "
                           f"{count}")
    return src.replace(old, new)


def _l1(src: str) -> str:
    src = _patch(src, "return (3 * d_max * kRow * 4 + 15) / 16 * 16;",
                 "return (32 * d_max + 15) / 16 * 16;")
    src = _patch(src, "for (int q = lane; cw < nv; q += 32) {",
                 "for (int q = lane; false; q += 32) {")
    src = _patch(src, "const float* col = sl + lane;",
                 "const float* col = llr + static_cast<size_t>(cw0 + "
                 "min(lane, nv - 1)) * 3 * D;")
    out, k = re.subn(r"col\[([^\]]*?) \* kRow\]", r"__ldg(col + \1)", src)
    if k != 6:
        raise RuntimeError(f"viterbi_variants: {k} LLR reads, expected 6")
    return out


VARIANTS = {
    "kernel": lambda s: s,
    "warps2": lambda s: _patch(s, "constexpr int kWarps = 1;",
                               "constexpr int kWarps = 2;"),
    "warps4": lambda s: _patch(s, "constexpr int kWarps = 1;",
                               "constexpr int kWarps = 4;"),
    "unsorted": lambda s: _patch(s, "for (; k > 0 && d[order[k - 1]]",
                                 "for (; false && d[order[k - 1]]"),
    "l1": _l1,
}


def build(earlier: str | None) -> dict:
    """{variant: ctypes library}, built side by side into _build/."""
    base = open(viterbi.SRC).read()
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    srcs = {}
    for name, make in VARIANTS.items():
        path = os.path.join(nvcc_build.BUILD_DIR, f"viterbi_tb_{name}.cu")
        with open(path, "w") as f:
            f.write(make(base))
        srcs[name] = path
    if earlier:
        srcs["earlier"] = os.path.abspath(earlier)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as ex:
        futs = {n: ex.submit(nvcc_build.load, f"viterbi_var_{n}", p)
                for n, p in srcs.items()}
        libs = {n: f.result() for n, f in futs.items()}
    for lib in libs.values():
        lib.viterbi_tb_launch.argtypes = [ctypes.c_void_p] * 5 + \
            [ctypes.c_int, ctypes.c_void_p]
        lib.viterbi_tb_launch.restype = ctypes.c_int
    return libs


def launcher(lib, groups, outs):
    """A call that launches `lib`'s kernel on `groups` into `outs`."""
    import torch
    n = len(groups)
    ints, ptrs = ctypes.c_int * n, ctypes.c_void_p * n
    args = (ptrs(*[x.data_ptr() for x in groups]),
            ptrs(*[o.data_ptr() for o in outs]),
            ints(*[int(x.shape[0]) for x in groups]),
            ints(*[int(x.shape[2]) for x in groups]),
            ints(*[min(WRAP, int(x.shape[2])) for x in groups]), n,
            torch.cuda.current_stream().cuda_stream)

    def run():
        err = lib.viterbi_tb_launch(*args)
        if err != 0:
            raise RuntimeError(f"viterbi variant launch failed: cudaError "
                               f"{err}")
    return run


def time_ms(fn, n: int = 20) -> float:
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


def occupancy(lib, shapes) -> dict | None:
    """Warps per SM and shared memory per block, where the library
    reports them (the earlier revision does not)."""
    try:
        fn = lib.viterbi_tb_occupancy
    except AttributeError:
        return None
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    ds = [d for _, d in shapes]
    ints = ctypes.c_int * len(ds)
    warps, smem = ctypes.c_int(), ctypes.c_int()
    err = fn(ints(*ds), ints(*[min(WRAP, d) for d in ds]), len(ds),
             ctypes.byref(warps), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"viterbi variant occupancy failed: cudaError "
                           f"{err}")
    return dict(warps_per_sm=warps.value, smem_per_block=smem.value)


def search_shapes() -> list:
    """(N, D) of one blind-search call of the loaded cell."""
    from ltesniffer_tpu_torch.sniffer import core, pdcch_rx
    from ltesniffer_tpu_torch.testing import loaded_cell
    st = pdcch_rx.make_unified_search(loaded_cell.CELL)[1]
    return [(core.LTESnifferCore.SEARCH_CHUNK * len(st["locs"]), d)
            for d in st["size_order"]]


def main(argv=None) -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", help="an earlier viterbi_tb.cu to time "
                    "beside the others")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("viterbi_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build(args.earlier)
    names = list(libs)
    rng = np.random.default_rng(20260817)
    res = {"card": card, "shapes": {}, "variants": {}}
    for name in names:
        # the plain entry's kernel (the source also holds the search entry's)
        (_, regs, st, ld), = [
            r for r in nvcc_build.ptxas_report(f"viterbi_var_{name}")
            if "viterbi_tb_kernel" in r[0]]
        res["variants"][name] = dict(registers=regs, spill_bytes=st + ld)
    for label, shapes in (("search", search_shapes()),
                          ("mib", [MIB_SHAPE])):
        groups = [torch.from_numpy((2.0 * rng.standard_normal((n, 3, d)))
                                   .astype(np.float32)).cuda()
                  for n, d in shapes]
        outs = {k: [torch.empty((n, d), dtype=torch.uint8, device="cuda")
                    for n, d in shapes] for k in names}
        runs = {k: launcher(libs[k], groups, outs[k]) for k in names}
        for k in names:
            runs[k]()
        torch.cuda.synchronize()
        for k in names:
            for o, ref in zip(outs[k], outs["kernel"]):
                if not torch.equal(o, ref):
                    raise AssertionError(f"{label}: variant {k}'s bits "
                                         "differ from the kernel's")
        turns = {k: [] for k in names}
        for order in (names, names[::-1]):
            for k in order:
                turns[k].append(time_ms(runs[k]))
        res["shapes"][label] = dict(groups=shapes, ms=turns)
        for k in names:
            occ = occupancy(libs[k], shapes)
            if occ:
                res["variants"][k][label] = occ
        for k in names:
            print(f"{label}: {k:9s} {turns[k][0]:.4f} / {turns[k][1]:.4f} "
                  f"ms", flush=True)
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(card)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
