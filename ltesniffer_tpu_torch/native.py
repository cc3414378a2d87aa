"""ctypes bindings for the native (C++) resolver + RNTI manager.

Builds the port's copy of the resolver (`csrc/resolver.cpp`) into a shared
library at first use — `g++ -O2 -shared -fPIC -std=c++17`, into the
git-ignored `ltesniffer_tpu_torch/_build/`, keyed by a hash of the source
and the flags — and exposes drop-in replacements for the Python
`RNTIManager` / `DciBlindSearch` host path.  The Python implementations
stay as the golden model; `tests/test_torch_native.py` holds the two
equal.

No silent fallback: when the library cannot be built or loaded,
`load_library` raises, and so does a core configured with
`use_native=True`.  `use_native=False` selects the Python resolver.

With LTESNIFFER_NATIVE_ASAN=1 in the environment, an
AddressSanitizer-instrumented build (`-O1 -g -fsanitize=address
-fno-omit-frame-pointer`) goes to `_build/libresolver_asan_{hash}.so`
instead, keyed the same way (the reference ships ASAN as a build option,
`CMakeLists.txt:339-351`).  The process must preload libasan
(`testing/asan_resolver_fuzz.py`, `tests/test_torch_native_asan.py`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict

import numpy as np

from ltesniffer_tpu_torch.sniffer.rnti_manager import (
    ActivationReason, FORMAT_ORDER, FORMAT_TO_INDEX,
    RNTI_PER_SUBFRAME, RNTI_HISTORY_DEPTH, RRC_INACTIVITY_TIMER_MS)

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_PKG, "csrc", "resolver.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
ASAN_FLAGS = ("-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer",
              "-shared", "-fPIC", "-std=c++17")

BUILD_SECONDS = {}      # "resolver" -> seconds of the g++ run in this process

_lib = None


def _asan() -> bool:
    return os.environ.get("LTESNIFFER_NATIVE_ASAN") == "1"


def _flags():
    return ASAN_FLAGS if _asan() else CXX_FLAGS


def library_path() -> str:
    """_build/libresolver_{hash}.so (libresolver_asan_{hash}.so with
    LTESNIFFER_NATIVE_ASAN=1): the hash covers the source and flags, so
    an edited source never loads a stale library."""
    flags = _flags()
    blob = open(SRC, "rb").read() + " ".join(flags).encode()
    tag = hashlib.sha1(blob).hexdigest()[:12]
    name = "libresolver_asan" if _asan() else "libresolver"
    return os.path.join(BUILD_DIR, f"{name}_{tag}.so")


def _build(so: str):
    """Compile into a per-process temp file, then rename it into place:
    several processes (test workers) may build at once, and each rename
    is atomic, so none loads a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        r = subprocess.run([CXX, *_flags(), "-o", tmp, SRC],
                           capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"native resolver: cannot run {CXX!r}: {e}") \
            from e
    if r.returncode != 0:
        raise RuntimeError(f"native resolver: {CXX} failed "
                           f"({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    BUILD_SECONDS["resolver"] = time.perf_counter() - t0


def load_library():
    """Compile (if needed) and load the native library; raises
    RuntimeError when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        _build(so)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(f"native resolver: cannot load {so}: {e}") from e
    lib.rm_create.restype = ctypes.c_void_p
    lib.rm_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int64]
    lib.rm_destroy.argtypes = [ctypes.c_void_p]
    for name in ("rm_add_evergreen", "rm_add_forbidden"):
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int]
    lib.rm_step_time.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rm_add_candidate.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.rm_get_frequency.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.rm_get_frequency.restype = ctypes.c_int
    lib.rm_validate_and_refresh.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
    lib.rm_validate_and_refresh.restype = ctypes.c_int
    lib.rm_activate_and_refresh.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int]
    lib.rm_activation_reason.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rm_activation_reason.restype = ctypes.c_int
    lib.rm_is_active.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rm_is_active.restype = ctypes.c_int
    lib.rm_active_count.argtypes = [ctypes.c_void_p]
    lib.rm_active_count.restype = ctypes.c_int
    lib.rm_active_set.argtypes = [ctypes.c_void_p,
                                  np.ctypeslib.ndpointer(np.int32),
                                  np.ctypeslib.ndpointer(np.int8),
                                  ctypes.c_int]
    lib.rm_active_set.restype = ctypes.c_int
    lib.resolve_subframe.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.int8),
        np.ctypeslib.ndpointer(np.float32),
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int64)]
    lib.resolve_subframe.restype = ctypes.c_int
    _lib = lib
    return lib


def build() -> float:
    """Build and load the library now (else it happens at first use).
    Returns the g++ time in seconds (0.0 if the library was there)."""
    load_library()
    return BUILD_SECONDS.get("resolver", 0.0)


class NativeRNTIManager:
    """RNTIManager-compatible facade over the C++ state."""

    def __init__(self, nformats: int = 9,
                 max_candidates_per_step: int = RNTI_PER_SUBFRAME,
                 threshold: int = 5,
                 lifetime_ms: int = RRC_INACTIVITY_TIMER_MS):
        self._lib = load_library()
        self._h = ctypes.c_void_p(self._lib.rm_create(
            nformats, max_candidates_per_step, threshold,
            RNTI_HISTORY_DEPTH, lifetime_ms))
        self.nformats = nformats
        self.threshold = threshold

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.rm_destroy(self._h)
        except Exception:
            pass

    def add_evergreen(self, lo, hi, f):
        self._lib.rm_add_evergreen(self._h, lo, hi, f)

    def add_forbidden(self, lo, hi, f):
        self._lib.rm_add_forbidden(self._h, lo, hi, f)

    def step_time(self, n=1):
        self._lib.rm_step_time(self._h, n)

    def add_candidate(self, rnti, f):
        self._lib.rm_add_candidate(self._h, rnti, f)

    def get_frequency(self, rnti, f):
        return self._lib.rm_get_frequency(self._h, rnti, f)

    def validate_and_refresh(self, rnti, f):
        return bool(self._lib.rm_validate_and_refresh(self._h, rnti, f))

    def activate_and_refresh(self, rnti, f, reason: ActivationReason):
        self._lib.rm_activate_and_refresh(self._h, rnti, f, reason.value)

    def get_activation_reason(self, rnti) -> ActivationReason:
        return ActivationReason(self._lib.rm_activation_reason(self._h, rnti))

    def is_active(self, rnti) -> bool:
        return bool(self._lib.rm_is_active(self._h, rnti))

    def active_set(self):
        cap = 4096
        rntis = np.zeros(cap, np.int32)
        reasons = np.zeros(cap, np.int8)
        n = self._lib.rm_active_set(self._h, rntis, reasons, cap)
        return [(int(rntis[i]), ActivationReason(int(reasons[i])), 0)
                for i in range(n)]


def default_native_manager(threshold: int = 5) -> NativeRNTIManager:
    from ltesniffer_tpu_torch.phy.params import (RARNTI_START, RARNTI_END,
                                                 PRNTI, SIRNTI)
    m = NativeRNTIManager(threshold=threshold)
    for fmt_name, idx in FORMAT_TO_INDEX.items():
        if fmt_name in ("1A", "1C"):
            m.add_evergreen(RARNTI_START, RARNTI_END, idx)
            m.add_evergreen(PRNTI, SIRNTI, idx)
        m.add_forbidden(0x0, 0x0, idx)
    return m


class NativeDciBlindSearch:
    """DciBlindSearch-compatible resolver driven by the C++ core."""

    SNR_GATE_DB = 6.0

    def __init__(self, cell, rnti_manager: NativeRNTIManager,
                 formats=FORMAT_ORDER):
        from ltesniffer_tpu_torch.phy import dci as dci_mod
        from ltesniffer_tpu_torch.sniffer.dci_search import SearchStats
        self.cell = cell
        self.rm = rnti_manager
        self.formats = list(formats)
        self.sizes = dci_mod.format_sizes(cell)
        self.stats = SearchStats()
        self._lib = rnti_manager._lib
        self._fmt0 = self.formats.index("0")
        self._fmt1a = self.formats.index("1A")
        self.size_order = tuple(sorted({self.sizes[f] + 16
                                        for f in self.formats}))
        self._size_idx = {f: self.size_order.index(self.sizes[f] + 16)
                          for f in self.formats}

    def resolve_subframe(self, out: Dict[str, np.ndarray], b: int,
                         locs, nof_cce: int, sf_idx: int, sfn: int = 0):
        from ltesniffer_tpu_torch.sniffer.dci_search import (AcceptedDci,
                                                             _LazyPayload)
        self.stats.nof_subframes += 1
        snr_ok = float(out["snr_db"][b]) > self.SNR_GATE_DB
        n_loc = len(locs)
        nf = len(self.formats)
        cand_rnti = np.zeros((n_loc, nf), np.int32)
        cand_resolved = np.zeros((n_loc, nf), np.int8)
        payload_of = {}
        if "cand_meta" in out:
            meta = np.asarray(out["cand_meta"][b])         # (n_loc, S)
            for fi, f in enumerate(self.formats):
                si = self._size_idx[f]
                m = meta[:, si]
                cand_rnti[:, fi] = m & 0xFFFF
                payload_of[f] = _LazyPayload(b, si, self.sizes[f])
                if f in ("0", "1A"):
                    cand_resolved[:, fi] = np.where((m >> 16) & 1 == 0,
                                                    self._fmt0, self._fmt1a)
                else:
                    cand_resolved[:, fi] = fi
        else:
            for fi, f in enumerate(self.formats):
                D = self.sizes[f] + 16
                bits = np.asarray(out[f"bits_{D}"][b])
                payload_of[f] = bits[:, :D - 16]
                cand_rnti[:, fi] = np.asarray(out[f"rnti_{D}"][b])
                if f in ("0", "1A"):
                    bit0 = bits[:, 0]
                    cand_resolved[:, fi] = np.where(bit0 == 0, self._fmt0,
                                                    self._fmt1a)
                else:
                    cand_resolved[:, fi] = fi
        if snr_ok:
            self.stats.nof_locations += n_loc
        loc_l = np.asarray([l for l, _ in locs], np.int32)
        loc_n = np.asarray([n for _, n in locs], np.int32)
        cce_power = np.ascontiguousarray(out["cce_power"][b], np.float32)
        out_rows = np.zeros((256, 6), np.int32)
        stats = np.zeros(2, np.int64)
        n = self._lib.resolve_subframe(
            self.rm._h, n_loc, nf, nof_cce, sf_idx, int(snr_ok),
            loc_l, loc_n, np.ascontiguousarray(cand_rnti),
            np.ascontiguousarray(cand_resolved), cce_power,
            out_rows.reshape(-1), 256, stats)
        self.stats.nof_decoded_locations += int(stats[0])
        self.stats.nof_missed_cce += int(stats[1])
        accepted = []
        for r in range(n):
            li, fi, rnti, l_d, ncce, hv = out_rows[r]
            fname = self.formats[fi]
            accepted.append(AcceptedDci(
                rnti=int(rnti), fmt=fname, l=int(l_d), ncce=int(ncce),
                payload=payload_of[fname][li].copy(), histval=int(hv),
                sf_idx=sf_idx, sfn=sfn))
        return accepted
