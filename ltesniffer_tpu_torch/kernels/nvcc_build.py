"""Build a CUDA source of the port into a shared library and load it.

The port's kernels have a plain C entry point; `load(name, src, deps)`
compiles `src` with `nvcc` (for `sm_90a`, `--fmad=false`) into
`ltesniffer_tpu_torch/_build/` (git-ignored) at first use, keyed by a hash
of the source, the headers it includes (`deps`) and the flags, and loads
it with ctypes.  No torch headers, no ninja: a build takes seconds.  The
compile's ptxas report (registers, spills per kernel) is kept beside the
library and parsed by `ptxas_report`.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

BUILD_SECONDS = {}      # name -> seconds of the nvcc run in this process
_LIBS = {}              # name -> path of the library (its ptxas report
                        # sits beside it, + ".ptxas.txt")


def nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


@functools.lru_cache(maxsize=None)
def load(name: str, src: str, deps: tuple = ()) -> ctypes.CDLL:
    """Build `src` (and its included headers `deps`) into
    _build/lib{name}_{hash}.so unless it is there, and load it."""
    blob = b"".join(open(p, "rb").read() for p in (src, *deps))
    tag = hashlib.sha1(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}_{tag}.so")
    _LIBS[name] = so
    if not os.path.exists(so):
        t0 = time.perf_counter()
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, src]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc {os.path.basename(src)} failed "
                               f"({r.returncode}):\n{r.stdout}\n{r.stderr}")
        with open(so + ".ptxas.txt", "w") as f:
            f.write(r.stderr)
        os.replace(tmp, so)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    return ctypes.CDLL(so)


def sass_counts(name: str) -> dict:
    """{kernel symbol: SASS instructions} of library `name`, from the
    toolkit's cuobjdump."""
    r = subprocess.run([os.path.join(os.path.dirname(nvcc()), "cuobjdump"),
                        "-sass", _LIBS[name]], capture_output=True,
                       text=True, check=True)
    out, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
        elif fn and re.match(r"\s+/\*[0-9a-f]{4}\*/\s", line):
            out[fn] += 1
    return out


def ptxas_report(name: str) -> list:
    """[(kernel symbol, registers, spill store bytes, spill load bytes)]
    from the ptxas report of library `name` (built by `load`)."""
    out, fn, spills = [], None, (0, 0)
    for line in open(_LIBS[name] + ".ptxas.txt"):
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((fn, int(m.group(1)), *spills))
            spills = (0, 0)
    return out
