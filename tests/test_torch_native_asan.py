"""The port's AddressSanitizer-instrumented resolver build, under the
randomized long-run equivalence fuzz (>= 1e5 candidate decisions, native
vs the port's Python resolver), as `tests/test_native_asan.py` runs the
reference's; and the ASAN build's path, key and failure.

The ASAN runtime must be loaded before libc, so the fuzz runs in a
subprocess with LD_PRELOAD=libasan.
"""
import os
import subprocess
import sys

import pytest

from ltesniffer_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _libasan():
    try:
        out = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True, check=True)
        path = out.stdout.strip()
        return path if os.path.isabs(path) and os.path.exists(path) else None
    except (OSError, subprocess.CalledProcessError):
        return None


def test_asan_fuzz_native_resolver():
    libasan = _libasan()
    if libasan is None:
        pytest.skip("g++ finds no libasan.so")
    env = dict(os.environ)
    env.update(LTESNIFFER_NATIVE_ASAN="1", LD_PRELOAD=libasan,
               # python itself is not ASAN-clean at exit; memory errors in
               # the resolver still abort the process with an ASAN report
               ASAN_OPTIONS="detect_leaks=0,abort_on_error=1")
    r = subprocess.run(
        [sys.executable, "-m", "ltesniffer_tpu_torch.testing."
         "asan_resolver_fuzz", "400"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "native == python golden" in r.stdout
    assert "native library: libresolver_asan_" in r.stdout
    assert "ERROR: AddressSanitizer" not in r.stderr


@pytest.mark.parametrize("asan", [False, True])
def test_build_path_and_flags(monkeypatch, asan):
    """LTESNIFFER_NATIVE_ASAN=1 selects the instrumented flags and its own
    library name, keyed by source and flags like the plain build."""
    if asan:
        monkeypatch.setenv("LTESNIFFER_NATIVE_ASAN", "1")
    else:
        monkeypatch.delenv("LTESNIFFER_NATIVE_ASAN", raising=False)
    name = os.path.basename(native.library_path())
    if asan:
        assert native._flags() == ("-O1", "-g", "-fsanitize=address",
                                   "-fno-omit-frame-pointer", "-shared",
                                   "-fPIC", "-std=c++17")
        assert name.startswith("libresolver_asan_")
        base = native.library_path()
        monkeypatch.setattr(native, "ASAN_FLAGS",
                            native.ASAN_FLAGS + ("-DX",))
        assert native.library_path() != base
    else:
        assert native._flags() == native.CXX_FLAGS
        assert name.startswith("libresolver_") and "asan" not in name


def test_asan_build_raises_without_compiler(tmp_path, monkeypatch):
    """No silent fallback for the instrumented build either."""
    monkeypatch.setenv("LTESNIFFER_NATIVE_ASAN", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    with pytest.raises(RuntimeError, match="native resolver"):
        native.load_library()
    assert not os.path.exists(native.library_path())
