"""ltesniffer_tpu_torch — the LTE sniffer on PyTorch and CUDA.

The PyTorch port of `ltesniffer_tpu` (the JAX reference package, which
stays beside it unchanged).  It imports neither JAX nor the reference:
host-only modules are copied here.  The downlink chain
(`sniffer.core.LTESnifferCore`, TM1-TM4 on 1 or 2 RX antennas) runs on a
CUDA device; each turbo decode is one launch of the hand-written kernel
`kernels/csrc/turbo_decode.cu`, and the host resolve runs in the C++
resolver `csrc/resolver.cpp` (`native.py`; with LTESNIFFER_NATIVE_ASAN=1
an AddressSanitizer build of it, fuzzed by
`testing/asan_resolver_fuzz.py`).  `parallel/` scales out: the subframe
split over CUDA devices (`sharding`), time blocks with boundary tracker
replay (`multihost`) and one OS process per block (`run_multihost`).
"""

__version__ = "0.1.0"
