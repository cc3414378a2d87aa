"""Least time of one tail-biting decode of every candidate of the
configuration's search space (its CFI's locations x the DCI sizes), every
profiled subframe, over the device time of the Viterbi's search entry."""
from sniffbench import work
from sniffbench.harness.reduce import kernel_seconds

KERNEL = "viterbi_search_kernel"


def read(rec):
    t = kernel_seconds(rec.get("kernels") or {}, KERNEL)
    if t <= 0 or not rec.get("profiled_sf"):
        return None
    return 100.0 * work.search_least_seconds(rec["config"],
                                             rec["profiled_sf"]) / t
