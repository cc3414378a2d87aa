"""Least time of one decode of every code block the profiled calls'
transport blocks carry, at the configured primary iterations, over the
device time of the turbo kernel."""
from sniffbench import work
from sniffbench.harness.reduce import kernel_seconds

KERNEL = "turbo_decode_kernel"


def read(rec):
    t = kernel_seconds(rec.get("kernels") or {}, KERNEL)
    if t <= 0 or not rec.get("profiled_tbs"):
        return None
    return 100.0 * work.turbo_least_seconds(rec["profiled_tbs"],
                                            rec["n_iter"]) / t
