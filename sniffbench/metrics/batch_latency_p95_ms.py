"""95th percentile of the batches' phase-1-start to phase-5-end time, ms;
None under 200 batches, so that at least 10 lie beyond it."""
import numpy as np

from sniffbench.metrics.program_trace import batch_latency_ms

MIN_BATCHES = 200


def read(rec):
    lat = batch_latency_ms(rec)
    if lat is None or len(lat) < MIN_BATCHES:
        return None
    return float(np.percentile(lat, 95))
