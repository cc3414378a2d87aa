"""Median time from a batch's phase 1 start to its phase 5 end (all its
transport blocks and pcap records out), over the window's batches, ms."""
import numpy as np

from sniffbench.metrics.program_trace import batch_latency_ms


def read(rec):
    lat = batch_latency_ms(rec)
    return None if lat is None else float(np.median(lat))
