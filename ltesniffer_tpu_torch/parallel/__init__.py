"""Scaling out: the subframe split over CUDA devices (`sharding`), time
blocks with boundary tracker replay (`multihost`) and the
process-per-block runner (`run_multihost`).  The port's counterpart of
`ltesniffer_tpu/parallel/`."""
