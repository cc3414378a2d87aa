"""Subframes through `run_packed` over the window's wall time, every call
of the window, ended by a device synchronize."""


def read(rec):
    return rec["window_sf"] / rec["window_wall_s"]
