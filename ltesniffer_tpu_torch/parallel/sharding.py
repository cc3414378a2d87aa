"""The subframe split over devices: shard the batch's subframe axis.

The port's counterpart of `ltesniffer_tpu/parallel/sharding.py`.  There
the batch sits on a `Mesh(devices, 'sf')` with `NamedSharding(P('sf'))`
and XLA partitions every stage.  Subframes are independent until the host
resolve, so no stage needs a collective, and the port makes the same
split by hand: the batch is cut into contiguous, equal shards, one per
mesh device; each shard's frontend and fixed-CFI search are enqueued on
its device before any result is read, so distinct cards overlap; `gather`
reads the shards back to the host in subframe order.

Per-device constants go through `kernels.cplx.const`, whose cache keys a
constant by `str(device)`: `"cuda"` and `"cuda:0"` are two entries (two
uploads of the same table to the same card).  `make_mesh` names every
device with its index, so a mesh never holds both spellings.

Across hosts, each host takes a contiguous time block of the stream
(`parallel.multihost`) and may split its batches over its own cards here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ltesniffer_tpu_torch.kernels.cplx import to_ri
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import frontend as frontend_mod
from ltesniffer_tpu_torch.sniffer import pdcch_rx


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one axis; a device may repeat
    (several shards on one card, or `["cpu"] * 8` in the tests)."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("sf",)

    @property
    def size(self) -> int:
        return len(self.devices)


def _indexed(dev) -> torch.device:
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices=None, axis: str = "sf") -> Mesh:
    """A mesh over `devices` (names or torch.device, repeats allowed), or
    with None over every CUDA card; raises when there is none."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device is available")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(_indexed(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices given")
    return Mesh(devs, (axis,))


def shard_subframes(mesh: Mesh, samples, sf_idx):
    """(B, RX, sf_len[, 2]) samples and (B,) sf_idx -> (samples shards,
    sf_idx shards): contiguous shards of B / mesh.size subframes, each on
    its mesh device.  Complex input is converted to float pairs on the
    host; raises when B is not a multiple of the mesh size."""
    x = np.asarray(samples)
    if np.iscomplexobj(x):
        x = to_ri(x)
    x = np.ascontiguousarray(x, np.float32)
    sf = np.asarray(sf_idx).astype(np.int64)
    B, n = x.shape[0], mesh.size
    if B % n or sf.shape != (B,):
        raise ValueError(f"shard_subframes: batch {B} (sf_idx "
                         f"{sf.shape}) does not split into {n} equal "
                         "shards")
    m = B // n
    xs = tuple(torch.from_numpy(x[k * m:(k + 1) * m]).to(d)
               for k, d in enumerate(mesh.devices))
    sfs = tuple(torch.from_numpy(sf[k * m:(k + 1) * m]).to(d)
                for k, d in enumerate(mesh.devices))
    return xs, sfs


@functools.lru_cache(maxsize=8)
def make_sharded_frontend(cell: CellConfig, mesh: Mesh):
    """run(samples shards, sf_idx shards) -> one frontend output dict per
    shard, each on its shard's device (`Frontend.run_ri`)."""
    fe = frontend_mod.make_frontend(cell)

    def run(samples_ri, sf_idx) -> List[dict]:
        return [fe.run_ri(x, s) for x, s in zip(samples_ri, sf_idx)]

    return run


@functools.lru_cache(maxsize=8)
def make_sharded_search(cell: CellConfig, cfi: int, mesh: Mesh):
    """(run(frontend shards, sf_idx shards) -> one search output dict per
    shard (`pdcch_rx.make_search_from_grids`), static maps)."""
    search, st = pdcch_rx.make_search_from_grids(cell, cfi)

    def run(fe_shards, sf_idx) -> List[dict]:
        return [search(f["grids"], f["h"], f["noise_var"], f["snr_db"], s)
                for f, s in zip(fe_shards, sf_idx)]

    return run, st


def gather(shards: Sequence[dict], keys=None) -> dict:
    """Per-shard output dicts -> {key: numpy array of the whole batch},
    shards concatenated in subframe order.  Every shard's work was
    enqueued before the first read."""
    keys = keys or shards[0].keys()
    return {k: np.concatenate([s[k].cpu().numpy() for s in shards])
            for k in keys}


def merge_accepted(per_host_accepted: Sequence[List],
                   host_offsets: Sequence[int]):
    """Order per-host accepted-DCI lists by global TTI.

    The plain time-order merge for hosts whose tracker state is already
    consistent (one process driving several meshes).  For independent
    hosts over contiguous time blocks use `parallel.multihost`: it
    replays the boundary through each host's trackers and drops the
    replay duplicates by ownership."""
    tagged = []
    for accepted, off in zip(per_host_accepted, host_offsets):
        for a in accepted:
            tagged.append(((off + a.sfn * 10 + a.sf_idx
                            if hasattr(a, "sfn") else off), a))
    tagged.sort(key=lambda t: t[0])
    return [a for _, a in tagged]
