"""Configuration from the JAX reference package.

The sniffer has no trained weights: what carries over from a deployment
of `ltesniffer_tpu` is its configuration (and the constant tables, which
the port rebuilds from the same code).  `config_from_reference` takes
`dataclasses.asdict` of the reference's `SnifferConfig` (or `CellConfig`)
and builds the port's.
"""
from __future__ import annotations

import dataclasses

from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer.core import SnifferConfig

# Reference options the port leaves out, with the one value it
# implements: live-mode shedding (no live driver yet), the int16/float32
# ingest paths and the shallower pipelines (the port runs packed int8
# through the deep pipeline).  `use_native` carries over: the port has
# its own copy of the C++ resolver (`ltesniffer_tpu_torch/native.py`).
_FIXED = {"live_mode": False, "ingest": "i8", "ingest_int16": True,
          "pipeline_depth": 3}
_DROPPED = ("live_buffer_sf",) + tuple(_FIXED)


def config_from_reference(d: dict, device: str = "cuda"):
    """Port `SnifferConfig` from a reference `SnifferConfig` dict, or port
    `CellConfig` from a reference `CellConfig` dict."""
    if "cell" not in d:
        return CellConfig(**d)
    d = dict(d)
    for k, v in _FIXED.items():
        if d.get(k, v) != v:
            raise ValueError(f"{k}={d[k]!r} is not ported yet (the port "
                             f"implements {k}={v!r})")
    for k in _DROPPED:
        d.pop(k, None)
    known = {f.name for f in dataclasses.fields(SnifferConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"reference options the port does not have: "
                         f"{unknown}")
    d["cell"] = CellConfig(**d["cell"])
    d["device"] = device
    return SnifferConfig(**d)
