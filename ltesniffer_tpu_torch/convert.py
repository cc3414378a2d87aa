"""Configuration from the JAX reference package.

The sniffer has no trained weights: what carries over from a deployment
of `ltesniffer_tpu` is its configuration (and the constant tables, which
the port rebuilds from the same code).  `config_from_reference` takes
`dataclasses.asdict` of the reference's `SnifferConfig` (or `CellConfig`)
and builds the port's; every option carries over (ingest, pipeline depth,
live mode and `use_native` included), and an option the port does not
have raises.
"""
from __future__ import annotations

import dataclasses

from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer.core import SnifferConfig


def config_from_reference(d: dict, device: str = "cuda"):
    """Port `SnifferConfig` from a reference `SnifferConfig` dict, or port
    `CellConfig` from a reference `CellConfig` dict."""
    if "cell" not in d:
        return CellConfig(**d)
    d = dict(d)
    known = {f.name for f in dataclasses.fields(SnifferConfig)}
    unknown = sorted(set(d) - known)
    if unknown:
        raise ValueError(f"reference options the port does not have: "
                         f"{unknown}")
    d["cell"] = CellConfig(**d["cell"])
    d["device"] = device
    return SnifferConfig(**d)
