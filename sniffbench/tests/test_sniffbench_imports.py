"""Neither JAX, nor the JAX package, nor the port in the yardstick; and the
run's own check of `sys.modules` compares whole top-level names."""
import json
import subprocess
import sys

import pytest

from sniffbench.harness import drive

CHECK = """
import json, sys
sys.path.insert(0, {root!r})
import {mod}
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


@pytest.mark.parametrize("mod", ["sniffbench.reference.compare",
                                 "sniffbench.reference.pcap",
                                 "sniffbench.gen.block", "sniffbench.work"])
def test_yardstick_loads_no_jax_and_no_port(mod):
    out = subprocess.run([sys.executable, "-c",
                          CHECK.format(root=drive.ROOT, mod=mod)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "ltesniffer_tpu",
                      "ltesniffer_tpu_torch", "torch"}


def test_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ltesniffer_tpu_torch_fake.x", None)
    assert "ltesniffer_tpu" not in drive.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ltesniffer_tpu.sniffer", None)
    assert drive.forbidden_modules() == ["ltesniffer_tpu"]


def test_no_source_under_sniffbench_imports_jax():
    import os
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|ltesniffer_tpu)"
                     r"(\s|\.|$)", re.M)
    for d, _, files in os.walk(os.path.join(drive.ROOT, "sniffbench")):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(d, f)).read()
                assert not pat.search(src), os.path.join(d, f)
