"""Port parity, the subframe split over devices: `ltesniffer_tpu_torch.
parallel.sharding` over an 8-way CPU mesh against the JAX package's
single-device fixed-CFI pipeline, mirroring `tests/test_sharding.py`.

RNTIs and decoded bits are compared for equality; CCE powers within
rtol 1e-4, atol 1e-5 (the reference test's tolerance: the two packages
sum the DFTs and the equalizer in another order); and the port's sharded
run against its own single-device run bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch
from ltesniffer_tpu.sniffer.dci_search import AcceptedDci as RefAcceptedDci

from ltesniffer_tpu_torch.parallel import sharding
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import pdcch_rx
from ltesniffer_tpu_torch.sniffer.dci_search import AcceptedDci

from tests import test_sharding as ref_tests

torch.set_num_threads(1)

CELL = CellConfig(n_id_cell=210, n_prb=25, nof_ports=2, nof_rx_ant=1)
CFI = ref_tests.CFI


@pytest.fixture(scope="module")
def runs():
    """The reference's 8-subframe batch through the JAX single-device
    pipeline, the port's single-device pipeline and the port's split over
    ["cpu"] * 8."""
    samples, sfs = ref_tests._batch(8, np.random.default_rng(0))
    run, st = ref_pdcch.make_pipeline(ref_tests.CELL, CFI)
    ref = {k: np.asarray(v)
           for k, v in run(jnp.asarray(samples), jnp.asarray(sfs)).items()}
    run_p, st_p = pdcch_rx.make_pipeline(CELL, CFI)
    single = {k: v.numpy() for k, v in
              run_p(samples, sfs, device="cpu").items()}
    mesh = sharding.make_mesh(["cpu"] * 8)
    fe = sharding.make_sharded_frontend(CELL, mesh)
    search, st_s = sharding.make_sharded_search(CELL, CFI, mesh)
    s_d, sf_d = sharding.shard_subframes(mesh, samples, sfs)
    shards = search(fe(s_d, sf_d), sf_d)
    assert len(shards) == 8
    assert all(s["cce_power"].shape[0] == 1 for s in shards)
    sharded = sharding.gather(shards)
    assert st_p["locs"] == st["locs"] and st_s is st_p
    return st, ref, single, sharded


def test_sharded_pipeline_matches_single_device(runs):
    """The mirror of the reference test: the port's split over eight
    devices against the JAX single-device pipeline."""
    st, ref, _, sharded = runs
    for D in sorted({st["sizes"][f] + 16 for f in st["sizes"]}):
        np.testing.assert_array_equal(sharded[f"rnti_{D}"],
                                      ref[f"rnti_{D}"])
        np.testing.assert_array_equal(sharded[f"bits_{D}"],
                                      ref[f"bits_{D}"])
    np.testing.assert_allclose(sharded["cce_power"], ref["cce_power"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sharded["snr_db"], ref["snr_db"],
                               rtol=1e-4, atol=1e-5)
    # the SI-RNTI DCIs of the even subframes decode on both
    D = st["sizes"]["1A"] + 16
    assert (sharded[f"rnti_{D}"][0::2] == 0xFFFF).any(axis=1).all()


def test_sharded_equals_own_single_device_bitwise(runs):
    _, _, single, sharded = runs
    assert sharded.keys() == single.keys()
    for k in single:
        np.testing.assert_array_equal(sharded[k], single[k], err_msg=k)


def test_shard_count_must_divide_batch():
    mesh = sharding.make_mesh(["cpu"] * 3)
    samples, sfs = ref_tests._batch(4, np.random.default_rng(1))
    with pytest.raises(ValueError, match="equal"):
        sharding.shard_subframes(mesh, samples, sfs)
    xs, sf = sharding.shard_subframes(sharding.make_mesh(["cpu"] * 2),
                                      samples, sfs)
    assert [x.shape[0] for x in xs] == [2, 2]
    assert xs[0].dtype == torch.float32 and xs[0].shape[-1] == 2
    np.testing.assert_array_equal(torch.cat(sf).numpy(), sfs)


def test_make_mesh_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharding.make_mesh()
    mesh = sharding.make_mesh(["cpu", "cpu"])
    assert mesh.devices == (torch.device("cpu"),) * 2
    assert mesh.axis_names == ("sf",) and mesh.size == 2


def test_merge_accepted_orders_by_time():
    """The mirror of the reference test, and both merges agree."""
    def two(cls):
        a = cls(rnti=1, fmt="1A", l=0, ncce=0, payload=np.zeros(1),
                histval=0, sf_idx=5, sfn=0)
        b = cls(rnti=2, fmt="1A", l=0, ncce=0, payload=np.zeros(1),
                histval=0, sf_idx=0, sfn=0)
        return [[a], [b]]
    merged = sharding.merge_accepted(two(AcceptedDci), [0, 1000])
    assert [x.rnti for x in merged] == [1, 2]
    want = ref_tests.sharding.merge_accepted(two(RefAcceptedDci), [0, 1000])
    assert [x.rnti for x in merged] == [x.rnti for x in want]
