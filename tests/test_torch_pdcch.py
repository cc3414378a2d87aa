"""Port parity, blind search: CRC, Gold sequences, the tail-biting Viterbi
and the unified PDCCH search of `ltesniffer_tpu_torch` against the JAX
package.  Integer outputs are compared for equality, the packed
`cand_fused` words word for word, on the `tests/test_pdcch_e2e.py`
scenarios."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ltesniffer_tpu.phy import crc as ref_crc, sequences as ref_seq
from ltesniffer_tpu.kernels import viterbi as ref_viterbi
from ltesniffer_tpu.phy.params import CellConfig as RefCell
from ltesniffer_tpu.sniffer import frontend as ref_frontend
from ltesniffer_tpu.sniffer import pdcch_rx as ref_pdcch
from ltesniffer_tpu.testing import encoder as ref_encoder

from ltesniffer_tpu_torch.kernels import viterbi
from ltesniffer_tpu_torch.phy import crc, sequences
from ltesniffer_tpu_torch.phy.params import CellConfig
from ltesniffer_tpu_torch.sniffer import frontend, pdcch_rx

from tests import test_pdcch_e2e as e2e

torch.set_num_threads(1)


@pytest.mark.parametrize("poly", ["CRC16", "CRC24A", "CRC24B", "CRC8"])
def test_batched_crc_equal(poly):
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (5, 3, 97)).astype(np.uint8)
    p = getattr(crc, poly)
    want = np.asarray(ref_crc.batched_crc(jnp.asarray(bits), p))
    got = crc.batched_crc(torch.from_numpy(bits), p)
    np.testing.assert_array_equal(got.numpy(), want)
    want_i = np.asarray(ref_crc.batched_crc_to_int(jnp.asarray(bits), p))
    got_i = crc.batched_crc_to_int(torch.from_numpy(bits), p)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_gold_sequence_equal():
    rng = np.random.default_rng(1)
    c_init = rng.integers(0, 2 ** 31, 7).astype(np.int64)
    want = np.asarray(ref_seq.gold_sequence_jax(
        jnp.asarray(c_init.astype(np.uint32)), 600))
    got = sequences.gold_sequence_torch(torch.from_numpy(c_init), 600)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[3].numpy(),
                                  sequences.gold_sequence(int(c_init[3]), 600))


def test_viterbi_multi_equal():
    """Several payload sizes in one fused scan, noisy LLRs."""
    rng = np.random.default_rng(2)
    llrs = [rng.normal(size=(6, 3, d)).astype(np.float32) * 2.0
            for d in (43, 57, 60)]
    want = ref_viterbi.viterbi_decode_tb_multi(
        [jnp.asarray(x) for x in llrs])
    got = viterbi.viterbi_decode_tb_multi([torch.from_numpy(x)
                                           for x in llrs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _scenario(name):
    """Subframes of the tests/test_pdcch_e2e.py scenarios."""
    rng = np.random.default_rng(7)
    if name == "sirnti":
        txs = [[ref_encoder.TxDci(dci=e2e._mk_dci_1a(0xFFFF), L=3, ncce=0)]]
        sfs = [5]
    elif name == "two_dcis":
        txs = [[ref_encoder.TxDci(dci=e2e._mk_dci_1a(0x1001), L=2, ncce=0),
                ref_encoder.TxDci(dci=e2e._mk_dci_1a(0x2002, mcs=3), L=2,
                                  ncce=8)]]
        sfs = [2]
    else:                                   # histogram build-up + empty
        txs = [[ref_encoder.TxDci(dci=e2e._mk_dci_1a(0x3456), L=0,
                                  ncce=4 * k)] for k in range(3)] + [[]]
        sfs = [1, 2, 3, 4]
    iqs = [e2e._subframe(t, sf, rng) for t, sf in zip(txs, sfs)]
    return np.stack(iqs).astype(np.complex64), np.asarray(sfs, np.int64)


@pytest.mark.parametrize("name", ["sirnti", "two_dcis", "histogram"])
def test_cand_fused_equal(name):
    """Same grids into both searches -> the packed candidate words are
    equal word for word; and the port's frontend + search end to end
    give the same words as the JAX package's."""
    iq, sfs = _scenario(name)
    ref_cell, cell = RefCell(**_cfg()), CellConfig(**_cfg())
    words, scales = _i8(iq)
    fe_ref = ref_frontend.make_frontend(ref_cell).jitted_i8(
        words, sfs.astype(np.int32), jnp.asarray(scales), np.float32(0.0))
    run_ref, st_ref = ref_pdcch.make_unified_search(ref_cell)
    want = np.asarray(run_ref(fe_ref["grids"], fe_ref["h"],
                              fe_ref["noise_var"], fe_ref["snr_db"],
                              jnp.asarray(sfs.astype(np.int32)),
                              fe_ref["cfi"] - 1,
                              fe_ref["scalars"])["cand_fused"])
    run, st = pdcch_rx.make_unified_search(cell)
    assert st["locs"] == st_ref["locs"]
    t = {k: torch.from_numpy(np.array(fe_ref[k]))
         for k in ("grids", "h", "noise_var", "snr_db", "scalars")}
    cfi_idx = torch.from_numpy(np.array(fe_ref["cfi"]).astype(np.int64)) - 1
    got = run(t["grids"], t["h"], t["noise_var"], t["snr_db"],
              torch.from_numpy(sfs), cfi_idx, t["scalars"])["cand_fused"]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # end to end through the port's own frontend
    fe = frontend.make_frontend(cell).run_i8c64(
        torch.from_numpy(_view_i64(words)), torch.from_numpy(sfs),
        torch.from_numpy(scales), 0.0)
    got2 = run(fe["grids"], fe["h"], fe["noise_var"], fe["snr_db"],
               torch.from_numpy(sfs), fe["cfi"] - 1,
               fe["scalars"])["cand_fused"]
    n_loc, S = len(st["locs"]), len(st["size_order"])
    meta, cce, scal, pay = pdcch_rx.unpack_fused(
        got2.numpy(), n_loc, S, st["nof_cce"], True, True)
    meta_r, cce_r, scal_r, pay_r = ref_pdcch.unpack_fused(
        want, n_loc, S, st["nof_cce"], True, True)
    # every candidate that decodes to a valid-looking RNTI of the scenario
    # agrees; CCE powers agree to float16 precision
    np.testing.assert_array_equal(meta, meta_r)
    np.testing.assert_array_equal(pay, pay_r)
    np.testing.assert_allclose(cce, cce_r, rtol=2e-3, atol=1e-3)
    np.testing.assert_allclose(scal, scal_r, rtol=2e-3, atol=1e-2)


def _cfg():
    return dict(n_id_cell=e2e.CELL.n_id_cell, n_prb=e2e.CELL.n_prb,
                nof_ports=e2e.CELL.nof_ports, nof_rx_ant=e2e.CELL.nof_rx_ant)


def _i8(iq):
    from ltesniffer_tpu_torch.kernels import cplx
    return cplx.to_i8_packed(iq)


def _view_i64(words):
    from ltesniffer_tpu_torch.kernels import cplx
    return cplx.view_i64(words)


def _fixed_cfi_batch(cfi, B=6):
    """tests/test_sharding.py's batch (25 PRB, SI-RNTI format-1A DCIs on
    the even subframes) with the control region of `cfi`."""
    from ltesniffer_tpu.phy import dci as ref_dci, ra as ref_ra
    from tests import test_sharding as sh
    rng = np.random.default_rng(10 + cfi)
    iqs, sfs = [], []
    for j in range(B):
        txs = []
        if j % 2 == 0:
            d = ref_dci.Dci(fmt="1A", rnti=0xFFFF, fields=dict(
                flag0_1a=1, riv=ref_ra.start_len_to_riv(0, 4, 25), mcs=3))
            txs.append(ref_encoder.TxDci(dci=d, L=1 if cfi == 1 else 2,
                                         ncce=0))
        g = ref_encoder.build_control_subframe(sh.CELL, j % 10, cfi, txs)
        h = ref_encoder.flat_channel(sh.CELL, 1, rng)
        iqs.append(ref_encoder.subframe_iq(
            sh.CELL, ref_encoder.apply_channel(g, h, 0.05, rng))[0])
        sfs.append(j % 10)
    return (np.stack(iqs)[:, None, :].astype(np.complex64),
            np.asarray(sfs, np.int32), sh.CELL)


@pytest.mark.parametrize("cfi", [1, 2, 3])
def test_fixed_cfi_pipeline_equal(cfi):
    """The fixed-CFI search of both packages on the same batch.

    * `make_search_from_grids` on the JAX frontend's grids against the JAX
      package's search run op by op (`jax.disable_jit`, where both
      packages do the same float operations in the same order): per-size
      bits and RNTIs, the candidate meta and payload words and
      `cand_fused` equal, CCE powers within rtol 1e-4, atol 1e-5.
    * `make_pipeline` (samples in, complex or float pairs) against the JAX
      `make_pipeline`: grids, CCE powers, SNRs and noise within rtol 1e-4,
      atol 1e-5 (the DFT sums run in another order), and the transmitted
      DCIs' candidates decode to equal bits and RNTIs.  Candidates that
      carry no DCI decode noise through near-tie path metrics, which
      flip with the last bit of an LLR: the JAX package's own jitted
      search and its op-by-op run differ on a few of them, so they are
      held through the first point.
    """
    import jax
    samples, sfs, ref_cell = _fixed_cfi_batch(cfi)
    cell = CellConfig(n_id_cell=ref_cell.n_id_cell, n_prb=ref_cell.n_prb,
                      nof_ports=ref_cell.nof_ports,
                      nof_rx_ant=ref_cell.nof_rx_ant)
    run_ref, st_ref = ref_pdcch.make_pipeline(ref_cell, cfi)
    ref = {k: np.asarray(v) for k, v in
           run_ref(jnp.asarray(samples), jnp.asarray(sfs)).items()}
    run, st = pdcch_rx.make_pipeline(cell, cfi)
    assert st["locs"] == st_ref["locs"] and st["nof_cce"] == st_ref["nof_cce"]
    sizes = sorted({st["sizes"][f] + 16 for f in st["sizes"]})
    int_keys = [f"{p}_{D}" for D in sizes for p in ("bits", "rnti")] + [
        "cand_meta", "cand_pay", "cand_fused"]
    fe_keys = ("grids", "h", "noise_var", "snr_db")

    # the search on the same grids, against the op-by-op reference
    search, st2 = pdcch_rx.make_search_from_grids(cell, cfi)
    assert st2 is st
    run_g, _ = ref_pdcch.make_search_from_grids(ref_cell, cfi)
    with jax.disable_jit():
        want = {k: np.asarray(v) for k, v in run_g(
            *[jnp.asarray(ref[k]) for k in fe_keys],
            jnp.asarray(sfs)).items()}
    t = {k: torch.from_numpy(np.array(ref[k])) for k in fe_keys}
    out = {k: v.numpy() for k, v in search(
        *[t[k] for k in fe_keys],
        torch.from_numpy(sfs.astype(np.int64))).items()}
    assert set(out) == set(want) == set(ref)
    for k in int_keys:
        got_k = out[k].view(np.uint32) if k == "cand_pay" else out[k]
        np.testing.assert_array_equal(got_k, want[k], err_msg=k)
    np.testing.assert_allclose(out["cce_power"], want["cce_power"],
                               rtol=1e-4, atol=1e-5)

    # samples in: complex and float pairs give the same, the frontend's
    # floats agree, and so do the transmitted DCIs
    got = {k: v.numpy() for k, v in run(samples, sfs, device="cpu").items()}
    ri = samples.view(np.float32).reshape(*samples.shape, 2)
    got_ri = run(ri, sfs, device="cpu")
    for k in got:
        np.testing.assert_array_equal(got_ri[k].numpy(), got[k], err_msg=k)
    for k in ("grids", "h", "cce_power", "snr_db", "noise_var"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert not got["cfo"].any()
    D = st["sizes"]["1A"] + 16
    li = st["locs"].index((1 if cfi == 1 else 2, 0))
    for k in (f"rnti_{D}", f"bits_{D}"):
        np.testing.assert_array_equal(got[k][0::2, li], ref[k][0::2, li])
    assert (got[f"rnti_{D}"][0::2, li] == 0xFFFF).all()


@pytest.mark.parametrize("case", ["2ports_sfn0", "2ports_sfn1021",
                                  "1port", "phich", "noise"])
def test_decode_mib_equal(case):
    """`pbch_rx.decode_mib` of both packages on tests/test_pbch.py's
    subframe-0 grids (the JAX frontend's): equal MIB results; and the
    port's own frontend on the same IQ gives the same MIB."""
    from ltesniffer_tpu.sniffer import pbch_rx as ref_pbch
    from ltesniffer_tpu_torch.sniffer import pbch_rx
    ref_cfg, sfn, noise, seed = {
        "2ports_sfn0": (dict(n_id_cell=211, n_prb=50, nof_ports=2), 0,
                        0.05, 0),
        "2ports_sfn1021": (dict(n_id_cell=211, n_prb=50, nof_ports=2), 1021,
                           0.05, 0),
        "1port": (dict(n_id_cell=33, n_prb=100, nof_ports=1), 8, 0.05, 1),
        "phich": (dict(n_id_cell=7, n_prb=25, nof_ports=2,
                       phich_resources=2.0), 40, 0.03, 2),
        "noise": (dict(n_id_cell=211, n_prb=50, nof_ports=2), None, 0.0,
                  3)}[case]
    ref_cell, cell = RefCell(**ref_cfg), CellConfig(**ref_cfg)
    rng = np.random.default_rng(seed)
    if sfn is None:
        iq = (0.7 * (rng.standard_normal((1, cell.sf_len))
                     + 1j * rng.standard_normal((1, cell.sf_len)))
              ).astype(np.complex64)
    else:
        g = ref_encoder.build_control_subframe(ref_cell, 0, 1, [])
        ref_encoder.add_pbch(g, ref_cell, sfn)
        h = ref_encoder.flat_channel(ref_cell, ref_cell.nof_rx_ant, rng)
        iq = ref_encoder.subframe_iq(
            ref_cell, ref_encoder.apply_channel(g, h, noise, rng))
    iq = iq[None].astype(np.complex64)
    fe = ref_frontend.make_frontend(ref_cell)(
        jnp.asarray(iq), jnp.asarray([0], np.int32))
    args = [np.asarray(fe[k][0]) for k in ("grids", "h", "noise_var")]
    want = ref_pbch.decode_mib(*args, ref_cell)
    got = pbch_rx.decode_mib(*[torch.from_numpy(np.array(a)) for a in args],
                             cell)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok == (sfn is not None)
    if sfn is not None:
        assert got.sfn == sfn and got.nof_ports == cell.nof_ports
    fe_p = frontend.make_frontend(cell).run(
        iq, torch.zeros(1, dtype=torch.int64), "cpu")
    got2 = pbch_rx.decode_mib(fe_p["grids"][0], fe_p["h"][0],
                              fe_p["noise_var"][0], cell)
    assert got2 == got
